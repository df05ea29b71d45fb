"""Frames of a video for the reconstruction CLI and the demo.

Counterpart of ``fast3r_tpu/serve/video.py``: the same ``ffmpeg`` command.
The JAX package falls back to OpenCV without ``ffmpeg``; the port has no
OpenCV (the card has none), so without ``ffmpeg`` on PATH it raises.
"""

from __future__ import annotations

import os
import shutil
import subprocess


def extract_frames_from_video(video_path: str, output_dir: str,
                              fps: float = 2.0) -> str:
    """``fps`` frames a second of ``video_path`` as ``output_dir``/
    frame_00001.jpg, ... by ``ffmpeg``; returns ``output_dir`` (for
    ``load_images``).  Raises RuntimeError when ``ffmpeg`` is not on PATH."""
    if shutil.which("ffmpeg") is None:
        raise RuntimeError(
            "video input needs ffmpeg on PATH (the port has no OpenCV "
            "fallback); extract the frames into a folder and pass that")
    os.makedirs(output_dir, exist_ok=True)
    subprocess.run(
        ["ffmpeg", "-y", "-loglevel", "error", "-i", video_path,
         "-vf", f"fps={fps}", os.path.join(output_dir, "frame_%05d.jpg")],
        check=True)
    return output_dir
