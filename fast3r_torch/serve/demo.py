"""The Gradio web demo.

Counterpart of ``fast3r_tpu/serve/demo.py`` (the reference's
``fast3r/viz/demo.py``): upload images (with a gallery preview) or a
video, pick the inference resolution, reconstruct (the model's forward
through ``inference(..., profiling=True)``, the local head aligned to the
global one at the 85th confidence percentile), get the scene as a PLY, a
per-session Viser server and the per-stage speed report; send thumbs up /
down or free-text feedback; end the session (and a timer collects idle
sessions).  ``gradio`` (and ``viser``) are imported inside the functions,
so the module imports without them; neither machine the port is tested on
has them, and the tests drive the demo through fake ones
(``tests/torch_fake_ui.py``).  The headless counterpart is
``fast3r_torch.cli.reconstruct``.

    python -m fast3r_torch.serve.demo --checkpoint DIR [--port 7860] \
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile
import threading
from typing import List, Optional

RESOLUTION_CHOICES = (512, 384, 224)
GC_INTERVAL_S = 600.0
GC_MAX_AGE_S = 3600.0


def _speed_report(views, info) -> str:
    """The 'Processing Speed' box: the total and the per-stage times of
    ``inference``'s profiling keys."""
    lines = [f"{len(views)} views in {info['total_time']:.2f}s "
             f"({len(views) / max(info['total_time'], 1e-9):.1f} img/s)"]
    for key in ("encode_images_time", "decoder_time", "head_forward_time"):
        if key in info:
            lines.append(f"  {key.replace('_time', '')}: {info[key]:.2f}s")
    return "\n".join(lines)


def create_demo(model, viser_port_range=(8020, 8100)):
    """The demo's Blocks around ``model`` (a ``fast3r_torch.Fast3R``; its
    device runs the forward, the alignment and each session's poses).
    ``demo._fast3r`` holds the GC timer, the session manager (None without
    viser) and two of the handlers."""
    import gradio as gr

    from fast3r_torch.eval.recon import align_local_pts3d_to_global
    from fast3r_torch.inference import inference
    from fast3r_torch.serve.server_manager import (ViserServerManager,
                                                   save_feedback)
    from fast3r_torch.serve.visualizer import (assemble_scene,
                                               export_scene_ply)
    from fast3r_torch.utils.image import load_images

    try:
        import viser  # noqa: F401

        manager = ViserServerManager(port_range=viser_port_range)
    except ImportError:
        manager = None  # the PLY viewer only

    device = model.device
    feedback_path = os.path.join(tempfile.gettempdir(),
                                 "fast3r_torch_feedback.jsonl")

    # a daemon timer chain collects the idle viser sessions
    def _gc_tick():
        if manager is not None:
            manager.gc(max_age_s=GC_MAX_AGE_S)
        t = threading.Timer(GC_INTERVAL_S, _gc_tick)
        t.daemon = True
        t.start()
        return t

    gc_timer = _gc_tick()

    def update_gallery(files: Optional[List]):
        """The gallery preview of the uploaded images."""
        return [f.name for f in (files or [])]

    def process_images(files: Optional[List], video,
                       conf_percentile: float,
                       resolution=512,
                       request: "gr.Request" = None):
        paths = [f.name for f in (files or [])]
        workdir = tempfile.mkdtemp()
        if video is not None:
            from fast3r_torch.serve.video import extract_frames_from_video

            frame_dir = extract_frames_from_video(video,
                                                  os.path.join(workdir, "fr"))
            paths = [os.path.join(frame_dir, p)
                     for p in sorted(os.listdir(frame_dir))]
        if not paths:
            return None, "upload images or a video"

        views = load_images(paths, size=int(resolution), verbose=False)
        result, info = inference(views, model, verbose=False, profiling=True)
        preds = result["preds"]
        align_local_pts3d_to_global(preds, min_conf_thr_percentile=85.0,
                                    device=device)
        scene = assemble_scene(views, preds, conf_percentile=conf_percentile)
        ply = export_scene_ply(os.path.join(workdir, "scene.ply"), scene)
        status = (f"{len(scene['points'])} points @ {resolution}px\n"
                  + _speed_report(views, info))
        if manager is not None:
            # a Viser server for this session
            session = getattr(request, "session_hash", None) or "default"
            manager.gc(max_age_s=GC_MAX_AGE_S)
            port = manager.start_server(
                session, {"views": views, "preds": preds},
                device=device.type)
            status += f"\nviser on port {port}"
        return ply, status

    def submit_feedback(text: str, rating: str = "",
                        request: "gr.Request" = None):
        if not text and not rating:
            return "enter feedback first"
        save_feedback(feedback_path, text,
                      {"session": getattr(request, "session_hash", None),
                       "rating": rating})
        return "thanks — feedback saved"

    def end_session(request: "gr.Request" = None):
        """Stop this session's Viser server."""
        if manager is None:
            return "no viser sessions"
        session = getattr(request, "session_hash", None) or "default"
        manager.stop_server(session)
        return f"session {session!r} released"

    with gr.Blocks(title="Fast3R") as demo:
        gr.Markdown("# Fast3R — 3D reconstruction from unposed images")
        with gr.Row():
            files = gr.File(file_count="multiple", label="images")
            video = gr.Video(label="or a video")
        gallery = gr.Gallery(label="uploaded scene", columns=6)
        resolution = gr.Radio(
            choices=[str(r) for r in RESOLUTION_CHOICES], value="512",
            label="inference resolution (px)")
        conf = gr.Slider(0, 99, value=10, label="confidence percentile")
        btn = gr.Button("Reconstruct")
        out_ply = gr.Model3D(label="reconstruction")
        status = gr.Textbox(label="processing speed", lines=5)
        if hasattr(files, "change"):
            files.change(update_gallery, [files], [gallery])
        btn.click(process_images, [files, video, conf, resolution],
                  [out_ply, status])
        with gr.Row():
            up = gr.Button("\U0001F44D Love it!")
            down = gr.Button("\U0001F44E Not quite there")
            fb = gr.Textbox(label="feedback")
            fb_btn = gr.Button("Send feedback")
        fb_status = gr.Textbox(label="", interactive=False)
        up.click(lambda request=None: submit_feedback(
            "", "thumbs_up", request), [], [fb_status])
        down.click(lambda request=None: submit_feedback(
            "", "thumbs_down", request), [], [fb_status])
        fb_btn.click(submit_feedback, [fb], [fb_status])
        end_btn = gr.Button("End session")
        end_btn.click(end_session, [], [fb_status])
    demo._fast3r = {"gc_timer": gc_timer, "manager": manager,
                    "update_gallery": update_gallery,
                    "end_session": end_session}
    return demo


def main(argv=None):
    ap = argparse.ArgumentParser(description="Fast3R web demo")
    ap.add_argument("--checkpoint", required=True,
                    help="HF-format checkpoint dir or a fast3r_torch run dir")
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    try:
        import gradio  # noqa: F401
    except ImportError:
        raise SystemExit(
            "gradio is not installed; use `python -m "
            "fast3r_torch.cli.reconstruct` for headless reconstruction")

    import torch

    from fast3r_torch.utils.checkpoint_utils import load_model

    dev = torch.device(args.device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    model = load_model(args.checkpoint, dtype=dtype, device=dev)
    create_demo(model).launch(server_port=args.port)


if __name__ == "__main__":
    main()
