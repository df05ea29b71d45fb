"""PLY point-cloud export.

Counterpart of ``fast3r_tpu/serve/ply.py`` (``write_ply``, ``read_ply``):
binary little-endian vertices, float xyz and optional uchar rgb.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

_VERTEX = [("xyz", np.float32, 3), ("rgb", np.uint8, 3)]


def write_ply(path: str, points: np.ndarray,
              colors: Optional[np.ndarray] = None) -> None:
    """Write an (N, 3) point cloud, with optional float [0, 1] or uint8
    colors, as binary little-endian PLY."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    n = len(points)
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if colors is not None:
        colors = np.asarray(colors)
        if colors.dtype != np.uint8:
            colors = (np.clip(colors, 0, 1) * 255).astype(np.uint8)
        colors = colors.reshape(-1, 3)
        if len(colors) != n:
            raise ValueError(f"{len(colors)} colors for {n} points")
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if colors is None:
            f.write(points.tobytes())
        else:
            rec = np.zeros(n, dtype=_VERTEX)
            rec["xyz"], rec["rgb"] = points, colors
            f.write(rec.tobytes())


def read_ply(path: str):
    """(points (N, 3) float32, colors (N, 3) uint8 or None) of a file
    written by :func:`write_ply`."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path} is not a PLY file")
        n, has_color = 0, False
        while True:
            line = f.readline().strip()
            if line.startswith(b"element vertex"):
                n = int(line.split()[-1])
            if line.startswith(b"property uchar"):
                has_color = True
            if line == b"end_header" or not line:
                break
        data = f.read()
    if has_color:
        rec = np.frombuffer(data, dtype=_VERTEX, count=n)
        return rec["xyz"].copy(), rec["rgb"].copy()
    return np.frombuffer(data, np.float32, count=n * 3).reshape(n, 3).copy(), None
