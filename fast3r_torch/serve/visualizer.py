"""Scene assembly for headless serving: merged coloured point clouds.

Counterpart of ``fast3r_tpu/serve/visualizer.py`` (``detect_sky_mask``,
``is_outdoor_scene``, ``assemble_scene``, ``export_scene_ply``,
``confidence_colors``, ``render_scene_frame``, ``render_scene_gif``), host
numpy: per-frame point clouds from the global or the aligned local head,
confidence-percentile filtering, HSV sky masking, confidence colouring and
an orbit GIF of the merged cloud (z-buffered 1-pixel splats, written with
PIL).  The HSV conversion and the JET colour map are OpenCV's 8-bit ones
written out in numpy (the fixed-point HSV of ``cv2.cvtColor`` and
``COLORMAP_JET``'s integer ramps), the morphology is scipy's.  The viser
server is not ported.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
from scipy import ndimage

from fast3r_torch.serve.ply import write_ply
from fast3r_torch.utils.image import unnormalize_rgb

_HSV_SHIFT = 12
_I = np.arange(256, dtype=np.float64)
with np.errstate(divide="ignore"):
    _SDIV = np.where(_I > 0, np.rint((255 << _HSV_SHIFT) / _I), 0).astype(
        np.int64)
    _HDIV = np.where(_I > 0, np.rint((180 << _HSV_SHIFT) / (6.0 * _I)),
                     0).astype(np.int64)


def rgb_to_hsv_u8(img: np.ndarray) -> np.ndarray:
    """uint8 RGB (H, W, 3) -> 8-bit HSV, H in [0, 180): OpenCV's
    fixed-point conversion."""
    r, g, b = (img[..., k].astype(np.int64) for k in range(3))
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b,
                 np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


def _in_range(hsv: np.ndarray, lo, hi) -> np.ndarray:
    return np.all((hsv >= np.asarray(lo)) & (hsv <= np.asarray(hi)), -1)


def detect_sky_mask(img_rgb: np.ndarray) -> np.ndarray:
    """HSV + morphology sky detection.  img_rgb: (H, W, 3) in [-1, 1].
    Returns an int8 mask, 1 = NOT sky."""
    hsv = rgb_to_hsv_u8(((img_rgb + 1) * 127.5).astype(np.uint8))
    mask = (_in_range(hsv, (105, 50, 140), (135, 255, 255))
            | _in_range(hsv, (95, 5, 150), (145, 100, 255))
            | _in_range(hsv, (0, 0, 235), (180, 10, 255)))
    upper = int(mask.shape[0] * 0.4)
    mask[:upper] |= (hsv[:upper, :, 1] < 50) & (hsv[:upper, :, 2] > 150)
    # a 7x7 dilation, then an opening; outside the image never counts
    mask = ndimage.maximum_filter(mask, 7, mode="constant", cval=False)
    mask = ndimage.minimum_filter(mask, 7, mode="constant", cval=True)
    mask = ndimage.maximum_filter(mask, 7, mode="constant", cval=False)

    labels, num = ndimage.label(mask)
    if num > 0:
        top = set(labels[0, :]) - {0}
        if top:
            mask = np.isin(labels, list(top))
            labels, num = ndimage.label(mask)
            if num > 0:
                sizes = ndimage.sum(mask, labels, range(1, num + 1))
                mask = np.isin(labels,
                               np.where(sizes > mask.size * 0.01)[0] + 1)
    return (~mask).astype(np.int8)


def is_outdoor_scene(not_sky_masks: Sequence[np.ndarray]) -> bool:
    """At least a quarter of the frames with more than 20% sky."""
    ratios = [1.0 - float(np.mean(m)) for m in not_sky_masks]
    return sum(r > 0.2 for r in ratios) >= len(ratios) / 4


def assemble_scene(views: Sequence[Dict], preds: Sequence[Dict],
                   use_local_head: bool = True, conf_percentile: float = 10.0,
                   mask_sky: bool = False) -> Dict:
    """A merged coloured point cloud of the per-view predictions:
    {"points" (N, 3), "colors" (N, 3) in [0, 1], "per_frame": [...],
    "outdoor": bool}."""
    all_pts, all_cols, per_frame, sky_masks = [], [], [], []
    for view, pred in zip(views, preds):
        key = ("pts3d_local_aligned_to_global"
               if use_local_head and "pts3d_local_aligned_to_global" in pred
               else "pts3d_in_other_view")
        conf_key = "conf_local" if "local" in key else "conf"
        pts = np.asarray(pred[key])[0]          # (H, W, 3)
        conf = np.asarray(pred[conf_key])[0]    # (H, W)
        img = np.asarray(view["img"])
        if img.ndim == 4:
            img = img[0]
        colors = unnormalize_rgb(img)
        mask = conf >= np.quantile(conf.reshape(-1), conf_percentile / 100.0)
        if mask_sky:
            not_sky = detect_sky_mask(img).astype(bool)
            sky_masks.append(not_sky)
            mask &= not_sky
        per_frame.append({"points": pts[mask], "colors": colors[mask],
                          "mask": mask})
        all_pts.append(pts[mask])
        all_cols.append(colors[mask])
    return {
        "points": np.concatenate(all_pts) if all_pts else np.zeros((0, 3)),
        "colors": np.concatenate(all_cols) if all_cols else np.zeros((0, 3)),
        "per_frame": per_frame,
        "outdoor": is_outdoor_scene(sky_masks) if sky_masks else False,
    }


def export_scene_ply(path: str, scene: Dict) -> str:
    write_ply(path, scene["points"], scene["colors"])
    return path


def _jet_lut() -> np.ndarray:
    """(256, 3) uint8 RGB of OpenCV's COLORMAP_JET: ramps of 4 per step."""
    i = np.arange(256)
    ramps = [np.minimum(4 * i + lo, hi - 4 * i)
             for lo, hi in ((-382, 1148), (-128, 892), (128, 638))]
    return np.clip(np.stack(ramps, -1), 0, 255).astype(np.uint8)


def confidence_colors(conf: np.ndarray, vmin: Optional[float] = None,
                      vmax: Optional[float] = None) -> np.ndarray:
    """JET colours of log-confidence: (N,) confidences -> (N, 3) RGB in
    [0, 1]."""
    x = np.log(np.maximum(np.asarray(conf, np.float64), 1e-8))
    lo = np.min(x) if vmin is None else np.log(max(vmin, 1e-8))
    hi = np.max(x) if vmax is None else np.log(max(vmax, 1e-8))
    t = np.clip((x - lo) / max(hi - lo, 1e-12), 0.0, 1.0)
    return _jet_lut()[(t * 255).astype(np.uint8)].astype(np.float32) / 255.0


def _look_at(eye: np.ndarray, target: np.ndarray, up=(0.0, -1.0, 0.0)):
    """World-to-camera (R, t) of a camera at ``eye`` looking at
    ``target`` (OpenCV axes: rows right, down, forward)."""
    fwd = target - eye
    fwd = fwd / (np.linalg.norm(fwd) + 1e-12)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right = right / (np.linalg.norm(right) + 1e-12)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd])
    return R, -R @ eye


def render_scene_frame(scene: Dict, eye: np.ndarray, target: np.ndarray,
                       hw=(480, 640), focal: float = 500.0,
                       background=(255, 255, 255)) -> np.ndarray:
    """The merged cloud seen from one pinhole camera: 1-pixel splats, the
    nearest point winning each pixel.  Returns (H, W, 3) uint8."""
    H, W = hw
    pts = np.asarray(scene["points"], np.float64)
    cols = (np.asarray(scene["colors"]) * 255).astype(np.uint8)
    frame = np.full((H, W, 3), background, np.uint8)
    if len(pts) == 0:
        return frame
    R, t = _look_at(eye, target)
    cam = pts @ R.T + t
    z = cam[:, 2]
    front = z > 1e-6
    cam, z, cols = cam[front], z[front], cols[front]
    u = np.round(cam[:, 0] / z * focal + W / 2).astype(np.int64)
    v = np.round(cam[:, 1] / z * focal + H / 2).astype(np.int64)
    ok = (u >= 0) & (u < W) & (v >= 0) & (v < H)
    u, v, z, cols = u[ok], v[ok], z[ok], cols[ok]
    order = np.argsort(-z)  # far to near: the nearest is written last
    frame[v[order], u[order]] = cols[order]
    return frame


def render_scene_gif(scene: Dict, path: str, n_frames: int = 24,
                     hw=(480, 640), fps: int = 8,
                     elevation: float = 0.35) -> str:
    """An orbit of ``n_frames`` views around the cloud's median point, at
    2.5 times its 90th-percentile radius, written to ``path`` as a looping
    GIF."""
    import PIL.Image

    pts = np.asarray(scene["points"], np.float64)
    if len(pts) == 0:
        center, radius = np.zeros(3), 1.0
    else:
        center = np.median(pts, axis=0)
        radius = float(np.quantile(
            np.linalg.norm(pts - center, axis=-1), 0.9)) + 1e-6
    frames = []
    for i in range(n_frames):
        ang = 2 * np.pi * i / n_frames
        eye = center + 2.5 * radius * np.array([
            np.sin(ang), -elevation, -np.cos(ang)])
        frames.append(PIL.Image.fromarray(
            render_scene_frame(scene, eye, center, hw=hw)))
    frames[0].save(path, save_all=True, append_images=frames[1:],
                   duration=int(1000 / fps), loop=0)
    return path
