"""Scene assembly for headless serving: merged coloured point clouds.

Counterpart of ``fast3r_tpu/serve/visualizer.py`` (``detect_sky_mask``,
``is_outdoor_scene``, ``assemble_scene``, ``export_scene_ply``,
``confidence_colors``), host numpy: per-frame point clouds from the global
or the aligned local head, confidence-percentile filtering, HSV sky masking
and confidence colouring.  The HSV conversion and the JET colour map are
OpenCV's 8-bit ones written out in numpy (the fixed-point HSV of
``cv2.cvtColor`` and ``COLORMAP_JET``'s integer ramps), the morphology is
scipy's.  The viser server and the GIF render are not ported.
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
