"""Local -> global alignment of the heads' pointmaps.

Counterpart of ``fast3r_tpu/eval/recon.py`` (``align_local_pts3d_to_global``):
for each view and sample, the local head's pointmap is aligned onto the
global head's by a weighted similarity (Umeyama) over the pixels whose
global confidence reaches a percentile, with an identity fallback below
three points.  The solves run batched on the device, one call per pixel
grid shape.  The reconstruction metrics (accuracy, completion, normals)
wait for the eval suites.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from fast3r_torch.ops.umeyama import apply_similarity, rigid_points_registration

_KEYS = ("pts3d_local", "conf_local", "pts3d_in_other_view", "conf")


def _align(pts_local, pts_global, weights):
    """(n, N, 3) local points onto global ones, (n, N) weights."""
    R, t, s = rigid_points_registration(pts_local, pts_global, weights)
    ok = weights.sum(-1) >= 3
    R = torch.where(ok[:, None, None], R,
                    torch.eye(3, device=R.device).expand_as(R))
    t = torch.where(ok[:, None], t, torch.zeros_like(t))
    s = torch.where(ok, s, torch.ones_like(s))
    return apply_similarity(pts_local.float(), R, t, s)


def align_local_pts3d_to_global(preds: Sequence[Dict],
                                views: Optional[Sequence[Dict]] = None,
                                min_conf_thr_percentile: float = 0.0,
                                device="cuda") -> None:
    """Adds "pts3d_local_aligned_to_global" (B, H, W, 3) float32 CPU to
    each pred dict, in place (a per-sample list where the samples' shapes
    differ); the solves run on ``device``.  Entries are (B, H, W, ...)
    tensors or arrays, or per-sample lists of them; a view's "valid_mask"
    narrows the confidence mask, and replaces it where fewer than three
    pixels remain."""
    for pred in preds:
        for key in _KEYS:
            if key not in pred:
                raise ValueError(f"Key {key!r} not found in preds.")
    jobs = {}  # (H, W) -> [(view, sample, local, global, weights)]
    for v, pred in enumerate(preds):
        for b in range(len(pred["pts3d_local"])):
            local, glob, conf = (torch.as_tensor(pred[k][b]).to(device).float()
                                 for k in ("pts3d_local",
                                           "pts3d_in_other_view", "conf"))
            cg = conf.reshape(-1)
            mask = cg >= torch.quantile(cg, min_conf_thr_percentile / 100.0)
            if views is not None and "valid_mask" in views[v]:
                valid = torch.as_tensor(views[v]["valid_mask"][b]).to(
                    device).reshape(-1).bool()
                mask &= valid
                if mask.sum() < 3:
                    mask = valid
            jobs.setdefault(tuple(local.shape[:2]), []).append(
                (v, b, local.reshape(-1, 3), glob.reshape(-1, 3),
                 mask.float()))
    out = {}
    for (H, W), items in jobs.items():
        aligned = _align(*(torch.stack([it[k] for it in items])
                           for k in (2, 3, 4))).cpu()
        for (v, b, *_), a in zip(items, aligned):
            out[v, b] = a.reshape(H, W, 3)
    for v, pred in enumerate(preds):
        maps = [out[v, b] for b in range(len(pred["pts3d_local"]))]
        same = all(m.shape == maps[0].shape for m in maps)
        pred["pts3d_local_aligned_to_global"] = (torch.stack(maps) if same
                                                 else maps)
