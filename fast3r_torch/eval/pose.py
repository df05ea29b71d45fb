"""Camera poses and focals from predicted pointmaps.

Counterpart of ``fast3r_tpu/eval/pose.py`` (``_maybe_untranspose``,
``correct_preds_orientation``, ``estimate_camera_poses`` with its "jax"
backend, ``estimate_poses_jax``): the focal from the first view's pointmap
(Weiszfeld, confidence percentile 10), then RANSAC-PnP of every view on the
device with the conf > 1 mask.  Same-shape views take one batched solve;
mixed shapes one solve per view, its generator seeded from the seed and the
view index.

Focal modes: "first_view_from_global_head" and
"first_view_from_local_head" (one focal for every view), and "individual":
a focal a view, found as the JAX package's cv2 backend finds it
(``fast_pnp_cv2``: a RANSAC-PnP at each of 100 focals from S / 2 to 3 S,
the most inliers winning; ``ops.pnp.focal_sweep``, all focals of all views
at once), then each view's pose solved at its focal.  JAX's own backend
collapses "individual" to one view-0 focal; the port does not follow it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fast3r_torch.ops.geometry import xy_grid
from fast3r_torch.ops.pnp import (
    estimate_focal_weiszfeld,
    focal_grid,
    focal_sweep,
    pnp_ransac,
)

FOCAL_METHODS = ("first_view_from_global_head", "first_view_from_local_head",
                 "individual")


def _maybe_untranspose(arr, hw):
    """Swap a landscape-stored map back to its true portrait orientation
    (only when its stored shape is exactly the transposed one, so maps
    already corrected and landscape maps pass through)."""
    if hw is None:
        return arr
    h, w = int(hw[0]), int(hw[1])
    if h != w and arr.shape[0] == w and arr.shape[1] == h:
        return arr.swapaxes(0, 1)
    return arr


def correct_preds_orientation(preds: Sequence[Dict],
                              views: Optional[Sequence[Dict]]) -> None:
    """In place: each predicted map becomes a per-sample list in its true
    orientation (safe to call twice)."""
    if views is None:
        return
    for pred, view in zip(preds, views):
        ts = np.asarray(view["true_shape"])
        keys = ["conf", "pts3d_in_other_view"]
        if "pts3d_local" in pred:
            keys += ["conf_local", "pts3d_local"]
            if "pts3d_local_aligned_to_global" in pred:
                keys.append("pts3d_local_aligned_to_global")
        for key in keys:
            pred[key] = [_maybe_untranspose(pred[key][i], ts[i])
                         for i in range(ts.shape[0])]


def _view_seed(seed: int, v: int) -> int:
    """The generator seed of view v's solve when shapes are mixed."""
    return (seed << 16) + v + 1


def _pnp_inputs(pts3d: torch.Tensor, conf: torch.Tensor):
    """(V, N, 3) points, the (N, 2) pixel grid, the conf > 1 mask (V, N)
    and the principal point of V same-shape views."""
    V, H, W, _ = pts3d.shape
    pp = torch.tensor([W / 2.0, H / 2.0], dtype=pts3d.dtype,
                      device=pts3d.device)
    pixels = xy_grid(W, H, pts3d.dtype, pts3d.device).reshape(-1, 2)
    return pts3d.reshape(V, -1, 3), pixels, conf.reshape(V, -1) > 1.0, pp


def individual_focals(pts3d: torch.Tensor, conf: torch.Tensor,
                      niter: int = 32,
                      generator: Optional[torch.Generator] = None,
                      sample_idx=None) -> torch.Tensor:
    """A focal a view of V same-shape views, (V,): the focal of
    ``focal_grid`` whose RANSAC-PnP finds the most inliers."""
    V, H, W, _ = pts3d.shape
    pts, pixels, mask, pp = _pnp_inputs(pts3d, conf)
    return focal_sweep(pts, pixels, mask, focal_grid(H, W, pts3d.dtype,
                                                     pts3d.device),
                       pp, iters=niter, generator=generator,
                       sample_idx=sample_idx)


def estimate_poses(pts3d: torch.Tensor, conf: torch.Tensor, focal=None,
                   niter: int = 32,
                   generator: Optional[torch.Generator] = None,
                   sample_idx=None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Poses of V same-shape views of one sample on their device:
    pts3d (V, H, W, 3) in view 0's frame, conf (V, H, W); ``focal`` one for
    all views or one a view (V,), by default view 0's Weiszfeld focal.
    Returns c2w (V, 4, 4), inlier counts (V,) and the focal used."""
    if focal is None:
        focal = estimate_focal_weiszfeld(pts3d[0], conf[0], 10.0)
    focal = torch.as_tensor(focal, dtype=pts3d.dtype, device=pts3d.device)
    pts, pixels, mask, pp = _pnp_inputs(pts3d, conf)
    c2w, inl = pnp_ransac(pts, pixels, mask, focal, pp, iters=niter,
                          generator=generator, sample_idx=sample_idx)
    return c2w, inl, focal


def estimate_camera_poses(
    preds: Sequence[Dict], views: Optional[Sequence[Dict]] = None,
    niter_PnP: int = 10,
    focal_length_estimation_method: str = "first_view_from_global_head",
    backend: str = "torch", seed: int = 0, device="cuda",
    sample_idx: Optional[Sequence] = None,
) -> Tuple[List[List[np.ndarray]], List[List[float]]]:
    """Per-view c2w poses (4x4 float32 numpy) and focals, [B][V].

    preds: per view, "pts3d_in_other_view" (B, H, W, 3) and "conf"
    (B, H, W) (tensors, arrays or per-sample lists); views, when given,
    carry "true_shape" to un-transpose portrait maps.  ``sample_idx``, one
    (V, iters, 8) index array per sample, replaces the random minimal
    samples (row v for view v; with "individual" focals the focal search
    takes the same samples).  The focal search of "individual" draws its
    samples first from the generator the poses' draws then continue."""
    if focal_length_estimation_method not in FOCAL_METHODS:
        raise ValueError(focal_length_estimation_method)
    if backend != "torch":
        raise ValueError(f"backend {backend!r}: the port has 'torch' only")
    V = len(preds)
    B = len(preds[0]["pts3d_in_other_view"])
    use_local = focal_length_estimation_method == "first_view_from_local_head"
    if use_local and "pts3d_local_aligned_to_global" not in preds[0]:
        from fast3r_torch.eval.recon import align_local_pts3d_to_global

        align_local_pts3d_to_global(preds, views, device=device)

    def sample_map(v: int, key: str, b: int) -> torch.Tensor:
        arr = torch.as_tensor(preds[v][key][b]).to(device).float()
        hw = np.asarray(views[v]["true_shape"])[b] if views is not None \
            else None
        return _maybe_untranspose(arr, hw)

    niter = max(niter_PnP, 32)
    poses_all, focals_all = [], []
    for b in range(B):
        pts = [sample_map(v, "pts3d_in_other_view", b) for v in range(V)]
        conf = [sample_map(v, "conf", b) for v in range(V)]
        focal = None   # "individual": a focal a view, below
        if use_local:
            focal = estimate_focal_weiszfeld(
                sample_map(0, "pts3d_local_aligned_to_global", b),
                sample_map(0, "conf_local", b), 10.0)
        elif focal_length_estimation_method != "individual":
            focal = estimate_focal_weiszfeld(pts[0], conf[0], 10.0)
        idx = None if sample_idx is None else torch.as_tensor(
            sample_idx[b], device=device)

        def solve(p, c, gen, ix):
            f = (individual_focals(p, c, niter, gen, ix) if focal is None
                 else focal)
            c2w, _, f = estimate_poses(p, c, f, niter, gen, ix)
            return c2w, f.expand(p.shape[0])

        if len({tuple(p.shape) for p in pts}) == 1:
            gen = torch.Generator(device=device).manual_seed(seed)
            c2w, f = solve(torch.stack(pts), torch.stack(conf), gen, idx)
        else:
            c2w, f = (torch.cat(x) for x in zip(*[solve(
                pts[v][None], conf[v][None],
                torch.Generator(device=device).manual_seed(_view_seed(seed, v)),
                None if idx is None else idx[v:v + 1]) for v in range(V)]))
        c2w = c2w.cpu().numpy()
        poses_all.append([c2w[v] for v in range(V)])
        focals_all.append([float(x) for x in f.cpu()])
    return poses_all, focals_all
