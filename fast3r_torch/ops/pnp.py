"""Focal and camera-pose recovery from pointmaps, on the device.

Counterpart of ``fast3r_tpu/ops/pnp.py`` (``estimate_focal_weiszfeld``,
``_project_so3``, ``_dlt_pose``, ``_skew``, ``_exp_so3``,
``_gauss_newton_polish``, ``_reproj_errors``, ``pnp_ransac_jax``):

  * focal: Weiszfeld IRLS over the pixels whose confidence reaches a
    percentile;
  * pose: multi-start LO-RANSAC.  Every minimal-sample hypothesis (an
    8-point weighted DLT, the smallest eigenvector of a 12x12 normal matrix,
    projected onto SO(3)) is polished by a Levenberg-damped Gauss-Newton
    with an annealed Huber width over all masked points and ranked by the
    truncated cost sum(min(err, thr)); the best is refit on its inliers and
    polished twice more.

The JAX package maps over views and vmaps over hypotheses; here the views x
hypotheses are one batch of tensors, cut into chunks of views so that the
(batch, points, 2, 6) Jacobians stay bounded.  The focal may be one for all
views or one a view.  The minimal samples come from a ``torch.Generator``
or are passed in as a (V, iters, sample_size) index tensor (the way to
reproduce another implementation's draws).  The cv2 backend
(``fast_pnp_cv2``) is not ported; :func:`focal_sweep` is its focal search
(a RANSAC-PnP at each of 100 focals, the most inliers winning) with the
focals as a leading axis of the hypotheses.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from fast3r_torch.ops.geometry import xy_grid

# hypotheses x points per polish chunk: bounds the Jacobians at ~0.2 GB
CHUNK_POINTS = 1 << 22
# hypotheses x points per scoring chunk of the focal search (a few
# (chunk, 3) fp32 temporaries, about 0.4 GB each)
SWEEP_CHUNK_POINTS = 1 << 25
NUM_FOCALS = 100   # fast_pnp_cv2's num_guessed_focals
# matrices a batched eigh call takes: the H100's cuSOLVER (CUDA 12.8) turns
# down batches of 32,767 12x12 matrices and more, takes 16,384
# (scripts/probe_eigh_batch.py)
EIGH_BATCH = 1 << 14


def estimate_focal_weiszfeld(pts3d: torch.Tensor,
                             conf: Optional[torch.Tensor] = None,
                             min_conf_percentile: float = 10.0,
                             iters: int = 100,
                             pp: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Weiszfeld focal of an (H, W, 3) pointmap over the pixels whose
    confidence is at least its ``min_conf_percentile`` percentile; a 0-d
    tensor on the pointmap's device."""
    H, W, _ = pts3d.shape
    dev, dt = pts3d.device, pts3d.dtype
    if pp is None:
        pp = torch.tensor([W / 2.0, H / 2.0], dtype=dt, device=dev)
    px = (xy_grid(W, H, dt, dev) - pp).reshape(-1, 2)
    if conf is None:
        m = torch.ones(H * W, dtype=dt, device=dev)
    else:
        c = conf.reshape(-1)
        m = (c >= torch.quantile(c, min_conf_percentile / 100.0)).to(dt)
    xy = pts3d[..., :2].reshape(-1, 2)
    z = pts3d[..., 2:3].reshape(-1, 1)
    xy_over_z = torch.where(z.abs() > 0, xy / z, torch.zeros_like(xy))
    xy_over_z = torch.nan_to_num(xy_over_z, posinf=0.0, neginf=0.0)
    dot_xy_px = (xy_over_z * px).sum(-1)
    dot_xy_xy = (xy_over_z ** 2).sum(-1)
    nvalid = m.sum().clamp(min=1.0)
    focal = (dot_xy_px * m).sum() / nvalid / ((dot_xy_xy * m).sum() / nvalid)
    for _ in range(iters):
        dis = torch.linalg.norm(px - focal * xy_over_z, dim=-1)
        w = m / dis.clamp(min=1e-8)
        focal = (w * dot_xy_px).sum() / (w * dot_xy_xy).sum()
    return focal


def _project_so3(M: torch.Tensor) -> torch.Tensor:
    """Nearest rotations of (..., 3, 3) matrices (SVD, det +1)."""
    u, _, vt = torch.linalg.svd(M)
    d = torch.sign(torch.linalg.det(u @ vt))
    ones = torch.ones_like(d)
    return (u * torch.stack([ones, ones, d], -1)[..., None, :]) @ vt


def _gram(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a^T b for (B, S, p) and (B, S, q) -> (B, p, q), the long S axis cut
    into up to 64 slices that are multiplied as one batch and summed: a
    (B, p, S) @ (B, S, q) product with S in the hundreds of thousands
    gives one tile per batch entry and leaves most of a GPU idle."""
    B, S, p = a.shape
    c = math.gcd(S, 64)
    prod = a.reshape(B * c, S // c, p).transpose(-1, -2) @ b.reshape(
        B * c, S // c, b.shape[-1])
    return prod.reshape(B, c, p, -1).sum(1)


def _dlt_pose(pts3d: torch.Tensor, rays: torch.Tensor, w: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted DLT for [R | t] with known intrinsics, batched: pts3d
    (B, n, 3), normalised pixels rays (B, n, 2), weights (B, n).

    Each point gives u (r3.X + t3) - (r1.X + t1) = 0 and
    v (r3.X + t3) - (r2.X + t2) = 0, linear in p = [r1 t1 r2 t2 r3 t3]; p is
    the smallest eigenvector of A^T W A."""
    B, n, _ = pts3d.shape
    Xh = torch.cat([pts3d, torch.ones_like(pts3d[..., :1])], -1)  # (B, n, 4)
    zero = torch.zeros_like(Xh)
    u, v = rays[..., 0:1], rays[..., 1:2]
    A = torch.cat([torch.cat([-Xh, zero, u * Xh], -1),
                   torch.cat([zero, -Xh, v * Xh], -1)], -2)  # (B, 2n, 12)
    ww = torch.cat([w, w], -1)[..., None]
    G = _gram(A * ww, A)
    P = torch.cat([torch.linalg.eigh(G[i:i + EIGH_BATCH])[1][..., 0]
                   for i in range(0, B, EIGH_BATCH)]).reshape(B, 3, 4)
    M, t = P[..., :3], P[..., 3]
    # scale by det(M)^(1/3); sign: most (weighted) points in front
    scale = torch.linalg.det(M).abs().pow(1.0 / 3.0)
    scale = torch.where(scale > 1e-12, scale, torch.ones_like(scale))
    M, t = M / scale[:, None, None], t / scale[:, None]
    depth = (pts3d @ M[:, 2, :, None])[..., 0] + t[:, 2:3]
    sign = torch.sign((torch.sign(depth) * w).sum(-1))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    return _project_so3(M * sign[:, None, None]), t * sign[:, None]


def _skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrices."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1),
    ], -2)


def _exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues exp map of (..., 3) axis-angle vectors."""
    th = torch.linalg.norm(w, dim=-1)[..., None, None]
    K = _skew(w)
    big = th > 1e-8
    safe = torch.where(big, th, torch.ones_like(th))
    a = torch.where(big, torch.sin(th) / safe, torch.ones_like(th))
    b = torch.where(big, (1.0 - torch.cos(th)) / safe ** 2,
                    torch.full_like(th, 0.5))
    return torch.eye(3, dtype=w.dtype, device=w.device) + a * K + b * (K @ K)


def _batch_focal(focal):
    """A focal for (B, N, k) arithmetic: one for the batch as it is, one a
    batch entry (B,) as (B, 1, 1)."""
    if torch.is_tensor(focal) and focal.dim() > 0:
        return focal.reshape(-1, 1, 1)
    return focal


def _gauss_newton_polish(pts3d, pixels, w, focal, pp, R, t, iters: int = 8,
                         huber_px: float = 2.5,
                         huber_px_start: Optional[float] = None,
                         damping: float = 1e-6):
    """Levenberg-damped Gauss-Newton on the reprojection residual with a
    Huber width annealed geometrically from ``huber_px_start`` (8x the
    final width by default) to ``huber_px``; left-multiplicative so(3)
    updates.  Batched: pts3d (B, N, 3), pixels (N, 2), w (B, N), R
    (B, 3, 3), t (B, 3), focal a scalar or (B,).  Points closer than 1% of
    the mean scene distance are left out of each step (their Jacobian
    leverage would swamp JtJ)."""
    focal = _batch_focal(focal)
    if huber_px_start is None:
        huber_px_start = 8.0 * huber_px
    decay = (huber_px / huber_px_start) ** (1.0 / max(iters - 1, 1))
    wsum = w.sum(-1)
    scene_scale = (torch.linalg.norm(pts3d, dim=-1) * w).sum(-1) \
        / wsum.clamp(min=1.0)
    z_min = (0.01 * scene_scale + 1e-6)[:, None]
    eye6 = torch.eye(6, dtype=pts3d.dtype, device=pts3d.device)
    for i in range(iters):
        huber_i = huber_px_start * decay ** i
        cam = pts3d @ R.transpose(-1, -2) + t[:, None]   # (B, N, 3)
        inv_z = 1.0 / cam[..., 2].clamp(min=1e-6)
        r = cam[..., :2] * inv_z[..., None] * focal + pp - pixels
        # the projection's Jacobian dp/dcam = f [[1/z, 0, -x/z^2],
        # [0, 1/z, -y/z^2]] times dcam/d(dw, dt) = [-skew(R X) | I],
        # written out per point (a batched 2x3 @ 3x3 product would launch
        # one tiny GEMM per point)
        x, y = cam[..., 0], cam[..., 1]
        a, b, c = (cam - t[:, None]).unbind(-1)            # R X
        iz2 = inv_z * inv_z
        zero = torch.zeros_like(inv_z)
        J = torch.stack([
            torch.stack([-x * iz2 * b, inv_z * c + x * iz2 * a, -inv_z * b,
                         inv_z, zero, -x * iz2], -1),
            torch.stack([-inv_z * c - y * iz2 * b, y * iz2 * a, inv_z * a,
                         zero, inv_z, -y * iz2], -1),
        ], -2).flatten(1, 2) * focal                       # (B, 2N, 6)
        rn = torch.linalg.norm(r, dim=-1)
        hub = (huber_i / rn.clamp(min=1e-9)).clamp(max=1.0)
        ww = (w * hub * (cam[..., 2] > z_min)).repeat_interleave(2, -1)
        Jw = J * ww[..., None]
        JtJ = _gram(Jw, J)
        lam = damping * (JtJ.diagonal(dim1=-2, dim2=-1).sum(-1) / 6.0 + 1.0)
        JtJ = JtJ + lam[:, None, None] * eye6
        delta = -torch.linalg.solve(JtJ, _gram(Jw, r.flatten(1)[..., None])
                                    )[..., 0]
        delta = torch.where(torch.isfinite(delta).all(-1, keepdim=True),
                            delta, torch.zeros_like(delta))
        R = _exp_so3(delta[:, :3]) @ R
        t = t + delta[:, 3:]
    return R, t


def _reproj_errors(pts3d, pixels, R, t, focal, pp):
    """(B, N) reprojection errors in pixels; 1e9 behind the camera.  focal:
    a scalar or (B,)."""
    focal = _batch_focal(focal)
    cam = pts3d @ R.transpose(-1, -2) + t[:, None]
    proj = cam[..., :2] / cam[..., 2:3].clamp(min=1e-8) * focal + pp
    err = torch.linalg.norm(proj - pixels, dim=-1)
    return torch.where(cam[..., 2] > 0, err, torch.full_like(err, 1e9))


def draw_samples(mask: torch.Tensor, iters: int, sample_size: int,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """(V, iters, sample_size) point indices drawn uniformly, with
    replacement, from each view's masked points (from all points of a view
    whose mask is empty)."""
    p = mask.float()
    p = p + (p.sum(-1, keepdim=True) == 0).float()
    idx = torch.multinomial(p, iters * sample_size, replacement=True,
                            generator=generator)
    return idx.reshape(mask.shape[0], iters, sample_size)


def pnp_ransac(pts3d: torch.Tensor, pixels: torch.Tensor, mask: torch.Tensor,
               focal, pp: torch.Tensor, iters: int = 32, sample_size: int = 8,
               reproj_thresh: float = 5.0,
               generator: Optional[torch.Generator] = None,
               sample_idx: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-shape RANSAC-PnP of V views at once.

    pts3d (V, N, 3) world points, pixels (N, 2), mask (V, N) valid points,
    focal a scalar or one a view (V,), pp (2,).  The minimal samples are
    ``sample_idx`` (V, iters, sample_size) when given, else drawn from
    ``generator``.  Returns c2w (V, 4, 4) and the inlier counts (V,)."""
    V, N, _ = pts3d.shape
    focal = torch.as_tensor(focal, dtype=pts3d.dtype,
                            device=pts3d.device).expand(V)
    rays = (pixels - pp) / focal[:, None, None]                # (V, N, 2)
    mf = mask.to(pts3d.dtype)
    if sample_idx is None:
        sample_idx = draw_samples(mask, iters, sample_size, generator)
    idx = torch.as_tensor(sample_idx, device=pts3d.device).long()
    iters = idx.shape[1]

    def robust_cost(err, m):
        return (err.clamp(max=reproj_thresh) * m).sum(-1)

    # every hypothesis: a DLT seed, a graduated-robust polish over all
    # masked points, ranked by the truncated cost
    vpc = max(1, CHUNK_POINTS // (iters * N))  # views per chunk
    Rs, ts, costs = [], [], []
    for v0 in range(0, V, vpc):
        p, m, ix = pts3d[v0:v0 + vpc], mf[v0:v0 + vpc], idx[v0:v0 + vpc]
        n = p.shape[0]
        flat = ix.reshape(n, -1)
        seeds = torch.gather(p, 1, flat[..., None].expand(-1, -1, 3))
        seed_rays = torch.gather(rays[v0:v0 + vpc], 1,
                                 flat[..., None].expand(-1, -1, 2))
        R, t = _dlt_pose(seeds.reshape(n * iters, -1, 3),
                         seed_rays.reshape(n * iters, -1, 2),
                         torch.ones(ix.shape, dtype=p.dtype,
                                    device=p.device).reshape(n * iters, -1))
        pb = p[:, None].expand(-1, iters, -1, -1).reshape(n * iters, N, 3)
        mb = m[:, None].expand(-1, iters, -1).reshape(n * iters, N)
        fb = focal[v0:v0 + vpc].repeat_interleave(iters)
        R, t = _gauss_newton_polish(pb, pixels, mb, fb, pp, R, t,
                                    iters=12, huber_px=reproj_thresh / 2.0,
                                    huber_px_start=8.0 * reproj_thresh)
        err = _reproj_errors(pb, pixels, R, t, fb, pp)
        Rs.append(R.reshape(n, iters, 3, 3))
        ts.append(t.reshape(n, iters, 3))
        costs.append(robust_cost(err, mb).reshape(n, iters))
    best = torch.cat(costs).argmin(-1)
    ar = torch.arange(V, device=pts3d.device)
    R0, t0 = torch.cat(Rs)[ar, best], torch.cat(ts)[ar, best]

    # refit on the best model's inliers (weighted DLT), keep it where it
    # lowers the truncated cost, then alternate polish and re-estimation
    err = _reproj_errors(pts3d, pixels, R0, t0, focal, pp)
    w_in = ((err < reproj_thresh) & mask).to(pts3d.dtype)
    cost = robust_cost(err, mf)
    enough = w_in.sum(-1) >= 6
    R1, t1 = _dlt_pose(pts3d, rays, w_in + 1e-9)
    err1 = _reproj_errors(pts3d, pixels, R1, t1, focal, pp)
    cost1 = robust_cost(err1, mf)
    take = enough & (cost1 < cost)
    R = torch.where(take[:, None, None], R1, R0)
    t = torch.where(take[:, None], t1, t0)
    cost = torch.where(take, cost1, cost)
    w_in = torch.where(take[:, None], (err1 < reproj_thresh) & mask,
                       w_in > 0).to(pts3d.dtype)
    for _ in range(2):
        Rp, tp = _gauss_newton_polish(pts3d, pixels, w_in, focal, pp, R, t,
                                      huber_px=reproj_thresh / 2.0,
                                      huber_px_start=reproj_thresh)
        errp = _reproj_errors(pts3d, pixels, Rp, tp, focal, pp)
        costp = robust_cost(errp, mf)
        better = costp <= cost
        R = torch.where(better[:, None, None], Rp, R)
        t = torch.where(better[:, None], tp, t)
        cost = torch.where(better, costp, cost)
        w_in = torch.where(better[:, None], (errp < reproj_thresh) & mask,
                           w_in > 0).to(pts3d.dtype)

    c2w = torch.eye(4, dtype=pts3d.dtype, device=pts3d.device).repeat(V, 1, 1)
    Rt = R.transpose(-1, -2)
    c2w[:, :3, :3] = Rt
    c2w[:, :3, 3] = -(Rt @ t[..., None])[..., 0]
    return c2w, w_in.sum(-1).to(torch.int32)


def focal_grid(height: int, width: int, dtype=torch.float32, device=None,
               num: int = NUM_FOCALS) -> torch.Tensor:
    """fast_pnp_cv2's tentative focals: ``num`` geometrically spaced from
    S / 2 to 3 S, S = max(height, width) (float64, then ``dtype``)."""
    S = max(width, height)
    return torch.as_tensor(np.geomspace(S / 2, S * 3, num=num), dtype=dtype,
                           device=device)


def focal_sweep(pts3d: torch.Tensor, pixels: torch.Tensor, mask: torch.Tensor,
                focals: torch.Tensor, pp: torch.Tensor, iters: int = 32,
                sample_size: int = 8, reproj_thresh: float = 5.0,
                generator: Optional[torch.Generator] = None,
                sample_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A RANSAC-PnP of each of V views at each of F focals, all at once: the
    ``iters`` minimal samples of a view (``sample_idx`` or drawn from
    ``generator``) seed an 8-point DLT at every focal, and each of these
    V x F x iters hypotheses is scored by its inliers, the masked points
    that it reprojects within ``reproj_thresh`` pixels.

    pts3d (V, N, 3), pixels (N, 2), mask (V, N), focals (F,), pp (2,).
    Returns each view's focal whose best hypothesis has the most inliers
    (V,), the smallest of a tie (cv2's search keeps the first)."""
    V, N, _ = pts3d.shape
    F = focals.shape[0]
    if sample_idx is None:
        sample_idx = draw_samples(mask, iters, sample_size, generator)
    idx = torch.as_tensor(sample_idx, device=pts3d.device).long()
    iters, k = idx.shape[1], idx.shape[2]
    flat = idx.reshape(V, -1)
    seeds = torch.gather(pts3d, 1, flat[..., None].expand(-1, -1, 3))
    rays = (pixels[flat] - pp)[:, None] / focals[None, :, None, None]
    H = F * iters                                  # hypotheses a view
    R, t = _dlt_pose(
        seeds.reshape(V, 1, iters, k, 3).expand(V, F, iters, k, 3)
        .reshape(V * H, k, 3), rays.reshape(V * H, k, 2),
        torch.ones((V * H, k), dtype=pts3d.dtype, device=pts3d.device))
    R, t = R.reshape(V, H, 3, 3), t.reshape(V, H, 3)
    fh = focals.repeat_interleave(iters)           # (H,): focal-major
    # only the masked points can be inliers: each view's first, padded to
    # the most any view has
    M = max(int(mask.sum(-1).max()), 1)
    keep = torch.sort(mask.to(torch.uint8), stable=True, dim=-1,
                      descending=True)[1][:, :M]
    pts_m = torch.gather(pts3d, 1, keep[..., None].expand(-1, -1, 3))
    pix_m, mask_m = pixels[keep], torch.gather(mask, 1, keep)
    step = max(1, SWEEP_CHUNK_POINTS // M)
    counts = []
    for v in range(V):
        for h0 in range(0, H, step):
            h1 = min(h0 + step, H)
            err = _reproj_errors(pts_m[v][None].expand(h1 - h0, M, 3),
                                 pix_m[v], R[v, h0:h1], t[v, h0:h1],
                                 fh[h0:h1], pp)
            counts.append(((err < reproj_thresh) & mask_m[v]).sum(-1))
    best = torch.cat(counts).reshape(V, F, iters).amax(-1)    # (V, F)
    return focals[best.argmax(-1)]
