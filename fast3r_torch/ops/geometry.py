"""Pixel grids and rigid transforms of pointmaps, for the training losses
and pose recovery.

Counterpart of ``fast3r_tpu/ops/geometry.py`` (``xy_grid``, ``geotrf``,
``se3_inverse``): batched einsums, the SE(3) inverse in closed form.
"""

from __future__ import annotations

import torch


def xy_grid(W: int, H: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(H, W, 2) with out[j, i] = (i, j): pixel x, y coordinates."""
    ys, xs = torch.meshgrid(torch.arange(H, dtype=dtype, device=device),
                            torch.arange(W, dtype=dtype, device=device),
                            indexing="ij")
    return torch.stack([xs, ys], dim=-1)


def geotrf(trf: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply batched (B, d+1, d+1) or (B, d, d) transforms to pointmaps
    (B, ..., d)."""
    d = pts.shape[-1]
    flat = pts.reshape(pts.shape[0], -1, d)
    if trf.shape[-1] == d:
        out = torch.einsum("bij,bnj->bni", trf, flat)
    elif trf.shape[-1] == d + 1:
        out = (torch.einsum("bij,bnj->bni", trf[:, :d, :d], flat)
               + trf[:, None, :d, d])
    else:
        raise ValueError(f"bad transform shape {tuple(trf.shape)} for pts "
                         f"dim {d}")
    return out.reshape(pts.shape)


def se3_inverse(t: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (..., 4, 4) rigid transforms."""
    rt = t[..., :3, :3].transpose(-1, -2)
    ti = -torch.einsum("...ij,...j->...i", rt, t[..., :3, 3])
    top = torch.cat([rt, ti[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=t.dtype,
                          device=t.device).expand(t.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)
