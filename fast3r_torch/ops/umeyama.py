"""Weighted similarity point-set registration (Umeyama).

Counterpart of ``fast3r_tpu/ops/umeyama.py`` (``rigid_points_registration``,
``apply_similarity``): the closed-form weighted Umeyama alignment, batched
over any leading axes (one solve per view in one call).  Returns (R, t, s)
such that y ≈ s * (x @ R^T) + t.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def rigid_points_registration(x: torch.Tensor, y: torch.Tensor,
                              weights: Optional[torch.Tensor] = None,
                              compute_scaling: bool = True,
                              eps: float = 1e-12
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Weighted Umeyama alignment x -> y.

    x, y: (..., N, 3) corresponding points; weights: (..., N) non-negative
    (uniform by default; zero-weight rows are ignored).  Returns R
    (..., 3, 3), t (..., 3) and s (...), in float32."""
    x, y = x.float(), y.float()
    w = torch.ones(x.shape[:-1], device=x.device) if weights is None \
        else weights.float()
    wn = w / w.sum(-1, keepdim=True).clamp(min=eps)  # (..., N)
    mu_x = (wn[..., None] * x).sum(-2)
    mu_y = (wn[..., None] * y).sum(-2)
    xc, yc = x - mu_x[..., None, :], y - mu_y[..., None, :]
    cov = torch.einsum("...n,...ni,...nj->...ij", wn, yc, xc)
    u, d, vt = torch.linalg.svd(cov)
    det = torch.linalg.det(u @ vt)
    ones = torch.ones_like(det)
    sgn = torch.stack([ones, ones, torch.sign(det)], dim=-1)  # (..., 3)
    R = (u * sgn[..., None, :]) @ vt
    if compute_scaling:
        var_x = (wn * (xc * xc).sum(-1)).sum(-1)
        s = (d * sgn).sum(-1) / var_x.clamp(min=eps)
    else:
        s = ones
    t = mu_y - s[..., None] * (R @ mu_x[..., None])[..., 0]
    return R, t, s


def apply_similarity(x: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
                     s: torch.Tensor) -> torch.Tensor:
    """y = s * (x @ R^T) + t, batched over the leading axes."""
    return s[..., None, None] * (x @ R.transpose(-1, -2)) + t[..., None, :]
