"""2D rotary position embedding (RoPE2D, base 100) for the encoder.

Counterpart of ``fast3r_tpu/ops/rope2d.py`` (``rope2d_cos_sin``,
``apply_rope2d_bnhd``): each head's D lanes split into a y-half and an x-half,
each rotated with 1D RoPE (rotate-half) by the token's y / x patch coordinate,
``inv_freq = 1 / base ** (arange(0, half, 2) / half)`` tiled twice.

Precision: q and k arrive rounded to the activation dtype (the qkv
projection's output) and rotate in fp32, then round back.  This is the
rounding of the JAX package's fused qkv+rope kernel on its default path; its
plain bf16 path rotates in bf16 instead.
"""

from __future__ import annotations

import torch


def rope2d_cos_sin(positions: torch.Tensor, head_dim: int,
                   base: float = 100.0):
    """cos, sin tables of shape (B, N, 2, head_dim // 2), float32, from
    (B, N, 2) integer (y, x) patch coordinates."""
    if head_dim % 4:
        raise ValueError(f"head_dim={head_dim} must be divisible by 4")
    half = head_dim // 2
    inv_freq = 1.0 / (base ** (
        torch.arange(0, half, 2, dtype=torch.float32,
                     device=positions.device) / float(half)))
    freqs = positions.to(torch.float32)[..., None] * inv_freq
    freqs = torch.cat([freqs, freqs], dim=-1)  # (B, N, 2, half)
    return torch.cos(freqs), torch.sin(freqs)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope2d_bnhd(tokens: torch.Tensor, cos: torch.Tensor,
                      sin: torch.Tensor) -> torch.Tensor:
    """Rotate q or k of shape (B, N, H, D) in fp32; output in the input
    dtype, contiguous."""
    t = tokens.float()
    y, x = t.chunk(2, dim=-1)  # each (B, N, H, half)
    cy, sy = cos[:, :, None, 0, :], sin[:, :, None, 0, :]
    cx, sx = cos[:, :, None, 1, :], sin[:, :, None, 1, :]
    y = y * cy + _rotate_half(y) * sy
    x = x * cx + _rotate_half(x) * sx
    return torch.cat([y, x], dim=-1).to(tokens.dtype)


def expand_rope_tables(cos: torch.Tensor, sin: torch.Tensor, dim: int,
                       dtype) -> tuple:
    """Flat per-token lane tables (B * N, dim) in ``dtype`` from (B, N, 2,
    half) cos / sin: lane l of a head carries the y table for the head's
    first ``half`` lanes and the x table for the rest, tiled over the heads,
    so ``t * ct + rotate_half_lanes(t, half) * st`` on (B * N, dim) rows is
    :func:`apply_rope2d_bnhd` (counterpart of ``fast3r_tpu/ops/rope2d.py``
    ``expand_rope_tables``; the tables are rounded to ``dtype``, the
    activation dtype, as there)."""
    B, N, _, half = cos.shape
    head = 2 * half
    if dim % head:
        raise ValueError(f"dim={dim} is not a multiple of head_dim={head}")

    def flat(t):
        per_head = torch.cat([t[:, :, 0, :], t[:, :, 1, :]], dim=-1)
        return per_head.repeat(1, 1, dim // head).reshape(B * N, dim).to(dtype)

    return flat(cos), flat(sin)


def rotate_half_lanes(x: torch.Tensor, half: int) -> torch.Tensor:
    """Rotate-half on flat (..., C) lanes: within every ``half``-lane group
    [a | b] (a quarter head each) -> [-b | a] (counterpart of
    ``fast3r_tpu/ops/rope2d.py`` ``rotate_half_lanes``)."""
    q = half // 2
    lane = torch.arange(x.shape[-1], device=x.device) % half
    return torch.where(lane < q, -torch.roll(x, -q, dims=-1),
                       torch.roll(x, q, dims=-1))
