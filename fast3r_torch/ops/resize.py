"""Bilinear resize with ``align_corners=True`` semantics.

Counterpart of ``fast3r_tpu/ops/resize.py``: the same (out, in) interpolation
matrices and 2-tap form, built on the host in numpy, applied to NCHW tensors
(rows first, then columns).  :func:`resize_matmul` is the plain version (the
JAX package's ``_resize_matmul``); :func:`resize_bilinear_align_corners`
sends a CUDA bf16 tensor at the regression trunk's scale to the
hand-written kernel (``ops/resize_kernel.py``, K12), as the JAX package
sends it to its Pallas kernel, and everything else to the plain version.
:func:`resize_bicubic_torch` is the DINOv2 encoder's position-embedding
resize (torch's bicubic numerics, two products), a plain tensor op.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=256)
def _interp_matrix(out_size: int, in_size: int) -> np.ndarray:
    """(out, in) matrix M with ``y = M @ x`` = align_corners=True linear interp."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    if out_size == 1:
        m[0, 0] = 1.0
        return m
    lo, hi, frac = _interp_taps(out_size, in_size)
    np.add.at(m, (np.arange(out_size), lo), 1.0 - frac)
    np.add.at(m, (np.arange(out_size), hi), frac)
    return m


@functools.lru_cache(maxsize=256)
def _interp_taps(out_size: int, in_size: int):
    """(lo, hi, frac) 2-tap form: out[i] = (1-frac) in[lo] + frac in[hi]."""
    if out_size == 1 or in_size == 1:
        z = np.zeros(out_size, dtype=np.int32)
        return z, z, np.zeros(out_size, dtype=np.float32)
    scale = (in_size - 1) / (out_size - 1)
    src = np.arange(out_size, dtype=np.float64) * scale
    lo = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = (src - lo).astype(np.float32)
    return lo.astype(np.int32), hi.astype(np.int32), frac


def resize_matmul(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize NCHW (B, C, H, W) -> (B, C, out_h, out_w), align_corners=True,
    as two products with the interpolation matrices in the input dtype."""
    _, _, h, w = x.shape
    if h != out_h:
        mh = torch.as_tensor(_interp_matrix(out_h, h), dtype=x.dtype,
                             device=x.device)
        x = torch.einsum("Oh,bchw->bcOw", mh, x)
    if w != out_w:
        mw = torch.as_tensor(_interp_matrix(out_w, w), dtype=x.dtype,
                             device=x.device)
        x = torch.einsum("Ow,bchw->bchO", mw, x)
    return x


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int,
                                  out_w: int) -> torch.Tensor:
    """Resize NCHW (B, C, H, W) -> (B, C, out_h, out_w), align_corners=True.

    A CUDA tensor that ``resize_kernel_supported`` accepts (bf16, 128k
    channels, trunk scale) launches the kernel; everything else, every
    fusion-block upsample included, takes :func:`resize_matmul`."""
    if x.device.type == "cuda":
        from fast3r_torch.ops.resize_kernel import (
            resize_bilinear_kernel,
            resize_kernel_supported,
        )

        if resize_kernel_supported(x.shape, out_h, out_w, x.dtype):
            return resize_bilinear_kernel(x, out_h, out_w)
    return resize_matmul(x, out_h, out_w)


def upsample2x_align_corners(x: torch.Tensor) -> torch.Tensor:
    """scale_factor=2 shortcut: output size is twice the input."""
    _, _, h, w = x.shape
    return resize_bilinear_align_corners(x, 2 * h, 2 * w)


# ---------------------------------------------------------------------------
# torch-parity bicubic (A = -0.75), align_corners=False
# ---------------------------------------------------------------------------

def _cubic(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """The Keys cubic convolution kernel with torch's A = -0.75."""
    x = np.abs(x)
    return np.where(
        x <= 1.0,
        ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
        np.where(x < 2.0, ((x - 5.0) * x + 8.0) * x - 4.0, 0.0) * a,
    )


@functools.lru_cache(maxsize=256)
def _bicubic_matrix(out_size: int, in_size: int,
                    scale: float | None = None) -> np.ndarray:
    """(out, in) matrix of ``F.interpolate(mode="bicubic",
    align_corners=False, antialias=False)``: src = (dst + 0.5) / scale - 0.5
    with ``scale`` the ``scale_factor`` when given, else out / in (the
    ``size=`` form); taps past the edges clamp to it."""
    s = float(scale) if scale is not None else out_size / in_size
    dst = np.arange(out_size, dtype=np.float64)
    src = (dst + 0.5) / s - 0.5
    lo = np.floor(src).astype(np.int64)
    frac = src - lo
    m = np.zeros((out_size, in_size), dtype=np.float64)
    for tap in range(-1, 3):
        idx = np.clip(lo + tap, 0, in_size - 1)
        np.add.at(m, (np.arange(out_size), idx), _cubic(frac - tap))
    return m.astype(np.float32)


def resize_bicubic_torch(x: torch.Tensor, out_h: int, out_w: int,
                         scale_factors=None) -> torch.Tensor:
    """Resize channel-last (B, H, W, C) with torch's bicubic numerics
    (A = -0.75, align_corners=False, no antialias) as two products with the
    interpolation matrices in x's dtype: the JAX package's
    ``resize_bicubic_torch``.  ``scale_factors`` (sh, sw) gives torch's
    ``scale_factor=`` coordinate mapping (hub DINOv2 passes (n + 0.1) / M);
    None the ``size=`` mapping."""
    _, h, w, _ = x.shape
    sh, sw = scale_factors if scale_factors is not None else (None, None)
    if h != out_h or sh is not None:
        mh = torch.as_tensor(_bicubic_matrix(out_h, h, sh), dtype=x.dtype,
                             device=x.device)
        x = torch.einsum("Oh,bhwc->bOwc", mh, x)
    if w != out_w or sw is not None:
        mw = torch.as_tensor(_bicubic_matrix(out_w, w, sw), dtype=x.dtype,
                             device=x.device)
        x = torch.einsum("Ow,bhwc->bhOc", mw, x)
    return x
