"""Bilinear resize with ``align_corners=True`` semantics.

Counterpart of ``fast3r_tpu/ops/resize.py``: the same (out, in) interpolation
matrices and 2-tap form, built on the host in numpy, applied to NCHW tensors
(rows first, then columns).  :func:`resize_matmul` is the plain version (the
JAX package's ``_resize_matmul``); :func:`resize_bilinear_align_corners`
sends a CUDA bf16 tensor at the regression trunk's scale to the
hand-written kernel (``ops/resize_kernel.py``, K12), as the JAX package
sends it to its Pallas kernel, and everything else to the plain version.
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
