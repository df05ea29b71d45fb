"""Align-corners bilinear resize: the hand-written CUDA kernel
(``csrc/resize.cu``, K12 of the port) and the road that picks it.

Counterpart of ``fast3r_tpu/ops/resize_kernel.py`` (``resize_bilinear_kernel``
-> ``_resize_kern``, gated by ``resize_kernel_supported``).  bf16 in, bf16
out, on the port's NCHW layout: (B, C, h, w) -> (B, C, out_h, out_w).  The
source note in ``resize.cu`` says what bounds it on the H100 and where it
rounds; the plain version is ``ops/resize.resize_matmul``, which rounds at
the same two points.

Forward-only kernel, as the JAX one: under autograd the backward is the
transposed interpolation matrices as plain products (``_resize_bwd``).
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from fast3r_torch.kernels import build
from fast3r_torch.ops.resize import _interp_matrix, _interp_taps, resize_matmul

LANE = 128
# the JAX road's trunk-scale floor (resize_kernel.py:136): below it, at the
# fusion-block upsample shapes, the matmul form serves
MIN_ELEMENTS = 192 * 256 * 128


def resize_kernel_supported(shape, out_h: int, out_w: int, dtype) -> bool:
    """(B, C, h, w) -> (B, C, out_h, out_w) on the kernel's road: the JAX
    road's conditions (bf16, h, w, out_h, out_w >= 2, C % 128 == 0, and
    h * w * C at trunk scale).  Its lane caps and row-plan checks are TPU
    VMEM limits, which refuse no head shape of ``make_plan`` at size 512
    or 224, and stay out."""
    if len(shape) != 4 or dtype != torch.bfloat16:
        return False
    _, c, h, w = shape
    return (c % LANE == 0 and min(h, w, out_h, out_w) >= 2
            and h * w * c >= MIN_ELEMENTS)


@functools.lru_cache(maxsize=64)
def _taps(out_size: int, in_size: int, device: torch.device
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The (lo, hi, frac) tables of ``_interp_taps`` on ``device``."""
    lo, hi, frac = _interp_taps(out_size, in_size)
    return tuple(torch.from_numpy(a).to(device) for a in (lo, hi, frac))


def _launch(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Check what the kernel takes and launch it (counts nothing)."""
    if x.device.type != "cuda" or x.dtype != torch.bfloat16 or x.dim() != 4:
        raise ValueError(f"resize kernel: needs a 4-D bf16 CUDA tensor, got "
                         f"{tuple(x.shape)} {x.dtype} on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"resize kernel: x must be contiguous NCHW, got "
                         f"strides {x.stride()}")
    b, c, h, w = x.shape
    out = torch.empty((b, c, out_h, out_w), device=x.device, dtype=x.dtype)
    lo_h, hi_h, fr_h = _taps(out_h, h, x.device)
    lo_w, hi_w, fr_w = _taps(out_w, w, x.device)
    err = build.library().fast3r_resize_bilinear(
        x.data_ptr(), out.data_ptr(), lo_h.data_ptr(), hi_h.data_ptr(),
        fr_h.data_ptr(), lo_w.data_ptr(), hi_w.data_ptr(), fr_w.data_ptr(),
        b * c, h, w, out_h, out_w, build.stream_handle(x.device))
    build.check(err, "fast3r_resize_bilinear")
    return out


def _resize_bwd(g: torch.Tensor, in_hw: Tuple[int, int]) -> torch.Tensor:
    """The transposed interpolation matrices in g's dtype (resize is linear,
    so this is its exact vector-Jacobian product)."""
    h, w = in_hw
    _, _, out_h, out_w = g.shape
    if w != out_w:
        mw = torch.as_tensor(_interp_matrix(out_w, w), dtype=g.dtype,
                             device=g.device)
        g = torch.einsum("Ow,bchO->bchw", mw, g)
    if h != out_h:
        mh = torch.as_tensor(_interp_matrix(out_h, h), dtype=g.dtype,
                             device=g.device)
        g = torch.einsum("Oh,bcOw->bchw", mh, g)
    return g


class _Resize(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, out_h, out_w):
        ctx.in_hw = tuple(x.shape[2:])
        return _launch(x, out_h, out_w)

    @staticmethod
    def backward(ctx, g):
        return _resize_bwd(g, ctx.in_hw), None, None


def resize_bilinear_kernel(x: torch.Tensor, out_h: int,
                           out_w: int) -> torch.Tensor:
    """Bilinear align_corners=True resize of NCHW x to (out_h, out_w).

    CPU tensors take the plain version (``resize_matmul``).  CUDA tensors
    launch the kernel, which takes contiguous bf16 only; anything else
    raises.  Differentiable (the backward is plain products)."""
    if x.device.type == "cpu":
        return resize_matmul(x, out_h, out_w)
    if torch.is_grad_enabled() and x.requires_grad:
        out = _Resize.apply(x, out_h, out_w)
    else:
        out = _launch(x, out_h, out_w)
    if x.numel():
        resize_bilinear_kernel.launches += 1
    return out


resize_bilinear_kernel.launches = 0
