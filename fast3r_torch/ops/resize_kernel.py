"""Align-corners bilinear resize: the hand-written CUDA kernel
(``csrc/resize.cu``, K12 of the port), its band plan and the road that
picks it.

Counterpart of ``fast3r_tpu/ops/resize_kernel.py`` (``resize_bilinear_kernel``
-> ``_resize_kern``, gated by ``resize_kernel_supported``).  bf16 in, bf16
out, on the port's NCHW layout: (B, C, h, w) -> (B, C, out_h, out_w).  The
source note in ``resize.cu`` says what bounds it on the H100 and where it
rounds; the plain version is ``ops/resize.resize_matmul``, which rounds at
the same two points.  :func:`band_plan` cuts the output into the items the
kernel's persistent CTAs walk and sizes their shared memory.

Forward-only kernel, as the JAX one: under autograd the backward is the
transposed interpolation matrices as plain products (``_resize_bwd``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from fast3r_torch.kernels import build
from fast3r_torch.ops.resize import _interp_matrix, _interp_taps, resize_matmul

LANE = 128
# the JAX road's trunk-scale floor (resize_kernel.py:136): below it, at the
# fusion-block upsample shapes, the matmul form serves
MIN_ELEMENTS = 192 * 256 * 128


def resize_kernel_supported(shape, out_h: int, out_w: int, dtype) -> bool:
    """(B, C, h, w) -> (B, C, out_h, out_w) on the kernel's road: the JAX
    road's conditions (bf16, h, w, out_h, out_w >= 2, C % 128 == 0, h * w *
    C at trunk scale, and a plan that fits: here :func:`band_plan`'s on
    the bulk road, the larger of its two).  JAX's lane caps are TPU VMEM
    limits, which refuse no head shape of ``make_plan`` at size 512 or 224,
    and stay out.  A shape no band fits takes ``resize_matmul``, as JAX's
    takes its XLA form."""
    if len(shape) != 4 or dtype != torch.bfloat16:
        return False
    _, c, h, w = shape
    if not (c % LANE == 0 and min(h, w, out_h, out_w) >= 2
            and h * w * c >= MIN_ELEMENTS):
        return False
    try:
        band_plan(h, w, out_h, out_w)
    except ValueError:
        return False
    return True


# shared memory a CTA may ask for on the H100 (227 KB), and the plan's
# target: four CTAs on an SM where the shape allows, as many as the
# kernel's 64 registers a thread let in (1 KB of each CTA's share is the
# runtime's)
SMEM_LIMIT = 232448
SMEM_TARGET = SMEM_LIMIT // 4 - 1024
COLS = 8           # output columns a thread computes, one 16-byte store
BAR_BYTES = 64     # the stages' mbarriers (resize.cu kBarBytes)
TAP_BYTES = 8      # a column tap in shared memory (resize.cu Tap)
MAX_BAND_ROWS = 32
STAGES = 2         # the ring of staged input on the bulk-copy road


class BandPlan(NamedTuple):
    """How ``csrc/resize.cu`` walks a resize: items of ``rows`` output rows
    by ``cols`` output columns of one plane; a stage holds ``stage_rows``
    input rows of ``pitch`` elements, the H buffer ``rows`` rows of
    ``pitch``; ``stages`` stages filled by 16-byte bulk copies if ``bulk``,
    else one stage filled with 2-byte copies; ``smem_bytes`` a CTA."""
    rows: int
    cols: int
    stage_rows: int
    pitch: int
    stages: int
    bulk: bool
    smem_bytes: int


def _round_up(n, m: int):
    """n (an int or an integer array) rounded up to a multiple of m."""
    return -(-n // m) * m


def staged_rows(rows: int, out_h: int, h: int):
    """Each row band's output rows [i0, i1) and the input rows [r0, r1]
    it stages (the kernel's own choice: ``lo_h[i0]`` .. ``hi_h[i1 - 1]``)."""
    lo, hi, _ = _interp_taps(out_h, h)
    i0 = np.arange(0, out_h, rows)
    i1 = np.minimum(i0 + rows, out_h)
    return i0, i1, lo[i0], hi[i1 - 1]


def staged_cols(cols: int, out_w: int, w: int, bulk: bool):
    """Each column band's output columns [j0, j1) and the input columns
    [c0, c0 + span) it stages: from ``lo_w[j0]`` to ``hi_w[j1 - 1]``, on the
    bulk road widened to whole 16-byte words."""
    lo, hi, _ = _interp_taps(out_w, w)
    j0 = np.arange(0, out_w, cols)
    j1 = np.minimum(j0 + cols, out_w)
    c0, c1 = lo[j0], hi[j1 - 1] + 1
    if bulk:
        c0 = c0 // COLS * COLS
        c1 = np.minimum(w, _round_up(c1, COLS))
    return j0, j1, c0, c1 - c0


def smem_bytes(rows: int, cols: int, stage_rows: int, pitch: int,
               stages: int) -> int:
    """The dynamic shared memory of a CTA (resize.cu smem_bytes): the
    mbarriers, the taps of a column band, the stages and two H buffers."""
    return (BAR_BYTES + _round_up(cols, COLS) * TAP_BYTES
            + (stages * stage_rows + 2 * rows) * pitch * 2)


@functools.lru_cache(maxsize=64)
def band_plan(h: int, w: int, out_h: int, out_w: int,
              aligned: bool = True) -> BandPlan:
    """The items of (h, w) -> (out_h, out_w): whole output rows if they fit,
    in bands of up to 32 rows, the widest band under ``SMEM_TARGET``, else
    under ``SMEM_LIMIT``; column bands (a multiple of 8 columns) only where
    a single row does not fit.  The bulk road needs rows of a multiple of 16
    bytes (w % 8 == 0) and a 16-byte aligned input (``aligned``).  Raises
    ValueError when not even one output row of 8 columns fits."""
    bulk = aligned and w % COLS == 0
    stages = STAGES if bulk else 1
    col_choices = [out_w] + [
        _round_up(-(-out_w // n), COLS) for n in (2, 4, 8, 16, 32, 64, 128)]
    col_choices = sorted({c for c in col_choices if c <= out_w and c > 0},
                         reverse=True)
    row_choices = sorted({min(MAX_BAND_ROWS >> i, out_h)
                          for i in range(MAX_BAND_ROWS.bit_length())},
                         reverse=True)
    for limit in (SMEM_TARGET, SMEM_LIMIT):
        for cols in col_choices:
            _, _, _, span = staged_cols(cols, out_w, w, bulk)
            pitch = _round_up(int(span.max()), COLS)
            for rows in row_choices:
                _, _, r0, r1 = staged_rows(rows, out_h, h)
                stage_rows = int((r1 - r0).max()) + 1
                smem = smem_bytes(rows, cols, stage_rows, pitch, stages)
                if smem <= limit:
                    return BandPlan(rows, cols, stage_rows, pitch, stages,
                                    bulk, smem)
    raise ValueError(f"resize kernel: no band of ({h}, {w}) -> ({out_h}, "
                     f"{out_w}) fits {SMEM_LIMIT} bytes of shared memory")


@functools.lru_cache(maxsize=64)
def _taps(out_size: int, in_size: int, device: torch.device
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The (lo, hi, frac) tables of ``_interp_taps`` on ``device``."""
    lo, hi, frac = _interp_taps(out_size, in_size)
    return tuple(torch.from_numpy(a).to(device) for a in (lo, hi, frac))


def _launch(x: torch.Tensor, out_h: int, out_w: int,
            ctas: int = 0) -> torch.Tensor:
    """Check what the kernel takes and launch it on ``ctas`` persistent
    CTAs (0: as many as fit on the SMs); counts nothing."""
    if x.device.type != "cuda" or x.dtype != torch.bfloat16 or x.dim() != 4:
        raise ValueError(f"resize kernel: needs a 4-D bf16 CUDA tensor, got "
                         f"{tuple(x.shape)} {x.dtype} on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"resize kernel: x must be contiguous NCHW, got "
                         f"strides {x.stride()}")
    b, c, h, w = x.shape
    if b * c >= 2 ** 31 or (b * c and min(h, w) < 1):
        raise ValueError(f"resize kernel: cannot take {tuple(x.shape)}")
    out = torch.empty((b, c, out_h, out_w), device=x.device, dtype=x.dtype)
    if not out.numel():
        return out
    plan = band_plan(h, w, out_h, out_w, x.data_ptr() % 16 == 0)
    lo_h, hi_h, fr_h = _taps(out_h, h, x.device)
    lo_w, hi_w, fr_w = _taps(out_w, w, x.device)
    err = build.library().fast3r_resize_bilinear(
        x.data_ptr(), out.data_ptr(), lo_h.data_ptr(), hi_h.data_ptr(),
        fr_h.data_ptr(), lo_w.data_ptr(), hi_w.data_ptr(), fr_w.data_ptr(),
        b * c, h, w, out_h, out_w, plan.rows, plan.cols, plan.stage_rows,
        plan.pitch, plan.stages, int(plan.bulk), ctas,
        build.stream_handle(x.device))
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
