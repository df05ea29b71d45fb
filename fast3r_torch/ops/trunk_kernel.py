"""DPT regression-head trunk: the hand-written CUDA kernel chain
(``csrc/trunk.cu``, K8) and its plain version.

Counterpart of ``fast3r_tpu/ops/trunk_kernel.py``
(``fused_regression_head_t`` -> ``_trunk_call`` -> ``_trunk_kern``):
conv1 3x3 (Cin -> 128, + b1) on the half-resolution grid -> align-corners
bilinear resize to (out_h, out_w) -> conv2 3x3 (128 -> 128, + b2) -> ReLU ->
1x1 conv3 (128 -> 4, + b3), emitted channel-major as (B, 4, out_h * out_w).
The source note in ``trunk.cu`` says what bounds it on the H100 and how it
is laid out.  Weights come in the port's torch layouts (OIHW).

In bfloat16 the chain is two launches of one wgmma kernel over tiles of
4 x 64 output pixels (:func:`trunk_plan` is its walk, mirrored here for
the tests); conv2 builds each tile's resized input in shared memory from
the window of conv1's output that the tile reads, with the tap tables of
``ops/resize._interp_taps`` (:func:`tap_tables`).

Differentiable: the forward is the kernel, the backward recomputes through
:func:`_plain_head` and differentiates that, as ``_head_t_bwd`` does.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from fast3r_torch.kernels import build
from fast3r_torch.ops.resize import _interp_taps, resize_matmul

TRUNK_CHANNELS = 128
OUT_CHANNELS = 4
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# the bf16 kernel's tile and conv2's window of coarse rows and columns
# (csrc/trunk.cu, hop::)
TILE_ROWS, TILE_COLS = 4, 64
WIN_ROWS, WIN_COLS = 6, 40


@dataclasses.dataclass(frozen=True)
class ConvWalk:
    """One launch's walk: tiles of TILE_ROWS x TILE_COLS output pixels,
    ``ty`` row bands x ``tx`` column bands an image, image-major; CTA b of
    ``grid`` takes tiles b, b + grid, ..."""
    n: int
    h: int
    w: int
    grid: int

    @property
    def ty(self) -> int:
        return -(-self.h // TILE_ROWS)

    @property
    def tx(self) -> int:
        return -(-self.w // TILE_COLS)

    @property
    def tiles(self) -> int:
        return self.n * self.ty * self.tx

    def origin(self, t: int):
        """(image, y0, x0) of tile t, as ``hop::tile_of``."""
        per = self.ty * self.tx
        r = t % per
        return t // per, (r // self.tx) * TILE_ROWS, (r % self.tx) * TILE_COLS

    def tiles_of(self, cta: int):
        return range(cta, self.tiles, self.grid)


@dataclasses.dataclass(frozen=True)
class TrunkPlan:
    conv1: ConvWalk
    conv2: ConvWalk
    windowed: bool  # every conv2 tile's window fits WIN_ROWS x WIN_COLS


def coarse_windows(hh: int, wc: int, out_h: int, out_w: int):
    """Per conv2 row band and column band: the first coarse row and the row
    count, the first coarse column and the column count that the band's
    halo (its rows / columns, one more on each side, clipped to the grid)
    reads through the taps, as ``hop::window_of`` and the tap check of
    ``build_halos`` in ``csrc/trunk.cu`` compute them."""
    lo_y, hi_y, _ = _interp_taps(out_h, hh)
    lo_x, hi_x, _ = _interp_taps(out_w, wc)
    y0 = np.arange(0, out_h, TILE_ROWS)
    x0 = np.arange(0, out_w, TILE_COLS)
    r0 = lo_y[np.maximum(y0 - 1, 0)]
    nr = hi_y[np.minimum(y0 + TILE_ROWS, out_h - 1)] - r0 + 1
    c0 = lo_x[np.maximum(x0 - 1, 0)]
    nc = hi_x[np.minimum(x0 + TILE_COLS, out_w - 1)] - c0 + 1
    return r0, nr, c0, nc


@functools.lru_cache(maxsize=64)
def trunk_plan(n: int, hh: int, wc: int, out_h: int, out_w: int,
               sms: int) -> TrunkPlan:
    """The bf16 chain's two walks (a persistent grid of at most one CTA an
    SM) and whether conv2 builds its halos from a window of coarse rows and
    columns in shared memory (a row pass, then a column pass)."""
    def walk(h, w):
        t = n * -(-h // TILE_ROWS) * -(-w // TILE_COLS)
        return ConvWalk(n, h, w, min(t, sms))

    _, nr, _, nc = coarse_windows(hh, wc, out_h, out_w)
    return TrunkPlan(walk(hh, wc), walk(out_h, out_w),
                     bool(nr.max() <= WIN_ROWS and nc.max() <= WIN_COLS))


def tap_tables(out_h: int, out_w: int, hh: int, wc: int):
    """conv2's tap tables on the host: int32 (lo_y, hi_y, lo_x, hi_x) and
    fp32 (frac_y, frac_x), concatenated, from ``_interp_taps``."""
    lo_y, hi_y, f_y = _interp_taps(out_h, hh)
    lo_x, hi_x, f_x = _interp_taps(out_w, wc)
    return (np.concatenate([lo_y, hi_y, lo_x, hi_x]).astype(np.int32),
            np.concatenate([f_y, f_x]).astype(np.float32))


@functools.lru_cache(maxsize=64)
def _device_tables(out_h, out_w, hh, wc, device: str):
    ti, tf = tap_tables(out_h, out_w, hh, wc)
    return (torch.from_numpy(ti).to(device), torch.from_numpy(tf).to(device))


# fast3r_tpu's trunk road (trunk_kernel.py:54-74): its Pallas kernel's VMEM
# plan, for a 2-byte dtype.  Read by reference_trunk_road only.
_REF_NSLOTS = 4
_REF_LANE = 128
_REF_OUT3 = 8
_REF_VMEM_LIMIT = 124 * 1024 * 1024
_REF_MOSAIC_STACK_MARGIN = 58 * 1024 * 1024
_REF_CHUNK_FINE_ROWS = 8


@functools.lru_cache(maxsize=64)
def _ref_window_rows(hh: int, out_h: int, rb: int) -> int:
    """``_trunk_plan``'s coarse window height for blocks of rb fine rows
    (its rin_c), or 0 where it has no plan."""
    if out_h % rb or hh < 4:
        return 0
    lo_t, _, frac_t = _interp_taps(out_h, hh)
    nrb = out_h // rb
    rows = np.zeros((nrb, rb + 2), np.int64)
    for b in range(nrb):
        for i in range(rb + 2):
            f = min(max(b * rb - 1 + i, 0), out_h - 1)
            rows[b, i] = min(int(lo_t[f]), hh - 2)  # l + 1 stays in range
    rin_c = int((rows.max(1) + 3 - (rows.min(1) - 1)).max())
    return 0 if rin_c > hh else rin_c


def _ref_pick_rb(out_h: int, hh: int) -> int:
    for rb in (48, 64, 32, 24, 16, 8):
        if out_h % rb or rb % _REF_CHUNK_FINE_ROWS:
            continue
        if _ref_window_rows(hh, out_h, rb):
            return rb
    return 0


def _ref_vmem_estimate(rin_c, wc, cin, c1, rb, out_w, c3) -> int:
    itemsize = 2
    lb = rin_c * wc + 2 * (wc + 8)
    lz = (rb + 2) * out_w + 16
    ring = _REF_NSLOTS * lb * cin * itemsize
    copies1 = 2 * lb * cin * itemsize
    y1 = rin_c * wc * c1 * itemsize
    wide = rin_c * out_w * c1 * itemsize
    z = lz * c1 * itemsize
    copies2 = 2 * lz * c1 * itemsize
    acc = _REF_CHUNK_FINE_ROWS * out_w * c1 * 4 + rin_c * wc * c1 * 4
    out = _REF_NSLOTS * rb * out_w * (_REF_OUT3 if c3 else c1) * itemsize
    w_res = (9 * cin * c1 + 9 * c1 * c1 + out_w * wc) * itemsize
    return ring + copies1 + y1 + wide + z + copies2 + acc + out + w_res


def reference_trunk_road(x_shape, out_h: int, out_w: int, c1: int = 128,
                         c3: int = 0) -> bool:
    """Whether fast3r_tpu's head takes its fused trunk kernel for a bf16
    head input of NHWC shape (B, Hh, Wc, Cin) resized to (out_h, out_w):
    the port's copy of ``trunk_kernel_supported`` and the plan arithmetic
    it needs, for a 2-byte dtype.

    Those are TPU VMEM budgets.  They decide a road only, so that the port
    runs the reference's road at every view shape and each road's rounding
    can be held against fast3r_tpu; no launch parameter of the port
    derives from them."""
    _, hh, wc, cin = x_shape
    if cin % _REF_LANE or c1 % _REF_LANE or wc % 8 or out_w % 8 \
            or c3 > _REF_OUT3:
        return False
    if hh * wc * cin < 96 * 128 * 256:
        return False
    rb = _ref_pick_rb(out_h, hh)
    if rb == 0:
        return False
    rin_c = _ref_window_rows(hh, out_h, rb)
    est = _ref_vmem_estimate(rin_c, wc, cin, c1, rb, out_w, c3)
    return est + _REF_MOSAIC_STACK_MARGIN <= _REF_VMEM_LIMIT


def _plain_head(x, w1, b1, w2, b2, w3, b3, out_h: int, out_w: int):
    """conv1 -> resize -> conv2 -> ReLU -> conv3 on NCHW x; (B, c3, H, W)."""
    y = F.conv2d(x, w1.to(x.dtype), b1.to(x.dtype), padding=1)
    y = resize_matmul(y, out_h, out_w)
    y = F.relu(F.conv2d(y, w2.to(x.dtype), b2.to(x.dtype), padding=1))
    return F.conv2d(y, w3.to(x.dtype), b3.to(x.dtype))


def _check_kernel_args(x, w1, w2, w3):
    if x.dtype not in _DTYPES:
        raise ValueError(f"trunk: dtype {x.dtype} not supported")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"trunk: x must be a contiguous NHWC tensor, got "
                         f"{tuple(x.shape)} strides {x.stride()}")
    cin = x.shape[3]
    want = {"w1": (TRUNK_CHANNELS, cin, 3, 3),
            "w2": (TRUNK_CHANNELS, TRUNK_CHANNELS, 3, 3),
            "w3": (OUT_CHANNELS, TRUNK_CHANNELS, 1, 1)}
    for name, w in (("w1", w1), ("w2", w2), ("w3", w3)):
        if tuple(w.shape) != want[name] or w.device != x.device:
            raise ValueError(f"trunk: {name} must be {want[name]} on "
                             f"{x.device}, got {tuple(w.shape)} on {w.device}")
    step = 8 if x.dtype == torch.float32 else 16
    if cin % step or x.data_ptr() % 16:
        raise ValueError(f"trunk: input channels {cin} not a multiple of "
                         f"{step}, or x not 16-byte aligned")


def _plain_head_t(x, w1, b1, w2, b2, w3, b3, out_h: int, out_w: int):
    """:func:`_plain_head` on NHWC x, channel-major (B, c3, H * W) out."""
    y = _plain_head(x.permute(0, 3, 1, 2), w1, b1, w2, b2, w3, b3, out_h,
                    out_w)
    return y.reshape(y.shape[0], y.shape[1], out_h * out_w)


class _TrunkHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, w3, b3, out_h, out_w):
        ctx.save_for_backward(x, w1, b1, w2, b2, w3, b3)
        ctx.hw = (out_h, out_w)
        return _launch(x, w1, b1, w2, b2, w3, b3, out_h, out_w)

    @staticmethod
    def backward(ctx, g):
        ins = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n)
                      for t, n in zip(ins, ctx.needs_input_grad)]
            y = _plain_head_t(*leaves, *ctx.hw)
        want = [t for t in leaves if t.requires_grad]
        got = iter(torch.autograd.grad(y, want, g) if want else ())
        return (*(next(got) if t.requires_grad else None for t in leaves),
                None, None)


def fused_regression_head_t(x: torch.Tensor, w1, b1, w2, b2, w3, b3,
                            out_h: int, out_w: int) -> torch.Tensor:
    """Head trunk + conv3 on NHWC x (B, hh, wc, Cin); (B, c3, out_h*out_w).

    CPU tensors take :func:`_plain_head`.  CUDA tensors launch the kernel
    chain, which takes float32 x with Cin % 8 == 0 or bfloat16 x with
    Cin % 16 == 0 (any n, grid and output size), 128 trunk channels and 4
    output channels; anything else raises.  Differentiable (the backward through :func:`_plain_head`).
    """
    if x.device.type == "cpu":
        return _plain_head_t(x, w1, b1, w2, b2, w3, b3, out_h, out_w)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w1, b1, w2, b2, w3, b3)):
        out = _TrunkHead.apply(x, w1, b1, w2, b2, w3, b3, out_h, out_w)
    else:
        out = _launch(x, w1, b1, w2, b2, w3, b3, out_h, out_w)
    if x.shape[0]:
        fused_regression_head_t.launches += 1
    return out


def _launch(x, w1, b1, w2, b2, w3, b3, out_h: int, out_w: int):
    """Check what the kernel chain takes and launch it (counts nothing)."""
    if x.device.type != "cuda":
        raise ValueError(f"trunk: no kernel for device {x.device}")
    _check_kernel_args(x, w1, w2, w3)
    n, hh, wc, cin = x.shape

    def cast(t, shape, dtype=torch.float32):
        return t.detach().to(dtype).reshape(shape).contiguous()

    # the 3x3 kernels in the layout each kernel reads: fp32 (tap, Cin, Cout)
    # for the scalar kernel, bf16 (tap, Cout, Cin) for the wgmma one
    if x.dtype == torch.float32:
        w1k = cast(w1.permute(2, 3, 1, 0), (9, cin, TRUNK_CHANNELS))
        w2k = cast(w2.permute(2, 3, 1, 0), (9, TRUNK_CHANNELS, TRUNK_CHANNELS))
    else:
        w1k = cast(w1.permute(2, 3, 0, 1), (9, TRUNK_CHANNELS, cin), x.dtype)
        w2k = cast(w2.permute(2, 3, 0, 1), (9, TRUNK_CHANNELS, TRUNK_CHANNELS),
                   x.dtype)
    w3k = cast(w3.reshape(OUT_CHANNELS, TRUNK_CHANNELS).t(),
               (TRUNK_CHANNELS, OUT_CHANNELS))
    b1k, b2k, b3k = (cast(b, (-1,)) for b in (b1, b2, b3))
    # conv1's output: fp32 for the scalar kernel, bf16 (the TPU kernel's
    # rounding point) for the wgmma one
    y1 = torch.empty((n, hh, wc, TRUNK_CHANNELS), device=x.device,
                     dtype=x.dtype)
    out = torch.empty((n, OUT_CHANNELS, out_h * out_w), device=x.device,
                      dtype=x.dtype)
    if n == 0:
        return out
    windowed, tap_i, tap_f = 0, None, None
    if x.dtype == torch.bfloat16:
        dev = str(x.device)
        windowed = int(trunk_plan(n, hh, wc, out_h, out_w,
                                  build.sm_count(dev)).windowed)
        tap_i, tap_f = _device_tables(out_h, out_w, hh, wc, dev)
    lib = build.library()
    err = lib.fast3r_trunk_head_fwd(
        _DTYPES[x.dtype], x.data_ptr(), w1k.data_ptr(), b1k.data_ptr(),
        w2k.data_ptr(), b2k.data_ptr(), w3k.data_ptr(), b3k.data_ptr(),
        y1.data_ptr(), out.data_ptr(),
        None if tap_i is None else tap_i.data_ptr(),
        None if tap_f is None else tap_f.data_ptr(), windowed,
        n, hh, wc, cin, out_h, out_w, build.stream_handle(x.device))
    build.check(err, "fast3r_trunk_head_fwd")
    return out


fused_regression_head_t.launches = 0
