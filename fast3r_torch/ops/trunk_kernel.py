"""DPT regression-head trunk: the hand-written CUDA kernel chain
(``csrc/trunk.cu``, kernel 3 of the port) and its plain version.

Counterpart of ``fast3r_tpu/ops/trunk_kernel.py``
(``fused_regression_head_t`` -> ``_trunk_call`` -> ``_trunk_kern``):
conv1 3x3 (Cin -> 128, + b1) on the half-resolution grid -> align-corners
bilinear resize to (out_h, out_w) -> conv2 3x3 (128 -> 128, + b2) -> ReLU ->
1x1 conv3 (128 -> 4, + b3), emitted channel-major as (B, 4, out_h * out_w).
The source note in ``trunk.cu`` says what bounds it on the H100 and how it
is laid out.  Weights come in the port's torch layouts (OIHW).

Differentiable: the forward is the kernel, the backward recomputes through
:func:`_plain_head` and differentiates that, as ``_head_t_bwd`` does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fast3r_torch.kernels import build
from fast3r_torch.ops.resize import resize_bilinear_align_corners

TRUNK_CHANNELS = 128
OUT_CHANNELS = 4
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _plain_head(x, w1, b1, w2, b2, w3, b3, out_h: int, out_w: int):
    """conv1 -> resize -> conv2 -> ReLU -> conv3 on NCHW x; (B, c3, H, W)."""
    y = F.conv2d(x, w1.to(x.dtype), b1.to(x.dtype), padding=1)
    y = resize_bilinear_align_corners(y, out_h, out_w)
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
    Cin % 16 == 0, 128 trunk channels and 4 output channels; anything else
    raises.  Differentiable (the backward through :func:`_plain_head`).
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

    # the 3x3 kernels in the layout each kernel stages: fp32 (tap, Cin, Cout)
    # for the scalar kernel, bf16 (tap, Cout, Cin) for the tensor-core one
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
    y1 = torch.empty((n, hh, wc, TRUNK_CHANNELS), device=x.device,
                     dtype=torch.float32)
    out = torch.empty((n, OUT_CHANNELS, out_h * out_w), device=x.device,
                      dtype=x.dtype)
    if n == 0:
        return out
    lib = build.library()
    err = lib.fast3r_trunk_head_fwd(
        _DTYPES[x.dtype], x.data_ptr(), w1k.data_ptr(), b1k.data_ptr(),
        w2k.data_ptr(), b2k.data_ptr(), w3k.data_ptr(), b3k.data_ptr(),
        y1.data_ptr(), out.data_ptr(), n, hh, wc, cin, out_h, out_w,
        build.stream_handle(x.device))
    build.check(err, "fast3r_trunk_head_fwd")
    return out


fused_regression_head_t.launches = 0
