"""LayerNorm forward and backward: the hand-written kernels and their plain
versions.

Replaces ``fast3r_tpu/ops/fused_layernorm.py`` (``_run_fwd`` ->
``_fwd_kernel``; ``_run_bwd`` -> ``_bwd_kernel``).  What bounds both on the
H100: memory.  The forward reads and writes 2 * M * C bytes in bf16 (63 MB
at (15360, 1024)) and the backward reads x and dy and writes dx, 3 * M * C
bytes, for a few FLOPs per element, far below the card's FLOP-per-byte
balance.  So each keeps whole rows in registers: one read of each input,
two-pass fp32 statistics (mean, then the mean of squared deviations, as the
TPU kernels do), fp32 math, one write in the input dtype.

The forward is CUDA C++ (``csrc/layernorm.cu``: a warp per row; its source
note says why), launched through the kernel library's plain C entry point,
which costs the host less than Triton's launcher.  The backward is Triton: it recomputes
mean and rstd from x (nothing saved but x) and emits, per program, fp32
partial sums of dscale and dbias over the rows it walked; a second small
sum over the programs finishes them (no float atomics, so the result is
deterministic).

:func:`fused_layernorm` is differentiable.  Triton is imported only inside
the launching function: the CPU build of the port has no Triton.
"""

from __future__ import annotations

import functools

import torch

from fast3r_torch.kernels import build

BWD_PROGRAMS = 1024  # programs of the backward; each walks rows / programs rows


def layernorm_ref(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """Plain LayerNorm over the last axis: fp32 two-pass statistics and
    affine, output in the input dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    y = y * weight.float() + bias.float()
    return y.to(x.dtype)


def layernorm_bwd_ref(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor,
                      eps: float):
    """Plain LayerNorm backward over the last axis: (dx in x's dtype, fp32
    dweight, fp32 dbias), statistics recomputed from x in fp32."""
    C = x.shape[-1]
    xf, dyf = x.reshape(-1, C).float(), dy.reshape(-1, C).float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    xhat = xc * rstd
    g = dyf * weight.float()
    dx = (g - g.mean(-1, keepdim=True)
          - xhat * (g * xhat).mean(-1, keepdim=True)) * rstd
    return (dx.to(x.dtype).reshape(x.shape), (dyf * xhat).sum(0),
            dyf.sum(0))


@functools.lru_cache(maxsize=1)
def _bwd_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def ln_bwd_kernel(x_ptr, w_ptr, dy_ptr, dx_ptr, dw_ptr, db_ptr, n_rows,
                      n_cols, eps, BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        nprog = tl.num_programs(0)
        cols = tl.arange(0, BLOCK)
        mask = cols < n_cols
        w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        dw_acc = tl.zeros([BLOCK], dtype=tl.float32)
        db_acc = tl.zeros([BLOCK], dtype=tl.float32)
        for row in range(pid, n_rows, nprog):
            off = row.to(tl.int64) * n_cols + cols
            x = tl.load(x_ptr + off, mask=mask, other=0.0).to(tl.float32)
            dy = tl.load(dy_ptr + off, mask=mask, other=0.0).to(tl.float32)
            mean = tl.sum(x, axis=0) / n_cols
            xc = tl.where(mask, x - mean, 0.0)
            var = tl.sum(xc * xc, axis=0) / n_cols
            rstd = 1.0 / tl.sqrt(var + eps)
            xhat = xc * rstd
            g = dy * w
            m1 = tl.sum(g, axis=0) / n_cols
            m2 = tl.sum(g * xhat, axis=0) / n_cols
            dx = (g - m1 - xhat * m2) * rstd
            tl.store(dx_ptr + off, dx.to(dx_ptr.dtype.element_ty), mask=mask)
            dw_acc += dy * xhat
            db_acc += dy
        tl.store(dw_ptr + pid * n_cols + cols, dw_acc, mask=mask)
        tl.store(db_ptr + pid * n_cols + cols, db_acc, mask=mask)

    return ln_bwd_kernel, triton.next_power_of_2


_DTYPES = (torch.float32, torch.bfloat16)


def _check_kernel_args(name: str, x: torch.Tensor, params) -> int:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"{name}: dtype {x.dtype} not supported")
    C = x.shape[-1]
    if not x.is_contiguous() or not 0 < C <= 16384:
        raise ValueError(f"{name}: needs a contiguous (..., C <= 16384) "
                         f"input, got {tuple(x.shape)} strides {x.stride()}")
    for pname, p in params:
        if (p.shape != (C,) or p.device != x.device or not p.is_contiguous()
                or p.dtype not in _DTYPES):
            raise ValueError(f"{name}: {pname} must be a contiguous ({C},) "
                             f"float32 or bfloat16 tensor on {x.device}")
    return C


def _forward(x, weight, bias, eps):
    """The forward kernel or, on the CPU, the plain version (counts
    nothing).  The kernel runs on the current stream of x's device; the C
    entry point makes that device current for the launch (a device context
    here would cost the host more than the launch)."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return layernorm_ref(x, weight, bias, eps)
        raise ValueError(f"layernorm: no kernel for device {x.device}")
    C = _check_kernel_args("layernorm", x, (("weight", weight), ("bias", bias)))
    rows = x.numel() // C
    if rows >= 2 ** 31:
        raise ValueError(f"layernorm: {rows} rows, more than the kernel takes")
    y = torch.empty_like(x)
    bf, dev = torch.bfloat16, x.device.index
    build.check(build.library().fast3r_layernorm_fwd(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(), rows,
        C, x.dtype == bf, weight.dtype == bf, bias.dtype == bf, eps, dev,
        torch._C._cuda_getCurrentRawStream(dev)), "fast3r_layernorm_fwd")
    return y


def layernorm_bwd(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor,
                  eps: float):
    """(dx, dweight, dbias) of LayerNorm over the last axis; dweight and
    dbias in fp32.  CPU tensors take :func:`layernorm_bwd_ref`; CUDA tensors
    launch the Triton backward, which takes contiguous float32 or bfloat16
    x and dy of the same shape with C <= 16384; anything else raises."""
    if x.device.type == "cpu":
        return layernorm_bwd_ref(x, weight, dy, eps)
    C = _check_kernel_args("layernorm backward", x, (("weight", weight),))
    if dy.shape != x.shape or dy.dtype != x.dtype or not dy.is_contiguous():
        raise ValueError("layernorm backward: dy must be contiguous, of x's "
                         "shape and dtype")
    bwd, next_pow2 = _bwd_kernel()
    rows = x.numel() // C
    progs = max(1, min(rows, BWD_PROGRAMS))
    dx = torch.empty_like(x)
    part = torch.zeros((2, progs, C), device=x.device, dtype=torch.float32)
    if rows:
        block = next_pow2(C)
        with torch.cuda.device(x.device):
            bwd[(progs,)](x, weight, dy, dx, part[0], part[1], rows, C,
                          float(eps), BLOCK=block,
                          num_warps=max(1, min(16, block // 256)))
        layernorm_bwd.launches += 1
    dw, db = part.sum(1)
    return dx, dw, db


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps, ctx.bias_dtype = eps, bias.dtype
        return _forward(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx, dw, db = layernorm_bwd(x, weight, dy.contiguous(), ctx.eps)
        return dx, dw.to(weight.dtype), db.to(ctx.bias_dtype), None


def fused_layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    eps: float) -> torch.Tensor:
    """LayerNorm over the last axis of x (..., C) with weight/bias (C,);
    differentiable (:func:`layernorm_bwd`).

    CPU tensors take the plain versions.  CUDA tensors launch the kernels
    (the forward CUDA C++, the backward Triton), which take a contiguous
    float32 or bfloat16 x with C <= 16384 and float32 or bfloat16 weight
    and bias; anything else raises.
    """
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        y = _LayerNorm.apply(x, weight, bias, eps)
    else:
        y = _forward(x, weight, bias, eps)
    if x.is_cuda and x.numel():
        fused_layernorm.launches += 1
    return y


fused_layernorm.launches = 0
layernorm_bwd.launches = 0
