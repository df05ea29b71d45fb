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

Both are CUDA C++ (``csrc/layernorm.cu``: a warp per row; its source note
says why), launched through the kernel library's plain C entry points,
which cost the host less than Triton's launcher.  The backward recomputes
mean and rstd from x (nothing saved but x) and writes fp32 partial rows of
dscale and dbias, one per CTA (or per warp on the scalar road), which a
second small launch of the same call sums in a fixed order (no float
atomics, so the result is deterministic).  :func:`bwd_plan` is its road
and grid, mirrored here for the tests.

:func:`fused_layernorm` is differentiable.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from fast3r_torch.kernels import build

# the backward's CTAs (csrc/layernorm.cu): 8 warps on the warp and scalar
# roads, 512 threads on the CTA road
BWD_WARPS = 8
BWD_CTA_THREADS = 512
BWD_SCALAR_CTAS = 16  # the scalar road's grid at most: 128 partial rows
ROADS = {"warp": 0, "cta": 1, "scalar": 2}


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """The backward's road and grid for ``rows`` rows: on the warp and
    scalar roads warp i of the ``ctas * BWD_WARPS`` takes rows i, i +
    warps, ...; on the CTA road CTA b takes rows b, b + ctas, ...
    ``partials`` is the number of partial rows of dweight (and of dbias)
    the launch writes."""
    road: str
    ctas: int
    rows: int

    @property
    def partials(self) -> int:
        return self.ctas * (BWD_WARPS if self.road == "scalar" else 1)

    def groups(self) -> int:
        """Row groups (warps or CTAs) of the walk."""
        return self.ctas * (1 if self.road == "cta" else BWD_WARPS)

    def rows_of(self, group: int) -> range:
        return range(group, self.rows, self.groups())


@functools.lru_cache(maxsize=256)
def bwd_plan(rows: int, C: int, itemsize: int, aligned: bool,
             sms: int) -> BwdPlan:
    """The forward's three roads: a warp a row for 16-byte rows of at most
    4 KB (as many CTAs as fit on the card at once: 2 an SM, 1 for 4 KB
    rows, whose registers take the SM), a CTA a row for wider 16-byte rows
    (one an SM), and the scalar road (16 CTAs at most) for the rest."""
    nbytes = C * itemsize
    vec = aligned and nbytes % 16 == 0
    if vec and nbytes <= 4096:
        per_sm = 2 if nbytes <= 2048 else 1
        return BwdPlan("warp", max(1, min(-(-rows // BWD_WARPS), per_sm * sms)),
                       rows)
    if vec and nbytes <= 16 * 8 * BWD_CTA_THREADS:
        return BwdPlan("cta", max(1, min(rows, sms)), rows)
    return BwdPlan("scalar", max(1, min(-(-rows // BWD_WARPS),
                                        BWD_SCALAR_CTAS)), rows)


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
    launch the backward kernels, which take contiguous float32 or bfloat16
    x and dy of the same shape with C <= 16384 and a float32 or bfloat16
    weight; anything else raises."""
    if x.device.type == "cpu":
        return layernorm_bwd_ref(x, weight, dy, eps)
    C = _check_kernel_args("layernorm backward", x, (("weight", weight),))
    if dy.shape != x.shape or dy.dtype != x.dtype or not dy.is_contiguous():
        raise ValueError("layernorm backward: dy must be contiguous, of x's "
                         "shape and dtype")
    rows = x.numel() // C
    if rows >= 2 ** 31:
        raise ValueError(f"layernorm backward: {rows} rows, more than the "
                         f"kernel takes")
    dx = torch.empty_like(x)
    if rows == 0:
        dwdb = torch.zeros((2, C), device=x.device, dtype=torch.float32)
        return dx, dwdb[0], dwdb[1]
    dev = x.device.index
    aligned = (x.data_ptr() | dy.data_ptr() | dx.data_ptr()
               | weight.data_ptr()) % 16 == 0
    plan = bwd_plan(rows, C, x.element_size(), aligned, build.sm_count(dev))
    buf = torch.empty(2 * (plan.partials + 1) * C, device=x.device,
                      dtype=torch.float32)
    bf = torch.bfloat16
    build.check(build.library().fast3r_layernorm_bwd(
        x.data_ptr(), weight.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        buf.data_ptr() + 8 * C, buf.data_ptr(), rows, C, x.dtype == bf,
        weight.dtype == bf, ROADS[plan.road], plan.ctas, eps, dev,
        torch._C._cuda_getCurrentRawStream(dev)), "fast3r_layernorm_bwd")
    layernorm_bwd.launches += 1
    return dx, buf[:C], buf[C:2 * C]


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
    (CUDA C++, ``csrc/layernorm.cu``), which take a contiguous
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
