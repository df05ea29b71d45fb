"""LayerNorm forward: the hand-written Triton kernel (kernel 1 of the port)
and its plain version.

Replaces ``fast3r_tpu/ops/fused_layernorm.py`` (``_run_fwd`` ->
``_fwd_kernel``).  What bounds it on the H100: memory.  One (M, C) pass
reads and writes 2 * M * C bytes in bf16 (63 MB at (15360, 1024)) for about
8 FLOPs per element, far below the card's FLOP-per-byte balance, so the
design keeps one row per program entirely in registers: one read, two-pass
fp32 statistics (mean, then the mean of squared deviations, as the TPU
kernel does), fp32 affine, one write in the input dtype.  Nothing to gain
from Hopper-specific instructions here; the kernel is Triton.

Triton is imported only inside the launching function: the CPU build of the
port has no Triton.
"""

from __future__ import annotations

import functools

import torch


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


@functools.lru_cache(maxsize=1)
def _kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def ln_fwd_kernel(x_ptr, w_ptr, b_ptr, y_ptr, n_cols, eps,
                      BLOCK: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK)
        mask = cols < n_cols
        x = tl.load(x_ptr + row * n_cols + cols, mask=mask,
                    other=0.0).to(tl.float32)
        mean = tl.sum(x, axis=0) / n_cols
        xc = tl.where(mask, x - mean, 0.0)
        var = tl.sum(xc * xc, axis=0) / n_cols
        rstd = 1.0 / tl.sqrt(var + eps)
        w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        b = tl.load(b_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        y = xc * rstd * w + b
        tl.store(y_ptr + row * n_cols + cols,
                 y.to(y_ptr.dtype.element_ty), mask=mask)

    return ln_fwd_kernel, triton.next_power_of_2


def fused_layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    eps: float) -> torch.Tensor:
    """LayerNorm over the last axis of x (..., C) with weight/bias (C,).

    CPU tensors take :func:`layernorm_ref`.  CUDA tensors launch the Triton
    kernel, which takes a contiguous float32 or bfloat16 x with C <= 16384;
    anything else raises.
    """
    if x.device.type == "cpu":
        return layernorm_ref(x, weight, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layernorm: no kernel for device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"layernorm: dtype {x.dtype} not supported")
    C = x.shape[-1]
    if not x.is_contiguous() or not 0 < C <= 16384:
        raise ValueError(f"layernorm: needs a contiguous (..., C <= 16384) "
                         f"input, got {tuple(x.shape)} strides {x.stride()}")
    for name, p in (("weight", weight), ("bias", bias)):
        if p.shape != (C,) or p.device != x.device or not p.is_contiguous():
            raise ValueError(f"layernorm: {name} must be a contiguous ({C},) "
                             f"tensor on {x.device}")
    kernel, next_pow2 = _kernel()
    y = torch.empty_like(x)
    rows = x.numel() // C
    if rows:
        block = next_pow2(C)
        with torch.cuda.device(x.device):
            kernel[(rows,)](x, weight, bias, y, C, float(eps), BLOCK=block,
                            num_warps=max(1, min(16, block // 256)))
        fused_layernorm.launches += 1
    return y


fused_layernorm.launches = 0
