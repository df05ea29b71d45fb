"""Encoder self-attention read straight from the packed (3, B, N, C) qkv
buffer that :func:`fast3r_torch.nn.fused_block.ln_qkv_rope` writes, forward
and backward.

Counterpart of ``fast3r_tpu/ops/batched_attention.py`` ``packed_qkv_attention``
(``_fusedqkv_bnc`` -> ``_fusedqkv_kernel``; backward
``packed_qkv_attention_bwd`` -> ``_fusedqkv_bwd_kernel``).  The TPU kernels
exist to move one unit's q, k and v (and dq, dk, dv) with a single DMA; on
the H100 the port's attention kernels (``csrc/attention_fwd.cu``,
``csrc/attention_bwd.cu``) read q, k, v, do and write dq, dk, dv through
(batch, token, head) strides, so all of them are strided views of packed
(3, B, N, C) buffers and nothing is copied.  No new CUDA.

Numerics: as :func:`fast3r_torch.ops.flash_attention.flash_attention`.  The
TPU forward sums the bf16-rounded p for its row sum (its ones-extended v);
the port's kernel sums the unrounded fp32 p.  Design choice of the
backward: the port keeps the forward's fp32 lse (B, H, N) and recomputes p
from it, like the decoder's backward; the TPU kernel saves no lse and
recomputes the softmax with a single row max.
"""

from __future__ import annotations

import torch

from fast3r_torch.ops.flash_attention import (
    attention_bwd_ref,
    attention_fwd_lse,
    attention_ref,
    launch_attention,
    launch_attention_bwd,
)


def _views(qkv3: torch.Tensor, num_heads: int):
    if qkv3.dim() != 4 or qkv3.shape[0] != 3 or qkv3.shape[3] % num_heads:
        raise ValueError(f"packed qkv attention: need (3, B, N, C) with C a "
                         f"multiple of {num_heads} heads, got {tuple(qkv3.shape)}")
    _, B, N, C = qkv3.shape
    return tuple(qkv3[i].view(B, N, num_heads, C // num_heads)
                 for i in range(3))


def packed_qkv_attention_bwd(qkv3, o, lse, do, num_heads: int,
                             scale: float) -> torch.Tensor:
    """d(qkv3) as one packed (3, B, N, C) tensor from the forward's o
    (B, N, H, D) and lse and the output cotangent do (B, N, C).  CPU tensors
    take :func:`attention_bwd_ref`; CUDA tensors launch the backward kernels
    with dq, dk and dv written through strides into the packed buffer."""
    q, k, v = _views(qkv3, num_heads)
    do = do.reshape(o.shape)
    if qkv3.device.type == "cpu":
        return torch.stack([t.reshape(qkv3.shape[1:]) for t in
                            attention_bwd_ref(q, k, v, o, lse, do, scale)])
    dqkv3 = torch.empty_like(qkv3)
    launch_attention_bwd(q, k, v, o, lse, do, scale,
                         *_views(dqkv3, num_heads))
    packed_qkv_attention_bwd.launches += 1
    return dqkv3


class _PackedQkvAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv3, num_heads, scale):
        o, lse = attention_fwd_lse(*_views(qkv3, num_heads), scale)
        ctx.save_for_backward(qkv3, o, lse)
        ctx.num_heads, ctx.scale = num_heads, scale
        return o.reshape(qkv3.shape[1:])

    @staticmethod
    def backward(ctx, do):
        qkv3, o, lse = ctx.saved_tensors
        return (packed_qkv_attention_bwd(qkv3, o, lse, do, ctx.num_heads,
                                         ctx.scale), None, None)


def packed_qkv_attention(qkv3: torch.Tensor, num_heads: int,
                         scale: float) -> torch.Tensor:
    """Self-attention over a packed (3, B, N, C) qkv buffer (q and k already
    rotated); (B, N, C) out.  Differentiable (the packed backward above).

    CPU tensors take the plain versions on the same views.  CUDA tensors
    launch the attention kernel on strided views of the buffer; a shape or
    dtype it cannot take raises.
    """
    q, k, v = _views(qkv3, num_heads)
    _, B, N, C = qkv3.shape
    if torch.is_grad_enabled() and qkv3.requires_grad:
        o = _PackedQkvAttention.apply(qkv3, num_heads, scale)
    elif qkv3.device.type == "cpu":
        return attention_ref(q, k, v, scale).reshape(B, N, C)
    else:
        o = launch_attention(q, k, v, scale).reshape(B, N, C)
    if qkv3.device.type != "cpu":
        packed_qkv_attention.launches += 1
    return o


packed_qkv_attention.launches = 0
packed_qkv_attention_bwd.launches = 0
