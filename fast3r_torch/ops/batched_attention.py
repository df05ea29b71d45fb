"""Encoder self-attention read straight from the packed (3, B, N, C) qkv
buffer that :func:`fast3r_torch.nn.fused_block.ln_qkv_rope` writes.

Counterpart of ``fast3r_tpu/ops/batched_attention.py`` ``packed_qkv_attention``
(``_fusedqkv_bnc`` -> ``_fusedqkv_kernel``).  The TPU kernel exists to fetch
one unit's q, k and v with a single DMA; on the H100 the port's attention
kernel (``csrc/attention_fwd.cu``) already reads q, k and v through
(batch, token, head) strides, so q, k and v are strided views of the packed
buffer and nothing is copied.  No new CUDA.

Numerics: as :func:`fast3r_torch.ops.flash_attention.flash_attention`.  The
TPU kernel sums the bf16-rounded p for its row sum (its ones-extended v);
the port's kernel sums the unrounded fp32 p.
"""

from __future__ import annotations

import torch

from fast3r_torch.ops.flash_attention import attention_ref, launch_attention


def _views(qkv3: torch.Tensor, num_heads: int):
    if qkv3.dim() != 4 or qkv3.shape[0] != 3 or qkv3.shape[3] % num_heads:
        raise ValueError(f"packed qkv attention: need (3, B, N, C) with C a "
                         f"multiple of {num_heads} heads, got {tuple(qkv3.shape)}")
    _, B, N, C = qkv3.shape
    return tuple(qkv3[i].view(B, N, num_heads, C // num_heads)
                 for i in range(3))


def packed_qkv_attention(qkv3: torch.Tensor, num_heads: int,
                         scale: float) -> torch.Tensor:
    """Self-attention over a packed (3, B, N, C) qkv buffer (q and k already
    rotated); (B, N, C) out.

    CPU tensors take :func:`attention_ref` on the same views.  CUDA tensors
    launch the attention kernel on strided views of the buffer; a shape or
    dtype it cannot take raises.
    """
    q, k, v = _views(qkv3, num_heads)
    _, B, N, C = qkv3.shape
    if qkv3.device.type == "cpu":
        return attention_ref(q, k, v, scale).reshape(B, N, C)
    o = launch_attention(q, k, v, scale)
    packed_qkv_attention.launches += 1
    return o.reshape(B, N, C)


packed_qkv_attention.launches = 0
