"""Multi-head attention with a selectable implementation, (B, N, H, D) layout.

Counterpart of ``fast3r_tpu/ops/attention.py``.  Implementations:

  * "batched" (the encoder's per-view heads), "pallas" (the decoder's
    long fused sequence) and "xla" (the DINO encoder's default, which the
    JAX package leaves to XLA):
    :func:`fast3r_torch.ops.flash_attention.flash_attention`, which
    launches the CUDA kernel on CUDA tensors and takes the plain version
    on the CPU;
  * "naive": the plain version,
    :func:`fast3r_torch.ops.flash_attention.attention_ref`, on any device;
  * a callable ``(q, k, v, scale) -> o``, called as it is (the
    sequence-sharded decoder's ring attention, as the JAX package passes
    it).

Any other name raises.
"""

from __future__ import annotations

from typing import Callable, Union

import torch

from fast3r_torch.ops.flash_attention import attention_ref, flash_attention

IMPLS = ("batched", "pallas", "xla", "naive")


AttnImpl = Union[str, Callable[..., torch.Tensor]]


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float, impl: AttnImpl) -> torch.Tensor:
    """softmax(scale * q k^T) v; q, k, v (B, N, H, D) -> (B, N, H, D)."""
    if callable(impl):
        return impl(q, k, v, scale)
    if impl in ("batched", "pallas", "xla"):
        return flash_attention(q, k, v, scale)
    if impl == "naive":
        return attention_ref(q, k, v, scale)
    raise ValueError(f"unknown attention impl {impl!r}; expected one of {IMPLS}")
