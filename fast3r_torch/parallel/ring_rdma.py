"""Ring attention with in-kernel hops over two slots per rank (forward): the
wrapper of ``csrc/ring_attention.cu``.

Counterpart of ``fast3r_tpu/parallel/ring_rdma.py`` (``ring_flash_attention_rdma``,
``_rdma_forward``).  The JAX kernel runs one ``pallas_call`` per device of
a ``shard_map`` ring and moves K/V between chips with remote copies; here
the ranks are stacked on a leading axis, q, k and v ``(n, B, S_loc, H, D)``
on one device, and one launch runs all n ranks, each with its own two K/V
slots, arrival counters and capacity counters.  The source notes give the
protocol (bootstrap copy, hop j from my slot (j-1)%2 into the right
neighbour's slot j%2 while epoch j-1 computes, capacity tokens before a
slot is reused) and say what bounds the kernel.

Self-ring mode (n = 1, ``self_ring_epochs = E``): E epochs over the rank's
own slots, every hop copying into itself.  The output equals plain
attention (the duplicated keys' weights renormalise away) and the lse is
the plain lse + ln E: the one-card check of the hop protocol that the JAX
package runs on one chip.

There is no plain fallback here: on anything but CUDA tensors the kernel
can take, these functions raise.  The plain version of the same function
is :func:`fast3r_torch.parallel.sequence.ring_flash_attention`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from fast3r_torch.kernels import build

HEAD_DIM = 64
NSLOTS = 2
MAX_RANKS = 16     # the kernel's pointer tables
FLAG_WORDS = 96    # counter words per rank (csrc/ring_attention.cu)
TIMEOUT_S = 20.0   # a wait longer than this traps (a protocol fault), never hangs
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_input(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if t.device != like.device or t.dtype != like.dtype:
        raise ValueError(f"ring attention: {name} is {t.dtype} on {t.device}, "
                         f"expected {like.dtype} on {like.device}")
    if t.shape != like.shape:
        raise ValueError(f"ring attention: {name} has shape {tuple(t.shape)}, "
                         f"q has {tuple(like.shape)}")
    vec = 16 // t.element_size()
    if (t.stride(4) != 1 or t.data_ptr() % 16
            or any(s % vec for s in t.stride()[:4])):
        raise ValueError(
            f"ring attention: {name} strides {t.stride()} are not 16-byte rows "
            "(head dim contiguous, other strides multiples of 16 bytes)")


def _plan(dtype: torch.dtype, n: int) -> Tuple[int, int]:
    """(how many CTAs per rank the card can hold resident together with
    every other rank's, 0 when n ranks cannot all be; fp32 state words per
    item)."""
    ctas, words = ctypes.c_int(0), ctypes.c_int(0)
    build.check(build.library().fast3r_ring_attention_plan(
        _DTYPES[dtype], n, ctypes.addressof(ctas), ctypes.addressof(words)),
        "fast3r_ring_attention_plan")
    return ctas.value, words.value


def _rdma_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float, n: int, self_ring_epochs: Optional[int] = None,
                  ctas_per_rank: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the ring kernel on rank-stacked CUDA q, k, v (n, B, S_loc, H,
    64), read through their strides.  Returns o (n, B, S_loc, H, 64) in q's
    dtype and lse (n, B * H, S_loc), fp32, natural log (what a backward
    reads).  ``ctas_per_rank`` overrides the resident count the card allows
    (a count that cannot be resident raises).  Counts one launch."""
    if q.device.type != "cuda":
        raise ValueError(
            f"ring attention: no kernel for device {q.device} (the plain ring "
            "is fast3r_torch.parallel.sequence.ring_flash_attention)")
    if q.dtype not in _DTYPES:
        raise ValueError(f"ring attention: dtype {q.dtype} not supported")
    if q.dim() != 5 or q.shape[4] != HEAD_DIM:
        raise ValueError(f"ring attention: q must be (n, B, S_loc, H, "
                         f"{HEAD_DIM}), got {tuple(q.shape)}")
    if q.shape[0] != n:
        raise ValueError(f"ring attention: q stacks {q.shape[0]} ranks, n={n}")
    if not 1 <= n <= MAX_RANKS:
        raise ValueError(f"ring attention: n={n} outside 1..{MAX_RANKS}")
    epochs = n
    if self_ring_epochs is not None:
        if n != 1:
            raise ValueError("ring attention: the self-ring is a one-rank mode")
        if self_ring_epochs < 1:
            raise ValueError("ring attention: self_ring_epochs must be >= 1")
        epochs = self_ring_epochs
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_input(name, t, q)
    _, B, S, H, _ = q.shape
    if S == 0:
        raise ValueError("ring attention: empty shards")
    items = B * H * -(-S // 64)
    resident, words = _plan(q.dtype, n)
    G = min(resident, items) if ctas_per_rank is None else ctas_per_rank
    if G < 1:
        raise RuntimeError(f"ring attention: {n} ranks cannot all be resident "
                           "on the card at once")
    dev = q.device
    o = torch.empty((n, B, S, H, HEAD_DIM), device=dev, dtype=q.dtype)
    lse = torch.empty((n, B * H, S), device=dev, dtype=torch.float32)
    slots_k = torch.empty((n, NSLOTS, B * H, S, HEAD_DIM), device=dev,
                          dtype=q.dtype)
    slots_v = torch.empty_like(slots_k)
    flags = torch.zeros((n, FLAG_WORDS), device=dev, dtype=torch.int32)
    state = (torch.empty((n * items * words,), device=dev,
                         dtype=torch.float32) if epochs > 1 else None)
    # per-rank pointer tables (one card today; peer pointers across cards)
    table = ctypes.c_void_p * n
    tk = table(*(slots_k[r].data_ptr() for r in range(n)))
    tv = table(*(slots_v[r].data_ptr() for r in range(n)))
    tf = table(*(flags[r].data_ptr() for r in range(n)))
    err = build.library().fast3r_ring_attention_fwd(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        *q.stride()[:4], *k.stride()[:4], *v.stride()[:4],
        o.data_ptr(), lse.data_ptr(), 0 if state is None else state.data_ptr(),
        ctypes.addressof(tk), ctypes.addressof(tv), ctypes.addressof(tf),
        n, epochs, B, H, S, G, float(scale), int(TIMEOUT_S * 1e9),
        build.stream_handle(dev))
    build.check(err, "fast3r_ring_attention_fwd")
    ring_flash_attention_rdma.launches += 1
    return o, lse


def ring_flash_attention_rdma(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, scale: float, n: int,
                              self_ring_epochs: Optional[int] = None
                              ) -> torch.Tensor:
    """softmax(scale * q_r k_all^T) v_all for each of n rank-stacked shards:
    q, k, v (n, B, S_loc, H, 64) CUDA tensors in float32 or bfloat16 ->
    o (n, B, S_loc, H, 64).  ``self_ring_epochs`` (n = 1 only) runs that
    many epochs over the rank's own slots.  Anything the kernel cannot take
    raises; there is no fallback to the plain ring."""
    o, _ = _rdma_forward(q, k, v, scale, n, self_ring_epochs)
    return o


ring_flash_attention_rdma.launches = 0
