"""Ring attention with in-kernel hops over two slots per rank: the wrappers
of ``csrc/ring_attention.cu`` (the forward) and ``csrc/ring_attention_bwd.cu``
(the dq and dk/dv rings of the backward), and the differentiable ring.

Counterpart of ``fast3r_tpu/parallel/ring_rdma.py`` (``ring_flash_attention_rdma``,
``_rdma_forward``, ``_ring_backward``, ``ring_flash_attention_rdma_diff``).
The JAX kernels run one ``pallas_call`` per device of a ``shard_map`` ring
and move their payloads between chips with remote copies; here the ranks
are stacked on a leading axis, q, k and v ``(n, B, S_loc, H, D)`` on one
device, and one launch runs all n ranks, each with its own two slots of
each payload, arrival counters and capacity counters.  The source notes give the
protocol (bootstrap copy, hop j from my slot (j-1)%2 into the right
neighbour's slot j%2 while epoch j-1 computes, capacity tokens before a
slot is reused; ``csrc/ring_protocol.cuh``, which the three kernels share)
and say what bounds each kernel.  Every launch gets its own freshly zeroed
counter words and slots.

Self-ring mode (n = 1, ``self_ring_epochs = E``): E epochs over the rank's
own slots, every hop copying into itself.  The output equals plain
attention (the duplicated keys' weights renormalise away) and the lse is
the plain lse + ln E: the one-card check of the hop protocol that the JAX
package runs on one chip.

There is no plain fallback here: on anything but CUDA tensors the kernels
can take, these functions raise.  The plain versions of the same functions
are :func:`fast3r_torch.parallel.sequence.ring_flash_attention` and
:func:`fast3r_torch.parallel.sequence.ring_attention_bwd_ref`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from fast3r_torch.kernels import build
from fast3r_torch.ops.flash_attention import tma_dims

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


def _check_kernel_input(q: torch.Tensor, n: int) -> None:
    """What every ring kernel takes: rank-stacked CUDA (n, B, S_loc, H, 64)
    q in float32 or bfloat16, 1 <= n <= MAX_RANKS, S_loc > 0."""
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
    if q.shape[2] == 0:
        raise ValueError("ring attention: empty shards")


def _ctas(resident: int, items: int, ctas_per_rank: Optional[int], n: int) -> int:
    G = min(resident, items) if ctas_per_rank is None else ctas_per_rank
    if G < 1:
        raise RuntimeError(f"ring attention: {n} ranks cannot all be resident "
                           "on the card at once")
    return G


def _pointer_table(t: torch.Tensor) -> ctypes.Array:
    """Host array of the n ranks' device pointers into t (n, ...)."""
    return (ctypes.c_void_p * t.shape[0])(*(t[r].data_ptr()
                                            for r in range(t.shape[0])))


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
    _check_kernel_input(q, n)
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
    items = B * H * -(-S // 64)
    resident, words = _plan(q.dtype, n)
    G = _ctas(resident, items, ctas_per_rank, n)
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
    tk, tv, tf = (_pointer_table(t) for t in (slots_k, slots_v, flags))
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


# ---------------------------------------------------------------------------
# the backward: the dq ring and the dk/dv ring (csrc/ring_attention_bwd.cu)
# ---------------------------------------------------------------------------

def _plan_bwd(which: int, dtype: torch.dtype, n: int) -> Tuple[int, int, int]:
    """:func:`_plan` of the dq ring (``which`` 0) or the dk/dv ring (1),
    and the rows of one of its items (128 in bf16, 64 in fp32)."""
    ctas, words, rows = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    build.check(build.library().fast3r_ring_attention_bwd_plan(
        which, _DTYPES[dtype], n, ctypes.addressof(ctas),
        ctypes.addressof(words), ctypes.addressof(rows)),
        "fast3r_ring_attention_bwd_plan")
    return ctas.value, words.value, rows.value


def _strides(*ts: torch.Tensor):
    return [s for t in ts for s in t.stride()[:4]]


def _check_bwd_inputs(q, k, v, do, n: int):
    """q, k, v, do checked; in bf16, each one whose rank and batch strides
    do not merge into one tensor-map dimension (:func:`tma_dims`) copied."""
    _check_kernel_input(q, n)
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        _check_input(name, t, q)
    if q.dtype == torch.bfloat16:
        return [t if tma_dims(t) is not None else t.contiguous()
                for t in (q, k, v, do)]
    return q, k, v, do


def _check_rows(name: str, t: torch.Tensor, shape, q: torch.Tensor) -> None:
    """A rows' input of the backward rings: contiguous fp32 on q's device."""
    if (tuple(t.shape) != tuple(shape) or t.dtype != torch.float32
            or t.device != q.device or not t.is_contiguous()):
        raise ValueError(f"ring attention: {name} must be contiguous fp32 "
                         f"{tuple(shape)} on {q.device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def ring_attention_bwd_dq(q, k, v, do, lse, delta, scale: float, n: int,
                          ctas_per_rank: Optional[int] = None) -> torch.Tensor:
    """Launch the dq ring: K/V rotate, q, do, lse and delta (n, B * H,
    S_loc) fp32 stay local.  Returns dq (n, B, S_loc, H, 64) in q's dtype.
    Anything the kernel cannot take raises.  Counts one launch."""
    q, k, v, do = _check_bwd_inputs(q, k, v, do, n)
    _, B, S, H, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        _check_rows(name, t, (n, B * H, S), q)
    resident, words, rows = _plan_bwd(0, q.dtype, n)
    items = B * H * -(-S // rows)
    G = _ctas(resident, items, ctas_per_rank, n)
    dev = q.device
    dq = torch.empty((n, B, S, H, HEAD_DIM), device=dev, dtype=q.dtype)
    slots_k = torch.empty((n, NSLOTS, B * H, S, HEAD_DIM), device=dev,
                          dtype=q.dtype)
    slots_v = torch.empty_like(slots_k)
    flags = torch.zeros((n, FLAG_WORDS), device=dev, dtype=torch.int32)
    state = (torch.empty((n * items * words,), device=dev,
                         dtype=torch.float32) if n > 1 else None)
    tk, tv, tf = (_pointer_table(t) for t in (slots_k, slots_v, flags))
    err = build.library().fast3r_ring_attention_bwd_dq(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), *_strides(q, k, v, do), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(),
        0 if state is None else state.data_ptr(), ctypes.addressof(tk),
        ctypes.addressof(tv), ctypes.addressof(tf), n, B, H, S, G,
        float(scale), int(TIMEOUT_S * 1e9), build.stream_handle(dev))
    build.check(err, "fast3r_ring_attention_bwd_dq")
    ring_attention_bwd_dq.launches += 1
    return dq


ring_attention_bwd_dq.launches = 0


def ring_attention_bwd_dkv(q, k, v, do, meta, scale: float, n: int,
                           ctas_per_rank: Optional[int] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dk/dv ring: q, do and ``meta`` (n, M) fp32, the rows' lse
    then their delta, each (B * H, S_pad) with S_pad = S_loc rounded up to a
    multiple of 64 (:func:`_bwd_rows`), rotate; K/V stay at their owner.
    Returns dk, dv (n, B, S_loc, H, 64) in q's dtype.  Anything the kernel
    cannot take raises.  Counts one launch."""
    q, k, v, do = _check_bwd_inputs(q, k, v, do, n)
    _, B, S, H, _ = q.shape
    _check_rows("meta", meta, (n, 2 * B * H * -(-S // 64) * 64), q)
    resident, words, rows = _plan_bwd(1, q.dtype, n)
    items = B * H * -(-S // rows)
    G = _ctas(resident, items, ctas_per_rank, n)
    dev = q.device
    dk = torch.empty((n, B, S, H, HEAD_DIM), device=dev, dtype=q.dtype)
    dv = torch.empty_like(dk)
    slots_q = torch.empty((n, NSLOTS, B * H, S, HEAD_DIM), device=dev,
                          dtype=q.dtype)
    slots_do = torch.empty_like(slots_q)
    slots_meta = torch.empty((n, NSLOTS, meta.shape[1]), device=dev,
                             dtype=torch.float32)
    flags = torch.zeros((n, FLAG_WORDS), device=dev, dtype=torch.int32)
    state = (torch.empty((n * items * words,), device=dev,
                         dtype=torch.float32) if n > 1 else None)
    tq, to, tm, tf = (_pointer_table(t)
                      for t in (slots_q, slots_do, slots_meta, flags))
    err = build.library().fast3r_ring_attention_bwd_dkv(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), *_strides(q, k, v, do), meta.data_ptr(), meta.shape[1],
        dk.data_ptr(), dv.data_ptr(),
        0 if state is None else state.data_ptr(), ctypes.addressof(tq),
        ctypes.addressof(to), ctypes.addressof(tm), ctypes.addressof(tf),
        n, B, H, S, G, float(scale), int(TIMEOUT_S * 1e9),
        build.stream_handle(dev))
    build.check(err, "fast3r_ring_attention_bwd_dkv")
    ring_attention_bwd_dkv.launches += 1
    return dk, dv


ring_attention_bwd_dkv.launches = 0


def _bwd_rows(o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rows' inputs of the backward rings: delta = rowsum(do o) (n,
    B * H, S_loc) in fp32 from the rounded o (a plain torch op: XLA's place
    in the JAX package), for the dq ring; and the dk/dv ring's payload
    (n, 2 * B * H * S_pad) fp32: the rows' lse (B * H, S_pad), then their
    delta, each row zero-padded to S_pad = S_loc rounded up to a multiple
    of 64, so every 64-query tile's words are one aligned bulk copy."""
    n, B, S, H, _ = o.shape
    delta = (do.float() * o.float()).sum(-1)  # (n, B, S, H)
    delta = delta.permute(0, 1, 3, 2).reshape(n, B * H, S).contiguous()
    s_pad = -(-S // 64) * 64
    meta = torch.zeros((n, 2, B * H, s_pad), device=o.device,
                       dtype=torch.float32)
    meta[:, 0, :, :S] = lse.reshape(n, B * H, S)
    meta[:, 1, :, :S] = delta
    return delta, meta.view(n, 2 * B * H * s_pad)


def _ring_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                   scale: float, n: int, ctas_per_rank: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of the ring over rank-stacked CUDA (n, B, S_loc, H, 64)
    q, k, v from the forward's o and lse (n, B * H, S_loc) and the output
    gradient do: the rows' delta and (lse, delta) rows (:func:`_bwd_rows`),
    then the dq ring and the dk/dv ring, each launch with its own zeroed
    counters and slots.  ``ctas_per_rank`` overrides the resident count of
    both."""
    _check_kernel_input(q, n)
    do = do.contiguous()
    _check_input("o", o, q)
    _, B, S, H, _ = q.shape
    _check_rows("lse", lse, (n, B * H, S), q)
    delta, meta = _bwd_rows(o, do, lse)
    dq = ring_attention_bwd_dq(q, k, v, do, lse, delta, scale, n,
                               ctas_per_rank)
    dk, dv = ring_attention_bwd_dkv(q, k, v, do, meta, scale, n,
                                    ctas_per_rank)
    return dq, dk, dv


class _RingAttention(torch.autograd.Function):
    """The ring forward kernel, saving q, k, v, o and lse; its backward the
    two ring kernels."""

    @staticmethod
    def forward(ctx, q, k, v, scale, n):
        o, lse = _rdma_forward(q, k, v, scale, n)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.n = scale, n
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _ring_backward(q, k, v, o, lse, do, ctx.scale, ctx.n)
        return dq, dk, dv, None, None


def ring_flash_attention_rdma_diff(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, scale: float, n: int
                                   ) -> torch.Tensor:
    """Differentiable ring attention over n rank-stacked shards: q, k, v
    (n, B, S_loc, H, 64) CUDA tensors -> o (n, B, S_loc, H, 64); the
    forward is the ring kernel, the backward the dq and dk/dv ring kernels.
    The training path of ``make_seq_sharded_train_step(ring_impl="rdma")``.
    Anything the kernels cannot take raises; there is no fallback to the
    plain ring."""
    return _RingAttention.apply(q, k, v, scale, n)
