"""Attention over (B, N, H, D), forward and backward: the hand-written CUDA
kernels (``csrc/attention_fwd.cu``, ``csrc/attention_bwd.cu``) and their
plain versions.

Counterpart of ``fast3r_tpu/ops/flash_attention.py`` (the decoder's packed
flash kernels, forward and backward) and ``fast3r_tpu/ops/batched_attention.py``
(the encoder's many-small-heads kernels): one strided kernel serves both in
each direction.  The source notes say what bounds them on the H100 and how
they are laid out.

Numerics: scores and softmax statistics in fp32.  The forward kernel rounds
the unnormalised probabilities to bf16 before the p @ v product (tensor
cores) and sums the unrounded ones; :func:`attention_ref` rounds the
normalised weights instead (``fast3r_tpu/ops/attention.py`` "naive").  The
two agree in fp32 at summation-order level and in bf16 at bf16 rounding.
For training the forward also returns the rows' fp32 logsumexp (lse), and
the backward recomputes p from it; :func:`attention_bwd_ref` states the
backward's rounding points.

:func:`flash_attention` is differentiable: under autograd it runs the
forward with lse and the backward kernel (plain versions on the CPU);
without autograd (inference) it launches the forward alone.
"""

from __future__ import annotations

import torch

from fast3r_torch.kernels import build

HEAD_DIM = 64
LSE_ROWS = 64  # lse / delta rows are padded to whole 64-query tiles
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """Plain attention: fp32 logits and softmax, weights rounded to the input
    dtype before the product with v (the JAX package's "naive" path)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def attention_lse_ref(q, k, v, scale: float):
    """:func:`attention_ref` and the rows' fp32 natural-log logsumexp of the
    scaled scores, (B, H, Nq)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return (torch.einsum("bhqk,bkhd->bqhd", w, v),
            torch.logsumexp(logits, dim=-1))


def attention_bwd_ref(q, k, v, o, lse, do, scale: float):
    """Plain backward: (dq, dk, dv) in q's dtype from the forward's output o
    and lse (B, H, Nq).  p = exp(scale q k^T - lse) and ds = p (do v^T -
    delta) in fp32, delta = rowsum(do o) from the rounded o; p and ds
    rounded to the input dtype before their products (the TPU kernels'
    rounding points), fp32 products."""
    dt = q.dtype
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.exp(s - lse[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    delta = (dof * o.float()).sum(-1).transpose(1, 2)  # (B, H, Nq)
    ds = (p * (dp - delta[..., None])).to(dt).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _check(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if t.device != like.device or t.dtype != like.dtype:
        raise ValueError(f"attention: {name} is {t.dtype} on {t.device}, "
                         f"expected {like.dtype} on {like.device}")
    if t.dim() != 4 or t.shape[0] != like.shape[0] or t.shape[2:] != like.shape[2:]:
        raise ValueError(f"attention: {name} has shape {tuple(t.shape)}, "
                         f"q has {tuple(like.shape)}")
    if tma_dims(t) is None:
        raise ValueError(
            f"attention: {name} strides {t.stride()} are not 16-byte rows "
            "(head dim contiguous, other strides multiples of 16 bytes)")


def tma_dims(t: torch.Tensor):
    """The rank-4 tensor-map view through which the backward kernels read a
    (B, N, H, D) tensor, or a rank-stacked (n, B, S, H, D) one with its rank
    and batch merged into one dimension: ``(dims, strides)`` innermost
    first, in elements, dims (D, N, H, B') and strides (1, token, head,
    batch), built from the tensor's own strides as the C entry points build
    their maps.  None where TMA cannot take the layout: D not contiguous, a
    stride not a multiple of 16 bytes, a base not 16-byte aligned, or rank
    and batch strides that do not merge (they merge when n == 1, B == 1 or
    the rank stride is B times the batch stride)."""
    if t.dim() == 5:
        n, B = t.shape[:2]
        s_rank, s_batch = t.stride()[:2]
        if n == 1 or s_rank == B * s_batch:
            sb = s_batch
        elif B == 1:
            sb = s_rank
        else:
            return None
        batch, (N, H, D), (sn, sh) = n * B, t.shape[2:], t.stride()[2:4]
    elif t.dim() == 4:
        (batch, N, H, D), (sb, sn, sh) = t.shape, t.stride()[:3]
    else:
        return None
    vec = 16 // t.element_size()
    if (t.stride(-1) != 1 or t.data_ptr() % 16
            or any(s % vec for s in (sn, sh, sb))):
        return None
    return (D, N, H, batch), (1, sn, sh, sb)


def _lse_buffer(B: int, H: int, Nq: int, device) -> torch.Tensor:
    """(B, H, Nq) fp32 view of a buffer whose rows are padded to whole
    64-query tiles, the layout the backward kernel reads."""
    ldl = -(-Nq // LSE_ROWS) * LSE_ROWS
    return torch.empty((B, H, ldl), device=device,
                       dtype=torch.float32)[..., :Nq]


def launch_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float, lse: torch.Tensor = None) -> torch.Tensor:
    """Launch the forward kernel on CUDA q, k, v (B, N, H, 64) read through
    their strides; (B, Nq, H, 64) contiguous out, and the rows' lse written
    into ``lse`` (a :func:`_lse_buffer`) when given.  Checks what the kernel
    takes and raises on anything else; counts nothing (each caller keeps its
    count)."""
    if q.device.type != "cuda":
        raise ValueError(f"attention: no kernel for device {q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"attention: dtype {q.dtype} not supported")
    if q.dim() != 4 or q.shape[3] != HEAD_DIM:
        raise ValueError(f"attention: q must be (B, N, H, {HEAD_DIM}), "
                         f"got {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, q)
    if k.shape[1] != v.shape[1] or k.shape[1] == 0:
        raise ValueError("attention: k and v need the same non-zero length")
    B, Nq, H, _ = q.shape
    Nk = k.shape[1]
    o = torch.empty((B, Nq, H, HEAD_DIM), device=q.device, dtype=q.dtype)
    lib = build.library()
    err = lib.fast3r_attention_fwd(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), B, H, Nq, Nk, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], float(scale),
        0 if lse is None else lse.data_ptr(),
        0 if lse is None else lse.stride(1), build.stream_handle(q.device))
    build.check(err, "fast3r_attention_fwd")
    return o


def attention_fwd_lse(q, k, v, scale: float):
    """(o, lse) for the backward: the plain version on CPU tensors, the
    forward kernel with its lse output on CUDA ones (counts nothing)."""
    if q.device.type == "cpu":
        return attention_lse_ref(q, k, v, scale)
    lse = _lse_buffer(q.shape[0], q.shape[2], q.shape[1], q.device)
    return launch_attention(q, k, v, scale, lse), lse


def launch_attention_bwd(q, k, v, o, lse, do, scale: float, dq, dk, dv):
    """Launch the backward kernels (dq, then dk / dv) on CUDA bf16 tensors:
    q, k, v and do (B, N, H, 64) read through rank-4 tensor maps of their
    strides (:func:`tma_dims`; views of one packed buffer are fine) and dq,
    dk, dv written through theirs; lse from :func:`attention_fwd_lse`.
    delta = rowsum(do o) is computed here, in fp32, into lse's padded
    layout.  A do that TMA cannot read is copied first; anything else
    that :func:`_check` refuses raises.  Counts nothing."""
    if q.dtype != torch.bfloat16:
        raise ValueError(f"attention backward: the kernel takes bfloat16, "
                         f"got {q.dtype}")
    if do.dim() == 4 and tma_dims(do) is None:
        do = do.contiguous()
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do), ("dq", dq),
                    ("dk", dk), ("dv", dv)):
        _check(name, t, q if name in ("q", "do", "dq") else k)
    if q.shape != do.shape or k.shape != v.shape:
        raise ValueError("attention backward: q / do and k / v shapes differ")
    B, Nq, H, _ = q.shape
    ldl = lse.stride(1)
    if (lse.dtype != torch.float32 or lse.shape != (B, H, Nq)
            or lse.stride(2) != 1 or ldl % LSE_ROWS or lse.stride(0) != H * ldl):
        raise ValueError("attention backward: lse must come from "
                         "attention_fwd_lse")
    delta = _lse_buffer(B, H, Nq, q.device)
    delta.copy_((do.float() * o.float()).sum(-1).transpose(1, 2))
    err = build.library().fast3r_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, H, Nq, k.shape[1], ldl,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
        *dq.stride()[:3], *dk.stride()[:3], *dv.stride()[:3], float(scale),
        build.stream_handle(q.device))
    build.check(err, "fast3r_attention_bwd")


def attention_bwd(q, k, v, o, lse, do, scale: float):
    """(dq, dk, dv) of attention from the forward's o and lse.  CPU tensors
    take :func:`attention_bwd_ref`; CUDA tensors launch the backward kernels
    into new contiguous (B, N, H, 64) tensors."""
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, o, lse, do, scale)
    dq = torch.empty(q.shape, device=q.device, dtype=q.dtype)
    dk = torch.empty(k.shape, device=k.device, dtype=k.dtype)
    dv = torch.empty(v.shape, device=v.device, dtype=v.dtype)
    launch_attention_bwd(q, k, v, o, lse, do, scale, dq, dk, dv)
    attention_bwd.launches += 1
    return dq, dk, dv


class _Attention(torch.autograd.Function):
    """Forward with lse, saved (q, k, v, o, lse); backward from them."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = attention_fwd_lse(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return (*attention_bwd(q, k, v, o, lse, do, ctx.scale), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """softmax(scale * q k^T) v over (B, N, H, D) inputs; (B, Nq, H, D) out.

    CPU tensors take the plain versions.  CUDA tensors launch the kernels
    (:func:`launch_attention`, and under autograd :func:`attention_bwd`),
    which read q, k and v through their strides (no copy of the qkv
    projection's views) and take D == 64, in float32 or bfloat16 forward
    and bfloat16 backward; anything else raises.
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        o = _Attention.apply(q, k, v, scale)
    elif q.device.type == "cpu":
        return attention_ref(q, k, v, scale)
    else:
        o = launch_attention(q, k, v, scale)
    if q.device.type != "cpu":
        flash_attention.launches += 1
    return o


flash_attention.launches = 0
attention_bwd.launches = 0
