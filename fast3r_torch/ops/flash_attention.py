"""Attention forward over (B, N, H, D): the hand-written CUDA kernel
(``csrc/attention_fwd.cu``, kernel 2 of the port) and its plain version.

Counterpart of ``fast3r_tpu/ops/flash_attention.py`` (the decoder's packed
flash kernel) and ``fast3r_tpu/ops/batched_attention.py`` (the encoder's
many-small-heads kernel): one strided kernel serves both.  The source note
in ``attention_fwd.cu`` says what bounds it on the H100 and how it is laid
out.

Numerics: scores and softmax statistics in fp32.  The kernel rounds the
unnormalised probabilities to bf16 before the p @ v product (tensor cores)
and sums the unrounded ones; :func:`attention_ref` rounds the normalised
weights instead (``fast3r_tpu/ops/attention.py`` "naive").  The two agree in
fp32 at summation-order level and in bf16 at bf16 rounding.
"""

from __future__ import annotations

import torch

from fast3r_torch.kernels import build

HEAD_DIM = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """Plain attention: fp32 logits and softmax, weights rounded to the input
    dtype before the product with v (the JAX package's "naive" path)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def _check(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if t.device != like.device or t.dtype != like.dtype:
        raise ValueError(f"attention: {name} is {t.dtype} on {t.device}, "
                         f"expected {like.dtype} on {like.device}")
    if t.dim() != 4 or t.shape[0] != like.shape[0] or t.shape[2:] != like.shape[2:]:
        raise ValueError(f"attention: {name} has shape {tuple(t.shape)}, "
                         f"q has {tuple(like.shape)}")
    vec = 16 // t.element_size()
    if (t.stride(3) != 1 or t.data_ptr() % 16
            or any(s % vec for s in t.stride()[:3])):
        raise ValueError(
            f"attention: {name} strides {t.stride()} are not 16-byte rows "
            "(head dim contiguous, other strides multiples of 16 bytes)")


def launch_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """Launch the kernel on CUDA q, k, v (B, N, H, 64) read through their
    strides; (B, Nq, H, 64) contiguous out.  Checks what the kernel takes and
    raises on anything else; counts nothing (each caller keeps its count)."""
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
        *v.stride()[:3], float(scale), build.stream_handle(q.device))
    build.check(err, "fast3r_attention_fwd")
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """softmax(scale * q k^T) v over (B, N, H, D) inputs; (B, Nq, H, D) out.

    CPU tensors take :func:`attention_ref`.  CUDA tensors launch the kernel
    (:func:`launch_attention`), which reads q, k and v through their strides
    (no copy of the qkv projection's views) and takes D == 64 in float32 or
    bfloat16; anything else raises.
    """
    if q.device.type == "cpu":
        return attention_ref(q, k, v, scale)
    o = launch_attention(q, k, v, scale)
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
