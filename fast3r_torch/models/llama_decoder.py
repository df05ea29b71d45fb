"""Llama-style fusion decoder (the reference's ``llama_dec`` ablation).

Counterpart of ``fast3r_tpu/models/llama_decoder.py``: all views' encoder
tokens fused into one (B, S, D_enc) sequence -> linear ``decoder_embed`` ->
n_layers x llama block -> RMSNorm ``norm``.  A block is RMSNorm -> GQA
attention (bias-free wq / wk / wv / wo, rotary on q and k) -> residual ->
RMSNorm -> SwiGLU FFN (w2(SiLU(w1 h) * w3 h), hidden
round_up(2/3 * 4 * D, multiple_of)) -> residual.

  * the rotary embedding rotates *consecutive pairs* (0::2, 1::2) in fp32
    and rounds once (not the encoder's rotate-half RoPE2D); its index is
    each token's image id, random at training and at inference alike, and
    its table has ``max_seq_len`` rows (θ = ``rope_theta``);
  * a learned ``view0_embed`` is added to view 0's tokens before EVERY
    layer, in x's dtype;
  * attention is bidirectional with scale head_dim ** -0.5 (no entropy
    bias); GQA repeats each kv head n_heads / kv_heads times;
  * hook 0 is the post-projection x, hooks d/2 and 3d/4 the carry after
    those layers, hook d the normed output.

With ``fused_blocks`` (the default, as in the JAX package) every block is
:func:`fast3r_torch.nn.fused_block.fused_llama_block`, whose products are
the hand-written RMS -> GEMM kernels; shapes the kernels cannot take raise
on CUDA.  The plain composition (``fused_blocks=False``) runs the products
as cuBLAS matmuls, as the JAX package leaves them to XLA off the TPU.

Tensor parallelism (``mesh`` a ``parallel.mesh.Mesh`` of ``model > 1``):
each rank holds whole heads, its ``n_heads / model`` query heads' ``wq``
rows and the ``kv_heads / model`` kv heads they read under the GQA repeat
(contiguous ``wk`` / ``wv`` rows), a slice of the SwiGLU hidden (``w1``,
``w3`` rows, ``w2`` columns) and the input columns of ``wo``; the norms,
``decoder_embed`` and ``view0_embed`` are replicated.  ``wo`` and ``w2``
are row-parallel products summed over the model group (no bias), on the
fused road inside ``matmul_residual``, the residual added to the sum.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from fast3r_torch.models.decoder import MAX_IMAGE_IDX
from fast3r_torch.nn.fused_block import fused_llama_block, fused_llama_supported
from fast3r_torch.nn.layers import RMSNorm, linear, row_parallel, stack_grids
from fast3r_torch.ops.attention import dot_product_attention


@dataclasses.dataclass(frozen=True)
class LlamaDecoderConfig:
    enc_embed_dim: int = 1024
    embed_dim: int = 1024
    n_layers: int = 24
    n_heads: int = 16
    n_kv_heads: Optional[int] = None
    multiple_of: int = 256
    ffn_dim_multiplier: Optional[float] = None
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_seq_len: int = MAX_IMAGE_IDX
    random_image_idx_embedding: bool = True
    # one of ops.attention.IMPLS (the port has no "xla")
    attn_impl: str = "pallas"
    # the fused RMS -> GEMM blocks (nn.fused_block), as in the JAX package
    fused_blocks: bool = True

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def ffn_hidden(self) -> int:
        hidden = int(2 * (4 * self.embed_dim) / 3)
        if self.ffn_dim_multiplier is not None:
            hidden = int(self.ffn_dim_multiplier * hidden)
        m = self.multiple_of
        return m * ((hidden + m - 1) // m)

    @property
    def hooks(self) -> Tuple[int, int, int, int]:
        d = self.n_layers
        return (0, d * 2 // 4, d * 3 // 4, d)


@functools.lru_cache(maxsize=8)
def freqs_cos_sin_table(head_dim: int, end: int, theta: float
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """(end, head_dim / 2) cos and sin of the rotary angles t * θ^(-2i/d),
    computed in float64 and cast to float32."""
    freqs = 1.0 / (theta ** (np.arange(0, head_dim, 2)[: head_dim // 2]
                             .astype(np.float64) / head_dim))
    f = np.outer(np.arange(end, dtype=np.float64), freqs)
    return np.cos(f).astype(np.float32), np.sin(f).astype(np.float32)


def apply_rotary_pairs(x: torch.Tensor, cos: torch.Tensor,
                       sin: torch.Tensor) -> torch.Tensor:
    """Rotate consecutive pairs (x[..., 0::2], x[..., 1::2]) in fp32 and
    round once to x's dtype; x (B, S, H, D), cos / sin (B, S, D / 2)."""
    xf = x.float()
    x0, x1 = xf[..., 0::2], xf[..., 1::2]
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    out = torch.stack([x0 * c - x1 * s, x0 * s + x1 * c], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def rmsnorm(p: RMSNorm, x: torch.Tensor, eps: float) -> torch.Tensor:
    """fp32 statistics; the normalised x cast to x's dtype BEFORE the scale
    multiply (in x's dtype), as the JAX package's ``rmsnorm``."""
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return y.to(x.dtype) * p.weight.to(x.dtype)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaDecoderConfig):
        super().__init__()
        d, hd = cfg.embed_dim, cfg.head_dim
        self.wq = nn.Linear(d, cfg.n_heads * hd, bias=False)
        self.wk = nn.Linear(d, cfg.kv_heads * hd, bias=False)
        self.wv = nn.Linear(d, cfg.kv_heads * hd, bias=False)
        self.wo = nn.Linear(cfg.n_heads * hd, d, bias=False)


class FeedForward(nn.Module):
    def __init__(self, cfg: LlamaDecoderConfig):
        super().__init__()
        d, hidden = cfg.embed_dim, cfg.ffn_hidden
        self.w1 = nn.Linear(d, hidden, bias=False)
        self.w2 = nn.Linear(hidden, d, bias=False)
        self.w3 = nn.Linear(d, hidden, bias=False)


class LlamaBlock(nn.Module):
    """attention_norm, attn.{wq, wk, wv, wo}, ffn_norm, ffn.{w1, w2, w3}."""

    def __init__(self, cfg: LlamaDecoderConfig):
        super().__init__()
        self.attention_norm = RMSNorm(cfg.embed_dim)
        self.attn = LlamaAttention(cfg)
        self.ffn_norm = RMSNorm(cfg.embed_dim)
        self.ffn = FeedForward(cfg)


class LlamaDecoder(nn.Module):
    """decoder_embed, layers.{i}, norm and the bare view0_embed."""

    def __init__(self, cfg: LlamaDecoderConfig):
        super().__init__()
        self.decoder_embed = nn.Linear(cfg.enc_embed_dim, cfg.embed_dim)
        self.layers = nn.ModuleList(LlamaBlock(cfg)
                                    for _ in range(cfg.n_layers))
        self.norm = RMSNorm(cfg.embed_dim)
        self.view0_embed = nn.Parameter(torch.zeros(cfg.embed_dim))


def llama_block(p: LlamaBlock, x: torch.Tensor, cos, sin,
                cfg: LlamaDecoderConfig, fused: bool = False,
                tps=(None, None)) -> torch.Tensor:
    """One llama block on x (B, S, D): the fused block with ``fused=True``,
    else the plain composition of the JAX package.  ``tps``: the
    (attention's, FFN's) tensor-parallel grids (``stack_grids``; ``p``
    this rank's slices of a split sublayer)."""
    if fused:
        return fused_llama_block(p, x, cos, sin, cfg, tps)
    B, S, D = x.shape
    hd = cfg.head_dim
    tp, tp_ffn = tps
    m = 1 if tp is None else tp.model
    heads, kv_heads = cfg.n_heads // m, cfg.kv_heads // m
    h = rmsnorm(p.attention_norm, x, cfg.norm_eps)
    if tp is not None:
        h = tp.copy_to_model(h)
    q = linear(p.attn.wq, h).reshape(B, S, heads, hd)
    k = linear(p.attn.wk, h).reshape(B, S, kv_heads, hd)
    v = linear(p.attn.wv, h).reshape(B, S, kv_heads, hd)
    q = apply_rotary_pairs(q, cos, sin)
    k = apply_rotary_pairs(k, cos, sin)
    n_rep = cfg.n_heads // cfg.kv_heads
    if n_rep > 1:  # GQA: each kv head repeated in place (jnp.repeat)
        k = k.repeat_interleave(n_rep, dim=2)
        v = v.repeat_interleave(n_rep, dim=2)
    o = dot_product_attention(q, k, v, scale=hd ** -0.5, impl=cfg.attn_impl)
    x = x + row_parallel(p.attn.wo, o.reshape(B, S, heads * hd), tp)
    h = rmsnorm(p.ffn_norm, x, cfg.norm_eps)
    if tp_ffn is not None:
        h = tp_ffn.copy_to_model(h)
    gate = F.silu(linear(p.ffn.w1, h)) * linear(p.ffn.w3, h)
    return x + row_parallel(p.ffn.w2, gate, tp_ffn)


def llama_decoder_forward(params: LlamaDecoder, cfg: LlamaDecoderConfig,
                          feats: torch.Tensor, image_ids: torch.Tensor,
                          rope_ids: Optional[torch.Tensor] = None,
                          remat: bool = False, mesh=None
                          ) -> Dict[int, torch.Tensor]:
    """Run the llama fusion decoder.

    feats: (B, S, D_enc) fused encoder tokens; image_ids: (B, S) each
    token's view index (0..V-1), read for the view-0 mask; rope_ids: (B, S)
    the rotary index of each token (the random image ids; ``image_ids``
    when None).  ``remat`` recomputes each plain block in the backward (the
    fused block always does).  With a ``parallel.mesh.Mesh`` of ``model >
    1`` the layers run tensor-parallel on this rank's slices (the attention
    whole on every rank where ``model`` does not divide its heads and kv
    heads, the FFN where it does not divide the hidden).  Returns
    {hook: activation} for ``cfg.hooks``.  On CUDA with ``fused_blocks`` a
    shape the kernels cannot take (at a rank's widths) raises.
    """
    tps = stack_grids(mesh, cfg)
    model = 1 if mesh is None else mesh.model
    x = linear(params.decoder_embed, feats)
    if cfg.fused_blocks and x.is_cuda and not fused_llama_supported(
            x.shape, cfg, model):
        raise ValueError(f"fused llama block: the kernels do not take x "
                         f"{tuple(x.shape)} with {cfg} at model={model}")
    ids = (image_ids if rope_ids is None else rope_ids).to(
        device=x.device, dtype=torch.long)
    cos_t, sin_t = freqs_cos_sin_table(cfg.head_dim, cfg.max_seq_len,
                                       cfg.rope_theta)
    cos = torch.as_tensor(cos_t, device=x.device)[ids]  # (B, S, hd / 2)
    sin = torch.as_tensor(sin_t, device=x.device)[ids]
    view0 = (image_ids.to(x.device) == 0)[..., None].to(x.dtype)
    v0 = params.view0_embed.to(x.dtype)

    outputs: Dict[int, torch.Tensor] = {0: x}
    checkpoint = remat and not cfg.fused_blocks and torch.is_grad_enabled()
    for i, layer in enumerate(params.layers):
        h = x + view0 * v0  # view0_embed before every layer
        args = (layer, h, cos, sin, cfg, cfg.fused_blocks, tps)
        x = (torch.utils.checkpoint.checkpoint(llama_block, *args,
                                               use_reentrant=False)
             if checkpoint else llama_block(*args))
        if i + 1 in cfg.hooks and i + 1 < cfg.n_layers:
            outputs[i + 1] = x
    outputs[cfg.n_layers] = rmsnorm(params.norm, x, cfg.norm_eps)
    return outputs
