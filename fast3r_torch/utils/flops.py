"""Analytic forward-FLOP accounting for the Fast3R model.

Counterpart of ``fast3r_tpu/utils/flops.py`` (``_vit_block_flops``,
``encoder_flops_per_image``, ``decoder_flops``,
``dpt_head_flops_per_image``, ``fast3r_forward_flops``) on the port's
configurations.  Every matmul and conv counts as 2*M*N*K; elementwise work
(softmax, LayerNorm, RoPE, activations, postprocess) is left out: it is
memory-bound and under 1% of the arithmetic.  No hardware enters the count.

The llama decoder (``cfg.decoder`` a ``LlamaDecoderConfig``) is counted by
its own products: q / k / v with its kv heads, wo, and the SwiGLU's w1, w3
and w2 (the JAX counter reads a ViT decoder's ``depth`` and ``mlp_ratio``
and raises on it).
"""

from __future__ import annotations

from typing import Dict

from fast3r_torch.models.dpt_head import DPTHeadConfig
from fast3r_torch.models.fast3r import Fast3RConfig


def _vit_block_flops(seq: int, dim: int, mlp_ratio: float = 4.0) -> float:
    """One pre-LN transformer block on ``seq`` tokens: qkv 6*S*D^2, the
    output projection 2*S*D^2, the MLP 2 * 2*S*D*rD, and the attention's
    QK^T and PV 2 * 2*S^2*D."""
    linears = (6 + 2 + 4 * mlp_ratio) * seq * dim * dim
    attn = 4 * seq * seq * dim
    return linears + attn


def encoder_flops_per_image(cfg: Fast3RConfig, height: int,
                            width: int) -> float:
    """CroCo ViT encoder forward FLOPs for one image."""
    e = cfg.encoder
    p = e.patch_size
    seq = (height // p) * (width // p)
    patchify = 2 * seq * (p * p * 3) * e.embed_dim  # one matmul a patch
    return patchify + e.depth * _vit_block_flops(seq, e.embed_dim, e.mlp_ratio)


def decoder_flops(cfg: Fast3RConfig, num_views: int, height: int,
                  width: int) -> Dict[str, float]:
    """Fusion decoder FLOPs over the sequence of all views' tokens:
    {"linears", "attention"}; the attention is quadratic in num_views
    (S = V * patches a view), the linears linear in it."""
    d = cfg.decoder
    p = cfg.encoder.patch_size
    seq = num_views * (height // p) * (width // p)
    embed = 2 * seq * d.enc_embed_dim * d.embed_dim  # decoder_embed
    if cfg.decoder_type == "llama":
        q_dim, kv_dim = d.n_heads * d.head_dim, d.kv_heads * d.head_dim
        block = 2 * seq * (d.embed_dim * (q_dim + 2 * kv_dim)   # wq wk wv
                           + q_dim * d.embed_dim                # wo
                           + 3 * d.embed_dim * d.ffn_hidden)    # w1 w3 w2
        return {"linears": embed + d.n_layers * block,
                "attention": d.n_layers * 4 * seq * seq * q_dim}
    linears = embed + d.depth * (6 + 2 + 4 * d.mlp_ratio) * seq \
        * d.embed_dim ** 2
    return {"linears": linears,
            "attention": d.depth * 4 * seq * seq * d.embed_dim}


def dpt_head_flops_per_image(cfg: DPTHeadConfig, height: int,
                             width: int) -> float:
    """One DPT head (adapter, refinenet cascade, regression) for one
    image."""
    p = cfg.patch_size
    npatch = (height // p) * (width // p)
    ld, fd, last = cfg.layer_dims, cfg.feature_dim, cfg.last_dim
    dt = cfg.dim_tokens

    def conv(pixels, kh, kw, cin, cout):
        return 2.0 * pixels * kh * kw * cin * cout

    def rcu(pixels):
        return 2 * conv(pixels, 3, 3, fd, fd)

    # act_postprocess: a 1x1 projection and a resample per hook
    total = conv(npatch, 1, 1, dt[0], ld[0])
    total += conv(npatch, 4, 4, ld[0], ld[0])     # the x4 transposed conv
    total += conv(npatch, 1, 1, dt[1], ld[1])
    total += conv(npatch, 2, 2, ld[1], ld[1])     # the x2 transposed conv
    total += conv(npatch, 1, 1, dt[2], ld[2])
    total += conv(npatch, 1, 1, dt[3], ld[3])
    total += conv(npatch / 4, 3, 3, ld[3], ld[3])     # the stride-2 down conv
    # layer{n}_rn: 3x3 -> feature_dim on the x4, x2, x1 and x0.5 grids
    for scale, dim in zip((16, 4, 1, 0.25), ld):
        total += conv(npatch * scale, 3, 3, dim, fd)
    # refinenets: two 3x3 convs a residual unit, a 1x1 out_conv after the
    # 2x upsample
    total += rcu(npatch / 4) + conv(npatch, 1, 1, fd, fd)
    total += 2 * rcu(npatch) + conv(npatch * 4, 1, 1, fd, fd)
    total += 2 * rcu(npatch * 4) + conv(npatch * 16, 1, 1, fd, fd)
    total += 2 * rcu(npatch * 16) + conv(npatch * 64, 1, 1, fd, fd)
    # the regression head at H/2, then at H
    half, full = (height // 2) * (width // 2), height * width
    total += conv(half, 3, 3, fd, fd // 2)
    total += conv(full, 3, 3, fd // 2, last)
    total += conv(full, 1, 1, last, cfg.num_channels)
    return total


def fast3r_forward_flops(cfg: Fast3RConfig, num_views: int, height: int,
                         width: int) -> Dict[str, float]:
    """Whole-model forward FLOPs for a (1, num_views, H, W) input: encoder,
    decoder_linears, decoder_attention, heads, total and per_image."""
    enc = encoder_flops_per_image(cfg, height, width) * num_views
    dec = decoder_flops(cfg, num_views, height, width)
    n_heads = 2 if cfg.with_local_head else 1
    heads = n_heads * dpt_head_flops_per_image(cfg.head, height,
                                               width) * num_views
    total = enc + dec["linears"] + dec["attention"] + heads
    return {"encoder": enc, "decoder_linears": dec["linears"],
            "decoder_attention": dec["attention"], "heads": heads,
            "total": total, "per_image": total / num_views}
