"""Sequence parallelism: ring attention and the sequence-sharded serving
forward (the 1000-view path).

Counterpart of ``fast3r_tpu/parallel/sequence.py`` (``_merge_partials``,
``ring_flash_attention``, ``make_seq_sharded_forward``).  The fused N-view
token sequence is cut into n shards, one per rank; the fusion decoder's
global attention runs as ring attention (each rank's queries against every
rank's K/V, one shard per epoch, the partials merged by the exact
online-softmax rule); everything else in the decoder is per token, and the
encoder and the DPT heads are per view.

The JAX package runs the ranks as devices of a ``shard_map`` mesh.  Here
the ranks are stacked on a leading axis of one device: the decoder runs on
``(n, S_loc, C)`` activations, ranks in the batch position, and its
attention receives rank-stacked ``(n, S_loc, H, D)`` shards.  With
``ring_impl="rdma"`` that attention is the ring kernel
(:func:`fast3r_torch.parallel.ring_rdma.ring_flash_attention_rdma`, all n
ranks in one launch); with ``"plain"`` it is :func:`ring_flash_attention`,
the kernel's plain version.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from fast3r_torch.models.decoder import image_idx_table, sample_random_image_ids
from fast3r_torch.models.dpt_head import dpt_head_forward
from fast3r_torch.models.encoder import encoder_forward
from fast3r_torch.models.fast3r import Fast3RConfig, Fast3RNet, _chunk_views
from fast3r_torch.nn.layers import layernorm, linear, run_vit_stack
from fast3r_torch.ops.flash_attention import attention_lse_ref
from fast3r_torch.parallel.ring_rdma import ring_flash_attention_rdma

RING_IMPLS = ("rdma", "plain")


def _merge_partials(o1, lse1, o2, lse2):
    """Merge two normalised partial attention results (online softmax): o
    (B, S, H, D), lse (B, H, S) fp32.  Returns o in o1's dtype and the
    merged lse."""
    m = torch.maximum(lse1, lse2)
    w1 = torch.exp(lse1 - m)
    w2 = torch.exp(lse2 - m)
    denom = w1 + w2

    def per_row(w):  # (B, H, S) -> (B, S, H, 1)
        return w.transpose(1, 2)[..., None]

    o = (o1.float() * per_row(w1) + o2.float() * per_row(w2)) / per_row(denom)
    return o.to(o1.dtype), m + torch.log(denom)


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float, epochs: Optional[int] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain ring attention over rank-stacked q, k, v (n, B, S_loc, H, D),
    on any device: the ring kernel's plain version.  For each rank r and
    epoch s, plain attention with lse
    (:func:`fast3r_torch.ops.flash_attention.attention_lse_ref`, what
    ``attention_fwd_lse`` runs on the CPU) of q_r against the K/V of rank
    (r - s) mod n, merged into a running fp32 result.  ``epochs`` (n = 1:
    the self-ring) defaults to n.  Returns o (n, B, S_loc, H, D) in q's
    dtype and lse (n, B * H, S_loc) fp32 (JAX's ring returns o only; the
    lse is the kernel's other output)."""
    n, B, S, H, _ = q.shape
    epochs = n if epochs is None else epochs
    outs, lses = [], []
    for r in range(n):
        o, lse = attention_lse_ref(q[r], k[r], v[r], scale)
        o = o.float()
        for s in range(1, epochs):
            src = (r - s) % n
            o_s, lse_s = attention_lse_ref(q[r], k[src], v[src], scale)
            o, lse = _merge_partials(o, lse, o_s, lse_s)
        outs.append(o.to(q.dtype))
        lses.append(lse.reshape(B * H, S))
    return torch.stack(outs), torch.stack(lses)


def make_seq_sharded_forward(cfg: Fast3RConfig, n: int, num_views: int,
                             image_hw: Tuple[int, int],
                             head_chunk_views: Optional[int] = None,
                             ring_impl: str = "rdma", device="cuda"
                             ) -> Callable[..., Dict[str, torch.Tensor]]:
    """The sequence-sharded serving forward over ``n`` ranks.

    Returns ``fwd(params, imgs, view_ids=None)``: ``params`` a
    :class:`~fast3r_torch.models.fast3r.Fast3RNet` on ``device`` (the same
    weights as ``fast3r_forward``; ``utils.convert.params_from_jax`` carries
    JAX's across, and the path adds no parameter), ``imgs`` (1, V, H, W, 3)
    with V = ``num_views`` and (H, W) = ``image_hw``, moved to ``device``
    in the params' dtype; ``view_ids`` (V,) the decoder's image ids, by
    default drawn as the single-device forward draws them at inference
    (:func:`sample_random_image_ids` from a generator seeded 0, or arange
    without random ids).  Returns pts3d_in_other_view (1, V, H, W, 3), conf
    (1, V, H, W) [, pts3d_local, conf_local].

    Rank r holds views [r V/n, (r+1) V/n).  The encoder runs over all ranks'
    views in one call and the heads over all views (in chunks of the
    largest divisor of V/n <= ``head_chunk_views`` when given): both are
    per view, so this is the per-rank computation.  The decoder runs on the
    rank-stacked sequence, its blocks on the plain block road with the ring
    as their callable attention (``ring_impl``: "rdma", the kernel, or
    "plain", its plain version).  ``device`` is "cuda" unless the caller
    asks for the CPU.  V % n != 0, a batch other than 1 and the llama
    decoder raise.
    """
    if num_views % n != 0:
        raise ValueError(f"views {num_views} % ranks {n} != 0")
    if ring_impl not in RING_IMPLS:
        raise ValueError(f"unknown ring_impl {ring_impl!r}; expected one of "
                         f"{RING_IMPLS}")
    if cfg.decoder_type != "fast3r":
        raise NotImplementedError(
            "the sequence-sharded forward runs the fusion decoder only (the "
            "JAX package's has no llama-decoder path)")
    device = torch.device(device)
    V, (H, W) = num_views, image_hw
    dcfg = cfg.decoder

    def ring_attn(q, k, v, scale):
        # q, k, v: (n, S_loc, H, D), ranks in the batch position
        q, k, v = (t.unsqueeze(1) for t in (q, k, v))
        if ring_impl == "rdma":
            o = ring_flash_attention_rdma(q, k, v, scale, n)
        else:
            o = ring_flash_attention(q, k, v, scale)[0]
        return o.squeeze(1)

    def run_heads(params, tokens):
        g = dpt_head_forward(params.head_global, cfg.head, tokens, (H, W))
        res = {"pts3d_in_other_view": g["pts3d"], "conf": g["conf"]}
        if cfg.with_local_head:
            loc = dpt_head_forward(params.head_local, cfg.head, tokens, (H, W))
            res["pts3d_local"], res["conf_local"] = loc["pts3d"], loc["conf"]
        return res

    @torch.inference_mode()
    def fwd(params: Fast3RNet, imgs: torch.Tensor,
            view_ids: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        p0 = next(params.parameters())
        if p0.device.type != device.type:
            raise ValueError(f"params are on {p0.device}, the forward on "
                             f"{device}")
        if imgs.shape[0] != 1:
            raise ValueError("the 1000-view path is B=1 (reference: bs=1 "
                             f"inference), got a batch of {imgs.shape[0]}")
        if tuple(imgs.shape[1:]) != (V, H, W, 3):
            raise ValueError(f"imgs {tuple(imgs.shape)} != (1, {V}, {H}, {W}, 3)")
        imgs = imgs.to(device=p0.device, dtype=p0.dtype)
        feats, _ = encoder_forward(params.encoder, cfg.encoder,
                                   imgs.reshape(V, H, W, 3))
        P = feats.shape[1]
        fused = feats.reshape(n, V // n * P, -1)  # rank-stacked sequence

        if view_ids is None:
            view_ids = (sample_random_image_ids(None, 1, V)[0]
                        if dcfg.random_image_idx_embedding
                        else torch.arange(V, dtype=torch.int32))
        ids = torch.as_tensor(view_ids).reshape(V).to(device=fused.device,
                                                      dtype=torch.long)
        image_ids = ids.repeat_interleave(P).reshape(n, -1)

        outputs = {0: fused}
        x = linear(params.decoder.decoder_embed, fused)
        table = torch.as_tensor(image_idx_table(dcfg.embed_dim),
                                device=x.device, dtype=x.dtype)
        x = x + table[image_ids]
        inner = [h for h in dcfg.hooks if 0 < h < dcfg.depth]
        x, hooked = run_vit_stack(params.decoder.blocks, x, dcfg.num_heads,
                                  dcfg.attn_scale(is_training=False),
                                  rope_cos_sin=None, attn_impl=ring_attn,
                                  ln_eps=dcfg.block_ln_eps, hooks=inner)
        outputs.update(hooked)
        outputs[dcfg.depth] = layernorm(params.decoder.norm, x,
                                        dcfg.final_ln_eps)

        tokens = [outputs[h].reshape(V, P, -1) for h in dcfg.hooks]
        cv = _chunk_views(head_chunk_views, V // n) or V
        chunks = [run_heads(params, [t[c:c + cv] for t in tokens])
                  for c in range(0, V, cv)]
        return {k: torch.cat([r[k] for r in chunks])[None] for k in chunks[0]}

    return fwd
