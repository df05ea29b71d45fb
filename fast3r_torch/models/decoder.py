"""Fast3R global-fusion transformer decoder.

Counterpart of ``fast3r_tpu/models/decoder.py``: all views' encoder tokens
fused into one (B, S = V * P, D_enc) sequence -> linear ``decoder_embed`` ->
plus the image-index sincos embedding of each token's view id -> depth x
global self-attention pre-LN ViT blocks (no RoPE, block LayerNorm eps 1e-5)
-> ``dec_norm`` (eps 1e-6).  At inference the softmax scale carries the
attention-entropy bias ``head_dim**-0.5 * sqrt(log(137) / log(20))``; a
training forward uses ``head_dim**-0.5``.
Returns the DPT hooks [0, d/2, 3d/4, d]: hook 0 is the raw encoder tokens,
the last is normed.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from fast3r_torch.nn.layers import (
    layernorm,
    linear,
    make_vit_stack,
    run_vit_stack,
    stack_grids,
)
from fast3r_torch.ops.attention import AttnImpl
from fast3r_torch.ops.sincos import sincos_1d_table_np

MAX_IMAGE_IDX = 1000  # rows of the image-index embedding table

# attention-entropy bias constants
_TRAIN_SEQLEN = 20
_INFERENCE_SEQLEN = 137


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    enc_embed_dim: int = 1024
    embed_dim: int = 1024
    num_heads: int = 16
    depth: int = 24
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    random_image_idx_embedding: bool = True
    attn_bias_for_inference_enabled: bool = True
    # an implementation's name, or a callable (q, k, v, scale) -> o (the
    # sequence-sharded paths' ring)
    attn_impl: AttnImpl = "pallas"
    block_ln_eps: float = 1e-5
    final_ln_eps: float = 1e-6
    # the fused-GEMM blocks (nn.fused_block), as in the JAX package
    fused_blocks: bool = True
    # the reference Block's dropout rates (nn.layers.vit_block)
    drop: float = 0.0
    attn_drop: float = 0.0
    drop_path: float = 0.0

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    def attn_scale(self, is_training: bool = False) -> float:
        """Softmax scale: at inference with the attention-entropy bias."""
        base = self.head_dim ** -0.5
        if not is_training and self.attn_bias_for_inference_enabled:
            return base * math.sqrt(
                math.log(_INFERENCE_SEQLEN) / math.log(_TRAIN_SEQLEN))
        return base

    @property
    def hooks(self) -> Tuple[int, int, int, int]:
        """DPT hook indices into [enc_tokens, block1..blockD]."""
        d = self.depth
        return (0, d * 2 // 4, d * 3 // 4, d)


@functools.lru_cache(maxsize=8)
def image_idx_table(embed_dim: int) -> np.ndarray:
    """The (1000, D) image-index sincos table, a constant (not a parameter)."""
    return sincos_1d_table_np(embed_dim, MAX_IMAGE_IDX)


class Decoder(nn.Module):
    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.decoder_embed = nn.Linear(cfg.enc_embed_dim, cfg.embed_dim)
        self.blocks = make_vit_stack(cfg.depth, cfg.embed_dim, cfg.mlp_ratio,
                                     cfg.qkv_bias)
        self.norm = nn.LayerNorm(cfg.embed_dim)


def sample_random_image_ids(generator: Optional[torch.Generator],
                            batch_size: int, num_views: int) -> torch.Tensor:
    """Random per-sample image ids, (B, V) int32: view 0 is id 0, views
    1..V-1 get distinct random ids in [1, 999].  Past ``MAX_IMAGE_IDX``
    views the ids run out and it raises (the JAX package's draw comes up
    short there, and its decoder's add of the table rows raises).

    The ids come from ``generator`` (a CPU ``torch.Generator``; seeded 0 when
    None).  They are NOT the ids the JAX package draws from
    ``jax.random.key(0)`` (threefry cannot be reproduced in torch): to compare
    the two packages, pass the JAX ids into the port's forward.
    """
    if num_views > MAX_IMAGE_IDX:
        raise ValueError(
            f"{num_views} views: the image-index table has {MAX_IMAGE_IDX} "
            f"rows, id 0 for view 0 and {MAX_IMAGE_IDX - 1} distinct random "
            f"ids for the others, so at most {MAX_IMAGE_IDX} views")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    rows = []
    for _ in range(batch_size):
        perm = torch.randperm(MAX_IMAGE_IDX - 1, generator=generator)
        rows.append(torch.cat([torch.zeros(1, dtype=torch.int64),
                               perm[:num_views - 1] + 1]))
    return torch.stack(rows).to(torch.int32)


def decoder_forward(params: Decoder, cfg: DecoderConfig, feats: torch.Tensor,
                    image_ids: torch.Tensor, is_training: bool = False,
                    remat: bool = False,
                    generator: Optional[torch.Generator] = None, mesh=None
                    ) -> Dict[int, torch.Tensor]:
    """Run the fusion decoder.

    feats: (B, S, D_enc) fused encoder tokens; image_ids: (B, S) integer image
    id per token; ``is_training`` selects the softmax scale, ``remat``
    recomputes the blocks in the backward and ``generator`` seeds the
    blocks' dropout (a training forward's only); with a
    ``parallel.mesh.Mesh`` of ``model > 1`` the blocks run tensor-parallel
    on this rank's slices and heads (a sublayer whose heads or hidden
    ``model`` does not divide, ``decoder_embed``, the image-index table and
    the final norm replicated).  Returns {hook: activation} for
    ``cfg.hooks``.
    """
    outputs: Dict[int, torch.Tensor] = {0: feats}
    x = linear(params.decoder_embed, feats)
    table = torch.as_tensor(image_idx_table(cfg.embed_dim), device=x.device,
                            dtype=x.dtype)
    x = x + table[image_ids.to(device=x.device, dtype=torch.long)]

    inner_hooks = [h for h in cfg.hooks if 0 < h < cfg.depth]
    x, hooked = run_vit_stack(params.blocks, x, cfg.num_heads,
                              cfg.attn_scale(is_training),
                              rope_cos_sin=None, attn_impl=cfg.attn_impl,
                              ln_eps=cfg.block_ln_eps, hooks=inner_hooks,
                              fused=cfg.fused_blocks, remat=remat,
                              drop=cfg.drop, attn_drop=cfg.attn_drop,
                              drop_path_rate=cfg.drop_path,
                              generator=generator if is_training else None,
                              mesh=mesh, tps=stack_grids(mesh, cfg))
    outputs.update(hooked)
    outputs[cfg.depth] = layernorm(params.norm, x, cfg.final_ln_eps)
    return outputs
