"""CroCo ViT image encoder.

Counterpart of ``fast3r_tpu/models/encoder.py``: patch embed -> depth x pre-LN
ViT block with 2D RoPE (base 100) -> final LayerNorm (eps 1e-6).  Flagship:
ViT-L/16, embed_dim 1024, depth 24, 16 heads, mlp_ratio 4.  The RoPE tables
are computed once per forward and shared by every block.  The dropout knobs
(``drop``, ``attn_drop``, ``drop_path``, 0 in every shipped configuration)
act when the forward is given a generator (``nn.layers``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from fast3r_torch.models.patch_embed import (
    patch_embed_manyar,
    patch_embed_simple,
)
from fast3r_torch.nn.layers import (
    layernorm,
    make_vit_stack,
    run_vit_stack,
    stack_grids,
)
from fast3r_torch.ops.rope2d import rope2d_cos_sin


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    patch_size: int = 16
    patch_embed_cls: str = "ManyAR_PatchEmbed"  # or "PatchEmbedDust3R"
    embed_dim: int = 1024
    num_heads: int = 16
    depth: int = 24
    mlp_ratio: float = 4.0
    rope_base: float = 100.0
    attn_impl: str = "batched"
    ln_eps: float = 1e-6
    # the fused-GEMM blocks (nn.fused_block), as in the JAX package
    fused_blocks: bool = True
    # the reference Block's dropout rates (nn.layers.vit_block)
    drop: float = 0.0
    attn_drop: float = 0.0
    drop_path: float = 0.0


class Encoder(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.patch_embed = nn.Conv2d(3, cfg.embed_dim, cfg.patch_size,
                                     stride=cfg.patch_size)
        self.blocks = make_vit_stack(cfg.depth, cfg.embed_dim, cfg.mlp_ratio,
                                     qkv_bias=True)
        self.norm = nn.LayerNorm(cfg.embed_dim)


def encoder_forward(params: Encoder, cfg: EncoderConfig, img: torch.Tensor,
                    true_shape: Optional[torch.Tensor] = None,
                    remat: bool = False,
                    generator: Optional[torch.Generator] = None, mesh=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode (B, H, W, 3) images (landscape storage layout, normalised to
    [-1, 1]); true_shape (B, 2) int (height, width) defaults to the storage
    shape.  ``remat`` recomputes the blocks in the backward; ``generator``
    (a training forward's) seeds the blocks' dropout.  With a
    ``parallel.mesh.Mesh`` of ``model > 1`` the blocks run tensor-parallel
    on this rank's slices and heads (a sublayer whose heads or hidden
    ``model`` does not divide, whole on every rank); the patch embedding
    and the final norm are replicated.  Returns feats (B, P, embed_dim)
    and positions (B, P, 2)."""
    B, H, W, _ = img.shape
    if true_shape is None:
        true_shape = torch.tensor([H, W], dtype=torch.int32).expand(B, 2)
    if cfg.patch_embed_cls == "ManyAR_PatchEmbed":
        x, pos = patch_embed_manyar(params.patch_embed, img, true_shape,
                                    cfg.patch_size)
    else:
        x, pos = patch_embed_simple(params.patch_embed, img, cfg.patch_size)

    head_dim = cfg.embed_dim // cfg.num_heads
    rope = rope2d_cos_sin(pos, head_dim, cfg.rope_base)
    x, _ = run_vit_stack(params.blocks, x, cfg.num_heads, head_dim ** -0.5,
                         rope_cos_sin=rope, attn_impl=cfg.attn_impl,
                         ln_eps=cfg.ln_eps, fused=cfg.fused_blocks,
                         remat=remat, drop=cfg.drop, attn_drop=cfg.attn_drop,
                         drop_path_rate=cfg.drop_path, generator=generator,
                         mesh=mesh, tps=stack_grids(mesh, cfg))
    return layernorm(params.norm, x, cfg.ln_eps), pos
