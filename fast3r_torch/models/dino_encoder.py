"""DINOv2 ViT-L/14 image encoder (the ``encoder_type: dino`` variant).

Counterpart of ``fast3r_tpu/models/dino_encoder.py``: patch conv, a cls
token and learned position embeddings bicubically resized to the patch grid
with hub DINOv2's numerics (``ops.resize.resize_bicubic_torch``), then
depth x pre-LN ViT block with LayerScale (``ls1``, ``ls2``, stacked on a
leading depth axis), then the final LayerNorm; the cls token is dropped
from the output.  Portrait samples (``true_shape``) are embedded in their
true orientation and their patch grid is un-transposed before the stack,
which then runs once for the whole batch (per-token ops and full attention
are equivariant to the token order).

On CUDA a block runs LayerNorm through the LayerNorm kernel
(``ops.fused_layernorm``, K7), its qkv, proj, fc1 and fc2 products as
cuBLAS matmuls (the JAX package leaves them to XLA) and attention through
the attention kernel (``ops.attention`` "xla" -> K1, strided q, k, v, one
(view, head) per batch-head: 1 + h w tokens, 1037 at 392x518).

Tensor parallelism (a ``parallel.mesh.Mesh`` of ``model > 1``): the blocks
run on this rank's slices (whole heads of qkv, a slice of the MLP hidden)
through the plain road's column- and row-parallel products, the LayerScale
gammas applied to each sublayer's summed output; the patch embedding, the
tokens, the position embeddings, the gammas and the norms are replicated,
as JAX's ``param_pspec`` leaves them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from fast3r_torch.models.patch_embed import position_grid
from fast3r_torch.nn.layers import (
    attention_layer,
    conv2d,
    layernorm,
    make_vit_stack,
    mlp,
    stack_grids,
)
from fast3r_torch.ops.resize import resize_bicubic_torch


@dataclasses.dataclass(frozen=True)
class DinoEncoderConfig:
    patch_size: int = 14
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    pos_embed_size: int = 37  # the 518 / 14 grid of the pretrained model
    ln_eps: float = 1e-6
    attn_impl: str = "xla"


class DinoEncoder(nn.Module):
    """Params named as the JAX dict: patch_embed, cls_token (1, 1, C),
    pos_embed (1, n n + 1, C), blocks.{i}, ls1 / ls2 (depth, C), norm."""

    def __init__(self, cfg: DinoEncoderConfig):
        super().__init__()
        c, n = cfg.embed_dim, cfg.pos_embed_size
        self.patch_embed = nn.Conv2d(3, c, cfg.patch_size,
                                     stride=cfg.patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c))
        self.pos_embed = nn.Parameter(torch.zeros(1, n * n + 1, c))
        self.blocks = make_vit_stack(cfg.depth, c, cfg.mlp_ratio,
                                     qkv_bias=True)
        self.ls1 = nn.Parameter(torch.ones(cfg.depth, c))
        self.ls2 = nn.Parameter(torch.ones(cfg.depth, c))
        self.norm = nn.LayerNorm(c)


def _interp_pos_embed(pos_embed: torch.Tensor, grid_hw: Tuple[int, int],
                      src_size: int) -> torch.Tensor:
    """The learned patch position embeddings resized to the (h, w) grid
    with hub DINOv2's ``interpolate_pos_encoding`` numerics (bicubic A =
    -0.75, align_corners=False, scale_factor (n + 0.1) / M), the cls
    embedding in front: (1, 1 + h w, C)."""
    cls_pe = pos_embed[:, :1]
    patch_pe = pos_embed[:, 1:].reshape(1, src_size, src_size, -1)
    h, w = grid_hw
    if (h, w) != (src_size, src_size):
        patch_pe = resize_bicubic_torch(
            patch_pe, h, w,
            scale_factors=((h + 0.1) / src_size, (w + 0.1) / src_size))
    return torch.cat([cls_pe, patch_pe.reshape(1, h * w, -1)], dim=1)


def _dino_block(p, x: torch.Tensor, gamma1: torch.Tensor,
                gamma2: torch.Tensor, num_heads: int, scale: float,
                attn_impl: str, ln_eps: float, mesh=None,
                tps=(None, None)) -> torch.Tensor:
    a = attention_layer(p.attn, layernorm(p.norm1, x, ln_eps), num_heads,
                        scale, None, attn_impl, mesh=mesh, tp=tps[0])
    x = x + gamma1.to(x.dtype) * a
    return x + gamma2.to(x.dtype) * mlp(p.mlp, layernorm(p.norm2, x, ln_eps),
                                        mesh=mesh, tp=tps[1])


def dino_encoder_forward(params: DinoEncoder, cfg: DinoEncoderConfig,
                         img: torch.Tensor,
                         true_shape: Optional[torch.Tensor] = None,
                         mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode (B, H, W, 3) images (storage layout, normalised); true_shape
    (B, 2) int (height, width), the storage shape by default: a sample with
    width < height is portrait and is embedded transposed.  Returns the
    normalised patch tokens without cls (B, h w, C) and their positions
    (B, h w, 2) as (y, x), portrait ones in true-orientation values and
    storage order.  Differentiable.  With a ``parallel.mesh.Mesh`` of
    ``model > 1`` the blocks run tensor-parallel on this rank's slices and
    ``num_heads / model`` heads (a sublayer whose heads or hidden ``model``
    does not divide, whole on every rank)."""
    B, H, W, _ = img.shape
    ps = cfg.patch_size
    if H % ps or W % ps:
        raise ValueError(f"image {H}x{W} is not a multiple of the patch "
                         f"size {ps}")
    h, w = H // ps, W // ps
    if true_shape is None:
        true_shape = torch.tensor([H, W], dtype=torch.int32).expand(B, 2)
    is_portrait = true_shape[:, 1] < true_shape[:, 0]
    n_port = int(is_portrait.sum())

    def embed(images, gh, gw):
        """Patch conv, cls and the position embeddings of a (gh, gw) grid."""
        x = conv2d(params.patch_embed, images.permute(0, 3, 1, 2), stride=ps)
        x = x.flatten(2).transpose(1, 2)  # (B, gh gw, C)
        cls = params.cls_token.to(x.dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1)
        return x + _interp_pos_embed(params.pos_embed, (gh, gw),
                                     cfg.pos_embed_size).to(x.dtype)

    branches = []
    if n_port < B:
        branches.append(embed(img, h, w))
    if n_port > 0:
        port = embed(img.transpose(1, 2), w, h)  # (B, 1 + w h, C)
        # the portrait patch grid back to storage (h, w) order
        tok = port[:, 1:].reshape(B, w, h, -1).transpose(1, 2)
        branches.append(torch.cat([port[:, :1],
                                   tok.reshape(B, h * w, -1)], dim=1))
    if len(branches) == 2:
        sel = is_portrait.to(img.device)[:, None, None]
        x = torch.where(sel, branches[1], branches[0])
    else:
        x = branches[0]

    scale = (cfg.embed_dim // cfg.num_heads) ** -0.5
    tps = stack_grids(mesh, cfg)
    heads = cfg.num_heads // (1 if tps[0] is None else tps[0].model)
    for i, block in enumerate(params.blocks):
        x = _dino_block(block, x, params.ls1[i], params.ls2[i], heads, scale,
                        cfg.attn_impl, cfg.ln_eps, mesh, tps)
    tokens = layernorm(params.norm, x, cfg.ln_eps)[:, 1:]

    pos_land = position_grid(h, w, img.device)
    pos_port = position_grid(w, h, img.device).reshape(w, h, 2).transpose(
        0, 1).reshape(h * w, 2)
    pos = torch.where(is_portrait.to(img.device)[:, None, None],
                      pos_port[None], pos_land[None])
    return tokens.contiguous(), pos


def load_dinov2_state_dict(state_dict: Dict, cfg: DinoEncoderConfig
                           ) -> Dict[str, torch.Tensor]:
    """Float32 state dict of ``DinoEncoder(cfg)`` from a torch hub DINOv2
    ViT state dict (``dinov2_vitl14`` layout: ``blocks.{i}.attn.qkv``,
    ``blocks.{i}.ls1.gamma``, ``patch_embed.proj``, ``cls_token``,
    ``pos_embed``, ``norm``); values are tensors or anything
    ``numpy.asarray`` takes.  The layouts are torch's on both sides, so
    only the names move and the LayerScale gammas stack on a depth axis."""
    def t(name):
        v = state_dict[name]
        return torch.as_tensor(np.asarray(v.detach().cpu() if torch.is_tensor(v)
                                          else v)).to(torch.float32)

    out = {"patch_embed.weight": t("patch_embed.proj.weight"),
           "patch_embed.bias": t("patch_embed.proj.bias"),
           "cls_token": t("cls_token"), "pos_embed": t("pos_embed"),
           "norm.weight": t("norm.weight"), "norm.bias": t("norm.bias")}
    for i in range(cfg.depth):
        for name in ("norm1", "attn.qkv", "attn.proj", "norm2", "mlp.fc1",
                     "mlp.fc2"):
            for leaf in ("weight", "bias"):
                out[f"blocks.{i}.{name}.{leaf}"] = t(f"blocks.{i}.{name}.{leaf}")
    for k in ("ls1", "ls2"):
        out[k] = torch.stack([t(f"blocks.{i}.{k}.gamma")
                              for i in range(cfg.depth)])
    return out
