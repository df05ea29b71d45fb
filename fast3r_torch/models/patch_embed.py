"""Patch embedding, including mixed landscape / portrait batches.

Counterpart of ``fast3r_tpu/models/patch_embed.py``.  Images are stored in
landscape layout (W >= H); a portrait image arrives pre-transposed and its
``true_shape`` (h, w) records the real orientation.  For a portrait sample
the projection runs on the un-transposed pixels and the tokens follow a
(W_tok, H_tok) raster with positions from that grid.  As in the JAX package
this uses ``conv(img^T, K) == conv(img, K^T)^T``: one extra conv with the
spatially transposed kernel and a per-sample select.

Inputs and outputs keep the JAX layout: images (B, H, W, 3), tokens
(B, P, D), positions (B, P, 2) as (y, x).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from fast3r_torch.nn.layers import conv2d


def position_grid(h: int, w: int, device=None) -> torch.Tensor:
    """(h*w, 2) cartesian product of (arange(h), arange(w)), y-major."""
    yy, xx = torch.meshgrid(torch.arange(h, device=device),
                            torch.arange(w, device=device), indexing="ij")
    return torch.stack([yy.reshape(-1), xx.reshape(-1)], dim=-1).to(torch.int32)


def _check(img: torch.Tensor, patch_size: int) -> None:
    B, H, W, _ = img.shape
    if H % patch_size or W % patch_size:
        raise ValueError(f"image {H}x{W} is not a multiple of the patch "
                         f"size {patch_size}")


def patch_embed_simple(p: nn.Conv2d, img: torch.Tensor, patch_size: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain conv patchify: (B, H, W, 3) -> tokens (B, h*w, D), positions."""
    _check(img, patch_size)
    B = img.shape[0]
    x = conv2d(p, img.permute(0, 3, 1, 2), stride=patch_size)  # (B, D, h, w)
    _, D, h, w = x.shape
    tokens = x.flatten(2).transpose(1, 2).contiguous()
    pos = position_grid(h, w, img.device)[None].expand(B, h * w, 2)
    return tokens, pos


def patch_embed_manyar(p: nn.Conv2d, img: torch.Tensor,
                       true_shape: torch.Tensor, patch_size: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ManyAR patch embed: img (B, H, W, 3) in landscape storage layout,
    true_shape (B, 2) int (height, width) per sample."""
    B, H, W, _ = img.shape
    if W < H:
        raise ValueError(f"img must be in landscape storage layout, got "
                         f"H={H} W={W}")
    _check(img, patch_size)
    h, w = H // patch_size, W // patch_size
    n_tokens = h * w
    is_portrait = (true_shape[:, 1] < true_shape[:, 0]).to(img.device)

    x = img.permute(0, 3, 1, 2)
    land = conv2d(p, x, stride=patch_size)  # (B, D, h, w)
    land_tokens = land.flatten(2).transpose(1, 2)
    port = conv2d(p, x, stride=patch_size, transpose_kernel_spatial=True)
    port_tokens = port.transpose(2, 3).flatten(2).transpose(1, 2)  # raster (w, h)

    sel = is_portrait[:, None, None]
    tokens = torch.where(sel, port_tokens, land_tokens).contiguous()
    pos_land = position_grid(h, w, img.device)[None].expand(B, n_tokens, 2)
    pos_port = position_grid(w, h, img.device)[None].expand(B, n_tokens, 2)
    pos = torch.where(sel, pos_port, pos_land)
    return tokens, pos
