"""DPT pixelwise regression head (pointmap + confidence).

Counterpart of ``fast3r_tpu/models/dpt_head.py``.  Pipeline (token grids at
patch stride 16, image H x W): hook tokens -> 1x1 conv to layer_dims[i] ->
resample {x4, x2, x1, x0.5} -> 3x3 conv (no bias) to feature_dim ->
refinenet cascade (residual conv units + 2x align-corners bilinear upsample
+ 1x1 out conv) -> regression trunk (3x3 conv, resize to H x W, 3x3 conv,
ReLU, 1x1 conv to 4 channels) -> postprocess.

The convs are cuDNN calls on NCHW tensors.  On CUDA the regression trunk
takes the JAX head's road for the view's shape (``fast3r_tpu``
``dpt_head.py:189-211``, decided by :func:`head_road`): the port's fused
kernel chain (``ops.trunk_kernel``) followed by the channel-major
postprocess where the reference's fused trunk takes the shape, else the
unfused composition (conv1 -> ``resize_bilinear_align_corners``, which
launches the resize kernel K12 at trunk scale -> conv2 -> ReLU -> conv3)
followed by the channel-last postprocess.  float32 on CUDA keeps the fused
chain at every shape: the reference's road refuses float32, and the
chain's fp32 variant is the port's own.  On the CPU the trunk is the plain
composition.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fast3r_torch.nn.layers import conv2d, conv_transpose2d
from fast3r_torch.ops.postprocess import postprocess, postprocess_transposed
from fast3r_torch.ops.resize import (
    resize_bilinear_align_corners,
    upsample2x_align_corners,
)
from fast3r_torch.ops.resize_kernel import resize_kernel_supported
from fast3r_torch.ops.trunk_kernel import (
    _plain_head,
    fused_regression_head_t,
    reference_trunk_road,
)


@dataclasses.dataclass(frozen=True)
class DPTHeadConfig:
    patch_size: int = 16
    num_channels: int = 4  # 3 (xyz) + 1 (conf)
    feature_dim: int = 256
    last_dim: int = 128
    layer_dims: Tuple[int, int, int, int] = (96, 192, 384, 768)
    dim_tokens: Tuple[int, int, int, int] = (1024, 1024, 1024, 1024)
    depth_mode: Tuple = ("exp", -float("inf"), float("inf"))
    conf_mode: Tuple = ("exp", 1.0, float("inf"))


def _conv(cin: int, cout: int, k: int, bias: bool = True) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, bias=bias)


class ResidualConvUnit(nn.Module):
    def __init__(self, fd: int):
        super().__init__()
        self.conv1 = _conv(fd, fd, 3)
        self.conv2 = _conv(fd, fd, 3)


class FusionBlock(nn.Module):
    def __init__(self, fd: int):
        super().__init__()
        self.rcu1 = ResidualConvUnit(fd)
        self.rcu2 = ResidualConvUnit(fd)
        self.out_conv = _conv(fd, fd, 1)


class DPTHead(nn.Module):
    """Params named as the JAX dict: act1..act4, layer_rn.{i},
    refinenet.{i} (index 0 = refinenet1), head.{conv1, conv2, conv3}."""

    def __init__(self, cfg: DPTHeadConfig):
        super().__init__()
        ld, fd, dt = cfg.layer_dims, cfg.feature_dim, cfg.dim_tokens
        self.act1 = nn.ModuleDict({
            "proj": _conv(dt[0], ld[0], 1),
            "up": nn.ConvTranspose2d(ld[0], ld[0], 4, stride=4)})
        self.act2 = nn.ModuleDict({
            "proj": _conv(dt[1], ld[1], 1),
            "up": nn.ConvTranspose2d(ld[1], ld[1], 2, stride=2)})
        self.act3 = nn.ModuleDict({"proj": _conv(dt[2], ld[2], 1)})
        self.act4 = nn.ModuleDict({
            "proj": _conv(dt[3], ld[3], 1),
            "down": _conv(ld[3], ld[3], 3)})
        self.layer_rn = nn.ModuleList(
            _conv(ld[i], fd, 3, bias=False) for i in range(4))
        self.refinenet = nn.ModuleList(FusionBlock(fd) for _ in range(4))
        self.head = nn.ModuleDict({
            "conv1": _conv(fd, fd // 2, 3),
            "conv2": _conv(fd // 2, cfg.last_dim, 3),
            "conv3": _conv(cfg.last_dim, cfg.num_channels, 1)})


def _residual_conv_unit(p: ResidualConvUnit, x: torch.Tensor) -> torch.Tensor:
    out = conv2d(p.conv1, F.relu(x), padding=1)
    out = conv2d(p.conv2, F.relu(out), padding=1)
    return out + x


def _fusion_block(p: FusionBlock, x: torch.Tensor, skip=None) -> torch.Tensor:
    if skip is not None:
        x = x + _residual_conv_unit(p.rcu1, skip)
    x = _residual_conv_unit(p.rcu2, x)
    x = upsample2x_align_corners(x)
    return conv2d(p.out_conv, x)


def head_road(x_shape, out_hw: Tuple[int, int], c1: int, c2: int, c3: int,
              dtype) -> str:
    """The trunk road of a CUDA head whose path1 has NCHW shape
    (B, Cin, H/2, W/2), for conv widths c1, c2, c3: "trunk" (the fused
    kernel chain), "resize_kernel" (unfused, K12 resize) or "resize_matmul"
    (unfused, matmul resize)."""
    b, cin, hh, wc = x_shape
    H, W = out_hw
    if dtype != torch.bfloat16 or (
            c1 == c2 and reference_trunk_road((b, hh, wc, cin), H, W, c1, c3)):
        return "trunk"
    if resize_kernel_supported((b, c1, hh, wc), H, W, dtype):
        return "resize_kernel"
    return "resize_matmul"


def dpt_head_forward(params: DPTHead, cfg: DPTHeadConfig,
                     hook_tokens: Sequence[torch.Tensor],
                     image_hw: Tuple[int, int]) -> Dict[str, torch.Tensor]:
    """Run the DPT head on the 4 hooked token sets (B, P, dim_tokens[i]) in
    patch raster order; returns {"pts3d": (B, H, W, 3), "conf": (B, H, W)}."""
    H, W = image_hw
    nh, nw = H // cfg.patch_size, W // cfg.patch_size
    grids = [t.reshape(t.shape[0], nh, nw, t.shape[-1]).permute(0, 3, 1, 2)
             for t in hook_tokens]

    l1 = conv_transpose2d(params.act1["up"],
                          conv2d(params.act1["proj"], grids[0]), stride=4)
    l2 = conv_transpose2d(params.act2["up"],
                          conv2d(params.act2["proj"], grids[1]), stride=2)
    l3 = conv2d(params.act3["proj"], grids[2])
    l4 = conv2d(params.act4["down"], conv2d(params.act4["proj"], grids[3]),
                stride=2, padding=1)
    layers = [conv2d(params.layer_rn[i], l, padding=1)
              for i, l in enumerate((l1, l2, l3, l4))]

    rn = params.refinenet
    path4 = _fusion_block(rn[3], layers[3])
    # crop the x2 upsample of the ceil'ed half grid back to layer 3's size
    path4 = path4[:, :, :layers[2].shape[2], :layers[2].shape[3]]
    path3 = _fusion_block(rn[2], path4, layers[2])
    path2 = _fusion_block(rn[1], path3, layers[1])
    path1 = _fusion_block(rn[0], path2, layers[0])  # (B, fd, H/2, W/2)

    hp = params.head
    trunk = (hp["conv1"].weight, hp["conv1"].bias, hp["conv2"].weight,
             hp["conv2"].bias, hp["conv3"].weight, hp["conv3"].bias, H, W)
    if path1.device.type == "cpu":
        x = _plain_head(path1, *trunk)  # (B, c3, H, W)
        return postprocess(x.permute(0, 2, 3, 1), cfg.depth_mode,
                           cfg.conf_mode)
    c1, c2, c3 = (hp[k].weight.shape[0] for k in ("conv1", "conv2", "conv3"))
    if head_road(path1.shape, (H, W), c1, c2, c3, path1.dtype) == "trunk":
        xt = fused_regression_head_t(path1.permute(0, 2, 3, 1).contiguous(),
                                     *trunk)
        return postprocess_transposed(xt, cfg.depth_mode, cfg.conf_mode, H, W)
    x = resize_bilinear_align_corners(conv2d(hp["conv1"], path1, padding=1),
                                      H, W)
    x = conv2d(hp["conv3"], F.relu(conv2d(hp["conv2"], x, padding=1)))
    return postprocess(x.permute(0, 2, 3, 1), cfg.depth_mode, cfg.conf_mode)
