"""Device image preprocessing: raw uint8 frames -> normalised model input.

Counterpart of ``fast3r_tpu/ops/preprocess.py`` (``PreprocessPlan``,
``make_plan``, ``preprocess_device``).  The host keeps the file decode and
the EXIF transpose (``utils/image.load_images_raw``); the resize, the centre
crop and the [-1, 1] normalisation run on the device, from the same static
geometry as ``utils/image.load_images``:

  * size == 224: resize the SHORT side to 224, then a centre square crop;
  * otherwise: resize the LONG side to ``size``, centre-crop each side to a
    multiple of 16; square results crop to 4:3 unless ``square_ok``.

The resample is the JAX package's ``jax.image.resize(..., antialias=True)``:
Lanczos-3 when downscaling, Keys cubic with a = -0.5 when upscaling (not
torch's bicubic a = -0.75, and not ``F.interpolate(antialias=True)``'s
filter), built here in numpy as one (out, in) weight matrix per axis and
applied as two products, then rounded and clipped to [0, 255] as PIL
quantises its output.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PreprocessPlan:
    """Static geometry of the preprocessing for one source shape."""

    src_hw: Tuple[int, int]               # raw (H, W) after EXIF / rotation
    pre_crop: Tuple[int, int, int, int]   # (top, left, h, w) before resize
    resized_hw: Tuple[int, int]           # after the long-edge resize
    crop: Tuple[int, int, int, int]       # (top, left, h, w) centre crop
    upscale: bool                         # Keys cubic (True) or Lanczos-3

    @property
    def out_hw(self) -> Tuple[int, int]:
        return self.crop[2], self.crop[3]


def make_plan(src_hw: Tuple[int, int], size: int, square_ok: bool = False,
              crop_to_landscape: bool = False) -> PreprocessPlan:
    """The resize / crop geometry of ``load_images`` for one raw (H, W)."""
    H0, W0 = src_hw
    top = left = 0
    H1, W1 = H0, W0
    if crop_to_landscape:
        desired = 4 / 3
        if W0 / H0 > desired:
            w = int(H0 * desired)
            left, top, H1, W1 = (W0 - w) // 2, 0, H0, w
        else:
            h = int(W0 / desired)
            left, top, H1, W1 = 0, (H0 - h) // 2, h, W0
    pre_crop = (top, left, H1, W1)

    # Python's round() (banker's), as PIL's size arithmetic in load_images
    long_edge = (int(round(size * max(W1 / H1, H1 / W1))) if size == 224
                 else size)
    S = max(W1, H1)
    W2 = int(round(W1 * long_edge / S))
    H2 = int(round(H1 * long_edge / S))

    cx, cy = W2 // 2, H2 // 2
    if size == 224:
        half = min(cx, cy)
        crop = (cy - half, cx - half, 2 * half, 2 * half)
    else:
        halfw, halfh = ((2 * cx) // 16) * 8, ((2 * cy) // 16) * 8
        if not square_ok and W2 == H2:
            halfh = 3 * halfw // 4
        crop = (cy - halfh, cx - halfw, 2 * halfh, 2 * halfw)
    return PreprocessPlan(src_hw=(H0, W0), pre_crop=pre_crop,
                          resized_hw=(H2, W2), crop=crop,
                          upscale=S <= long_edge)


def _lanczos3(x: np.ndarray) -> np.ndarray:
    with np.errstate(divide="ignore", invalid="ignore"):
        y = 3.0 * np.sin(np.pi * x) * np.sin(np.pi * x / 3.0) / (np.pi * x) ** 2
    return np.where(x > 3.0, 0.0, np.where(x > 1e-3, y, 1.0))


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel with a = -0.5."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


@functools.lru_cache(maxsize=64)
def resize_weights(out_size: int, in_size: int, upscale: bool) -> np.ndarray:
    """(out, in) float32 matrix of ``jax.image.resize`` along one axis
    (half-pixel centres, antialias): the kernel widened by 1 / scale when
    downscaling, each row normalised over the input, rows whose sample
    falls outside the input zeroed."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(out_size, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[:, None] - np.arange(in_size, dtype=np.float64)[None])
    w = (_keys_cubic if upscale else _lanczos3)(x / kernel_scale)
    total = w.sum(axis=1, keepdims=True)
    ok = np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps)
    w = np.where(ok, w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[:, None], w, 0.0).astype(np.float32)


def preprocess_device(imgs_u8: torch.Tensor, plan: PreprocessPlan,
                      dtype=torch.float32) -> torch.Tensor:
    """(V, H0, W0, 3) uint8 -> (V, h, w, 3) in [-1, 1], on imgs_u8's
    device: pre-crop, separable resize (two fp32 products), round and clip
    to [0, 255], centre crop, normalise."""
    if tuple(imgs_u8.shape[1:]) != (*plan.src_hw, 3):
        raise ValueError(f"frames {tuple(imgs_u8.shape)} do not match the "
                         f"plan's source shape {plan.src_hw}")
    t, l, h, w = plan.pre_crop
    x = imgs_u8[:, t:t + h, l:l + w].float()
    H2, W2 = plan.resized_hw
    mh, mw = (torch.from_numpy(resize_weights(o, i, plan.upscale)).to(x.device)
              for o, i in ((H2, h), (W2, w)))
    x = torch.einsum("Oh,vhwc->vOwc", mh, x)
    x = torch.einsum("Pw,vOwc->vOPc", mw, x)
    x = x.round().clamp(0.0, 255.0)
    t, l, h, w = plan.crop
    x = x[:, t:t + h, l:l + w]
    return ((x / 255.0 - 0.5) / 0.5).to(dtype)
