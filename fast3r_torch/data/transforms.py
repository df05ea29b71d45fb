"""Image transforms for the data loader.

Counterpart of ``fast3r_tpu/data/transforms.py``.  Behavioral reference:
fast3r/dust3r/datasets/utils/transforms.py — ``ImgNorm = ToTensor +
Normalize(0.5, 0.5)`` and ``ColorJitter = torchvision ColorJitter(0.5, 0.5, 0.5, 0.1) + ImgNorm``.
The reference resolves transform config strings with ``eval(transform)``
(base_stereo_view_dataset.py:48-49); here names resolve against the
TRANSFORMS registry instead.

The jitter matches torchvision semantics: per-image factors drawn uniformly
from [max(0, 1-b), 1+b] (brightness/contrast/saturation) and [-h, h] (hue),
applied in a random operation order.  Unlike torchvision (global torch rng),
the factors come from the dataset's per-item rng when available — seeded
datasets therefore produce deterministic jitter.
"""

from __future__ import annotations

import numpy as np
import PIL.Image
import PIL.ImageEnhance

from fast3r_torch.utils.image import img_norm


def _shift_hue(img: PIL.Image.Image, hue_shift: float) -> PIL.Image.Image:
    """Shift hue by ``hue_shift`` in turns (torchvision adjust_hue range
    [-0.5, 0.5])."""
    if abs(hue_shift) < 1e-8:
        return img
    h, s, v = img.convert("HSV").split()
    h_arr = np.asarray(h, dtype=np.int16)
    h_arr = ((h_arr + int(round(hue_shift * 255))) % 256).astype(np.uint8)
    return PIL.Image.merge(
        "HSV", (PIL.Image.fromarray(h_arr, "L"), s, v)).convert("RGB")


class ColorJitter:
    """Random brightness/contrast/saturation/hue jitter, then img_norm."""

    def __init__(self, brightness=0.5, contrast=0.5, saturation=0.5, hue=0.1):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue
        self._rng = np.random.default_rng()

    def set_rng(self, rng: np.random.Generator) -> None:
        """Adopt the dataset's per-item rng (called by BaseViewDataset)."""
        self._rng = rng

    def _factor(self, amount: float) -> float:
        return float(self._rng.uniform(max(0.0, 1 - amount), 1 + amount))

    def __call__(self, img: PIL.Image.Image) -> np.ndarray:
        if not isinstance(img, PIL.Image.Image):
            img = PIL.Image.fromarray(np.asarray(img))
        ops = [
            lambda im: PIL.ImageEnhance.Brightness(im).enhance(
                self._factor(self.brightness)),
            lambda im: PIL.ImageEnhance.Contrast(im).enhance(
                self._factor(self.contrast)),
            lambda im: PIL.ImageEnhance.Color(im).enhance(
                self._factor(self.saturation)),
            lambda im: _shift_hue(
                im, float(self._rng.uniform(-self.hue, self.hue))),
        ]
        for i in self._rng.permutation(4):
            img = ops[int(i)](img)
        return img_norm(img)


TRANSFORMS = {
    "ImgNorm": img_norm,
    "ColorJitter": ColorJitter(),
}


def resolve_transform(t):
    """Resolve a transform spec: callable, or a registered name string."""
    if callable(t):
        return t
    if isinstance(t, str):
        if t not in TRANSFORMS:
            raise KeyError(
                f"unknown transform {t!r}; registered: {sorted(TRANSFORMS)}")
        return TRANSFORMS[t]
    raise TypeError(f"transform must be callable or str, got {type(t)}")
