"""Image / depth file reads with PIL (reference dust3r/utils/image.py:35-45).

Counterpart of ``fast3r_tpu/data/io.py`` (``imread_cv2``), without cv2, which
the card's machine does not have.  The flags keep cv2's names and values so
the datasets read as their JAX twins:

  * ``IMREAD_COLOR``: 8-bit RGB (H, W, 3), the EXIF orientation applied, as
    cv2's colour read does;
  * ``IMREAD_UNCHANGED``: the stored samples as they are: a 16-bit PNG gives
    uint16 (Pillow opens it as mode ``I;16``, or ``I`` (int32) in older
    versions: both are cast), an 8-bit mask uint8, a colour file RGB;
  * EXR files (any flag) go through the port's own codec, ``data/exr.py``,
    float16 widened to float32.
"""

from __future__ import annotations

import numpy as np
import PIL.Image
from PIL.ImageOps import exif_transpose

IMREAD_UNCHANGED = -1
IMREAD_COLOR = 1


def imread_cv2(path: str, options: int = IMREAD_COLOR) -> np.ndarray:
    """Open an image or depthmap; RGB order for colour images."""
    if str(path).endswith((".exr", "EXR")):
        from fast3r_torch.data.exr import read_exr

        img = np.asarray(read_exr(str(path)))
        if img.dtype == np.float16:
            img = img.astype(np.float32)
        return img
    try:
        im = PIL.Image.open(str(path))
        im.load()
    except (OSError, ValueError) as e:
        raise IOError(f"Could not load image={path} with {options=}") from e
    if options == IMREAD_COLOR:
        return np.asarray(exif_transpose(im).convert("RGB"))
    if im.mode.startswith("I;16") or im.mode == "I":
        return np.asarray(im).astype(np.uint16)
    if im.mode in ("RGBA", "P"):
        im = im.convert("RGB")
    return np.asarray(im)
