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
    float16 widened to float32;
  * PFM files (any flag; BlendedMVS's rendered depths) through
    :func:`read_pfm`: float32 as cv2's ``IMREAD_UNCHANGED`` read gives it
    (one channel for ``Pf``, three in RGB order for ``PF``).
"""

from __future__ import annotations

import numpy as np
import PIL.Image
from PIL.ImageOps import exif_transpose

IMREAD_UNCHANGED = -1
IMREAD_COLOR = 1


def imread_cv2(path: str, options: int = IMREAD_COLOR) -> np.ndarray:
    """Open an image or depthmap; RGB order for colour images."""
    if str(path).lower().endswith(".pfm"):
        return read_pfm(str(path))
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


def read_pfm(path: str) -> np.ndarray:
    """A Portable Float Map: header ``Pf`` (one channel) or ``PF`` (three),
    ``width height``, then a scale whose sign gives the byte order
    (negative: little-endian), then float32 rows stored bottom-up.  Returns
    (H, W) or (H, W, 3) float32, top row first."""
    with open(path, "rb") as f:
        tokens = []
        while len(tokens) < 4:
            line = f.readline()
            if not line:
                raise IOError(f"{path}: truncated PFM header")
            tokens += line.split()
        kind, w, h, scale = (tokens[0], int(tokens[1]), int(tokens[2]),
                             float(tokens[3]))
        if kind not in (b"Pf", b"PF"):
            raise IOError(f"{path}: not a PFM file ({kind!r})")
        c = 1 if kind == b"Pf" else 3
        data = np.frombuffer(f.read(4 * w * h * c),
                             "<f4" if scale < 0 else ">f4")
    if data.size != w * h * c:
        raise IOError(f"{path}: {data.size} samples for {w}x{h}x{c}")
    img = data.reshape((h, w, c) if c == 3 else (h, w))[::-1]
    return np.ascontiguousarray(img, np.float32)
