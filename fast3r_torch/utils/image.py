"""Image loading and host preprocessing for inference.

Counterpart of ``fast3r_tpu/utils/image.py`` (``load_images``,
``load_images_raw``, ``img_norm``, ``unnormalize_rgb``), the port's own copy:
folder or list of paths -> view dicts with a normalised image in [-1, 1],
``true_shape``, idx and instance.  PIL decodes, applies the EXIF
orientation and resizes; the rules are the reference's:

  * size == 224: resize the SHORT side to 224 (long-edge resize by the
    aspect ratio), then a centre square crop;
  * otherwise: resize the LONG side to ``size``, centre-crop each side to a
    multiple of 16; a square result is cropped to 4:3 unless ``square_ok``.

Images are channel-last (1, H, W, 3) float32 numpy arrays, as in the JAX
package; ``inference`` takes them as they are.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Union

import numpy as np
import PIL.Image
from PIL.ImageOps import exif_transpose

try:  # optional, as in the reference
    from pillow_heif import register_heif_opener

    register_heif_opener()
    HEIF_SUPPORT = True
except ImportError:
    HEIF_SUPPORT = False

EXTENSIONS = (".jpg", ".jpeg", ".png") + ((".heic", ".heif") if HEIF_SUPPORT
                                          else ())


def img_norm(img: PIL.Image.Image) -> np.ndarray:
    """ToTensor + Normalize(0.5, 0.5): uint8 -> float32 in [-1, 1], (H, W, 3)."""
    return (np.asarray(img).astype(np.float32) / 255.0 - 0.5) / 0.5


def unnormalize_rgb(img: np.ndarray) -> np.ndarray:
    """Inverse of img_norm, clipped to [0, 1]."""
    return np.clip(img * 0.5 + 0.5, 0.0, 1.0)


def _resize_pil_image(img: PIL.Image.Image,
                      long_edge_size: int) -> PIL.Image.Image:
    S = max(img.size)
    interp = PIL.Image.LANCZOS if S > long_edge_size else PIL.Image.BICUBIC
    new_size = tuple(int(round(x * long_edge_size / S)) for x in img.size)
    return img.resize(new_size, interp)


def _listing(folder_or_list):
    """(root, entries): a folder's sorted names, or the list as given."""
    if isinstance(folder_or_list, str):
        return folder_or_list, sorted(os.listdir(folder_or_list))
    if isinstance(folder_or_list, (list, tuple)):
        return "", list(folder_or_list)
    raise ValueError(f"bad folder_or_list={folder_or_list!r}")


def _open(root: str, path) -> PIL.Image.Image:
    return exif_transpose(PIL.Image.open(os.path.join(root, path))
                          ).convert("RGB")


def load_images_raw(folder_or_list: Union[str, Sequence],
                    verbose: bool = True,
                    rotate_clockwise_90: bool = False) -> List[np.ndarray]:
    """Decode and EXIF-transpose only -> uint8 (H, W, 3) frames; resize,
    crop and normalisation run on the device (``ops/preprocess.py``,
    ``inference.inference_from_raw``)."""
    root, entries = _listing(folder_or_list)
    frames = []
    for path in entries:
        if isinstance(path, PIL.Image.Image):
            img = path.convert("RGB")
        elif str(path).lower().endswith(EXTENSIONS):
            img = _open(root, path)
        else:
            continue
        if rotate_clockwise_90:
            img = img.rotate(-90, expand=True)
        frames.append(np.asarray(img, np.uint8))
    if not frames:
        raise FileNotFoundError(f"no images found at {root}")
    if verbose:
        print(f" (Decoded {len(frames)} raw frames)")
    return frames


def load_images(folder_or_list: Union[str, Sequence], size: int,
                square_ok: bool = False, verbose: bool = True,
                rotate_clockwise_90: bool = False,
                crop_to_landscape: bool = False) -> List[Dict]:
    """Open and preprocess images into the Fast3R input format."""
    root, entries = _listing(folder_or_list)
    if verbose:
        print(f">> Loading images from {folder_or_list}" if root
              else f">> Loading a list of {len(entries)} images")
    imgs = []
    for path in entries:
        if isinstance(path, PIL.Image.Image):
            img = path
        elif str(path).lower().endswith(EXTENSIONS):
            img = _open(root, path)
        else:
            continue
        if rotate_clockwise_90:
            img = img.rotate(-90, expand=True)
        if crop_to_landscape:
            desired = 4 / 3
            width, height = img.size
            if width / height > desired:
                new_w = int(height * desired)
                left = (width - new_w) // 2
                box = (left, 0, left + new_w, height)
            else:
                new_h = int(width / desired)
                top = (height - new_h) // 2
                box = (0, top, width, top + new_h)
            img = img.crop(box)

        W1, H1 = img.size
        if size == 224:  # resize the short side to 224
            img = _resize_pil_image(img, round(size * max(W1 / H1, H1 / W1)))
        else:
            img = _resize_pil_image(img, size)
        W, H = img.size
        cx, cy = W // 2, H // 2
        if size == 224:
            half = min(cx, cy)
            img = img.crop((cx - half, cy - half, cx + half, cy + half))
        else:
            halfw, halfh = ((2 * cx) // 16) * 8, ((2 * cy) // 16) * 8
            if not square_ok and W == H:
                halfh = 3 * halfw / 4
            img = img.crop((cx - halfw, cy - halfh, cx + halfw, cy + halfh))

        W2, H2 = img.size
        if verbose:
            print(f" - adding {path} with resolution {W1}x{H1} --> {W2}x{H2}")
        imgs.append(dict(img=img_norm(img)[None],               # (1, H, W, 3)
                         true_shape=np.int32([img.size[::-1]]),  # (1, 2)
                         idx=len(imgs), instance=str(len(imgs))))
    if not imgs:
        raise FileNotFoundError(f"no images found at {root}")
    if verbose:
        print(f" (Found {len(imgs)} images)")
    return imgs
