"""Image/depthmap joint crop-resize with intrinsics bookkeeping.

Counterpart of ``fast3r_tpu/data/cropping.py`` (behavioural reference:
fast3r/dust3r/datasets/utils/cropping.py and the colmap/opencv
principal-point helpers, dust3r/utils/geometry.py:248-273).  Host-side
preprocessing: PIL for images (Lanczos downscale / bicubic upscale), as in
JAX; the depthmap's nearest-neighbour resize is numpy, on the index
``cv2.resize(..., INTER_NEAREST)`` takes (:func:`resize_nearest`), since the
port has no cv2 and PIL's ``NEAREST`` picks other pixels.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import PIL.Image

LANCZOS = PIL.Image.Resampling.LANCZOS
BICUBIC = PIL.Image.Resampling.BICUBIC


def colmap_to_opencv_intrinsics(K: np.ndarray) -> np.ndarray:
    """Colmap puts the top-left pixel center at (0.5, 0.5); OpenCV at (0, 0)."""
    K = K.copy()
    K[0, 2] -= 0.5
    K[1, 2] -= 0.5
    return K


def opencv_to_colmap_intrinsics(K: np.ndarray) -> np.ndarray:
    K = K.copy()
    K[0, 2] += 0.5
    K[1, 2] += 0.5
    return K


def camera_matrix_of_crop(
    input_camera_matrix: np.ndarray,
    input_resolution,
    output_resolution,
    scaling: float = 1.0,
    offset_factor: float = 0.5,
    offset=None,
) -> np.ndarray:
    """Intrinsics after scale + centered crop (reference cropping.py:96-109)."""
    margins = np.asarray(input_resolution) * scaling - np.asarray(output_resolution)
    assert np.all(margins >= 0.0)
    if offset is None:
        offset = offset_factor * margins
    K = opencv_to_colmap_intrinsics(input_camera_matrix)
    K[:2, :] *= scaling
    K[:2, 2] -= offset
    return colmap_to_opencv_intrinsics(K)


def crop_image_depthmap(
    image: PIL.Image.Image,
    depthmap: Optional[np.ndarray],
    camera_intrinsics: np.ndarray,
    crop_bbox: Tuple[int, int, int, int],
):
    """Crop view + shift principal point (reference cropping.py:112-127)."""
    l, t, r, b = crop_bbox
    image = image.crop((l, t, r, b))
    if depthmap is not None:
        depthmap = depthmap[t:b, l:r]
    K = camera_intrinsics.copy()
    K[0, 2] -= l
    K[1, 2] -= t
    return image, depthmap, K


def _nearest_index(src: int, dst: int) -> np.ndarray:
    """cv2's INTER_NEAREST source index of each of ``dst`` outputs:
    min(floor(i * (1 / (dst / src))), src - 1), in float64 as cv2 computes
    it."""
    scale = 1.0 / (dst / src)
    return np.minimum(np.floor(np.arange(dst) * scale).astype(np.int64),
                      src - 1)


def resize_nearest(arr: np.ndarray, size) -> np.ndarray:
    """``cv2.resize(arr, size, interpolation=INTER_NEAREST)``: ``size`` is
    (width, height); ``arr`` is (H, W, ...)."""
    out_w, out_h = (int(s) for s in size)
    rows = _nearest_index(arr.shape[0], out_h)
    cols = _nearest_index(arr.shape[1], out_w)
    return arr[rows[:, None], cols[None, :]]


def rescale_image_depthmap(
    image: PIL.Image.Image,
    depthmap: Optional[np.ndarray],
    camera_intrinsics: np.ndarray,
    output_resolution,
    force: bool = True,
):
    """Jointly rescale so (out_w, out_h) >= output_resolution
    (reference cropping.py:62-93): Lanczos down / bicubic up for the image,
    nearest for the depthmap."""
    if not isinstance(image, PIL.Image.Image):
        image = PIL.Image.fromarray(image)
    input_resolution = np.array(image.size)  # (W, H)
    output_resolution = np.array(output_resolution)
    if depthmap is not None:
        assert tuple(depthmap.shape[:2]) == image.size[::-1]
    scale_final = max(output_resolution / image.size) + 1e-8
    if scale_final >= 1 and not force:
        return image, depthmap, camera_intrinsics
    output_resolution = np.floor(input_resolution * scale_final).astype(int)

    image = image.resize(tuple(output_resolution),
                         resample=LANCZOS if scale_final < 1 else BICUBIC)
    if depthmap is not None:
        depthmap = resize_nearest(depthmap, tuple(output_resolution))
    K = camera_matrix_of_crop(camera_intrinsics, input_resolution,
                              output_resolution, scaling=scale_final)
    return image, depthmap, K


def bbox_from_intrinsics_in_out(
    input_camera_matrix: np.ndarray,
    output_camera_matrix: np.ndarray,
    output_resolution,
) -> Tuple[int, int, int, int]:
    out_width, out_height = output_resolution
    l, t = np.int32(
        np.round(input_camera_matrix[:2, 2] - output_camera_matrix[:2, 2])
    )
    return (l, t, l + out_width, t + out_height)
