"""The OpenCV image operations of the eval loaders, in numpy and scipy.

The JAX package's loaders call cv2; the card's machine has no cv2, so the
port computes each operation as cv2 (5.0) does:

  * :func:`resize_linear`: ``cv2.resize(img, (w, h))`` (``INTER_LINEAR``)
    of a uint8 image: half-pixel source coordinates clamped at the edges,
    cv2's fixed point (11-bit coefficients, the horizontal pass in exact
    integers, the vertical pass rounded as cv2's SIMD road rounds it).
    cv2 zeroes the fraction of a clamped column but keeps that of a
    clamped row, whose two taps then read the same source row, each
    product rounded on its own.  Every shape equals cv2's bytes.  An
    equal-size resize returns a copy of the input.
  * :func:`erode`: ``cv2.erode(img, np.ones((kh, kw)))``: the minimum over
    the kernel's window anchored at its centre, the border at +inf.
  * :func:`rodrigues`: ``cv2.Rodrigues`` of a rotation vector, float64.
  * :func:`rotate90_cw`: ``cv2.rotate(img, cv2.ROTATE_90_CLOCKWISE)``.
  * :func:`remap`: ``cv2.remap`` of a float32 image with float32 maps,
    ``BORDER_CONSTANT`` 0: linear (cv2 5 takes float maps unquantised and
    lerps along x, then y, each lerp one fused multiply-add) or nearest
    (the maps rounded half to even).

The nearest resize is ``data.cropping.resize_nearest``.
"""

from __future__ import annotations

import numpy as np
import scipy.ndimage

RESIZE_COEF_SCALE = 2048   # INTER_RESIZE_COEF_SCALE: 11-bit coefficients


def _linear_taps(src: int, dst: int, zero_clamped: bool):
    """cv2's INTER_LINEAR source indices and fraction of each output:
    fx = (d + 0.5) * (src / dst) - 0.5 (double, then float), floored, both
    indices clamped to the image; with ``zero_clamped`` (cv2's columns, not
    its rows) the fraction is 0 where the first index is clamped."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    i = np.floor(f).astype(np.int64)
    frac = f - i.astype(np.float32)
    if zero_clamped:
        frac[(i < 0) | (i >= src - 1)] = 0.0
    return np.clip(i, 0, src - 1), np.clip(i + 1, 0, src - 1), frac


def _fixed(frac: np.ndarray):
    """The two coefficients (1 - f, f) in 11-bit fixed point, rounded half
    to even as cv2's saturate_cast<short> does."""
    one = np.float32(1.0)
    return (np.rint((one - frac) * RESIZE_COEF_SCALE).astype(np.int64),
            np.rint(frac * RESIZE_COEF_SCALE).astype(np.int64))


def resize_linear(img: np.ndarray, size) -> np.ndarray:
    """``cv2.resize(img, size)`` with ``INTER_LINEAR``; ``size`` is (width,
    height), ``img`` uint8 (H, W) or (H, W, C)."""
    if img.dtype != np.uint8:
        raise TypeError(f"resize_linear takes uint8, not {img.dtype}")
    out_w, out_h = (int(s) for s in size)
    H, W = img.shape[:2]
    if (out_h, out_w) == (H, W):
        return img.copy()
    x0, x1, fx = _linear_taps(W, out_w, zero_clamped=True)
    y0, y1, fy = _linear_taps(H, out_h, zero_clamped=False)
    a0, a1 = _fixed(fx)
    b0, b1 = _fixed(fy)
    ex = (slice(None),) + (None,) * (img.ndim - 2)
    ey = (slice(None), None) + (None,) * (img.ndim - 2)
    s = img.astype(np.int64)
    h = s[:, x0] * a0[ex] + s[:, x1] * a1[ex]
    v = ((((h[y0] >> 4) * b0[ey]) >> 16)
         + (((h[y1] >> 4) * b1[ey]) >> 16) + 2) >> 2
    return np.clip(v, 0, 255).astype(np.uint8)


def erode(img: np.ndarray, ksize=(10, 10)) -> np.ndarray:
    """``cv2.erode(img, np.ones(ksize, np.uint8))``, one iteration: each
    output the minimum of the (kh, kw) window whose anchor (kh // 2,
    kw // 2) lies on it; pixels outside the image do not count."""
    # scipy centres a window of size k at k // 2, as cv2 anchors it
    return scipy.ndimage.minimum_filter(img, size=tuple(ksize),
                                        mode="constant", cval=np.inf)


def rodrigues(rvec) -> np.ndarray:
    """``cv2.Rodrigues(rvec)[0]``: the 3x3 rotation of an axis-angle
    vector, float64."""
    r = np.asarray(rvec, np.float64).reshape(3)
    theta = float(np.linalg.norm(r))
    if theta < np.finfo(np.float64).eps:
        return np.eye(3)
    k = r / theta
    c, s = np.cos(theta), np.sin(theta)
    kx = np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]],
                   [-k[1], k[0], 0.0]])
    return c * np.eye(3) + (1.0 - c) * np.outer(k, k) + s * kx


def rotate90_cw(img: np.ndarray) -> np.ndarray:
    """``cv2.rotate(img, cv2.ROTATE_90_CLOCKWISE)``."""
    return np.ascontiguousarray(np.rot90(img, k=-1))


def _fma(a, b, c) -> np.ndarray:
    """float32 a * b + c rounded once (the float32 product is exact in
    float64)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def remap(img: np.ndarray, map_x: np.ndarray, map_y: np.ndarray,
          linear: bool = True) -> np.ndarray:
    """``cv2.remap(img, map_x, map_y, INTER_LINEAR or INTER_NEAREST,
    borderMode=BORDER_CONSTANT, borderValue=0)`` for a float32 (H, W) or
    (H, W, C) image and float32 maps of the output's shape."""
    if img.dtype != np.float32:
        raise TypeError(f"remap takes a float32 image, not {img.dtype}")
    H, W = img.shape[:2]
    mx = np.asarray(map_x, np.float32)
    my = np.asarray(map_y, np.float32)

    def tap(y, x):
        ok = (y >= 0) & (y < H) & (x >= 0) & (x < W)
        t = img[np.clip(y, 0, H - 1), np.clip(x, 0, W - 1)]
        t[~ok] = 0
        return t

    if not linear:
        return tap(np.rint(my).astype(np.int64), np.rint(mx).astype(np.int64))
    x0 = np.floor(mx)
    y0 = np.floor(my)
    ex = (Ellipsis,) + (None,) * (img.ndim - 2)
    ax, ay = (mx - x0)[ex], (my - y0)[ex]
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    t00, t01 = tap(y0, x0), tap(y0, x0 + 1)
    t10, t11 = tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)
    top = _fma(t01 - t00, ax, t00)
    bottom = _fma(t11 - t10, ax, t10)
    return _fma(bottom - top, ay, top)
