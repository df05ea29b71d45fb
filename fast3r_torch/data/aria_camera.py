"""Aria Fisheye624 camera model + fisheye->pinhole rectification.

Counterpart of ``fast3r_tpu/data/aria_camera.py``, numpy only: the remaps
go through ``data/imgproc.remap`` and the vignette image is read with PIL,
in the BGR order of the JAX package's bare ``cv2.imread``.

Behavioral reference: fast3r/dust3r/datasets/aria/camera_utils.py —
FisheyeRadTanThinPrism ("Fisheye624") projection (radial theta-series with 6
k-terms + tangential p0/p1 + thin-prism s0..s3, :134-247), iterative
unprojection (:249-415), pinhole project/unproject, and
undistort_fisheye_to_pinhole_rgbd (:13-83): build the pinhole pixel grid,
unproject to rays, project through the fisheye model, remap color +
z-converted depth.

Host-side numpy implementation (this runs in data-loader workers).  The
unprojection inverts the model in two stages — a fixed-point solve for the
tangential/thin-prism terms (they are tiny for the ASE camera) and a scalar
Newton solve for the radial theta-series — instead of the reference's joint
2x2 Newton; the round-trip error is verified < 1e-3 px in tests.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# ASE camera constants (reference ase_multiview.py:28-70); 15-param layout
# [f, cu, cv, k0..k5, p0, p1, s0..s3]
FISHEYE_CAM_PARAMS = np.array(
    [297.638, 357.66, 349.192,
     0.365089, -0.173808, -0.753495, 2.43479, -2.57786, 0.878848,
     0.00080052, -0.000294238, 0, 0, 0, 0], np.float32)

PINHOLE_CAM_PARAMS = np.array([297.638, 297.638, 357.66, 349.192], np.float32)

ASE_INTRINSICS = np.array(
    [[297.638, 0, 357.66], [0, 297.638, 349.192], [0, 0, 1]], np.float32)

T_DEVICE_FROM_CAMERA = np.array(
    [[0.99606003, -0.04388682, 0.07706079, -0.0075301],
     [0.08210934, 0.78468796, -0.61442889, -0.01090855],
     [-0.03350334, 0.61833547, 0.78519983, -0.00359806],
     [0.0, 0.0, 0.0, 1.0]], np.float32)


def _split_params(params: np.ndarray):
    params = np.asarray(params, np.float64).reshape(-1)
    if params.shape[0] == 15:
        f = np.array([params[0], params[0]])
        c = params[1:3]
    else:
        f = params[0:2]
        c = params[2:4]
    k = params[-12:-6]
    p = params[-6:-4]
    s = params[-4:]
    return f, c, k, p, s


def _distort(xr_yr: np.ndarray, p, s) -> np.ndarray:
    """Tangential + thin-prism terms added to the radially-corrected point."""
    xr, yr = xr_yr[..., 0], xr_yr[..., 1]
    rd_sq = xr * xr + yr * yr
    du = (2 * xr * xr + rd_sq) * p[0] + 2 * xr * yr * p[1] \
        + s[0] * rd_sq + s[1] * rd_sq ** 2
    dv = (2 * yr * yr + rd_sq) * p[1] + 2 * xr * yr * p[0] \
        + s[2] * rd_sq + s[3] * rd_sq ** 2
    return np.stack([du, dv], axis=-1)


def fisheye624_project(xyz: np.ndarray, params: np.ndarray) -> np.ndarray:
    """Project (N, 3) points -> (N, 2) pixels (reference camera_utils.py:134)."""
    f, c, k, p, s = _split_params(params)
    eps = 1e-9
    xyz = np.asarray(xyz, np.float64)
    z = xyz[..., 2:3]
    z = np.where(np.abs(z) < eps, eps * np.where(z < 0, -1.0, 1.0), z)
    ab = xyz[..., :2] / z
    ab = np.where(np.abs(ab) < eps, eps * np.where(ab < 0, -1.0, 1.0), ab)
    r = np.linalg.norm(ab, axis=-1, keepdims=True)
    th = np.arctan(r)
    th_divr = np.where(r < eps, np.ones_like(ab), ab / r)
    th_k = th.copy()
    for i in range(6):
        th_k = th_k + k[i] * th ** (3 + i * 2)
    xr_yr = th_k * th_divr
    uv_dist = xr_yr + _distort(xr_yr, p, s)
    return (uv_dist * f + c).astype(np.float64)


def fisheye624_unproject(uv: np.ndarray, params: np.ndarray,
                         fp_iters: int = 10, newton_iters: int = 10
                         ) -> np.ndarray:
    """Invert the model: (N, 2) pixels -> (N, 3) unit-z rays."""
    f, c, k, p, s = _split_params(params)
    uv_dist = (np.asarray(uv, np.float64) - c) / f

    # fixed point for the (tiny) tangential/thin-prism terms
    xr_yr = uv_dist.copy()
    for _ in range(fp_iters):
        xr_yr = uv_dist - _distort(xr_yr, p, s)

    # scalar Newton for the radial theta series: th + sum k_i th^(3+2i) = rd
    rd = np.linalg.norm(xr_yr, axis=-1)
    th = np.minimum(rd, 1.4)
    for _ in range(newton_iters):
        fval = th - rd
        fprime = np.ones_like(th)
        for i in range(6):
            fval = fval + k[i] * th ** (3 + 2 * i)
            fprime = fprime + (3 + 2 * i) * k[i] * th ** (2 + 2 * i)
        th = th - fval / np.maximum(fprime, 1e-6)
        th = np.clip(th, 0.0, np.pi / 2 - 1e-6)

    r = np.tan(th)
    scale = np.where(rd > 1e-9, r / np.maximum(rd, 1e-9), 1.0)
    ab = xr_yr * scale[..., None]
    return np.concatenate([ab, np.ones_like(ab[..., :1])], axis=-1)


def pinhole_unproject(uv: np.ndarray, params: np.ndarray) -> np.ndarray:
    fx, fy, cx, cy = np.asarray(params, np.float64).reshape(-1)
    a = (uv[..., 0] - cx) / fx
    b = (uv[..., 1] - cy) / fy
    return np.stack([a, b, np.ones_like(a)], axis=-1)


def pinhole_project(xyz: np.ndarray, params: np.ndarray) -> np.ndarray:
    fx, fy, cx, cy = np.asarray(params, np.float64).reshape(-1)
    u = xyz[..., 0] / xyz[..., 2] * fx + cx
    v = xyz[..., 1] / xyz[..., 2] * fy + cy
    return np.stack([u, v], axis=-1)


def undistort_fisheye_to_pinhole_rgbd(
    fisheye_img: np.ndarray,
    fisheye_depth: np.ndarray,
    fisheye_params: np.ndarray = FISHEYE_CAM_PARAMS,
    pinhole_params: np.ndarray = PINHOLE_CAM_PARAMS,
) -> Tuple[np.ndarray, np.ndarray]:
    """Rectify a fisheye RGB-D capture to the pinhole model
    (reference camera_utils.py:13-83)."""
    from fast3r_torch.data.imgproc import remap

    h, w = fisheye_img.shape[:2]
    u, v = np.meshgrid(np.arange(w, dtype=np.float64),
                       np.arange(h, dtype=np.float64))
    uv_grid = np.stack([u.reshape(-1), v.reshape(-1)], axis=-1)

    rays = pinhole_unproject(uv_grid, pinhole_params)
    fisheye_uv = fisheye624_project(rays, fisheye_params).reshape(h, w, 2)
    map_x = fisheye_uv[..., 0].astype(np.float32)
    map_y = fisheye_uv[..., 1].astype(np.float32)

    # z-depth conversion on the FISHEYE grid: the stored range along each
    # fisheye ray projected onto the camera Z axis
    fisheye_rays = fisheye624_unproject(uv_grid, fisheye_params)
    rays_norm = fisheye_rays / np.linalg.norm(fisheye_rays, axis=-1,
                                              keepdims=True)
    z_depth = (rays_norm[..., 2] * fisheye_depth.reshape(-1).astype(np.float64))
    z_depth = z_depth.reshape(h, w).astype(np.float32)

    pinhole_image = remap(fisheye_img, map_x, map_y, linear=True)
    pinhole_depth = remap(z_depth, map_x, map_y, linear=False)
    return pinhole_image, pinhole_depth


class VignetteCorrector:
    """Vignette correction (reference camera_utils.py:85-121).

    The reference bundles an IMX577 calibration image next to its module; we
    probe the same filename here (drop `vignette_imx577.png` beside this
    file) and fall back to identity correction when absent.  The image is
    kept in BGR order, as the JAX package's ``cv2.imread`` returns it."""

    DEFAULT_NAME = "vignette_imx577.png"

    def __init__(self, vignette_file: Optional[str] = None):
        if vignette_file is None:
            import os.path as osp

            candidate = osp.join(osp.dirname(__file__), self.DEFAULT_NAME)
            if osp.exists(candidate):
                vignette_file = candidate
        self.vignette = None
        if vignette_file is not None:
            from fast3r_torch.data.io import imread_cv2

            try:
                v = imread_cv2(vignette_file)[..., ::-1]  # RGB -> BGR
            except IOError:  # cv2.imread's None: no correction
                v = None
            if v is not None:
                self.vignette = v.astype(np.float32) / 255.0

    def correct(self, rgb_image: np.ndarray) -> np.ndarray:
        if self.vignette is None:
            return rgb_image.astype(np.float32)
        out = rgb_image.astype(np.float32) / np.clip(self.vignette, 1e-3, None)
        out = np.clip(out, 0.0, 255.0)
        return (out * (self.vignette != 0.0)).astype(np.float32)
