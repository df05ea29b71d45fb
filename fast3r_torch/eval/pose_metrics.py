"""Camera pose metrics: all-pairs relative angles, RRA/RTA, mAA.

Counterpart of ``fast3r_tpu/eval/pose_metrics.py`` in numpy, float32 as JAX
computes them (x64 off).  Behavioral reference:
fast3r/eval/cam_pose_metric.py:17-192 (camera_to_rel_deg, calculate_auc,
batched_all_pairs, closed_form_inverse, rotation/translation angle) and
fast3r/utils/so3_utils.py:7-149 (so3_relative_angle with linear acos
extrapolation).  Thresholds {5, 15, 30} and mAA(30) per
multiview_dust3r_module.py:103-111,780.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np

DEFAULT_ACOS_BOUND = 1.0 - 1e-4


def acos_linear_extrapolation(x: np.ndarray,
                              bound: float = DEFAULT_ACOS_BOUND) -> np.ndarray:
    """acos with 1st-order Taylor extrapolation outside (-bound, bound)
    (so3_utils.py:7-60) — numerically safe near +-1."""
    def taylor(x, x0):
        dacos = -1.0 / math.sqrt(1.0 - x0 * x0)
        return (x - np.float32(x0)) * np.float32(dacos) + np.float32(
            math.acos(x0))

    x = np.asarray(x, np.float32)
    inside = np.arccos(np.clip(x, np.float32(-bound), np.float32(bound)))
    res = np.where(x >= np.float32(bound), taylor(x, bound), inside)
    res = np.where(x <= np.float32(-bound), taylor(x, -bound), res)
    return res.astype(np.float32)


def so3_relative_angle(R1: np.ndarray, R2: np.ndarray,
                       eps: float = 1e-4) -> np.ndarray:
    """Angle of R1^T R2 in radians, batched (..., 3, 3)."""
    R12 = np.einsum("...ji,...jk->...ik", R1, R2)
    trace = np.trace(R12, axis1=-2, axis2=-1)
    cos = (trace - np.float32(1.0)) / np.float32(2.0)
    return acos_linear_extrapolation(cos, 1.0 - eps)


def translation_angle_deg(t1: np.ndarray, t2: np.ndarray,
                          eps: float = 1e-15,
                          default_err: float = 1e6) -> np.ndarray:
    """Angle between translation directions in degrees
    (cam_pose_metric.py:168-180)."""
    e = np.float32(eps)
    t1n = t1 / (np.linalg.norm(t1, axis=-1, keepdims=True) + e)
    t2n = t2 / (np.linalg.norm(t2, axis=-1, keepdims=True) + e)
    loss_t = np.clip(np.float32(1.0) - np.sum(t1n * t2n, axis=-1) ** 2, e,
                     None)
    err = (np.arccos(np.sqrt(np.float32(1.0) - loss_t)) * np.float32(180.0)
           / np.float32(np.pi))
    return np.where(np.isfinite(err), err, np.float32(default_err))


def se3_inverse(T: np.ndarray) -> np.ndarray:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = np.swapaxes(R, -1, -2)
    out = np.zeros_like(T)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = -np.einsum("...ij,...j->...i", Rt, t)
    out[..., 3, 3] = 1.0
    return out


def all_pairs(n: int) -> Tuple[np.ndarray, np.ndarray]:
    i1, i2 = np.triu_indices(n, k=1)
    return i1, i2


def camera_to_rel_deg(pred_c2w: np.ndarray, gt_c2w: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """All-pairs relative rotation/translation errors in degrees
    (cam_pose_metric.py:17-42).  Inputs: (N, 4, 4) cam2world."""
    pred_c2w = np.asarray(pred_c2w, np.float32)
    gt_c2w = np.asarray(gt_c2w, np.float32)
    n = pred_c2w.shape[0]
    i1, i2 = all_pairs(n)
    rel_gt = se3_inverse(gt_c2w[i1]) @ gt_c2w[i2]
    rel_pred = se3_inverse(pred_c2w[i1]) @ pred_c2w[i2]
    rdeg = (so3_relative_angle(rel_gt[:, :3, :3], rel_pred[:, :3, :3])
            * np.float32(180.0) / np.float32(np.pi))
    tdeg = translation_angle_deg(rel_gt[:, :3, 3], rel_pred[:, :3, 3])
    return rdeg, tdeg


def calculate_auc(r_error: np.ndarray, t_error: np.ndarray,
                  max_threshold: int = 30) -> float:
    """mAA: mean of the cumulative histogram of max(r, t) errors
    (cam_pose_metric.py:44-73)."""
    max_errors = np.maximum(np.asarray(r_error), np.asarray(t_error))
    bins = np.arange(max_threshold + 1)
    histogram, _ = np.histogram(max_errors, bins=bins)
    normalized = histogram.astype(float) / len(max_errors)
    return float(np.mean(np.cumsum(normalized)))


def pose_metrics(pred_c2w, gt_c2w,
                 thresholds=(5, 15, 30)) -> Dict[str, float]:
    """RRA/RTA@tau + mAA(30) for one scene."""
    rdeg, tdeg = camera_to_rel_deg(pred_c2w, gt_c2w)
    out = {}
    for tau in thresholds:
        out[f"RRA_at_{tau}"] = float((rdeg < tau).mean())
        out[f"RTA_at_{tau}"] = float((tdeg < tau).mean())
    out["mAA_30"] = calculate_auc(rdeg, tdeg, 30)
    return out
