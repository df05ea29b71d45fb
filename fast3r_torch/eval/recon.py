"""Reconstruction evaluation: alignment, normals, accuracy / completion.

Counterpart of ``fast3r_tpu/eval/recon.py``:

  * ``align_local_pts3d_to_global``: for each view and sample, the local
    head's pointmap is aligned onto the global head's by a weighted
    similarity (Umeyama) over the pixels whose global confidence reaches a
    percentile, with an identity fallback below three points.  The solves
    run batched on the device, one call per pixel grid shape.
  * ``evaluate_reconstruction`` (reference multiview_dust3r_module.py:
    551-735): per sample, the masked predicted points of every view are
    aligned to the ground truth by a confidence-weighted similarity (fp32
    on the device), then ``estimate_normals`` (30-NN PCA) on both clouds
    and the nearest-neighbour ``accuracy`` / ``completion`` with their
    normal consistencies (reference recon_metric.py:14-49).  The
    confidence thresholds are ``np.quantile`` per view, as in JAX; the
    KD-trees are scipy's ``cKDTree`` on the host, as in JAX.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from scipy.spatial import cKDTree

from fast3r_torch.ops.umeyama import apply_similarity, rigid_points_registration

_KEYS = ("pts3d_local", "conf_local", "pts3d_in_other_view", "conf")


def _align(pts_local, pts_global, weights):
    """(n, N, 3) local points onto global ones, (n, N) weights."""
    R, t, s = rigid_points_registration(pts_local, pts_global, weights)
    ok = weights.sum(-1) >= 3
    R = torch.where(ok[:, None, None], R,
                    torch.eye(3, device=R.device).expand_as(R))
    t = torch.where(ok[:, None], t, torch.zeros_like(t))
    s = torch.where(ok, s, torch.ones_like(s))
    return apply_similarity(pts_local.float(), R, t, s)


def align_local_pts3d_to_global(preds: Sequence[Dict],
                                views: Optional[Sequence[Dict]] = None,
                                min_conf_thr_percentile: float = 0.0,
                                device="cuda") -> None:
    """Adds "pts3d_local_aligned_to_global" (B, H, W, 3) float32 CPU to
    each pred dict, in place (a per-sample list where the samples' shapes
    differ); the solves run on ``device``.  Entries are (B, H, W, ...)
    tensors or arrays, or per-sample lists of them; a view's "valid_mask"
    narrows the confidence mask, and replaces it where fewer than three
    pixels remain."""
    for pred in preds:
        for key in _KEYS:
            if key not in pred:
                raise ValueError(f"Key {key!r} not found in preds.")
    jobs = {}  # (H, W) -> [(view, sample, local, global, weights)]
    for v, pred in enumerate(preds):
        for b in range(len(pred["pts3d_local"])):
            local, glob, conf = (torch.as_tensor(pred[k][b]).to(device).float()
                                 for k in ("pts3d_local",
                                           "pts3d_in_other_view", "conf"))
            cg = conf.reshape(-1)
            mask = cg >= torch.quantile(cg, min_conf_thr_percentile / 100.0)
            if views is not None and "valid_mask" in views[v]:
                valid = torch.as_tensor(views[v]["valid_mask"][b]).to(
                    device).reshape(-1).bool()
                mask &= valid
                if mask.sum() < 3:
                    mask = valid
            jobs.setdefault(tuple(local.shape[:2]), []).append(
                (v, b, local.reshape(-1, 3), glob.reshape(-1, 3),
                 mask.float()))
    out = {}
    for (H, W), items in jobs.items():
        aligned = _align(*(torch.stack([it[k] for it in items])
                           for k in (2, 3, 4))).cpu()
        for (v, b, *_), a in zip(items, aligned):
            out[v, b] = a.reshape(H, W, 3)
    for v, pred in enumerate(preds):
        maps = [out[v, b] for b in range(len(pred["pts3d_local"]))]
        same = all(m.shape == maps[0].shape for m in maps)
        pred["pts3d_local_aligned_to_global"] = (torch.stack(maps) if same
                                                 else maps)


# ---------------------------------------------------------------------------
# normals + metrics
# ---------------------------------------------------------------------------

def estimate_normals(points: np.ndarray, knn: int = 30) -> np.ndarray:
    """PCA normals over the k nearest neighbours (Open3D's
    ``estimate_normals`` default, KDTreeSearchParamKNN(knn=30)): the
    smallest eigenvector of each neighbourhood's covariance.  The sign is
    arbitrary; the metrics use |dot| (recon_metric.py:30-31)."""
    k = min(knn, len(points))
    _, idx = cKDTree(points).query(points, k=k, workers=-1)
    nbrs = points[idx]                       # (N, k, 3)
    nbrs = nbrs - nbrs.mean(axis=1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", nbrs, nbrs)
    _, vecs = np.linalg.eigh(cov)
    return vecs[:, :, 0]


def accuracy(gt_points, rec_points, gt_normals=None, rec_normals=None):
    """Mean and median distance rec -> gt (and the normal consistency's
    mean and median) (recon_metric.py:21-34)."""
    dist, idx = cKDTree(gt_points).query(rec_points, workers=-1)
    if gt_normals is not None and rec_normals is not None:
        nd = np.abs(np.sum(gt_normals[idx] * rec_normals, axis=-1))
        return (float(dist.mean()), float(np.median(dist)), float(nd.mean()),
                float(np.median(nd)))
    return float(dist.mean()), float(np.median(dist))


def completion(gt_points, rec_points, gt_normals=None, rec_normals=None):
    """Mean and median distance gt -> rec (and the normal consistency's
    mean and median) (recon_metric.py:37-49)."""
    dist, idx = cKDTree(rec_points).query(gt_points, workers=-1)
    if gt_normals is not None and rec_normals is not None:
        nd = np.abs(np.sum(gt_normals * rec_normals[idx], axis=-1))
        return (float(dist.mean()), float(np.median(dist)), float(nd.mean()),
                float(np.median(nd)))
    return float(dist.mean()), float(np.median(dist))


def completion_ratio(gt_points, rec_points, dist_th: float = 0.05) -> float:
    dist, _ = cKDTree(rec_points).query(gt_points, workers=-1)
    return float((dist < dist_th).mean())


def _host(x) -> np.ndarray:
    """A tensor or array as a float32 (or bool) numpy array on the host."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x if x.dtype == torch.bool else x.float()).numpy()
    return np.asarray(x)


def evaluate_reconstruction(
    views: Sequence[Dict],
    preds: Sequence[Dict],
    min_conf_thr_percentile_for_local_alignment_and_icp: float = 0.0,
    min_conf_thr_percentile_for_metric_calculation: float = 0.0,
    use_pts3d_from_local_head: bool = True,
    device="cuda",
) -> List[Optional[Dict[str, float]]]:
    """Per-sample reconstruction metrics: a list over the batch of dicts
    with accuracy, accuracy_median, completion, completion_median, nc1,
    nc1_median, nc2 and nc2_median, or None for a sample with fewer than 3
    points.  ``views[v]`` holds "pts3d" (B, H, W, 3) and "valid_mask"
    (B, H, W); ``preds[v]`` the heads' outputs (tensors or arrays).  The
    alignments run on ``device``; with the local head, the preds gain
    "pts3d_local_aligned_to_global"."""
    assert (min_conf_thr_percentile_for_local_alignment_and_icp
            >= min_conf_thr_percentile_for_metric_calculation)
    if use_pts3d_from_local_head:
        align_local_pts3d_to_global(
            preds, views,
            min_conf_thr_percentile=(
                min_conf_thr_percentile_for_local_alignment_and_icp),
            device=device)
    pts_key, conf_key = (("pts3d_local_aligned_to_global", "conf_local")
                         if use_pts3d_from_local_head
                         else ("pts3d_in_other_view", "conf"))
    results = []
    for i in range(len(views[0]["pts3d"])):
        pred_pts, gt_pts_icp, gt_pts_metrics, icp_weights = [], [], [], []
        for view, pred in zip(views, preds):
            pts_pred = _host(pred[pts_key][i])
            conf = _host(pred[conf_key][i])
            pts_gt = _host(view["pts3d"][i])
            valid = _host(view["valid_mask"][i]).astype(bool)
            cflat = conf.reshape(-1)
            thr_metric = np.quantile(
                cflat, min_conf_thr_percentile_for_metric_calculation / 100.0)
            m_pred = valid & (conf >= thr_metric)
            pred_pts.append(pts_pred[m_pred].reshape(-1, 3))
            gt_pts_icp.append(pts_gt[m_pred].reshape(-1, 3))
            gt_pts_metrics.append(pts_gt[valid].reshape(-1, 3))
            thr_icp = np.quantile(
                cflat,
                min_conf_thr_percentile_for_local_alignment_and_icp / 100.0)
            icp_weights.append((conf[m_pred] >= thr_icp).astype(np.float32))
        pred_all = np.concatenate(pred_pts)
        gt_icp_all = np.concatenate(gt_pts_icp)
        gt_metrics_all = np.concatenate(gt_pts_metrics)
        w_all = np.concatenate(icp_weights)
        if len(pred_all) < 3 or len(gt_metrics_all) < 3:
            results.append(None)
            continue
        x = torch.from_numpy(pred_all).to(device)
        R, t, s = rigid_points_registration(
            x, torch.from_numpy(gt_icp_all).to(device),
            torch.from_numpy(w_all).to(device))
        pred_aligned = apply_similarity(x, R, t, s).cpu().numpy()

        pred_normals = estimate_normals(pred_aligned)
        gt_normals = estimate_normals(gt_metrics_all)
        acc, acc_med, nc1, nc1_med = accuracy(
            gt_metrics_all, pred_aligned, gt_normals, pred_normals)
        comp, comp_med, nc2, nc2_med = completion(
            gt_metrics_all, pred_aligned, gt_normals, pred_normals)
        results.append({
            "accuracy": acc, "accuracy_median": acc_med,
            "completion": comp, "completion_median": comp_med,
            "nc1": nc1, "nc1_median": nc1_med,
            "nc2": nc2, "nc2_median": nc2_med,
        })
    return results
