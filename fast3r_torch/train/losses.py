"""Training losses: multiview confidence-weighted 3D regression.

Counterpart of ``fast3r_tpu/train/losses.py`` (``LossConfig``,
``regr3d_multiview_v4``, ``conf_loss_multiview_v2``; reference
Regr3DMultiviewV4 and ConfLossMultiviewV2, the training objective), and of
its legacy variants below: ground-truth points of every
view move into the anchor (view 0) camera frame for the global branch and
into each view's own frame for the local branch; prediction and ground truth
are normalised independently by their mean valid distance (jointly over the
views for the global branch, per view for the local one); the per-pixel
loss is ``conf * ||pred - gt|| - alpha * log(conf)``, a masked mean per
(view, branch), summed and divided by the number of terms.  All loss math is
fp32; masked means are ``sum(x * mask) / sum(mask)`` as in the JAX package.

Data parallelism: the means pool over (B, H, W) jointly, so a rank's batch
rows alone do not give the global batch's loss.  Given ``pool`` (a sum
over the data-parallel ranks, ``Mesh.sum_data``), the counts are pooled
before the divide and the returned loss is this rank's share: the sum of
the ranks' shares is the global loss, and so is the sum of their
gradients.  The per-view details come back pooled (whole).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from fast3r_torch.ops.geometry import geotrf, se3_inverse

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class LossConfig:
    alpha: float = 0.2             # conf-loss regulariser (flagship config)
    norm_mode: str = "avg_dis"
    gt_scale: bool = False
    local_scale_consistent: bool = False
    with_local: bool = True


def _masked_mean(x: torch.Tensor, mask: torch.Tensor, dim=None,
                 pool=None) -> torch.Tensor:
    """sum(x * mask) / sum(mask) (0 where nothing is valid); with ``pool``
    the count is pooled over the ranks first: this rank's share of the
    pooled mean."""
    m = mask.to(x.dtype)
    s = (x * m).sum() if dim is None else (x * m).sum(dim)
    n = m.sum() if dim is None else m.sum(dim)
    if pool is not None:
        n = pool(n)
    return torch.where(n > 0, s / n.clamp(min=1.0), torch.zeros_like(s))


def _norm_factor(pts: torch.Tensor, valid: torch.Tensor, norm_mode: str,
                 lead: int) -> torch.Tensor:
    """Mean valid distance over everything after the first ``lead`` axes of
    (..., 3) points, at least 1e-8."""
    mode, dis_mode = norm_mode.split("_")
    dis = torch.linalg.vector_norm(pts, dim=-1)
    if dis_mode == "log1p":
        dis = torch.log1p(dis)
    elif dis_mode != "dis":
        raise ValueError(f"unsupported dis mode {dis_mode!r}")
    if mode != "avg":
        raise ValueError(f"unsupported norm mode {mode!r}")
    shape = pts.shape[:lead] + (-1,)
    return _masked_mean(dis.reshape(shape), valid.reshape(shape),
                        dim=-1).clamp(min=1e-8)


def _perview_norm_factor(pts: torch.Tensor, valid: torch.Tensor,
                         norm_mode: str) -> torch.Tensor:
    """Per-(sample, view) factor of (..., H, W, 3) points: the mean valid
    distance over each view's pixels, shape (...)."""
    return _norm_factor(pts, valid, norm_mode, pts.dim() - 3)


def regr3d_multiview_v4(gts: Tensors, preds: Tensors,
                        cfg: LossConfig = LossConfig(), pool=None
                        ) -> Tuple[Tensors, Tensors]:
    """Per-pixel regression distances of the global (+ local) branch.

    gts: pts3d (B, V, H, W, 3) world frame, valid_mask (B, V, H, W) bool,
    camera_pose (B, V, 4, 4) cam2world; preds: pts3d_in_other_view
    [+ pts3d_local].  Returns ({"global": (B, V, H, W)[, "local"],
    "valid_mask"}, {"global_per_view": (V,)[, "local_per_view"]}); with
    ``pool`` the per-view details are pooled over the ranks."""
    gt_pts = gts["pts3d"].float()
    valid = gts["valid_mask"]
    poses = gts["camera_pose"].float()
    B, V = gt_pts.shape[:2]
    bcast = (slice(None),) + (None,) * 4

    inv_anchor = se3_inverse(poses[:, 0])
    gt_global = geotrf(inv_anchor, gt_pts.reshape(B, -1, 3)).reshape(
        gt_pts.shape)
    pr_global = preds["pts3d_in_other_view"].float()
    nf_pr = _norm_factor(pr_global, valid, cfg.norm_mode, 1)
    pr_g = pr_global / nf_pr[bcast]
    nf_gt = None
    if not cfg.gt_scale:
        nf_gt = _norm_factor(gt_global, valid, cfg.norm_mode, 1)
        gt_g = gt_global / nf_gt[bcast]
    else:
        gt_g = gt_global
    out = {"global": torch.linalg.vector_norm(pr_g - gt_g, dim=-1)}
    details = {"global_per_view": _pooled(_masked_mean(
        out["global"].detach(), valid, (0, 2, 3), pool), pool)}

    if cfg.with_local and "pts3d_local" in preds:
        inv_local = se3_inverse(poses.reshape(B * V, 4, 4))
        gt_local = geotrf(inv_local, gt_pts.reshape(B * V, -1, 3)).reshape(
            gt_pts.shape)
        pr_local = preds["pts3d_local"].float()
        if not cfg.local_scale_consistent:
            per_view = (slice(None), slice(None)) + (None,) * 3
            pr_l = pr_local / _perview_norm_factor(pr_local, valid,
                                                   cfg.norm_mode)[per_view]
            gt_l = (gt_local / _perview_norm_factor(gt_local, valid,
                                                    cfg.norm_mode)[per_view]
                    if not cfg.gt_scale else gt_local)
        else:
            pr_l = pr_local / nf_pr[bcast]
            gt_l = gt_local / nf_gt[bcast] if not cfg.gt_scale else gt_local
        out["local"] = torch.linalg.vector_norm(pr_l - gt_l, dim=-1)
        details["local_per_view"] = _pooled(_masked_mean(
            out["local"].detach(), valid, (0, 2, 3), pool), pool)
    out["valid_mask"] = valid
    return out, details


def _pooled(share: torch.Tensor, pool) -> torch.Tensor:
    """The whole value from this rank's share (the share itself without a
    pool)."""
    return share if pool is None else pool(share)


def conf_loss_multiview_v2(gts: Tensors, preds: Tensors,
                           cfg: LossConfig = LossConfig(), pool=None
                           ) -> Tuple[torch.Tensor, Tensors]:
    """The training objective: (scalar loss, details), details holding the
    per-view distances and ``conf_loss_{branch}`` (V,) per branch.  With
    ``pool`` (data parallelism) the loss is this rank's share of the
    global batch's, the details whole."""
    pixel, details = regr3d_multiview_v4(gts, preds, cfg, pool)
    valid = pixel["valid_mask"]
    V = valid.shape[1]
    terms = []
    branches = [("global", "conf")]
    if "local" in pixel:
        branches.append(("local", "conf_local"))
    for branch, conf_key in branches:
        conf = preds[conf_key].float()
        px = pixel[branch] * conf - cfg.alpha * torch.log(conf)
        # per-view masked mean over (B, H, W) jointly
        per_view = _masked_mean(px.transpose(0, 1).reshape(V, -1),
                                valid.transpose(0, 1).reshape(V, -1), -1,
                                pool)
        details[f"conf_loss_{branch}"] = _pooled(per_view.detach(), pool)
        terms.append(per_view)
    total = torch.cat(terms)
    return total.sum() / total.shape[0], details


# ---------------------------------------------------------------------------
# legacy variants (the JAX package's; reference losses.py:160-568, 744-788,
# 898-977).  Each takes and returns what its JAX counterpart does.
# ---------------------------------------------------------------------------

def _joint_norm_factor(pts: torch.Tensor, valid: torch.Tensor,
                       norm_mode: str) -> torch.Tensor:
    """Per-sample factor of (B, ...) points over all their views, (B,)."""
    return _norm_factor(pts, valid, norm_mode, 1)


def _global_scalar_norm_factor(pts: torch.Tensor, valid: torch.Tensor,
                               norm_mode: str) -> torch.Tensor:
    """One factor over the valid points of every sample and view (the
    reference V2 / V3 ``dis.mean()``, unlike V4's per-sample factor)."""
    return _norm_factor(pts, valid, norm_mode, 0)


def _masked_lower_median(x: torch.Tensor, valid: torch.Tensor
                         ) -> torch.Tensor:
    """``torch.nanmedian`` along the last axis over the valid entries: the
    lower median (element (n - 1) // 2 of the sorted values); +inf where
    nothing is valid."""
    s = torch.where(valid, x, torch.full_like(x, float("inf"))).sort(-1)[0]
    idx = ((valid.sum(-1) - 1) // 2).clamp(min=0)
    return s.gather(-1, idx[..., None])[..., 0]


def _pair_in_cam1(gt1: Tensors, gt2: Tensors, pred1: Tensors, pred2: Tensors):
    """Both views' ground truth in view 1's camera frame, and the
    predictions: pred1's own-frame pts3d, pred2's pts3d_in_other_view."""
    in_cam1 = se3_inverse(gt1["camera_pose"].float())
    return (geotrf(in_cam1, gt1["pts3d"].float()),
            geotrf(in_cam1, gt2["pts3d"].float()),
            pred1["pts3d"].float(), pred2["pts3d_in_other_view"].float())


def _pair_normalised(gt_pts1, gt_pts2, pr_pts1, pr_pts2, valid1, valid2,
                     norm_mode: str, gt_scale: bool):
    """Each pair divided by its joint per-sample factor over both views (the
    ground truth only without ``gt_scale``)."""
    valid = torch.stack([valid1, valid2], 1)

    def factor(p1, p2):
        return _joint_norm_factor(torch.stack([p1, p2], 1), valid,
                                  norm_mode)[:, None, None, None]

    nf = factor(pr_pts1, pr_pts2)
    pr_pts1, pr_pts2 = pr_pts1 / nf, pr_pts2 / nf
    if not gt_scale:
        nf = factor(gt_pts1, gt_pts2)
        gt_pts1, gt_pts2 = gt_pts1 / nf, gt_pts2 / nf
    return gt_pts1, gt_pts2, pr_pts1, pr_pts2


def regr3d_pair(gt1: Tensors, gt2: Tensors, pred1: Tensors, pred2: Tensors,
                norm_mode: str = "avg_dis", gt_scale: bool = False
                ) -> Tuple[Tensors, Tensors]:
    """Pairwise DUSt3R regression (reference Regr3D): both views' ground
    truth in view 1's frame, pred1's pts3d and pred2's pts3d_in_other_view
    against them after the joint normalisation of the pair.  Returns
    ({"l1", "l2": (B, H, W), "valid1", "valid2"}, details)."""
    valid1, valid2 = gt1["valid_mask"], gt2["valid_mask"]
    gt_pts1, gt_pts2, pr_pts1, pr_pts2 = _pair_normalised(
        *_pair_in_cam1(gt1, gt2, pred1, pred2), valid1, valid2, norm_mode,
        gt_scale)
    l1 = torch.linalg.vector_norm(pr_pts1 - gt_pts1, dim=-1)
    l2 = torch.linalg.vector_norm(pr_pts2 - gt_pts2, dim=-1)
    details = {"Regr3D_pts3d_1": _masked_mean(l1, valid1),
               "Regr3D_pts3d_2": _masked_mean(l2, valid2)}
    return {"l1": l1, "l2": l2, "valid1": valid1, "valid2": valid2}, details


def conf_loss_pair(gt1: Tensors, gt2: Tensors, pred1: Tensors,
                   pred2: Tensors, alpha: float = 0.2,
                   norm_mode: str = "avg_dis", gt_scale: bool = False
                   ) -> Tuple[torch.Tensor, Tensors]:
    """Pairwise confidence loss (reference ConfLoss): the SUM over the two
    views of masked-mean(conf * loss - alpha * log conf)."""
    pixel, details = regr3d_pair(gt1, gt2, pred1, pred2, norm_mode, gt_scale)
    terms = []
    for li, vi, pred in (("l1", "valid1", pred1), ("l2", "valid2", pred2)):
        conf = pred["conf"].float()
        terms.append(_masked_mean(pixel[li] * conf - alpha * torch.log(conf),
                                  pixel[vi]))
    details["conf_loss_1"], details["conf_loss_2"] = terms
    return terms[0] + terms[1], details


def _anchor_frame(gts: Tensors) -> torch.Tensor:
    """Every view's ground truth in view 0's camera frame, (B, V, H, W, 3)."""
    gt_pts = gts["pts3d"].float()
    B = gt_pts.shape[0]
    inv_anchor = se3_inverse(gts["camera_pose"].float()[:, 0])
    return geotrf(inv_anchor, gt_pts.reshape(B, -1, 3)).reshape(gt_pts.shape)


def regr3d_multiview_v1(gts: Tensors, preds: Tensors,
                        norm_mode: str = "avg_dis", gt_scale: bool = False
                        ) -> Tuple[Tensors, Tensors]:
    """Reference Regr3DMultiview: view i normalised jointly with the anchor
    view only (pair by pair, not over all views); global branch only."""
    valid = gts["valid_mask"]
    gt_a = _anchor_frame(gts)
    pr = preds["pts3d_in_other_view"].float()
    losses, details = [], {}
    for i in range(valid.shape[1]):
        pair_valid = torch.stack([valid[:, 0], valid[:, i]], 1)

        def pair_nf(p):
            return _joint_norm_factor(torch.stack([p[:, 0], p[:, i]], 1),
                                      pair_valid, norm_mode)[:, None, None,
                                                             None]

        pr_i = pr[:, i] / pair_nf(pr)
        gt_i = gt_a[:, i] if gt_scale else gt_a[:, i] / pair_nf(gt_a)
        li = torch.linalg.vector_norm(pr_i - gt_i, dim=-1)
        losses.append(li)
        details[f"Regr3DMultiview_pts3d_{i}_loss"] = _masked_mean(
            li, valid[:, i])
    return {"global": torch.stack(losses, 1), "valid_mask": valid}, details


def regr3d_multiview_v2(gts: Tensors, preds: Tensors,
                        norm_mode: str = "avg_dis", gt_scale: bool = False
                        ) -> Tuple[Tensors, Tensors]:
    """Reference Regr3DMultiviewV2: one factor over all views and samples
    (a batch-global scalar); global branch only."""
    valid = gts["valid_mask"]
    gt_g = _anchor_frame(gts)
    pr_g = preds["pts3d_in_other_view"].float()
    pr_g = pr_g / _global_scalar_norm_factor(pr_g, valid, norm_mode)
    if not gt_scale:
        gt_g = gt_g / _global_scalar_norm_factor(gt_g, valid, norm_mode)
    pixel = {"global": torch.linalg.vector_norm(pr_g - gt_g, dim=-1),
             "valid_mask": valid}
    details = {f"Regr3DMultiview_pts3d_{i}_loss": _masked_mean(
        pixel["global"][:, i], valid[:, i]) for i in range(valid.shape[1])}
    return pixel, details


def regr3d_multiview_v3(gts: Tensors, preds: Tensors,
                        norm_mode: str = "avg_dis", gt_scale: bool = False
                        ) -> Tuple[Tensors, Tensors]:
    """Reference Regr3DMultiviewV3: V2's global branch, and a local branch
    (each view in its own frame) normalised by one batch-global factor a
    view."""
    pixel, _ = regr3d_multiview_v2(gts, preds, norm_mode, gt_scale)
    valid = pixel["valid_mask"]
    B, V = valid.shape[:2]
    details = {f"Regr3DMultiviewV3_pts3d_loss_global/{i:02d}": _masked_mean(
        pixel["global"][:, i], valid[:, i]) for i in range(V)}
    if "pts3d_local" in preds:
        gt_pts = gts["pts3d"].float()
        inv_local = se3_inverse(gts["camera_pose"].float().reshape(B * V, 4,
                                                                   4))
        gt_l = geotrf(inv_local, gt_pts.reshape(B * V, -1, 3)).reshape(
            gt_pts.shape)
        pr_l = preds["pts3d_local"].float()

        def perview_scalar(pts):
            return torch.stack([_global_scalar_norm_factor(
                pts[:, i], valid[:, i], norm_mode) for i in range(V)])[
                None, :, None, None, None]

        pr_l = pr_l / perview_scalar(pr_l)
        if not gt_scale:
            gt_l = gt_l / perview_scalar(gt_l)
        pixel["local"] = torch.linalg.vector_norm(pr_l - gt_l, dim=-1)
        for i in range(V):
            details[f"Regr3DMultiviewV3_pts3d_loss_local/{i:02d}"] = \
                _masked_mean(pixel["local"][:, i], valid[:, i])
    return pixel, details


def conf_loss_multiview_v1(gts: Tensors, preds: Tensors, alpha: float = 1.0,
                           norm_mode: str = "avg_dis", gt_scale: bool = False
                           ) -> Tuple[torch.Tensor, Tensors]:
    """Reference ConfLossMultiview: the SUM over views of
    masked-mean(conf * loss - alpha * log conf) over V2's global branch."""
    pixel, details = regr3d_multiview_v2(gts, preds, norm_mode, gt_scale)
    valid = pixel["valid_mask"]
    conf = preds["conf"].float()
    total = torch.zeros((), device=conf.device)
    for i in range(valid.shape[1]):
        ci = _masked_mean(pixel["global"][:, i] * conf[:, i]
                          - alpha * torch.log(conf[:, i]), valid[:, i])
        details[f"ConfLossMultiview_conf_loss_{i}"] = ci
        total = total + ci
    return total, details


def regr3d_scale_shift_inv(gt1: Tensors, gt2: Tensors, pred1: Tensors,
                           pred2: Tensors, norm_mode=None,
                           gt_scale: bool = False) -> Tuple[Tensors, Tensors]:
    """Reference Regr3D_ScaleShiftInv: after the optional pair
    normalisation, (1) subtract from each side the joint lower-median depth
    (z only) of its two views; (2) divide by the joint lower-median distance
    to the per-coordinate lower-median centre (the prediction's clipped to
    [1e-3, 1e3]; with ``gt_scale`` the prediction is rescaled to the ground
    truth's scale instead)."""
    valid1, valid2 = gt1["valid_mask"], gt2["valid_mask"]
    pts = _pair_in_cam1(gt1, gt2, pred1, pred2)
    if norm_mode:
        pts = _pair_normalised(*pts, valid1, valid2, norm_mode, gt_scale)
    gt_pts1, gt_pts2, pr_pts1, pr_pts2 = pts
    B = gt_pts1.shape[0]
    both_valid = torch.cat([valid1.reshape(B, -1), valid2.reshape(B, -1)], -1)

    def shifted(p1, p2):
        z = torch.cat([p1[..., 2].reshape(B, -1), p2[..., 2].reshape(B, -1)],
                      -1)
        shift = _masked_lower_median(z, both_valid)[:, None, None, None]
        off = torch.cat([torch.zeros_like(shift).expand(-1, -1, -1, 2),
                         shift], -1)
        return p1 - off, p2 - off

    gt_pts1, gt_pts2 = shifted(gt_pts1, gt_pts2)
    pr_pts1, pr_pts2 = shifted(pr_pts1, pr_pts2)

    def center_scale(p1, p2):
        p = torch.cat([p1.reshape(B, -1, 3), p2.reshape(B, -1, 3)], 1)
        center = torch.stack([_masked_lower_median(p[..., c], both_valid)
                              for c in range(3)], -1)
        return _masked_lower_median(
            torch.linalg.vector_norm(p - center[:, None], dim=-1),
            both_valid)[:, None, None, None]

    gt_s = center_scale(gt_pts1, gt_pts2)
    pr_s = center_scale(pr_pts1, pr_pts2).clamp(1e-3, 1e3)
    if gt_scale:
        pr_pts1, pr_pts2 = pr_pts1 * gt_s / pr_s, pr_pts2 * gt_s / pr_s
    else:
        gt_pts1, gt_pts2 = gt_pts1 / gt_s, gt_pts2 / gt_s
        pr_pts1, pr_pts2 = pr_pts1 / pr_s, pr_pts2 / pr_s
    l1 = torch.linalg.vector_norm(pr_pts1 - gt_pts1, dim=-1)
    l2 = torch.linalg.vector_norm(pr_pts2 - gt_pts2, dim=-1)
    details = {"Regr3D_ScaleShiftInv_pts3d_1": _masked_mean(l1, valid1),
               "Regr3D_ScaleShiftInv_pts3d_2": _masked_mean(l2, valid2)}
    return {"l1": l1, "l2": l2, "valid1": valid1, "valid2": valid2}, details
