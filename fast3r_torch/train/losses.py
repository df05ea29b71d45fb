"""Training losses: multiview confidence-weighted 3D regression.

Counterpart of ``fast3r_tpu/train/losses.py`` (``LossConfig``,
``regr3d_multiview_v4``, ``conf_loss_multiview_v2``; reference
Regr3DMultiviewV4 and ConfLossMultiviewV2): ground-truth points of every
view move into the anchor (view 0) camera frame for the global branch and
into each view's own frame for the local branch; prediction and ground truth
are normalised independently by their mean valid distance (jointly over the
views for the global branch, per view for the local one); the per-pixel
loss is ``conf * ||pred - gt|| - alpha * log(conf)``, a masked mean per
(view, branch), summed and divided by the number of terms.  All loss math is
fp32; masked means are ``sum(x * mask) / sum(mask)`` as in the JAX package.
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


def _masked_mean(x: torch.Tensor, mask: torch.Tensor, dim=None) -> torch.Tensor:
    m = mask.to(x.dtype)
    s = (x * m).sum() if dim is None else (x * m).sum(dim)
    n = m.sum() if dim is None else m.sum(dim)
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
                        cfg: LossConfig = LossConfig()
                        ) -> Tuple[Tensors, Tensors]:
    """Per-pixel regression distances of the global (+ local) branch.

    gts: pts3d (B, V, H, W, 3) world frame, valid_mask (B, V, H, W) bool,
    camera_pose (B, V, 4, 4) cam2world; preds: pts3d_in_other_view
    [+ pts3d_local].  Returns ({"global": (B, V, H, W)[, "local"],
    "valid_mask"}, {"global_per_view": (V,)[, "local_per_view"]})."""
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
    details = {"global_per_view": _masked_mean(out["global"], valid,
                                               dim=(0, 2, 3))}

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
        details["local_per_view"] = _masked_mean(out["local"], valid,
                                                 dim=(0, 2, 3))
    out["valid_mask"] = valid
    return out, details


def conf_loss_multiview_v2(gts: Tensors, preds: Tensors,
                           cfg: LossConfig = LossConfig()
                           ) -> Tuple[torch.Tensor, Tensors]:
    """The training objective: (scalar loss, details), details holding the
    per-view distances and ``conf_loss_{branch}`` (V,) per branch."""
    pixel, details = regr3d_multiview_v4(gts, preds, cfg)
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
                                valid.transpose(0, 1).reshape(V, -1), dim=-1)
        details[f"conf_loss_{branch}"] = per_view
        terms.append(per_view)
    total = torch.cat(terms)
    return total.sum() / total.shape[0], details
