"""Head-output postprocessing: raw channels -> 3D pointmap + confidence.

Counterpart of ``fast3r_tpu/ops/postprocess.py``:

  * depth_mode ("exp", -inf, inf): pts3d = xyz / max(||xyz||, 1e-8) * expm1(||xyz||)
  * conf_mode  ("exp", 1, inf):    conf  = 1 + exp(x)

:func:`postprocess` takes the channel-last (B, H, W, C) map of the plain head;
:func:`postprocess_transposed` the channel-major (B, C, H*W) map of the trunk
kernel.  Both return {"pts3d": (B, H, W, 3), "conf": (B, H, W)}.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

Mode = Tuple[str, float, float]


def _depth(xyz: torch.Tensor, mode: Mode, dim: int) -> torch.Tensor:
    name, vmin, vmax = mode
    if name == "linear":
        if vmin == -float("inf") and vmax == float("inf"):
            return xyz
        return xyz.clamp(vmin, vmax)
    d = torch.linalg.vector_norm(xyz, dim=dim, keepdim=True)
    xyz = xyz / d.clamp(min=1e-8)
    if name == "square":
        return xyz * d.square()
    if name == "exp":
        return xyz * torch.expm1(d)
    raise ValueError(f"bad depth mode={name!r}")


def _conf(x: torch.Tensor, mode: Mode) -> torch.Tensor:
    name, vmin, vmax = mode
    if name == "exp":
        return vmin + torch.exp(x).clamp(max=vmax - vmin)
    if name == "sigmoid":
        return (vmax - vmin) * torch.sigmoid(x) + vmin
    raise ValueError(f"bad conf mode={name!r}")


def postprocess(out: torch.Tensor, depth_mode: Mode,
                conf_mode: Optional[Mode]) -> Dict[str, torch.Tensor]:
    """Split a (B, H, W, C) head map into pts3d (+ conf)."""
    res = {"pts3d": _depth(out[..., 0:3], depth_mode, dim=-1)}
    if conf_mode is not None:
        res["conf"] = _conf(out[..., 3], conf_mode)
    return res


def postprocess_transposed(out: torch.Tensor, depth_mode: Mode,
                           conf_mode: Optional[Mode], out_h: int,
                           out_w: int) -> Dict[str, torch.Tensor]:
    """postprocess() over a channel-major (B, C, H*W) head map; same math,
    same outputs."""
    B = out.shape[0]
    pts = _depth(out[:, 0:3], depth_mode, dim=1)
    res = {"pts3d": pts.transpose(1, 2).reshape(B, out_h, out_w, 3)}
    if conf_mode is not None:
        res["conf"] = _conf(out[:, 3], conf_mode).reshape(B, out_h, out_w)
    return res
