"""The training step: forward, loss, backward and AdamW on one device.

Counterpart of ``fast3r_tpu/train/step.py`` (``OptimConfig``,
``make_schedule``, ``make_optimizer``, ``TrainState``, ``init_train_state``,
``train_step``).  The optimizer reproduces the JAX package's optax chain:

  * ``make_schedule``: optax's ``warmup_cosine_decay_schedule`` (linear 0 ->
    lr over ``warmup_steps``, then cosine to ``eta_min`` at
    ``total_steps``), evaluated at the optimizer's own count, so the first
    step runs at lr 0;
  * optional ``clip_by_global_norm(grad_clip)`` on the gradients first;
  * AdamW: bias-corrected moments (eps 1e-8 outside the square root), the
    decoupled weight decay added to the update, times -lr;
  * optional ``lr_scales`` per top-level group after AdamW, an unknown
    group name raising.

The non-finite guard: a non-finite loss or gradient norm leaves params and
optimizer state (moments and count) untouched while ``step`` advances.
The port updates params and moments in place (the JAX step returns new
arrays); moments take the params' dtype, as optax's do.  Norms (gradient
norm, clip, ``watch/``) are taken in fp32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch

from fast3r_torch.models.fast3r import Fast3RConfig, Fast3RNet, fast3r_forward
from fast3r_torch.train.losses import LossConfig, conf_loss_multiview_v2

ADAM_EPS = 1e-8


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    lr: float = 1e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    weight_decay: float = 0.05
    warmup_steps: int = 1000
    total_steps: int = 100_000
    eta_min: float = 1e-6
    grad_clip: Optional[float] = None
    # ((top-level group, scale), ...): each group's update times its scale
    lr_scales: Optional[Tuple[Tuple[str, float], ...]] = None


def make_schedule(cfg: OptimConfig):
    """step -> learning rate, optax's warmup_cosine_decay_schedule(0, lr,
    warmup_steps, total_steps, eta_min)."""
    alpha = 0.0 if cfg.lr == 0.0 else cfg.eta_min / cfg.lr
    decay = cfg.total_steps - cfg.warmup_steps
    if decay <= 0:
        raise ValueError("total_steps must exceed warmup_steps")

    def schedule(step: int) -> float:
        if step < cfg.warmup_steps:
            return cfg.lr * min(max(step, 0), cfg.warmup_steps) / cfg.warmup_steps
        t = min(step - cfg.warmup_steps, decay)
        return cfg.lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / decay))
                         + alpha)

    return schedule


@dataclasses.dataclass
class AdamWState:
    count: int                    # updates applied (Adam and the schedule)
    mu: Dict[str, torch.Tensor]   # first moments, by parameter name
    nu: Dict[str, torch.Tensor]   # second moments


@dataclasses.dataclass
class TrainState:
    params: Fast3RNet
    opt_state: AdamWState
    step: int
    generator: torch.Generator    # CPU; the decoder's random image ids


def _check_lr_scales(cfg: OptimConfig, params: Fast3RNet) -> None:
    groups = sorted(name for name, _ in params.named_children())
    unknown = sorted(set(dict(cfg.lr_scales or ())) - set(groups))
    if unknown:
        raise ValueError(f"lr_scales keys {unknown} match no top-level param "
                         f"group; available groups: {groups}")


def init_train_state(params: Fast3RNet, optim_cfg: OptimConfig,
                     seed: int = 0) -> TrainState:
    """Zero moments in the params' dtype and device, count 0, step 0."""
    _check_lr_scales(optim_cfg, params)
    named = dict(params.named_parameters())
    return TrainState(
        params=params,
        opt_state=AdamWState(
            count=0, mu={k: torch.zeros_like(p) for k, p in named.items()},
            nu={k: torch.zeros_like(p) for k, p in named.items()}),
        step=0, generator=torch.Generator().manual_seed(seed))


def global_norm(ts: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, fp32."""
    if not ts:
        return torch.zeros(())
    return torch.sqrt(sum(t.float().square().sum() for t in ts))


@torch.no_grad()
def _adamw_update(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
                  state: AdamWState, cfg: OptimConfig, grad_norm: torch.Tensor
                  ) -> None:
    """One AdamW update in place (params and moments), count advanced."""
    b1, b2 = cfg.betas
    lr = make_schedule(cfg)(state.count)
    state.count += 1
    c1, c2 = 1 - b1 ** state.count, 1 - b2 ** state.count
    # optax's clip_by_global_norm: scale to grad_clip unless below it
    clip = cfg.grad_clip is not None and not bool(grad_norm < cfg.grad_clip)
    scales = dict(cfg.lr_scales or ())
    for name, p in params.items():
        g = grads[name]
        if clip:
            g = (g / grad_norm.to(g.device, g.dtype)) * cfg.grad_clip
        mu, nu = state.mu[name], state.nu[name]
        mu.mul_(b1).add_(g, alpha=1 - b1)
        nu.mul_(b2).add_(g.square(), alpha=1 - b2)
        upd = (mu / c1) / (torch.sqrt(nu / c2) + ADAM_EPS)
        upd = upd + cfg.weight_decay * p
        upd = upd * (-lr * scales.get(name.split(".", 1)[0], 1.0))
        p.copy_(p + upd)


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               model_cfg: Fast3RConfig, optim_cfg: OptimConfig,
               loss_cfg: LossConfig = LossConfig(), remat: bool = True,
               mixed_orientation: bool = False,
               view_ids: Optional[torch.Tensor] = None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimisation step on the params' device; updates ``state`` in
    place and returns it with the metrics.

    batch: imgs (B, V, H, W, 3), true_shapes (B, V, 2), pts3d
    (B, V, H, W, 3), valid_mask (B, V, H, W), camera_pose (B, V, 4, 4);
    tensors or numpy arrays, moved to the params' device (imgs in their
    dtype).  ``view_ids`` (B, V) replace the decoder image ids drawn from
    ``state.generator`` (e.g. to reproduce another implementation's draw).
    Metrics: loss, lr, grad_norm, skipped_nonfinite, the loss details and
    ``watch/grad_norm/{group}``, ``watch/param_norm/{group}``.
    """
    net = state.params
    p0 = next(net.parameters())
    dev, dt = p0.device, p0.dtype
    b = {k: torch.as_tensor(batch[k]).to(dev) for k in
         ("imgs", "true_shapes", "pts3d", "valid_mask", "camera_pose")}
    named = {k: p for k, p in net.named_parameters() if p.requires_grad}

    with torch.enable_grad():
        preds = fast3r_forward(net, model_cfg, b["imgs"].to(dt),
                               b["true_shapes"].cpu(),
                               mixed_orientation=mixed_orientation,
                               view_ids=view_ids, is_training=True,
                               remat=remat, generator=state.generator)
        loss, details = conf_loss_multiview_v2(b, preds, loss_cfg)
        grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()),
                                                    allow_unused=True)))
    grads = {k: torch.zeros_like(named[k]) if g is None else g
             for k, g in grads.items()}
    loss = loss.detach()
    grad_norm = global_norm(list(grads.values()))
    finite = bool(torch.isfinite(loss)) and bool(torch.isfinite(grad_norm))

    with torch.no_grad():
        metrics = {"loss": loss, "lr": make_schedule(optim_cfg)(state.step),
                   "grad_norm": grad_norm,
                   "skipped_nonfinite": int(not finite),
                   **{k: v.detach() for k, v in details.items()}}
        for group, mod in net.named_children():
            names = [f"{group}.{k}" for k, _ in mod.named_parameters()]
            metrics[f"watch/grad_norm/{group}"] = global_norm(
                [grads[n] for n in names if n in grads])
            metrics[f"watch/param_norm/{group}"] = global_norm(
                [p for _, p in mod.named_parameters()])
    if finite:
        _adamw_update(named, grads, state.opt_state, optim_cfg, grad_norm)
    state.step += 1
    return state, metrics
