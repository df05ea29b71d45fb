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

Master weights: ``init_train_state(..., compute_dtype=torch.bfloat16)`` on
fp32 params keeps them (and the moments) in fp32 as the master and adds a
working copy in bf16, allocated once, on which ``train_step`` runs the
forward and backward (the card's kernels take bf16).  The working copy's
gradients are cast to the master's dtype for the norm, the clip, AdamW and
``lr_scales``; after an update the working copy is refreshed from the
master in place.  Without a compute dtype (or with the params' own) there
is no copy and the step computes in the params' dtype.
"""

from __future__ import annotations

import copy
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
    params: Fast3RNet             # the weights AdamW updates (the master)
    opt_state: AdamWState
    step: int
    generator: torch.Generator    # CPU; the decoder's random image ids
    # the compute copy of params in another dtype (forward and backward),
    # or None when the step computes on params themselves
    work: Optional[Fast3RNet] = None

    @property
    def compute_params(self) -> Fast3RNet:
        return self.params if self.work is None else self.work


def _check_lr_scales(cfg: OptimConfig, params: Fast3RNet) -> None:
    groups = sorted(name for name, _ in params.named_children())
    unknown = sorted(set(dict(cfg.lr_scales or ())) - set(groups))
    if unknown:
        raise ValueError(f"lr_scales keys {unknown} match no top-level param "
                         f"group; available groups: {groups}")


def init_train_state(params: Fast3RNet, optim_cfg: OptimConfig,
                     seed: int = 0,
                     compute_dtype: Optional[torch.dtype] = None
                     ) -> TrainState:
    """Zero moments in the params' dtype and device, count 0, step 0; with a
    ``compute_dtype`` other than the params', a working copy of the params
    in it (the master-weights road)."""
    _check_lr_scales(optim_cfg, params)
    named = dict(params.named_parameters())
    work = None
    if compute_dtype is not None and compute_dtype != next(
            params.parameters()).dtype:
        # a copy of the module whose parameters are cast, not copied first
        memo = {id(p): torch.nn.Parameter(p.detach().to(compute_dtype),
                                          requires_grad=p.requires_grad)
                for p in named.values()}
        work = copy.deepcopy(params, memo)
    return TrainState(
        params=params,
        opt_state=AdamWState(
            count=0, mu={k: torch.zeros_like(p) for k, p in named.items()},
            nu={k: torch.zeros_like(p) for k, p in named.items()}),
        step=0, generator=torch.Generator().manual_seed(seed), work=work)


@torch.no_grad()
def refresh_working_copy(state: TrainState) -> None:
    """The working copy set from the master (rounded to its dtype), in
    place; nothing without one."""
    if state.work is None:
        return
    work = dict(state.work.named_parameters())
    master = list(state.params.named_parameters())
    torch._foreach_copy_([work[n] for n, _ in master], [p for _, p in master])


def global_norm(ts: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, fp32."""
    if not ts:
        return torch.zeros(())
    return torch.sqrt(sum(t.float().square().sum() for t in ts))


@torch.no_grad()
def _adamw_update(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
                  state: AdamWState, cfg: OptimConfig, grad_norm: torch.Tensor
                  ) -> None:
    """One AdamW update in place (params and moments), count advanced:
    torch's fused AdamW, one call a learning-rate scale.  It decays the
    param before the Adam step, which is optax's
    ``p - lr (m / (sqrt(v) + eps) + wd p)`` up to rounding."""
    b1, b2 = cfg.betas
    lr = make_schedule(cfg)(state.count)
    state.count += 1
    # optax's clip_by_global_norm: scale to grad_clip unless below it (the
    # fused call divides the gradients by grad_scale)
    grad_scale = None
    if cfg.grad_clip is not None:
        grad_scale = (grad_norm.float() / cfg.grad_clip).clamp(min=1.0)
    scales = dict(cfg.lr_scales or ())
    groups: Dict[float, List[str]] = {}
    for name in params:
        groups.setdefault(scales.get(name.split(".", 1)[0], 1.0),
                          []).append(name)
    for scale, names in groups.items():
        ps = [params[n] for n in names]
        dev = ps[0].device
        count = torch.tensor(float(state.count), device=dev)
        # the fused kernels walk every list's tensors in one layout: the
        # gradients in their param's dtype and strides
        gs = [grads[n] for n in names]
        if any((g.dtype, g.stride()) != (p.dtype, p.stride())
               for g, p in zip(gs, ps)):
            cast = [torch.empty_like(p) for p in ps]
            torch._foreach_copy_(cast, gs)
            gs = cast
        torch._fused_adamw_(
            ps, gs,
            [state.mu[n] for n in names], [state.nu[n] for n in names], [],
            [count] * len(ps), lr=lr * scale, beta1=b1, beta2=b2,
            weight_decay=cfg.weight_decay, eps=ADAM_EPS, amsgrad=False,
            maximize=False,
            grad_scale=None if grad_scale is None else grad_scale.to(dev),
            found_inf=None)


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
    net = state.compute_params
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
        for group, mod in state.params.named_children():
            names = [f"{group}.{k}" for k, _ in mod.named_parameters()]
            metrics[f"watch/grad_norm/{group}"] = global_norm(
                [grads[n] for n in names if n in grads])
            metrics[f"watch/param_norm/{group}"] = global_norm(
                [p for _, p in mod.named_parameters()])
    if finite:
        master = dict(state.params.named_parameters())
        _adamw_update({k: master[k] for k in named}, grads, state.opt_state,
                      optim_cfg, grad_norm)
        refresh_working_copy(state)
    state.step += 1
    return state, metrics
