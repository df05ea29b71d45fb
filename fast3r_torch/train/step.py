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

The mesh road (``init_train_state(..., mesh=...)``, a
:class:`MeshTrainState` for :func:`train_step`; the JAX package's sharded
``make_jitted_train_step``): on a ``data x model`` grid of ranks
(``parallel.mesh``) each data rank takes its rows of the global batch;
the dropout seeds and the decoder's image ids are drawn, in the
one-process road's order, for the whole global batch from the one
generator every rank holds (``init_train_state`` seeds it alike on every
rank, and a checkpoint restores it), and each dropout mask is drawn whole
and sliced, so a grid's step is the one-process step on the global batch;
both stacks (any encoder and decoder) run tensor-parallel over the model
group; the loss pools its masked means over the data group; the gradients
are reduce-scattered over the data group into ZeRO-2 shards, on which the
same fused AdamW runs against the rank's fp32 master shard, all-gathered
into the compute copy afterwards.  Norms sum the shards' squares over the
data group and the model-split params' over the model group, counting a
replicated param once; the non-finite guard reads the pooled loss and
norm, so every rank skips together.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

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
    mesh = None                   # one device, no grid of ranks

    @property
    def net(self) -> Fast3RNet:
        """The params the forward and backward run on."""
        return self.params if self.work is None else self.work

    @torch.no_grad()
    def reduce_grads(self, grads: Dict[str, torch.Tensor]):
        """(the gradients AdamW takes, the global gradient norm, the
        ``watch/`` norms) of the step's gradients by name."""
        watch = {}
        for group, mod in self.params.named_children():
            names = [f"{group}.{k}" for k, _ in mod.named_parameters()]
            watch[f"watch/grad_norm/{group}"] = global_norm(
                [grads[n] for n in names if n in grads])
            watch[f"watch/param_norm/{group}"] = global_norm(
                [p for _, p in mod.named_parameters()])
        return grads, global_norm(list(grads.values())), watch

    def apply(self, grads: Dict[str, torch.Tensor], cfg: OptimConfig,
              grad_norm: torch.Tensor) -> None:
        """AdamW on the master, then the working copy refreshed."""
        master = dict(self.params.named_parameters())
        _adamw_update({k: master[k] for k in grads}, grads, self.opt_state,
                      cfg, grad_norm)
        refresh_working_copy(self)

    def whole(self, which: str, to_all: bool = True
              ) -> Dict[str, torch.Tensor]:
        """The master ("master") or a moment ("mu", "nu") by parameter
        name."""
        if which == "master":
            return self.params.state_dict()
        return getattr(self.opt_state, which)

    @torch.no_grad()
    def load_whole(self, params: Dict[str, torch.Tensor],
                   mu: Optional[Dict[str, torch.Tensor]] = None,
                   nu: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """The master (and the working copy) and the moments given set
        from whole tensors by name, in place."""
        self.params.load_state_dict(params)
        refresh_working_copy(self)
        for mine, saved in ((self.opt_state.mu, mu), (self.opt_state.nu, nu)):
            if saved is not None:
                if mine.keys() != saved.keys():
                    raise ValueError("optimizer state of other parameters")
                for k, v in saved.items():
                    mine[k].copy_(v)


def _check_lr_scales(cfg: OptimConfig, params: Fast3RNet) -> None:
    groups = sorted(name for name, _ in params.named_children())
    unknown = sorted(set(dict(cfg.lr_scales or ())) - set(groups))
    if unknown:
        raise ValueError(f"lr_scales keys {unknown} match no top-level param "
                         f"group; available groups: {groups}")


def init_train_state(params: Fast3RNet, optim_cfg: OptimConfig,
                     seed: int = 0,
                     compute_dtype: Optional[torch.dtype] = None,
                     mesh=None, model_cfg: Optional[Fast3RConfig] = None,
                     device=None):
    """Zero moments in the params' dtype and device, count 0, step 0; with a
    ``compute_dtype`` other than the params', a working copy of the params
    in it (the master-weights road).

    With a ``mesh`` (``parallel.mesh``; ``model_cfg`` the model's config)
    ``params`` are the WHOLE model's, the same on every rank so that the
    grid does not change the init: a :class:`MeshTrainState` of this rank's
    slices as its compute copy on ``device`` in ``compute_dtype`` (default:
    the params'), and its ZeRO-2 shards of them in fp32 as the master, zero
    moments beside them."""
    _check_lr_scales(optim_cfg, params)
    generator = torch.Generator().manual_seed(seed)
    if mesh is not None:
        # imported here: fast3r_torch.parallel's package imports this module
        from fast3r_torch.parallel import mesh as mesh_lib

        mesh.check_model_config(model_cfg)
        device = device if device is not None else next(
            params.parameters()).device
        local = mesh_lib.shard_params(params, mesh, model_cfg)
        zero = mesh_lib.zero_init(local, model_cfg, mesh, device)
        return MeshTrainState(
            net=local.to(device=device, dtype=compute_dtype), opt_state=zero,
            mesh=mesh, cfg=model_cfg, step=0, generator=generator)
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
        step=0, generator=generator, work=work)


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


def train_step(state, batch: Dict[str, torch.Tensor],
               model_cfg: Fast3RConfig, optim_cfg: OptimConfig,
               loss_cfg: LossConfig = LossConfig(), remat: bool = True,
               mixed_orientation: bool = False,
               view_ids: Optional[torch.Tensor] = None):
    """One optimisation step on the compute params' device: of a
    :class:`TrainState` on one device, or this rank's part of a grid's step
    (:class:`MeshTrainState`).  Updates ``state`` in place and returns it
    with the metrics.

    batch: imgs (B, V, H, W, 3), true_shapes (B, V, 2), pts3d
    (B, V, H, W, 3), valid_mask (B, V, H, W), camera_pose (B, V, 4, 4);
    tensors or numpy arrays, moved to the params' device (imgs in their
    dtype).  On a grid ``batch`` is this data rank's B rows of the global
    batch of B x data rows (data rank d holding rows d B .. d B + B - 1),
    the same on every model rank of its group.  ``view_ids`` (global B, V)
    replace the decoder image ids drawn from ``state.generator`` (e.g. to
    reproduce another implementation's draw).  Metrics (whole, the same on
    every rank): loss, lr, grad_norm, skipped_nonfinite, the loss details
    and ``watch/grad_norm/{group}``, ``watch/param_norm/{group}``.
    """
    net, mesh = state.net, state.mesh
    p0 = next(net.parameters())
    dev, dt = p0.device, p0.dtype
    b = {k: torch.as_tensor(batch[k]).to(dev) for k in
         ("imgs", "true_shapes", "pts3d", "valid_mask", "camera_pose")}
    pool = None
    if mesh is not None:
        # given ids are the global batch's (the forward draws them so, from
        # the generator every rank holds, after the dropout seeds)
        if view_ids is not None:
            from fast3r_torch.parallel.mesh import batch_rows

            view_ids = view_ids[batch_rows(mesh, view_ids.shape[0])]
        pool = mesh.sum_data
    named = {k: p for k, p in net.named_parameters() if p.requires_grad}

    with torch.enable_grad():
        preds = fast3r_forward(net, model_cfg, b["imgs"].to(dt),
                               b["true_shapes"].cpu(),
                               mixed_orientation=mixed_orientation,
                               view_ids=view_ids, is_training=True,
                               remat=remat, generator=state.generator,
                               mesh=mesh)
        # on a grid this rank's share of the global batch's loss
        loss, details = conf_loss_multiview_v2(b, preds, loss_cfg, pool=pool)
        grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()),
                                                    allow_unused=True)))
    grads = {k: torch.zeros_like(named[k]) if g is None else g
             for k, g in grads.items()}
    loss = loss.detach() if mesh is None else mesh.sum_data(loss)
    grads, grad_norm, watch = state.reduce_grads(grads)
    finite = bool(torch.isfinite(loss)) and bool(torch.isfinite(grad_norm))
    metrics = {"loss": loss, "lr": make_schedule(optim_cfg)(state.step),
               "grad_norm": grad_norm, "skipped_nonfinite": int(not finite),
               **{k: v.detach() for k, v in details.items()}, **watch}
    if finite:
        state.apply(grads, optim_cfg, grad_norm)
    state.step += 1
    return state, metrics


# ---------------------------------------------------------------------------
# the mesh road: data, ZeRO-2 and tensor parallelism
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MeshTrainState:
    """A rank's state on a grid: :class:`TrainState`'s interface over
    ``parallel.mesh``'s model slices and ZeRO-2 shards."""
    net: Fast3RNet                # this rank's compute copy (model slices)
    opt_state: Any                # parallel.mesh.ZeroState: AdamW's count,
    #                               this rank's fp32 master and moment shards
    mesh: Any                     # parallel.mesh.Mesh
    cfg: Fast3RConfig             # the model's (whole shapes)
    step: int
    generator: torch.Generator    # CPU, the same on every rank

    @torch.no_grad()
    def reduce_grads(self, grads: Dict[str, torch.Tensor]):
        """(this rank's gradient shards, reduce-scattered over the data
        group, the global gradient norm, the ``watch/`` norms): norms sum
        the shards' squares over the data group and the model-split
        params' over the model group, a replicated param counted once."""
        from fast3r_torch.parallel import mesh as mesh_lib

        zero = self.opt_state
        shards = mesh_lib.zero_grads(zero, grads, self.mesh)
        gsq = mesh_lib.zero_norms(zero, shards, self.mesh)
        psq = mesh_lib.zero_norms(zero, zero.master, self.mesh)
        dev = next(iter(zero.master.values())).device

        def norm(sq, group=None):
            parts = [v for k, v in sq.items()
                     if group is None or k.split(".", 1)[0] == group]
            return torch.sqrt(sum(parts)) if parts else torch.zeros(
                (), device=dev)

        watch = {}
        for group, _ in self.net.named_children():
            watch[f"watch/grad_norm/{group}"] = norm(gsq, group)
            watch[f"watch/param_norm/{group}"] = norm(psq, group)
        return shards, norm(gsq), watch

    def apply(self, shards: Dict[str, torch.Tensor], cfg: OptimConfig,
              grad_norm: torch.Tensor) -> None:
        """AdamW on the master shards, all-gathered into the compute copy."""
        from fast3r_torch.parallel import mesh as mesh_lib

        zero = self.opt_state
        _adamw_update({k: zero.master[k] for k in shards}, shards, zero, cfg,
                      grad_norm)
        mesh_lib.zero_publish(zero, self.net, self.mesh)

    def whole(self, which: str, to_all: bool = True
              ) -> Optional[Dict[str, torch.Tensor]]:
        """The whole master ("master") or moment ("mu", "nu") by parameter
        name on the CPU, gathered over the grid (every rank calls it): on
        every rank, or with ``to_all`` False on global rank 0 only (None on
        the others)."""
        from fast3r_torch.parallel import mesh as mesh_lib

        local = mesh_lib.zero_gather(self.opt_state, self.mesh, which, to_all)
        if local is None:
            return None
        return mesh_lib.gather_params(local, self.mesh, self.cfg, to_all)

    def load_whole(self, params: Dict[str, torch.Tensor],
                   mu: Optional[Dict[str, torch.Tensor]] = None,
                   nu: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """This rank's slices and shards of whole tensors by name (the
        master, the moments given), and the compute copy, in place."""
        from fast3r_torch.parallel import mesh as mesh_lib

        local = [None if d is None
                 else mesh_lib.shard_params(d, self.mesh, self.cfg)
                 for d in (params, mu, nu)]
        mesh_lib.zero_load(self.opt_state, *local)
        mesh_lib.zero_publish(self.opt_state, self.net, self.mesh)
