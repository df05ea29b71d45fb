"""Training loop: epochs over a loader, validation suites, checkpoint / resume,
requeue on a signal.

Counterpart of ``fast3r_tpu/train/trainer.py`` (``TrainerConfig``,
``Trainer.fit``, ``install_signal_handlers``, ``validate``,
``save_checkpoint`` / ``load_checkpoint``) on one device or, with
``use_mesh``, on a ``data x model`` grid of ranks:

  * per-epoch ``set_epoch`` on the loader (or on its dataset and sampler);
  * :func:`fast3r_torch.train.step.train_step` per batch, the mixed
    orientation flag taken from the batch's true shapes;
  * sample and image counters that sum the batches actually seen, all-reduced
    over the ranks when ``torch.distributed`` is initialised (the JAX
    trainer multiplies the local count by the host count);
  * fp32 params and AdamW moments, as the JAX trainer's; on the card the
    forward and backward run on a bf16 working copy of them
    (``init_train_state(compute_dtype=...)``), refreshed after each update;
  * ``torch.save`` checkpoints of {params, optimizer state, step, generator
    state, epoch, counters}: "last" after every epoch (with the next epoch
    to run, so a resume continues rather than repeats) and
    ``epoch_{epoch:04d}`` every ``ckpt_every_n_epochs``; ``fit`` resumes
    from "last" when it exists;
  * SIGTERM / SIGUSR1 (``install_signal_handlers``) only set a flag; at the
    next step boundary ``fit`` saves "last" and returns (the cluster
    requeue flow);
  * ``model_config.json`` beside the checkpoints, so that
    ``utils.checkpoint_utils.load_model`` serves a run directory;
  * validation (under ``torch.inference_mode``): the mean loss of every
    val loader, the camera-pose suite (RRA / RTA at 5, 15, 30 degrees and
    mAA(30), through ``eval.pose.estimate_camera_poses`` on the params'
    device) on loaders whose dataset is ``Co3d_v2``, and the
    reconstruction suite (``eval.recon.evaluate_reconstruction``:
    accuracy, completion and normal consistency, their medians) on
    ``dtu`` / ``7scenes`` / ``nrgbd``, dispatched as JAX does.

Metrics go through ``utils.logging.MetricLogger``: ``{run_dir}/metrics.csv``
and the sinks of ``TrainerConfig.loggers`` (TensorBoard events under
``{run_dir}/tensorboard`` by default).

The mesh road (``use_mesh``; JAX's ``data_axis`` / ``model_axis``, data
-1 taking all the ranks the model axis leaves): every rank builds the whole
model from the seed and keeps its slices (``parallel.mesh``), so the grid
does not change the init; the state is ``train.step.MeshTrainState``
(ZeRO-2 fp32 master and moment shards, tensor-parallel stacks) behind the
one-device state's interface; every batch is the model group's first
rank's, shared over the group (``Mesh.share_batch``); the parameter
accounting is the whole model's; the counters count data ranks; a stop
signal on any rank stops every rank at the same step; a checkpoint holds
the whole master and moments, gathered to and written by global rank 0
(the file of a one-device run), and loads onto any grid; validation runs
the forward on every model rank and averages over the data ranks.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from fast3r_torch.models.fast3r import (
    Fast3RConfig,
    Fast3RNet,
    fast3r_forward,
    init_fast3r,
)
from fast3r_torch.train.losses import LossConfig, conf_loss_multiview_v2
from fast3r_torch.parallel import mesh as mesh_lib
from fast3r_torch.train.step import OptimConfig, init_train_state, train_step
from fast3r_torch.utils.checkpoint_utils import RUN_CONFIG, config_to_dict
from fast3r_torch.utils.logging import MetricLogger, RankedLogger

log = RankedLogger(__name__)

# the reference's validation_step auto-dispatch (module.py:290-301): pose
# metrics for CO3D batches, reconstruction metrics for the recon sets
POSE_EVAL_DATASETS = frozenset({"Co3d_v2"})
RECON_EVAL_DATASETS = frozenset({"dtu", "7scenes", "nrgbd"})


@dataclasses.dataclass
class TrainerConfig:
    max_epochs: int = 10
    val_every_n_epochs: int = 1
    recon_val_every_n_epochs: int = 5   # reference: every 5th epoch
    ckpt_every_n_epochs: int = 20
    run_dir: str = "runs/default"
    log_every_n_steps: int = 10
    seed: int = 42
    # metric sinks beyond the always-on CSV: "tensorboard" (own event
    # writer); wandb/mlflow/comet/neptune/aim attach if importable
    loggers: Tuple[str, ...] = ("tensorboard",)
    remat: bool = True
    # the grid of ranks: use_mesh=False keeps the one-device road; data -1
    # (or 0, None) takes all the ranks the model axis leaves; model > 1 is
    # tensor parallelism
    use_mesh: bool = False
    data_axis: Optional[int] = -1
    model_axis: int = 1


def _global_count(n: int, mesh=None) -> int:
    """n summed over the data ranks of ``mesh``, else over the ranks (n
    itself without torch.distributed)."""
    if mesh is not None:
        return mesh.count(n)
    if not (torch.distributed.is_available()
            and torch.distributed.is_initialized()):
        return n
    t = torch.tensor([n], dtype=torch.int64)
    if torch.distributed.get_backend() == "nccl":
        t = t.cuda()
    torch.distributed.all_reduce(t)
    return int(t.item())


def _any(flag: bool, mesh=None) -> bool:
    """Whether ``flag`` is set on any rank of ``mesh`` (flag itself
    without one)."""
    return flag if mesh is None else mesh.any(flag)


def _mixed(batch) -> bool:
    ts = np.asarray(batch["true_shapes"])
    return bool((ts[..., 1] < ts[..., 0]).any())


class Trainer:
    def __init__(self, model_cfg: Fast3RConfig, optim_cfg: OptimConfig,
                 loss_cfg: LossConfig = LossConfig(),
                 trainer_cfg: TrainerConfig = TrainerConfig(),
                 params: Optional[Fast3RNet] = None, device="cuda"):
        """``params`` (the master weights AdamW updates) default to
        ``init_fast3r(model_cfg, trainer_cfg.seed)`` in fp32 on ``device``.
        On a CUDA device the forward and backward run on a bf16 working
        copy of them (the card's kernels take bf16), elsewhere on the
        params themselves.  Params handed in bf16 train in bf16, without a
        copy.  With ``use_mesh`` the (whole) params are built on the CPU
        and each rank keeps its slices on ``device``."""
        self.model_cfg = model_cfg
        self.optim_cfg = optim_cfg
        self.loss_cfg = loss_cfg
        self.cfg = trainer_cfg
        os.makedirs(self.cfg.run_dir, exist_ok=True)
        with open(os.path.join(self.cfg.run_dir, RUN_CONFIG), "w") as f:
            json.dump(config_to_dict(model_cfg), f, indent=2)
        self.metrics = MetricLogger(
            os.path.join(self.cfg.run_dir, "metrics.csv"),
            sinks=self.cfg.loggers)
        self.mesh = None
        if self.cfg.use_mesh:
            self.mesh = mesh_lib.make_mesh(self.cfg.data_axis,
                                           self.cfg.model_axis)
            log.info(f"mesh: data={self.mesh.data} x model={self.mesh.model}; "
                     "ZeRO-2 master and moment shards")
        if params is None:
            params = init_fast3r(model_cfg, trainer_cfg.seed, torch.float32,
                                 "cpu" if self.mesh else device)
        on_card = (torch.device(device).type == "cuda" if self.mesh
                   else next(params.parameters()).is_cuda)
        self.state = init_train_state(
            params.train(), optim_cfg, trainer_cfg.seed + 1,
            torch.bfloat16 if on_card else None, mesh=self.mesh,
            model_cfg=model_cfg, device=device)
        # parameter accounting (reference utils/logging_utils.py:18-63), of
        # the whole model on a mesh too
        by_top = {name: sum(p.numel() for p in mod.parameters())
                  for name, mod in params.named_children()}
        log.info("model parameters: total %.1fM (%s)",
                 sum(by_top.values()) / 1e6,
                 ", ".join(f"{k}={v / 1e6:.1f}M"
                           for k, v in sorted(by_top.items())))
        self.epoch = 0
        self.total_samples = 0
        self.total_images = 0
        self._stop_requested = False

    # ---- signal-based requeue (reference SLURMEnvironment auto_requeue) ----
    def install_signal_handlers(self):
        """SIGTERM / SIGUSR1 set a flag; ``fit`` saves "last" at the next
        step boundary and returns.  The handler itself does no I/O.
        :meth:`restore_signal_handlers` puts the previous handlers back."""
        def handler(signum, frame):
            self._stop_requested = True

        self._prev_handlers = {sig: signal.signal(sig, handler)
                               for sig in (signal.SIGTERM, signal.SIGUSR1)}

    def restore_signal_handlers(self):
        for sig, prev in getattr(self, "_prev_handlers", {}).items():
            signal.signal(sig, prev)
        self._prev_handlers = {}

    @property
    def net(self) -> Fast3RNet:
        """The params the forward runs on (this rank's slices on a mesh)."""
        return self.state.net

    def params_state_dict(self) -> Dict[str, torch.Tensor]:
        """The whole master params, ``Fast3RNet``'s state dict (a
        collective on a mesh)."""
        return self.state.whole("master")

    def set_params(self, state_dict: Dict[str, torch.Tensor]) -> None:
        """Replace the master params (and the compute copy) by a whole
        ``Fast3RNet`` state dict, the moments kept (pretrained weights)."""
        self.state.load_whole(state_dict)

    def _share(self, batch):
        """The batch every model rank of a data group runs on."""
        return batch if self.mesh is None else self.mesh.share_batch(batch)

    # ---- checkpointing --------------------------------------------------
    def _ckpt_path(self, name: str) -> str:
        return os.path.join(self.cfg.run_dir, "checkpoints", f"{name}.pt")

    def save_checkpoint(self, name: str = "last") -> str:
        """Write {params, optimizer state, step, generator state, epoch,
        counters}; on a mesh every rank calls it and global rank 0 writes
        the gathered whole, the file of a one-device run."""
        s = self.state
        # gathered to global rank 0 only (None on the other ranks)
        whole = {w: s.whole(w, to_all=False) for w in ("master", "mu", "nu")}
        path = self._ckpt_path(name)
        if whole["master"] is not None:
            blob = {"params": whole["master"],
                    "opt_state": {"count": s.opt_state.count,
                                  "mu": whole["mu"], "nu": whole["nu"]},
                    "step": s.step, "generator": s.generator.get_state(),
                    "epoch": self.epoch, "total_samples": self.total_samples,
                    "total_images": self.total_images}
            os.makedirs(os.path.dirname(path), exist_ok=True)
            t = time.time()
            torch.save(blob, path + ".tmp")
            os.replace(path + ".tmp", path)  # a reader never sees half a file
            log.info(f"saved checkpoint {name!r} at step {s.step} in "
                     f"{time.time() - t:.1f}s")
        _any(False, self.mesh)  # the file is there before any rank goes on
        return path

    def load_checkpoint(self, name: str = "last") -> bool:
        path = self._ckpt_path(name)
        if not os.path.exists(path):
            return False
        s = self.state
        t = time.time()
        # mapped on the host and copied into the state's own tensors (their
        # device and dtype), so the card never holds two copies
        blob = torch.load(path, map_location="cpu", weights_only=True,
                          mmap=True)
        o = blob["opt_state"]
        if not set(o["mu"]) == set(o["nu"]) == set(blob["params"]):
            raise ValueError(f"{path}: optimizer state of other parameters")
        # on a mesh this rank's slices of the whole, onto whatever grid runs
        s.load_whole(blob["params"], o["mu"], o["nu"])
        s.opt_state.count = o["count"]
        s.step = blob["step"]
        s.generator.set_state(blob["generator"].cpu())
        self.epoch = blob["epoch"]
        self.total_samples = blob["total_samples"]
        self.total_images = blob["total_images"]
        log.info(f"resumed from {name!r}: epoch={self.epoch} step={s.step} "
                 f"(read in {time.time() - t:.1f}s)")
        return True

    # ---- train ----------------------------------------------------------
    def fit(self, train_loader, val_loaders: Optional[Dict[str, Any]] = None,
            resume: bool = True,
            on_step: Optional[Callable[[], None]] = None) -> None:
        """Train to ``max_epochs`` (from "last" when ``resume`` finds it);
        ``on_step()`` is called after each step (the CLI's profiler)."""
        if resume:
            self.load_checkpoint("last")
        for epoch in range(self.epoch, self.cfg.max_epochs):
            self.epoch = epoch
            if hasattr(train_loader, "set_epoch"):
                train_loader.set_epoch(epoch)
            else:
                if hasattr(getattr(train_loader, "dataset", None), "set_epoch"):
                    train_loader.dataset.set_epoch(epoch)
                if getattr(train_loader, "sampler", None) is not None:
                    train_loader.sampler.set_epoch(epoch)
            t_epoch = time.time()
            for i, batch in enumerate(train_loader):
                batch = self._share(batch)
                self.state, m = train_step(
                    self.state, batch, self.model_cfg, self.optim_cfg,
                    self.loss_cfg, remat=self.cfg.remat,
                    mixed_orientation=_mixed(batch))
                B, V = np.shape(batch["imgs"])[:2]
                self.total_samples += _global_count(B, self.mesh)
                self.total_images += _global_count(B * V, self.mesh)
                if i % self.cfg.log_every_n_steps == 0:
                    self.metrics.log(
                        step=self.state.step, epoch=epoch,
                        total_samples=self.total_samples,
                        total_images=self.total_images,
                        **{k: float(v) for k, v in m.items()
                           if np.ndim(v) == 0})
                if on_step is not None:
                    on_step()
                # every rank stops together
                self._stop_requested = _any(self._stop_requested, self.mesh)
                if self._stop_requested:
                    self.save_checkpoint("last")
                    log.info("stopping for requeue")
                    return
            log.info(f"epoch {epoch} done in {time.time() - t_epoch:.1f}s "
                     f"(step {self.state.step})")
            if val_loaders and (epoch + 1) % self.cfg.val_every_n_epochs == 0:
                self.validate(val_loaders, epoch)
            # persist the NEXT epoch to run so a resume continues
            self.epoch = epoch + 1
            self.save_checkpoint("last")
            if (epoch + 1) % self.cfg.ckpt_every_n_epochs == 0:
                self.save_checkpoint(f"epoch_{epoch:04d}")

    # ---- validation ------------------------------------------------------
    @torch.inference_mode()
    def validate(self, val_loaders: Dict[str, Any], epoch: int,
                 eval_pose: Optional[Dict[str, Optional[bool]]] = None,
                 eval_recon: Optional[Dict[str, Optional[bool]]] = None,
                 use_pts3d_from_local_head: bool = True
                 ) -> Dict[str, float]:
        """Per-loader val loss and metric suites (inference forward: the
        entropy scale and the image ids of a generator seeded 0).

        Dispatch follows JAX's (the reference's validation_step,
        module.py:290-301): a loader's entry in ``eval_pose`` /
        ``eval_recon`` forces its suite on or off; when it is None (or the
        dict is None) the suite runs when the batch's dataset name holds a
        name of ``POSE_EVAL_DATASETS`` / ``RECON_EVAL_DATASETS``
        (case-insensitive), the recon suite only at epoch 0 and every
        ``recon_val_every_n_epochs``-th epoch (0, 4, 9, ... for 5).
        The recon suite aligns the local head's points to the global
        head's first (``use_pts3d_from_local_head``), or takes the global
        head's; its metrics average into ``val/{name}/recon/{key}``."""
        from fast3r_torch.eval.pose import estimate_camera_poses
        from fast3r_torch.eval.pose_metrics import pose_metrics
        from fast3r_torch.eval.recon import evaluate_reconstruction

        def dispatch(flags, name, batch, auto_names, epoch_ok=True):
            want = flags.get(name) if flags else None
            if want is not None:
                return want
            ds = batch.get("dataset")
            if not (epoch_ok and bool(ds)):
                return False
            ds_name = str(ds[0][0]).lower()
            return any(a.lower() in ds_name for a in auto_names)

        recon_epoch_ok = epoch == 0 or (
            (epoch + 1) % self.cfg.recon_val_every_n_epochs == 0)
        net = self.net
        p0 = next(net.parameters())
        results: Dict[str, float] = {}
        for name, loader in val_loaders.items():
            losses: List[float] = []
            pose_ms, recon_ms = [], []
            suite_matched = False
            for batch in loader:
                batch = self._share(batch)
                b = {k: torch.as_tensor(batch[k]).to(p0.device) for k in
                     ("imgs", "pts3d", "valid_mask", "camera_pose")}
                ts = np.asarray(batch["true_shapes"])
                preds = fast3r_forward(
                    net, self.model_cfg, b["imgs"].to(p0.dtype),
                    torch.as_tensor(ts), mixed_orientation=_mixed(batch),
                    mesh=self.mesh)
                loss, _ = conf_loss_multiview_v2(b, preds, self.loss_cfg)
                losses.append(float(loss))
                pose_on = dispatch(eval_pose, name, batch, POSE_EVAL_DATASETS)
                suite_matched |= bool(pose_on or dispatch(
                    eval_recon, name, batch, RECON_EVAL_DATASETS))
                V = preds["pts3d_in_other_view"].shape[1]
                if pose_on:
                    preds_v = [{k: v[:, i] for k, v in preds.items()}
                               for i in range(V)]
                    # true shapes un-transpose portrait samples' maps
                    # before PnP (correct_preds_orientation)
                    views_v = [{"true_shape": ts[:, i]} for i in range(V)]
                    poses, _ = estimate_camera_poses(preds_v, views=views_v,
                                                     device=p0.device)
                    for i in range(len(poses)):
                        gt = np.asarray(batch["camera_pose"][i])
                        pose_ms.append(pose_metrics(np.stack(poses[i]), gt))
                if dispatch(eval_recon, name, batch, RECON_EVAL_DATASETS,
                            recon_epoch_ok):
                    views_v = [{"pts3d": batch["pts3d"][:, i],
                                "valid_mask": batch["valid_mask"][:, i]}
                               for i in range(V)]
                    preds_v = [{k: v[:, i] for k, v in preds.items()}
                               for i in range(V)]
                    rs = evaluate_reconstruction(
                        views_v, preds_v,
                        use_pts3d_from_local_head=use_pts3d_from_local_head,
                        device=p0.device)
                    recon_ms.extend(r for r in rs if r)
            if losses and not suite_matched:
                log.warning(
                    f"val loader {name!r}: no metric suite dispatched; only "
                    "val loss is recorded for it")
            results[f"val/{name}/loss"] = (float(np.mean(losses)) if losses
                                           else float("nan"))
            for ms, prefix in ((pose_ms, "pose"), (recon_ms, "recon")):
                if ms:
                    for key in ms[0]:
                        results[f"val/{name}/{prefix}/{key}"] = float(
                            np.mean([m[key] for m in ms]))
        if (torch.distributed.is_available()
                and torch.distributed.is_initialized()):
            # the mean over the (data) ranks (JAX: process_allgather +
            # nanmean); a data group's model ranks hold the same results
            group = self.mesh.data_group if self.mesh is not None else None
            gathered = [None] * torch.distributed.get_world_size(group)
            torch.distributed.all_gather_object(gathered, results, group=group)
            results = {k: float(np.nanmean([g[k] for g in gathered]))
                       for k in sorted(results)}
        self.metrics.log(step=self.state.step, epoch=epoch, **results)
        log.info(f"validation @ epoch {epoch}: "
                 + json.dumps({k: round(v, 4) for k, v in results.items()}))
        return results
