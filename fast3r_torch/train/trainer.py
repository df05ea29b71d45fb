"""Training loop: epochs over a loader, validation loss, checkpoint / resume.

Counterpart of ``fast3r_tpu/train/trainer.py`` (``TrainerConfig``,
``Trainer.fit``, ``validate``, ``save_checkpoint`` / ``load_checkpoint``) on
one device:

  * per-epoch ``set_epoch`` on the loader (or on its dataset and sampler);
  * :func:`fast3r_torch.train.step.train_step` per batch, the mixed
    orientation flag taken from the batch's true shapes;
  * sample and image counters that sum the batches actually seen, all-reduced
    over the ranks when ``torch.distributed`` is initialised (the JAX
    trainer multiplies the local count by the host count);
  * ``torch.save`` checkpoints of {params, optimizer state, step, generator
    state, epoch, counters}: "last" after every epoch (with the next epoch
    to run, so a resume continues rather than repeats) and
    ``epoch_{epoch:04d}`` every ``ckpt_every_n_epochs``; ``fit`` resumes
    from "last" when it exists;
  * ``model_config.json`` beside the checkpoints, so that
    ``utils.checkpoint_utils.load_model`` serves a run directory;
  * validation: the mean loss of every val loader.  The pose and
    reconstruction suites wait for the eval modules.

Metrics go to ``{run_dir}/metrics.jsonl``, one JSON object per logged step.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from fast3r_torch.models.fast3r import (
    Fast3RConfig,
    Fast3RNet,
    fast3r_forward,
    init_fast3r,
)
from fast3r_torch.train.losses import LossConfig, conf_loss_multiview_v2
from fast3r_torch.train.step import (
    AdamWState,
    OptimConfig,
    init_train_state,
    train_step,
)
from fast3r_torch.utils.checkpoint_utils import RUN_CONFIG, config_to_dict


@dataclasses.dataclass
class TrainerConfig:
    max_epochs: int = 10
    val_every_n_epochs: int = 1
    ckpt_every_n_epochs: int = 20
    run_dir: str = "runs/default"
    log_every_n_steps: int = 10
    seed: int = 42
    remat: bool = True


def _global_count(n: int) -> int:
    """n summed over the ranks (n itself without torch.distributed)."""
    if not (torch.distributed.is_available()
            and torch.distributed.is_initialized()):
        return n
    t = torch.tensor([n], dtype=torch.int64)
    if torch.distributed.get_backend() == "nccl":
        t = t.cuda()
    torch.distributed.all_reduce(t)
    return int(t.item())


def _mixed(batch) -> bool:
    ts = np.asarray(batch["true_shapes"])
    return bool((ts[..., 1] < ts[..., 0]).any())


class Trainer:
    def __init__(self, model_cfg: Fast3RConfig, optim_cfg: OptimConfig,
                 loss_cfg: LossConfig = LossConfig(),
                 trainer_cfg: TrainerConfig = TrainerConfig(),
                 params: Optional[Fast3RNet] = None, device="cuda",
                 dtype=torch.bfloat16):
        """``params`` default to ``init_fast3r(model_cfg, trainer_cfg.seed)``
        in ``dtype`` on ``device`` (the card's kernels train bf16 params)."""
        self.model_cfg = model_cfg
        self.optim_cfg = optim_cfg
        self.loss_cfg = loss_cfg
        self.cfg = trainer_cfg
        os.makedirs(self.cfg.run_dir, exist_ok=True)
        with open(os.path.join(self.cfg.run_dir, RUN_CONFIG), "w") as f:
            json.dump(config_to_dict(model_cfg), f, indent=2)
        if params is None:
            params = init_fast3r(model_cfg, trainer_cfg.seed, dtype, device)
        self.state = init_train_state(params.train(), optim_cfg,
                                      trainer_cfg.seed + 1)
        self.epoch = 0
        self.total_samples = 0
        self.total_images = 0

    # ---- checkpointing --------------------------------------------------
    def _ckpt_path(self, name: str) -> str:
        return os.path.join(self.cfg.run_dir, "checkpoints", f"{name}.pt")

    def save_checkpoint(self, name: str = "last") -> str:
        s = self.state
        blob = {"params": s.params.state_dict(),
                "opt_state": {"count": s.opt_state.count,
                              "mu": s.opt_state.mu, "nu": s.opt_state.nu},
                "step": s.step, "generator": s.generator.get_state(),
                "epoch": self.epoch, "total_samples": self.total_samples,
                "total_images": self.total_images}
        path = self._ckpt_path(name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save(blob, path + ".tmp")
        os.replace(path + ".tmp", path)  # a reader never sees half a file
        return path

    def load_checkpoint(self, name: str = "last") -> bool:
        path = self._ckpt_path(name)
        if not os.path.exists(path):
            return False
        s = self.state
        dev = next(s.params.parameters()).device
        blob = torch.load(path, map_location=dev, weights_only=True)
        s.params.load_state_dict(blob["params"])
        o = blob["opt_state"]
        s.opt_state = AdamWState(count=o["count"], mu=o["mu"], nu=o["nu"])
        s.step = blob["step"]
        s.generator.set_state(blob["generator"].cpu())
        self.epoch = blob["epoch"]
        self.total_samples = blob["total_samples"]
        self.total_images = blob["total_images"]
        return True

    # ---- train ----------------------------------------------------------
    def _log(self, record: Dict[str, Any]) -> None:
        with open(os.path.join(self.cfg.run_dir, "metrics.jsonl"), "a") as f:
            f.write(json.dumps(record) + "\n")

    def fit(self, train_loader, val_loaders: Optional[Dict[str, Any]] = None,
            resume: bool = True) -> None:
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
            for i, batch in enumerate(train_loader):
                self.state, m = train_step(
                    self.state, batch, self.model_cfg, self.optim_cfg,
                    self.loss_cfg, remat=self.cfg.remat,
                    mixed_orientation=_mixed(batch))
                B, V = np.shape(batch["imgs"])[:2]
                self.total_samples += _global_count(B)
                self.total_images += _global_count(B * V)
                if i % self.cfg.log_every_n_steps == 0:
                    self._log({
                        "step": self.state.step, "epoch": epoch,
                        "total_samples": self.total_samples,
                        "total_images": self.total_images,
                        **{k: float(v) for k, v in m.items()
                           if np.ndim(v) == 0}})
            if val_loaders and (epoch + 1) % self.cfg.val_every_n_epochs == 0:
                self.validate(val_loaders, epoch)
            # persist the NEXT epoch to run so a resume continues
            self.epoch = epoch + 1
            self.save_checkpoint("last")
            if (epoch + 1) % self.cfg.ckpt_every_n_epochs == 0:
                self.save_checkpoint(f"epoch_{epoch:04d}")

    # ---- validation ------------------------------------------------------
    @torch.no_grad()
    def validate(self, val_loaders: Dict[str, Any],
                 epoch: int) -> Dict[str, float]:
        """Mean validation loss per loader (inference forward: the entropy
        scale and the image ids of a generator seeded 0)."""
        net = self.state.params
        p0 = next(net.parameters())
        results = {}
        for name, loader in val_loaders.items():
            losses = []
            for batch in loader:
                b = {k: torch.as_tensor(batch[k]).to(p0.device) for k in
                     ("imgs", "pts3d", "valid_mask", "camera_pose")}
                preds = fast3r_forward(
                    net, self.model_cfg, b["imgs"].to(p0.dtype),
                    torch.as_tensor(batch["true_shapes"]),
                    mixed_orientation=_mixed(batch))
                loss, _ = conf_loss_multiview_v2(b, preds, self.loss_cfg)
                losses.append(float(loss))
            results[f"val/{name}/loss"] = (float(np.mean(losses)) if losses
                                           else float("nan"))
        self._log({"step": self.state.step, "epoch": epoch, **results})
        return results
