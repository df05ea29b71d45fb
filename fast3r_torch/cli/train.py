"""Training entry point.

Counterpart of ``fast3r_tpu/cli/train.py`` (reference fast3r/train.py:57-147:
config composition, seeding, datamodule / model / trainer instantiation, fit
with optional resume).  Usage:

    python -m fast3r_torch.cli.train [--config path] [--experiment name] \
        [--resume | --no-resume] [--distributed] [--profile-dir DIR] \
        [--device cuda|cpu] [key=value ...]

The run trains on the card unless ``--device cpu`` is given: fp32 params
and AdamW moments on either device, as the JAX trainer's; on the card the
forward and backward run on a bf16 working copy of the params (its
kernels take bf16), on the CPU in fp32 (every op on its plain version).
Without a GPU the default raises torch's own error.  ``--distributed``
joins the process group of a ``torchrun`` launch (NCCL on the card, gloo
on the CPU), one device per process; with more than one rank the trainer
takes its mesh road (``parallel:``: ``data_axis``, -1 for all the ranks
the model axis leaves, and ``model_axis``, tensor parallelism when above
1): one model trained on the global batch, ZeRO-2 optimizer shards.  The
batch per process is ``data.batch_size_per_device``; the samplers slice
the data by data rank, and every model rank of a data group steps on its
first model rank's batch (the trainer shares it: an unseeded dataset's
crops and jitter differ from process to process).
``--profile-dir`` records a ``torch.profiler`` trace of PROFILE_STEPS
training steps there, after one skipped step and one warm-up step.
``pretrained:`` names an HF-format checkpoint directory or a fast3r_torch
run directory whose weights replace the random ones (unless a resume
finds "last").  The resolved config is written to
``{run_dir}/config.yaml``.
"""

from __future__ import annotations

import argparse
import os

PROFILE_STEPS = 3  # steps recorded by --profile-dir, after 1 skipped, 1 warm-up


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train Fast3R (PyTorch)")
    default_cfg = os.path.join(os.path.dirname(__file__), "..", "configs",
                               "train.yaml")
    parser.add_argument("--config", default=default_cfg)
    parser.add_argument("--experiment", default=None)
    parser.add_argument("--resume", action="store_true", default=True)
    parser.add_argument("--no-resume", dest="resume", action="store_false")
    parser.add_argument("--distributed", action="store_true",
                        help="torch.distributed.init_process_group from the "
                             "torchrun environment")
    parser.add_argument("--profile-dir", default=None,
                        help="record a torch.profiler trace of the first "
                             "training steps into this directory")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("overrides", nargs="*",
                        help="dotted config overrides: a.b.c=value")
    args = parser.parse_args(argv)

    import torch

    from fast3r_torch.parallel.mesh import grid_shape

    if args.distributed:
        # a torchrun launch: MASTER_ADDR / MASTER_PORT / RANK / WORLD_SIZE
        # in the environment; one card per process
        if args.device == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        torch.distributed.init_process_group(
            backend="nccl" if args.device == "cuda" else "gloo")

    from fast3r_torch.config import (
        load_config,
        loss_config_from_dict,
        model_config_from_dict,
        optim_config_from_dict,
        save_config,
    )
    from fast3r_torch.data.datamodule import MultiViewDataModule
    from fast3r_torch.train.trainer import Trainer, TrainerConfig
    from fast3r_torch.utils.logging import RankedLogger

    log = RankedLogger("fast3r_torch.train")
    cfg = load_config(args.config, args.experiment, args.overrides)

    run_dir = cfg.get("paths", {}).get("run_dir", "runs/default")
    run_dir = run_dir.replace("${task_name}", cfg.get("task_name", "default"))
    save_config(cfg, run_dir)
    device = torch.device(args.device, torch.cuda.current_device()
                          if args.device == "cuda" else None)
    log.info(f"run dir: {run_dir}; device: {device}")

    model_cfg = model_config_from_dict(cfg["model"])
    optim_cfg = optim_config_from_dict(cfg.get("optim", {}))
    loss_cfg = loss_config_from_dict(cfg.get("loss", {}))
    tcfg_d = cfg.get("trainer", {})
    par = cfg.get("parallel", {}) or {}
    world = (torch.distributed.get_world_size() if args.distributed else 1)
    data_axis, model_axis = grid_shape(par.get("data_axis", -1),
                                       par.get("model_axis", 1), world)
    if data_axis * model_axis != world:
        raise ValueError(f"parallel: data_axis {data_axis} x model_axis "
                         f"{model_axis} != {world} ranks")
    trainer_cfg = TrainerConfig(
        max_epochs=tcfg_d.get("max_epochs", 10),
        val_every_n_epochs=tcfg_d.get("val_every_n_epochs", 1),
        recon_val_every_n_epochs=tcfg_d.get("recon_val_every_n_epochs", 5),
        ckpt_every_n_epochs=tcfg_d.get("ckpt_every_n_epochs", 20),
        run_dir=run_dir,
        log_every_n_steps=tcfg_d.get("log_every_n_steps", 10),
        seed=cfg.get("seed", 42),
        remat=tcfg_d.get("remat", True),
        use_mesh=world > 1, data_axis=data_axis, model_axis=model_axis,
    )

    data_cfg = cfg.get("data", {})
    dm = MultiViewDataModule(
        train_datasets=data_cfg.get("train_datasets", []),
        validation_datasets=data_cfg.get("validation_datasets", []),
        batch_size_per_device=data_cfg.get("batch_size_per_device", 1),
        num_workers=data_cfg.get("num_workers", 4),
        num_workers_val=data_cfg.get("num_workers_val", 0),
        # the data ranks: global rank = data rank * model_axis + model rank
        world_size=data_axis,
        rank=(torch.distributed.get_rank() if args.distributed else 0)
        // model_axis,
    )
    train_loader = dm.train_dataloader()
    val_loaders = dm.val_dataloaders()
    trainer = None
    try:
        # the loader's workers import and unpickle while the model builds
        if train_loader is not None:
            train_loader.start()
        trainer = Trainer(model_cfg, optim_cfg, loss_cfg, trainer_cfg,
                          device=device)
        trainer.install_signal_handlers()

        pretrained = cfg.get("pretrained")
        if pretrained and not (args.resume and os.path.exists(
                trainer._ckpt_path("last"))):
            from fast3r_torch.utils.checkpoint_utils import load_model

            log.info(f"loading pretrained weights from {pretrained}")
            trainer.set_params(
                load_model(pretrained, device="cpu").params.state_dict())

        if args.profile_dir:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if args.device == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            # only the first steps: a whole run's events would pile up in
            # host memory until the fit's end
            with torch.profiler.profile(
                    activities=acts,
                    schedule=torch.profiler.schedule(
                        wait=1, warmup=1, active=PROFILE_STEPS, repeat=1),
                    on_trace_ready=torch.profiler.tensorboard_trace_handler(
                        args.profile_dir)) as prof:
                trainer.fit(train_loader, val_loaders, resume=args.resume,
                            on_step=prof.step)
        else:
            trainer.fit(train_loader, val_loaders, resume=args.resume)
    except Exception:
        # the reference's task_wrapper logs the exception before re-raising
        # (utils/utils.py:49-100) so cluster logs always show the cause
        log.exception("training failed")
        raise
    finally:
        if trainer is not None:
            trainer.restore_signal_handlers()
        # stop the loader workers and reclaim their shared-memory blocks
        for loader in [train_loader, *val_loaders.values()]:
            if loader is not None:
                loader.close()
    log.info("training complete")
    return trainer


if __name__ == "__main__":
    main()
