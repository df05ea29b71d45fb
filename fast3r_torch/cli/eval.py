"""Evaluation entry point.

Counterpart of ``fast3r_tpu/cli/eval.py`` (reference fast3r/eval.py:54-139):
reload the config from the run's snapshot (or the default train.yaml for an
HF-format checkpoint), merge an eval preset and dotted overrides, load the
model and run validation (the loss, and the pose / recon suites) over the
configured validation datasets.

    python -m fast3r_torch.cli.eval --run-dir runs/flagship \
        [--checkpoint last] [--device cuda|cpu] [key=value ...]
    python -m fast3r_torch.cli.eval --hf-checkpoint CKPT_DIR \
        --eval-config ablation_recon_better_inference_hp \
        data.data_root=/data

The model evaluates on the card in bfloat16 (the fused kernels' type)
unless ``--device cpu`` is given (float32, every op on its plain version);
without a GPU the default raises torch's own error.  Each process loads
``data.batch_size_per_device`` samples a batch; where the caller has
initialised ``torch.distributed``, the loaders slice the data by rank and
the batch over the ranks is JAX's ``batch_size_per_device *
jax.device_count()``.  Metrics go to
``{run_dir}/eval/metrics.csv`` for a run directory (the run's own files
stay as they are) and to ``eval_out/`` for an HF-format checkpoint; the
results dict is printed as JSON and returned.
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    ap = argparse.ArgumentParser(description="Evaluate Fast3R (PyTorch)")
    ap.add_argument("--run-dir", default=None)
    ap.add_argument("--hf-checkpoint", default=None)
    ap.add_argument("--checkpoint", default="last")
    ap.add_argument("--eval-pose", action="store_true",
                    help="run pose metrics on every dataset")
    ap.add_argument("--eval-recon", action="store_true",
                    help="run reconstruction metrics on every dataset")
    ap.add_argument("--eval-config", default=None,
                    help="eval preset from fast3r_torch/configs/eval/ "
                         "(eval_cam_pose, ablation_recon_better_inference_hp, "
                         "ablation_recon_without_local_head, "
                         "ablation_varying_test_views): the reference's "
                         "configs/eval groups")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    if not (args.run_dir or args.hf_checkpoint):
        ap.error("need --run-dir or --hf-checkpoint")

    import torch
    import yaml

    from fast3r_torch.config import (
        CONFIG_DIR,
        _resolve_interpolations,
        deep_merge,
        load_config,
        loss_config_from_dict,
        parse_override,
        set_dotted,
    )
    from fast3r_torch.data.datamodule import MultiViewDataModule
    from fast3r_torch.train.step import OptimConfig
    from fast3r_torch.train.trainer import Trainer, TrainerConfig
    from fast3r_torch.utils.checkpoint_utils import load_model

    if args.run_dir:
        # the run's config snapshot is the source of truth (eval.py:69-83)
        with open(os.path.join(args.run_dir, "config.yaml")) as f:
            cfg = yaml.safe_load(f)
    else:
        cfg = load_config(os.path.join(CONFIG_DIR, "train.yaml"))
    if args.eval_config:
        with open(os.path.join(CONFIG_DIR, "eval",
                               args.eval_config + ".yaml")) as f:
            cfg = deep_merge(cfg, yaml.safe_load(f) or {})
    for ov in args.overrides:
        k, v = parse_override(ov)
        set_dotted(cfg, k, v)
    cfg = _resolve_interpolations(cfg)

    device = torch.device(args.device, torch.cuda.current_device()
                          if args.device == "cuda" else None)
    dtype = torch.bfloat16 if args.device == "cuda" else torch.float32
    model = load_model(args.run_dir or args.hf_checkpoint, dtype=dtype,
                       device=device, ckpt_name=args.checkpoint)
    trainer = Trainer(
        model.cfg, OptimConfig(), loss_config_from_dict(cfg.get("loss", {})),
        TrainerConfig(run_dir=(os.path.join(args.run_dir, "eval")
                               if args.run_dir else "eval_out"),
                      remat=False),
        params=model.params, device=device)

    data_cfg = cfg.get("data", {})
    dm = MultiViewDataModule(
        validation_datasets=data_cfg.get("validation_datasets", []),
        batch_size_per_device=data_cfg.get("batch_size_per_device", 1),
        num_workers_val=data_cfg.get("num_workers_val", 0),
    )
    val_loaders = dm.val_dataloaders()
    try:
        # the suites auto-dispatch per dataset name inside validate (the
        # reference's validation_step, module.py:290-301); the flags and an
        # `eval:` preset key force a suite on (True) or off (False)
        eval_cfg = cfg.get("eval", {})
        pose_ov = True if args.eval_pose else eval_cfg.get("pose")
        recon_ov = True if args.eval_recon else eval_cfg.get("recon")
        results = trainer.validate(
            val_loaders, epoch=0,
            eval_pose={name: pose_ov for name in val_loaders},
            eval_recon={name: recon_ov for name in val_loaders},
            use_pts3d_from_local_head=cfg.get("model", {}).get(
                "eval_use_pts3d_from_local_head", True))
    finally:
        for loader in val_loaders.values():
            loader.close()
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
