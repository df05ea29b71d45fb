"""High-level checkpoint loading.

Counterpart of ``fast3r_tpu/utils/checkpoint_utils.py`` (``load_model``,
``_inference_overrides``, here ``inference.serving_config``):
``load_model`` accepts an HF-format directory (config.json + weights) or a
run directory of the port's ``train/trainer.py`` (model_config.json,
written by :func:`config_to_dict`, + checkpoints/{name}.pt; the training
CLI also writes config.yaml there) in the ``dtype`` asked for (a run's
fp32 master weights serve in bf16 on the card), and applies the
reference's inference override (plain patch embedding).  A fast3r_tpu run directory (config.yaml
and an orbax checkpoint, no checkpoints/{name}.pt) raises.
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch

from fast3r_torch.inference import Fast3R, serving_config
from fast3r_torch.models.decoder import DecoderConfig
from fast3r_torch.models.dpt_head import DPTHeadConfig
from fast3r_torch.models.encoder import EncoderConfig
from fast3r_torch.models.fast3r import Fast3RConfig, empty_fast3r
from fast3r_torch.models.llama_decoder import LlamaDecoderConfig

RUN_CONFIG = "model_config.json"


def load_model(checkpoint_dir: str, dtype=torch.float32, device="cuda",
               ckpt_name: str = "last") -> Fast3R:
    """A Fast3R model from an HF-format directory or a port run directory."""
    run_ckpt = os.path.join(checkpoint_dir, "checkpoints", f"{ckpt_name}.pt")
    if (os.path.exists(os.path.join(checkpoint_dir, "config.yaml"))
            and not os.path.exists(run_ckpt)):
        raise ValueError(
            f"{checkpoint_dir} is a fast3r_tpu run directory (orbax "
            "checkpoint); export it with fast3r_tpu's "
            "convert_checkpoint_to_hf and load the exported directory")
    if os.path.exists(run_ckpt):
        with open(os.path.join(checkpoint_dir, RUN_CONFIG)) as f:
            cfg = serving_config(config_from_dict(json.load(f)))
        net = empty_fast3r(cfg, device="cpu")
        # mapped, not read: only the params are touched, not the optimizer
        # moments beside them (two more copies of the weights)
        blob = torch.load(run_ckpt, map_location="cpu", weights_only=True,
                          mmap=True)
        net.load_state_dict(blob["params"], strict=True)
        return Fast3R(cfg, net.to(device=device, dtype=dtype))
    model = Fast3R.from_pretrained(checkpoint_dir, dtype=dtype, device=device)
    model.cfg = serving_config(model.cfg)
    return model


def config_to_dict(cfg: Fast3RConfig) -> dict:
    """Every field of a configuration, JSON-ready."""
    return {**dataclasses.asdict(cfg), "decoder_type": cfg.decoder_type}


def config_from_dict(d: dict) -> Fast3RConfig:
    """The inverse of :func:`config_to_dict`."""
    def build(cls, fields):
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in fields.items()})

    dec = LlamaDecoderConfig if d["decoder_type"] == "llama" else DecoderConfig
    return Fast3RConfig(encoder=build(EncoderConfig, d["encoder"]),
                        decoder=build(dec, d["decoder"]),
                        head=build(DPTHeadConfig, d["head"]),
                        with_local_head=d["with_local_head"])
