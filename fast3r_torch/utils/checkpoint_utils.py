"""High-level checkpoint loading.

Counterpart of ``fast3r_tpu/utils/checkpoint_utils.py`` (``load_model``,
``_inference_overrides``, here ``inference.serving_config``, and
``config_to_reference_args``):
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
from fast3r_torch.models.dino_encoder import DinoEncoderConfig
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
    return {**dataclasses.asdict(cfg), "decoder_type": cfg.decoder_type,
            "encoder_type": cfg.encoder_type}


def config_from_dict(d: dict) -> Fast3RConfig:
    """The inverse of :func:`config_to_dict`."""
    def build(cls, fields):
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in fields.items()})

    dec = LlamaDecoderConfig if d["decoder_type"] == "llama" else DecoderConfig
    enc = (DinoEncoderConfig if d.get("encoder_type") == "dino"
           else EncoderConfig)
    return Fast3RConfig(encoder=build(enc, d["encoder"]),
                        decoder=build(dec, d["decoder"]),
                        head=build(DPTHeadConfig, d["head"]),
                        with_local_head=d["with_local_head"])


def config_to_reference_args(cfg: Fast3RConfig) -> dict:
    """A configuration as the reference's ``{encoder,decoder,head}_args``
    (an HF checkpoint's config.json), for every variant: croco | dino
    encoder x ViT | llama decoder; :func:`fast3r_torch.inference.
    config_from_reference_args` reads it back."""
    e, d, h = cfg.encoder, cfg.decoder, cfg.head
    if cfg.encoder_type == "dino":
        encoder_args = {"encoder_type": "dino", "patch_size": e.patch_size,
                        "embed_dim": e.embed_dim, "num_heads": e.num_heads,
                        "depth": e.depth, "mlp_ratio": e.mlp_ratio,
                        "pos_embed_size": e.pos_embed_size}
    else:
        encoder_args = {"encoder_type": "croco", "patch_size": e.patch_size,
                        "patch_embed_cls": e.patch_embed_cls,
                        "embed_dim": e.embed_dim, "num_heads": e.num_heads,
                        "depth": e.depth, "mlp_ratio": e.mlp_ratio,
                        "pos_embed": f"RoPE{e.rope_base:g}",
                        "attn_implementation": "flash_attention"}
    if cfg.decoder_type == "llama":
        decoder_args = {
            "decoder_type": "llama",
            "random_image_idx_embedding": d.random_image_idx_embedding,
            "enc_embed_dim": d.enc_embed_dim, "embed_dim": d.embed_dim,
            "n_layers": d.n_layers, "n_heads": d.n_heads,
            "n_kv_heads": d.n_kv_heads, "multiple_of": d.multiple_of,
            "ffn_dim_multiplier": d.ffn_dim_multiplier,
            "norm_eps": d.norm_eps, "rope_theta": d.rope_theta,
            "max_seq_len": d.max_seq_len, "is_causal": False,
            "depth": d.n_layers}
    else:
        decoder_args = {
            "decoder_type": "fast3r",
            "random_image_idx_embedding": d.random_image_idx_embedding,
            "enc_embed_dim": d.enc_embed_dim, "embed_dim": d.embed_dim,
            "num_heads": d.num_heads, "depth": d.depth,
            "mlp_ratio": d.mlp_ratio, "qkv_bias": d.qkv_bias,
            "attn_implementation": "flash_attention",
            "attn_bias_for_inference_enabled":
                d.attn_bias_for_inference_enabled}
    head_args = {"head_type": "dpt", "output_mode": "pts3d",
                 "depth_mode": list(h.depth_mode),
                 "conf_mode": list(h.conf_mode), "patch_size": h.patch_size,
                 "with_local_head": cfg.with_local_head}
    return {"encoder_args": encoder_args, "decoder_args": decoder_args,
            "head_args": head_args}
