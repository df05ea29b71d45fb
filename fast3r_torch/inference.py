"""Serving entry: the ``Fast3R`` model container and ``inference(views, model)``.

Counterpart of ``fast3r_tpu/inference.py`` (``config_from_reference_args``,
``Fast3R``, ``inference``, ``forward_views`` and
``_build_varshape_forward``):

    model = Fast3R.from_random(seed=0, dtype=torch.bfloat16, device="cuda")
    out = inference(views, model)
    # out = {"views": views, "preds": [{pts3d_in_other_view, conf,
    #         pts3d_local, conf_local}, ...], "loss": None}

Each view is a reference-style dict with "img" of shape (1, H, W, 3) or
(1, 3, H, W) and an optional "true_shape" [[h, w]].  Inference runs the
reference's inference configuration: plain patch embedding at the views' own
shape, the fusion decoder over all views, both heads at (H, W).  Every view
of a request must have the same shape; mixed-shape requests raise.  Each
prediction is a float32 CPU tensor with a leading batch axis of 1.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fast3r_torch.models.decoder import DecoderConfig, sample_random_image_ids
from fast3r_torch.models.dpt_head import DPTHeadConfig
from fast3r_torch.models.encoder import EncoderConfig
from fast3r_torch.models.fast3r import (
    Fast3RConfig,
    Fast3RNet,
    empty_fast3r,
    fast3r_forward,
    init_fast3r,
)
from fast3r_torch.models.llama_decoder import LlamaDecoderConfig
from fast3r_torch.utils.convert import params_from_jax


def config_from_reference_args(encoder_args: Dict, decoder_args: Dict,
                               head_args: Dict,
                               attn_impl: str = "pallas") -> Fast3RConfig:
    """A Fast3RConfig from the reference's ``*_args`` dicts (the HF
    checkpoint's config.json, or a ``configs/experiment`` overlay), with
    the JAX package's defaults for missing keys.  ``attn_impl`` is one of
    ``ops.attention.IMPLS`` for the decoder; with "pallas" the encoder
    takes "batched" (both are the attention kernel on CUDA), as
    ``Fast3RConfig.flagship()``.  The DINO encoder is not ported: see
    ROADMAP.md, Queue 1 item 7."""
    if encoder_args.get("encoder_type", "croco") == "dino":
        raise NotImplementedError(
            "encoder_type 'dino' is not ported to fast3r_torch (ROADMAP.md, "
            "Queue 1 item 7)")
    enc = EncoderConfig(
        patch_size=encoder_args.get("patch_size", 16),
        patch_embed_cls=encoder_args.get("patch_embed_cls",
                                         "ManyAR_PatchEmbed"),
        embed_dim=encoder_args.get("embed_dim", 1024),
        num_heads=encoder_args.get("num_heads", 16),
        depth=encoder_args.get("depth", 24),
        mlp_ratio=encoder_args.get("mlp_ratio", 4),
        rope_base=float(str(encoder_args.get("pos_embed",
                                             "RoPE100"))[len("RoPE"):]),
        attn_impl="batched" if attn_impl == "pallas" else attn_impl,
        drop=encoder_args.get("drop", 0.0),
        attn_drop=encoder_args.get("attn_drop", 0.0),
        drop_path=encoder_args.get("drop_path", 0.0),
    )
    return _assemble_config(enc, decoder_args, head_args, attn_impl)


def _assemble_config(enc: EncoderConfig, decoder_args: Dict, head_args: Dict,
                     attn_impl: str) -> Fast3RConfig:
    if decoder_args.get("decoder_type", "fast3r") == "llama":
        dec = LlamaDecoderConfig(
            enc_embed_dim=decoder_args.get("enc_embed_dim", enc.embed_dim),
            embed_dim=decoder_args.get("embed_dim", 1024),
            n_layers=decoder_args.get("n_layers", 24),
            n_heads=decoder_args.get("n_heads", 16),
            n_kv_heads=decoder_args.get("n_kv_heads"),
            multiple_of=decoder_args.get("multiple_of", 256),
            ffn_dim_multiplier=decoder_args.get("ffn_dim_multiplier"),
            norm_eps=decoder_args.get("norm_eps", 1e-5),
            rope_theta=decoder_args.get("rope_theta", 10000.0),
            max_seq_len=decoder_args.get("max_seq_len", 1000),
            random_image_idx_embedding=decoder_args.get(
                "random_image_idx_embedding", True),
            attn_impl=attn_impl,
        )
    else:
        dec = DecoderConfig(
            enc_embed_dim=decoder_args.get("enc_embed_dim", enc.embed_dim),
            embed_dim=decoder_args.get("embed_dim", 768),
            num_heads=decoder_args.get("num_heads", 12),
            depth=decoder_args.get("depth", 12),
            mlp_ratio=decoder_args.get("mlp_ratio", 4.0),
            qkv_bias=decoder_args.get("qkv_bias", True),
            random_image_idx_embedding=decoder_args.get(
                "random_image_idx_embedding", True),
            attn_bias_for_inference_enabled=decoder_args.get(
                "attn_bias_for_inference_enabled", True),
            attn_impl=attn_impl,
            drop=decoder_args.get("drop", 0.0),
            attn_drop=decoder_args.get("attn_drop", 0.0),
            drop_path=decoder_args.get("drop_path", 0.0),
        )
    conf_mode = head_args.get("conf_mode", ("exp", 1, float("inf")))
    head = DPTHeadConfig(
        patch_size=head_args.get("patch_size", 16),
        num_channels=3 + bool(conf_mode),
        dim_tokens=(enc.embed_dim, dec.embed_dim, dec.embed_dim,
                    dec.embed_dim),
        depth_mode=tuple(head_args.get("depth_mode",
                                       ("exp", -float("inf"), float("inf")))),
        conf_mode=tuple(conf_mode),
    )
    return Fast3RConfig(encoder=enc, decoder=dec, head=head,
                        with_local_head=head_args.get("with_local_head",
                                                      False))


class Fast3R:
    """Parameters (a ``Fast3RNet``) plus their config, device and dtype."""

    def __init__(self, cfg: Fast3RConfig, params: Fast3RNet):
        self.cfg = cfg
        self.params = params.eval()

    @property
    def device(self) -> torch.device:
        return next(self.params.parameters()).device

    @property
    def dtype(self) -> torch.dtype:
        return next(self.params.parameters()).dtype

    @classmethod
    def from_random(cls, cfg: Optional[Fast3RConfig] = None, seed: int = 0,
                    dtype=torch.float32, device="cuda") -> "Fast3R":
        """Random weights from ``seed`` (``models.fast3r.init_fast3r``);
        the flagship configuration by default."""
        cfg = cfg or Fast3RConfig.flagship()
        return cls(cfg, init_fast3r(cfg, seed, dtype, device))

    @classmethod
    def from_jax_params(cls, tree, cfg: Fast3RConfig, dtype=torch.float32,
                        device="cuda") -> "Fast3R":
        """Weights from a ``fast3r_tpu`` param tree of numpy arrays."""
        net = empty_fast3r(cfg, device="cpu")
        net.load_state_dict(params_from_jax(tree, cfg), strict=True)
        return cls(cfg, net.to(device=device, dtype=dtype))

    def to(self, device=None, dtype=None) -> "Fast3R":
        """A copy of the model on another device and / or in another dtype."""
        clone = empty_fast3r(self.cfg, self.device)
        clone.load_state_dict(self.params.state_dict())
        return Fast3R(self.cfg, clone.to(device=device, dtype=dtype))

    def __call__(self, views: Sequence[Dict], image_ids=None):
        return forward_views(self, views, image_ids=image_ids)


def _views_to_arrays(views: Sequence[Dict]
                     ) -> Tuple[List[np.ndarray], List[Tuple[int, int]]]:
    """(1, H, W, 3) float32 channel-last arrays and true (h, w) per view."""
    imgs, shapes = [], []
    for v in views:
        img = v["img"]
        img = (img.detach().cpu().float().numpy() if torch.is_tensor(img)
               else np.asarray(img, dtype=np.float32))
        if img.ndim == 4 and img.shape[1] == 3 and img.shape[-1] != 3:
            img = img.transpose(0, 2, 3, 1)  # NCHW -> NHWC
        if img.ndim != 4 or img.shape[0] != 1 or img.shape[-1] != 3:
            raise ValueError(f"view image must be (1, H, W, 3) or (1, 3, H, W), "
                             f"got {img.shape}")
        imgs.append(img)
        ts = np.asarray(v.get("true_shape", [[img.shape[1], img.shape[2]]]))
        shapes.append((int(ts.reshape(-1)[0]), int(ts.reshape(-1)[1])))
    return imgs, shapes


def _inference_image_ids(cfg: Fast3RConfig, num_views: int,
                         image_ids=None) -> torch.Tensor:
    """(1, V) view ids: random (view 0 pinned to 0) from a generator seeded 0
    when the decoder uses random ids, else arange; ``image_ids`` overrides."""
    if image_ids is not None:
        ids = torch.tensor(np.asarray(image_ids), dtype=torch.int32)
        return ids.reshape(1, num_views)
    if cfg.decoder.random_image_idx_embedding:
        return sample_random_image_ids(None, 1, num_views)
    return torch.arange(num_views, dtype=torch.int32)[None]


@torch.inference_mode()
def forward_views(model: Fast3R, views: Sequence[Dict],
                  image_ids=None) -> List[Dict[str, torch.Tensor]]:
    """Run the model on same-shape view dicts -> per-view predictions, under
    ``torch.inference_mode`` (no autograd state)."""
    imgs_np, shapes = _views_to_arrays(views)
    found = {im.shape[1:3] for im in imgs_np} | set(shapes)
    if len(found) != 1:
        raise NotImplementedError(
            "fast3r_torch.inference serves requests whose views all share "
            f"one shape (stored and true); got {sorted(found)} (mixed-shape "
            "requests: see ROADMAP)")
    V = len(imgs_np)
    imgs = torch.from_numpy(np.concatenate(imgs_np))[None].to(
        device=model.device, dtype=model.dtype)  # (1, V, H, W, 3)
    cfg = dataclasses.replace(
        model.cfg, encoder=dataclasses.replace(
            model.cfg.encoder, patch_embed_cls="PatchEmbedDust3R"))
    out = fast3r_forward(model.params, cfg, imgs,
                         view_ids=_inference_image_ids(cfg, V, image_ids))
    host = {k: _to_host(v[0].float()) for k, v in out.items()}  # (V, ...)
    if model.device.type == "cuda":
        torch.cuda.current_stream(model.device).synchronize()
    return [{k: v[i:i + 1] for k, v in host.items()} for i in range(V)]


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """Copy to the CPU; from a GPU through pinned memory, without waiting
    (the caller synchronises once for all outputs)."""
    if t.device.type == "cpu":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return host.copy_(t, non_blocking=True)


def inference(multiple_views_in_one_sample: Sequence[Dict], model: Fast3R,
              device=None, dtype=None, verbose: bool = True, image_ids=None):
    """Reference-compatible entry.

    ``device`` / ``dtype`` move a copy of the model for this call when they
    differ from the model's.  ``image_ids`` (V ints, view 0 first) replace
    the randomly drawn decoder image ids, e.g. to reproduce another
    implementation's draw; for the llama decoder they are the rotary
    index, and its view-0 mask stays on the first view.
    """
    if verbose:
        print(f">> Inference with model on "
              f"{len(multiple_views_in_one_sample)} images")
    if (device is not None
            and torch.device(device).type != model.device.type) or \
            (dtype is not None and dtype != model.dtype):
        model = model.to(device=device or model.device,
                         dtype=dtype or model.dtype)
    preds = forward_views(model, multiple_views_in_one_sample,
                          image_ids=image_ids)
    return {"views": list(multiple_views_in_one_sample), "preds": preds,
            "loss": None}
