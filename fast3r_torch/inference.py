"""Serving entry: the ``Fast3R`` model container, ``inference(views, model)``
and ``inference_from_raw(frames, model)``.

Counterpart of ``fast3r_tpu/inference.py`` (``config_from_reference_args``,
``Fast3R`` with ``from_pretrained``, ``inference``, ``forward_views``,
``_build_varshape_forward``, ``_forward_views_staged`` and
``inference_from_raw``):

    model = Fast3R.from_pretrained(hf_dir, dtype=torch.bfloat16)
    out = inference(load_images(folder, size=512), model)
    # out = {"views": views, "preds": [{pts3d_in_other_view, conf,
    #         pts3d_local, conf_local}, ...], "loss": None}

Each view is a reference-style dict with "img" of shape (1, H, W, 3) or
(1, 3, H, W) and an optional "true_shape" [[h, w]] equal to its stored
shape.  Inference runs the reference's inference configuration: plain patch
embedding at each view's own shape, the fusion decoder over all views' tokens,
both heads at each view's own (H, W).  A request whose views share one shape
runs ``fast3r_forward`` batched over all views; a mixed-shape request encodes
each shape group batched, concatenates the tokens in view order (image ids
repeated by each view's own patch count), runs the decoder over the whole
sequence and the heads per shape group, each on the road its shape takes.
``profiling=True`` runs those three stages with a device synchronisation
after each and returns the reference's ``profiling_info`` keys.  Each
prediction is a float32 CPU tensor with a leading batch axis of 1.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fast3r_torch.models.decoder import (
    DecoderConfig,
    decoder_forward,
    sample_random_image_ids,
)
from fast3r_torch.models.dino_encoder import (
    DinoEncoderConfig,
    dino_encoder_forward,
)
from fast3r_torch.models.dpt_head import DPTHeadConfig, dpt_head_forward
from fast3r_torch.models.encoder import EncoderConfig, encoder_forward
from fast3r_torch.models.fast3r import (
    Fast3RConfig,
    Fast3RNet,
    empty_fast3r,
    fast3r_forward,
    init_fast3r,
)
from fast3r_torch.models.llama_decoder import (
    LlamaDecoderConfig,
    llama_decoder_forward,
)
from fast3r_torch.ops.preprocess import make_plan, preprocess_device
from fast3r_torch.utils.checkpoint import (
    load_state_dict_file,
    params_from_fast3r_checkpoint,
)
from fast3r_torch.utils.convert import params_from_jax


def config_from_reference_args(encoder_args: Dict, decoder_args: Dict,
                               head_args: Dict,
                               attn_impl: str = "pallas") -> Fast3RConfig:
    """A Fast3RConfig from the reference's ``*_args`` dicts (the HF
    checkpoint's config.json, or a ``configs/experiment`` overlay), with
    the JAX package's defaults for missing keys.  ``attn_impl`` is one of
    ``ops.attention.IMPLS`` for the decoder; with "pallas" the encoder
    takes "batched" (both are the attention kernel on CUDA), as
    ``Fast3RConfig.flagship()``.  ``encoder_type: dino`` builds the DINOv2
    ViT-L/14 encoder (its widths overridable, as in the JAX package), whose
    attention takes ``attn_impl`` as given."""
    if encoder_args.get("encoder_type", "croco") == "dino":
        dino = DinoEncoderConfig(
            patch_size=encoder_args.get("patch_size", 14),
            embed_dim=encoder_args.get("embed_dim", 1024),
            depth=encoder_args.get("depth", 24),
            num_heads=encoder_args.get("num_heads", 16),
            mlp_ratio=encoder_args.get("mlp_ratio", 4.0),
            pos_embed_size=encoder_args.get("pos_embed_size", 37),
            attn_impl=attn_impl,
        )
        return _assemble_config(dino, decoder_args, head_args, attn_impl)
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


def _assemble_config(enc, decoder_args: Dict, head_args: Dict,
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

    @classmethod
    def from_pretrained(cls, local_dir: str, dtype=torch.float32,
                        device="cuda", attn_impl: str = "pallas") -> "Fast3R":
        """An HF-format checkpoint directory: config.json (the reference's
        ``*_args``) and model.safetensors or pytorch_model.bin.  A hub id
        is not downloaded: the path must be a local directory."""
        if not os.path.isdir(local_dir):
            raise FileNotFoundError(
                f"{local_dir!r} is not a local checkpoint directory (hub ids "
                "are not downloaded)")
        with open(os.path.join(local_dir, "config.json")) as f:
            hf_cfg = json.load(f)
        cfg = config_from_reference_args(hf_cfg["encoder_args"],
                                         hf_cfg["decoder_args"],
                                         hf_cfg["head_args"], attn_impl)
        net = empty_fast3r(cfg, device="cpu")
        net.load_state_dict(params_from_fast3r_checkpoint(
            load_state_dict_file(local_dir), cfg), strict=True)
        return cls(cfg, net.to(device=device, dtype=dtype))

    def to(self, device=None, dtype=None) -> "Fast3R":
        """A copy of the model on another device and / or in another dtype."""
        clone = empty_fast3r(self.cfg, self.device)
        clone.load_state_dict(self.params.state_dict())
        return Fast3R(self.cfg, clone.to(device=device, dtype=dtype))

    def __call__(self, views: Sequence[Dict], image_ids=None,
                 profiling: bool = False):
        return forward_views(self, views, image_ids=image_ids,
                             profiling=profiling)


def _views_to_arrays(views: Sequence[Dict]
                     ) -> Tuple[List[np.ndarray], List[Tuple[int, int]]]:
    """(1, H, W, 3) float32 channel-last arrays and (h, w) per view; a
    true_shape other than the stored shape raises."""
    imgs, shapes = [], []
    for i, v in enumerate(views):
        img = v["img"]
        img = (img.detach().cpu().float().numpy() if torch.is_tensor(img)
               else np.asarray(img, dtype=np.float32))
        if img.ndim == 4 and img.shape[1] == 3 and img.shape[-1] != 3:
            img = img.transpose(0, 2, 3, 1)  # NCHW -> NHWC
        if img.ndim != 4 or img.shape[0] != 1 or img.shape[-1] != 3:
            raise ValueError(f"view image must be (1, H, W, 3) or (1, 3, H, W), "
                             f"got {img.shape}")
        hw = (img.shape[1], img.shape[2])
        ts = np.asarray(v.get("true_shape", [hw])).reshape(-1)
        if (int(ts[0]), int(ts[1])) != hw:
            raise ValueError(f"view {i}: true_shape {tuple(ts)} differs from "
                             f"its stored shape {hw}")
        imgs.append(img)
        shapes.append(hw)
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


def serving_config(cfg: Fast3RConfig) -> Fast3RConfig:
    """The reference's inference override: plain patch embedding (the
    DINO encoder has no such knob and is served as it is)."""
    if cfg.encoder_type == "dino":
        return cfg
    return dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, patch_embed_cls="PatchEmbedDust3R"))


def _forward_batched(model: Fast3R, imgs: torch.Tensor,
                     image_ids=None) -> Dict[str, torch.Tensor]:
    """(1, V, H, W, 3) same-shape views on the model's device -> outputs
    (V, ...) through ``fast3r_forward``."""
    cfg = serving_config(model.cfg)
    out = fast3r_forward(model.params, cfg, imgs, view_ids=_inference_image_ids(
        cfg, imgs.shape[1], image_ids))
    return {k: v[0] for k, v in out.items()}


def _heads(params: Fast3RNet, cfg: Fast3RConfig, tokens, hw
           ) -> Dict[str, torch.Tensor]:
    g = dpt_head_forward(params.head_global, cfg.head, tokens, hw)
    res = {"pts3d_in_other_view": g["pts3d"], "conf": g["conf"]}
    if cfg.with_local_head:
        loc = dpt_head_forward(params.head_local, cfg.head, tokens, hw)
        res["pts3d_local"], res["conf_local"] = loc["pts3d"], loc["conf"]
    return res


def _forward_staged(model: Fast3R, groups, shapes, image_ids, sync
                    ) -> Tuple[List[Dict[str, torch.Tensor]], Dict[str, float]]:
    """Encoder per shape group, decoder over the whole sequence, heads per
    shape group; ``sync()`` closes each stage and returns its host clock.

    groups: {(h, w): (view indices, (n, h, w, 3) images on the device)}.
    Returns per-view outputs (1, ...) and the stage times."""
    cfg = serving_config(model.cfg)
    params, dev = model.params, model.device
    ps = cfg.encoder.patch_size
    counts = [(h // ps) * (w // ps) for h, w in shapes]
    offsets = np.cumsum([0] + counts)
    V = len(shapes)

    t0 = sync()
    feats: List[Optional[torch.Tensor]] = [None] * V
    for (h, w), (idxs, batch) in groups.items():
        if cfg.encoder_type == "dino":  # the storage shape (JAX's serving)
            f, _ = dino_encoder_forward(params.encoder, cfg.encoder, batch)
        else:
            ts = torch.tensor([h, w], dtype=torch.int32).expand(len(idxs), 2)
            f, _ = encoder_forward(params.encoder, cfg.encoder, batch, ts)
        for j, i in enumerate(idxs):
            feats[i] = f[j:j + 1]
    fused = torch.cat(feats, dim=1)  # (1, S, C)
    t1 = sync()

    repeats = torch.tensor(counts, device=dev)
    ids = _inference_image_ids(cfg, V, image_ids).to(dev).repeat_interleave(
        repeats, dim=1)
    if cfg.decoder_type == "llama":
        order = torch.arange(V, device=dev)[None].repeat_interleave(repeats,
                                                                     dim=1)
        dec_out = llama_decoder_forward(params.decoder, cfg.decoder, fused,
                                        order, rope_ids=ids)
    else:
        dec_out = decoder_forward(params.decoder, cfg.decoder, fused, ids)
    hooks = [dec_out[k] for k in cfg.decoder.hooks]
    t2 = sync()

    preds: List[Optional[Dict[str, torch.Tensor]]] = [None] * V
    for hw, (idxs, _) in groups.items():
        tokens = [torch.cat([t[:, offsets[i]:offsets[i + 1]] for i in idxs])
                  for t in hooks]  # each (n, P, C)
        res = _heads(params, cfg, tokens, hw)
        for j, i in enumerate(idxs):
            preds[i] = {k: v[j:j + 1] for k, v in res.items()}
    t3 = sync()
    info = {"encode_images_time": t1 - t0, "pos_emb_time": 0.0,
            "decoder_time": t2 - t1, "head_forward_time": t3 - t2,
            "total_time": t3 - t0}
    return preds, info


@torch.inference_mode()
def forward_views(model: Fast3R, views: Sequence[Dict], image_ids=None,
                  profiling: bool = False):
    """Run the model on view dicts -> per-view predictions (and, with
    ``profiling``, the stage times), under ``torch.inference_mode``."""
    imgs_np, shapes = _views_to_arrays(views)
    dev = model.device

    def to_dev(idxs):
        return torch.from_numpy(np.concatenate([imgs_np[i] for i in idxs])).to(
            device=dev, dtype=model.dtype)

    def sync() -> float:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    info = None
    if profiling or len(set(shapes)) > 1:
        groups = {}
        for i, s in enumerate(shapes):
            groups.setdefault(s, []).append(i)
        groups = {s: (idxs, to_dev(idxs)) for s, idxs in groups.items()}
        preds, info = _forward_staged(model, groups, shapes, image_ids, sync)
    else:
        out = _forward_batched(model, to_dev(range(len(views)))[None],
                               image_ids)
        preds = [{k: v[i:i + 1] for k, v in out.items()}
                 for i in range(len(views))]
    preds = [{k: _to_host(v.float()) for k, v in p.items()} for p in preds]
    sync()
    return (preds, info) if profiling else preds


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """Copy to the CPU; from a GPU through pinned memory, without waiting
    (the caller synchronises once for all outputs)."""
    if t.device.type == "cpu":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return host.copy_(t, non_blocking=True)


def inference(multiple_views_in_one_sample: Sequence[Dict], model: Fast3R,
              device=None, dtype=None, verbose: bool = True, image_ids=None,
              profiling: bool = False):
    """Reference-compatible entry.

    ``device`` / ``dtype`` move a copy of the model for this call when they
    differ from the model's.  ``image_ids`` (V ints, view 0 first) replace
    the randomly drawn decoder image ids, e.g. to reproduce another
    implementation's draw; for the llama decoder they are the rotary
    index, and its view-0 mask stays on the first view.  ``profiling``
    returns ``(result, profiling_info)``.
    """
    if verbose:
        print(f">> Inference with model on "
              f"{len(multiple_views_in_one_sample)} images")
    if (device is not None
            and torch.device(device).type != model.device.type) or \
            (dtype is not None and dtype != model.dtype):
        model = model.to(device=device or model.device,
                         dtype=dtype or model.dtype)
    out = forward_views(model, multiple_views_in_one_sample,
                        image_ids=image_ids, profiling=profiling)
    preds, info = out if profiling else (out, None)
    result = {"views": list(multiple_views_in_one_sample), "preds": preds,
              "loss": None}
    return (result, info) if profiling else result


@torch.inference_mode()
def inference_from_raw(raw_frames, model: Fast3R, size: int = 512,
                       square_ok: bool = False, verbose: bool = True,
                       image_ids=None):
    """Same-shape raw uint8 frames in, the ``inference`` contract out.

    raw_frames: a (V, H, W, 3) uint8 array or a list of (H, W, 3) uint8
    arrays of one shape (decoded and EXIF-transposed on the host,
    ``utils.image.load_images_raw``).  The resize, crop and normalisation of
    ``load_images`` run on the model's device (``ops.preprocess``); the
    views carry the preprocessed images for colouring."""
    raw = (np.stack([np.asarray(f, np.uint8) for f in raw_frames])
           if isinstance(raw_frames, (list, tuple)) else np.asarray(raw_frames))
    if raw.ndim != 4 or raw.shape[-1] != 3 or raw.dtype != np.uint8:
        raise ValueError(f"raw frames must be (V, H, W, 3) uint8 of one "
                         f"shape, got {raw.shape} {raw.dtype}")
    V, H0, W0 = raw.shape[:3]
    if verbose:
        print(f">> Device-ingest inference on {V} raw frames {W0}x{H0}")
    plan = make_plan((H0, W0), size, square_ok=square_ok)
    imgs = preprocess_device(torch.from_numpy(raw).to(model.device), plan,
                             model.dtype)  # (V, h, w, 3)
    out = _forward_batched(model, imgs[None], image_ids)
    host = {k: _to_host(v.float()) for k, v in out.items()}
    imgs = _to_host(imgs.float())
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    h, w = plan.out_hw
    preds = [{k: v[i:i + 1] for k, v in host.items()} for i in range(V)]
    views = [{"img": imgs[i:i + 1].numpy(), "true_shape": np.int32([[h, w]]),
              "idx": i, "instance": str(i)} for i in range(V)]
    return {"views": views, "preds": preds, "loss": None}
