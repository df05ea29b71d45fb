"""Reference-format Fast3R checkpoints -> the port's parameters.

Counterpart of ``fast3r_tpu/utils/checkpoint.py`` (``fast3r_key_map``,
``llama_decoder_entries``, ``dino_encoder_entries``, ``_variant_key_map``,
``torch_state_dict_to_params`` / ``params_from_fast3r_checkpoint``, and the
way back, ``fast3r_params_to_state_dict`` / ``params_to_torch_state_dict``,
with ``load_dust3r_checkpoint_partial``).  The
published weights are a torch state dict of the reference module tree
(``encoder.* decoder.* downstream_head.* downstream_head_local.*``, keys
optionally prefixed ``net.`` by Lightning).  Each entry of the key map names
a reference tensor prefix, the JAX package's parameter path and a kind.
The port's parameter names are those paths joined with dots, and its
layouts are the reference's own (Linear (out, in), Conv OIHW, ConvTranspose
(in, out, kh, kw)), so the mapping renames and never transposes.

``load_state_dict_file`` reads ``model.safetensors`` with a reader of its
own (the format is an 8-byte little-endian header length, a JSON header,
then raw little-endian tensors), or ``pytorch_model.bin`` / ``model.pt`` /
``model.pth`` through ``torch.load(weights_only=True)``.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Tuple, Union

import torch
from torch import nn

Entry = Tuple[str, Tuple, str]  # (reference prefix, JAX path, kind)

_SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16,
                       "BF16": torch.bfloat16}


def _block_entries(prefix: str, path: Tuple) -> List[Entry]:
    """One ViT block's tensors."""
    return [(f"{prefix}{t}", path + j, kind) for t, j, kind in (
        ("norm1", ("norm1",), "ln"), ("attn.qkv", ("attn", "qkv"), "linear"),
        ("attn.proj", ("attn", "proj"), "linear"), ("norm2", ("norm2",), "ln"),
        ("mlp.fc1", ("mlp", "fc1"), "linear"),
        ("mlp.fc2", ("mlp", "fc2"), "linear"))]


def _head_entries(tkey: str, jkey: str) -> List[Entry]:
    """DPT head tensors."""
    p = f"{tkey}.dpt."
    out: List[Entry] = [
        (p + "act_postprocess.0.0", (jkey, "act1", "proj"), "conv"),
        (p + "act_postprocess.0.1", (jkey, "act1", "up"), "convT"),
        (p + "act_postprocess.1.0", (jkey, "act2", "proj"), "conv"),
        (p + "act_postprocess.1.1", (jkey, "act2", "up"), "convT"),
        (p + "act_postprocess.2.0", (jkey, "act3", "proj"), "conv"),
        (p + "act_postprocess.3.0", (jkey, "act4", "proj"), "conv"),
        (p + "act_postprocess.3.1", (jkey, "act4", "down"), "conv"),
    ]
    for i in range(4):
        out.append((p + f"scratch.layer{i + 1}_rn", (jkey, "layer_rn", i),
                    "conv_nobias"))
        rp = p + f"scratch.refinenet{i + 1}."
        jp = (jkey, "refinenet", i)
        out += [
            (rp + "resConfUnit1.conv1", jp + ("rcu1", "conv1"), "conv"),
            (rp + "resConfUnit1.conv2", jp + ("rcu1", "conv2"), "conv"),
            (rp + "resConfUnit2.conv1", jp + ("rcu2", "conv1"), "conv"),
            (rp + "resConfUnit2.conv2", jp + ("rcu2", "conv2"), "conv"),
            (rp + "out_conv", jp + ("out_conv",), "conv"),
        ]
    out += [(p + "head.0", (jkey, "head", "conv1"), "conv"),
            (p + "head.2", (jkey, "head", "conv2"), "conv"),
            (p + "head.4", (jkey, "head", "conv3"), "conv")]
    return out


def _encoder_entries(depth: int) -> List[Entry]:
    entries: List[Entry] = [
        ("encoder.patch_embed.proj", ("encoder", "patch_embed"), "conv"),
        ("encoder.enc_norm", ("encoder", "norm"), "ln"),
    ]
    for i in range(depth):
        entries += _block_entries(f"encoder.enc_blocks.{i}.",
                                  ("encoder", "blocks", i))
    return entries


def fast3r_key_map(enc_depth: int, dec_depth: int,
                   with_local_head: bool) -> List[Entry]:
    """The entries of the CroCo encoder + ViT decoder model, in the JAX
    package's order (the stems first, then the blocks, then the heads)."""
    entries: List[Entry] = [
        ("encoder.patch_embed.proj", ("encoder", "patch_embed"), "conv"),
        ("encoder.enc_norm", ("encoder", "norm"), "ln"),
        ("decoder.decoder_embed", ("decoder", "decoder_embed"), "linear"),
        ("decoder.dec_norm", ("decoder", "norm"), "ln"),
    ]
    for i in range(enc_depth):
        entries += _block_entries(f"encoder.enc_blocks.{i}.",
                                  ("encoder", "blocks", i))
    for i in range(dec_depth):
        entries += _block_entries(f"decoder.dec_blocks.{i}.",
                                  ("decoder", "blocks", i))
    return entries + _head_pair(with_local_head)


def _head_pair(with_local_head: bool) -> List[Entry]:
    return (_head_entries("downstream_head", "head_global")
            + (_head_entries("downstream_head_local", "head_local")
               if with_local_head else []))


def llama_decoder_entries(n_layers: int) -> List[Entry]:
    """The llama fusion decoder's tensors; ``tensor`` entries are raw
    parameters (no .weight suffix), RMSNorm weights take the ``ln`` kind."""
    entries: List[Entry] = [
        ("decoder.view0_embed", ("decoder", "view0_embed"), "tensor"),
        ("decoder.decoder_embed", ("decoder", "decoder_embed"), "linear"),
        ("decoder.norm", ("decoder", "norm"), "ln"),
    ]
    for i in range(n_layers):
        p, pa = f"decoder.layers.{i}.", ("decoder", "layers", i)
        entries += [(p + t, pa + j, kind) for t, j, kind in (
            ("attention_norm", ("attention_norm",), "ln"),
            ("attention.wq", ("attn", "wq"), "linear"),
            ("attention.wk", ("attn", "wk"), "linear"),
            ("attention.wv", ("attn", "wv"), "linear"),
            ("attention.wo", ("attn", "wo"), "linear"),
            ("ffn_norm", ("ffn_norm",), "ln"),
            ("feed_forward.w1", ("ffn", "w1"), "linear"),
            ("feed_forward.w2", ("ffn", "w2"), "linear"),
            ("feed_forward.w3", ("ffn", "w3"), "linear"))]
    return entries


def dino_encoder_entries(depth: int) -> List[Entry]:
    """The DINO encoder's tensors: the reference wraps a torch hub DINOv2
    ViT as ``encoder.model``; each block's LayerScale gamma is a ``tensor``
    entry of path (encoder, ls1 | ls2, i), stacked on the depth axis of the
    port's ``encoder.ls1`` / ``encoder.ls2``."""
    pre = "encoder.model."
    entries: List[Entry] = [
        (pre + "patch_embed.proj", ("encoder", "patch_embed"), "conv"),
        (pre + "cls_token", ("encoder", "cls_token"), "tensor"),
        (pre + "pos_embed", ("encoder", "pos_embed"), "tensor"),
        (pre + "norm", ("encoder", "norm"), "ln"),
    ]
    for i in range(depth):
        entries += _block_entries(f"{pre}blocks.{i}.", ("encoder", "blocks", i))
        entries += [(f"{pre}blocks.{i}.ls1.gamma", ("encoder", "ls1", i),
                     "tensor"),
                    (f"{pre}blocks.{i}.ls2.gamma", ("encoder", "ls2", i),
                     "tensor")]
    return entries


def _variant_key_map(cfg) -> List[Entry]:
    """The entries of a Fast3RConfig: croco | dino encoder x ViT | llama
    decoder."""
    if cfg.encoder_type == "dino":
        entries = dino_encoder_entries(cfg.encoder.depth)
    else:
        entries = _encoder_entries(cfg.encoder.depth)
    if cfg.decoder_type == "llama":
        entries += llama_decoder_entries(cfg.decoder.n_layers)
    else:
        entries += [
            ("decoder.decoder_embed", ("decoder", "decoder_embed"), "linear"),
            ("decoder.dec_norm", ("decoder", "norm"), "ln"),
        ]
        for i in range(cfg.decoder.depth):
            entries += _block_entries(f"decoder.dec_blocks.{i}.",
                                      ("decoder", "blocks", i))
    return entries + _head_pair(cfg.with_local_head)


def params_from_fast3r_checkpoint(state_dict: Dict[str, torch.Tensor], cfg,
                                  strip_net_prefix: bool = True
                                  ) -> Dict[str, torch.Tensor]:
    """Float32 state dict of ``Fast3RNet(cfg)`` from a reference state dict
    (tensors or anything ``torch.as_tensor`` takes).  Reference tensors
    outside the map (the DPT's ``layer_rn`` aliases) are ignored; a missing
    one raises."""
    sd = {}
    for k, v in state_dict.items():
        if strip_net_prefix and k.startswith("net."):
            k = k[len("net."):]
        sd[k] = v
    out: Dict[str, torch.Tensor] = {}
    stacks: Dict[str, Dict[int, torch.Tensor]] = {}
    for prefix, path, kind in _variant_key_map(cfg):
        if kind == "tensor" and isinstance(path[-1], int):  # LayerScale
            if prefix not in sd:
                raise KeyError(f"missing checkpoint tensor {prefix}")
            stacks.setdefault(".".join(path[:-1]), {})[path[-1]] = \
                torch.as_tensor(sd[prefix]).to(torch.float32)
            continue
        name = ".".join(map(str, path))
        keys = ({"": prefix} if kind == "tensor" else
                {".weight": prefix + ".weight", ".bias": prefix + ".bias"})
        for suffix, key in keys.items():
            if key not in sd:
                if suffix == ".bias":
                    continue  # conv_nobias, RMSNorm, bias-free linears
                raise KeyError(f"missing checkpoint tensor {key}")
            out[name + suffix] = torch.as_tensor(sd[key]).to(torch.float32)
    for name, rows in stacks.items():
        out[name] = torch.stack([rows[i] for i in range(len(rows))])
    return out


Params = Union[nn.Module, Dict[str, torch.Tensor]]


def _named(params: Params) -> Dict[str, torch.Tensor]:
    """name -> tensor of a ``Fast3RNet`` (its state dict) or of a dict."""
    return dict(params.state_dict() if isinstance(params, nn.Module)
                else params)


def _export(params: Params, entries: List[Entry]) -> Dict[str, torch.Tensor]:
    """The reference state dict of the port's params by ``entries``: CPU
    copies of the tensors under the reference's keys (a LayerScale gamma,
    a row of ``encoder.ls1`` / ``ls2``), then the DPT's ``layer_rn``
    aliases."""
    named = _named(params)
    sd: Dict[str, torch.Tensor] = {}
    for prefix, path, kind in entries:
        if kind == "tensor" and isinstance(path[-1], int):  # LayerScale
            sd[prefix] = named[".".join(path[:-1])][path[-1]].detach().cpu(
                ).clone()
            continue
        name = ".".join(map(str, path))
        keys = ({"": prefix} if kind == "tensor" else
                {".weight": prefix + ".weight", ".bias": prefix + ".bias"})
        for suffix, key in keys.items():
            if name + suffix in named:
                sd[key] = named[name + suffix].detach().cpu().clone()
    # the reference DPT holds scratch.layer{i}_rn in a scratch.layer_rn
    # ModuleList too, so its state_dict() carries both spellings of the
    # same tensors: emit both, so that the export strict-loads there
    for key in list(sd):
        m = re.match(r"(.*scratch\.)layer(\d)_rn(\..*)", key)
        if m:
            sd[f"{m.group(1)}layer_rn.{int(m.group(2)) - 1}{m.group(3)}"] = \
                sd[key]
    return sd


def fast3r_params_to_state_dict(params: Params, cfg
                                ) -> Dict[str, torch.Tensor]:
    """The reference state dict of any Fast3RConfig variant's params (a
    ``Fast3RNet`` or its state dict): the inverse of
    :func:`params_from_fast3r_checkpoint`, with the DPT ``layer_rn``
    aliases, for export."""
    return _export(params, _variant_key_map(cfg))


def params_to_torch_state_dict(params: Params, enc_depth: int,
                               dec_depth: int, with_local_head: bool
                               ) -> Dict[str, torch.Tensor]:
    """The reference state dict of the CroCo encoder + ViT decoder model's
    params, keyed in :func:`fast3r_key_map`'s order, with the DPT
    ``layer_rn`` aliases."""
    return _export(params, fast3r_key_map(enc_depth, dec_depth,
                                          with_local_head))


def load_dust3r_checkpoint_partial(params: Params,
                                   state_dict: Dict[str, torch.Tensor],
                                   enc_depth: int, load_head: bool = True
                                   ) -> Dict[str, torch.Tensor]:
    """Params initialised from a pairwise DUSt3R checkpoint (the
    reference's ``load_from_dust3r_checkpoint``): ``patch_embed.proj``,
    ``enc_blocks.{i}`` and ``enc_norm`` go to the encoder and, with
    ``load_head``, ``downstream_head1`` to ``head_global``; everything else
    keeps its values.  An entry whose weight is missing, or whose tensors
    have no parameter of their shape, is skipped (the reference's
    ``strict=False``).  Returns a new name -> tensor dict (CPU copies,
    loaded tensors in their parameter's dtype)."""
    out = {k: v.detach().cpu().clone() for k, v in _named(params).items()}
    entries: List[Entry] = [
        ("patch_embed.proj", ("encoder", "patch_embed"), "conv"),
        ("enc_norm", ("encoder", "norm"), "ln"),
    ]
    for i in range(enc_depth):
        entries += _block_entries(f"enc_blocks.{i}.", ("encoder", "blocks", i))
    if load_head:
        entries += [(t.replace("downstream_head.", "downstream_head1."), p, k)
                    for t, p, k in _head_entries("downstream_head",
                                                 "head_global")]
    for prefix, path, _ in entries:
        if prefix + ".weight" not in state_dict:
            continue
        name = ".".join(map(str, path))
        got = {name + suffix: torch.as_tensor(state_dict[prefix + suffix])
               for suffix in (".weight", ".bias")
               if prefix + suffix in state_dict}
        if all(k in out and out[k].shape == v.shape for k, v in got.items()):
            for k, v in got.items():
                out[k] = v.to(out[k].dtype).clone()
    return out


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of a ``.safetensors`` file (F32, F16 or BF16), read with
    ``torch.frombuffer`` from one copy of the file."""
    with open(path, "rb") as f:
        blob = bytearray(f.read())
    n = int.from_bytes(blob[:8], "little")
    header = json.loads(blob[8:8 + n].decode("utf-8"))
    base = 8 + n
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES.get(meta["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name} has dtype "
                             f"{meta['dtype']}, not one of "
                             f"{sorted(_SAFETENSORS_DTYPES)}")
        begin, end = meta["data_offsets"]
        count = (end - begin) // dtype.itemsize
        t = (torch.frombuffer(blob, dtype=dtype, count=count,
                              offset=base + begin) if count
             else torch.empty(0, dtype=dtype))
        out[name] = t.reshape(meta["shape"])
    return out


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """The reference state dict under an HF-format directory."""
    st = os.path.join(path, "model.safetensors")
    if os.path.exists(st):
        return read_safetensors(st)
    for name in ("pytorch_model.bin", "model.pt", "model.pth"):
        p = os.path.join(path, name)
        if os.path.exists(p):
            sd = torch.load(p, map_location="cpu", weights_only=True)
            return sd.get("state_dict", sd)
    raise FileNotFoundError(f"no weights file found under {path}")
