"""Move parameters between a ``fast3r_tpu`` parameter tree and the port.

The JAX package keeps params as nested dicts and lists of arrays
(``fast3r_tpu/nn/layers.py`` contract):

  Linear     {"w": (in, out), "b": (out,)}          -> weight (out, in), bias
  LayerNorm  {"scale": (d,), "bias": (d,)}          -> weight, bias
  RMSNorm    {"scale": (d,)}                        -> weight
  Conv       {"w": HWIO (kh, kw, cin, cout), "b"}   -> weight OIHW, bias
  ConvT      {"w": HWIO (k, k, cin, cout), "b"}     -> weight (cin, cout, k, k)
  "blocks", "layers"  (dicts: the ViT and llama stacks) every leaf stacked on
             a leading depth axis                   -> blocks.{i}, layers.{i}
  lists      ("layer_rn", "refinenet")             -> ModuleList index
  "view0_embed"  a bare (d,) leaf of the llama decoder -> the same parameter
  "cls_token", "pos_embed", "ls1", "ls2"  the DINO encoder's bare leaves (the
             LayerScale gammas stacked (depth, d) on both sides) -> the same

Which layout a leaf takes is decided by the port module it lands in, so the
converter needs no table of names: the module path is the JAX key path.
Leaves may be numpy arrays or anything ``numpy.asarray`` accepts.
:func:`params_to_jax` is the inverse (for comparing gradients and updated
params leaf by leaf with the JAX tree).

On a tensor-parallel grid (``parallel.mesh``), ``shard_params`` of
:func:`params_from_jax`'s dict (and the model's config) gives a rank its
slices of a JAX tree, and
:func:`params_to_jax` of ``gather_params`` (the whole tensors from every
model rank's slices) gives the JAX tree back.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from fast3r_torch.nn.layers import RMSNorm

_BARE = ("view0_embed", "cls_token", "pos_embed", "ls1", "ls2")
_LEAF_NAMES = {"w": "weight", "b": "bias", "scale": "weight", "bias": "bias",
               **{k: k for k in _BARE}}
_STACKED = ("blocks", "layers")  # subtrees stacked on a leading depth axis


def _leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, np.ndarray]]:
    """(dotted path, array) for every leaf; stacked subtrees unstacked."""
    if isinstance(tree, dict):
        for key, sub in tree.items():
            path = f"{prefix}{key}"
            if key in _STACKED and isinstance(sub, dict):  # not head lists
                depth = {np.asarray(a).shape[0] for _, a in _leaves(sub)}
                if len(depth) != 1:
                    raise ValueError(f"{path}: leaves disagree on depth {depth}")
                for i in range(depth.pop()):
                    yield from _leaves(_index(sub, i), f"{path}.{i}.")
            else:
                yield from _leaves(sub, path + ".")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _leaves(sub, f"{prefix}{i}.")
    else:
        yield prefix[:-1], np.asarray(tree)


def _index(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_index(v, i) for v in tree]
    return np.asarray(tree)[i]


def _to_port(module: nn.Module, leaf: str, a: np.ndarray) -> np.ndarray:
    if leaf == "w" and isinstance(module, nn.Linear):
        return a.T
    if leaf == "w" and isinstance(module, nn.Conv2d):
        return a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if leaf == "w" and isinstance(module, nn.ConvTranspose2d):
        return a.transpose(2, 3, 0, 1)  # HWIO -> (cin, cout, kh, kw)
    return a


def params_from_jax(tree: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """Float32 state dict of ``Fast3RNet(cfg)`` from the JAX param tree of
    ``fast3r_tpu.models.fast3r.init_fast3r`` for the same configuration.

    Raises if a JAX leaf has no place in the port, if a shape disagrees, or
    if a port parameter is left without a value.
    """
    from fast3r_torch.models.fast3r import Fast3RNet

    with torch.device("meta"):
        net = Fast3RNet(cfg)
    expected = dict(net.state_dict())
    out: Dict[str, torch.Tensor] = {}
    for path, a in _leaves(tree):
        mod_path, _, leaf = path.rpartition(".")
        if leaf not in _LEAF_NAMES:
            raise KeyError(f"unknown JAX leaf {path!r}")
        name = f"{mod_path}.{_LEAF_NAMES[leaf]}" if mod_path else _LEAF_NAMES[leaf]
        if name not in expected:
            raise KeyError(f"JAX leaf {path!r} has no port parameter {name!r}")
        module = net.get_submodule(mod_path)
        t = torch.tensor(_to_port(module, leaf, a), dtype=torch.float32)
        if tuple(t.shape) != tuple(expected[name].shape):
            raise ValueError(f"{path}: shape {tuple(t.shape)} after conversion, "
                             f"port expects {tuple(expected[name].shape)}")
        if name in out:
            raise KeyError(f"two JAX leaves map to {name!r}")
        out[name] = t
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"port parameters without a JAX leaf: {missing[:8]}"
                       f"{' ...' if len(missing) > 8 else ''}")
    return out


def _to_jax(module: nn.Module, leaf: str, a: np.ndarray) -> np.ndarray:
    if leaf == "weight" and isinstance(module, nn.Linear):
        return a.T
    if leaf == "weight" and isinstance(module, nn.Conv2d):
        return a.transpose(2, 3, 1, 0)  # OIHW -> HWIO
    if leaf == "weight" and isinstance(module, nn.ConvTranspose2d):
        return a.transpose(2, 3, 0, 1)  # (cin, cout, kh, kw) -> HWIO
    return a


def _jax_leaf(module: nn.Module, leaf: str) -> str:
    if isinstance(module, (nn.LayerNorm, RMSNorm)):
        return {"weight": "scale", "bias": "bias"}[leaf]
    return {"weight": "w", "bias": "b", **{k: k for k in _BARE}}[leaf]


def params_to_jax(tensors: Dict[str, torch.Tensor], cfg) -> Dict[str, Any]:
    """The ``fast3r_tpu`` param tree (nested dicts and lists of float32
    numpy arrays, block and layer leaves stacked on a leading depth axis)
    of a state dict of ``Fast3RNet(cfg)``, or of any name -> tensor map of
    the same names and shapes (gradients, updated params): the inverse of
    :func:`params_from_jax`."""
    from fast3r_torch.models.fast3r import Fast3RNet

    with torch.device("meta"):
        net = Fast3RNet(cfg)
    tree: Dict[str, Any] = {}
    for name, t in tensors.items():
        mod_path, _, leaf = name.rpartition(".")
        module = net.get_submodule(mod_path)
        a = _to_jax(module, leaf, t.detach().float().cpu().numpy())
        node, parts = tree, mod_path.split(".")
        i = 0
        while i < len(parts):
            key = parts[i]
            if key in _STACKED:  # stacked: collect per block, stack below
                node = node.setdefault(key, {})
                depth_i = int(parts[i + 1])
                i += 2
                path = parts[i:] + [_jax_leaf(module, leaf)]
                node.setdefault(tuple(path), {})[depth_i] = a
                break
            nxt = parts[i + 1] if i + 1 < len(parts) else None
            if nxt is not None and nxt.isdigit():
                lst = node.setdefault(key, [])
                j = int(nxt)
                lst.extend({} for _ in range(j + 1 - len(lst)))
                node = lst[j]
                i += 2
            else:
                node = node.setdefault(key, {})
                i += 1
        else:
            node[_jax_leaf(module, leaf)] = a
    return _stack_blocks(tree)


def _stack_blocks(tree: Any) -> Any:
    """Turn every stacked {(path...): {i: array}} map into nested dicts of
    depth-stacked arrays."""
    if isinstance(tree, list):
        return [_stack_blocks(v) for v in tree]
    if not isinstance(tree, dict):
        return tree
    out: Dict[str, Any] = {}
    for key, sub in tree.items():
        if key in _STACKED:
            stacked: Dict[str, Any] = {}
            for path, per_block in sub.items():
                node = stacked
                for part in path[:-1]:
                    node = node.setdefault(part, {})
                node[path[-1]] = np.stack([per_block[i]
                                           for i in range(len(per_block))])
            out[key] = stacked
        else:
            out[key] = _stack_blocks(sub)
    return out
