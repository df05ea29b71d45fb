"""YAML config system: composition + experiment overlays + CLI overrides.

Replaces the reference's Hydra tree (configs/train.yaml with defaults,
``# @package _global_`` experiment overlays, configs snapshot into the run dir
— SURVEY.md §5.6) with a small explicit loader:

  * ``load_config(base, experiment=..., overrides=[...])`` deep-merges a base
    yaml, an optional experiment yaml, and ``a.b.c=value`` CLI overrides
    (values parsed with ast.literal_eval, falling back to string);
  * the resolved config is snapshotted into the run dir (``config.yaml``) and
    is the source of truth for later eval/demo loads (the reference reads the
    run's .hydra/config.yaml, eval.py:69-83);
  * NO eval(): dataset strings use fast3r_torch.data.dsl.

Builders below map config dicts onto the typed model/optim dataclasses.
Counterpart of ``fast3r_tpu/config.py``; the yaml files are the port's own
copies (``fast3r_torch/configs``).  ``attn_impl: xla`` (the JAX package's
plain attention) maps to the port's plain attention, ``naive``.
"""

from __future__ import annotations

import ast
import copy
import os
from typing import Any, Dict, List, Optional, Sequence

import yaml

from fast3r_torch.inference import config_from_reference_args
from fast3r_torch.models.fast3r import Fast3RConfig
from fast3r_torch.train.losses import LossConfig
from fast3r_torch.train.step import OptimConfig

CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "configs")
# JAX attention implementations -> the port's (ops.attention.IMPLS): the
# configs' "xla" (XLA's own attention in the JAX package) takes the port's
# kernel roads, as "pallas" does (the encoder "batched", the decoder the
# attention kernel): on the card every attention is a hand-written kernel
ATTN_IMPLS = {"xla": "pallas"}


def deep_merge(base: Dict, overlay: Dict) -> Dict:
    out = copy.deepcopy(base)
    for k, v in overlay.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def set_dotted(cfg: Dict, dotted: str, value: Any) -> None:
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def parse_override(s: str):
    key, _, raw = s.partition("=")
    try:
        value = ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        value = raw
    return key, value


def _get_dotted(cfg: Dict, dotted: str):
    node = cfg
    for k in dotted.split("."):
        node = node[k]
    return node


_ALLOWED_EVAL_NODES = (
    ast.Expression, ast.BinOp, ast.UnaryOp, ast.Constant,
    ast.Add, ast.Sub, ast.Mult, ast.Div, ast.FloorDiv, ast.Mod, ast.Pow,
    ast.USub, ast.UAdd,
)


def _safe_arith_eval(expr: str):
    """Arithmetic-only evaluator for ${python_eval:"..."} (the reference
    registers an OmegaConf resolver that eval()s arbitrary code,
    train.py:48-54; here only literals and + - * / // % ** are allowed)."""
    tree = ast.parse(expr.strip(), mode="eval")
    for node in ast.walk(tree):
        if not isinstance(node, _ALLOWED_EVAL_NODES):
            raise ValueError(
                f"python_eval only supports arithmetic, got {ast.dump(node)}")
    return eval(compile(tree, "<python_eval>", "eval"))  # noqa: S307 — vetted


_INTERP_RE = None


def _resolve_interpolations(cfg: Dict) -> Dict:
    """Resolve ${a.b.c} references and ${python_eval:"expr"} in string values
    (the reference's OmegaConf interpolation, e.g.
    window_size=${python_eval:"${data.num_views} * 2"})."""
    import re

    global _INTERP_RE
    if _INTERP_RE is None:
        _INTERP_RE = re.compile(
            r"\$\{python_eval:\s*\"([^\"]*)\"\s*\}|\$\{([A-Za-z0-9_.]+)\}")

    def resolve_str(s: str):
        for _ in range(10):  # nested references resolve inside-out per pass
            def sub(m):
                if m.group(1) is not None:
                    body = m.group(1)
                    if "${" in body:  # resolve inner plain refs first
                        body = re.sub(
                            r"\$\{([A-Za-z0-9_.]+)\}",
                            lambda i: str(_get_dotted(cfg, i.group(1))), body)
                        return '${python_eval:"' + body + '"}'
                    return str(_safe_arith_eval(body))
                return str(_get_dotted(cfg, m.group(2)))

            # a string that IS a single reference keeps its native type
            full = _INTERP_RE.fullmatch(s)
            if full is not None and full.group(2) is not None:
                v = _get_dotted(cfg, full.group(2))
                if not isinstance(v, str):
                    return v
            if (full is not None and full.group(1) is not None
                    and "${" not in full.group(1)):
                return _safe_arith_eval(full.group(1))
            new = _INTERP_RE.sub(sub, s)
            if new == s:
                return s
            s = new
        return s

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, str) and "${" in node:
            return resolve_str(node)
        return node

    return walk(cfg)


def _load_overlay(path: str, exp_root: str, _seen=None) -> Dict:
    """Load one experiment yaml, resolving its ``extends:`` chain first (the
    reference's Hydra ``defaults: - group/default`` composition,
    configs/experiment/data_scaling/data_scaling_0.25.yaml:3-4).  ``extends``
    is a name or list of names resolved relative to the file's directory,
    falling back to the experiment root."""
    _seen = _seen or set()
    real = os.path.realpath(path)
    if real in _seen:
        raise ValueError(f"extends cycle through {path}")
    _seen.add(real)
    with open(path) as f:
        overlay = yaml.safe_load(f) or {}
    parents = overlay.pop("extends", None)
    if parents is None:
        return overlay
    if isinstance(parents, str):
        parents = [parents]
    merged: Dict = {}
    for name in parents:
        cand = [name, name + ".yaml"] if name.endswith(".yaml") else [
            name + ".yaml"]
        for c in list(cand):
            cand.append(os.path.join(os.path.dirname(path), c))
            cand.append(os.path.join(exp_root, c))
        parent_path = next((c for c in cand if os.path.exists(c)), None)
        if parent_path is None:
            raise FileNotFoundError(f"extends target {name!r} (from {path})")
        merged = deep_merge(merged, _load_overlay(parent_path, exp_root,
                                                  _seen))
    return deep_merge(merged, overlay)


def load_config(
    base_path: str,
    experiment: Optional[str] = None,
    overrides: Sequence[str] = (),
) -> Dict:
    with open(base_path) as f:
        cfg = yaml.safe_load(f) or {}
    exp_root = os.path.join(os.path.dirname(base_path), "experiment")
    if experiment:
        exp_path = experiment
        if not os.path.exists(exp_path):
            exp_path = os.path.join(exp_root, experiment + ".yaml")
        cfg = deep_merge(cfg, _load_overlay(exp_path, exp_root))
    for ov in overrides:
        key, value = parse_override(ov)
        set_dotted(cfg, key, value)
    return _resolve_interpolations(cfg)


def save_config(cfg: Dict, run_dir: str) -> str:
    os.makedirs(run_dir, exist_ok=True)
    path = os.path.join(run_dir, "config.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    return path


# ---------------------------------------------------------------------------
# typed builders
# ---------------------------------------------------------------------------

def model_config_from_dict(model_cfg: Dict) -> Fast3RConfig:
    """Accepts the reference's net args layout (encoder_args/decoder_args/
    head_args, configs/model/fast3r.yaml)."""
    impl = model_cfg.get("attn_impl", "xla")
    return config_from_reference_args(
        model_cfg.get("encoder_args", {}),
        model_cfg.get("decoder_args", {}),
        model_cfg.get("head_args", {}),
        attn_impl=ATTN_IMPLS.get(impl, impl),
    )


def optim_config_from_dict(d: Dict) -> OptimConfig:
    return OptimConfig(
        lr=float(d.get("lr", 1e-4)),
        betas=tuple(d.get("betas", (0.9, 0.95))),
        weight_decay=float(d.get("weight_decay", 0.05)),
        warmup_steps=int(d.get("warmup_steps", 1000)),
        total_steps=int(d.get("total_steps", 100_000)),
        eta_min=float(d.get("eta_min", 1e-6)),
        grad_clip=d.get("grad_clip"),
        lr_scales=(tuple(sorted(
            (str(k), float(v)) for k, v in d["lr_scales"].items()))
            if d.get("lr_scales") else None),
    )


def loss_config_from_dict(d: Dict) -> LossConfig:
    return LossConfig(
        alpha=float(d.get("alpha", 0.2)),
        norm_mode=d.get("norm_mode", "avg_dis"),
        gt_scale=bool(d.get("gt_scale", False)),
        local_scale_consistent=bool(d.get("local_scale_consistent", False)),
        with_local=bool(d.get("with_local", True)),
    )
