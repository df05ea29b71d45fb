"""Safe parser for the dataset-algebra DSL.

The reference ``eval()``s strings like
``"80_000 @ Co3d_Multiview(split='train', resolution=[(512,384)], ...)"``
(dust3r/datasets/__init__.py:33-34) — arbitrary code execution from config.
Here the same grammar is parsed with the ast module and restricted to:

  expr    := expr '+' expr | INT '@' expr | INT '*' expr | call
  call    := NAME '(' [INT ','] kwarg (',' kwarg)* ')'
  kwarg   := NAME '=' literal            (literals via ast.literal_eval)

Dataset names resolve against the registry populated by
fast3r_torch.data.datasets (register_dataset / DATASET_REGISTRY).  Counterpart
of ``fast3r_tpu/data/dsl.py``.
"""

from __future__ import annotations

import ast
from typing import Any, Callable, Dict

DATASET_REGISTRY: Dict[str, Callable] = {}


def register_dataset(cls=None, *, name: str = None):
    """Class decorator / function: register a dataset constructor for the DSL."""
    def wrap(c):
        DATASET_REGISTRY[name or c.__name__] = c
        return c

    if cls is None:
        return wrap
    return wrap(cls)


def _check_registered(name: str) -> None:
    if name not in DATASET_REGISTRY:
        raise KeyError(f"unknown dataset {name!r}; registered: "
                       f"{sorted(DATASET_REGISTRY)}")


def _build(node: ast.AST):
    if isinstance(node, ast.BinOp):
        if isinstance(node.op, ast.Add):
            return _build(node.left) + _build(node.right)
        if isinstance(node.op, ast.MatMult):
            n = _literal(node.left)
            assert isinstance(n, int), f"left of @ must be int, got {n!r}"
            return n @ _build(node.right)
        if isinstance(node.op, ast.Mult):
            n = _literal(node.left)
            assert isinstance(n, int), f"left of * must be int, got {n!r}"
            return n * _build(node.right)
        raise ValueError(f"unsupported operator {ast.dump(node.op)}")
    if isinstance(node, ast.Call):
        assert isinstance(node.func, ast.Name), "dataset call must be a name"
        name = node.func.id
        _check_registered(name)
        args = [_literal(a) for a in node.args]
        kwargs = {kw.arg: _literal(kw.value) for kw in node.keywords}
        return DATASET_REGISTRY[name](*args, **kwargs)
    raise ValueError(f"unsupported expression {ast.dump(node)}")


def _literal(node: ast.AST) -> Any:
    if isinstance(node, ast.Name):
        # bare identifiers (the reference writes transform=ColorJitter and
        # eval()s it) become their name string; the dataset resolves it
        # against a registry — no code execution
        return node.id
    try:
        return ast.literal_eval(node)
    except (ValueError, SyntaxError) as e:
        raise ValueError(
            f"dataset DSL arguments must be literals, got {ast.dump(node)}"
        ) from e


def build_dataset(expr: str):
    """Parse a dataset DSL string into a dataset object."""
    import fast3r_torch.data.datasets  # noqa: F401 — populates the registry

    tree = ast.parse(expr.strip(), mode="eval")
    return _build(tree.body)


def _validate(node: ast.AST) -> None:
    """Same grammar walk as _build, minus construction."""
    if isinstance(node, ast.BinOp):
        if isinstance(node.op, ast.Add):
            _validate(node.left)
            _validate(node.right)
            return
        if isinstance(node.op, (ast.MatMult, ast.Mult)):
            n = _literal(node.left)
            assert isinstance(n, int), f"left of @/* must be int, got {n!r}"
            _validate(node.right)
            return
        raise ValueError(f"unsupported operator {ast.dump(node.op)}")
    if isinstance(node, ast.Call):
        assert isinstance(node.func, ast.Name), "dataset call must be a name"
        name = node.func.id
        _check_registered(name)
        for a in node.args:
            _literal(a)
        for kw in node.keywords:
            _literal(kw.value)
        return
    raise ValueError(f"unsupported expression {ast.dump(node)}")


def validate_dataset_spec(expr: str) -> None:
    """Check a dataset DSL string parses and names only registered datasets,
    WITHOUT constructing anything (no filesystem access) — config validation
    for overlays whose data roots are not mounted."""
    import fast3r_torch.data.datasets  # noqa: F401 — populates the registry

    tree = ast.parse(expr.strip(), mode="eval")
    _validate(tree.body)
