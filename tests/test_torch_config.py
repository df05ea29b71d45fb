"""The port's config loader (fast3r_torch.config) against fast3r_tpu's on the
CPU.

* Every yaml file the port ships (``fast3r_torch/configs``) holds the same
  data as its JAX twin (``yaml.safe_load``; only comments differ).
* ``load_config`` of the port and of JAX give equal dicts for ``train.yaml``
  alone, with every shipped experiment (``extends:`` chains included) and
  with dotted overrides.
* ``model_config_from_dict``, ``optim_config_from_dict`` and
  ``loss_config_from_dict`` give equal values on the fields both sides
  have; the attention implementation maps JAX's "xla" (XLA's attention) to
  the port's kernel roads ("pallas"), and the port's encoder takes
  "batched" where JAX's config says "pallas" (both the attention kernel).
"""

import dataclasses
import os
import pathlib

import pytest
import yaml

import fast3r_tpu
from fast3r_tpu import config as jc

from fast3r_torch import config as tc

PORT_DIR = pathlib.Path(tc.CONFIG_DIR)
JAX_DIR = pathlib.Path(fast3r_tpu.__file__).parent / "configs"
SHIPPED = sorted(str(p.relative_to(PORT_DIR)) for p in PORT_DIR.rglob("*.yaml"))
EXPERIMENTS = sorted(str(p.relative_to(PORT_DIR / "experiment"))[:-len(".yaml")]
                     for p in (PORT_DIR / "experiment").rglob("*.yaml"))
OVERRIDES = ["data.num_views=8", "optim.lr=3e-4", "trainer.max_epochs=2",
             "paths.run_dir=/tmp/run_x", "model.head_args.with_local_head=False",
             "data.train_datasets=['4 @ DummyMultiview(num_scenes=2, "
             "resolution=[(64, 48)])']"]


def _both(experiment=None, overrides=()):
    port = tc.load_config(str(PORT_DIR / "train.yaml"), experiment, overrides)
    ref = jc.load_config(str(JAX_DIR / "train.yaml"), experiment, overrides)
    return port, ref


def test_shipped_set_is_jax_training_set():
    """train.yaml, every experiment overlay and the eval presets: JAX's
    whole set, no more."""
    jax_set = sorted(str(p.relative_to(JAX_DIR)) for p in JAX_DIR.rglob("*.yaml"))
    assert SHIPPED == jax_set


@pytest.mark.parametrize("rel", SHIPPED)
def test_shipped_yaml_equals_jax(rel):
    with open(PORT_DIR / rel) as f, open(JAX_DIR / rel) as g:
        assert yaml.safe_load(f) == yaml.safe_load(g)


@pytest.mark.parametrize("experiment", [None] + EXPERIMENTS)
def test_load_config_matches_jax(experiment):
    port, ref = _both(experiment)
    assert port == ref


@pytest.mark.parametrize("experiment", [None, "super_long_training",
                                        "data_scaling/data_scaling_0.25",
                                        "model_scaling/model_scaling_base"])
def test_load_config_overrides_match_jax(experiment):
    port, ref = _both(experiment, OVERRIDES)
    assert port == ref
    assert port["optim"]["lr"] == 3e-4 and port["data"]["num_views"] == 8


def test_python_eval_and_interpolation_match_jax(tmp_path):
    (tmp_path / "base.yaml").write_text(
        "task_name: demo\n"
        "data:\n"
        "  num_views: 20\n"
        "  window: ${python_eval:\"${data.num_views} * 2 + 1\"}\n"
        "  expr: D(num_views=${data.num_views})\n"
        "paths:\n"
        "  run_dir: runs/${task_name}\n")
    for ov in ([], ["data.num_views=7"]):
        port = tc.load_config(str(tmp_path / "base.yaml"), overrides=ov)
        assert port == jc.load_config(str(tmp_path / "base.yaml"),
                                      overrides=ov)
        assert isinstance(port["data"]["window"], int)
    (tmp_path / "evil.yaml").write_text(
        "x: ${python_eval:\"__import__('os').getpid()\"}\n")
    with pytest.raises(ValueError):
        tc.load_config(str(tmp_path / "evil.yaml"))


def test_extends_cycle_rejected(tmp_path):
    exp = tmp_path / "experiment"
    exp.mkdir()
    (tmp_path / "base.yaml").write_text("a: 1\n")
    (exp / "x.yaml").write_text("extends: y\nb: 1\n")
    (exp / "y.yaml").write_text("extends: x\nc: 1\n")
    with pytest.raises(ValueError, match="cycle"):
        tc.load_config(str(tmp_path / "base.yaml"), experiment="x")


def test_save_config_matches_jax(tmp_path):
    port, ref = _both("super_long_training", OVERRIDES)
    p = tc.save_config(port, str(tmp_path / "port"))
    r = jc.save_config(ref, str(tmp_path / "jax"))
    assert open(p).read() == open(r).read()
    assert tc.load_config(p) == port


def _same_fields(a, b, path=""):
    """Equal values on the dataclass fields both have, recursively."""
    common = ({f.name for f in dataclasses.fields(a)}
              & {f.name for f in dataclasses.fields(b)})
    assert common, path
    for name in sorted(common):
        x, y = getattr(a, name), getattr(b, name)
        if dataclasses.is_dataclass(x) and dataclasses.is_dataclass(y):
            _same_fields(x, y, f"{path}.{name}")
        elif name == "attn_impl":
            y = {"xla": "pallas"}.get(y, y)
            assert x == y or (x == "batched" and y == "pallas"), (path, x, y)
        else:
            assert x == y, (f"{path}.{name}", x, y)


@pytest.mark.parametrize("experiment", [None] + EXPERIMENTS)
def test_typed_builders_match_jax(experiment):
    port, ref = _both(experiment)
    _same_fields(tc.model_config_from_dict(port["model"]),
                 jc.model_config_from_dict(ref["model"]))
    _same_fields(tc.optim_config_from_dict(port.get("optim", {})),
                 jc.optim_config_from_dict(ref.get("optim", {})))
    _same_fields(tc.loss_config_from_dict(port.get("loss", {})),
                 jc.loss_config_from_dict(ref.get("loss", {})))


def test_flagship_experiment_is_the_flagship():
    """super_long_training builds Fast3RConfig.flagship(): the kernels'
    road, 647,551,368 parameters."""
    import torch

    from fast3r_torch.models.fast3r import Fast3RConfig, Fast3RNet

    port, _ = _both("super_long_training")
    cfg = tc.model_config_from_dict(port["model"])
    assert cfg == Fast3RConfig.flagship()
    with torch.device("meta"):
        net = Fast3RNet(cfg)
    assert sum(p.numel() for p in net.parameters()) == 647_551_368


def test_config_dir_default_matches_cli():
    from fast3r_torch.cli import train

    assert os.path.samefile(
        os.path.join(os.path.dirname(train.__file__), "..", "configs"),
        tc.CONFIG_DIR)
