"""The model_scaling decoders (configs/experiment/model_scaling/*: 768 x 12
at 12 heads, 1024 x 24 at 16, 1280 x 32 at 16, so head_dim 64, 64 and 80)
in the port against fast3r_tpu on the CPU.

At tiny widths the same shapes of trouble: a decoder 160 wide with 2 heads
(head_dim 80, the huge decoder's) and one 96 wide with 2 heads (a width that
is not the flagship's), each behind the tiny encoder and heads with the
numpy-filled JAX param tree of tests/test_torch_model.py; the forward of
both and two ``train_step``s of the head_dim-80 model against JAX's, as
tests/test_torch_train.py holds the tiny model.  The attention's plain
forward and backward at head_dim 80 are held against JAX's flash functions
(Pallas in TPU interpret mode, as tests/test_torch_backward.py runs them).
The three overlays build through ``config.py`` to the widths, depths and
heads their YAML names.

Tolerances (float32, elementwise |port - jax| <= atol + rtol * |jax|): the
attention forward and the model's outputs 2e-5, gradients 1e-4 (summation
order only); the training steps those of tests/test_torch_train.py.
"""

import dataclasses
import pathlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

import fast3r_torch
import fast3r_tpu
from fast3r_torch import config as tc
from fast3r_torch.data.dummy import make_dummy_batch
from fast3r_torch.inference import Fast3R
from fast3r_torch.ops import flash_attention as tfa
from fast3r_torch.train import step as ts
from fast3r_torch.utils.convert import params_to_jax

from fast3r_tpu import config as jc
from fast3r_tpu.models import fast3r as jf
from fast3r_tpu.models.decoder import sample_random_image_ids
from fast3r_tpu.ops import flash_attention as jfa
from fast3r_tpu.train import step as js

from test_torch_model import _jax_params, _port_cfg
from test_torch_train import (
    OPT,
    PARAM_TOL,
    _assert_metrics_close,
    _assert_tree_close,
)

from torch_threads import few_torch_threads  # noqa: F401 (autouse)

TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
B, V, H, W = 2, 3, 32, 48
JAX_CONFIGS = pathlib.Path(fast3r_tpu.__file__).parent / "configs"
OVERLAYS = {"model_scaling/model_scaling_base": (768, 12, 12),
            "model_scaling/model_scaling_large": (1024, 24, 16),
            "model_scaling/model_scaling_huge": (1280, 32, 16)}


def _jax_cfg(width):
    """The tiny JAX model with a decoder of ``width`` and 2 heads."""
    base = jf.Fast3RConfig.tiny()
    dec = dataclasses.replace(base.decoder, embed_dim=width, num_heads=2)
    head = dataclasses.replace(base.head, dim_tokens=(64, width, width, width))
    return dataclasses.replace(base, decoder=dec, head=head)


_MODELS = {}


def _models(width):
    if width not in _MODELS:
        jcfg = _jax_cfg(width)
        params = _jax_params(jcfg, seed=5)
        model = Fast3R.from_jax_params(jax.tree.map(np.asarray, params),
                                       _port_cfg(jcfg), device="cpu")
        _MODELS[width] = (jcfg, params, model)
    return _MODELS[width]


@pytest.mark.parametrize("grad", [False, True])
def test_attention_head_dim_80_matches_jax_flash(grad):
    """(1, 256, 2, 80), the huge decoder's head_dim: JAX's flash_attention
    (a Pallas kernel at this shape, the ones block padded) and its vjp
    against the port's plain forward and backward, which its wrapper takes
    on the CPU."""
    rng = np.random.default_rng(8)
    shape = (1, 256, 2, 80)
    q, k, v, do = (rng.standard_normal(shape).astype(np.float32)
                   for _ in range(4))
    scale = 80 ** -0.5
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(a, b, c, scale),
                           *map(jnp.asarray, (q, k, v)))
        ref_g = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(a).requires_grad_(grad) for a in (q, k, v)]
    got = tfa.flash_attention(*leaves, scale)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **TOL)
    if grad:
        got.backward(torch.from_numpy(do))
        for t, r, n in zip(leaves, ref_g, ("dq", "dk", "dv")):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(r),
                                       err_msg=n, **GRAD_TOL)


@pytest.mark.parametrize("width", [160, 96])
def test_fast3r_forward_matches_jax(width):
    """B = 2, V = 3 at 32x48, the port's default fused road and its plain
    road against JAX's forward; JAX's ids."""
    jcfg, params, model = _models(width)
    rng = np.random.default_rng(9)
    imgs = rng.standard_normal((B, V, H, W, 3)).astype(np.float32)
    ids = np.asarray(sample_random_image_ids(jax.random.key(0), B, V))
    ref = jax.jit(lambda p, x: jf.fast3r_forward(p, jcfg, x))(
        params, jnp.asarray(imgs))
    for fused in (True, False):
        out = fast3r_torch.fast3r_forward(
            model.params, model.cfg.with_fused_blocks(fused),
            torch.from_numpy(imgs), view_ids=torch.tensor(ids))
        for key in ref:
            np.testing.assert_allclose(out[key].detach().numpy(),
                                       np.asarray(ref[key]),
                                       err_msg=f"{key} fused={fused}",
                                       **TOL)


@pytest.fixture(scope="module")
def jax_steps():
    """Two JAX train_steps of the head_dim-80 model (one jitted program)."""
    jcfg, params, _ = _models(160)
    ocfg = js.OptimConfig(**OPT)
    step = jax.jit(lambda s, b: js.train_step(s, b, jcfg, ocfg, remat=True))
    state = js.init_train_state(params, ocfg, jax.random.key(1))
    out = []
    for seed in (10, 11):
        batch = {k: jnp.asarray(v) for k, v in
                 make_dummy_batch(B, V, H, W, seed=seed).items()
                 if k in ("imgs", "true_shapes", "pts3d", "valid_mask",
                          "camera_pose")}
        _, step_rng = jax.random.split(state.rng)
        step_rng = jax.random.fold_in(step_rng, state.step)
        ids = torch.tensor(np.asarray(sample_random_image_ids(step_rng, B, V)))
        state, m = step(state, batch)
        out.append((ids, jax.tree.map(np.asarray, m),
                    jax.tree.map(np.asarray, state.params)))
    return out


def test_two_train_steps_match_jax(jax_steps):
    """The head_dim-80 model: loss, lr, norms and every param after each of
    two steps (the first at lr 0) on the port's default road (the fused
    blocks' plain versions on the CPU), against JAX's steps."""
    _, params, model = _models(160)
    cfg = model.cfg
    net = Fast3R.from_jax_params(jax.tree.map(np.asarray, params), cfg,
                                 device="cpu").params.train()
    state = ts.init_train_state(net, ts.OptimConfig(**OPT))
    for i, (seed, (ids, jm, jparams)) in enumerate(zip((10, 11), jax_steps)):
        state, m = ts.train_step(state, make_dummy_batch(B, V, H, W, seed=seed),
                                 cfg, ts.OptimConfig(**OPT), remat=True,
                                 view_ids=ids)
        _assert_metrics_close(m, jm)
        got = params_to_jax(dict(state.params.named_parameters()), cfg)
        _assert_tree_close(got, jparams, PARAM_TOL, f"step {i + 1} params")


@pytest.mark.parametrize("experiment", sorted(OVERLAYS))
def test_overlays_build_to_their_yaml(experiment):
    """Each overlay through config.py: the decoder's width, depth and heads
    as its YAML names them (head_dim 64, 64 and 80), the JAX package's
    config the same, and the model's parameter count on the meta device."""
    width, depth, heads = OVERLAYS[experiment]
    port = tc.model_config_from_dict(
        tc.load_config(str(pathlib.Path(tc.CONFIG_DIR) / "train.yaml"),
                       experiment)["model"])
    ref = jc.model_config_from_dict(
        jc.load_config(str(JAX_CONFIGS / "train.yaml"), experiment)["model"])
    d = port.decoder
    assert (d.embed_dim, d.depth, d.num_heads) == (width, depth, heads)
    assert (d.embed_dim, d.depth, d.num_heads, d.mlp_ratio) == (
        ref.decoder.embed_dim, ref.decoder.depth, ref.decoder.num_heads,
        ref.decoder.mlp_ratio)
    assert d.head_dim == width // heads and d.enc_embed_dim == 1024
    assert port.encoder.embed_dim == ref.encoder.embed_dim == 1024
    assert port.head.dim_tokens == (1024, width, width, width)
    with torch.device("meta"):
        net = fast3r_torch.models.fast3r.Fast3RNet(port)
    shapes = jax.eval_shape(lambda key: jf.init_fast3r(key, ref),
                            jax.random.key(0))
    for group in ("encoder", "decoder", "head_global"):
        want = sum(int(np.prod(a.shape))
                   for a in jax.tree.leaves(shapes[group]))
        got = sum(p.numel() for p in getattr(net, group).parameters())
        assert got == want, group
