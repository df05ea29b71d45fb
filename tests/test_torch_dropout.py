"""The Block's dropout knobs in the port (fast3r_torch.nn.layers) against
fast3r_tpu's, on the CPU, as tests/test_dropout.py holds the JAX block
against the reference.

``drop`` (the projection's and the MLP's outputs), ``attn_drop`` (the
softmax weights) and ``drop_path`` (per-sample stochastic depth) draw from
an explicit ``torch.Generator`` here and from a threefry key in JAX: the
draws cannot be equal, so the tests hold

  * zero rates with a generator equal to no generator, bit for bit (block
    and whole model: the generator is not read);
  * drop_path = 1 to the exact fixed point (both branches zeroed, the
    output is the input, on both sides);
  * each output element's mean over 256 draws within 5 standard errors of
    JAX's, and the overall standard deviations within 5% (fp32);
  * a stack that trains: finite gradients, the same seed the same output,
    another seed another, and a recomputed (remat) stack the same
    gradients bit for bit;
  * a tiny model's training step with non-zero rates: finite, the plain
    road, the image ids drawn after the stacks' seeds.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import fast3r_torch
from fast3r_torch.data.dummy import make_dummy_batch
from fast3r_torch.models.decoder import sample_random_image_ids
from fast3r_torch.nn import layers as tlayers
from fast3r_torch.nn.layers import Block, run_vit_stack, vit_block
from fast3r_torch.train import step as ts

from fast3r_tpu.nn.layers import init_vit_block
from fast3r_tpu.nn.layers import vit_block as jax_vit_block

DIM, HEADS, B, N = 64, 4, 3, 16
SCALE = (DIM // HEADS) ** -0.5
DRAWS = 256

THREADS = 2  # torch threads: the suite runs several test processes on the
             # same cores


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, THREADS))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def block_setup():
    params = init_vit_block(jax.random.key(0), DIM, HEADS)
    x = np.random.default_rng(0).standard_normal((B, N, DIM)) * 0.5
    return params, x.astype(np.float32)


def _port_block(p):
    blk = Block(DIM)
    sd = {"norm1.weight": p["norm1"]["scale"], "norm1.bias": p["norm1"]["bias"],
          "attn.qkv.weight": p["attn"]["qkv"]["w"].T,
          "attn.qkv.bias": p["attn"]["qkv"]["b"],
          "attn.proj.weight": p["attn"]["proj"]["w"].T,
          "attn.proj.bias": p["attn"]["proj"]["b"],
          "norm2.weight": p["norm2"]["scale"], "norm2.bias": p["norm2"]["bias"],
          "mlp.fc1.weight": p["mlp"]["fc1"]["w"].T,
          "mlp.fc1.bias": p["mlp"]["fc1"]["b"],
          "mlp.fc2.weight": p["mlp"]["fc2"]["w"].T,
          "mlp.fc2.bias": p["mlp"]["fc2"]["b"]}
    blk.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in sd.items()})
    return blk


def _block(blk, x, seed=None, **rates):
    return vit_block(blk, torch.from_numpy(x), HEADS, SCALE,
                     attn_impl="naive", seed=seed, **rates)


def test_zero_rates_with_generator_bit_identical(block_setup):
    params, x = block_setup
    blk = _port_block(params)
    with torch.no_grad():
        base = _block(blk, x)
        seeded = _block(blk, x, seed=7)
        g = torch.Generator().manual_seed(3)
        state = g.get_state()
        y, _ = run_vit_stack([blk, blk], torch.from_numpy(x), HEADS, SCALE,
                             attn_impl="naive", generator=g)
        y0, _ = run_vit_stack([blk, blk], torch.from_numpy(x), HEADS, SCALE,
                              attn_impl="naive")
    assert torch.equal(base, seeded) and torch.equal(y, y0)
    assert torch.equal(g.get_state(), state)  # not read at zero rates
    ref = jax_vit_block(params, jnp.asarray(x), HEADS, SCALE,
                        rng=jax.random.key(7))
    np.testing.assert_allclose(base.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=2e-5)


def test_drop_path_one_is_identity(block_setup):
    params, x = block_setup
    with torch.no_grad():
        out = _block(_port_block(params), x, seed=1, drop_path_rate=1.0)
    np.testing.assert_array_equal(out.numpy(), x)
    ref = jax_vit_block(params, jnp.asarray(x), HEADS, SCALE, droppath=1.0,
                        rng=jax.random.key(1))
    np.testing.assert_array_equal(np.asarray(ref), x)


@pytest.mark.parametrize("rates", [
    dict(drop=0.3, attn_drop=0.2, drop_path=0.1),
    dict(drop=0.0, attn_drop=0.5, drop_path=0.0),
])
def test_nonzero_rates_moments_match_jax(block_setup, rates):
    """Same weights and input, train-mode rates: the per-element output
    mean over 256 draws of each side within 5 standard errors of the mean
    (so a wrong scale, a wrong mask shape or a knob left out shows), the
    overall standard deviations within 5%."""
    params, x = block_setup
    fn = jax.jit(lambda r: jax_vit_block(
        params, jnp.asarray(x), HEADS, SCALE, drop=rates["drop"],
        attn_drop=rates["attn_drop"], droppath=rates["drop_path"], rng=r))
    jouts = np.stack([np.asarray(fn(jax.random.key(i)))
                      for i in range(DRAWS)])
    blk = _port_block(params)
    with torch.no_grad():
        touts = np.stack([_block(
            blk, x, seed=1000 + i, drop=rates["drop"],
            attn_drop=rates["attn_drop"],
            drop_path_rate=rates["drop_path"]).numpy()
            for i in range(DRAWS)])
    assert not np.array_equal(touts[0], touts[1])
    sem = jouts.std(0).mean() / np.sqrt(DRAWS)
    diff = np.abs(jouts.mean(0) - touts.mean(0)).mean()
    assert diff < 5 * sem, (diff, sem)
    assert abs(jouts.std() - touts.std()) / jouts.std() < 0.05


def test_stack_trains_with_dropout(block_setup):
    params, x = block_setup
    blocks = [_port_block(params), _port_block(params)]
    rates = dict(drop=0.1, attn_drop=0.1, drop_path_rate=0.1)

    def run(seed, remat=False):
        xt = torch.from_numpy(x).requires_grad_(True)
        y, _ = run_vit_stack(blocks, xt, HEADS, SCALE, attn_impl="naive",
                             remat=remat, generator=torch.Generator()
                             .manual_seed(seed), **rates)
        ps = [xt] + [p for b in blocks for p in b.parameters()]
        return y.detach(), torch.autograd.grad(y.square().sum(), ps)

    y1, g1 = run(4)
    y2, g2 = run(4, remat=True)
    y3, _ = run(5)
    assert all(torch.isfinite(g).all() for g in g1)
    assert torch.equal(y1, y2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    assert not torch.equal(y1, y3)


def test_dropout_step_on_the_plain_road(monkeypatch):
    """A tiny flagship-shaped model with the rates in both stacks takes two
    training steps: finite metrics, no fused block called, the params
    moved; the image ids come after the two stack seeds, and with zero
    rates the generator gives today's ids."""
    base = fast3r_torch.Fast3RConfig.tiny()
    cfg = dataclasses.replace(
        base, encoder=dataclasses.replace(base.encoder, drop=0.1,
                                          drop_path=0.1),
        decoder=dataclasses.replace(base.decoder, attn_drop=0.1,
                                    drop_path=0.2))
    net = fast3r_torch.Fast3R.from_random(cfg, seed=0,
                                          device="cpu").params.train()
    before = {k: v.clone() for k, v in net.state_dict().items()}

    def no_fused(*a, **kw):
        raise AssertionError("a dropping block took the fused road")

    opt = ts.OptimConfig(lr=1e-3, warmup_steps=1, total_steps=100)
    state = ts.init_train_state(net, opt, seed=3)
    with monkeypatch.context() as mp:
        mp.setattr(tlayers, "fused_vit_block", no_fused)
        for seed in (0, 1):
            state, m = ts.train_step(state, make_dummy_batch(
                1, 2, 32, 48, seed=seed), cfg, opt)
            assert not m["skipped_nonfinite"] and torch.isfinite(m["loss"])
    assert any(not torch.equal(v, before[k])
               for k, v in net.state_dict().items())

    imgs = torch.zeros((1, 3, 32, 48, 3))
    ids = []
    for c in (cfg, base):
        g = torch.Generator().manual_seed(9)
        spy = []
        monkeypatch.setattr(fast3r_torch.models.fast3r,
                            "sample_random_image_ids",
                            lambda gen, b, v: spy.append(
                                sample_random_image_ids(gen, b, v)) or spy[-1])
        with torch.no_grad():
            fast3r_torch.fast3r_forward(net, c, imgs, is_training=True,
                                        generator=g)
        ids.append(spy[0])
    g = torch.Generator().manual_seed(9)
    torch.randint(0, 2 ** 63 - 1, (), generator=g)
    torch.randint(0, 2 ** 63 - 1, (), generator=g)
    assert torch.equal(ids[0], sample_random_image_ids(g, 1, 3))
    assert torch.equal(ids[1], sample_random_image_ids(
        torch.Generator().manual_seed(9), 1, 3))
