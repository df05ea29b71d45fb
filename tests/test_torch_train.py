"""The port's training slice (fast3r_torch.train) against fast3r_tpu's on the
CPU: losses, the schedule and optimizer, whole ``train_step``s, the
Trainer's loop with checkpoint / resume, ``freeze_mask`` and
``params_to_jax``.

The model is the tiny configuration with the numpy-filled JAX param tree of
tests/test_torch_model.py, loaded into the port with ``params_from_jax``;
batches come from ``make_dummy_batch`` (the port's copy, checked equal to
the JAX package's); the port's decoder takes the image ids JAX draws from
its step rng.  Everything runs in float32.

Tolerances: 1e-5 relative on the loss, norms and lr (fp32 through the whole
model, summation order only); updated params 2e-5 absolute plus 1e-4
relative: Adam divides each gradient by its own root mean square, so an
update inherits the gradient's relative error and a gradient at fp32 noise
level can move its parameter by up to lr times a noise ratio.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

import fast3r_torch
from fast3r_torch.data.dummy import make_dummy_batch
from fast3r_torch.inference import Fast3R
from fast3r_torch.models.fast3r import freeze_mask
from fast3r_torch.train import losses as tl
from fast3r_torch.train import step as ts
from fast3r_torch.train.trainer import Trainer, TrainerConfig
from fast3r_torch.utils.convert import params_from_jax, params_to_jax

from fast3r_tpu.data.dummy import make_dummy_batch as jax_dummy_batch
from fast3r_tpu.models import fast3r as jf
from fast3r_tpu.models.decoder import sample_random_image_ids
from fast3r_tpu.train import losses as jl
from fast3r_tpu.train import step as js

from test_torch_model import _jax_params, _port_cfg
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

B, V, H, W = 2, 3, 32, 48
RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=2e-5)
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=100, eta_min=1e-5)


@pytest.fixture(scope="module")
def setup():
    jcfg = jf.Fast3RConfig.tiny()
    params = _jax_params(jcfg, seed=3)
    cfg = _port_cfg(jcfg)
    return jcfg, params, cfg


def _port_state(params, cfg, ocfg):
    net = Fast3R.from_jax_params(jax.tree.map(np.asarray, params), cfg,
                                 device="cpu").params.train()
    return ts.init_train_state(net, ocfg)


def _jax_ids(state):
    """The (B, V) image ids JAX's train_step draws from its state."""
    _, step_rng = jax.random.split(state.rng)
    step_rng = jax.random.fold_in(step_rng, state.step)
    return torch.tensor(np.asarray(sample_random_image_ids(step_rng, B, V)))


def _batch(seed):
    return make_dummy_batch(B, V, H, W, seed=seed)


def _assert_tree_close(port_tree, jax_tree, tol, what):
    flat_p = jax.tree_util.tree_leaves_with_path(port_tree)
    flat_j = jax.tree_util.tree_leaves_with_path(jax_tree)
    assert [p for p, _ in flat_p] == [p for p, _ in flat_j], what
    for (path, a), (_, b) in zip(flat_p, flat_j):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}",
                                   **tol)


def _assert_metrics_close(m, jm):
    keys = {k for k in jm if k != "skipped_nonfinite"}
    assert keys <= set(m), sorted(keys - set(m))
    for k in sorted(keys):
        np.testing.assert_allclose(np.asarray(m[k]), np.asarray(jm[k]),
                                   rtol=RTOL, atol=1e-7, err_msg=k)
    assert int(m["skipped_nonfinite"]) == int(jm["skipped_nonfinite"])


def test_dummy_batch_is_the_jax_packages():
    a, b = make_dummy_batch(2, 3, 16, 32, seed=5), jax_dummy_batch(2, 3, 16, 32,
                                                                  seed=5)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("gt_scale,local_consistent", [(False, False),
                                                       (True, False),
                                                       (False, True)])
def test_conf_loss_matches_jax(gt_scale, local_consistent):
    """conf_loss_multiview_v2 over regr3d_multiview_v4, with random
    predictions (conf >= 1) against a dummy batch's ground truth."""
    rng = np.random.default_rng(6)
    batch = _batch(6)
    preds = {"pts3d_in_other_view": rng.standard_normal((B, V, H, W, 3)),
             "pts3d_local": rng.standard_normal((B, V, H, W, 3)),
             "conf": 1 + rng.random((B, V, H, W)),
             "conf_local": 1 + rng.random((B, V, H, W))}
    preds = {k: v.astype(np.float32) for k, v in preds.items()}
    gts = {k: batch[k] for k in ("pts3d", "valid_mask", "camera_pose")}
    cfg = dict(gt_scale=gt_scale, local_scale_consistent=local_consistent)
    ref, rdet = jl.conf_loss_multiview_v2(
        jax.tree.map(jnp.asarray, gts), jax.tree.map(jnp.asarray, preds),
        jl.LossConfig(**cfg))
    got, det = tl.conf_loss_multiview_v2(
        {k: torch.from_numpy(v) for k, v in gts.items()},
        {k: torch.from_numpy(v) for k, v in preds.items()}, tl.LossConfig(**cfg))
    np.testing.assert_allclose(got.item(), float(ref), rtol=RTOL)
    assert det.keys() == rdet.keys()
    for k in det:
        np.testing.assert_allclose(det[k].numpy(), np.asarray(rdet[k]),
                                   rtol=RTOL, err_msg=k)


def test_schedule_matches_optax():
    """Every step of a warmup + cosine schedule (lr 0 at step 0) and past
    its end; optax evaluates in float32, the port in float64 (1e-5)."""
    cfg = ts.OptimConfig(lr=3e-4, warmup_steps=7, total_steps=40, eta_min=2e-6)
    ref = js.make_schedule(js.OptimConfig(lr=3e-4, warmup_steps=7,
                                          total_steps=40, eta_min=2e-6))
    got = ts.make_schedule(cfg)
    assert got(0) == 0.0
    for s in range(0, 50):
        np.testing.assert_allclose(got(s), float(ref(s)), rtol=1e-5, atol=1e-12)


@pytest.fixture(scope="module")
def jax_steps(setup):
    """Two JAX train_steps (one jitted program) from the numpy-filled
    params: [(ids, metrics, state after)] per step."""
    jcfg, params, _ = setup
    ocfg = js.OptimConfig(**OPT)
    step = jax.jit(lambda s, b: js.train_step(s, b, jcfg, ocfg, remat=True))
    state = js.init_train_state(params, ocfg, jax.random.key(1))
    out = []
    for seed in (10, 11):
        batch = {k: jnp.asarray(v) for k, v in _batch(seed).items()
                 if k in ("imgs", "true_shapes", "pts3d", "valid_mask",
                          "camera_pose")}
        ids = _jax_ids(state)
        state, m = step(state, batch)
        out.append((ids, jax.tree.map(np.asarray, m),
                    jax.tree.map(np.asarray, state.params)))
    return out


@pytest.mark.parametrize("fused", [True, False])
def test_two_train_steps_match_jax(setup, jax_steps, fused):
    """loss, lr, grad_norm, skipped_nonfinite, the loss details and every
    watch/ norm at both steps, and every param after each step (the first
    runs at lr 0 and changes nothing), on the fused and the plain road."""
    _, params, cfg = setup
    cfg = cfg.with_fused_blocks(fused)
    state = _port_state(params, cfg, ts.OptimConfig(**OPT))
    for i, (seed, (ids, jm, jparams)) in enumerate(zip((10, 11), jax_steps)):
        state, m = ts.train_step(state, _batch(seed), cfg,
                                 ts.OptimConfig(**OPT), remat=True,
                                 view_ids=ids)
        assert state.step == i + 1 and state.opt_state.count == i + 1
        _assert_metrics_close(m, jm)
        got = params_to_jax(dict(state.params.named_parameters()), cfg)
        _assert_tree_close(got, jparams, PARAM_TOL, f"step {i + 1} params")
    assert m["lr"] == pytest.approx(OPT["lr"])


def _port_grads(state, batch, cfg, ids):
    """{name: gradient} of the port's training forward + loss."""
    b = {k: torch.as_tensor(batch[k]) for k in
         ("imgs", "true_shapes", "pts3d", "valid_mask", "camera_pose")}
    preds = fast3r_torch.fast3r_forward(state.params, cfg, b["imgs"],
                                        b["true_shapes"], view_ids=ids,
                                        is_training=True)
    loss, _ = tl.conf_loss_multiview_v2(b, preds)
    names, ps = zip(*state.params.named_parameters())
    gs = torch.autograd.grad(loss, ps, allow_unused=True)
    return {n: torch.zeros_like(p) if g is None else g
            for n, p, g in zip(names, ps, gs)}


@pytest.mark.parametrize("case", ["lr_scales", "grad_clip"])
def test_optimizer_options_match_jax(setup, case):
    """Two train_steps with per-group lr scales (one group frozen at scale
    0) or a gradient clip that triggers.  The JAX side applies
    make_optimizer's chain, as its train_step does, to the same gradients
    (the port's, which test_two_train_steps_match_jax holds to JAX's)."""
    jcfg, params, cfg = setup
    extra = ({"lr_scales": (("encoder", 0.5), ("head_local", 0.0))}
             if case == "lr_scales" else {"grad_clip": 0.05})
    jocfg = js.OptimConfig(**OPT, **extra)
    tx = js.make_optimizer(jocfg)
    jstate = js.init_train_state(params, jocfg, jax.random.key(1))
    state = _port_state(params, cfg, ts.OptimConfig(**OPT, **extra))
    jp, opt_state = jstate.params, jstate.opt_state

    @jax.jit
    def update(grads, opt_state, p):
        updates, opt_state = tx.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state

    for seed in (12, 13):
        ids = _jax_ids(jstate)
        grads = jax.tree.map(jnp.asarray, params_to_jax(
            _port_grads(state, _batch(seed), cfg, ids), cfg))
        jp, opt_state = update(grads, opt_state, jp)
        jstate = dataclasses.replace(jstate, rng=jax.random.split(jstate.rng)[0],
                                     step=jstate.step + 1)
        state, m = ts.train_step(state, _batch(seed), cfg,
                                 ts.OptimConfig(**OPT, **extra), view_ids=ids)
        np.testing.assert_allclose(m["grad_norm"].item(),
                                   float(optax.global_norm(grads)), rtol=RTOL)
    if case == "grad_clip":
        assert m["grad_norm"].item() > 0.05  # the clip triggered
    got = params_to_jax(dict(state.params.named_parameters()), cfg)
    _assert_tree_close(got, jax.tree.map(np.asarray, jp), PARAM_TOL, case)
    if case == "lr_scales":  # the frozen group kept its initial values
        _assert_tree_close(got["head_local"],
                           jax.tree.map(np.asarray, params["head_local"]),
                           dict(rtol=0, atol=0), "head_local")


def test_lr_scales_unknown_group_raises(setup):
    _, params, cfg = setup
    with pytest.raises(ValueError, match="encodr"):
        _port_state(params, cfg, ts.OptimConfig(lr_scales=(("encodr", 0.1),)))


def test_nonfinite_batch_leaves_state_untouched(setup):
    """A NaN image: loss non-finite, skipped_nonfinite 1, params and
    moments unchanged, Adam's count held, step advanced."""
    _, params, cfg = setup
    ocfg = ts.OptimConfig(**OPT)
    state = _port_state(params, cfg, ocfg)
    state, _ = ts.train_step(state, _batch(14), cfg, ocfg)
    state, _ = ts.train_step(state, _batch(15), cfg, ocfg)  # moments non-zero
    before = {k: v.clone() for k, v in state.params.state_dict().items()}
    mu = {k: v.clone() for k, v in state.opt_state.mu.items()}
    nu = {k: v.clone() for k, v in state.opt_state.nu.items()}
    bad = _batch(16)
    bad["imgs"][0, 1, 3, 4, 0] = np.nan
    state, m = ts.train_step(state, bad, cfg, ocfg)
    assert m["skipped_nonfinite"] == 1 and not torch.isfinite(m["loss"])
    assert state.step == 3 and state.opt_state.count == 2
    for k, v in state.params.state_dict().items():
        assert torch.equal(v, before[k]), k
    for k in mu:
        assert torch.equal(state.opt_state.mu[k], mu[k])
        assert torch.equal(state.opt_state.nu[k], nu[k])


class _Loader:
    """A list of dummy batches with set_epoch, recording the epochs."""

    def __init__(self, seeds):
        self.batches = [_batch(s) for s in seeds]
        self.epochs = []

    def set_epoch(self, e):
        self.epochs.append(e)

    def __iter__(self):
        return iter(self.batches)


def test_trainer_fit_checkpoint_resume(setup, tmp_path):
    """fit 2 epochs of 2 batches, checkpoint "last", then a new Trainer
    fits to 3 epochs from it: counters, step, Adam count and generator
    continue, and the run equals an uninterrupted 3-epoch fit."""
    _, params, cfg = setup
    ocfg = ts.OptimConfig(**OPT)

    def trainer(run, epochs):
        net = Fast3R.from_jax_params(jax.tree.map(np.asarray, params), cfg,
                                     device="cpu").params
        return Trainer(cfg, ocfg, trainer_cfg=TrainerConfig(
            max_epochs=epochs, run_dir=str(tmp_path / run), log_every_n_steps=1,
            remat=False), params=net)

    a = trainer("a", 2)
    loader = _Loader((20, 21))
    a.fit(loader, val_loaders={"val": _Loader((22,))})
    assert loader.epochs == [0, 1]
    assert (a.state.step, a.epoch, a.total_samples, a.total_images) == (
        4, 2, 4 * B, 4 * B * V)
    b = trainer("a", 3)  # same run dir: resumes from "last"
    loader_b = _Loader((20, 21))
    b.fit(loader_b)
    assert loader_b.epochs == [2]
    assert (b.state.step, b.state.opt_state.count, b.epoch, b.total_samples,
            b.total_images) == (6, 6, 3, 6 * B, 6 * B * V)
    c = trainer("c", 3)
    c.fit(_Loader((20, 21)))
    for k, v in c.state.params.state_dict().items():
        torch.testing.assert_close(b.state.params.state_dict()[k], v, rtol=0,
                                   atol=0, msg=k)
    lines = (tmp_path / "a" / "metrics.csv").read_text().splitlines()
    assert any("val/val/loss" in ln for ln in lines)


@pytest.mark.parametrize("freeze", ["none", "encoder", "sandwich"])
def test_freeze_mask_matches_jax(setup, freeze):
    jcfg, params, cfg = setup
    jmask = jf.freeze_mask(params, jcfg, freeze)
    net = fast3r_torch.models.fast3r.empty_fast3r(cfg, device="cpu")
    mask = freeze_mask(net, cfg, freeze)
    assert set(mask) == {n for n, _ in net.named_parameters()}
    for group, sub in jmask.items():
        (want,) = set(jax.tree.leaves(sub))
        assert all(v == want for n, v in mask.items()
                   if n.split(".")[0] == group), group


def test_params_to_jax_round_trip(setup):
    """params_to_jax(params_from_jax(tree)) is the tree, leaf for leaf."""
    _, params, cfg = setup
    tree = jax.tree.map(np.asarray, params)
    back = params_to_jax(params_from_jax(tree, cfg), cfg)
    _assert_tree_close(back, tree, dict(rtol=0, atol=0), "round trip")


def test_training_forward_scale_and_dropout(setup):
    """The training decoder scale has no entropy bias; a non-zero dropout
    rate drops in a training forward given a generator (one seed, one
    output; without a generator the forward equals the zero-rate one); a
    training forward without ids or a generator raises."""
    _, _, cfg = setup
    assert cfg.decoder.attn_scale(True) == cfg.decoder.head_dim ** -0.5
    assert cfg.decoder.attn_scale() > cfg.decoder.attn_scale(True)
    net = fast3r_torch.models.fast3r.init_fast3r(cfg, seed=0, device="cpu")
    imgs = torch.from_numpy(_batch(17)["imgs"][:1, :2])
    ids = torch.tensor([[0, 5]], dtype=torch.int32)
    drop = dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, drop=0.1))
    with torch.no_grad():
        a, b = (fast3r_torch.fast3r_forward(
            net, drop, imgs, is_training=True,
            generator=torch.Generator().manual_seed(5)) for _ in range(2))
        plain = fast3r_torch.fast3r_forward(net, drop, imgs, is_training=True,
                                            view_ids=ids)
        ref = fast3r_torch.fast3r_forward(net, cfg, imgs, is_training=True,
                                          view_ids=ids)
    for k in ref:
        assert torch.equal(a[k], b[k]) and torch.equal(plain[k], ref[k]), k
        assert torch.isfinite(a[k]).all(), k
    assert not torch.equal(a["conf"], fast3r_torch.fast3r_forward(
        net, drop, imgs, is_training=True,
        generator=torch.Generator().manual_seed(6))["conf"])
    with pytest.raises(ValueError, match="generator"):
        fast3r_torch.fast3r_forward(net, cfg, imgs, is_training=True)
