"""The master-weights road of the port's training (fp32 params and AdamW
moments, the forward and backward on a bf16 working copy) on the CPU.

* The port's ``Trainer`` on the CPU keeps fp32 params and moments and
  computes in fp32, as JAX's ``Trainer`` does: one epoch of two batches
  from the same numpy-filled params gives the same logged loss, lr,
  gradient norm and every ``watch/`` norm within 1e-5 relative (fp32,
  summation order), the same AdamW moments within 1e-5 of each tensor's
  largest entry, and the same params within 1e-5 relative wherever the
  update is determined (Adam divides each gradient by its own root mean
  square, so a gradient at fp32 noise level can flip its parameter's step:
  such entries are held within one step).  The port's decoder takes the
  image ids JAX's trainer draws from its rng.
* With ``compute_dtype=torch.bfloat16`` the working copy equals the bf16
  rounding of the master after every step, bit for bit; the norms read the
  master; an update far below bf16's spacing (lr 1e-6 on LayerNorm scales
  of 1.0, spacing 2^-7) moves every scale of the master, where the bf16
  road's params do not move; a non-finite batch leaves master, moments and
  copy untouched; a checkpoint resumes bit for bit, and serves in bf16.
  The bf16 steps on the CPU are slow: these tests take few of them.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

import fast3r_torch
from fast3r_torch.data.dummy import make_dummy_batch
from fast3r_torch.inference import Fast3R
from fast3r_torch.train import step as ts
from fast3r_torch.train.trainer import Trainer, TrainerConfig
from fast3r_torch.utils.checkpoint_utils import load_model
from fast3r_torch.utils.convert import params_to_jax

from fast3r_tpu.models import fast3r as jf
from fast3r_tpu.models.decoder import sample_random_image_ids as jax_ids
from fast3r_tpu.train import step as js
from fast3r_tpu.train.trainer import Trainer as JaxTrainer
from fast3r_tpu.train.trainer import TrainerConfig as JaxTrainerConfig

from test_torch_cli_train import _rows
from test_torch_model import _jax_params, _port_cfg

B, V, H, W = 1, 2, 32, 48
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=100, eta_min=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=2e-5)
SEED = 5

THREADS = 2  # torch threads: the suite runs several test processes on the
             # same cores


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, THREADS))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jcfg = jf.Fast3RConfig.tiny()
    params = jax.tree.map(np.asarray, _jax_params(jcfg, seed=4))
    return jcfg, params, _port_cfg(jcfg)


def _net(params, cfg):
    return Fast3R.from_jax_params(params, cfg, device="cpu").params


class _Loader:
    def __init__(self, seeds):
        self.batches = [make_dummy_batch(B, V, H, W, seed=s) for s in seeds]

    def set_epoch(self, e):
        pass

    def __iter__(self):
        return iter(self.batches)


def test_trainer_fp32_matches_jax_trainer(setup, tmp_path, monkeypatch):
    jcfg, params, cfg = setup
    loader = _Loader((30, 31))
    tcfg = dict(max_epochs=1, log_every_n_steps=1, seed=SEED, remat=False,
                loggers=())
    jt = JaxTrainer(jcfg, js.OptimConfig(**OPT), trainer_cfg=JaxTrainerConfig(
        run_dir=str(tmp_path / "jax"), **tcfg),
        init_params=jax.tree.map(jnp.asarray, params))
    # the ids JAX's step draws: from its state's rng, split every step
    rng, ids = jt.state.rng, []
    for step in range(2):
        rng, step_rng = jax.random.split(rng)
        ids.append(torch.tensor(np.asarray(jax_ids(
            jax.random.fold_in(step_rng, step), B, V))))
    jt.fit(loader, resume=False)

    it = iter(ids)
    monkeypatch.setattr(fast3r_torch.models.fast3r, "sample_random_image_ids",
                        lambda gen, b, v: next(it))
    pt = Trainer(cfg, ts.OptimConfig(**OPT), trainer_cfg=TrainerConfig(
        run_dir=str(tmp_path / "port"), **tcfg), params=_net(params, cfg),
        device="cpu")
    assert pt.state.work is None
    pt.fit(loader, resume=False)
    assert next(it, None) is None  # both steps took JAX's ids

    for p in [*pt.state.params.parameters(), *pt.state.opt_state.mu.values(),
              *pt.state.opt_state.nu.values()]:
        assert p.dtype == torch.float32
    got = _rows(tmp_path / "port" / "metrics.csv")
    want = _rows(tmp_path / "jax" / "metrics.csv")
    assert len(got) == len(want) == 2
    keys = [k for k in want[0] if k in ("loss", "lr", "grad_norm")
            or k.startswith("watch/")]
    assert len(keys) == 3 + 2 * 4
    for g, w in zip(got, want):
        assert g["step"] == w["step"]
        for k in keys:
            np.testing.assert_allclose(float(g[k]), float(w[k]), rtol=1e-5,
                                       atol=1e-12, err_msg=k)
    # the moments (the fp32 gradients AdamW took) within 1e-5 of each
    # tensor's largest entry; the params within 1e-5 where the update is
    # determined (|mu| at least 1e-2 of its tensor's largest), elsewhere
    # within one Adam step (2.5 lr: a gradient at fp32 noise level can
    # flip the sign of its update)
    tree = lambda d: jax.tree_util.tree_leaves(  # noqa: E731
        params_to_jax(d, cfg))
    leaves = jax.tree_util.tree_leaves_with_path
    jmu, jnu = (jax.tree_util.tree_leaves(
        optax.tree_utils.tree_get(jt.state.opt_state, k)) for k in ("mu", "nu"))
    for got, want in ((tree(pt.state.opt_state.mu), jmu),
                      (tree(pt.state.opt_state.nu), jnu)):
        for a, b in zip(got, want):
            b = np.asarray(b)
            assert np.abs(np.asarray(a) - b).max() <= 1e-5 * np.abs(b).max()
    mine = tree(dict(pt.state.params.named_parameters()))
    for a, (path, b), mu in zip(mine, leaves(jt.state.params), jmu):
        a, b, mu = np.asarray(a), np.asarray(b), np.abs(np.asarray(mu))
        det = mu >= 1e-2 * mu.max()
        np.testing.assert_allclose(a[det], b[det], rtol=1e-5, atol=1e-7,
                                   err_msg=jax.tree_util.keystr(path))
        assert np.abs(a - b).max() <= 2.5 * OPT["lr"]


def _assert_copy_is_rounding(state):
    work = dict(state.work.named_parameters())
    for name, p in state.params.named_parameters():
        assert p.dtype == torch.float32 and work[name].dtype == torch.bfloat16
        assert torch.equal(work[name], p.to(torch.bfloat16)), name


def _master_state(params, cfg, opt, seed=0):
    net = _net(params, cfg).train()
    return ts.init_train_state(net, opt, seed, compute_dtype=torch.bfloat16)


def test_working_copy_tracks_master(setup):
    """Two steps: after each the copy is the master's bf16 rounding, the
    param norms the master's; then a non-finite batch leaves master,
    moments and copy untouched."""
    _, params, cfg = setup
    opt = ts.OptimConfig(**OPT)
    state = _master_state(params, cfg, opt)
    _assert_copy_is_rounding(state)
    for seed in (40, 41):
        norms = {g: ts.global_norm(list(m.parameters())).item()
                 for g, m in state.params.named_children()}
        state, m = ts.train_step(state, make_dummy_batch(B, V, H, W,
                                                         seed=seed), cfg, opt)
        assert not m["skipped_nonfinite"] and torch.isfinite(m["loss"])
        for g, n in norms.items():   # the master's, before the update
            assert m[f"watch/param_norm/{g}"].item() == pytest.approx(
                n, rel=1e-6)
        _assert_copy_is_rounding(state)
        for mu in state.opt_state.mu.values():
            assert mu.dtype == torch.float32
    assert state.opt_state.count == 2

    snap = [{k: v.clone() for k, v in d.items()} for d in (
        state.params.state_dict(), state.work.state_dict(),
        state.opt_state.mu, state.opt_state.nu)]
    bad = make_dummy_batch(B, V, H, W, seed=45)
    bad["imgs"][0, 1, 2, 3, 0] = np.nan
    state, m = ts.train_step(state, bad, cfg, opt)
    assert m["skipped_nonfinite"] == 1 and state.opt_state.count == 2
    for d, ref in zip((state.params.state_dict(), state.work.state_dict(),
                       state.opt_state.mu, state.opt_state.nu), snap):
        assert all(torch.equal(d[k], v) for k, v in ref.items())


def _ln_scales(net):
    return {n: p.detach().clone() for n, p in net.named_parameters()
            if n.endswith("norm.weight") or n.endswith("norm1.weight")
            or n.endswith("norm2.weight")}


def test_update_below_bf16_spacing_moves_master(setup):
    """lr 1e-6 from the first step (no warmup, constant): every element of
    every LayerNorm scale (1.0 at init) moves in the master; the bf16
    copy's and the bf16 road's stay at 1.0."""
    _, _, cfg = setup
    opt = ts.OptimConfig(lr=1e-6, warmup_steps=0, total_steps=100,
                         eta_min=1e-6)
    batch = make_dummy_batch(B, V, H, W, seed=42)
    master = fast3r_torch.models.fast3r.init_fast3r(cfg, seed=1,
                                                    device="cpu").train()
    state = ts.init_train_state(master, opt, compute_dtype=torch.bfloat16)
    before = _ln_scales(state.params)
    assert len(before) == 2 * 2 + 1 + 2 * 4 + 1 and all(
        torch.all(v == 1.0) for v in before.values())
    state, _ = ts.train_step(state, batch, cfg, opt)
    for n, p in _ln_scales(state.params).items():
        assert torch.all(p != before[n]), n
        assert (p - 1).abs().max() < 1e-5, n
    assert all(torch.all(p == 1.0) for p in _ln_scales(state.work).values())

    bf16 = fast3r_torch.models.fast3r.init_fast3r(
        cfg, seed=1, dtype=torch.bfloat16, device="cpu").train()
    state, _ = ts.train_step(ts.init_train_state(bf16, opt), batch, cfg, opt)
    assert all(torch.all(p == 1.0) for p in _ln_scales(state.params).values())


def test_master_checkpoint_resumes_bitwise_and_serves_bf16(setup, tmp_path):
    """Two epochs of one batch on the master road, the second resumed from
    the first's "last" checkpoint in a new Trainer, equal an uninterrupted
    run bit for bit (master, moments, working copy); the checkpoint holds
    fp32 params and moments; ``load_model`` serves it in bf16 (the master
    rounded), and validation runs on the working copy."""
    _, params, cfg = setup
    opt = ts.OptimConfig(**OPT)

    def trainer(run, epochs):
        tr = Trainer(cfg, opt, trainer_cfg=TrainerConfig(
            max_epochs=epochs, run_dir=str(tmp_path / run), loggers=(),
            remat=False), params=_net(params, cfg), device="cpu")
        # the card's road: a bf16 working copy of the fp32 master
        tr.state = ts.init_train_state(tr.state.params, opt, tr.cfg.seed + 1,
                                       compute_dtype=torch.bfloat16)
        return tr

    a = trainer("a", 1)
    a.fit(_Loader((50,)))
    blob = torch.load(tmp_path / "a" / "checkpoints" / "last.pt",
                      weights_only=True)
    for t in [*blob["params"].values(), *blob["opt_state"]["mu"].values()]:
        assert t.dtype == torch.float32
    b = trainer("a", 2)
    b.fit(_Loader((50,)))
    c = trainer("c", 2)
    c.fit(_Loader((50,)))
    assert b.state.step == c.state.step == 2
    for x, y in ((b.state.params, c.state.params), (b.state.work, c.state.work)):
        for k, v in y.state_dict().items():
            assert torch.equal(x.state_dict()[k], v), k
    for k, v in c.state.opt_state.nu.items():
        assert torch.equal(b.state.opt_state.nu[k], v), k
    _assert_copy_is_rounding(b.state)

    served = load_model(str(tmp_path / "a"), dtype=torch.bfloat16,
                        device="cpu")
    for k, v in b.state.work.state_dict().items():
        assert torch.equal(served.params.state_dict()[k], v), k
    batch = dict(make_dummy_batch(B, V, H, W, seed=52),
                 dataset=[["DTU"] * V])
    res = b.validate({"v": [batch]}, epoch=1, eval_recon={"v": False})
    assert np.isfinite(res["val/v/loss"])
