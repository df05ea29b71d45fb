"""The port's mesh road (``fast3r_torch.parallel.mesh``, ``train_step`` on a
``MeshTrainState``, the Trainer's ``use_mesh`` and ``parallel:`` in
``cli.train``) on the CPU, against fast3r_tpu's sharded step and the port's
own one-process road.

The ranks are gloo processes spawned with ``torch.multiprocessing`` on a
free local port, one torch thread each; each grid's ranks run the CLI and
checkpoint flows below after their steps, in a new process group, rather
than start processes of their own.  The workers live in this module,
which imports JAX only inside the test functions, so a spawned worker
imports torch and the port only.

* The tensor-parallel rule: for every parameter of the tiny, flagship,
  model_scaling, llama_dec and DINO-encoder configurations at model 2 and
  4, ``param_spec`` splits the same logical dim (output or input) of the
  same params as JAX's ``param_pspec`` through the converter's name map,
  and replicates where JAX does and where whole heads or the hidden do
  not divide over ``model`` (tiny's two heads at model 4).
* Two mesh steps on ``tiny()`` in fp32, fused and plain roads, at (data,
  model) (2, 1), (1, 2) and (2, 2), against JAX's ``make_jitted_train_step``
  on a mesh of as many virtual devices with the same global batch and
  image ids: the loss within 1e-5 relative, the gathered params and AdamW
  moments within 1e-5 of each tensor's largest value; each rank's moment
  bytes at most 0.6 of the whole's at data 2.
* The same at (1, 2) on 2-sample batches for decoders whose widths model 2
  does not divide, which the port runs replicated where JAX splits them
  mid-head or replicates them: one head of 64, a llama decoder of 2 heads
  over 1 kv head, an MLP hidden of 257; and two steps of the one-head,
  257-hidden decoder with dropout in both stacks equal the one-process
  steps from the same seed.  The sequence-sharded road stays refused.
* ``python -m fast3r_torch.cli.train --distributed --device cpu`` as 2 gloo
  ranks for 2 steps of debug_smoke: both ranks hold the same params
  (bitwise), and they equal a one-process run on the same global batches
  within 1e-5 of each tensor's largest value.
* The same CLI as 4 ranks at ``parallel.model_axis=2`` on a dataset with no
  seed, whose crops and colour jitter draw from each process's entropy:
  the model ranks of a data group step on the same images, the data groups
  on different ones, and every rank ends with the same replicated params.
* A (2, 2) run's checkpoint after step 1, resumed on one process, gives
  step 2 of the uninterrupted mesh run within the same tolerance, and
  ``load_model`` serves the run directory.

Params: AdamW divides each gradient by its own root mean square, so a
step moves an element by lr times m / sqrt(v) and inherits its moment's
relative error: an element whose gradient is rounding noise (the k rows of
qkv's bias, whose gradient is zero in exact arithmetic since each query's
softmax ignores a shift of every key's logit; head weights that reach the
loss only through a vanishing path) moves by up to the learning rate
whatever the summation order, here or between the port's one-device step
and JAX's.  So each param element is held to 1e-5 of its tensor's largest
value plus lr times its first moment's relative uncertainty (1e-5 of the
tensor's largest moment over its own, at most 1); every test takes one
step at lr > 0.
"""

import dataclasses
import os
import socket
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from fast3r_torch import Fast3RConfig
from fast3r_torch.data.dummy import make_dummy_batch
from fast3r_torch.models.fast3r import empty_fast3r
from fast3r_torch.parallel import mesh as pm
from fast3r_torch.train import step as ts

BATCH_KEYS = ("imgs", "true_shapes", "pts3d", "valid_mask", "camera_pose")
DROP = dict(drop=0.1, attn_drop=0.1, drop_path=0.1)
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=100, eta_min=1e-5)
V, H, W = 3, 32, 48
RTOL = 1e-5       # of each tensor's largest value (params, moments); loss
GRIDS = [(2, 1), (1, 2), (2, 2)]
THREADS = 2  # torch threads of this process: the suite runs several test
             # processes on the same cores, and the spawned ranks take one


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, THREADS))
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait(ctx, seconds: float = 300.0) -> None:
    """Join spawned ranks (their failure raises here), killing them after
    ``seconds``."""
    end = time.monotonic() + seconds
    while not ctx.join(timeout=1.0):
        if time.monotonic() > end:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"ranks still running after {seconds} s")


def _join(rank: int, world: int, port: int) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)


def _rows(batch: dict, mesh, keys=BATCH_KEYS) -> dict:
    rows = pm.batch_rows(mesh, np.shape(batch["imgs"])[0])
    return {k: batch[k][rows] for k in keys}


def _amax(t: torch.Tensor) -> float:
    return t.abs().max().item() if t.numel() else 0.0


def _assert_close(got: dict, want: dict, what: str, mu=None, lr=None):
    """Each tensor within RTOL of its largest value.  With the reference's
    first moments ``mu`` (params after one step at learning rate ``lr``),
    each element also gets its AdamW step's uncertainty: lr times its
    moment's relative uncertainty (RTOL of the tensor's largest moment over
    its own), at most lr."""
    assert set(got) == set(want), (what, sorted(set(got) ^ set(want)))
    for k, w in want.items():
        g, w = torch.as_tensor(got[k]).float(), torch.as_tensor(w).float()
        assert g.shape == w.shape, (what, k, g.shape, w.shape)
        tol = torch.full_like(w, RTOL * _amax(w))
        if mu is not None:
            m = torch.as_tensor(mu[k]).float().abs()
            rel = torch.where(m > 0, RTOL * _amax(m) / m, torch.ones_like(m))
            tol += lr * rel.clamp(max=1.0)
        err = (g - w).abs() - tol
        assert _amax(err.clamp(min=0)) == 0, (
            what, k, _amax(err.clamp(min=0)), RTOL * _amax(w))


# ---------------------------------------------------------------------------
# the tensor-parallel rule against JAX's
# ---------------------------------------------------------------------------

SPEC_CONFIGS = ["tiny", "flagship", "model_scaling/model_scaling_base",
                "model_scaling/model_scaling_large",
                "model_scaling/model_scaling_huge", "llama_dec", "dino"]


def _config(name):
    """(port config, JAX config) of tiny, flagship, an experiment overlay
    (the model_scaling ones, llama_dec) or "dino" (the flagship behind the
    DINOv2 ViT-L/14 encoder)."""
    import pathlib

    import fast3r_tpu
    from fast3r_torch import config as tc
    from fast3r_torch.models.dino_encoder import DinoEncoderConfig
    from fast3r_tpu import config as jc
    from fast3r_tpu.models import fast3r as jf
    from fast3r_tpu.models.dino_encoder import DinoEncoderConfig as JDino

    if name == "tiny":
        return Fast3RConfig.tiny(), jf.Fast3RConfig.tiny()
    if name == "flagship":
        return Fast3RConfig.flagship(), jf.Fast3RConfig.flagship()
    if name == "dino":
        cfg, jcfg = Fast3RConfig.flagship(), jf.Fast3RConfig.flagship()
        return (dataclasses.replace(cfg, encoder=DinoEncoderConfig(),
                                    head=dataclasses.replace(cfg.head,
                                                             patch_size=14)),
                dataclasses.replace(jcfg, encoder=JDino(),
                                    head=dataclasses.replace(jcfg.head,
                                                             patch_size=14)))
    jroot = pathlib.Path(fast3r_tpu.__file__).parent / "configs"
    return (tc.model_config_from_dict(tc.load_config(
        str(pathlib.Path(tc.CONFIG_DIR) / "train.yaml"), name)["model"]),
        jc.model_config_from_dict(jc.load_config(
            str(jroot / "train.yaml"), name)["model"]))


def _jax_split(keys, shape, mesh):
    """'out', 'in' or None: the logical dim JAX's rule splits."""
    from fast3r_tpu.parallel.mesh import param_pspec

    spec = tuple(param_pspec(keys, shape, mesh))
    dims = [i for i, s in enumerate(spec) if s == "model"]
    if not dims:
        return None
    assert len(dims) == 1, (keys, spec)
    last = len(shape) - 1
    if keys[-1] == "b":
        return "out"
    return "out" if dims[0] == last else "in"


def _runs_whole(pname, cfg, model) -> bool:
    """Whether the port keeps ``pname``'s block sublayer whole at ``model``
    ranks: an attention whose heads or kv heads, or an MLP / FFN whose
    hidden, ``model`` does not divide (JAX splits such a width mid-head
    where its shape divides)."""
    parts = pname.split(".")
    if parts[0] not in ("encoder", "decoder"):
        return False
    heads, kv_heads, hidden = pm.tp_widths(getattr(cfg, parts[0]))
    if "attn" in parts:
        return bool(heads % model or kv_heads % model)
    if "mlp" in parts or "ffn" in parts:
        return bool(hidden % model)
    return False


@pytest.mark.parametrize("name", SPEC_CONFIGS)
def test_param_spec_matches_jax(name):
    import jax
    from fast3r_tpu.models import fast3r as jf
    from fast3r_tpu.parallel.mesh import make_mesh

    from fast3r_torch.models.fast3r import Fast3RNet
    from fast3r_torch.utils.convert import _STACKED, _jax_leaf

    cfg, jcfg = _config(name)
    shapes = jax.eval_shape(lambda k: jf.init_fast3r(k, jcfg),
                            jax.random.key(0))
    jax_leaves = {
        tuple(str(getattr(p, "key", getattr(p, "idx", p))) for p in path):
        tuple(leaf.shape)
        for path, leaf in jax.tree_util.tree_leaves_with_path(shapes)}
    with torch.device("meta"):
        net = Fast3RNet(cfg)
    for model in (2, 4):
        jmesh = make_mesh(devices=jax.devices()[:model], data=1,
                          model=model)
        want = {k: _jax_split(k, s, jmesh) for k, s in jax_leaves.items()}
        seen = set()
        for pname, p in net.named_parameters():
            mod_path, _, leaf = pname.rpartition(".")
            parts = mod_path.split(".")
            keys = tuple(x for i, x in enumerate(parts)
                         if not (i and parts[i - 1] in _STACKED))
            keys += (_jax_leaf(net.get_submodule(mod_path), leaf),)
            assert keys in want, (name, pname, keys)
            spec = pm.param_spec(pname, tuple(p.shape), model, cfg)
            got = None if spec is None else ("out", "in")[spec.dim]
            expect = None if _runs_whole(pname, cfg, model) else want[keys]
            assert got == expect, (name, model, pname, got, want[keys])
            seen.add(keys)
        assert seen == set(want), (name, sorted(set(want) - seen)[:4])
        assert any(v for v in want.values()), name


def test_shard_gather_round_trip():
    """shard_tensor / unshard_tensor invert each other; qkv's slices hold
    whole heads of q, k and v."""
    cfg = Fast3RConfig.tiny()  # 2 heads, hidden 256: model 2 and 4 split
    t = torch.arange(12 * 5, dtype=torch.float32).reshape(12, 5)
    spec = pm.param_spec("decoder.blocks.0.attn.qkv.weight", (12, 5), 2, cfg)
    assert spec == pm.ParamSpec(0, packed=True)
    parts = [pm.shard_tensor(t, spec, 2, r) for r in range(2)]
    assert torch.equal(parts[0], torch.cat([t[0:2], t[4:6], t[8:10]]))
    assert torch.equal(pm.unshard_tensor(parts, spec), t)
    spec = pm.param_spec("encoder.blocks.1.mlp.fc2.weight", (5, 12), 4, cfg)
    parts = [pm.shard_tensor(t.t(), spec, 4, r) for r in range(4)]
    assert parts[1].shape == (5, 3)
    assert torch.equal(pm.unshard_tensor(parts, spec), t.t())
    assert pm.param_spec("encoder.blocks.1.attn.proj.bias", (5,), 2,
                         cfg) is None
    assert pm.param_spec("head_global.proj.weight", (4, 4), 2, cfg) is None


# ---------------------------------------------------------------------------
# widths that model does not divide, and the refused sequence-sharded road
# ---------------------------------------------------------------------------

UNEVEN = ["heads", "gqa", "hidden"]
UNEVEN_ROWS = 2  # the global batch of their steps


def uneven_cfg(what: str) -> Fast3RConfig:
    """``tiny()`` with a decoder whose sublayer model 2 cannot split into
    whole heads or columns: "heads" one head of 64; "gqa" a llama decoder of
    2 heads over 1 kv head; "hidden" an MLP hidden of 257; "drop" one head
    and a hidden of 257 with every dropout rate of both stacks non-zero."""
    from fast3r_torch.models.llama_decoder import LlamaDecoderConfig

    cfg = Fast3RConfig.tiny()
    if what == "gqa":
        return dataclasses.replace(cfg, decoder=LlamaDecoderConfig(
            enc_embed_dim=64, embed_dim=64, n_layers=2, n_heads=2,
            n_kv_heads=1))
    dec = {"heads": dict(num_heads=1), "hidden": dict(mlp_ratio=257 / 64),
           "drop": dict(num_heads=1, mlp_ratio=257 / 64, **DROP)}[what]
    enc = DROP if what == "drop" else {}
    return dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, **enc),
        decoder=dataclasses.replace(cfg.decoder, **dec))


def uneven_jax_cfg(what: str):
    """JAX's configuration of the same decoder (not "drop")."""
    from fast3r_tpu.models import fast3r as jf
    from fast3r_tpu.models.llama_decoder import LlamaDecoderConfig as JLlama

    cfg = jf.Fast3RConfig.tiny()
    if what == "gqa":
        return dataclasses.replace(cfg, decoder=JLlama(
            enc_embed_dim=64, embed_dim=64, n_layers=2, n_heads=2,
            n_kv_heads=1))
    dec = {"heads": dict(num_heads=1), "hidden": dict(mlp_ratio=257 / 64)}
    return dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, **dec[what]))


def _uneven_batches(seeds) -> list:
    return [{k: v for k, v in make_dummy_batch(UNEVEN_ROWS, V, H, W,
                                               seed=s).items()
             if k in BATCH_KEYS} for s in seeds]


def _uneven_worker(rank, world, port, tmp):
    """At (1, 2): each UNEVEN decoder's two steps on both block roads from
    its inputs file, then the "drop" configuration's two steps from
    ``init_fast3r(seed=5)`` with the image ids drawn from the state's
    generator; rank 0 saves each's results."""
    from fast3r_torch.models.fast3r import init_fast3r

    _join(rank, world, port)
    mesh = pm.make_mesh(1, 2)
    for what in UNEVEN:
        inputs = torch.load(f"{tmp}/uneven_in_{what}.pt", weights_only=False)
        res = {fused: _two_steps(uneven_cfg(what).with_fused_blocks(fused),
                                 inputs, mesh) for fused in (True, False)}
        if rank == 0:
            torch.save(res, f"{tmp}/uneven_{what}.pt")
    cfg, opt = uneven_cfg("drop"), ts.OptimConfig(**OPT)
    state = ts.init_train_state(init_fast3r(cfg, seed=5, device="cpu").train(),
                                opt, seed=1, mesh=mesh, model_cfg=cfg)
    losses = []
    for batch in _uneven_batches((30, 31)):
        state, met = ts.train_step(state, _rows(batch, mesh), cfg, opt)
        losses.append(float(met["loss"]))
    whole = {w: state.whole(w) for w in ("master", "mu", "nu")}
    if rank == 0:
        torch.save(dict(losses=losses, **whole), f"{tmp}/uneven_drop.pt")
    dist.destroy_process_group()


@pytest.mark.parametrize("what", ["heads", "gqa", "hidden", "seq"])
def test_tensor_parallel_refusals(runs, what):
    """What model 2 cannot split into whole heads or columns runs
    replicated, and matches JAX's sharded step (which splits such widths
    mid-head or replicates them) as the grids above do, on both block
    roads: a decoder of one head, a llama decoder of 2 heads over 1 kv head,
    an MLP hidden of 257.  The sequence-sharded road stays refused, with its
    named error."""
    mesh = pm.Mesh.__new__(pm.Mesh)
    mesh.data, mesh.model = 1, 2
    if what == "seq":
        from fast3r_torch.parallel.sequence import seq_sharded_config

        with pytest.raises(pm.TensorParallelError):
            mesh.check_model_config(seq_sharded_config(
                Fast3RConfig.tiny(), 2, ring_impl="plain"))
        return
    cfg = uneven_cfg(what)
    mesh.check_model_config(cfg)
    shapes = pm.full_shapes(cfg)
    sub = ".mlp." if what == "hidden" else ".attn."
    whole = [k for k in shapes if k.startswith("decoder.") and sub in k]
    assert whole and all(pm.param_spec(k, shapes[k], 2, cfg) is None
                         for k in whole)
    losses, want, res = runs["uneven"][what]
    for fused in (True, False):
        got = res[fused]
        np.testing.assert_allclose(got["losses"], losses, rtol=RTOL)
        _assert_close(got["master"], want["master"], "params", want["mu"],
                      OPT["lr"])
        _assert_close(got["mu"], want["mu"], "mu")
        _assert_close(got["nu"], want["nu"], "nu")


def test_uneven_dropout_mesh_step_matches_one_process(runs):
    """Dropout in a sublayer that runs replicated draws the same mask on
    both model ranks: two steps at (1, 2) of the one-head, 257-hidden
    decoder with dropout in both stacks equal the one-process steps from
    the same seed."""
    from fast3r_torch.models.fast3r import init_fast3r

    got = torch.load(runs["tmp"] / "uneven_drop.pt")
    cfg, opt = uneven_cfg("drop"), ts.OptimConfig(**OPT)
    state = ts.init_train_state(init_fast3r(cfg, seed=5, device="cpu").train(),
                                opt, seed=1)
    losses = []
    for batch in _uneven_batches((30, 31)):
        state, met = ts.train_step(state, batch, cfg, opt)
        losses.append(float(met["loss"]))
    np.testing.assert_allclose(got["losses"], losses, rtol=RTOL)
    mu = state.opt_state.mu
    _assert_close(got["master"], state.params.state_dict(), "params", mu,
                  OPT["lr"])
    _assert_close(got["mu"], mu, "mu")
    _assert_close(got["nu"], state.opt_state.nu, "nu")


# ---------------------------------------------------------------------------
# two mesh steps against JAX's sharded step
# ---------------------------------------------------------------------------

def _two_steps(cfg, inputs: dict, mesh) -> dict:
    """Two mesh steps of ``cfg`` from ``inputs`` (params ``sd``,
    ``batches``, image ``ids``): the losses, the whole master and moments
    (every rank calls it) and this rank's moment bytes."""
    opt = ts.OptimConfig(**OPT)
    net = empty_fast3r(cfg, device="cpu")
    net.load_state_dict(inputs["sd"])
    state = ts.init_train_state(net.train(), opt, seed=1, mesh=mesh,
                                model_cfg=cfg)
    losses = []
    for batch, vid in zip(inputs["batches"], inputs["ids"]):
        state, met = ts.train_step(state, _rows(batch, mesh), cfg, opt,
                                   remat=True, view_ids=vid)
        losses.append(float(met["loss"]))
    whole = {w: state.whole(w) for w in ("master", "mu", "nu")}
    return dict(losses=losses,
                own_moment_bytes=pm.moment_bytes(state.opt_state), **whole)


def _step_worker(rank, world, port, d, m, inputs, out, ckpt, cli):
    """Both roads' two mesh steps on a (d, m) grid from the file
    ``inputs`` (params ``sd``, ``batches``, image ``ids``); rank 0 saves
    the gathered results to ``out``.  With ``ckpt`` (run_dir, out, the
    batches' file) the same ranks then run :func:`_ckpt_flow`; with ``cli``
    (port, run_dir, overrides) they then run the training CLI in a new
    process group (:func:`_cli_run`).  The inputs come by file: a spawn
    whose arguments outgrow a pipe's buffer waits for the child's imports,
    which would start the ranks one after another."""
    _join(rank, world, port)
    inputs = torch.load(inputs, weights_only=False)  # numpy batches
    mesh = pm.make_mesh(d, m)
    res = {}
    for fused in (True, False):
        cfg = Fast3RConfig.tiny().with_fused_blocks(fused)
        res[fused] = _two_steps(cfg, inputs, mesh)
        nbytes = [None] * world
        dist.all_gather_object(nbytes, res[fused].pop("own_moment_bytes"))
        res[fused]["moment_bytes"] = nbytes
    if rank == 0:
        torch.save(res, out)
    if ckpt is not None:
        _ckpt_flow(rank, *ckpt)
    dist.destroy_process_group()
    if cli is not None:
        _cli_run(rank, world, *cli)


def _jax_moments(opt_state):
    """(mu, nu) trees of optax's adam state in JAX's opt_state."""
    import jax

    found = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: hasattr(x, "mu") and hasattr(x, "nu"))
        if hasattr(s, "mu")]
    assert len(found) == 1
    return found[0].mu, found[0].nu


def _jax_grid(d, m, params, batches, jcfg=None):
    """JAX's two sharded steps of ``jcfg`` (default ``tiny()``) on a (d, m)
    mesh of virtual devices: the losses and the state after them."""
    import jax
    import jax.numpy as jnp

    from fast3r_tpu.models import fast3r as jf
    from fast3r_tpu.parallel import mesh as jm
    from fast3r_tpu.train import step as js

    jcfg = jcfg or jf.Fast3RConfig.tiny()
    ocfg = js.OptimConfig(**OPT)
    tx = js.make_optimizer(ocfg)
    mesh = jm.make_mesh(devices=jax.devices()[:d * m], data=d, model=m)
    sharded = jm.shard_params(params, mesh)
    state = js.TrainState(
        params=sharded, opt_state=jm.zero_init_opt_state(tx, sharded, mesh),
        step=jnp.zeros((), jnp.int32), rng=jax.random.key(1))
    shardings = jm.train_state_shardings(state, mesh, tx)
    state = jax.device_put(state, shardings)  # one compile for both steps
    batches = [{k: jax.device_put(jnp.asarray(b[k]), jm.batch_sharding(mesh))
                for k in BATCH_KEYS} for b in batches]
    # XLA's CPU backend without its costly passes: the same program, a
    # quicker compile
    step = js.make_jitted_train_step(
        jcfg, ocfg, remat=False, state_shardings=shardings).lower(
            state, batches[0]).compile(compiler_options={
                "xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True})
    losses = []
    for batch in batches:
        state, met = step(state, batch)
        losses.append(float(met["loss"]))
    return losses, state


def _jax_ids(d):
    """The (d, V) image ids of JAX's two steps (its state's rng: split, then
    folded with the step), drawn eagerly."""
    import jax

    from fast3r_tpu.models.decoder import sample_random_image_ids

    rng, ids = jax.random.key(1), []
    for step in range(2):
        rng, step_rng = jax.random.split(rng)
        ids.append(torch.tensor(np.asarray(sample_random_image_ids(
            jax.random.fold_in(step_rng, step), d, V))))
    return ids


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every multi-process run of this module, started together: the three
    grids' ranks (the (2, 1) ranks then run the CLI on debug_smoke, the
    (2, 2) ranks the checkpoint flow and the CLI at model 2 on unseeded
    data) and the UNEVEN decoders' two ranks in the background while JAX
    compiles its six sharded steps in threads.  {"grids": {(data, model):
    (JAX's losses; its params, mu and nu as port dicts; the port's results
    by road)}, "uneven": the same by UNEVEN name, "cli": the CLI run's
    directory, "cli_tp": the model-2 CLI run's, "ckpt": (run_dir, results
    file, batches), "tmp": the runs' directory}."""
    from concurrent.futures import ThreadPoolExecutor

    import jax

    from fast3r_torch.utils.convert import params_from_jax
    from fast3r_tpu.models import fast3r as jf

    from test_torch_model import _jax_params

    cfg = Fast3RConfig.tiny()
    params = jax.tree.map(np.asarray, _jax_params(jf.Fast3RConfig.tiny(),
                                                  seed=3))
    sd = params_from_jax(params, cfg)
    tmp = tmp_path_factory.mktemp("mesh")
    ckpt = (str(tmp / "ckpt_run"), str(tmp / "ckpt_whole.pt"),
            [{k: v for k, v in make_dummy_batch(2, V, H, W, seed=s).items()
              if k in BATCH_KEYS} for s in (20, 21)])
    torch.save(ckpt[2], tmp / "ckpt_batches.pt")
    cli = {(2, 1): (_free_port(), str(tmp / "cli"), CLI_OVERRIDES),
           (2, 2): (_free_port(), str(tmp / "cli_tp"), CLI_TP_OVERRIDES)}
    batches, procs = {}, {}
    for d, m in GRIDS:
        batches[d] = [{k: v for k, v in make_dummy_batch(
            d, V, H, W, seed=s).items() if k in BATCH_KEYS} for s in (10, 11)]
        inputs, out = str(tmp / f"in{d}x{m}.pt"), str(tmp / f"{d}x{m}.pt")
        torch.save({"sd": sd, "batches": batches[d], "ids": _jax_ids(d)},
                   inputs)
        procs[(d, m)] = (out, mp.spawn(
            _step_worker, nprocs=d * m, join=False, args=(
                d * m, _free_port(), d, m, inputs, out,
                (*ckpt[:2], str(tmp / "ckpt_batches.pt"))
                if (d, m) == (2, 2) else None, cli.get((d, m)))))
    uneven_params = {}
    for what in UNEVEN:
        uneven_params[what] = jax.tree.map(np.asarray, _jax_params(
            uneven_jax_cfg(what), seed=3))
        torch.save({"sd": params_from_jax(uneven_params[what],
                                          uneven_cfg(what)),
                    "batches": _uneven_batches((10, 11)),
                    "ids": _jax_ids(UNEVEN_ROWS)},
                   tmp / f"uneven_in_{what}.pt")
    uneven = mp.spawn(_uneven_worker, nprocs=2, join=False,
                      args=(2, _free_port(), str(tmp)))
    with ThreadPoolExecutor(len(GRIDS) + len(UNEVEN)) as pool:
        futures = {g: pool.submit(_jax_grid, *g, params, batches[g[0]])
                   for g in GRIDS}
        futures.update({w: pool.submit(_jax_grid, 1, 2, uneven_params[w],
                                       _uneven_batches((10, 11)),
                                       uneven_jax_cfg(w)) for w in UNEVEN})
        jax_res = {g: f.result(timeout=300) for g, f in futures.items()}

    def expected(key, port_cfg):
        losses, state = jax_res[key]
        mu, nu = _jax_moments(state.opt_state)
        return losses, {k: params_from_jax(jax.tree.map(np.asarray, t),
                                           port_cfg)
                        for k, t in (("master", state.params), ("mu", mu),
                                     ("nu", nu))}

    grids = {}
    for g, (out, ctx) in procs.items():
        _wait(ctx)
        grids[g] = (*expected(g, cfg), torch.load(out))
    _wait(uneven)
    return {"grids": grids, "cli": tmp / "cli", "cli_tp": tmp / "cli_tp",
            "ckpt": ckpt, "tmp": tmp,
            "uneven": {w: (*expected(w, uneven_cfg(w)),
                           torch.load(tmp / f"uneven_{w}.pt"))
                       for w in UNEVEN}}


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "plain"])
@pytest.mark.parametrize("grid", GRIDS, ids=[f"{d}x{m}" for d, m in GRIDS])
def test_mesh_steps_match_jax_sharded(runs, grid, fused):
    d, m = grid
    losses, want, res = runs["grids"][grid]
    got = res[fused]
    np.testing.assert_allclose(got["losses"], losses, rtol=RTOL)
    _assert_close(got["master"], want["master"], "params", want["mu"],
                  OPT["lr"])
    _assert_close(got["mu"], want["mu"], "mu")
    _assert_close(got["nu"], want["nu"], "nu")
    if d == 2:
        whole = 2 * sum(t.numel() * 4 for t in want["master"].values())
        assert max(got["moment_bytes"]) <= 0.6 * whole, (
            got["moment_bytes"], whole)


# ---------------------------------------------------------------------------
# the training CLI over 2 gloo ranks
# ---------------------------------------------------------------------------

CLI_FLAGS = ["--experiment", "debug_smoke", "--device", "cpu", "--no-resume"]
CLI_OVERRIDES = ["trainer.ckpt_every_n_epochs=100"]
# debug_smoke's data without its seed, with the real configs'
# augmentations; one head, the CPU time of the replicated heads halved
CLI_TP_OVERRIDES = CLI_OVERRIDES + [
    "parallel.model_axis=2", "data.validation_datasets=[]",
    "model.head_args.with_local_head=False",
    "data.train_datasets=['8 @ DummyMultiview(num_scenes=4, num_views=2, "
    "resolution=[(64, 48)], aug_crop=16, transform=ColorJitter)']"]


def _cli_run(rank, world, port, run_dir, overrides):
    """One rank of ``python -m fast3r_torch.cli.train --distributed`` (a
    torchrun launch's environment).  Saves to ``{run_dir}/rank{rank}.pt``
    its whole params, its own replicated params and a digest of the images
    of each step it took."""
    import hashlib

    from fast3r_torch.cli import train as cli
    from fast3r_torch.train import trainer as tr

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    seen, step = [], tr.train_step

    def recorded(state, batch, *args, **kwargs):
        seen.append(hashlib.sha1(np.ascontiguousarray(
            batch["imgs"]).tobytes()).hexdigest())
        return step(state, batch, *args, **kwargs)

    tr.train_step = recorded
    trainer = cli.main([*CLI_FLAGS, "--distributed", *overrides,
                        f"paths.run_dir={run_dir}"])
    shapes = pm.full_shapes(trainer.model_cfg)
    replicated = {k: p.detach().clone()
                  for k, p in trainer.net.named_parameters()
                  if pm.param_spec(k, shapes[k], trainer.mesh.model,
                                   trainer.model_cfg) is None}
    torch.save({"whole": trainer.params_state_dict(), "seen": seen,
                "replicated": replicated},
               os.path.join(run_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


class _GlobalBatches:
    """The data ranks' loaders zipped: each step's batches concatenated in
    rank order, the global batch of a data-parallel run."""

    def __init__(self, loaders):
        self.loaders = loaders

    def set_epoch(self, epoch):
        for lo in self.loaders:
            lo.set_epoch(epoch)

    def __iter__(self):
        for parts in zip(*self.loaders):
            yield {k: (np.concatenate([p[k] for p in parts])
                       if isinstance(parts[0][k], np.ndarray)
                       else sum((list(p[k]) for p in parts), []))
                   for k in parts[0]}


def test_distributed_cli_ranks_agree(runs, tmp_path):
    from fast3r_torch import config as tc
    from fast3r_torch.data.datamodule import MultiViewDataModule
    from fast3r_torch.train.trainer import Trainer, TrainerConfig

    run = runs["cli"]
    ranks = [torch.load(run / f"rank{r}.pt")["whole"] for r in range(2)]
    assert ranks[0].keys() == ranks[1].keys()
    for k in ranks[0]:
        assert torch.equal(ranks[0][k], ranks[1][k]), k
    saved = torch.load(run / "checkpoints" / "last.pt")
    assert saved["step"] == 2
    for k, v in ranks[0].items():
        assert torch.equal(saved["params"][k], v), k

    # one process on the same global batches (both ranks' loaders zipped)
    cfg = tc.load_config(os.path.join(tc.CONFIG_DIR, "train.yaml"),
                         "debug_smoke", CLI_OVERRIDES)
    d = cfg["data"]
    loaders = [MultiViewDataModule(
        d["train_datasets"], batch_size_per_device=d["batch_size_per_device"],
        num_workers=0, world_size=2, rank=r).train_dataloader()
        for r in range(2)]
    t = cfg["trainer"]
    trainer = Trainer(
        tc.model_config_from_dict(cfg["model"]),
        tc.optim_config_from_dict(cfg["optim"]),
        tc.loss_config_from_dict(cfg.get("loss", {})),
        TrainerConfig(max_epochs=t["max_epochs"], run_dir=str(tmp_path / "one"),
                      seed=cfg["seed"], remat=t["remat"], loggers=(),
                      ckpt_every_n_epochs=100),
        device="cpu")
    trainer.fit(_GlobalBatches(loaders), None, resume=False)
    assert trainer.state.step == 2
    _assert_close(ranks[0], trainer.params_state_dict(), "cli params",
                  trainer.state.opt_state.mu,
                  tc.optim_config_from_dict(cfg["optim"]).lr)


def test_distributed_cli_model_ranks_share_batches(runs):
    """cli.train at data 2 x model 2 on a dataset with no seed: each data
    group's model ranks step on the model rank 0's images, and every rank
    ends with the same replicated params (heads, norms, embeddings)."""
    run = runs["cli_tp"]
    ranks = [torch.load(run / f"rank{r}.pt") for r in range(4)]
    for r in ranks:
        assert len(r["seen"]) == 2, r["seen"]
    for d in range(2):
        assert ranks[2 * d]["seen"] == ranks[2 * d + 1]["seen"], d
    assert ranks[0]["seen"] != ranks[2]["seen"]
    want = ranks[0]["replicated"]
    assert any(k.startswith("head_global") for k in want)
    for r in ranks[1:]:
        assert r["replicated"].keys() == want.keys()
        for k, v in want.items():
            assert torch.equal(r["replicated"][k], v), k
    saved = torch.load(run / "checkpoints" / "last.pt")
    assert saved["step"] == 2
    for k, v in ranks[0]["whole"].items():
        assert torch.equal(saved["params"][k], v), k


# ---------------------------------------------------------------------------
# a mesh run's checkpoint
# ---------------------------------------------------------------------------

def _ckpt_flow(rank, run_dir, out, batches, cfg=None):
    """A model-2 mesh Trainer of ``cfg`` (default ``tiny()``; the grid of
    the calling ranks) takes two steps on the ``batches`` file's and saves
    "last" after the first; rank 0 saves the whole params and first
    moments after the second to ``out``."""
    from fast3r_torch.train.trainer import Trainer, TrainerConfig

    batches = torch.load(batches, weights_only=False)
    cfg = cfg or Fast3RConfig.tiny()
    opt = ts.OptimConfig(**OPT)
    trainer = Trainer(cfg, opt, trainer_cfg=TrainerConfig(
        run_dir=run_dir, loggers=(), use_mesh=True, model_axis=2),
        device="cpu")
    for i, batch in enumerate(batches):
        trainer.state, _ = ts.train_step(
            trainer.state, _rows(batch, trainer.mesh), cfg, opt)
        if i == 0:
            trainer.save_checkpoint("last")
    whole = {"params": trainer.params_state_dict(),
             "mu": trainer.state.whole("mu")}
    if rank == 0:
        torch.save(whole, out)


def test_mesh_checkpoint_resumes_on_one_process(runs):
    _check_resume(*runs["ckpt"], Fast3RConfig.tiny())


def _check_resume(run_dir, out, batches, cfg):
    """A mesh run's checkpoint after step 1 (``_ckpt_flow``), resumed on
    one process, gives the mesh run's step 2; ``load_model`` serves it."""
    from fast3r_torch.train.trainer import Trainer, TrainerConfig
    from fast3r_torch.utils.checkpoint_utils import load_model

    opt = ts.OptimConfig(**OPT)
    one = Trainer(cfg, opt, trainer_cfg=TrainerConfig(
        run_dir=run_dir, loggers=()), device="cpu")
    assert one.load_checkpoint("last") and one.state.step == 1
    one.state, _ = ts.train_step(one.state, batches[1], cfg, opt)
    want = torch.load(out)
    _assert_close(one.params_state_dict(), want["params"], "resumed",
                  want["mu"], OPT["lr"])
    served = load_model(run_dir, device="cpu")
    saved = torch.load(os.path.join(run_dir, "checkpoints", "last.pt"))
    for k, v in served.params.state_dict().items():
        assert torch.equal(v, saved["params"][k]), k
