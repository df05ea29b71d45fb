"""The mesh road (``fast3r_torch.parallel.mesh``) on the model variants: the
llama decoder (MHA and GQA) and the DINO encoder tensor-parallel, dropout
on a model axis, the training CLI and a checkpoint of a tensor-parallel
llama run, on the CPU, against fast3r_tpu's sharded step and the port's
one-process road.

One spawn of four gloo ranks (``tests/test_torch_mesh.py``'s helpers, one
torch thread each) runs every case, while JAX compiles its six sharded
steps in threads:

* at (data, model) (2, 2), the four ranks: two mesh steps of each variant
  on both block roads;
* then two process groups of two ranks, (1, 2) each: ranks 0-1 the llama
  and GQA steps, a dropout step and the checkpoint flow of a llama run;
  ranks 2-3 the DINO steps, then ``cli.train --distributed`` at
  ``parallel.model_axis=2`` on a tiny llama model.

Checks:

* each variant's two steps at (1, 2) and (2, 2), fused and plain roads,
  against JAX's ``make_jitted_train_step`` on a mesh of as many virtual
  devices with the same global batch and image ids (2 samples on both
  grids: at (1, 2) each rank steps on both, at (2, 2) on one): the loss
  within 1e-5
  relative, the gathered params and AdamW moments within 1e-5 of each
  tensor's largest value, params plus the AdamW term of
  ``tests/test_torch_mesh.py``'s docstring;
* two steps at (1, 2) with ``drop``, ``attn_drop`` and ``drop_path``
  non-zero in both stacks equal the port's one-process steps from the same
  seed (dropout seeds, masks and image ids drawn alike) within the same
  tolerances;
* the CLI's two ranks end with the same whole params, bitwise, and the
  checkpoint's;
* the llama run's checkpoint after step 1, resumed on one process, gives
  the mesh run's step 2.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from fast3r_torch import Fast3RConfig
from fast3r_torch.data.dummy import make_dummy_batch
from fast3r_torch.models.dino_encoder import DinoEncoderConfig
from fast3r_torch.models.fast3r import empty_fast3r, init_fast3r
from fast3r_torch.models.llama_decoder import LlamaDecoderConfig
from fast3r_torch.nn.fused_block import fused_llama_supported
from fast3r_torch.parallel import mesh as pm
from fast3r_torch.train import step as ts

from test_torch_mesh import (
    BATCH_KEYS,
    CLI_OVERRIDES,
    OPT,
    RTOL,
    V,
    _assert_close,
    _check_resume,
    _ckpt_flow,
    _cli_run,
    _free_port,
    _jax_grid,
    _jax_ids,
    _jax_moments,
    _join,
    _rows,
    _wait,
)
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

VARIANTS = ["llama", "gqa", "dino"]
GRIDS = [(1, 2), (2, 2)]
# a variant's view size: the CroCo encoder's patch 16, DINO's 14
HW = {"llama": (32, 48), "gqa": (32, 48), "dino": (28, 42)}
DROP = dict(drop=0.1, attn_drop=0.1, drop_path=0.1)
ROWS = 2  # the global batch of every grid's steps
# a tiny llama model through the CLI: debug_smoke's, its decoder 32 x 2 over
# 2 heads, one head (the replicated heads' CPU time halved), 2 steps of
# debug_smoke's data, no validation
CLI_LLAMA_OVERRIDES = CLI_OVERRIDES + [
    "parallel.model_axis=2", "data.validation_datasets=[]",
    "model.head_args.with_local_head=False",
    "data.train_datasets=['4 @ DummyMultiview(num_scenes=4, num_views=2, "
    "resolution=[(64, 48)], seed=777)']",
    "model.decoder_args.decoder_type=llama", "model.decoder_args.n_layers=2",
    "model.decoder_args.n_heads=2"]


def port_cfg(name: str) -> Fast3RConfig:
    """The port's tiny variant: ``tiny()`` behind a llama decoder of 2
    layers, 4 heads of 16 (GQA: 2 kv heads), or a DINO encoder 64 wide, 2
    deep, 4 heads, on a 4 x 4 position grid; "drop": ``tiny()`` with every
    dropout rate of both stacks non-zero."""
    cfg = Fast3RConfig.tiny()
    if name in ("llama", "gqa"):
        return dataclasses.replace(cfg, decoder=LlamaDecoderConfig(
            enc_embed_dim=64, embed_dim=64, n_layers=2, n_heads=4,
            n_kv_heads=2 if name == "gqa" else None))
    if name == "dino":
        return dataclasses.replace(
            cfg, encoder=DinoEncoderConfig(embed_dim=64, depth=2, num_heads=4,
                                           pos_embed_size=4),
            head=dataclasses.replace(cfg.head, patch_size=14))
    return dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, **DROP),
        decoder=dataclasses.replace(cfg.decoder, **DROP))


def jax_cfg(name: str):
    """JAX's configuration of the same variant."""
    from fast3r_tpu.models import fast3r as jf
    from fast3r_tpu.models.dino_encoder import DinoEncoderConfig as JDino
    from fast3r_tpu.models.llama_decoder import LlamaDecoderConfig as JLlama

    cfg = jf.Fast3RConfig.tiny()
    if name in ("llama", "gqa"):
        return dataclasses.replace(cfg, decoder=JLlama(
            enc_embed_dim=64, embed_dim=64, n_layers=2, n_heads=4,
            n_kv_heads=2 if name == "gqa" else None))
    return dataclasses.replace(
        cfg, encoder=JDino(embed_dim=64, depth=2, num_heads=4,
                           pos_embed_size=4),
        head=dataclasses.replace(cfg.head, patch_size=14))


def _batches(name: str, rows: int, seeds) -> list:
    h, w = HW.get(name, (32, 48))
    return [{k: v for k, v in make_dummy_batch(rows, V, h, w, seed=s).items()
             if k in BATCH_KEYS} for s in seeds]


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _steps(name: str, inputs: str, out: str, rank: int) -> None:
    """Both roads' two mesh steps of variant ``name`` on the current grid
    from the file ``inputs`` (params ``sd``, ``batches``, image ``ids``);
    rank 0 saves the gathered results to ``out``."""
    inputs = torch.load(inputs, weights_only=False)
    mesh = pm.make_mesh(model=2)
    opt = ts.OptimConfig(**OPT)
    res = {}
    for fused in (True, False):
        cfg = port_cfg(name).with_fused_blocks(fused)
        net = empty_fast3r(cfg, device="cpu")
        net.load_state_dict(inputs["sd"])
        state = ts.init_train_state(net.train(), opt, seed=1, mesh=mesh,
                                    model_cfg=cfg)
        losses = []
        for batch, vid in zip(inputs["batches"], inputs["ids"]):
            state, met = ts.train_step(state, _rows(batch, mesh), cfg, opt,
                                       remat=True, view_ids=vid)
            losses.append(float(met["loss"]))
        res[fused] = dict(losses=losses, **{w: state.whole(w) for w in
                                            ("master", "mu", "nu")})
    if rank == 0:
        torch.save(res, out)


def _dropout_steps(out: str, rank: int) -> None:
    """Two steps of the dropout configuration on the current grid from
    ``init_fast3r(seed=5)``, the image ids drawn from the state's
    generator; rank 0 saves the losses and the whole state to ``out``."""
    cfg = port_cfg("drop")
    opt = ts.OptimConfig(**OPT)
    mesh = pm.make_mesh(model=2)
    state = ts.init_train_state(init_fast3r(cfg, seed=5, device="cpu").train(),
                                opt, seed=1, mesh=mesh, model_cfg=cfg)
    losses = []
    for batch in _batches("drop", mesh.data, (30, 31)):
        state, met = ts.train_step(state, _rows(batch, mesh), cfg, opt)
        losses.append(float(met["loss"]))
    whole = {w: state.whole(w) for w in ("master", "mu", "nu")}
    if rank == 0:
        torch.save(dict(losses=losses, **whole), out)


def _worker(rank, world, ports, tmp):
    """The (2, 2) grid's steps of every variant, then two (1, 2) groups:
    ranks 0-1 the llama and GQA steps, the dropout steps and the llama
    checkpoint flow; ranks 2-3 the DINO steps and the training CLI."""
    _join(rank, world, ports["grid"])
    for name in VARIANTS:
        _steps(name, f"{tmp}/in_{name}.pt", f"{tmp}/out_{name}_2x2.pt", rank)
    dist.destroy_process_group()
    pair, sub = divmod(rank, 2)
    _join(sub, 2, ports[f"pair{pair}"])
    if pair == 0:
        for name in ("llama", "gqa"):
            _steps(name, f"{tmp}/in_{name}.pt", f"{tmp}/out_{name}_1x2.pt",
                   sub)
        _dropout_steps(f"{tmp}/drop.pt", sub)
        _ckpt_flow(sub, f"{tmp}/ckpt_run", f"{tmp}/ckpt_whole.pt",
                   f"{tmp}/ckpt_batches.pt", port_cfg("llama"))
        dist.destroy_process_group()
    else:
        _steps("dino", f"{tmp}/in_dino.pt", f"{tmp}/out_dino_1x2.pt", sub)
        dist.destroy_process_group()
        _cli_run(sub, 2, ports["cli"], f"{tmp}/cli", CLI_LLAMA_OVERRIDES)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results, and JAX's two sharded steps of each variant on
    each grid, compiled in threads while the ranks run: {"grids": {(name,
    (data, model)): (JAX's losses; its params, mu and nu as port dicts;
    the port's results by road)}, "tmp": the runs' directory}."""
    from concurrent.futures import ThreadPoolExecutor

    import jax

    from fast3r_torch.utils.convert import params_from_jax

    from test_torch_model import _jax_params

    tmp = tmp_path_factory.mktemp("mesh_variants")
    params, batches = {}, {}
    for name in VARIANTS:
        params[name] = jax.tree.map(np.asarray,
                                    _jax_params(jax_cfg(name), seed=3))
        batches[name] = _batches(name, ROWS, (10, 11))
        torch.save({"sd": params_from_jax(params[name], port_cfg(name)),
                    "batches": batches[name], "ids": _jax_ids(ROWS)},
                   tmp / f"in_{name}.pt")
    torch.save(_batches("llama", 1, (20, 21)), tmp / "ckpt_batches.pt")
    ports = {k: _free_port() for k in ("grid", "pair0", "pair1", "cli")}
    ctx = mp.spawn(_worker, nprocs=4, join=False, args=(4, ports, str(tmp)))
    with ThreadPoolExecutor(len(VARIANTS) * len(GRIDS)) as pool:
        futures = {(n, g): pool.submit(_jax_grid, *g, params[n], batches[n],
                                       jax_cfg(n))
                   for n in VARIANTS for g in GRIDS}
        jax_res = {k: f.result(timeout=300) for k, f in futures.items()}
    _wait(ctx)
    grids = {}
    for (name, (d, m)), (losses, state) in jax_res.items():
        mu, nu = _jax_moments(state.opt_state)
        want = {k: params_from_jax(jax.tree.map(np.asarray, t),
                                   port_cfg(name))
                for k, t in (("master", state.params), ("mu", mu), ("nu", nu))}
        grids[name, (d, m)] = (losses, want,
                               torch.load(tmp / f"out_{name}_{d}x{m}.pt"))
    return {"grids": grids, "tmp": tmp}


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [True, False], ids=["fused", "plain"])
@pytest.mark.parametrize("grid", GRIDS, ids=[f"{d}x{m}" for d, m in GRIDS])
@pytest.mark.parametrize("name", VARIANTS)
def test_variant_mesh_steps_match_jax_sharded(runs, name, grid, fused):
    losses, want, res = runs["grids"][name, grid]
    got = res[fused]
    np.testing.assert_allclose(got["losses"], losses, rtol=RTOL)
    _assert_close(got["master"], want["master"], "params", want["mu"],
                  OPT["lr"])
    _assert_close(got["mu"], want["mu"], "mu")
    _assert_close(got["nu"], want["nu"], "nu")


def test_dropout_mesh_step_matches_one_process(runs):
    """Dropout at (1, 2) draws the one-process road's seeds, masks and image
    ids: its two steps equal the one-process steps from the same seed."""
    got = torch.load(runs["tmp"] / "drop.pt")
    cfg = port_cfg("drop")
    opt = ts.OptimConfig(**OPT)
    state = ts.init_train_state(init_fast3r(cfg, seed=5, device="cpu").train(),
                                opt, seed=1)
    losses = []
    for batch in _batches("drop", 1, (30, 31)):
        state, met = ts.train_step(state, batch, cfg, opt)
        losses.append(float(met["loss"]))
    np.testing.assert_allclose(got["losses"], losses, rtol=RTOL)
    mu = state.opt_state.mu
    _assert_close(got["master"], state.params.state_dict(), "params", mu,
                  OPT["lr"])
    _assert_close(got["mu"], mu, "mu")
    _assert_close(got["nu"], state.opt_state.nu, "nu")


def test_distributed_cli_llama_model_axis(runs):
    """cli.train at model 2 on a tiny llama model: both ranks hold the same
    whole params (bitwise), which the checkpoint holds."""
    run = runs["tmp"] / "cli"
    ranks = [torch.load(run / f"rank{r}.pt") for r in range(2)]
    assert any(".layers." in k for k in ranks[0]["whole"])
    assert len(ranks[0]["seen"]) == 2, ranks[0]["seen"]
    assert ranks[0]["seen"] == ranks[1]["seen"]
    assert ranks[0]["whole"].keys() == ranks[1]["whole"].keys()
    for k, v in ranks[0]["whole"].items():
        assert torch.equal(ranks[1]["whole"][k], v), k
    saved = torch.load(run / "checkpoints" / "last.pt")
    assert saved["step"] == 2
    for k, v in ranks[0]["whole"].items():
        assert torch.equal(saved["params"][k], v), k


def test_llama_mesh_checkpoint_resumes_on_one_process(runs):
    tmp = runs["tmp"]
    _check_resume(str(tmp / "ckpt_run"), str(tmp / "ckpt_whole.pt"),
                  torch.load(tmp / "ckpt_batches.pt", weights_only=False),
                  port_cfg("llama"))


# ---------------------------------------------------------------------------
# what the tensor-parallel road takes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["llama", "gqa", "dino", "drop"])
def test_check_model_config_takes_variants(name):
    """The llama decoder (MHA and GQA), the DINO encoder and dropout run
    at model 2."""
    mesh = pm.Mesh.__new__(pm.Mesh)
    mesh.data, mesh.model = 1, 2
    mesh.check_model_config(port_cfg(name))


def test_fused_llama_supported_at_rank_widths():
    """llama_dec's fused road at a rank's widths: at model 2 (8 heads, q |
    k | v N 1536, hidden 1408) the kernels take it; at model 4 the hidden
    704 is no multiple of 128, and only the plain road runs."""
    from fast3r_torch import config as tc

    cfg = tc.model_config_from_dict(tc.load_config(
        f"{tc.CONFIG_DIR}/train.yaml", "llama_dec")["model"]).decoder
    assert cfg.ffn_hidden == 2816
    shape = (1, 8 * 768, 1024)
    assert fused_llama_supported(shape, cfg, 1)
    assert fused_llama_supported(shape, cfg, 2)
    assert not fused_llama_supported(shape, cfg, 4)
