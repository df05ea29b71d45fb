"""The port's sequence-sharded training (``fast3r_torch/parallel``: the
backward rings' plain version, the sharded loss and the training step)
against ``fast3r_tpu/parallel`` on the CPU.

JAX runs as ``tests/test_sequence_parallel.py`` runs it: ``shard_map`` on
the virtual CPU mesh of ``tests/conftest.py``, the RDMA ring kernels in
Pallas interpret mode.  The port stacks the ranks on a leading axis of one
device; on the CPU its ring is the plain one under autograd
(``ring_impl="plain"``), since the ring kernels exist only on the card
(``tests/test_torch_cuda.py`` holds them there).  Everything is fp32 with
numpy-seeded inputs.  Tolerances: the ring gradients within 3e-5 absolute
and relative (JAX's own ring-gradient bound); the loss within 1e-5
relative (fp32 loss math, summation order only); two training steps (the
first at the schedule's lr 0, the second updating the params) within the
bounds of JAX's seq-sharded step tests: loss 1e-4 relative, gradient norm
1e-3, updated params 2e-3 relative plus 2e-5 absolute (Adam divides each
gradient by its own root mean square, so a gradient at fp32 noise level
moves its parameter by up to lr times a noise ratio).
"""

import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
import torch

from fast3r_torch.data.dummy import make_dummy_batch
from fast3r_torch.inference import Fast3R
from fast3r_torch.models.llama_decoder import LlamaDecoderConfig
from fast3r_torch.parallel import ring_rdma as port_rdma
from fast3r_torch.parallel import sequence as port_seq
from fast3r_torch.train import losses as tl
from fast3r_torch.train import step as ts
from fast3r_torch.utils.convert import params_to_jax

from fast3r_tpu.models import fast3r as jf
from fast3r_tpu.models.decoder import sample_random_image_ids
from fast3r_tpu.parallel import ring_rdma as jax_rdma
from fast3r_tpu.parallel import sequence as jax_seq
from fast3r_tpu.train import losses as jl
from fast3r_tpu.train import step as js

from test_torch_model import _jax_params, _port_cfg
from test_torch_train import _assert_tree_close
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

RING_TOL = dict(rtol=3e-5, atol=3e-5)
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=2e-3, atol=2e-5)
BATCH_KEYS = ("imgs", "pts3d", "valid_mask", "camera_pose")
OPT = dict(warmup_steps=2, total_steps=10)


def _stack(a, n):
    """(1, S, H, D) numpy -> rank-stacked (n, 1, S / n, H, D) torch."""
    _, S, H, D = a.shape
    return torch.from_numpy(a).reshape(n, 1, S // n, H, D)


def _to_ranks(a, n):
    """(B, V, ...) -> rank-stacked (n, B, V / n, ...) torch: rank r holds
    views [r V / n, (r + 1) V / n) of every sample."""
    a = torch.as_tensor(np.asarray(a))
    B, V = a.shape[:2]
    return a.reshape((B, n, V // n) + a.shape[2:]).transpose(0, 1)


# ---------------------------------------------------------------------------
# the backward rings' plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_ring_bwd_ref_matches_jax_rdma_ring(n):
    """dq, dk, dv of ``ring_attention_bwd_ref`` (from the plain ring's o and
    lse) against ``jax.vjp`` of JAX's differentiable RDMA ring (the dq and
    dk/dv ring kernels in interpret mode) and against autograd of the
    port's plain ring, at the shapes of JAX's ring-gradient test: n = 1 (no
    hops), 2 (hops, no slot reuse), 3 (first reuse), 8 (steady
    back-pressure)."""
    rng = np.random.default_rng(11)
    S, H, D = n * 32 * max(1, 8 // n), 4, 32
    q, k, v, w = (rng.standard_normal((1, S, H, D)).astype(np.float32)
                  for _ in range(4))
    scale = D ** -0.5

    mesh = Mesh(np.array(jax.devices()[:n]), ("seq",))
    ring = jax.shard_map(
        lambda q, k, v: jax_rdma.ring_flash_attention_rdma_diff(
            q, k, v, scale, "seq", n),
        mesh=mesh, in_specs=(P(None, "seq"),) * 3, out_specs=P(None, "seq"),
        check_vma=False)
    sh = NamedSharding(mesh, P(None, "seq"))
    ref = jax.jit(lambda q, k, v, w: jax.vjp(ring, q, k, v)[1](w))(
        *(jax.device_put(jnp.asarray(a), sh) for a in (q, k, v, w)))

    args = [_stack(a, n) for a in (q, k, v)]
    o, lse = port_seq.ring_flash_attention(*args, scale)
    got = port_seq.ring_attention_bwd_ref(*args, o, lse, _stack(w, n), scale)
    leaves = [a.clone().requires_grad_() for a in args]
    torch.autograd.backward(port_seq.ring_flash_attention(*leaves, scale)[0],
                            _stack(w, n))
    for name, g, r, auto in zip("qkv", got, ref, leaves):
        assert g.shape == (n, 1, S // n, H, D) and g.dtype == torch.float32
        np.testing.assert_allclose(g.reshape(1, S, H, D).numpy(),
                                   np.asarray(r), err_msg=name, **RING_TOL)
        np.testing.assert_allclose(g.numpy(), auto.grad.numpy(),
                                   err_msg=f"autograd {name}", **RING_TOL)


def test_ring_bwd_ref_rounds_at_the_kernels_points():
    """In bf16 the plain version rounds p and ds to bf16 before their
    products and each gradient once, as the kernels do: it stays within a
    few bf16 steps of the fp32 gradients and differs from them."""
    g = torch.Generator().manual_seed(4)
    q, k, v, do = (torch.randn((2, 1, 40, 2, 64), generator=g)
                   for _ in range(4))
    o, lse = port_seq.ring_flash_attention(q, k, v, 0.125)
    full = port_seq.ring_attention_bwd_ref(q, k, v, o, lse, do, 0.125)
    bf = [t.bfloat16() for t in (q, k, v)]
    o16, lse16 = port_seq.ring_flash_attention(*bf, 0.125)
    half = port_seq.ring_attention_bwd_ref(*bf, o16, lse16, do.bfloat16(),
                                           0.125)
    for a, b in zip(half, full):
        assert a.dtype == torch.bfloat16
        err = ((a.float() - b).norm() / b.norm()).item()
        assert 0 < err < 2e-2


# ---------------------------------------------------------------------------
# the sharded loss
# ---------------------------------------------------------------------------

N_RANKS, V, H, W = 4, 8, 16, 24


def _loss_inputs(B, seed):
    batch = make_dummy_batch(B, V, H, W, seed=seed)
    rng = np.random.default_rng(seed)
    preds = {"pts3d_in_other_view": rng.standard_normal((B, V, H, W, 3)),
             "pts3d_local": rng.standard_normal((B, V, H, W, 3)),
             "conf": 1 + rng.random((B, V, H, W)),
             "conf_local": 1 + rng.random((B, V, H, W))}
    preds = {k: a.astype(np.float32) for k, a in preds.items()}
    gts = {k: batch[k] for k in ("pts3d", "valid_mask", "camera_pose")}
    return gts, preds


def _jax_sharded_loss(gts, preds, cfg, B):
    """JAX's seq_sharded_conf_loss under shard_map: views over 4 'seq'
    devices, and for B = 2 the samples over 2 'data' devices (its data-axis
    pooling)."""
    if B == 1:
        mesh = Mesh(np.array(jax.devices()[:N_RANKS]), ("seq",))
        data_axis, spec = None, P(None, "seq")
    else:
        mesh = Mesh(np.array(jax.devices()[:B * N_RANKS]).reshape(B, N_RANKS),
                    ("data", "seq"))
        data_axis, spec = "data", P("data", "seq")
    fn = jax.jit(jax.shard_map(
        lambda g, p: jax_seq.seq_sharded_conf_loss(g, p, cfg, "seq",
                                                   data_axis=data_axis),
        mesh=mesh, in_specs=({k: spec for k in gts}, {k: spec for k in preds}),
        out_specs=P(), check_vma=False))
    sh = NamedSharding(mesh, spec)
    put = {k: jax.device_put(jnp.asarray(a), sh) for k, a in gts.items()}
    pp = {k: jax.device_put(jnp.asarray(a), sh) for k, a in preds.items()}
    return float(fn(put, pp))


@pytest.mark.parametrize("B,gt_scale", [(1, False), (1, True), (2, False)])
def test_seq_sharded_conf_loss_matches_jax(B, gt_scale):
    """The loss over 4 rank-stacked shards against JAX's under shard_map
    (B = 2: a 2 x 4 data x seq mesh) and against the port's own
    single-device ``conf_loss_multiview_v2`` on the unsharded views."""
    gts, preds = _loss_inputs(B, seed=5 + B)
    ref = _jax_sharded_loss(gts, preds, jl.LossConfig(gt_scale=gt_scale), B)
    cfg = tl.LossConfig(gt_scale=gt_scale)
    got = port_seq.seq_sharded_conf_loss(
        {k: _to_ranks(a, N_RANKS) for k, a in gts.items()},
        {k: _to_ranks(a, N_RANKS) for k, a in preds.items()}, cfg)
    single, _ = tl.conf_loss_multiview_v2(
        {k: torch.from_numpy(a) for k, a in gts.items()},
        {k: torch.from_numpy(a) for k, a in preds.items()}, cfg)
    np.testing.assert_allclose(got.item(), ref, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got.item(), single.item(), rtol=LOSS_RTOL)


def test_seq_sharded_conf_loss_norms_over_all_ranks():
    """The joint factor is one mean over every rank's views: with one
    rank's predictions scaled by 5 the loss moves and still equals the
    single-device loss on the same views (a factor taken per rank would
    cancel that rank's scale and miss it)."""
    gts, preds = _loss_inputs(1, seed=9)
    g = {k: _to_ranks(a, N_RANKS) for k, a in gts.items()}
    p = {k: _to_ranks(a, N_RANKS) for k, a in preds.items()}
    base = port_seq.seq_sharded_conf_loss(g, p, tl.LossConfig(with_local=False))
    p2 = dict(p, pts3d_in_other_view=p["pts3d_in_other_view"].clone())
    p2["pts3d_in_other_view"][3] *= 5.0
    moved = port_seq.seq_sharded_conf_loss(g, p2,
                                           tl.LossConfig(with_local=False))
    single, _ = tl.conf_loss_multiview_v2(
        {k: torch.from_numpy(a) for k, a in gts.items()},
        {"pts3d_in_other_view": p2["pts3d_in_other_view"].transpose(0, 1)
         .reshape(1, V, H, W, 3), "conf": torch.from_numpy(preds["conf"])},
        tl.LossConfig(with_local=False))
    assert abs(moved.item() - base.item()) > 1e-3
    np.testing.assert_allclose(moved.item(), single.item(), rtol=LOSS_RTOL)


def test_perview_norm_factor_matches_jax():
    gts, preds = _loss_inputs(2, seed=3)
    pts, valid = preds["pts3d_local"], gts["valid_mask"]
    ref = jl._perview_norm_factor(jnp.asarray(pts), jnp.asarray(valid),
                                  "avg_dis")
    got = tl._perview_norm_factor(torch.from_numpy(pts),
                                  torch.from_numpy(valid), "avg_dis")
    assert got.shape == (2, V)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=LOSS_RTOL)


# ---------------------------------------------------------------------------
# one training step
# ---------------------------------------------------------------------------

STEP_CASES = {  # name -> (samples B, views V, ranks n)
    "seq4": (1, 8, 4),
    "data2_seq2": (2, 4, 2),
}
STEP_HW = (48, 64)


STEPS = 2  # the first at lr 0 (warmup), so only the second moves params


@pytest.fixture(scope="module")
def jax_seq_steps():
    """For each case: JAX's make_seq_sharded_train_step(ring_impl="xla")
    STEPS times on one batch from the numpy-filled tiny params (a 4-device
    'seq' mesh, or a 2 x 2 data x seq mesh), with the batch, the image ids
    and the metrics of each step, and the params after the last."""
    jcfg = jf.Fast3RConfig.tiny()
    params = _jax_params(jcfg)
    ocfg = js.OptimConfig(**OPT)
    out = {}
    for name, (B, nv, n) in STEP_CASES.items():
        devs = np.array(jax.devices()[:B * n])
        if B == 1:
            mesh, kw, spec = Mesh(devs, ("seq",)), {}, P(None, "seq")
        else:
            mesh = Mesh(devs.reshape(B, n), ("data", "seq"))
            kw, spec = {"data_axis": "data"}, P("data", "seq")
        batch = {k: a for k, a in make_dummy_batch(B, nv, *STEP_HW,
                                                   seed=0).items()
                 if k in BATCH_KEYS}
        state = js.init_train_state(jax.tree.map(jnp.copy, params), ocfg,
                                    jax.random.key(1))
        step = jax_seq.make_seq_sharded_train_step(
            jcfg, ocfg, mesh, remat=False, ring_impl="xla", **kw)
        sh = NamedSharding(mesh, spec)
        sharded = {k: jax.device_put(jnp.asarray(a), sh)
                   for k, a in batch.items()}
        steps = []
        for _ in range(STEPS):
            _, step_rng = jax.random.split(state.rng)
            step_rng = jax.random.fold_in(step_rng, state.step)
            ids = np.asarray(sample_random_image_ids(step_rng, B, nv))
            state, m = step(state, sharded)
            steps.append((ids, jax.tree.map(np.asarray, m)))
        out[name] = (batch, steps, jax.tree.map(np.asarray, state.params))
    return _port_cfg(jcfg), params, out


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_seq_sharded_train_step_matches_jax(jax_seq_steps, case):
    """Two steps of the port's seq-sharded step (plain ring, no remat) on
    the tiny model, 48x64 views, against JAX's (XLA ring) with the same
    params and JAX's image ids: 8 views over 4 ranks, and 2 samples x 4
    views over 2 ranks against JAX's 2D data x seq mesh.  The second step
    runs at lr > 0, so the updated params are held to JAX's."""
    cfg, params, out = jax_seq_steps
    batch, jsteps, jparams = out[case]
    n = STEP_CASES[case][2]
    net = Fast3R.from_jax_params(jax.tree.map(np.asarray, params), cfg,
                                 device="cpu").params.train()
    init = {k: p.detach().clone() for k, p in net.named_parameters()}
    state = ts.init_train_state(net, ts.OptimConfig(**OPT))
    step = port_seq.make_seq_sharded_train_step(
        cfg, ts.OptimConfig(**OPT), n, remat=False, ring_impl="plain",
        device="cpu")
    for i, (ids, jm) in enumerate(jsteps):
        state, m = step(state, batch, torch.tensor(ids))
        assert state.step == i + 1 and state.opt_state.count == i + 1
        assert int(m["skipped_nonfinite"]) == 0 == int(jm["skipped_nonfinite"])
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(m["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-3)
    assert m["lr"] > 0
    assert any(not torch.equal(p, init[k])
               for k, p in state.params.named_parameters())
    got = params_to_jax(dict(state.params.named_parameters()), cfg)
    _assert_tree_close(got, jparams, PARAM_TOL, f"{case} params")


def test_seq_sharded_train_step_matches_single_device_step(jax_seq_steps):
    """With remat, 2 ranks and the ids drawn from the state's generator, two
    seq-sharded steps equal two of the port's own ``train_step`` on the
    plain decoder road (the same ids: both draw from a generator seeded
    0), the second step's update included."""
    cfg, params, out = jax_seq_steps
    batch = out["data2_seq2"][0]
    cfg = cfg.with_fused_blocks(False)
    net = Fast3R.from_jax_params(jax.tree.map(np.asarray, params), cfg,
                                 device="cpu").params.train()
    opt = ts.OptimConfig(**OPT)
    s1 = ts.init_train_state(copy.deepcopy(net), opt)
    s2 = ts.init_train_state(net, opt)
    seq_step = port_seq.make_seq_sharded_train_step(
        cfg, opt, 2, ring_impl="plain", device="cpu")
    for _ in range(STEPS):
        _, m1 = ts.train_step(s1, dict(batch, true_shapes=np.tile(
            np.array(STEP_HW, np.int32), (2, 4, 1))), cfg, opt, remat=True)
        _, m2 = seq_step(s2, batch)
        for k in m1:
            np.testing.assert_allclose(np.asarray(m2[k]), np.asarray(m1[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
    assert m2["lr"] > 0
    for (name, a), (_, b) in zip(s2.params.named_parameters(),
                                 s1.params.named_parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   err_msg=name, **PARAM_TOL)


# ---------------------------------------------------------------------------
# the rules of the wrappers
# ---------------------------------------------------------------------------

def test_seq_sharded_train_step_rejects(jax_seq_steps):
    cfg, params, out = jax_seq_steps
    opt = ts.OptimConfig(**OPT)
    with pytest.raises(ValueError, match="ring_impl"):
        port_seq.make_seq_sharded_train_step(cfg, opt, 2, ring_impl="xla",
                                             device="cpu")
    llama = cfg.__class__(encoder=cfg.encoder, head=cfg.head,
                          decoder=LlamaDecoderConfig(
                              enc_embed_dim=64, embed_dim=64, n_layers=2,
                              n_heads=2))
    with pytest.raises(NotImplementedError, match="llama"):
        port_seq.make_seq_sharded_train_step(llama, opt, 2, device="cpu")
    net = Fast3R.from_jax_params(jax.tree.map(np.asarray, params), cfg,
                                 device="cpu").params
    batch = out["seq4"][0]
    step = port_seq.make_seq_sharded_train_step(cfg, opt, 3, ring_impl="plain",
                                                device="cpu")
    with pytest.raises(ValueError, match="% ranks"):
        step(ts.init_train_state(net, opt), batch)
    on_gpu = port_seq.make_seq_sharded_train_step(cfg, opt, 4)
    with pytest.raises(ValueError, match="params are on cpu"):
        on_gpu(ts.init_train_state(net, opt), batch)


def test_rdma_diff_and_backward_on_cpu_tensors_raise(jax_seq_steps):
    """The differentiable ring and its backward never run the plain ring
    quietly: CPU tensors raise, and so does the seq-sharded step with the
    kernels on CPU params; no launch is counted."""
    counts = (port_rdma.ring_flash_attention_rdma, port_rdma.ring_attention_bwd_dq,
              port_rdma.ring_attention_bwd_dkv)
    before = [f.launches for f in counts]
    q = torch.zeros((2, 1, 64, 2, 64), requires_grad=True)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        port_rdma.ring_flash_attention_rdma_diff(q, q, q, 0.125, 2)
    lse = torch.zeros((2, 2, 64))
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        port_rdma._ring_backward(q, q, q, q, lse, q, 0.125, 2)
    cfg, params, out = jax_seq_steps
    opt = ts.OptimConfig(**OPT)
    net = Fast3R.from_jax_params(jax.tree.map(np.asarray, params), cfg,
                                 device="cpu").params
    step = port_seq.make_seq_sharded_train_step(cfg, opt, 4, ring_impl="rdma",
                                                device="cpu")
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        step(ts.init_train_state(net, opt), out["seq4"][0])
    assert [f.launches for f in counts] == before
