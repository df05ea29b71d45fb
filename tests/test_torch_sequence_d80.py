"""The sequence-sharded paths at head_dim 80 (model_scaling_huge's
decoder, 1280 / 16) in the port against fast3r_tpu on the CPU.

The ring kernels (K14) take head_dim 64 and 80 on the card
(``tests/test_torch_cuda.py`` holds both against the plain ring there);
here the port's plain ring, the seq-sharded forward and the seq-sharded
training step run at head_dim 80 against JAX's: its RDMA ring kernel in
Pallas interpret mode (which pads D to a lane width) and its XLA ring in
the step, as ``tests/test_torch_sequence.py`` and
``tests/test_torch_sequence_train.py`` run them at the tiny model's 32.
The model is the tiny configuration with a decoder of two heads of 80.
Tolerances are those files': the ring's o and lse 2e-5, the forward 5e-4,
the step's loss 1e-4 and gradient norm 1e-3 relative, the params after an
update (2e-3, 2e-5).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
import torch

from fast3r_torch.data.dummy import make_dummy_batch
from fast3r_torch.inference import Fast3R
from fast3r_torch.parallel import sequence as port_seq
from fast3r_torch.train import step as ts
from fast3r_torch.utils.convert import params_to_jax

from fast3r_tpu.models import fast3r as jf
from fast3r_tpu.models.decoder import sample_random_image_ids
from fast3r_tpu.parallel import sequence as jax_seq
from fast3r_tpu.train import step as js

from test_torch_model import _jax_params, _port_cfg
from test_torch_sequence import RING_TOL, SEQ_TOL, OUT_KEYS, _jax_ring, _stack
from test_torch_train import _assert_tree_close
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

HEAD_DIM = 80
PARAM_TOL = dict(rtol=2e-3, atol=2e-5)
OPT = dict(warmup_steps=2, total_steps=10)
V, H, W, N_RANKS = 8, 48, 64, 4


def _d80_cfg():
    """The tiny JAX configuration with a decoder of 2 heads of 80."""
    cfg = jf.Fast3RConfig.tiny()
    width = 2 * HEAD_DIM
    return dataclasses.replace(
        cfg, decoder=dataclasses.replace(cfg.decoder, embed_dim=width),
        head=dataclasses.replace(cfg.head, dim_tokens=(64,) + (width,) * 3))


@pytest.fixture(scope="module")
def d80():
    """(JAX cfg, JAX params, port cfg) at head_dim 80."""
    jcfg = _d80_cfg()
    cfg = _port_cfg(jcfg)
    assert cfg.decoder.head_dim == HEAD_DIM
    return jcfg, _jax_params(jcfg, seed=3), cfg


@pytest.mark.parametrize("n", [1, 3])
def test_plain_ring_matches_jax_rdma_ring_head_dim_80(n):
    """o and lse of the port's plain ring at head_dim 80 against JAX's RDMA
    ring kernel (interpret mode, D padded to its lane width) over n ranks:
    no hops, and the first slot reuse."""
    rng = np.random.default_rng(11 + n)
    S = n * 32 * max(1, 8 // n)
    q, k, v = (rng.standard_normal((1, S, 2, HEAD_DIM)).astype(np.float32)
               for _ in range(3))
    scale = HEAD_DIM ** -0.5
    o_ref, lse_ref = _jax_ring(q, k, v, scale, n)
    o, lse = port_seq.ring_flash_attention(*(_stack(a, n) for a in (q, k, v)),
                                           scale)
    np.testing.assert_allclose(o.reshape(q.shape).numpy(), o_ref, **RING_TOL)
    np.testing.assert_allclose(lse.numpy(), lse_ref.reshape(n, -1, S // n),
                               **RING_TOL)


def test_seq_sharded_forward_head_dim_80_matches_jax(d80):
    """The port's seq-sharded forward (plain ring, 4 ranks) against JAX's
    (RDMA ring kernel in interpret mode) at head_dim 80, JAX's image ids
    fed in."""
    jcfg, params, cfg = d80
    model = Fast3R.from_jax_params(jax.tree.map(np.asarray, params), cfg,
                                   device="cpu")
    imgs = np.random.default_rng(5).standard_normal(
        (1, V, H, W, 3)).astype(np.float32)
    ids = np.array(sample_random_image_ids(jax.random.key(0), 1, V)[0])
    mesh = Mesh(np.array(jax.devices()[:N_RANKS]), ("seq",))
    jfwd = jax_seq.make_seq_sharded_forward(jcfg, mesh, num_views=V,
                                            image_hw=(H, W), ring_impl="rdma")
    ref = jfwd(params, jax.device_put(jnp.asarray(imgs),
                                      NamedSharding(mesh, P(None, "seq"))))
    fwd = port_seq.make_seq_sharded_forward(cfg, N_RANKS, V, (H, W),
                                            ring_impl="plain", device="cpu")
    out = fwd(model.params, torch.from_numpy(imgs), torch.from_numpy(ids))
    for key in OUT_KEYS:
        assert out[key].shape == ref[key].shape, key
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   err_msg=key, **SEQ_TOL)


def test_seq_sharded_train_step_head_dim_80_matches_jax(d80):
    """Two steps of the port's seq-sharded step (plain ring, no remat, 8
    views over 4 ranks) against JAX's (XLA ring) at head_dim 80 with the
    same params and JAX's image ids; the second at lr > 0, so the updated
    params are held to JAX's."""
    jcfg, params, cfg = d80
    batch = {k: a for k, a in make_dummy_batch(1, V, H, W, seed=0).items()
             if k in ("imgs", "pts3d", "valid_mask", "camera_pose")}
    mesh = Mesh(np.array(jax.devices()[:N_RANKS]), ("seq",))
    ocfg = js.OptimConfig(**OPT)
    jstate = js.init_train_state(jax.tree.map(jnp.copy, params), ocfg,
                                 jax.random.key(1))
    jstep = jax_seq.make_seq_sharded_train_step(jcfg, ocfg, mesh, remat=False,
                                                ring_impl="xla")
    sh = NamedSharding(mesh, P(None, "seq"))
    sharded = {k: jax.device_put(jnp.asarray(a), sh) for k, a in batch.items()}

    net = Fast3R.from_jax_params(jax.tree.map(np.asarray, params), cfg,
                                 device="cpu").params.train()
    state = ts.init_train_state(net, ts.OptimConfig(**OPT))
    step = port_seq.make_seq_sharded_train_step(
        cfg, ts.OptimConfig(**OPT), N_RANKS, remat=False, ring_impl="plain",
        device="cpu")
    for _ in range(2):
        _, step_rng = jax.random.split(jstate.rng)
        step_rng = jax.random.fold_in(step_rng, jstate.step)
        ids = np.asarray(sample_random_image_ids(step_rng, 1, V))
        jstate, jm = jstep(jstate, sharded)
        state, m = step(state, batch, torch.tensor(ids))
        assert int(m["skipped_nonfinite"]) == 0 == int(jm["skipped_nonfinite"])
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(m["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-3)
    assert m["lr"] > 0
    _assert_tree_close(params_to_jax(dict(state.params.named_parameters()),
                                     cfg),
                       jax.tree.map(np.asarray, jstate.params), PARAM_TOL,
                       "params")


def test_check_ring_head_dim_takes_80_on_cuda(d80):
    """On a CUDA device the seq-sharded paths' check passes head_dim 64 and
    80, the ring kernels' instantiations, and raises for 96; the plain ring
    and the CPU take any head_dim."""
    _, _, cfg = d80
    port_seq._check_ring_head_dim(cfg, "rdma", "cuda")
    for hd, ok in ((64, True), (80, True), (96, False)):
        c = dataclasses.replace(cfg, decoder=dataclasses.replace(
            cfg.decoder, embed_dim=2 * hd, num_heads=2))
        assert c.decoder.head_dim == hd
        if ok:
            port_seq._check_ring_head_dim(c, "rdma", "cuda")
        else:
            with pytest.raises(ValueError, match="head_dim 64 or 80"):
                port_seq._check_ring_head_dim(c, "rdma", "cuda")
        port_seq._check_ring_head_dim(c, "plain", "cuda")
        port_seq._check_ring_head_dim(c, "rdma", "cpu")
