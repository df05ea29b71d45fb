"""The port's many-view forward against fast3r_tpu on the CPU: 1000 views in
one forward (the paper's title; ``scripts/bench_1000view.py``'s call,
``fast3r_forward(..., head_chunk_views=25)``), the decoder's image-id limit
at 1001 views, and the sequence-sharded forward at 200 views.

The tiny configuration at 32x32 views (2 x 2 patches a view: S = 4000
decoder tokens at 1000 views), fp32, numpy-seeded weights and images
(``tests/test_torch_model.py``'s), the decoder image ids JAX draws from
``jax.random.key(0)`` fed to the port.  Tolerances: each output within
2e-5 of its mean magnitude against JAX (summation order through six
blocks and two heads, as the fp32 parity tests); chunked against unchunked
heads in the port within 1e-5 relative (the heads are per view: only the
batch a convolution sees changes); the sequence-sharded forward within
``tests/test_torch_sequence.py``'s 5e-4 of JAX's.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
import torch

from fast3r_torch.inference import Fast3R, inference
from fast3r_torch.models import fast3r as port_fast3r
from fast3r_torch.models.decoder import MAX_IMAGE_IDX
from fast3r_torch.models.decoder import (
    sample_random_image_ids as port_image_ids,
)
from fast3r_torch.parallel import sequence as port_seq

from fast3r_tpu.models import fast3r as jf
from fast3r_tpu.models.decoder import sample_random_image_ids
from fast3r_tpu.parallel.sequence import make_seq_sharded_forward

from test_torch_model import _jax_params, _port_cfg
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

V, H, W, CHUNK = 1000, 32, 32, 25
OUT_KEYS = ("pts3d_in_other_view", "conf", "pts3d_local", "conf_local")
MEAN_TOL = 2e-5     # of each output's mean magnitude, against JAX
CHUNK_RTOL = 1e-5   # chunked against unchunked heads, in the port
SEQ_TOL = dict(rtol=5e-4, atol=5e-4)
SEQ_V, SEQ_RANKS = 200, 4


@pytest.fixture(scope="module")
def tiny():
    """(JAX config, JAX params, the port's model of the same weights)."""
    jcfg = jf.Fast3RConfig.tiny()
    params = _jax_params(jcfg)
    model = Fast3R.from_jax_params(jax.tree.map(np.asarray, params),
                                   _port_cfg(jcfg), device="cpu")
    return jcfg, params, model


def _images(views: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (1, views, H, W, 3)).astype(np.float32)


def _forward(model, imgs, ids, chunk):
    with torch.inference_mode():
        return port_fast3r.fast3r_forward(
            model.params, model.cfg, torch.from_numpy(imgs),
            head_chunk_views=chunk, view_ids=torch.from_numpy(ids))


@pytest.fixture(scope="module")
def thousand(tiny):
    """JAX's 1000-view forward (heads in chunks of 25) and its image ids,
    and the port's forward of the same inputs with and without head
    chunks."""
    jcfg, params, model = tiny
    imgs = _images(V, seed=21)
    ids = np.array(sample_random_image_ids(jax.random.key(0), 1, V))
    ref = jax.jit(lambda p, x: jf.fast3r_forward(
        p, jcfg, x, head_chunk_views=CHUNK))(params, jnp.asarray(imgs))
    return (ids, {k: np.asarray(v) for k, v in ref.items()},
            _forward(model, imgs, ids, CHUNK),
            _forward(model, imgs, ids, None))


def test_thousand_views_match_jax(thousand):
    """1000 views in one forward, the heads over 40 chunks of 25 views,
    against JAX's; JAX's draw gives every id of the table's 1..999 once."""
    ids, ref, out, _ = thousand
    assert sorted(ids[0, 1:].tolist()) == list(range(1, MAX_IMAGE_IDX))
    assert set(out) == set(OUT_KEYS)
    for k in OUT_KEYS:
        assert out[k].shape == ref[k].shape, k
        err = np.abs(out[k].numpy() - ref[k]).max()
        assert err <= MEAN_TOL * np.abs(ref[k]).mean(), (k, err)
    assert (out["conf"] >= 1).all() and (out["conf_local"] >= 1).all()


def test_thousand_views_chunked_equal_unchunked(thousand):
    """The heads over chunks of 25 views, written into the outputs as they
    come, give the one-chunk forward's outputs."""
    _, _, chunked, whole = thousand
    for k in OUT_KEYS:
        np.testing.assert_allclose(chunked[k].numpy(), whole[k].numpy(),
                                   rtol=CHUNK_RTOL, atol=0, err_msg=k)


def test_port_draw_uses_every_id_at_1000_views():
    """At 1000 views the port's own draw, like JAX's, gives view 0 id 0 and
    the others every id of 1..999 once."""
    ids = port_image_ids(torch.Generator().manual_seed(3), 2, V)
    for row in ids.tolist():
        assert row[0] == 0 and sorted(row[1:]) == list(range(1, 1000))


def test_1001_views_raise_as_jax_does(tiny, monkeypatch):
    """At 1001 views the table's 1000 ids run out: JAX's draw comes up one
    short and its decoder's add of the table rows raises (TypeError, at
    trace time under jit); the port's draw raises, naming the table, before
    the encoder or any kernel runs: on the forward, the sequence-sharded
    forward and the serving entry."""
    jcfg, params, model = tiny
    imgs = _images(V + 1, seed=22)
    with pytest.raises(TypeError, match="broadcast"):
        jax.jit(lambda p, x: jf.fast3r_forward(
            p, jcfg, x, head_chunk_views=CHUNK))(params, jnp.asarray(imgs))

    def no_encoder(*args, **kwargs):
        raise AssertionError("the encoder ran")

    monkeypatch.setattr(port_fast3r, "encoder_forward", no_encoder)
    monkeypatch.setattr(port_seq, "encoder_forward", no_encoder)
    x = torch.from_numpy(imgs)
    with pytest.raises(ValueError, match="image-index table has 1000 rows"):
        port_fast3r.fast3r_forward(model.params, model.cfg, x,
                                   head_chunk_views=CHUNK)
    fwd = port_seq.make_seq_sharded_forward(model.cfg, 7, V + 1, (H, W),
                                            ring_impl="plain", device="cpu")
    with pytest.raises(ValueError, match="image-index table has 1000 rows"):
        fwd(model.params, x)
    views = [{"img": x[:, i]} for i in range(V + 1)]
    with pytest.raises(ValueError, match="image-index table has 1000 rows"):
        inference(views, model, verbose=False)


def test_seq_sharded_forward_at_200_views_matches_jax(tiny):
    """200 views over 4 ranks (S_loc = 200 tokens), the port's plain ring
    against JAX's sequence-sharded forward on four virtual CPU devices (its
    RDMA ring in interpret mode), JAX's image ids fed in, heads in chunks
    of 25."""
    jcfg, params, model = tiny
    imgs = _images(SEQ_V, seed=23)
    ids = np.array(sample_random_image_ids(jax.random.key(0), 1, SEQ_V)[0])
    mesh = Mesh(np.array(jax.devices()[:SEQ_RANKS]), ("seq",))
    jfwd = make_seq_sharded_forward(jcfg, mesh, num_views=SEQ_V,
                                    image_hw=(H, W), head_chunk_views=CHUNK,
                                    ring_impl="rdma")
    ref = jfwd(params, jax.device_put(jnp.asarray(imgs),
                                      NamedSharding(mesh, P(None, "seq"))))
    fwd = port_seq.make_seq_sharded_forward(
        model.cfg, SEQ_RANKS, SEQ_V, (H, W), head_chunk_views=CHUNK,
        ring_impl="plain", device="cpu")
    out = fwd(model.params, torch.from_numpy(imgs), torch.from_numpy(ids))
    assert set(out) == set(OUT_KEYS)
    for k in OUT_KEYS:
        assert out[k].shape == ref[k].shape, k
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   err_msg=k, **SEQ_TOL)
