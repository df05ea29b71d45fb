"""The port's sequence-sharded serving forward and ring attention
(``fast3r_torch/parallel``) against ``fast3r_tpu/parallel`` on the CPU.

JAX runs as ``tests/test_sequence_parallel.py`` runs it: ``shard_map`` on
the virtual CPU mesh of ``tests/conftest.py``, the RDMA ring kernel in
Pallas interpret mode.  The port stacks the ranks on a leading axis of one
device; on the CPU its ring is the plain version
(``ring_impl="plain"``, :func:`ring_flash_attention`), since the ring kernel
exists only on the card (``tests/test_torch_cuda.py`` holds it there).
Everything is fp32 with numpy-seeded inputs.  Tolerances: the ring's o and
lse within 2e-5 absolute and relative (the bound of JAX's own ring tests);
the whole forward within 5e-4 of JAX's (the bound of JAX's seq-sharded
tests: two heads after six transformer blocks) and within 1e-4 of the
port's own single-device forward (same code but the attention, which
differs in summation order only).
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
import torch

from fast3r_torch.inference import Fast3R
from fast3r_torch.models.fast3r import fast3r_forward
from fast3r_torch.models.llama_decoder import LlamaDecoderConfig
from fast3r_torch.nn.layers import run_vit_stack
from fast3r_torch.ops.attention import dot_product_attention
from fast3r_torch.parallel import ring_rdma as port_rdma
from fast3r_torch.parallel import sequence as port_seq

from fast3r_tpu.models import fast3r as jf
from fast3r_tpu.models.decoder import sample_random_image_ids
from fast3r_tpu.parallel import ring_rdma as jax_rdma
from fast3r_tpu.parallel.sequence import make_seq_sharded_forward

from test_torch_model import _jax_params, _port_cfg
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

RING_TOL = dict(rtol=2e-5, atol=2e-5)
SEQ_TOL = dict(rtol=5e-4, atol=5e-4)
SELF_TOL = dict(rtol=1e-4, atol=1e-4)
OUT_KEYS = ("pts3d_in_other_view", "conf", "pts3d_local", "conf_local")


def _qkv(n, seed, H=4, D=32):
    """q, k, v (1, S, H, D) with S = n * 32 * max(1, 8 // n), as JAX's ring
    tests draw them."""
    rng = np.random.default_rng(seed)
    S = n * 32 * max(1, 8 // n)
    return [rng.standard_normal((1, S, H, D)).astype(np.float32)
            for _ in range(3)]


def _stack(a, n):
    """(1, S, H, D) -> rank-stacked (n, 1, S / n, H, D) torch."""
    _, S, H, D = a.shape
    return torch.from_numpy(a).reshape(n, 1, S // n, H, D)


def _jax_ring(q, k, v, scale, n, epochs=None):
    """JAX's RDMA ring forward on an n-device mesh: o (1, S, H, D) and lse
    (n, B * H, S_loc) (``_rdma_forward`` inside ``shard_map``)."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("seq",))

    def body(q, k, v):
        o, lse = jax_rdma._rdma_forward(q, k, v, scale, "seq", n,
                                        n if epochs is None else epochs)
        return o, lse[None, ..., 0]

    fn = jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(None, "seq"),) * 3,
        out_specs=(P(None, "seq"), P("seq")),
        check_vma=False))
    sh = NamedSharding(mesh, P(None, "seq"))
    o, lse = fn(*(jax.device_put(jnp.asarray(a), sh) for a in (q, k, v)))
    return np.asarray(o), np.asarray(lse)


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_plain_ring_matches_jax_rdma_ring(n):
    """o and lse of the port's plain ring against JAX's RDMA ring kernel
    (interpret mode) over n ranks: n = 1 (no hops), 2 (hops, no slot
    reuse), 3 (first reuse), 8 (steady back-pressure)."""
    q, k, v = _qkv(n, seed=7)
    scale = q.shape[-1] ** -0.5
    o_ref, lse_ref = _jax_ring(q, k, v, scale, n)
    o, lse = port_seq.ring_flash_attention(*(_stack(a, n) for a in (q, k, v)),
                                         scale)
    S_loc = q.shape[1] // n
    np.testing.assert_allclose(o.reshape(q.shape).numpy(), o_ref, **RING_TOL)
    np.testing.assert_allclose(lse.numpy(),
                               lse_ref.reshape(n, -1, S_loc), **RING_TOL)


def test_self_ring_matches_jax_and_shifts_lse():
    """Self-ring, E = 4 epochs over one rank's own slots: o equals JAX's
    self-ring (and plain attention); the lse is the plain lse + ln 4."""
    rng = np.random.default_rng(9)
    q, k, v = (rng.standard_normal((1, 256, 4, 32)).astype(np.float32)
               for _ in range(3))
    scale = 32 ** -0.5
    o_ref, _ = _jax_ring(q, k, v, scale, 1, epochs=4)
    args = [_stack(a, 1) for a in (q, k, v)]
    o, lse = port_seq.ring_flash_attention(*args, scale, epochs=4)
    np.testing.assert_allclose(o.reshape(q.shape).numpy(), o_ref, **RING_TOL)
    o1, lse1 = port_seq.ring_flash_attention(*args, scale)
    np.testing.assert_allclose(o.numpy(), o1.numpy(), **RING_TOL)
    np.testing.assert_allclose(lse.numpy(), lse1.numpy() + math.log(4),
                               **RING_TOL)


def test_merge_partials_is_exact():
    """Merging the attention over two key halves gives the attention over
    all keys, o and lse."""
    from fast3r_torch.ops.flash_attention import attention_lse_ref

    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((2, 40, 3, 16), generator=g) for _ in range(3))
    o, lse = attention_lse_ref(q, k, v, 0.3)
    a = attention_lse_ref(q, k[:, :13], v[:, :13], 0.3)
    b = attention_lse_ref(q, k[:, 13:], v[:, 13:], 0.3)
    om, lm = port_seq._merge_partials(*a, *b)
    torch.testing.assert_close(om, o, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(lm, lse, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the sequence-sharded forward
# ---------------------------------------------------------------------------

V, H, W, N_RANKS = 8, 48, 64, 4


@pytest.fixture(scope="module")
def tiny():
    """(port cfg, port model, images, JAX's image ids, JAX's seq-sharded
    rdma outputs with head_chunk_views=1 over 4 ranks)."""
    jcfg = jf.Fast3RConfig.tiny()
    params = _jax_params(jcfg)
    model = Fast3R.from_jax_params(jax.tree.map(np.asarray, params),
                                   _port_cfg(jcfg), device="cpu")
    imgs = np.random.default_rng(1).standard_normal(
        (1, V, H, W, 3)).astype(np.float32)
    ids = np.array(sample_random_image_ids(jax.random.key(0), 1, V)[0])
    mesh = Mesh(np.array(jax.devices()[:N_RANKS]), ("seq",))
    fwd = make_seq_sharded_forward(jcfg, mesh, num_views=V, image_hw=(H, W),
                                   head_chunk_views=1, ring_impl="rdma")
    out = fwd(params, jax.device_put(jnp.asarray(imgs),
                                     NamedSharding(mesh, P(None, "seq"))))
    return model, imgs, ids, {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("head_chunk_views", [None, 1])
def test_seq_sharded_forward_matches_jax(tiny, head_chunk_views):
    """The port's seq-sharded forward (plain ring, 4 ranks) against JAX's
    (RDMA ring kernel in interpret mode), JAX's image ids fed in; with and
    without head chunking (the heads are per view: chunks change nothing)."""
    model, imgs, ids, ref = tiny
    fwd = port_seq.make_seq_sharded_forward(
        model.cfg, N_RANKS, V, (H, W), head_chunk_views=head_chunk_views,
        ring_impl="plain", device="cpu")
    out = fwd(model.params, torch.from_numpy(imgs), torch.from_numpy(ids))
    assert set(out) == set(OUT_KEYS)
    for key in OUT_KEYS:
        assert out[key].shape == ref[key].shape, key
        np.testing.assert_allclose(out[key].numpy(), ref[key], err_msg=key,
                                   **SEQ_TOL)


@pytest.mark.parametrize("n", [1, 2, 8])
def test_seq_sharded_forward_matches_single_device(tiny, n):
    """The same request through the seq-sharded forward over n ranks and
    through the port's own ``fast3r_forward`` (plain decoder road, the same
    image ids)."""
    model, imgs, ids, _ = tiny
    cfg = model.cfg.with_fused_blocks(False)
    fwd = port_seq.make_seq_sharded_forward(cfg, n, V, (H, W),
                                            ring_impl="plain", device="cpu")
    x = torch.from_numpy(imgs)
    out = fwd(model.params, x, torch.from_numpy(ids))
    with torch.no_grad():
        ref = fast3r_forward(model.params, cfg, x,
                             view_ids=torch.from_numpy(ids)[None])
    for key in OUT_KEYS:
        np.testing.assert_allclose(out[key].numpy(), ref[key].numpy(),
                                   err_msg=key, **SELF_TOL)


def test_seq_sharded_forward_default_ids_are_the_single_device_ones(tiny):
    """Without view_ids both forwards draw the inference ids from a
    generator seeded 0."""
    model, imgs, _, _ = tiny
    cfg = model.cfg.with_fused_blocks(False)
    fwd = port_seq.make_seq_sharded_forward(cfg, 2, V, (H, W),
                                            ring_impl="plain", device="cpu")
    x = torch.from_numpy(imgs)
    out = fwd(model.params, x)
    with torch.no_grad():
        ref = fast3r_forward(model.params, cfg, x)
    np.testing.assert_allclose(out["conf"].numpy(), ref["conf"].numpy(),
                               **SELF_TOL)


# ---------------------------------------------------------------------------
# the rules of the wrappers
# ---------------------------------------------------------------------------

def test_seq_sharded_forward_rejects(tiny):
    model, imgs, _, _ = tiny
    cfg = model.cfg
    with pytest.raises(ValueError, match="% ranks"):
        port_seq.make_seq_sharded_forward(cfg, 3, V, (H, W), device="cpu")
    with pytest.raises(ValueError, match="ring_impl"):
        port_seq.make_seq_sharded_forward(cfg, 2, V, (H, W), ring_impl="xla",
                                          device="cpu")
    llama = cfg.__class__(encoder=cfg.encoder, head=cfg.head,
                          decoder=LlamaDecoderConfig(
                              enc_embed_dim=64, embed_dim=64, n_layers=2,
                              n_heads=2))
    with pytest.raises(NotImplementedError, match="llama"):
        port_seq.make_seq_sharded_forward(llama, 2, V, (H, W), device="cpu")
    fwd = port_seq.make_seq_sharded_forward(cfg, 2, V, (H, W),
                                            ring_impl="plain", device="cpu")
    two = torch.from_numpy(np.concatenate([imgs, imgs]))
    with pytest.raises(ValueError, match="B=1"):
        fwd(model.params, two)
    with pytest.raises(ValueError, match="imgs"):
        fwd(model.params, torch.from_numpy(imgs[:, :4]))
    on_gpu = port_seq.make_seq_sharded_forward(cfg, 2, V, (H, W))
    with pytest.raises(ValueError, match="params are on cpu"):
        on_gpu(model.params, torch.from_numpy(imgs))


def test_rdma_on_cpu_tensors_raises(tiny):
    """The ring kernel's wrapper never runs the plain ring quietly: CPU
    tensors raise, in the wrapper and through the seq-sharded forward."""
    q = torch.zeros((2, 1, 64, 2, 64))
    before = port_rdma.ring_flash_attention_rdma.launches
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        port_rdma.ring_flash_attention_rdma(q, q, q, 0.125, 2)
    model, imgs, ids, _ = tiny
    fwd = port_seq.make_seq_sharded_forward(model.cfg, 2, V, (H, W),
                                            ring_impl="rdma", device="cpu")
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        fwd(model.params, torch.from_numpy(imgs), torch.from_numpy(ids))
    assert port_rdma.ring_flash_attention_rdma.launches == before


def test_callable_attention_matches_the_string_road():
    """A callable attn_impl (q, k, v, scale) -> o serves the blocks exactly
    as the named implementation it wraps."""
    torch.manual_seed(0)
    from fast3r_torch.nn.layers import make_vit_stack

    blocks = make_vit_stack(2, 32).eval()
    x = torch.randn((2, 10, 32))
    seen = []

    def attn(q, k, v, scale):
        seen.append(tuple(q.shape))
        return dot_product_attention(q, k, v, scale, "naive")

    with torch.no_grad():
        a, ha = run_vit_stack(blocks, x, 4, 0.3, attn_impl="naive", hooks=[1])
        b, hb = run_vit_stack(blocks, x, 4, 0.3, attn_impl=attn, hooks=[1])
    assert seen == [(2, 10, 4, 8)] * 2
    assert torch.equal(a, b) and torch.equal(ha[1], hb[1])
    with pytest.raises(ValueError, match="unknown attention impl"):
        dot_product_attention(x[..., None], x[..., None], x[..., None], 1.0,
                              "cudnn")
