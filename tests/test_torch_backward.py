"""Gradients of the port's kernel modules against ``jax.vjp`` of fast3r_tpu's
on the CPU.

The JAX side runs its Pallas kernels in TPU interpret mode (as
tests/test_torch_fused_block.py runs them), at shapes where each function
really takes its kernel: the LayerNorm backward ``_bwd_kernel``, the packed
flash backward ``_bwd_dq_kernel_packed`` / ``_bwd_dkv_kernel_packed``
(asserted through ``packed_flash_supported``), the fused-qkv backward
``_fusedqkv_bwd_kernel`` (``packed_qkv_bwd_supported``) and the replay
``_ln_matmul_replay_kernel`` behind every fused product's VJP.  The port's
side is each function under autograd, which on CPU tensors runs its
autograd Function with the plain versions of the kernels.  Inputs and
cotangents are numpy-seeded float32, the same numbers to both.

Tolerance: float32, 2e-5 absolute and relative on values of order 1, 1e-4
on the larger weight gradients (sums over 256 rows); both sides compute
every step in fp32 and differ only in summation order.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from fast3r_torch.nn import fused_block as tfb
from fast3r_torch.nn.layers import Block
from fast3r_torch.ops import batched_attention as tba
from fast3r_torch.ops import flash_attention as tfa
from fast3r_torch.ops import fused_layernorm as tln
from fast3r_torch.ops import rope2d as trope

from fast3r_tpu.nn import fused_block as jfb
from fast3r_tpu.ops import rope2d as jrope

from torch_threads import few_torch_threads  # noqa: F401 (autouse)

B, N, C, HEADS = 2, 128, 256, 4
HD = C // HEADS
M = B * N
EPS = 1e-6
TOL = dict(rtol=2e-5, atol=2e-5)
TOL_W = dict(rtol=1e-4, atol=1e-4)


def _rng(seed):
    return np.random.default_rng(seed)


def _uni(rng, shape):
    bound = 1.0 / np.sqrt(shape[0])
    return rng.uniform(-bound, bound, shape).astype(np.float32)


def _vec(rng, n, scale, base=0.0):
    return (base + scale * rng.standard_normal(n)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_()


def _port_grads(fn, args, cot):
    """Gradients of fn(*args) (torch leaves from numpy) for the cotangent."""
    leaves = [_t(a) for a in args]
    out = fn(*leaves)
    outs = out if isinstance(out, tuple) else (out,)
    cots = cot if isinstance(cot, tuple) else (cot,)
    torch.autograd.backward(outs, [torch.from_numpy(c) for c in cots])
    return [t.grad.numpy() for t in leaves]


def _jax_grads(fn, args, cot):
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in args])
        return [np.asarray(g) for g in vjp(
            tuple(jnp.asarray(c) for c in cot) if isinstance(cot, tuple)
            else jnp.asarray(cot))]


def _close(port, ref, names, tol=TOL):
    for p, r, n in zip(port, ref, names):
        assert p.shape == r.shape, n
        np.testing.assert_allclose(p, r, err_msg=n, **tol)


def _ln_inputs(seed, n_out):
    rng = _rng(seed)
    x = (rng.standard_normal((M, C)) * 2 + 0.5).astype(np.float32)
    return (x, _vec(rng, C, 0.1, 1.0), _vec(rng, C, 0.1), _uni(rng, (C, n_out)),
            _vec(rng, n_out, 0.02)), rng


def test_layernorm_vjp_matches_jax():
    """ops.fused_layernorm at 256 rows, where _pick_rows takes the Pallas
    backward kernel."""
    from fast3r_tpu.ops.fused_layernorm import _pick_rows, fused_layernorm

    assert _pick_rows(M, C, live_tiles=8) > 0
    rng = _rng(0)
    args = ((rng.standard_normal((B, N, C)) * 3 + 1).astype(np.float32),
            _vec(rng, C, 0.1, 1.0), _vec(rng, C, 0.1))
    dy = rng.standard_normal((B, N, C)).astype(np.float32)
    ref = _jax_grads(lambda x, s, b: fused_layernorm(x, s, b, EPS), args, dy)
    got = _port_grads(lambda x, s, b: tln.fused_layernorm(x, s, b, EPS), args,
                      dy)
    _close(got, ref, ("dx", "dscale", "dbias"), TOL_W)


def test_flash_attention_vjp_matches_jax():
    """The decoder's flash attention at (1, 768, 2, 64): the JAX side takes
    the packed head-group forward with lse and the packed backward
    kernels."""
    from fast3r_tpu.ops.flash_attention import (flash_attention,
                                                packed_flash_supported)

    shape = (1, 768, 2, 64)
    assert packed_flash_supported(shape, shape, 4)
    rng = _rng(1)
    args = tuple(rng.standard_normal(shape).astype(np.float32)
                 for _ in range(3))
    do = rng.standard_normal(shape).astype(np.float32)
    ref = _jax_grads(lambda q, k, v: flash_attention(q, k, v, 0.15), args, do)
    got = _port_grads(lambda q, k, v: tfa.flash_attention(q, k, v, 0.15),
                      args, do)
    _close(got, ref, ("dq", "dk", "dv"))


def test_packed_qkv_attention_vjp_matches_jax():
    """The encoder's packed (3, B, N, C) attention: the JAX backward is
    _fusedqkv_bwd_kernel (packed_qkv_bwd_supported)."""
    from fast3r_tpu.ops.batched_attention import (packed_qkv_attention,
                                                  packed_qkv_bwd_supported)

    assert packed_qkv_bwd_supported((B, N, HEADS, HD), jnp.float32)
    rng = _rng(2)
    qkv3 = rng.standard_normal((3, B, N, C)).astype(np.float32)
    do = rng.standard_normal((B, N, C)).astype(np.float32)
    ref = _jax_grads(lambda t: packed_qkv_attention(t, HEADS, 0.125), (qkv3,),
                     do)
    got = _port_grads(lambda t: tba.packed_qkv_attention(t, HEADS, 0.125),
                      (qkv3,), do)
    _close(got, ref, ("dqkv",))


@pytest.mark.parametrize("act", [None, "gelu"])
def test_ln_matmul_replay_matches_jax(act):
    """(y, u, mean, rstd, z) of the replay against _ln_matmul_replay."""
    (x, g, b, w, bias), _ = _ln_inputs(3, 4 * C)
    ref = jfb._ln_matmul_replay(*map(jnp.asarray, (x, g, b, w, bias)), EPS,
                                act)
    got = tfb.ln_matmul_replay(*map(torch.from_numpy, (x, g, b)),
                               torch.from_numpy(w.T.copy()),
                               torch.from_numpy(bias), EPS, act=act)
    assert (got[4] is None) == (act is None)
    names = ("y", "u", "mean", "rstd", "z")
    for i, (p, r) in enumerate(zip(got, ref)):
        r = np.asarray(r)
        np.testing.assert_allclose(p.numpy(), r.reshape(p.shape),
                                   err_msg=names[i], **TOL)


@pytest.mark.parametrize("act", [None, "gelu"])
def test_ln_matmul_vjp_matches_jax(act):
    args, rng = _ln_inputs(4, 4 * C)
    g = rng.standard_normal((M, 4 * C)).astype(np.float32)
    ref = _jax_grads(lambda *a: jfb.ln_matmul(*a, EPS, act=act), args, g)
    pargs = args[:3] + (args[3].T.copy(), args[4])
    got = _port_grads(lambda *a: tfb.ln_matmul(*a, EPS, act=act), pargs, g)
    got[3] = got[3].T
    _close(got, ref, ("dx", "dgamma", "dbeta", "dw", "dbias"), TOL_W)


def test_ln_qkv_vjp_matches_jax():
    args, rng = _ln_inputs(5, 3 * C)
    g = tuple(rng.standard_normal((M, C)).astype(np.float32) for _ in range(3))
    ref = _jax_grads(lambda *a: tuple(jfb.ln_qkv(*a, EPS)), args, g)
    pargs = args[:3] + (args[3].T.copy(), args[4])
    got = _port_grads(lambda *a: tfb.ln_qkv(*a, EPS), pargs, g)
    got[3] = got[3].T
    _close(got, ref, ("dx", "dgamma", "dbeta", "dw", "dbias"), TOL_W)


def _tables(pos, dt_j=jnp.float32, dt_t=torch.float32):
    jc, js = jrope.rope2d_cos_sin(jnp.asarray(pos), HD, 100.0)
    tc, ts = trope.rope2d_cos_sin(torch.from_numpy(pos), HD, 100.0)
    return ((jc, js) + jrope.expand_rope_tables(jc, js, C, dt_j),
            (tc, ts) + trope.expand_rope_tables(tc, ts, C, dt_t))


def _pos():
    pos = np.stack(np.meshgrid(np.arange(8), np.arange(16), indexing="ij"),
                   -1).reshape(-1, 2)
    return np.broadcast_to(pos[None], (B, N, 2)).astype(np.int32).copy()


def test_ln_qkv_rope_vjp_matches_jax():
    """The RoPE backward is RoPE with the sine negated."""
    args, rng = _ln_inputs(6, 3 * C)
    (_, _, jct, jst), (_, _, tct, tst) = _tables(_pos())
    g = rng.standard_normal((3, M, C)).astype(np.float32)
    ref = _jax_grads(lambda *a: jfb.ln_qkv_rope(*a, jct, jst, HEADS, EPS),
                     args, g)
    pargs = args[:3] + (args[3].T.copy(), args[4])
    got = _port_grads(lambda *a: tfb.ln_qkv_rope(*a, tct, tst, HEADS, EPS),
                      pargs, g)
    got[3] = got[3].T
    _close(got, ref, ("dx", "dgamma", "dbeta", "dw", "dbias"), TOL_W)


def test_matmul_residual_vjp_matches_jax():
    rng = _rng(7)
    args = (rng.standard_normal((M, 4 * C)).astype(np.float32) * 0.5,
            _uni(rng, (4 * C, C)), _vec(rng, C, 0.02),
            rng.standard_normal((M, C)).astype(np.float32))
    g = rng.standard_normal((M, C)).astype(np.float32)
    ref = _jax_grads(jfb.matmul_residual, args, g)
    pargs = (args[0], args[1].T.copy(), args[2], args[3])
    got = _port_grads(tfb.matmul_residual, pargs, g)
    got[1] = got[1].T
    _close(got, ref, ("dx", "dw", "dbias", "dresidual"), TOL_W)


def test_ln_mlp_vjp_matches_jax():
    """The whole-MLP VJP replays the two-kernel road on both sides."""
    rng = _rng(8)
    args = ((rng.standard_normal((M, C)) * 2 + 0.5).astype(np.float32),
            _vec(rng, C, 0.1, 1.0), _vec(rng, C, 0.1), _uni(rng, (C, 4 * C)),
            _vec(rng, 4 * C, 0.02), _uni(rng, (4 * C, C)), _vec(rng, C, 0.02))
    g = rng.standard_normal((M, C)).astype(np.float32)
    ref = _jax_grads(lambda *a: jfb.ln_mlp(*a, EPS), args, g)
    pargs = (*args[:3], args[3].T.copy(), args[4], args[5].T.copy(), args[6])
    got = _port_grads(lambda *a: tfb.ln_mlp(*a, EPS), pargs, g)
    got[3], got[5] = got[3].T, got[5].T
    _close(got, ref, ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2"),
           TOL_W)


_BLOCK_KEYS = (("norm1", "scale"), ("norm1", "bias"), ("attn", "qkv", "w"),
               ("attn", "qkv", "b"), ("attn", "proj", "w"),
               ("attn", "proj", "b"), ("norm2", "scale"), ("norm2", "bias"),
               ("mlp", "fc1", "w"), ("mlp", "fc1", "b"), ("mlp", "fc2", "w"),
               ("mlp", "fc2", "b"))


@pytest.mark.parametrize("prefer_fused_mlp", [True, False])
@pytest.mark.parametrize("road", ["encoder", "decoder"])
def test_fused_vit_block_vjp_matches_jax(road, prefer_fused_mlp, monkeypatch):
    """The fused block's custom VJP (recompute from (x, params)): the encoder
    road (RoPE, packed qkv, packed attention) and the decoder road (ln_qkv,
    attention), on the whole-MLP and the two-kernel MLP roads."""
    monkeypatch.setattr(tfb, "PREFER_FUSED_MLP", prefer_fused_mlp)
    monkeypatch.setattr(jfb, "PREFER_FUSED_MLP", prefer_fused_mlp)
    rng = _rng(9)
    shapes = {"scale": (C,), "bias": (C,), "qkv": (C, 3 * C),
              "proj": (C, C), "fc1": (C, 4 * C), "fc2": (4 * C, C)}
    leaves = []
    for key in _BLOCK_KEYS:
        if key[-1] == "scale":
            leaves.append(_vec(rng, C, 0.1, 1.0))
        elif key[-1] == "bias":
            leaves.append(_vec(rng, C, 0.1))
        elif key[-1] == "w":
            leaves.append(_uni(rng, shapes[key[1]]))
        else:
            leaves.append(_vec(rng, shapes[key[1]][1], 0.02))
    x = (rng.standard_normal((B, N, C)) * 2 + 0.5).astype(np.float32)
    g = rng.standard_normal((B, N, C)).astype(np.float32)
    jrope_t, trope_t = _tables(_pos()) if road == "encoder" else (None, None)
    impl = "batched" if road == "encoder" else "pallas"

    def jax_block(x, *ls):
        p = {}
        for key, a in zip(_BLOCK_KEYS, ls):
            node = p
            for k in key[:-1]:
                node = node.setdefault(k, {})
            node[key[-1]] = a
        return jfb.fused_vit_block(p, x, jrope_t, HEADS, HD ** -0.5, impl, EPS)

    ref = _jax_grads(jax_block, (x, *leaves), g)

    blk = Block(C)
    names = tfb.BLOCK_PARAMS
    with torch.no_grad():
        for name, key, a in zip(names, _BLOCK_KEYS, leaves):
            blk.get_parameter(name).copy_(torch.from_numpy(
                a.T.copy() if key[-1] == "w" else a))
    xt = _t(x)
    y = tfb.fused_vit_block(blk, xt, trope_t, HEADS, HD ** -0.5, impl, EPS)
    torch.autograd.backward(y, torch.from_numpy(g))
    got = [xt.grad.numpy()] + [
        blk.get_parameter(n).grad.numpy().T if k[-1] == "w"
        else blk.get_parameter(n).grad.numpy()
        for n, k in zip(names, _BLOCK_KEYS)]
    _close(got, ref, ("dx",) + names, TOL_W)


def test_backward_wrappers_count_no_launch_on_cpu():
    """On the CPU the backward runs the plain versions: nothing counted."""
    fns = (tfa.attention_bwd, tba.packed_qkv_attention_bwd, tln.layernorm_bwd,
           tfb.ln_matmul_replay)
    before = [f.launches for f in fns]
    test_packed_qkv_attention_vjp_matches_jax()
    test_layernorm_vjp_matches_jax()
    assert [f.launches for f in fns] == before


def test_backward_wrappers_raise_off_cuda_and_cpu():
    """A device with no kernel raises instead of falling back."""
    x = torch.zeros((4, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tln.layernorm_bwd(x, torch.ones(64, device="meta"), x, 1e-6)
    w = torch.zeros((128, 64), device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no kernel"):
        tfb.ln_matmul_replay(x.bfloat16(), x[0], x[0], w, w[:, 0], 1e-6)
