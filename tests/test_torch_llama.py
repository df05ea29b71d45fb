"""The port's llama-decoder slice (fast3r_torch.models.llama_decoder, the RMS
products and the fused llama block of fast3r_torch.nn.fused_block, the
llama branches of fast3r_forward, config_from_reference_args and the
converter) against fast3r_tpu on the CPU.

The JAX side runs as its own tests run it off the TPU: the RMS primitives
and ``fused_llama_block`` are Pallas kernels in interpret mode (as in
tests/test_fused_llama.py), the model forward takes its plain llama blocks.
The port's side is each function's plain version, which is what its wrapper
takes for CPU tensors.  The same numpy-seeded inputs go to both; weights go
to JAX as (in, out) and to the port transposed.  Torch cannot reproduce
threefry, so the port takes the rotary ids JAX draws.

Tolerances, elementwise |port - jax| <= atol + rtol * |jax|:
  * float32: 2e-5 absolute and relative for forwards (summation order
    only), 1e-4 for gradients (as tests/test_torch_backward.py), the
    model's outputs 2e-4 (as tests/test_torch_model.py) and the training
    steps those of tests/test_torch_train.py (1e-5 relative on the loss and
    norms, updated params 1e-4 relative plus 2e-5 absolute).
  * bfloat16: rtol 2^-7 (one bf16 step of the output) plus a per-function
    atol for an intermediate that rounds to the other side of a bf16 step
    (x * rstd, u, q / k before the rotation, h1 * h3), ATOL_BF16, with the
    excess over the rtol term measured at these inputs in brackets.
"""

import dataclasses
import pathlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import fast3r_torch
from fast3r_torch.inference import Fast3R
from fast3r_torch.inference import config_from_reference_args
from fast3r_torch.models import llama_decoder as tld
from fast3r_torch.nn import fused_block as tfb
from fast3r_torch.train import step as ts
from fast3r_torch.utils.convert import params_from_jax, params_to_jax

from fast3r_tpu.inference import config_from_reference_args as jconfig_args
from fast3r_tpu.models import fast3r as jf
from fast3r_tpu.models import llama_decoder as jld
from fast3r_tpu.models.decoder import sample_random_image_ids
from fast3r_tpu.nn import fused_block as jfb
from fast3r_tpu.train import step as js

from torch_threads import few_torch_threads  # noqa: F401 (autouse)

REPO = pathlib.Path(__file__).resolve().parents[1]
B, S, D, HEADS = 2, 128, 256, 4
M = B * S
EPS = 1e-5
F32_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)
RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=2e-5)
RTOL_BF16 = 2 ** -7
ATOL_BF16 = {  # measured excess over the rtol term in brackets
    "rms_matmul": 2e-3,         # outputs up to ~2.7 (1.4e-7)
    "rms_qkv3": 2e-3,           # (1.4e-7)
    "rms_replay": 2e-3,         # y, u and z, up to ~4.7 (1.3e-8)
    "rotary": 1e-6,             # one rounding of the same fp32 values (0)
    "rmsnorm": 1e-6,            # (0)
    "block": 1e-2,              # every rounding of the block, outputs up
}                               # to ~4.5 (2.5e-3)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _j(a, dt=jnp.float32):
    return jnp.asarray(a, dtype=dt)


def _t(a, dt=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a))).to(dt)


def _tw(a, dt=torch.float32):
    """A JAX (in, out) weight in the port's (out, in) layout."""
    return _t(np.asarray(a).T, dt)


def _close(out, ref, name, dtype, tol=None):
    a = out.detach().float().numpy()
    b = np.asarray(jnp.asarray(ref, jnp.float32))
    assert a.shape == b.shape, (name, a.shape, b.shape)
    if dtype == "float32":
        np.testing.assert_allclose(a, b, err_msg=name, **(tol or F32_TOL))
    else:
        np.testing.assert_allclose(a, b, rtol=RTOL_BF16,
                                   atol=ATOL_BF16[name], err_msg=name)


def _cfgs(n_kv_heads=None, attn_impl="naive"):
    """(JAX, port) block configs: D 256, 4 heads of 64, hidden 768."""
    kw = dict(embed_dim=D, enc_embed_dim=D, n_layers=1, n_heads=HEADS,
              n_kv_heads=n_kv_heads, multiple_of=128, norm_eps=EPS)
    return (jld.LlamaDecoderConfig(**kw, attn_impl=attn_impl),
            tld.LlamaDecoderConfig(**kw, attn_impl=attn_impl))


def _block_params(cfg, seed=0):
    """numpy JAX-layout params of one llama block: weights
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)), RMS scales 1 + N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def uni(n_in, n_out):
        b = 1.0 / np.sqrt(n_in)
        return {"w": rng.uniform(-b, b, (n_in, n_out)).astype(np.float32)}

    def scale():
        return {"scale": (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)}

    kvd, hid = cfg.kv_heads * cfg.head_dim, cfg.ffn_hidden
    return {"attention_norm": scale(),
            "attn": {"wq": uni(D, D), "wk": uni(D, kvd), "wv": uni(D, kvd),
                     "wo": uni(D, D)},
            "ffn_norm": scale(),
            "ffn": {"w1": uni(D, hid), "w2": uni(hid, D), "w3": uni(D, hid)}}


def _port_block(p, cfg, dt):
    blk = tld.LlamaBlock(cfg)
    sd = {"attention_norm.weight": p["attention_norm"]["scale"],
          "ffn_norm.weight": p["ffn_norm"]["scale"]}
    for grp in ("attn", "ffn"):
        for name, leaf in p[grp].items():
            sd[f"{grp}.{name}.weight"] = leaf["w"].T
    blk.load_state_dict({k: _t(v) for k, v in sd.items()})
    return blk.to(dt)


def _rope(cfg, seed=2):
    """fp32 (B, S, hd / 2) cos / sin of random ids below 64, both sides."""
    cos_t, sin_t = jld.freqs_cos_sin_table(cfg.head_dim, 64, cfg.rope_theta)
    ids = np.random.default_rng(seed).integers(0, 64, (B, S))
    return cos_t[ids], sin_t[ids]


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((M, D)) * 2 + 0.5).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)

    def w(n):
        b = 1.0 / np.sqrt(D)
        return rng.uniform(-b, b, (D, n)).astype(np.float32)

    return x, gamma, {n: w(n) for n in (768, 512)}


# --------------------------------------------------------------------------
# rotary table, rotary, rmsnorm
# --------------------------------------------------------------------------

@pytest.mark.parametrize("head_dim,end,theta", [(64, 1000, 10000.0),
                                                (32, 50, 500.0)])
def test_freqs_table_matches_jax(head_dim, end, theta):
    jc, js_ = jld.freqs_cos_sin_table(head_dim, end, theta)
    tc, ts_ = tld.freqs_cos_sin_table(head_dim, end, theta)
    assert tc.dtype == np.float32 and tc.shape == (end, head_dim // 2)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(ts_, js_)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_apply_rotary_pairs_matches_jax(dtype):
    """Consecutive pairs, rotated in fp32 and rounded once."""
    jdt, tdt = DTYPES[dtype]
    jcfg, _ = _cfgs()
    cos, sin = _rope(jcfg)
    x = np.random.default_rng(4).standard_normal((B, S, HEADS, 64)).astype(
        np.float32)
    ref = jld.apply_rotary_pairs(_j(x, jdt), _j(cos), _j(sin))
    out = tld.apply_rotary_pairs(_t(x, tdt), _t(cos), _t(sin))
    assert out.dtype == tdt
    _close(out, ref, "rotary", dtype)
    # pairs, not halves: lanes 0 and 1 rotate together
    ones = torch.zeros((1, 1, 1, 4))
    ones[..., 0] = 1.0
    rot = tld.apply_rotary_pairs(ones, torch.tensor([[[0.0, 1.0]]]),
                                 torch.tensor([[[1.0, 0.0]]]))
    assert rot.flatten().tolist() == [0.0, 1.0, 0.0, 0.0]


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rmsnorm_matches_jax(arrays, dtype):
    """fp32 statistics, cast to x's dtype before the scale multiply."""
    x, gamma, _ = arrays
    jdt, tdt = DTYPES[dtype]
    ref = jld.rmsnorm({"scale": _j(gamma)}, _j(x, jdt), EPS)
    norm = tld.RMSNorm(D)
    norm.weight.data = _t(gamma)
    out = tld.rmsnorm(norm, _t(x, tdt), EPS)
    assert out.dtype == tdt
    _close(out, ref, "rmsnorm", dtype)


# --------------------------------------------------------------------------
# the RMS products (K13)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", [768, 512])
@pytest.mark.parametrize("act", [None, "silu"])
def test_rms_matmul_matches_jax(arrays, dtype, n, act):
    """gamma in fp32 with bf16 activations: the forward rounds it first."""
    x, gamma, ws = arrays
    jdt, tdt = DTYPES[dtype]
    ref = jfb.rms_matmul(_j(x, jdt), _j(gamma), _j(ws[n], jdt), EPS, act=act)
    out = tfb.rms_matmul(_t(x, tdt), _t(gamma), _tw(ws[n], tdt), EPS, act=act)
    assert out.dtype == tdt
    _close(out, ref, "rms_matmul", dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n_kv_heads", [None, 2])
def test_rms_qkv3_matches_jax(arrays, dtype, n_kv_heads):
    """N = 768 (kv heads as q) and 512 (GQA: 2 kv heads of 64)."""
    x, gamma, ws = arrays
    jdt, tdt = DTYPES[dtype]
    kvd = 64 * (n_kv_heads or HEADS)
    w = ws[D + 2 * kvd]
    wq, wk, wv = w[:, :D], w[:, D:D + kvd], w[:, D + kvd:]
    ref = jfb.rms_qkv3(_j(x, jdt), _j(gamma), _j(wq, jdt), _j(wk, jdt),
                       _j(wv, jdt), EPS)
    out = tfb.rms_qkv3(_t(x, tdt), _t(gamma), _tw(wq, tdt), _tw(wk, tdt),
                       _tw(wv, tdt), EPS)
    assert [o.shape for o in out] == [(M, D), (M, kvd), (M, kvd)]
    for o, r in zip(out, ref):
        _close(o, r, "rms_qkv3", dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", [768, 512])
@pytest.mark.parametrize("act", [None, "silu"])
def test_rms_matmul_replay_matches_jax(arrays, dtype, n, act):
    """y, u, rstd and (SiLU) z of the replay; gamma multiplied in fp32."""
    x, gamma, ws = arrays
    jdt, tdt = DTYPES[dtype]
    ref = jfb._rms_matmul_replay(_j(x, jdt), _j(gamma), _j(ws[n], jdt), EPS,
                                 act)
    out = tfb.rms_matmul_replay(_t(x, tdt), _t(gamma), _tw(ws[n], tdt), EPS,
                                act)
    assert len(ref) == (4 if act else 3) and (out[3] is None) == (act is None)
    for o, r in ((out[0], ref[0]), (out[1], ref[1])) + (
            ((out[3], ref[3]),) if act else ()):
        assert o.dtype == tdt
        _close(o, r, "rms_replay", dtype)
    np.testing.assert_allclose(out[2].numpy(), np.asarray(ref[2])[:, 0],
                               rtol=1e-6)


@pytest.mark.parametrize("fn", ["rms_matmul", "rms_matmul_silu", "rms_qkv3",
                                "rms_qkv3_gqa"])
def test_rms_backward_matches_jax_vjp(arrays, fn):
    """The replay's backward (_rms_backward) against jax.vjp of the Pallas
    functions (custom VJPs over the interpret-mode replay), fp32: dx,
    dgamma and every weight's gradient."""
    x, gamma, ws = arrays
    rng = np.random.default_rng(5)
    if fn.startswith("rms_matmul"):
        act = "silu" if fn.endswith("silu") else None
        w = ws[768]
        g = rng.standard_normal((M, 768)).astype(np.float32)
        _, vjp = jax.vjp(lambda a, b, c: jfb.rms_matmul(a, b, c, EPS, act),
                         _j(x), _j(gamma), _j(w))
        ref = vjp(_j(g))
        tx, tg, tw = (_t(a).requires_grad_() for a in (x, gamma, w.T))
        torch.autograd.backward(tfb.rms_matmul(tx, tg, tw, EPS, act), _t(g))
        pairs = [(tx.grad, ref[0]), (tg.grad, ref[1]), (tw.grad.t(), ref[2])]
    else:
        kvd = 128 if fn.endswith("gqa") else D
        w = ws[D + 2 * kvd]
        parts = [w[:, :D], w[:, D:D + kvd], w[:, D + kvd:]]
        gs = [rng.standard_normal((M, p.shape[1])).astype(np.float32)
              for p in parts]
        _, vjp = jax.vjp(lambda a, b, *c: jfb.rms_qkv3(a, b, *c, EPS),
                         _j(x), _j(gamma), *(_j(p) for p in parts))
        ref = vjp(tuple(_j(g_) for g_ in gs))
        tx, tg = _t(x).requires_grad_(), _t(gamma).requires_grad_()
        tws = [_t(p.T).requires_grad_() for p in parts]
        out = tfb.rms_qkv3(tx, tg, *tws, EPS)
        torch.autograd.backward(out, [_t(g_) for g_ in gs])
        pairs = [(tx.grad, ref[0]), (tg.grad, ref[1])] + [
            (t.grad.t(), r) for t, r in zip(tws, ref[2:])]
    for i, (a, r) in enumerate(pairs):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), err_msg=str(i),
                                   **GRAD_TOL)


def test_rms_wrappers_count_no_launch_on_cpu(arrays):
    """The CPU road is the plain version: no kernel, no launch counted."""
    x, gamma, ws = arrays
    fns = (tfb.rms_matmul, tfb.rms_qkv3, tfb.rms_matmul_replay)
    before = [f.launches for f in fns]
    tx, tg, tw = _t(x), _t(gamma), _tw(ws[768])
    tfb.rms_matmul(tx, tg, tw, EPS, act="silu")
    tfb.rms_qkv3(tx, tg, tw[:256], tw[256:512], tw[512:], EPS)
    tfb.rms_matmul(tx, tg.requires_grad_(), tw, EPS)
    assert [f.launches for f in fns] == before


@pytest.mark.parametrize("fn", ["rms_matmul", "rms_qkv3", "rms_matmul_replay"])
def test_rms_wrappers_raise_off_cpu_without_kernel(fn):
    """Neither on the CPU nor on CUDA: no kernel and no fallback."""
    x = torch.empty(128, 1024, device="meta", dtype=torch.bfloat16)
    w = torch.empty(1024, 1024, device="meta", dtype=torch.bfloat16)
    g = torch.empty(1024, device="meta")
    calls = {"rms_matmul": lambda: tfb.rms_matmul(x, g, w, EPS, act="silu"),
             "rms_qkv3": lambda: tfb.rms_qkv3(x, g, w, w[:256], w[:256], EPS),
             "rms_matmul_replay": lambda: tfb.rms_matmul_replay(x, g, w, EPS)}
    with pytest.raises(ValueError, match="no kernel"):
        calls[fn]()


def test_rms_act_rejects_unknown():
    with pytest.raises(ValueError, match="gelu"):
        tfb.rms_matmul(torch.zeros(2, 256), torch.ones(256),
                       torch.zeros(128, 256), EPS, act="gelu")


# --------------------------------------------------------------------------
# the llama block: fused and plain
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n_kv_heads", [None, 2])
@pytest.mark.parametrize("fused", [True, False])
def test_llama_block_matches_jax(dtype, n_kv_heads, fused):
    """The port's fused block (plain versions) and plain block against
    JAX's fused_llama_block (interpret-mode kernels) and llama_block."""
    jdt, tdt = DTYPES[dtype]
    jcfg, tcfg = _cfgs(n_kv_heads)
    p = _block_params(jcfg)
    cos, sin = _rope(jcfg)
    x = (np.random.default_rng(1).standard_normal((B, S, D))).astype(np.float32)
    jp = jax.tree.map(lambda a: _j(a, jdt), p)
    jargs = (jp, _j(x, jdt), _j(cos), _j(sin), jcfg)
    ref = (jfb.fused_llama_block(*jargs) if fused
           else jld.llama_block(*jargs))
    blk = _port_block(p, tcfg, tdt)
    with torch.no_grad():
        out = tld.llama_block(blk, _t(x, tdt), _t(cos), _t(sin), tcfg,
                              fused=fused)
    assert out.shape == (B, S, D) and out.dtype == tdt
    _close(out, ref, "block", dtype)


@pytest.mark.parametrize("n_kv_heads", [None, 2])
@pytest.mark.parametrize("fused", [True, False])
def test_llama_block_grads_match_jax(n_kv_heads, fused):
    """fp32 gradients of x and every param for a random cotangent: the
    fused block's recompute-backward against jax.vjp of
    fb.fused_llama_block, the plain block against jax.vjp of llama_block."""
    jcfg, tcfg = _cfgs(n_kv_heads)
    p = _block_params(jcfg, seed=3)
    cos, sin = _rope(jcfg, seed=4)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    g = rng.standard_normal((B, S, D)).astype(np.float32)
    jfn = jfb.fused_llama_block if fused else jld.llama_block
    _, vjp = jax.vjp(lambda p_, x_: jfn(p_, x_, _j(cos), _j(sin), jcfg),
                     jax.tree.map(_j, p), _j(x))
    jdp, jdx = vjp(_j(g))
    blk = _port_block(p, tcfg, torch.float32)
    tx = _t(x).requires_grad_()
    y = tld.llama_block(blk, tx, _t(cos), _t(sin), tcfg, fused=fused)
    torch.autograd.backward(y, _t(g))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), **GRAD_TOL)
    for grp, names in (("attention_norm", ("scale",)), ("ffn_norm", ("scale",)),
                       ("attn", ("wq", "wk", "wv", "wo")),
                       ("ffn", ("w1", "w2", "w3"))):
        for n in names:
            if n == "scale":
                got, want = blk.get_parameter(f"{grp}.weight").grad, jdp[grp][n]
            else:
                got = blk.get_parameter(f"{grp}.{n}.weight").grad.t()
                want = jdp[grp][n]["w"]
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       err_msg=f"{grp}.{n}", **GRAD_TOL)


def test_fused_llama_supported():
    """The slice's shapes fit the port's kernels; widths they cannot take
    do not, and the decoder raises on them on CUDA (not here)."""
    cfg = tld.LlamaDecoderConfig()
    assert tfb.fused_llama_supported((1, 15360, 1024), cfg)
    assert tfb.fused_llama_supported((1, 15360, 1024),
                                     dataclasses.replace(cfg, n_kv_heads=4))
    assert not tfb.fused_llama_supported(  # the RMS prologue: K % 256
        (1, 64, 640), dataclasses.replace(cfg, embed_dim=640, n_heads=10))
    assert not tfb.fused_llama_supported(
        (1, 64, 1024), dataclasses.replace(cfg, n_heads=8))  # head_dim 128
    assert not tfb.fused_llama_supported(
        (1, 64, 2048), dataclasses.replace(cfg, embed_dim=2048, n_heads=32))


# --------------------------------------------------------------------------
# the model: decoder hooks, forward, training steps
# --------------------------------------------------------------------------

def _tiny_llama(jax_side: bool, attn_impl: str = "pallas"):
    dec_kw = dict(enc_embed_dim=64, embed_dim=64, n_layers=4, n_heads=2)
    if jax_side:
        return dataclasses.replace(jf.Fast3RConfig.tiny(),
                                   decoder=jld.LlamaDecoderConfig(**dec_kw))
    return dataclasses.replace(
        fast3r_torch.Fast3RConfig.tiny(),
        decoder=tld.LlamaDecoderConfig(**dec_kw, attn_impl=attn_impl))


def _fill(jcfg, seed=0):
    """numpy-seeded values in the param tree of ``init_fast3r(key, jcfg)``
    (stacked ``layers``): weights U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
    biases N(0, 0.02), norm scales 1 + N(0, 0.1), LayerNorm biases
    N(0, 0.1), view0_embed N(0, 0.1) (larger than the init's 0.02, so it
    shows in the outputs)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: jf.init_fast3r(k, jcfg),
                            jax.random.key(0))

    def fill(path, leaf):
        keys = [getattr(q, "key", None) for q in path]
        shape = leaf.shape[1:] if {"blocks", "layers"} & set(keys) else leaf.shape
        if keys[-1] == "scale":
            a = 1 + 0.1 * rng.standard_normal(leaf.shape)
        elif keys[-1] in ("bias", "view0_embed"):
            a = 0.1 * rng.standard_normal(leaf.shape)
        elif keys[-1] == "b":
            a = 0.02 * rng.standard_normal(leaf.shape)
        else:
            bound = 1.0 / np.sqrt(np.prod(shape[:-1]))
            a = rng.uniform(-bound, bound, leaf.shape)
        return jnp.asarray(a, jnp.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def tiny():
    jcfg, cfg = _tiny_llama(True), _tiny_llama(False)
    params = _fill(jcfg)
    model = Fast3R.from_jax_params(jax.tree.map(np.asarray, params), cfg,
                                   device="cpu")
    return jcfg, params, cfg, model


def _images(Bn, V, H, W, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (Bn, V, H, W, 3)).astype(np.float32)


def _assert_out_close(out, ref):
    assert set(out) == set(ref)
    for k in ref:
        a, b = out[k].detach().numpy(), np.asarray(ref[k])
        np.testing.assert_allclose(a, b, err_msg=k, **MODEL_TOL)


@pytest.mark.parametrize("fused", [True, False])
def test_llama_decoder_hooks_match_jax(tiny, fused):
    """Hooks 0 (post-projection), 2, 3 and 4 (normed) with JAX's drawn
    rotary ids; the view-0 mask from the arange ids."""
    jcfg, params, cfg, model = tiny
    Bn, V, P = 2, 3, 12
    feats = np.random.default_rng(7).standard_normal(
        (Bn, V * P, 64)).astype(np.float32)
    order = np.repeat(np.broadcast_to(np.arange(V), (Bn, V)), P, axis=1)
    key = jax.random.key(5)
    ref = jld.llama_decoder_forward(params["decoder"], jcfg.decoder,
                                    _j(feats), _j(order, jnp.int32), rng=key,
                                    num_views=V)
    vids = np.asarray(sample_random_image_ids(key, Bn, V))
    dcfg = dataclasses.replace(cfg.decoder, fused_blocks=fused)
    out = tld.llama_decoder_forward(model.params.decoder, dcfg, _t(feats),
                                    torch.from_numpy(order),
                                    rope_ids=torch.from_numpy(
                                        np.repeat(vids, P, axis=1)))
    assert sorted(out) == sorted(ref) == [0, 2, 3, 4]
    for h in ref:
        np.testing.assert_allclose(out[h].detach().numpy(), np.asarray(ref[h]),
                                   err_msg=str(h), **MODEL_TOL)


@pytest.mark.parametrize("fused", [True, False])
def test_llama_fast3r_forward_matches_jax(tiny, fused):
    """The tiny llama model, B=2 V=3 at 64x96, with the rotary ids JAX
    draws from jax.random.key(0) at inference; both block roads."""
    jcfg, params, cfg, model = tiny
    imgs = _images(2, 3, 64, 96)
    ref = jax.jit(lambda p, x: jf.fast3r_forward(p, jcfg, x))(params,
                                                               _j(imgs))
    ids = np.asarray(sample_random_image_ids(jax.random.key(0), 2, 3))
    with torch.no_grad():
        out = fast3r_torch.fast3r_forward(
            model.params, cfg.with_fused_blocks(fused), _t(imgs),
            view_ids=torch.from_numpy(ids))
    _assert_out_close(out, ref)


def test_llama_inference_matches_jax(tiny):
    """fast3r_torch.inference with ``image_ids`` = JAX's draw (the rotary
    index) against fast3r_tpu.inference on 3 views."""
    from fast3r_tpu.inference import Fast3R as JFast3R
    from fast3r_tpu.inference import inference as jinference

    jcfg, params, _, model = tiny
    imgs = _images(1, 3, 64, 96, seed=2)[0]
    views = [{"img": imgs[i:i + 1], "true_shape": np.int32([[64, 96]])}
             for i in range(3)]
    ref = jinference(views, JFast3R(jcfg, params), verbose=False)
    ids = np.asarray(sample_random_image_ids(jax.random.key(0), 1, 3))[0]
    out = fast3r_torch.inference(views, model, verbose=False, image_ids=ids)
    for p, r in zip(out["preds"], ref["preds"]):
        _assert_out_close(p, r)


def test_llama_mixed_shape_inference_matches_jax_composition(tiny):
    """A mixed-shape request (views 32x48, 48x80, 32x48) through the port's
    ``inference`` against the composition JAX's same-shape path computes:
    JAX's serving encoder and heads per shape group, and
    ``llama_decoder_forward`` with ``num_views=None`` and the rotary ids
    (JAX's draw) repeated by each view's own patch count.  JAX's own
    mixed-shape inference repeats them S // V times instead, which differs
    from this (a fault of the JAX package).  fp32, MODEL_TOL (2e-4,
    summation order only)."""
    from fast3r_tpu.inference import _make_encoder_fn
    from fast3r_tpu.models.dpt_head import dpt_head_forward as jhead

    jcfg, params, _, model = tiny
    shapes = [(32, 48), (48, 80), (32, 48)]
    rng = np.random.default_rng(4)
    imgs = [rng.standard_normal((1, h, w, 3)).astype(np.float32)
            for h, w in shapes]
    views = [{"img": im, "true_shape": np.int32([[h, w]])}
             for im, (h, w) in zip(imgs, shapes)]
    ids = np.asarray(sample_random_image_ids(jax.random.key(0), 1, 3))[0]
    out = fast3r_torch.inference(views, model, verbose=False, image_ids=ids)

    encode = _make_encoder_fn(jcfg)
    groups = {hw: [i for i, s in enumerate(shapes) if s == hw]
              for hw in sorted(set(shapes))}
    feats = [None] * len(shapes)
    for idxs in groups.values():
        f = encode(params, jnp.concatenate([_j(imgs[i]) for i in idxs]))
        for j, i in enumerate(idxs):
            feats[i] = f[j:j + 1]
    counts = [f.shape[1] for f in feats]
    assert counts == [6, 15, 6]  # S = 27: JAX's S // V would give 9 each
    rope = np.repeat(ids, counts)[None]
    dec = jld.llama_decoder_forward(params["decoder"], jcfg.decoder,
                                    jnp.concatenate(feats, axis=1),
                                    _j(rope, jnp.int32), num_views=None)
    offsets = np.cumsum([0] + counts)
    for (h, w), idxs in groups.items():
        toks = [jnp.concatenate([dec[k][:, offsets[i]:offsets[i + 1]]
                                 for i in idxs]) for k in jcfg.decoder.hooks]
        g = jhead(params["head_global"], jcfg.head, toks, (h, w))
        loc = jhead(params["head_local"], jcfg.head, toks, (h, w))
        for j, i in enumerate(idxs):
            ref = {"pts3d_in_other_view": g["pts3d"][j:j + 1],
                   "conf": g["conf"][j:j + 1],
                   "pts3d_local": loc["pts3d"][j:j + 1],
                   "conf_local": loc["conf"][j:j + 1]}
            _assert_out_close(out["preds"][i], ref)


BATCH_KEYS = ("imgs", "true_shapes", "pts3d", "valid_mask", "camera_pose")
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=100, eta_min=1e-5)


@pytest.fixture(scope="module")
def jax_steps(tiny):
    """Two JAX train_steps of the tiny llama model: [(ids, metrics,
    params after)] per step."""
    from fast3r_torch.data.dummy import make_dummy_batch

    jcfg, params, _, _ = tiny
    ocfg = js.OptimConfig(**OPT)
    step = jax.jit(lambda s, b: js.train_step(s, b, jcfg, ocfg, remat=True))
    state = js.init_train_state(params, ocfg, jax.random.key(1))
    out = []
    for seed in (10, 11):
        batch = {k: jnp.asarray(v) for k, v in
                 make_dummy_batch(2, 3, 32, 48, seed=seed).items()
                 if k in BATCH_KEYS}
        _, step_rng = jax.random.split(state.rng)
        step_rng = jax.random.fold_in(step_rng, state.step)
        ids = torch.tensor(np.asarray(sample_random_image_ids(step_rng, 2, 3)))
        state, m = step(state, batch)
        out.append((ids, jax.tree.map(np.asarray, m),
                    jax.tree.map(np.asarray, state.params)))
    return out


@pytest.mark.parametrize("fused", [True, False])
def test_llama_train_steps_match_jax(tiny, jax_steps, fused):
    """Two train_steps against fast3r_tpu.train.step.train_step: loss, lr,
    grad norm, every watch/ norm, and every param after each step."""
    from fast3r_torch.data.dummy import make_dummy_batch

    _, params, cfg, _ = tiny
    cfg = cfg.with_fused_blocks(fused)
    net = Fast3R.from_jax_params(jax.tree.map(np.asarray, params), cfg,
                                 device="cpu").params.train()
    state = ts.init_train_state(net, ts.OptimConfig(**OPT))
    for i, (seed, (ids, jm, jparams)) in enumerate(zip((10, 11), jax_steps)):
        state, m = ts.train_step(state, make_dummy_batch(2, 3, 32, 48,
                                                         seed=seed),
                                 cfg, ts.OptimConfig(**OPT), remat=True,
                                 view_ids=ids)
        keys = {k for k in jm if k != "skipped_nonfinite"}
        assert keys <= set(m), sorted(keys - set(m))
        for k in sorted(keys):
            np.testing.assert_allclose(np.asarray(m[k]), np.asarray(jm[k]),
                                       rtol=RTOL, atol=1e-7, err_msg=k)
        assert int(m["skipped_nonfinite"]) == 0
        got = params_to_jax(dict(state.params.named_parameters()), cfg)
        flat_p = jax.tree_util.tree_leaves_with_path(got)
        flat_j = jax.tree_util.tree_leaves_with_path(jparams)
        assert [p for p, _ in flat_p] == [p for p, _ in flat_j]
        for (path, a), (_, b) in zip(flat_p, flat_j):
            np.testing.assert_allclose(
                a, b, err_msg=f"step {i + 1} {jax.tree_util.keystr(path)}",
                **PARAM_TOL)


def test_llama_train_step_draws_rope_ids_from_generator(tiny):
    """Without view_ids the step draws the rotary ids from state.generator:
    two states seeded alike take equal steps, another seed differs, and
    view_ids override the draw."""
    from fast3r_torch.data.dummy import make_dummy_batch

    _, params, cfg, _ = tiny
    batch = make_dummy_batch(1, 3, 32, 48, seed=3)
    opt = ts.OptimConfig(**OPT)

    def loss(seed, ids=None):
        net = Fast3R.from_jax_params(jax.tree.map(np.asarray, params), cfg,
                                     device="cpu").params
        state = ts.init_train_state(net, opt, seed=seed)
        drawn = fast3r_torch.models.decoder.sample_random_image_ids(
            torch.Generator().manual_seed(seed), 1, 3)
        _, m = ts.train_step(state, batch, cfg, opt, view_ids=ids)
        return m["loss"].item(), drawn

    a, drawn = loss(0)
    assert loss(0)[0] == a and loss(1)[0] != a
    assert loss(1, ids=drawn)[0] == a


# --------------------------------------------------------------------------
# configuration and conversion
# --------------------------------------------------------------------------

def _llama_dec_args():
    import yaml

    text = (REPO / "fast3r_tpu/configs/experiment/llama_dec.yaml").read_text()
    model = yaml.safe_load(text)["model"]
    return {}, model["decoder_args"], model["head_args"]


def _assert_fields_match(port, ref, skip=("attn_impl",)):
    """Every field of the port's config equals the JAX config's."""
    assert type(port).__name__ == type(ref).__name__
    for f in dataclasses.fields(port):
        if f.name not in skip:
            assert getattr(port, f.name) == getattr(ref, f.name), f.name


@pytest.mark.parametrize("which", ["llama_dec", "fast3r"])
def test_config_from_reference_args_matches_jax(which):
    """The llama_dec.yaml overlay's args, and the default ViT decoder with
    a few keys set, against fast3r_tpu's config_from_reference_args."""
    if which == "llama_dec":
        args = _llama_dec_args()
    else:
        args = ({"embed_dim": 1024, "pos_embed": "RoPE100"},
                {"embed_dim": 1024, "depth": 24, "num_heads": 16},
                {"with_local_head": True, "conf_mode": ["exp", 1, 1e9]})
    ref = jconfig_args(*args)
    cfg = config_from_reference_args(*args)
    assert cfg.decoder_type == ref.decoder_type
    _assert_fields_match(cfg.encoder, ref.encoder)
    _assert_fields_match(cfg.decoder, ref.decoder)
    _assert_fields_match(cfg.head, ref.head)
    assert cfg.with_local_head == ref.with_local_head
    assert (cfg.encoder.attn_impl, cfg.decoder.attn_impl) == ("batched",
                                                              "pallas")


def test_llama_dec_config_is_the_slice():
    """The overlay gives the slice's decoder (the flagship's with its
    decoder replaced) and the 653,572,488-parameter model."""
    cfg = config_from_reference_args(*_llama_dec_args())
    slice_dec = tld.LlamaDecoderConfig(
        enc_embed_dim=1024, embed_dim=1024, n_layers=24, n_heads=16,
        n_kv_heads=None, multiple_of=256, norm_eps=1e-5, rope_theta=10000.0,
        max_seq_len=1000, random_image_idx_embedding=True, attn_impl="pallas",
        fused_blocks=True)
    assert cfg.decoder == slice_dec
    assert (slice_dec.ffn_hidden, slice_dec.hooks) == (2816, (0, 12, 18, 24))
    flagship = dataclasses.replace(fast3r_torch.Fast3RConfig.flagship(),
                                   decoder=slice_dec)
    with torch.device("meta"):
        net = fast3r_torch.models.fast3r.Fast3RNet(flagship)
    assert sum(p.numel() for p in net.parameters()) == 653_572_488
    assert sum(p.numel() for p in net.decoder.parameters()) == 309_382_144


def test_config_dino_encoder_raises():
    """``encoder_type: dino`` no longer raises: it builds the DINOv2
    ViT-L/14 encoder (held against fast3r_tpu in tests/test_torch_dino.py)
    at its published widths."""
    cfg = config_from_reference_args({"encoder_type": "dino"}, {}, {})
    assert cfg.encoder_type == "dino"
    assert (cfg.encoder.patch_size, cfg.encoder.embed_dim, cfg.encoder.depth,
            cfg.encoder.num_heads, cfg.encoder.pos_embed_size) == (
                14, 1024, 24, 16, 37)


def test_llama_params_round_trip(tiny):
    """params_to_jax(params_from_jax(tree)) is the llama tree leaf for leaf;
    layers unstacked, view0_embed and the RMS scales placed."""
    jcfg, params, cfg, _ = tiny
    tree = jax.tree.map(np.asarray, params)
    sd = params_from_jax(tree, cfg)
    np.testing.assert_array_equal(
        sd["decoder.layers.2.attn.wk.weight"].numpy(),
        tree["decoder"]["layers"]["attn"]["wk"]["w"][2].T)
    np.testing.assert_array_equal(sd["decoder.layers.1.ffn_norm.weight"].numpy(),
                                  tree["decoder"]["layers"]["ffn_norm"]["scale"][1])
    np.testing.assert_array_equal(sd["decoder.view0_embed"].numpy(),
                                  tree["decoder"]["view0_embed"])
    back = params_to_jax(sd, cfg)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(tree))
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                                 jax.tree_util.tree_leaves_with_path(tree)):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))


def test_llama_converter_rejects_unknown_and_missing(tiny):
    _, params, cfg, _ = tiny
    tree = jax.tree.map(np.asarray, params)
    extra = jax.tree.map(lambda a: a, tree)
    extra["decoder"]["view1_embed"] = np.zeros(64, np.float32)
    with pytest.raises(KeyError, match="view1_embed"):
        params_from_jax(extra, cfg)
    missing = jax.tree.map(lambda a: a, tree)
    del missing["decoder"]["view0_embed"]
    with pytest.raises(KeyError, match="view0_embed"):
        params_from_jax(missing, cfg)


def test_init_fills_rms_scales_and_view0_embed():
    cfg = _tiny_llama(False)
    net = fast3r_torch.init_fast3r(cfg, seed=1, device="cpu")
    assert torch.equal(net.decoder.norm.weight, torch.ones(64))
    assert torch.equal(net.decoder.layers[3].ffn_norm.weight, torch.ones(64))
    v0 = net.decoder.view0_embed
    assert 0.005 < v0.std().item() < 0.05 and torch.isfinite(v0).all()


def test_llama_trainer_fit(tiny, tmp_path):
    """Trainer.fit takes the llama configuration: two epochs of one batch,
    finite logged losses, a validation loss, and the rotary ids drawn from
    the trainer's generator."""
    import csv

    from fast3r_torch.data.dummy import make_dummy_batch
    from fast3r_torch.train.trainer import Trainer, TrainerConfig

    _, params, cfg, _ = tiny
    net = Fast3R.from_jax_params(jax.tree.map(np.asarray, params), cfg,
                                 device="cpu").params
    trainer = Trainer(cfg, ts.OptimConfig(**OPT), trainer_cfg=TrainerConfig(
        max_epochs=2, run_dir=str(tmp_path), log_every_n_steps=1), params=net)
    batches = [make_dummy_batch(1, 3, 32, 48, seed=20)]
    trainer.fit(batches, val_loaders={"val": batches})
    assert trainer.state.step == 2 and trainer.epoch == 2
    with open(tmp_path / "metrics.csv", newline="") as f:
        lines = [{k: float(v) for k, v in row.items() if v}
                 for row in csv.DictReader(f)]
    losses = [ln["loss"] for ln in lines if "loss" in ln]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert any("val/val/loss" in ln for ln in lines)
