"""The port's fused ViT-block functions (fast3r_torch.nn.fused_block and
fast3r_torch.ops.batched_attention) against fast3r_tpu's on the CPU.

The JAX side is called directly, its Pallas kernels in interpret mode (as
tests/test_fused_block.py runs them); the port's side is each function's
plain version, which is what its wrapper takes for CPU tensors.  The same
numpy-seeded inputs go to both at B, N, C, H = 2, 128, 256, 4, in float32 and
in bfloat16 (each array rounded once from the same float32 values, so both
sides start from identical numbers).  Weights go to JAX as (in, out) and to
the port transposed, in the nn.Linear layout.

Tolerances, elementwise |port - jax| <= atol + rtol * |jax|:
  * float32: 2e-5 absolute and relative.  Both sides compute every step in
    fp32 and differ only in summation order (and JAX's interpret-mode GELU
    is the A&S erf, max abs error 1.5e-7).
  * bfloat16: rtol 2^-7, one bf16 step (outputs are rounded once from fp32
    values that differ in their last fp32 bits, so they can land one bf16
    step apart).  The atol covers an intermediate that rounds to the other
    side of a bf16 step (LN output, q / k before the rotation, the MLP's h):
    its step of 2^-8 relative moves an output that sums many such terms by
    about 2^-8 of the terms' scale, which is larger than one output step
    where the sum cancels.  ATOL_BF16 states it per function, beside the
    excess over the rtol term measured at these inputs.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fast3r_torch.nn import fused_block as tfb
from fast3r_torch.nn.layers import Block, vit_block
from fast3r_torch.ops import batched_attention as tba
from fast3r_torch.ops import rope2d as trope

from fast3r_tpu.nn import fused_block as jfb
from fast3r_tpu.ops import rope2d as jrope

from torch_threads import few_torch_threads  # noqa: F401 (autouse)

B, N, C, HEADS = 2, 128, 256, 4
HD = C // HEADS
M = B * N
EPS = 1e-6

F32_TOL = dict(rtol=2e-5, atol=2e-5)
RTOL_BF16 = 2 ** -7
ATOL_BF16 = {  # measured excess over the rtol term in brackets
    "ln_matmul": 2e-3,        # outputs up to ~3 (1.1e-4)
    "ln_qkv": 2e-3,           # (below 1e-6)
    "ln_qkv_rope": 4e-3,      # plus q / k rounded before the rotation (0)
    "matmul_residual": 2e-3,  # outputs up to ~9 (below 1e-6)
    "ln_mlp": 4e-3,           # plus h rounded between fc1 and fc2 (1.2e-4)
    "attention": 4e-3,        # p rounded before / weights after (1.1e-3)
    "block": 3e-2,            # every rounding of the block in turn, outputs
}                             # up to ~9 (1.5e-2)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def arrays():
    """float32 numpy inputs: x, the block's params (JAX layout) and the rope
    positions of an 8 x 16 patch grid."""
    rng = np.random.default_rng(0)

    def uni(shape):
        bound = 1.0 / np.sqrt(shape[0])
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    def vec(n, scale, base=0.0):
        return (base + scale * rng.standard_normal(n)).astype(np.float32)

    p = {
        "norm1": {"scale": vec(C, 0.1, 1.0), "bias": vec(C, 0.1)},
        "attn": {"qkv": {"w": uni((C, 3 * C)), "b": vec(3 * C, 0.02)},
                 "proj": {"w": uni((C, C)), "b": vec(C, 0.02)}},
        "norm2": {"scale": vec(C, 0.1, 1.0), "bias": vec(C, 0.1)},
        "mlp": {"fc1": {"w": uni((C, 4 * C)), "b": vec(4 * C, 0.02)},
                "fc2": {"w": uni((4 * C, C)), "b": vec(C, 0.02)}},
    }
    x = (rng.standard_normal((B, N, C)) * 2 + 0.5).astype(np.float32)
    pos = np.stack(np.meshgrid(np.arange(8), np.arange(16), indexing="ij"),
                   -1).reshape(-1, 2)
    pos = np.broadcast_to(pos[None], (B, N, 2)).astype(np.int32).copy()
    return x, p, pos


def _j(a, dt):
    return jnp.asarray(a, dtype=dt)


def _t(a, dt):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dt)


def _tw(a, dt):
    """A JAX (in, out) weight in the port's (out, in) layout."""
    return _t(a.T, dt)


def _close(out, ref, name, dtype):
    a = out.float().numpy()
    b = np.asarray(jnp.asarray(ref, jnp.float32))
    assert a.shape == b.shape, name
    if dtype == "float32":
        np.testing.assert_allclose(a, b, err_msg=name, **F32_TOL)
    else:
        np.testing.assert_allclose(a, b, rtol=RTOL_BF16,
                                   atol=ATOL_BF16[name], err_msg=name)


def _rope_tables(pos, jdt, tdt):
    jc, js = jrope.rope2d_cos_sin(jnp.asarray(pos), HD, 100.0)
    tc, ts = trope.rope2d_cos_sin(torch.from_numpy(pos), HD, 100.0)
    return ((jc, js) + jrope.expand_rope_tables(jc, js, C, jdt),
            (tc, ts) + trope.expand_rope_tables(tc, ts, C, tdt))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("act", [None, "gelu"])
def test_ln_matmul_matches_jax(arrays, dtype, act):
    x, p, _ = arrays
    jdt, tdt = DTYPES[dtype]
    n, fc = p["norm2"], p["mlp"]["fc1"]
    ref = jfb.ln_matmul(_j(x.reshape(M, C), jdt), _j(n["scale"], jdt),
                        _j(n["bias"], jdt), _j(fc["w"], jdt), _j(fc["b"], jdt),
                        EPS, act=act)
    out = tfb.ln_matmul(_t(x.reshape(M, C), tdt), _t(n["scale"], tdt),
                        _t(n["bias"], tdt), _tw(fc["w"], tdt), _t(fc["b"], tdt),
                        EPS, act=act)
    assert out.dtype == tdt
    _close(out, ref, "ln_matmul", dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ln_qkv_matches_jax(arrays, dtype):
    x, p, _ = arrays
    jdt, tdt = DTYPES[dtype]
    n, qkv = p["norm1"], p["attn"]["qkv"]
    ref = jfb.ln_qkv(_j(x.reshape(M, C), jdt), _j(n["scale"], jdt),
                     _j(n["bias"], jdt), _j(qkv["w"], jdt), _j(qkv["b"], jdt),
                     EPS)
    out = tfb.ln_qkv(_t(x.reshape(M, C), tdt), _t(n["scale"], tdt),
                     _t(n["bias"], tdt), _tw(qkv["w"], tdt), _t(qkv["b"], tdt),
                     EPS)
    assert len(out) == 3
    for o, r in zip(out, ref):
        _close(o, r, "ln_qkv", dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ln_qkv_rope_matches_jax(arrays, dtype):
    """Packed (3, M, C) output; the lane tables rounded to the dtype."""
    x, p, pos = arrays
    jdt, tdt = DTYPES[dtype]
    (_, _, jct, jst), (_, _, tct, tst) = _rope_tables(pos, jdt, tdt)
    n, qkv = p["norm1"], p["attn"]["qkv"]
    ref = jfb.ln_qkv_rope(_j(x.reshape(M, C), jdt), _j(n["scale"], jdt),
                          _j(n["bias"], jdt), _j(qkv["w"], jdt),
                          _j(qkv["b"], jdt), jct, jst, HEADS, EPS)
    out = tfb.ln_qkv_rope(_t(x.reshape(M, C), tdt), _t(n["scale"], tdt),
                          _t(n["bias"], tdt), _tw(qkv["w"], tdt),
                          _t(qkv["b"], tdt), tct, tst, HEADS, EPS)
    assert out.shape == (3, M, C) and out.dtype == tdt
    _close(out, ref, "ln_qkv_rope", dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_matmul_residual_matches_jax(arrays, dtype):
    x, p, _ = arrays
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    h = rng.standard_normal((M, C)).astype(np.float32) * 0.5
    proj = p["attn"]["proj"]
    ref = jfb.matmul_residual(_j(h, jdt), _j(proj["w"], jdt),
                              _j(proj["b"], jdt), _j(x.reshape(M, C), jdt))
    out = tfb.matmul_residual(_t(h, tdt), _tw(proj["w"], tdt),
                              _t(proj["b"], tdt), _t(x.reshape(M, C), tdt))
    _close(out, ref, "matmul_residual", dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ln_mlp_matches_jax(arrays, dtype):
    x, p, _ = arrays
    jdt, tdt = DTYPES[dtype]
    n, f1, f2 = p["norm2"], p["mlp"]["fc1"], p["mlp"]["fc2"]
    ref = jfb.ln_mlp(_j(x.reshape(M, C), jdt), _j(n["scale"], jdt),
                     _j(n["bias"], jdt), _j(f1["w"], jdt), _j(f1["b"], jdt),
                     _j(f2["w"], jdt), _j(f2["b"], jdt), EPS)
    out = tfb.ln_mlp(_t(x.reshape(M, C), tdt), _t(n["scale"], tdt),
                     _t(n["bias"], tdt), _tw(f1["w"], tdt), _t(f1["b"], tdt),
                     _tw(f2["w"], tdt), _t(f2["b"], tdt), EPS)
    _close(out, ref, "ln_mlp", dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_packed_qkv_attention_matches_jax(dtype):
    """The fused-qkv Pallas kernel (interpret mode) on a (3, B, N, C)
    buffer vs the port's attention on strided views of the same buffer."""
    from fast3r_tpu.ops.batched_attention import packed_qkv_attention

    jdt, tdt = DTYPES[dtype]
    qkv3 = np.random.default_rng(2).standard_normal((3, B, N, C)).astype(
        np.float32)
    ref = packed_qkv_attention(_j(qkv3, jdt), HEADS, 0.125)
    out = tba.packed_qkv_attention(_t(qkv3, tdt), HEADS, 0.125)
    assert out.shape == (B, N, C) and out.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32_TOL)
    else:
        _close(out, ref, "attention", dtype)


def _port_block(p, tdt):
    blk = Block(C)
    sd = {"norm1.weight": p["norm1"]["scale"], "norm1.bias": p["norm1"]["bias"],
          "attn.qkv.weight": p["attn"]["qkv"]["w"].T,
          "attn.qkv.bias": p["attn"]["qkv"]["b"],
          "attn.proj.weight": p["attn"]["proj"]["w"].T,
          "attn.proj.bias": p["attn"]["proj"]["b"],
          "norm2.weight": p["norm2"]["scale"], "norm2.bias": p["norm2"]["bias"],
          "mlp.fc1.weight": p["mlp"]["fc1"]["w"].T,
          "mlp.fc1.bias": p["mlp"]["fc1"]["b"],
          "mlp.fc2.weight": p["mlp"]["fc2"]["w"].T,
          "mlp.fc2.bias": p["mlp"]["fc2"]["b"]}
    blk.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                         for k, v in sd.items()})
    return blk.to(tdt).eval().requires_grad_(False)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("road", ["encoder", "decoder"])
def test_fused_vit_block_matches_jax(arrays, dtype, road):
    """The whole fused block: the encoder road (RoPE 4-tuple, "batched":
    ln_qkv_rope -> packed attention) and the decoder road (no RoPE,
    "pallas": ln_qkv -> attention), each -> matmul_residual -> ln_mlp."""
    from jax.experimental.pallas import tpu as pltpu

    x, p, pos = arrays
    jdt, tdt = DTYPES[dtype]
    jp = jax.tree.map(lambda a: _j(a, jdt), p)
    blk = _port_block(p, tdt)
    scale = HD ** -0.5
    if road == "encoder":
        jrope_t, trope_t = _rope_tables(pos, jdt, tdt)
        impl = "batched"
    else:
        jrope_t = trope_t = None
        impl = "pallas"
    with pltpu.force_tpu_interpret_mode():
        ref = jfb.fused_vit_block(jp, _j(x, jdt), jrope_t, HEADS, scale, impl,
                                  EPS)
    out = tfb.fused_vit_block(blk, _t(x, tdt), trope_t, HEADS, scale, impl,
                              EPS)
    assert out.shape == (B, N, C) and out.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32_TOL)
    else:
        _close(out, ref, "block", dtype)


@pytest.mark.parametrize("prefer_fused_mlp", [True, False])
def test_fused_block_equals_plain_block_fp32(arrays, prefer_fused_mlp,
                                             monkeypatch):
    """On the port's own parameters (the plain road's Block, unchanged), the
    fused road and the plain composition agree in fp32 on both MLP roads,
    through ``vit_block(fused=)``."""
    monkeypatch.setattr(tfb, "PREFER_FUSED_MLP", prefer_fused_mlp)
    x, p, pos = arrays
    blk = _port_block(p, torch.float32)
    tc, ts = trope.rope2d_cos_sin(torch.from_numpy(pos), HD, 100.0)
    xt = torch.from_numpy(x)
    ref = vit_block(blk, xt, HEADS, HD ** -0.5, (tc, ts), "batched", EPS)
    out = vit_block(blk, xt, HEADS, HD ** -0.5,
                    (tc, ts) + trope.expand_rope_tables(tc, ts, C,
                                                        torch.float32),
                    "batched", EPS, fused=True)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **F32_TOL)


def test_rope_lane_helpers_match_jax():
    """expand_rope_tables bit-equal in float32; rotate_half_lanes exact."""
    rng = np.random.default_rng(3)
    pos = rng.integers(0, 40, size=(2, 30, 2)).astype(np.int32)
    jc, js = jrope.rope2d_cos_sin(jnp.asarray(pos), HD, 100.0)
    tc, ts = trope.rope2d_cos_sin(torch.from_numpy(pos), HD, 100.0)
    jct, jst = jrope.expand_rope_tables(jc, js, C, jnp.float32)
    tct, tst = trope.expand_rope_tables(tc, ts, C, torch.float32)
    np.testing.assert_allclose(tct.numpy(), np.asarray(jct), atol=1e-6)
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), atol=1e-6)
    x = rng.standard_normal((60, C)).astype(np.float32)
    np.testing.assert_array_equal(
        trope.rotate_half_lanes(torch.from_numpy(x), HD // 2).numpy(),
        np.asarray(jrope.rotate_half_lanes(jnp.asarray(x), HD // 2)))


def test_fused_wrappers_count_no_launch_on_cpu(arrays):
    """The CPU road is the plain version: no kernel, no launch counted."""
    x, p, _ = arrays
    before = {f: f.launches for f in (tfb.ln_matmul, tfb.ln_qkv,
                                      tfb.ln_qkv_rope, tfb.matmul_residual,
                                      tfb.ln_mlp, tba.packed_qkv_attention)}
    blk = _port_block(p, torch.float32)
    tfb.fused_vit_block(blk, torch.from_numpy(x), None, HEADS, 0.125,
                        "pallas", EPS)
    assert {f: f.launches for f in before} == before
