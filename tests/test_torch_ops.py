"""Port ops (fast3r_torch.ops) against their fast3r_tpu counterparts on the CPU.

The same numpy-seeded float32 inputs go through the JAX function (its Pallas
kernels in interpret mode, as the JAX package's own tests run them) and the
port's CPU path (each kernel module's plain version).  Tolerances are stated
per test: both sides compute in float32 and differ only in summation order.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fast3r_torch.ops import (
    attention as t_attention,
    flash_attention as t_flash,
    fused_layernorm as t_ln,
    postprocess as t_post,
    resize as t_resize,
    rope2d as t_rope,
    sincos as t_sincos,
    trunk_kernel as t_trunk,
)

from torch_threads import few_torch_threads  # noqa: F401 (autouse)

DEPTH_MODE = ("exp", -float("inf"), float("inf"))
CONF_MODE = ("exp", 1.0, float("inf"))


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _qkv_views(qkv: np.ndarray):
    """q, k, v as strided views of one (B, N, 3, H, D) tensor, the layout the
    port's attention layer hands to the kernel."""
    t = _t(qkv)
    return t[:, :, 0], t[:, :, 1], t[:, :, 2]


# --------------------------------------------------------------------------
# kernel 1: LayerNorm
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 256), (2, 40, 128)])
@pytest.mark.parametrize("eps", [1e-6, 1e-5])
def test_layernorm_matches_jax_kernel(shape, eps):
    """Port LN (plain version on CPU) vs the Pallas LN kernel in interpret
    mode; random scale and bias.  fp32 two-pass statistics on both sides:
    1e-5 absolute on outputs of magnitude ~10."""
    from fast3r_tpu.ops.fused_layernorm import fused_layernorm

    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * 5 + 2).astype(np.float32)
    scale = rng.standard_normal(shape[-1]).astype(np.float32)
    bias = rng.standard_normal(shape[-1]).astype(np.float32)
    ref = np.asarray(fused_layernorm(jnp.asarray(x), jnp.asarray(scale),
                                     jnp.asarray(bias), eps))
    out = t_ln.fused_layernorm(_t(x), _t(scale), _t(bias), eps)
    assert out.dtype == torch.float32 and out.shape == shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_layernorm_bf16_matches_jax_kernel():
    """bf16 in and out at (24, 1024): the port's plain version against the
    Pallas LN kernel in interpret mode.  Both take fp32 statistics and round
    the output once, from fp32 values that differ in summation order: one
    bf16 step (2^-8 relative, ties 2^-7) on outputs of magnitude ~10."""
    from fast3r_tpu.ops.fused_layernorm import fused_layernorm

    rng = np.random.default_rng(1)
    x = (rng.standard_normal((24, 1024)) * 5 + 2).astype(np.float32)
    scale = rng.standard_normal(1024).astype(np.float32)
    bias = rng.standard_normal(1024).astype(np.float32)
    bf = jnp.bfloat16
    ref = fused_layernorm(jnp.asarray(x, bf), jnp.asarray(scale, bf),
                          jnp.asarray(bias, bf), 1e-6)
    assert ref.dtype == bf
    out = t_ln.fused_layernorm(_t(x).bfloat16(), _t(scale).bfloat16(),
                               _t(bias).bfloat16(), 1e-6)
    assert out.dtype == torch.bfloat16 and out.shape == (24, 1024)
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=2 ** -7,
                               atol=1e-6)


def test_layernorm_bf16_keeps_dtype():
    x = torch.randn(8, 128).to(torch.bfloat16)
    out = t_ln.fused_layernorm(x, torch.ones(128), torch.zeros(128), 1e-6)
    assert out.dtype == torch.bfloat16
    ref = t_ln.layernorm_ref(x.float(), torch.ones(128), torch.zeros(128), 1e-6)
    # one bf16 rounding of the output: 2^-8 relative, |y| <= ~4
    assert (out.float() - ref).abs().max() < 2e-2


# --------------------------------------------------------------------------
# kernel 2: attention
# --------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,H,D", [(2, 256, 2, 64), (2, 128, 16, 64)])
def test_attention_matches_jax_flash_kernel(B, S, H, D):
    """Decoder road: port attention vs the Pallas flash kernel in TPU
    interpret mode.  fp32, 2e-5 (the JAX package's own flash tolerance)."""
    from jax.experimental.pallas import tpu as pltpu

    from fast3r_tpu.ops import flash_attention as fa

    rng = np.random.default_rng(0)
    qkv = rng.standard_normal((B, S, 3, H, D)).astype(np.float32)
    scale = D ** -0.5
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(fa.flash_attention(
            jnp.asarray(qkv[:, :, 0]), jnp.asarray(qkv[:, :, 1]),
            jnp.asarray(qkv[:, :, 2]), scale))
    out = t_attention.dot_product_attention(*_qkv_views(qkv), scale,
                                            impl="pallas")
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shape", [(2, 128, 4, 64), (1, 256, 2, 64)])
def test_attention_matches_jax_batched_kernel(shape):
    """Encoder road: port attention vs the packed many-heads Pallas kernel
    (interpret mode) at shapes where that kernel is taken.  fp32, 2e-5."""
    from fast3r_tpu.ops.batched_attention import (
        batched_attention,
        packed_attention_supported,
    )

    assert packed_attention_supported(shape, jnp.float32)
    B, N, H, D = shape
    rng = np.random.default_rng(1)
    qkv = rng.standard_normal((B, N, 3, H, D)).astype(np.float32)
    ref = np.asarray(batched_attention(
        jnp.asarray(qkv[:, :, 0]), jnp.asarray(qkv[:, :, 1]),
        jnp.asarray(qkv[:, :, 2]), 0.125))
    out = t_attention.dot_product_attention(*_qkv_views(qkv), 0.125,
                                            impl="batched")
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)


def test_attention_ragged_and_naive_match_jax_naive():
    """A sequence that is no multiple of any tile (196 tokens, 224x224 views)
    through every implementation name vs the JAX naive path.  fp32, 1e-5."""
    from fast3r_tpu.ops.attention import dot_product_attention

    rng = np.random.default_rng(2)
    qkv = rng.standard_normal((2, 196, 3, 4, 64)).astype(np.float32)
    ref = np.asarray(dot_product_attention(
        jnp.asarray(qkv[:, :, 0]), jnp.asarray(qkv[:, :, 1]),
        jnp.asarray(qkv[:, :, 2]), 0.2, impl="naive"))
    for impl in t_attention.IMPLS:
        out = t_attention.dot_product_attention(*_qkv_views(qkv), 0.2, impl)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5,
                                   err_msg=impl)


def test_attention_unknown_impl_raises():
    """"xla" (the DINO encoder's default) is a known name, mapped to the
    attention kernel; a name of no implementation raises."""
    q = torch.zeros(1, 4, 1, 64)
    with pytest.raises(ValueError, match="unknown attention impl"):
        t_attention.dot_product_attention(q, q, q, 1.0, impl="cudnn")
    torch.testing.assert_close(
        t_attention.dot_product_attention(q, q, q, 1.0, impl="xla"),
        t_attention.dot_product_attention(q, q, q, 1.0, impl="naive"))


@pytest.mark.parametrize("fn", ["attention", "layernorm", "trunk",
                                "packed_qkv_attention", "ln_matmul", "ln_qkv",
                                "ln_qkv_rope", "matmul_residual", "ln_mlp"])
def test_kernel_wrappers_raise_off_cpu_without_kernel(fn):
    """A tensor that is neither on the CPU nor on CUDA has no kernel and no
    fallback: the wrappers raise instead of computing anything."""
    from fast3r_torch.nn import fused_block as t_fb
    from fast3r_torch.ops import batched_attention as t_ba

    x = torch.empty(2, 64, 1, 64, device="meta")
    x2 = torch.empty(128, 1024, device="meta", dtype=torch.bfloat16)
    w = torch.empty(3072, 1024, device="meta", dtype=torch.bfloat16)
    v = torch.empty(3072, device="meta")
    calls = {
        "attention": lambda: t_flash.flash_attention(x, x, x, 1.0),
        "layernorm": lambda: t_ln.fused_layernorm(x, x[0, 0, 0], x[0, 0, 0],
                                                  1e-6),
        "trunk": lambda: t_trunk.fused_regression_head_t(
            x, *[torch.empty(128, 64, 3, 3, device="meta")] * 6, 4, 4),
        "packed_qkv_attention": lambda: t_ba.packed_qkv_attention(
            torch.empty(3, 2, 64, 128, device="meta"), 2, 1.0),
        "ln_matmul": lambda: t_fb.ln_matmul(x2, v[:1024], v[:1024], w, v,
                                            1e-6, act="gelu"),
        "ln_qkv": lambda: t_fb.ln_qkv(x2, v[:1024], v[:1024], w, v, 1e-6),
        "ln_qkv_rope": lambda: t_fb.ln_qkv_rope(
            x2, v[:1024], v[:1024], w, v, x2, x2, 16, 1e-6),
        "matmul_residual": lambda: t_fb.matmul_residual(x2, w[:1024],
                                                        v[:1024], x2),
        "ln_mlp": lambda: t_fb.ln_mlp(x2, v[:1024], v[:1024], w, v, w.t(),
                                      v[:1024], 1e-6),
    }
    with pytest.raises(ValueError, match="no kernel"):
        calls[fn]()


# --------------------------------------------------------------------------
# kernel 3: regression-head trunk
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trunk_setup():
    """The JAX trunk tests' shapes: (2, 32, 16, 128) -> (64, 32)."""
    rng = np.random.default_rng(0)
    B, hh, wc, cin, c1 = 2, 32, 16, 128, 128
    x = (rng.standard_normal((B, hh, wc, cin)) * 0.3).astype(np.float32)
    w1 = (rng.standard_normal((3, 3, cin, c1)) * 0.05).astype(np.float32)
    b1 = (rng.standard_normal((c1,)) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((3, 3, c1, c1)) * 0.05).astype(np.float32)
    b2 = (rng.standard_normal((c1,)) * 0.1).astype(np.float32)
    w3 = (rng.standard_normal((1, 1, c1, 4)) * 0.05).astype(np.float32)
    b3 = (rng.standard_normal((4,)) * 0.1).astype(np.float32)
    return x, w1, b1, w2, b2, w3, b3


def _oihw(w):
    return _t(np.transpose(w, (3, 2, 0, 1)))


def test_trunk_matches_jax_kernel(trunk_setup):
    """fused_regression_head_t + postprocess_transposed: port (plain version)
    vs the Pallas trunk kernel in interpret mode.  fp32, 1e-4 relative /
    1e-5 absolute (the JAX trunk tests' tolerance)."""
    from fast3r_tpu.ops.postprocess import postprocess_transposed
    from fast3r_tpu.ops.trunk_kernel import fused_regression_head_t

    x, w1, b1, w2, b2, w3, b3 = trunk_setup
    H, W = 64, 32
    xt_ref = fused_regression_head_t(*map(jnp.asarray, trunk_setup), H, W)
    ref = postprocess_transposed(xt_ref, DEPTH_MODE, CONF_MODE, H, W)
    xt = t_trunk.fused_regression_head_t(
        _t(x), _oihw(w1), _t(b1), _oihw(w2), _t(b2), _oihw(w3), _t(b3), H, W)
    assert xt.shape == (2, 4, H * W)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xt_ref), rtol=1e-4,
                               atol=1e-5)
    out = t_post.postprocess_transposed(xt, DEPTH_MODE, CONF_MODE, H, W)
    assert set(out) == {"pts3d", "conf"}
    for k in out:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_trunk_plain_equals_channel_last_postprocess(trunk_setup):
    """The CPU head path (plain head + channel-last postprocess) and the
    CUDA path's layout (channel-major map + postprocess_transposed) give the
    same result on the same numbers: 1e-6."""
    x, w1, b1, w2, b2, w3, b3 = trunk_setup
    args = (_oihw(w1), _t(b1), _oihw(w2), _t(b2), _oihw(w3), _t(b3), 64, 32)
    y = t_trunk._plain_head(_t(x).permute(0, 3, 1, 2), *args)
    a = t_post.postprocess(y.permute(0, 2, 3, 1), DEPTH_MODE, CONF_MODE)
    b = t_post.postprocess_transposed(y.reshape(2, 4, -1), DEPTH_MODE,
                                      CONF_MODE, 64, 32)
    for k in a:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=1e-6,
                                   atol=1e-6)


# --------------------------------------------------------------------------
# plain ops on the path
# --------------------------------------------------------------------------

def test_rope2d_matches_jax():
    """cos/sin tables and the fp32 rotation: 1e-6."""
    from fast3r_tpu.ops.rope2d import apply_rope2d_bnhd, rope2d_cos_sin

    rng = np.random.default_rng(3)
    pos = rng.integers(0, 40, size=(2, 30, 2)).astype(np.int32)
    x = rng.standard_normal((2, 30, 3, 64)).astype(np.float32)
    jc, js = rope2d_cos_sin(jnp.asarray(pos), 64, 100.0)
    tc, ts = t_rope.rope2d_cos_sin(torch.from_numpy(pos), 64, 100.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    ref = apply_rope2d_bnhd(jnp.asarray(x), jc, js)
    out = t_rope.apply_rope2d_bnhd(_t(x), tc, ts)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


def test_sincos_table_matches_jax():
    from fast3r_tpu.ops.sincos import sincos_1d_table_np

    np.testing.assert_array_equal(t_sincos.sincos_1d_table_np(64, 1000),
                                  sincos_1d_table_np(64, 1000))


@pytest.mark.parametrize("hw,out_hw", [((6, 8), (12, 16)), ((12, 16), (64, 32)),
                                       ((1, 5), (3, 9))])
def test_resize_matches_jax(hw, out_hw):
    """Interp matrices bit-equal; the resize itself 1e-6 in fp32."""
    from fast3r_tpu.ops import resize as j_resize

    for o, i in zip(out_hw, hw):
        np.testing.assert_array_equal(t_resize._interp_matrix(o, i),
                                      j_resize._interp_matrix(o, i))
        for a, b in zip(t_resize._interp_taps(o, i),
                        j_resize._interp_taps(o, i)):
            np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2,) + hw + (5,)).astype(np.float32)
    ref = j_resize.resize_bilinear_align_corners(jnp.asarray(x), *out_hw)
    out = t_resize.resize_bilinear_align_corners(
        _t(x).permute(0, 3, 1, 2), *out_hw)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("depth_mode,conf_mode", [
    (DEPTH_MODE, CONF_MODE),
    (("linear", -float("inf"), float("inf")), ("sigmoid", 0.0, 2.0)),
    (("square", -float("inf"), float("inf")), ("exp", 1.0, 5.0)),
])
def test_postprocess_matches_jax(depth_mode, conf_mode):
    """Both layouts, every depth / conf mode: 1e-6 relative."""
    from fast3r_tpu.ops import postprocess as j_post

    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, 7, 4)).astype(np.float32)
    ref = j_post.postprocess(jnp.asarray(x), depth_mode, conf_mode)
    out = t_post.postprocess(_t(x), depth_mode, conf_mode)
    xt = np.ascontiguousarray(x.reshape(2, 42, 4).transpose(0, 2, 1))
    out_t = t_post.postprocess_transposed(_t(xt), depth_mode, conf_mode, 6, 7)
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
