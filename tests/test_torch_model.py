"""The port's model path (fast3r_torch) against fast3r_tpu on the CPU.

The weights are a JAX param tree of exactly the structure
``fast3r_tpu.models.fast3r.init_fast3r`` returns (taken with
``jax.eval_shape``), filled with numpy-seeded values at the init's scale and
with random LayerNorm scales and biases (the init's ones and zeros would hide
the affine; JAX's eager init also takes ~20 s per config on the CPU).
``params_from_jax`` loads the same tree into the port.  The same
numpy-seeded images, and the decoder image ids JAX draws from
``jax.random.key(0)`` (the port cannot reproduce threefry), go through both
forwards in float32.  Outputs are compared at
2e-4 absolute + 2e-4 relative: both sides compute in fp32 through 6-8
transformer blocks and two DPT heads, differing only in summation order
(measured differences are ~1e-6).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import fast3r_torch
from fast3r_torch.inference import Fast3R
from fast3r_torch.utils.convert import params_from_jax

from fast3r_tpu.models import fast3r as jf
from fast3r_tpu.models.decoder import sample_random_image_ids

from torch_threads import few_torch_threads  # noqa: F401 (autouse)

RTOL = ATOL = 2e-4


def _jax_narrow_cfg():
    """head_dim 64 in both stacks and a decoder on the Pallas flash kernel:
    at 2 views of 128x128 the fused sequence is 128 tokens, a multiple of
    the flash tiles, so JAX's decoder runs the kernel (interpret mode)."""
    enc = dataclasses.replace(jf.Fast3RConfig.tiny().encoder, embed_dim=128,
                              num_heads=2)
    dec = dataclasses.replace(jf.Fast3RConfig.tiny().decoder, enc_embed_dim=128,
                              embed_dim=128, num_heads=2, attn_impl="pallas")
    head = dataclasses.replace(jf.Fast3RConfig.tiny().head,
                               dim_tokens=(128, 128, 128, 128))
    return jf.Fast3RConfig(encoder=enc, decoder=dec, head=head)


def _port_cfg(jcfg):
    """The port's config with the JAX config's widths."""
    e, d, h = jcfg.encoder, jcfg.decoder, jcfg.head
    return fast3r_torch.Fast3RConfig(
        encoder=fast3r_torch.models.encoder.EncoderConfig(
            patch_size=e.patch_size, embed_dim=e.embed_dim,
            num_heads=e.num_heads, depth=e.depth),
        decoder=fast3r_torch.models.decoder.DecoderConfig(
            enc_embed_dim=d.enc_embed_dim, embed_dim=d.embed_dim,
            num_heads=d.num_heads, depth=d.depth),
        head=fast3r_torch.models.dpt_head.DPTHeadConfig(
            feature_dim=h.feature_dim, last_dim=h.last_dim,
            layer_dims=h.layer_dims, dim_tokens=h.dim_tokens),
        with_local_head=jcfg.with_local_head)


def _jax_params(jcfg, seed=0):
    """numpy-seeded values in the param tree of ``init_fast3r(key, jcfg)``:
    weights U(-1/sqrt(fan_in), 1/sqrt(fan_in)) as the init draws them,
    biases N(0, 0.02), LayerNorm scales 1 + N(0, 0.1) and biases N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: jf.init_fast3r(k, jcfg),
                            jax.random.key(0))

    def fill(path, leaf):
        keys = [getattr(p, "key", None) for p in path]
        shape = leaf.shape[1:] if "blocks" in keys else leaf.shape
        if keys[-1] == "scale":
            a = 1 + 0.1 * rng.standard_normal(leaf.shape)
        elif keys[-1] == "bias":
            a = 0.1 * rng.standard_normal(leaf.shape)
        elif keys[-1] == "b":
            a = 0.02 * rng.standard_normal(leaf.shape)
        else:
            bound = 1.0 / np.sqrt(np.prod(shape[:-1]))
            a = rng.uniform(-bound, bound, leaf.shape)
        return jnp.asarray(a, jnp.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


_MODELS = {}


def _models(name):
    """(jax cfg, jax params, port model) built once per config."""
    if name not in _MODELS:
        jcfg = jf.Fast3RConfig.tiny() if name == "tiny" else _jax_narrow_cfg()
        params = _jax_params(jcfg)
        tree = jax.tree.map(np.asarray, params)
        _MODELS[name] = (jcfg, params,
                         Fast3R.from_jax_params(tree, _port_cfg(jcfg),
                                                device="cpu"))
    return _MODELS[name]


def _assert_close(out, ref):
    """``fast3r_forward`` is differentiable: its outputs carry autograd
    history when the params require grad."""
    assert set(out) == set(ref)
    for k in ref:
        a, b = out[k].detach().numpy(), np.asarray(ref[k])
        assert a.shape == b.shape, k
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=k)


def _images(B, V, H, W, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, V, H, W, 3)).astype(np.float32)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("mixed,chunk", [(False, None), (False, 2),
                                         (True, None), (True, 3)])
def test_fast3r_forward_matches_jax(mixed, chunk, fused):
    """tiny config, B=2 V=4 at 64x96: landscape and mixed orientation, with
    and without head chunking (chunk 3 rounds down to 2 views), on the
    port's fused-GEMM blocks (the default) and on its plain blocks; the JAX
    forward takes its plain blocks off the TPU.  Both roads read the same
    converted ``Block`` parameters."""
    jcfg, params, model = _models("tiny")
    cfg = model.cfg.with_fused_blocks(fused)
    B, V, H, W = 2, 4, 64, 96
    imgs = _images(B, V, H, W)
    shapes = np.broadcast_to(np.array([H, W], np.int32), (B, V, 2)).copy()
    if mixed:
        shapes[0, 1] = (W, H)
        shapes[1, 3] = (W, H)
    ids = np.asarray(sample_random_image_ids(jax.random.key(0), B, V))
    ref = jax.jit(lambda p, x, s: jf.fast3r_forward(
        p, jcfg, x, s, mixed_orientation=mixed, head_chunk_views=chunk))(
            params, jnp.asarray(imgs), jnp.asarray(shapes))
    out = fast3r_torch.fast3r_forward(
        model.params, cfg, torch.from_numpy(imgs),
        torch.from_numpy(shapes), mixed_orientation=mixed,
        head_chunk_views=chunk, view_ids=torch.tensor(ids))
    _assert_close(out, ref)
    assert (out["conf"] >= 1).all() and (out["conf_local"] >= 1).all()


def test_fast3r_forward_narrow_flash_decoder_matches_jax():
    """head_dim 64, 2 views at 128x128: JAX's decoder attention is the
    Pallas flash kernel in TPU interpret mode."""
    from jax.experimental.pallas import tpu as pltpu

    jcfg, params, model = _models("narrow")
    imgs = _images(1, 2, 128, 128, seed=1)
    ids = np.asarray(sample_random_image_ids(jax.random.key(0), 1, 2))
    with pltpu.force_tpu_interpret_mode():
        ref = jf.fast3r_forward(params, jcfg, jnp.asarray(imgs))
    out = fast3r_torch.fast3r_forward(model.params, model.cfg,
                                      torch.from_numpy(imgs),
                                      view_ids=torch.tensor(ids))
    _assert_close(out, ref)


@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
def test_inference_matches_jax(layout):
    """fast3r_torch.inference vs fast3r_tpu.inference on 3 same-shape views,
    with the JAX-drawn image ids passed in."""
    from fast3r_tpu.inference import Fast3R as JFast3R
    from fast3r_tpu.inference import inference as jinference

    jcfg, params, model = _models("tiny")
    imgs = _images(1, 3, 64, 96, seed=2)[0]
    views = [{"img": imgs[i:i + 1], "true_shape": np.int32([[64, 96]]),
              "idx": i, "instance": str(i)} for i in range(3)]
    ref = jinference(views, JFast3R(jcfg, params), verbose=False)
    ids = np.asarray(sample_random_image_ids(jax.random.key(0), 1, 3))[0]
    if layout == "nchw":
        views = [dict(v, img=torch.from_numpy(v["img"]).permute(0, 3, 1, 2))
                 for v in views]
    out = fast3r_torch.inference(views, model, verbose=False, image_ids=ids)
    assert out["loss"] is None and len(out["preds"]) == 3
    for p, r in zip(out["preds"], ref["preds"]):
        _assert_close(p, r)


def test_inference_mixed_shapes_raise():
    """Views of mixed shapes are served (tests/test_torch_serve.py); a view
    whose true_shape differs from its stored shape raises."""
    _, _, model = _models("tiny")
    views = [{"img": np.zeros((1, 64, 96, 3), np.float32)},
             {"img": np.zeros((1, 64, 64, 3), np.float32),
              "true_shape": [[64, 96]]}]
    with pytest.raises(ValueError, match="true_shape"):
        fast3r_torch.inference(views, model, verbose=False)


def test_port_ids_are_deterministic_and_pin_view0():
    from fast3r_torch.models.decoder import sample_random_image_ids as ids

    a, b = ids(None, 2, 20), ids(None, 2, 20)
    assert torch.equal(a, b) and a.dtype == torch.int32
    assert (a[:, 0] == 0).all() and (a[:, 1:] >= 1).all() and (a < 1000).all()
    assert all(len(set(r.tolist())) == 20 for r in a)


# --------------------------------------------------------------------------
# converter
# --------------------------------------------------------------------------

def _count_leaves(tree):
    """JAX leaves with the stacked block axis counted per block."""
    n = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        keys = [getattr(p, "key", None) for p in path]
        n += np.asarray(leaf).shape[0] if "blocks" in keys else 1
    return n


@pytest.mark.parametrize("name", ["tiny", "narrow"])
def test_converter_key_for_key(name):
    """Every JAX leaf lands on exactly one port parameter and every port
    parameter is set; values arrive in the torch layouts."""
    jcfg, params, model = _models(name)
    tree = jax.tree.map(np.asarray, params)
    sd = params_from_jax(tree, model.cfg)
    assert set(sd) == set(model.params.state_dict())
    assert len(sd) == _count_leaves(tree)
    np.testing.assert_array_equal(
        sd["encoder.blocks.1.attn.qkv.weight"].numpy(),
        tree["encoder"]["blocks"]["attn"]["qkv"]["w"][1].T)
    np.testing.assert_array_equal(
        sd["head_global.refinenet.2.rcu1.conv1.weight"].numpy(),
        tree["head_global"]["refinenet"][2]["rcu1"]["conv1"]["w"]
        .transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["head_local.act1.up.weight"].numpy(),
        tree["head_local"]["act1"]["up"]["w"].transpose(2, 3, 0, 1))
    np.testing.assert_array_equal(
        sd["decoder.norm.weight"].numpy(), tree["decoder"]["norm"]["scale"])
    # the JAX init's own tree has this structure
    init_tree = jax.eval_shape(lambda k: jf.init_fast3r(k, jcfg),
                               jax.random.key(1))
    assert (jax.tree_util.tree_structure(init_tree)
            == jax.tree_util.tree_structure(params))


def test_converter_rejects_extra_and_missing_leaves():
    jcfg, params, model = _models("tiny")
    tree = jax.tree.map(np.asarray, params)
    extra = dict(tree, extra={"w": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="extra"):
        params_from_jax(extra, model.cfg)
    missing = dict(tree)
    del missing["head_local"]
    with pytest.raises(KeyError, match="head_local"):
        params_from_jax(missing, model.cfg)


def test_from_random_is_seeded_and_flagship_plain_blocks():
    """The flagship takes the fused-GEMM blocks in both stacks (the JAX
    package's default); ``with_fused_blocks(False)`` gives its plain
    blocks.  Random weights are seeded."""
    cfg = fast3r_torch.Fast3RConfig.flagship()
    assert cfg.encoder.fused_blocks and cfg.decoder.fused_blocks
    assert (cfg.encoder.attn_impl, cfg.decoder.attn_impl) == ("batched", "pallas")
    plain = cfg.with_fused_blocks(False)
    assert not plain.encoder.fused_blocks and not plain.decoder.fused_blocks
    a = Fast3R.from_random(fast3r_torch.Fast3RConfig.tiny(), seed=3,
                           device="cpu")
    b = Fast3R.from_random(fast3r_torch.Fast3RConfig.tiny(), seed=3,
                           device="cpu")
    for (ka, va), (kb, vb) in zip(a.params.state_dict().items(),
                                  b.params.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    w = a.params.decoder.blocks[0].attn.qkv.weight
    assert w.abs().max() <= 64 ** -0.5 and w.std() > 0
    assert torch.equal(a.params.encoder.norm.weight, torch.ones(64))


@pytest.mark.parametrize("entry", ["from_random", "from_jax_params",
                                   "init_fast3r", "empty_fast3r"])
def test_entry_points_default_to_cuda(entry):
    """With no device argument the model lands on the card; without one,
    torch's own error, and no fallback to the CPU."""
    from fast3r_torch.models import fast3r as tf

    cfg = fast3r_torch.Fast3RConfig.tiny()
    calls = {
        "from_random": lambda: Fast3R.from_random(cfg).params,
        "from_jax_params": lambda: Fast3R.from_jax_params(
            jax.tree.map(np.asarray, _models("tiny")[1]),
            _models("tiny")[2].cfg).params,
        "init_fast3r": lambda: tf.init_fast3r(cfg),
        "empty_fast3r": lambda: tf.empty_fast3r(cfg),
    }
    if torch.cuda.is_available():
        net = calls[entry]()
        assert next(net.parameters()).device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            calls[entry]()
