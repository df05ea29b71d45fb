"""The port's DINOv2 encoder slice (fast3r_torch.models.dino_encoder, its
bicubic position-embedding resize, the dino branches of fast3r_forward,
the serving path, config_from_reference_args / config_to_reference_args,
the checkpoint map and the converter) against fast3r_tpu on the CPU.

The JAX side runs its plain attention ("naive"), as tests/test_dino_encoder.py
does; the port's side is each function's plain version, which its wrappers
take for CPU tensors.  The same numpy-seeded inputs and weights go to both
(weights through ``params_from_jax``); the port takes the image ids JAX
draws.  Widths are tiny: a 64-wide, 2-deep encoder of 2 heads at patch 14
with a 4 x 4 learned position grid, so every image shape here resizes it.

Tolerances, elementwise |port - jax| <= atol + rtol * |jax|, float32:
2e-5 for the resize, the encoder and the model's outputs (summation order
only), gradients 1e-4 (as tests/test_torch_backward.py); the parameters
loaded from checkpoints are compared bit for bit.
"""

import importlib
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import fast3r_torch
from fast3r_torch.inference import Fast3R, config_from_reference_args
from fast3r_torch.models import dino_encoder as tde
from fast3r_torch.ops.resize import resize_bicubic_torch
from fast3r_torch.train import losses as tl
from fast3r_torch.utils.checkpoint import (
    load_state_dict_file,
    params_from_fast3r_checkpoint,
)
from fast3r_torch.utils.checkpoint_utils import (
    config_from_dict,
    config_to_dict,
    config_to_reference_args,
)
from fast3r_torch.utils.convert import params_from_jax, params_to_jax

from fast3r_tpu.models import dino_encoder as jde
from fast3r_tpu.models import fast3r as jf
from fast3r_tpu.models.decoder import sample_random_image_ids
from fast3r_tpu.ops import resize as jresize
from fast3r_tpu.train import losses as jl
from fast3r_tpu.utils import checkpoint_utils as jcu

from test_torch_model import _jax_params
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

jinf = importlib.import_module("fast3r_tpu.inference")

F32_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
ENC_ARGS = {"encoder_type": "dino", "patch_size": 14, "embed_dim": 64,
            "depth": 2, "num_heads": 2, "pos_embed_size": 4}
DEC_ARGS = {"enc_embed_dim": 64, "embed_dim": 64, "num_heads": 2, "depth": 4}
HEAD_ARGS = {"patch_size": 14, "with_local_head": True}
H, W = 42, 56  # a 3 x 4 patch grid


def _jax_cfg():
    """The tiny dino model of the JAX package: the reference args with the
    DPT head at the JAX tiny widths."""
    cfg = jinf.config_from_reference_args(ENC_ARGS, DEC_ARGS, HEAD_ARGS,
                                          attn_impl="naive")
    return jf.Fast3RConfig(
        encoder=cfg.encoder, decoder=cfg.decoder,
        head=jf.DPTHeadConfig(patch_size=14, dim_tokens=(64, 64, 64, 64),
                              feature_dim=32, last_dim=16,
                              layer_dims=(8, 16, 24, 32)),
        with_local_head=True)


def _port_cfg(jcfg):
    cfg = config_from_reference_args(ENC_ARGS, DEC_ARGS, HEAD_ARGS)
    h = jcfg.head
    return fast3r_torch.Fast3RConfig(
        encoder=cfg.encoder, decoder=cfg.decoder,
        head=fast3r_torch.models.dpt_head.DPTHeadConfig(
            patch_size=14, feature_dim=h.feature_dim, last_dim=h.last_dim,
            layer_dims=h.layer_dims, dim_tokens=h.dim_tokens),
        with_local_head=True)


@pytest.fixture(scope="module")
def setup():
    jcfg = _jax_cfg()
    params = _jax_params(jcfg, seed=4)
    cfg = _port_cfg(jcfg)
    model = Fast3R.from_jax_params(jax.tree.map(np.asarray, params), cfg,
                                   device="cpu")
    return jcfg, params, cfg, model


def _imgs(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("mapping", ["size", "hub_offset"])
def test_resize_bicubic_matches_jax(mapping):
    """The shapes of tests/test_dino_encoder.py::test_bicubic_torch_parity:
    (1, 5, 5, 7) -> 9 x 6, the ``size=`` and hub's scale-factor mappings."""
    x = _imgs((1, 5, 5, 7), 1)
    sf = ((9 + 0.1) / 5, (6 + 0.1) / 5) if mapping == "hub_offset" else None
    ref = jresize.resize_bicubic_torch(jnp.asarray(x), 9, 6, scale_factors=sf)
    got = resize_bicubic_torch(torch.from_numpy(x), 9, 6, scale_factors=sf)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("orient", ["landscape", "portrait", "mixed"])
def test_dino_encoder_matches_jax(setup, orient):
    """Tokens (cls dropped) within 2e-5 and positions equal; a portrait
    sample's true shape is its storage shape transposed."""
    jcfg, params, cfg, model = setup
    img = _imgs((3, H, W, 3), 2)
    ts = np.array([[H, W]] * 3, np.int32)
    if orient != "landscape":
        ts[1:] = (W, H)
        if orient == "portrait":
            ts[0] = (W, H)
    ref_t, ref_p = jde.dino_encoder_forward(params["encoder"], jcfg.encoder,
                                            jnp.asarray(img), jnp.asarray(ts))
    got_t, got_p = tde.dino_encoder_forward(
        model.params.encoder, cfg.encoder, torch.from_numpy(img),
        torch.from_numpy(ts))
    np.testing.assert_allclose(got_t.detach().numpy(), np.asarray(ref_t),
                               **F32_TOL)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(ref_p))


def _hub_state_dict(cfg, seed):
    """A synthetic torch hub dinov2 state dict of ``cfg``'s shapes."""
    rng = np.random.default_rng(seed)
    c, n, hid = cfg.embed_dim, cfg.pos_embed_size, int(cfg.embed_dim * 4)
    shapes = {"patch_embed.proj.weight": (c, 3, 14, 14),
              "patch_embed.proj.bias": (c,), "cls_token": (1, 1, c),
              "pos_embed": (1, n * n + 1, c), "norm.weight": (c,),
              "norm.bias": (c,)}
    for i in range(cfg.depth):
        p = f"blocks.{i}."
        shapes.update({p + "norm1.weight": (c,), p + "norm1.bias": (c,),
                       p + "attn.qkv.weight": (3 * c, c),
                       p + "attn.qkv.bias": (3 * c,),
                       p + "attn.proj.weight": (c, c),
                       p + "attn.proj.bias": (c,),
                       p + "ls1.gamma": (c,), p + "ls2.gamma": (c,),
                       p + "norm2.weight": (c,), p + "norm2.bias": (c,),
                       p + "mlp.fc1.weight": (hid, c),
                       p + "mlp.fc1.bias": (hid,),
                       p + "mlp.fc2.weight": (c, hid),
                       p + "mlp.fc2.bias": (c,)})
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


def test_load_dinov2_state_dict_matches_jax(setup):
    """The port's load of a hub-layout state dict is, tensor for tensor,
    the JAX package's load converted to the port's layout."""
    jcfg, params, cfg, _ = setup
    sd = _hub_state_dict(cfg.encoder, 7)
    ref = params_from_jax({**jax.tree.map(np.asarray, params),
                           "encoder": jax.tree.map(
                               np.asarray,
                               jde.load_dinov2_state_dict(sd, jcfg.encoder))},
                          cfg)
    got = tde.load_dinov2_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, cfg.encoder)
    want = {k[len("encoder."):]: v for k, v in ref.items()
            if k.startswith("encoder.")}
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    # and the module takes it
    tde.DinoEncoder(cfg.encoder).load_state_dict(got, strict=True)


def test_dino_hf_round_trip(setup, tmp_path):
    """A dino model exported by fast3r_tpu's convert_checkpoint_to_hf loads
    into the port bit for bit (the LayerScale gammas stacked from their
    per-block entries); the configuration round-trips through
    config_to_reference_args, the run directory's dict and the JAX
    package's reader."""
    jcfg, params, cfg, model = setup
    out = jcu.convert_checkpoint_to_hf(jinf.Fast3R(jcfg, params),
                                       str(tmp_path / "dino"))
    with open(f"{out}/config.json") as f:
        hf = json.load(f)
    read = config_from_reference_args(hf["encoder_args"], hf["decoder_args"],
                                      hf["head_args"])
    assert read.encoder_type == "dino" and read.encoder == cfg.encoder
    assert read.decoder == cfg.decoder
    # the tiny head's widths are not in config.json (from_pretrained reads
    # published-width heads only): the map is read with the model's config
    got = params_from_fast3r_checkpoint(load_state_dict_file(out), cfg)
    want = model.params.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    args = config_to_reference_args(cfg)
    assert config_from_reference_args(args["encoder_args"],
                                      args["decoder_args"],
                                      args["head_args"]) == \
        config_from_reference_args(ENC_ARGS, DEC_ARGS, HEAD_ARGS)
    jargs = jcu.config_to_reference_args(jcfg)
    assert args["encoder_args"] == jargs["encoder_args"]
    assert config_from_dict(config_to_dict(cfg)) == cfg


def test_config_from_reference_args_matches_jax():
    """The DINO encoder's fields and the assembled decoder and head are the
    JAX package's (the attention implementation aside: the port's is one
    of its own names)."""
    j = jinf.config_from_reference_args(ENC_ARGS, DEC_ARGS, HEAD_ARGS)
    p = config_from_reference_args(ENC_ARGS, DEC_ARGS, HEAD_ARGS)
    assert p.encoder_type == j.encoder_type == "dino"
    for f in ("patch_size", "embed_dim", "depth", "num_heads", "mlp_ratio",
              "pos_embed_size", "ln_eps"):
        assert getattr(p.encoder, f) == getattr(j.encoder, f), f
    assert p.head.patch_size == j.head.patch_size == 14
    assert p.head.dim_tokens == j.head.dim_tokens
    assert (p.decoder.embed_dim, p.decoder.depth) == (64, 4)


@pytest.mark.parametrize("mixed", [True])
def test_dino_fast3r_forward_matches_jax(setup, mixed):
    """B = 2, V = 3 at 42x56 in mixed orientation (both head orientations
    and both encoder branches run); JAX's ids."""
    jcfg, params, cfg, model = setup
    B, V = 2, 3
    imgs = _imgs((B, V, H, W, 3), 3)
    shapes = np.broadcast_to(np.array([H, W], np.int32), (B, V, 2)).copy()
    if mixed:
        shapes[0, 1] = (W, H)
        shapes[1, 2] = (W, H)
    ids = np.asarray(sample_random_image_ids(jax.random.key(0), B, V))
    ref = jax.jit(lambda p, x, s: jf.fast3r_forward(
        p, jcfg, x, s, mixed_orientation=mixed))(
            params, jnp.asarray(imgs), jnp.asarray(shapes))
    out = fast3r_torch.fast3r_forward(
        model.params, cfg, torch.from_numpy(imgs), torch.from_numpy(shapes),
        mixed_orientation=mixed, view_ids=torch.tensor(ids))
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(out[k].detach().numpy(),
                                   np.asarray(ref[k]), err_msg=k, **F32_TOL)


def test_dino_mixed_shape_inference_matches_jax(setup):
    """The port's serving path on a request of two landscape and one
    portrait-stored view (the portrait branch of the encoder) against the
    JAX package's ``inference`` (its ids, drawn from key 0)."""
    jcfg, params, cfg, model = setup
    views = [{"img": _imgs((1, H, W, 3), 10 + i)} for i in range(2)]
    views.append({"img": _imgs((1, W, H, 3), 12)})
    # JAX's serving draw (key 0), handed to the port
    ids = np.asarray(sample_random_image_ids(jax.random.key(0), 1, 3))[0]
    ref = jinf.inference(views, jinf.Fast3R(jcfg, params), verbose=False)
    got = fast3r_torch.inference(views, model, verbose=False, image_ids=ids)
    for r, g in zip(ref["preds"], got["preds"]):
        assert set(r) <= set(g)
        for k in r:
            np.testing.assert_allclose(g[k].numpy(), np.asarray(r[k]),
                                       err_msg=k, **F32_TOL)


def test_dino_train_gradients_match_jax_vjp(setup):
    """The training forward's conf loss and every parameter's gradient
    (jax.grad, i.e. the vjp of the scalar loss), B = 2, V = 2, one portrait
    view: the ids JAX draws from its rng go to the port."""
    from fast3r_torch.data.dummy import make_dummy_batch

    jcfg, params, cfg, model = setup
    B, V = 2, 2
    batch = make_dummy_batch(B, V, H, W, seed=5)
    gts = {k: batch[k] for k in ("pts3d", "valid_mask", "camera_pose")}
    rng = jax.random.key(3)

    def jloss(p):
        pred = jf.fast3r_forward(p, jcfg, jnp.asarray(batch["imgs"]),
                                 jnp.asarray(batch["true_shapes"]),
                                 is_training=True, rng=rng)
        return jl.conf_loss_multiview_v2(jax.tree.map(jnp.asarray, gts),
                                         pred)[0]

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(params)
    ids = torch.tensor(np.asarray(sample_random_image_ids(rng, B, V)))
    net = Fast3R.from_jax_params(jax.tree.map(np.asarray, params), cfg,
                                 device="cpu").params.train()
    preds = fast3r_torch.fast3r_forward(
        net, cfg, torch.from_numpy(batch["imgs"]),
        torch.from_numpy(batch["true_shapes"]), view_ids=ids,
        is_training=True)
    loss, _ = tl.conf_loss_multiview_v2(
        {k: torch.from_numpy(v) for k, v in gts.items()}, preds)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    names, ps = zip(*net.named_parameters())
    grads = torch.autograd.grad(loss, ps, allow_unused=True)
    got = params_to_jax({n: torch.zeros_like(p) if g is None else g
                         for n, p, g in zip(names, ps, grads)}, cfg)
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_r = jax.tree_util.tree_leaves_with_path(ref_grads)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_r]
    for (path, a), (_, b) in zip(flat_g, flat_r):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   err_msg=jax.tree_util.keystr(path),
                                   **GRAD_TOL)


def test_dino_params_round_trip_and_init(setup):
    """params_to_jax(params_from_jax(tree)) is the JAX tree leaf for leaf
    (cls_token, pos_embed and the stacked ls1 / ls2 included); random init
    fills cls 0, LayerScale 1 and a N(0, 0.02) position table."""
    jcfg, params, cfg, model = setup
    back = params_to_jax(model.params.state_dict(), cfg)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    flat_j = jax.tree_util.tree_leaves_with_path(params)
    assert [p for p, _ in flat_b] == [p for p, _ in flat_j]
    for (path, a), (_, b) in zip(flat_b, flat_j):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=jax.tree_util.keystr(path))
    enc = Fast3R.from_random(cfg, seed=0, device="cpu").params.encoder
    assert (enc.cls_token == 0).all() and (enc.ls1 == 1).all()
    assert (enc.ls2 == 1).all()
    assert 0.01 < float(enc.pos_embed.std()) < 0.03


def test_dino_flops_match_jax(setup):
    """``utils/flops.py`` counts a DINO model as the JAX package's counter
    does (the patch-14 grid, the encoder's width and depth)."""
    from fast3r_torch.utils.flops import fast3r_forward_flops
    from fast3r_tpu.utils.flops import fast3r_forward_flops as jflops

    jcfg, _, cfg, _ = setup
    assert fast3r_forward_flops(cfg, 5, H, W) == jflops(jcfg, 5, H, W)
