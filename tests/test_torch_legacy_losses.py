"""The port's legacy losses (fast3r_torch.train.losses) against fast3r_tpu's
on the CPU, and the port's FLOP counter (fast3r_torch.utils.flops) against
fast3r_tpu's.

Losses: the same numpy-seeded ground truth and predictions go through both;
every returned array (the per-pixel distances and masks, the scalar loss,
every detail) agrees within 1e-5 relative and 1e-6 absolute: both compute
in fp32 and differ in summation order only.

FLOPs: pure arithmetic on the configurations, so equality within 1e-12
relative.  For ``llama_dec`` JAX's ``decoder_flops`` reads a ViT decoder's
``depth`` and raises (``fast3r_tpu/utils/flops.py:56``); there the port's
encoder and head terms are held to JAX's and its decoder terms to the
products that ``torch.utils.flop_counter`` counts in the port's own llama
decoder forward at a tiny width.
"""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch
from torch.utils.flop_counter import FlopCounterMode

from fast3r_torch.models.fast3r import Fast3RConfig, init_fast3r
from fast3r_torch.models.llama_decoder import (
    LlamaDecoderConfig,
    llama_decoder_forward,
)
from fast3r_torch.train import losses as tl
from fast3r_torch.utils import flops as tf

from fast3r_tpu.models import fast3r as jf
from fast3r_tpu.models.llama_decoder import LlamaDecoderConfig as JLlama
from fast3r_tpu.train import losses as jl
from fast3r_tpu.utils import flops as jflops

from test_torch_model import _port_cfg

TOL = dict(rtol=1e-5, atol=1e-6)
B, V, H, W = 2, 3, 8, 12

THREADS = 2  # torch threads: the suite runs several test processes on the
             # same cores


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, THREADS))
    yield
    torch.set_num_threads(n)


def _rand_pose(rng):
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = q
    T[:3, 3] = rng.standard_normal(3)
    return T


def _view_gt(rng, lead):
    return {"pts3d": rng.standard_normal(lead + (H, W, 3)).astype(np.float32)
            + 1,
            "valid_mask": rng.random(lead + (H, W)) < 0.8,
            "camera_pose": np.stack([_rand_pose(rng) for _ in
                                     range(int(np.prod(lead)))]).reshape(
                lead + (4, 4))}


def _conf(rng, shape):
    return (1 + np.exp(rng.standard_normal(shape))).astype(np.float32)


def _pair(seed):
    rng = np.random.default_rng(seed)
    gt1, gt2 = _view_gt(rng, (B,)), _view_gt(rng, (B,))
    pred1 = {"pts3d": rng.standard_normal((B, H, W, 3)).astype(np.float32),
             "conf": _conf(rng, (B, H, W))}
    pred2 = {"pts3d_in_other_view":
             rng.standard_normal((B, H, W, 3)).astype(np.float32),
             "conf": _conf(rng, (B, H, W))}
    return gt1, gt2, pred1, pred2


def _multiview(seed):
    rng = np.random.default_rng(seed)
    gts = _view_gt(rng, (B, V))
    gts["valid_mask"][1, 2] = False   # a view with nothing valid
    preds = {"pts3d_in_other_view":
             rng.standard_normal((B, V, H, W, 3)).astype(np.float32),
             "conf": _conf(rng, (B, V, H, W)),
             "pts3d_local": rng.standard_normal((B, V, H, W, 3)).astype(
                 np.float32),
             "conf_local": _conf(rng, (B, V, H, W))}
    return gts, preds


def _assert_same(got, want, what=""):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{what}[{i}]")
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _assert_same(got[k], want[k], f"{what}[{k!r}]")
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.shape == w.shape and g.dtype == w.dtype, (what, g.dtype,
                                                           w.dtype)
        if g.dtype == bool:
            np.testing.assert_array_equal(g, w, err_msg=what)
        else:
            np.testing.assert_allclose(g, w, err_msg=what, **TOL)


def _both(fn_name, args, kwargs):
    t_args = [{k: torch.from_numpy(v) for k, v in a.items()} for a in args]
    j_args = [{k: jnp.asarray(v) for k, v in a.items()} for a in args]
    got = getattr(tl, fn_name)(*t_args, **kwargs)
    want = getattr(jl, fn_name)(*j_args, **kwargs)
    to_np = lambda t: t.detach().numpy() if torch.is_tensor(t) else t  # noqa: E731
    got = (tuple({k: to_np(v) for k, v in d.items()} if isinstance(d, dict)
                 else to_np(d) for d in got))
    want = (tuple({k: np.asarray(v) for k, v in d.items()}
                  if isinstance(d, dict) else np.asarray(d) for d in want))
    return got, want


@pytest.mark.parametrize("fn_name,kwargs", [
    ("regr3d_pair", {}), ("regr3d_pair", {"gt_scale": True}),
    ("conf_loss_pair", {}),
    ("conf_loss_pair", {"alpha": 0.5, "norm_mode": "avg_log1p"}),
    ("regr3d_scale_shift_inv", {}),
    ("regr3d_scale_shift_inv", {"norm_mode": "avg_dis"}),
    ("regr3d_scale_shift_inv", {"norm_mode": "avg_dis", "gt_scale": True}),
])
def test_pair_losses_match_jax(fn_name, kwargs):
    got, want = _both(fn_name, _pair(7), kwargs)
    _assert_same(got, want, fn_name)


@pytest.mark.parametrize("fn_name,kwargs", [
    ("regr3d_multiview_v1", {}), ("regr3d_multiview_v1", {"gt_scale": True}),
    ("regr3d_multiview_v2", {}),
    ("regr3d_multiview_v2", {"norm_mode": "avg_log1p"}),
    ("regr3d_multiview_v3", {}), ("regr3d_multiview_v3", {"gt_scale": True}),
    ("conf_loss_multiview_v1", {}),
    ("conf_loss_multiview_v1", {"alpha": 0.2, "gt_scale": True}),
])
def test_multiview_losses_match_jax(fn_name, kwargs):
    got, want = _both(fn_name, _multiview(8), kwargs)
    _assert_same(got, want, fn_name)


def test_v3_without_local_head_and_lower_median():
    """V3 on global predictions only returns the global branch alone; the
    lower median equals torch.nanmedian over the valid entries."""
    gts, preds = _multiview(9)
    preds = {k: v for k, v in preds.items() if "local" not in k}
    got, want = _both("regr3d_multiview_v3", (gts, preds), {})
    _assert_same(got, want)
    assert "local" not in got[0]
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.standard_normal((4, 11)).astype(np.float32))
    valid = torch.from_numpy(rng.random((4, 11)) < 0.6)
    want = torch.nanmedian(torch.where(valid, x, torch.nan), dim=-1)[0]
    assert torch.equal(tl._masked_lower_median(x, valid), want)


def test_legacy_losses_differentiate():
    """The legacy losses are differentiable in the predictions."""
    gt1, gt2, pred1, pred2 = ({k: torch.from_numpy(v) for k, v in d.items()}
                              for d in _pair(11))
    pred2["pts3d_in_other_view"].requires_grad_(True)
    loss, _ = tl.conf_loss_pair(gt1, gt2, pred1, pred2)
    (g,) = torch.autograd.grad(loss, [pred2["pts3d_in_other_view"]])
    assert torch.isfinite(g).all() and g.abs().sum() > 0


# ---------------------------------------------------------------------------
# the FLOP counter
# ---------------------------------------------------------------------------

SHAPES = [(2, 224, 224), (20, 384, 512), (7, 512, 288), (1000, 192, 256)]


@pytest.mark.parametrize("name", ["flagship", "tiny", "tiny_global"])
@pytest.mark.parametrize("views,h,w", SHAPES)
def test_flops_match_jax(name, views, h, w):
    jcfg = {"flagship": jf.Fast3RConfig.flagship(),
            "tiny": jf.Fast3RConfig.tiny(),
            "tiny_global": jf.Fast3RConfig.tiny(with_local_head=False)}[name]
    cfg = _port_cfg(jcfg)
    got = tf.fast3r_forward_flops(cfg, views, h, w)
    want = jflops.fast3r_forward_flops(jcfg, views, h, w)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12), k
    assert tf.dpt_head_flops_per_image(cfg.head, h, w) == pytest.approx(
        jflops.dpt_head_flops_per_image(jcfg.head, h, w), rel=1e-12)
    assert tf._vit_block_flops(h, w) == jflops._vit_block_flops(h, w)


@pytest.mark.parametrize("views,h,w", SHAPES)
def test_llama_flops(views, h, w):
    """llama_dec: the encoder and heads equal JAX's (whose decoder term
    raises on the llama configuration)."""
    jcfg = dataclasses.replace(jf.Fast3RConfig.flagship(), decoder=JLlama())
    cfg = dataclasses.replace(Fast3RConfig.flagship(),
                              decoder=LlamaDecoderConfig())
    with pytest.raises(AttributeError, match="depth"):
        jflops.fast3r_forward_flops(jcfg, views, h, w)
    got = tf.fast3r_forward_flops(cfg, views, h, w)
    assert got["encoder"] == pytest.approx(
        jflops.encoder_flops_per_image(jcfg, h, w) * views, rel=1e-12)
    assert got["heads"] == pytest.approx(
        2 * views * jflops.dpt_head_flops_per_image(jcfg.head, h, w),
        rel=1e-12)
    # the flagship's decoder differs only by the FFN: SwiGLU 3 x 1024 x 2816
    # against the MLP's 2 x 1024 x 4096 a token and layer
    flag = tf.decoder_flops(Fast3RConfig.flagship(), views, h, w)
    seq = views * (h // 16) * (w // 16)
    assert got["decoder_linears"] - flag["linears"] == pytest.approx(
        24 * 2 * seq * 1024 * (3 * 2816 - 2 * 4096), rel=1e-12)
    assert got["decoder_attention"] == flag["attention"]


@pytest.mark.parametrize("kv_heads", [None, 1])
def test_llama_decoder_flops_count_its_products(kv_heads):
    """The llama decoder term against torch's own count of the matmuls in
    the port's decoder forward (2 views of 32x48 at width 64, 4 heads,
    with and without grouped kv heads)."""
    dec = LlamaDecoderConfig(enc_embed_dim=64, embed_dim=64, n_layers=2,
                             n_heads=4, n_kv_heads=kv_heads, multiple_of=32,
                             attn_impl="naive", fused_blocks=False)
    cfg = dataclasses.replace(Fast3RConfig.tiny(), decoder=dec)
    net = init_fast3r(cfg, seed=0, device="cpu")
    views, h, w = 2, 32, 48
    seq = views * (h // 16) * (w // 16)
    feats = torch.randn(1, seq, 64)
    ids = torch.arange(views).repeat_interleave(seq // views)[None]
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        llama_decoder_forward(net.decoder, dec, feats, ids)
    want = tf.decoder_flops(cfg, views, h, w)
    assert counter.get_total_flops() == want["linears"] + want["attention"]
