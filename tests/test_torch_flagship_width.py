"""The port at the flagship's widths against fast3r_tpu on the CPU, stage by
stage: the stage list of docs/flagship_parity.json (encoder features, each
decoder hook, both heads' points and confidence) for 2 views at 224x224 in
float32.

So far the port is held against JAX at tiny widths only; this anchors the
card's mesh comparison (chip_smoke.py phase 27) at the real ones: width
1024, 16 heads of 64, MLP hidden 4096, the DPT heads' 256 features, with
the depth cut to encoder 2 and decoder 4 (hooks 0, 2, 3, 4, as
``Fast3RConfig.tiny`` scales them).  The weights are the numpy-filled JAX
param tree of tests/test_torch_model.py; the port runs its default roads
(fused blocks, batched encoder attention) on their plain CPU versions, JAX
its plain XLA road; both take the image ids JAX draws from key(0).

Tolerance: each stage's max |port - jax| over the mean |jax| (the
artifact's ``max_rel_vs_meanmag``) at most 1e-4: fp32 through 6 blocks of
1024-wide products and the heads' convolutions, summation order only (the
artifact's reference-vs-JAX figures at depth 24 are at most 1.4e-5).
"""


import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fast3r_torch.inference import Fast3R
from fast3r_torch.models.decoder import decoder_forward
from fast3r_torch.models.encoder import encoder_forward
from fast3r_torch.models.fast3r import _run_head_oriented

from fast3r_tpu.models import decoder as jd
from fast3r_tpu.models import encoder as je
from fast3r_tpu.models import fast3r as jf
from fast3r_tpu.models.dpt_head import DPTHeadConfig

from test_torch_model import _jax_params, _port_cfg

V, RES = 2, 224
TOL = 1e-4
THREADS = 2  # torch threads: the suite runs several test processes on the
             # same cores


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, THREADS))
    yield
    torch.set_num_threads(n)


def _jax_cfg():
    """The flagship's widths at encoder depth 2 and decoder depth 4, on JAX's
    plain road (as scripts/flagship_parity.py builds it)."""
    return jf.Fast3RConfig(
        encoder=je.EncoderConfig(img_size=512, embed_dim=1024, num_heads=16,
                                 depth=2, fused_blocks=False,
                                 attn_impl="naive"),
        decoder=jd.DecoderConfig(enc_embed_dim=1024, embed_dim=1024,
                                 num_heads=16, depth=4, fused_blocks=False,
                                 attn_impl="naive"),
        head=DPTHeadConfig(dim_tokens=(1024, 1024, 1024, 1024)),
        with_local_head=True)


def _stages(enc, dec, run_head, cfg, params, flat, ids):
    """{stage: array} of one forward through the given package's pieces."""
    BV, H, W, _ = flat.shape
    feats, _ = enc(params["encoder"], cfg.encoder, flat)
    P = feats.shape[1]
    fused = feats.reshape(1, BV * P, -1)
    dec_out = dec(params["decoder"], cfg.decoder, fused,
                  ids.repeat(P, axis=1) if isinstance(ids, np.ndarray)
                  else ids.repeat_interleave(P, dim=1))
    out = {"encoder_feats": feats}
    out.update({f"decoder_hook_{h}": dec_out[h] for h in cfg.decoder.hooks})
    tokens = [dec_out[h].reshape(BV, P, -1) for h in cfg.decoder.hooks]
    for name in ("global", "local"):
        r = run_head(params[f"head_{name}"], cfg.head, tokens, H, W, None,
                     False)
        out[f"{name}_pts3d"], out[f"{name}_conf"] = r["pts3d"], r["conf"]
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def test_flagship_width_stages_match_jax():
    jcfg = _jax_cfg()
    assert jcfg.decoder.hooks == (0, 2, 3, 4)
    jparams = _jax_params(jcfg, seed=11)
    cfg = _port_cfg(jcfg)
    assert (cfg.encoder.embed_dim, cfg.encoder.num_heads,
            cfg.head.feature_dim) == (1024, 16, 256)
    model = Fast3R.from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                                   device="cpu")
    imgs = np.random.default_rng(12).uniform(
        -1, 1, (V, RES, RES, 3)).astype(np.float32)
    ids = np.asarray(jd.sample_random_image_ids(jax.random.key(0), 1, V))

    want = _stages(je.encoder_forward, jd.decoder_forward,
                   jf._run_head_oriented, jcfg, jparams, jnp.asarray(imgs),
                   ids)
    net = model.params
    with torch.inference_mode():
        got = _stages(
            encoder_forward, decoder_forward, _run_head_oriented, cfg,
            {k: getattr(net, k) for k in ("encoder", "decoder", "head_global",
                                          "head_local")},
            torch.from_numpy(imgs), torch.from_numpy(ids))
    assert got.keys() == want.keys() and len(want) == 9
    for k, w in want.items():
        assert got[k].shape == w.shape, (k, got[k].shape, w.shape)
        rel = np.abs(got[k] - w).max() / max(np.abs(w).mean(), 1e-12)
        assert rel <= TOL, (k, rel)
