"""The port's checkpoint export and DUSt3R initialisation
(``fast3r_torch.utils.checkpoint``: ``fast3r_params_to_state_dict``,
``params_to_torch_state_dict``, ``load_dust3r_checkpoint_partial``) against
fast3r_tpu's on the same params, carried across with ``params_from_jax``:
key for key (in order) and bit for bit; each export read back by
``params_from_fast3r_checkpoint`` gives the params again."""

import numpy as np
import pytest
import torch

import jax

from fast3r_torch import Fast3RConfig
from fast3r_torch.models.decoder import DecoderConfig
from fast3r_torch.models.dpt_head import DPTHeadConfig
from fast3r_torch.models.encoder import EncoderConfig
from fast3r_torch.models.fast3r import empty_fast3r
from fast3r_torch.utils import checkpoint as tck
from fast3r_torch.utils.convert import params_from_jax

from fast3r_tpu.utils import checkpoint as jck

from test_checkpoint_utils import _tiny12
from test_torch_mesh_variants import jax_cfg, port_cfg
from test_torch_model import _jax_params
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

VARIANTS = ["tiny", "llama", "gqa", "dino"]


def _cfgs(name):
    """(port config, JAX config): ``tiny()`` or a tiny variant of
    ``tests/test_torch_mesh_variants.py``."""
    from fast3r_tpu.models import fast3r as jf

    if name == "tiny":
        return Fast3RConfig.tiny(), jf.Fast3RConfig.tiny()
    return port_cfg(name), jax_cfg(name)


def _params(name, seed=0):
    cfg, jcfg = _cfgs(name)
    jp = jax.tree.map(np.asarray, _jax_params(jcfg, seed=seed))
    return cfg, jcfg, jp, params_from_jax(jp, cfg)


def _assert_same(got: dict, want: dict):
    assert list(got) == list(want), sorted(set(got) ^ set(want))[:8]
    for k, w in want.items():
        g = got[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.shape, w.shape)
        assert np.array_equal(g, w), k


@pytest.mark.parametrize("name", VARIANTS)
def test_fast3r_params_to_state_dict_matches_jax(name):
    cfg, jcfg, jp, sd = _params(name)
    got = tck.fast3r_params_to_state_dict(sd, cfg)
    _assert_same(got, jck.fast3r_params_to_state_dict(jp, jcfg))
    assert any(".scratch.layer_rn.0." in k for k in got)
    # a Fast3RNet exports as its state dict does
    net = empty_fast3r(cfg, device="cpu")
    net.load_state_dict(sd)
    _assert_same(tck.fast3r_params_to_state_dict(net, cfg),
                 {k: v.numpy() for k, v in got.items()})


@pytest.mark.parametrize("name", VARIANTS)
def test_fast3r_export_round_trips(name):
    cfg, _, _, sd = _params(name, seed=1)
    back = tck.params_from_fast3r_checkpoint(
        tck.fast3r_params_to_state_dict(sd, cfg), cfg)
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


@pytest.mark.parametrize("local", [True, False], ids=["local", "global"])
def test_params_to_torch_state_dict_matches_jax(local):
    from fast3r_tpu.models import fast3r as jf

    cfg = Fast3RConfig.tiny(with_local_head=local)
    jcfg = jf.Fast3RConfig.tiny(with_local_head=local)
    jp = jax.tree.map(np.asarray, _jax_params(jcfg, seed=2))
    sd = params_from_jax(jp, cfg)
    depths = (cfg.encoder.depth, cfg.decoder.depth, local)
    got = tck.params_to_torch_state_dict(sd, *depths)
    _assert_same(got, jck.params_to_torch_state_dict(jp, *depths))
    back = tck.params_from_fast3r_checkpoint(got, cfg)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def _port_tiny12() -> Fast3RConfig:
    """tests/test_checkpoint_utils.py's ``_tiny12`` in the port."""
    return Fast3RConfig(
        encoder=EncoderConfig(embed_dim=64, num_heads=2, depth=2),
        decoder=DecoderConfig(enc_embed_dim=64, embed_dim=64, num_heads=2,
                              depth=12),
        head=DPTHeadConfig(dim_tokens=(64, 64, 64, 64)))


def _dust3r_state_dict(donor) -> dict:
    """The DUSt3R-layout state dict of tests/test_dust3r_init.py: the
    donor's encoder tensors under bare names, its global head under
    ``downstream_head1``."""
    jcfg = _tiny12()
    full = jck.params_to_torch_state_dict(donor, jcfg.encoder.depth,
                                          jcfg.decoder.depth,
                                          with_local_head=True)
    sd = {}
    for k, v in full.items():
        if (k.startswith("encoder.patch_embed.proj")
                or k.startswith("encoder.enc_blocks")
                or k.startswith("encoder.enc_norm")):
            sd[k.replace("encoder.", "")] = v
        elif k.startswith("downstream_head."):
            sd[k.replace("downstream_head.", "downstream_head1.")] = v
    return sd


@pytest.fixture(scope="module")
def dust3r():
    """(donor, target) param trees of ``_tiny12`` in JAX's layout and the
    port's, and the donor's DUSt3R-layout state dict."""
    jcfg, cfg = _tiny12(), _port_tiny12()
    trees = [jax.tree.map(np.asarray, _jax_params(jcfg, seed=s)) for s in (0, 1)]
    return trees, [params_from_jax(t, cfg) for t in trees], \
        _dust3r_state_dict(trees[0])


@pytest.mark.parametrize("case", ["head", "no_head", "mismatch"])
def test_load_dust3r_checkpoint_partial_matches_jax(dust3r, case):
    """The encoder (and with ``load_head`` the global head) from the
    donor, the rest kept; "mismatch": one block's qkv of another width and
    a missing norm are skipped, as the reference's strict=False does."""
    jcfg, cfg = _tiny12(), _port_tiny12()
    (donor, target), (donor_t, target_t), sd = dust3r
    sd = dict(sd)
    if case == "mismatch":
        sd["enc_blocks.1.attn.qkv.weight"] = np.zeros((96, 64), np.float32)
        del sd["enc_norm.weight"]
    load_head = case != "no_head"
    want = jck.load_dust3r_checkpoint_partial(target, sd, jcfg.encoder.depth,
                                              load_head=load_head)
    got = tck.load_dust3r_checkpoint_partial(target_t, sd, cfg.encoder.depth,
                                             load_head)
    want = params_from_jax(want, cfg)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    # what moved: the donor's encoder (and head); the decoder kept
    assert torch.equal(got["encoder.patch_embed.weight"],
                       donor_t["encoder.patch_embed.weight"])
    assert torch.equal(got["decoder.decoder_embed.weight"],
                       target_t["decoder.decoder_embed.weight"])
    moved = torch.equal(got["head_global.head.conv3.weight"],
                        donor_t["head_global.head.conv3.weight"])
    assert moved == load_head
    if case == "mismatch":
        for k in ("encoder.blocks.1.attn.qkv.weight", "encoder.norm.weight"):
            assert torch.equal(got[k], target_t[k]), k
        assert torch.equal(got["encoder.blocks.0.attn.qkv.weight"],
                           donor_t["encoder.blocks.0.attn.qkv.weight"])


def test_export_copies_tensors():
    """The export holds copies: writing to it leaves the params as they
    were."""
    cfg, _, _, sd = _params("tiny")
    before = {k: v.clone() for k, v in sd.items()}
    out = tck.fast3r_params_to_state_dict(sd, cfg)
    for t in out.values():
        t.zero_()
    for k, v in before.items():
        assert torch.equal(sd[k], v), k
