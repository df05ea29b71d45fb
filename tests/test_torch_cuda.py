"""The port's hand-written kernels against their plain versions on a GPU.

Marked ``cuda``: without a CUDA device every test here skips (the kernels
have no CPU mode; their plain versions are what the CPU tests check against
fast3r_tpu).  Run on a machine with an H100:

    python -m pytest tests/test_torch_cuda.py -q

Tolerances: float32 compares differ only in summation order (1e-4); bfloat16
compares allow the roundings each side makes (stated per test).
"""

import math

import pytest
import torch

from fast3r_torch.ops import flash_attention as t_flash
from fast3r_torch.ops import fused_layernorm as t_ln
from fast3r_torch.ops import trunk_kernel as t_trunk

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("B,N,H", [(2, 768, 4), (1, 196, 2), (3, 64, 1),
                                   (1, 1000, 2)])
def test_attention_kernel_matches_plain(dev, dtype, atol, B, N, H):
    """Strided q/k/v views of a (B, N, 3, H, 64) tensor, ragged N included."""
    qkv = torch.randn((B, N, 3, H, 64), generator=_gen(0), device=dev).to(dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    before = t_flash.flash_attention.launches
    out = t_flash.flash_attention(q, k, v, 0.125)
    assert t_flash.flash_attention.launches == before + 1
    ref = t_flash.attention_ref(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert out.shape == (B, N, H, 64) and out.dtype == dtype
    assert (out.float() - ref.float()).abs().max().item() < atol


def test_attention_kernel_cross_lengths(dev):
    """Nq != Nk, contiguous inputs, the decoder's inference scale."""
    g = _gen(1)
    q = torch.randn((1, 130, 2, 64), generator=g, device=dev)
    k = torch.randn((1, 300, 2, 64), generator=g, device=dev)
    v = torch.randn((1, 300, 2, 64), generator=g, device=dev)
    scale = 0.125 * math.sqrt(math.log(137) / math.log(20))
    out = t_flash.flash_attention(q, k, v, scale)
    ref = t_flash.attention_ref(q, k, v, scale)
    assert (out - ref).abs().max().item() < 1e-4


def test_attention_kernel_rejects_what_it_cannot_take(dev):
    x32 = torch.zeros((1, 64, 2, 32), device=dev)
    with pytest.raises(ValueError, match="64"):
        t_flash.flash_attention(x32, x32, x32, 1.0)
    x = torch.zeros((1, 64, 2, 64), device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        t_flash.flash_attention(x, x, x, 1.0)
    x = torch.zeros((1, 64, 2, 64), device=dev)
    odd = torch.zeros((1, 64, 2, 66), device=dev)[..., :64]  # 264-byte heads
    with pytest.raises(ValueError, match="strides"):
        t_flash.flash_attention(x, odd, x, 1.0)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 6e-2)])
@pytest.mark.parametrize("shape", [(300, 1024), (2, 5, 64), (7, 96)])
def test_layernorm_kernel_matches_plain(dev, dtype, atol, shape):
    """bf16: one output rounding (2^-8 relative) on values up to ~8."""
    g = _gen(2)
    x = (torch.randn(shape, generator=g, device=dev) * 3 + 1).to(dtype)
    w = torch.randn(shape[-1], generator=g, device=dev).to(dtype)
    b = torch.randn(shape[-1], generator=g, device=dev).to(dtype)
    before = t_ln.fused_layernorm.launches
    out = t_ln.fused_layernorm(x, w, b, 1e-5)
    assert t_ln.fused_layernorm.launches == before + 1
    ref = t_ln.layernorm_ref(x, w, b, 1e-5)
    assert out.dtype == dtype
    assert (out.float() - ref.float()).abs().max().item() < atol


def test_layernorm_kernel_rejects_strided_input(dev):
    x = torch.zeros((8, 64), device=dev).t()
    with pytest.raises(ValueError, match="contiguous"):
        t_ln.fused_layernorm(x, torch.ones(8, device=dev),
                             torch.zeros(8, device=dev), 1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hh,wc,H,W", [(12, 20, 24, 40), (7, 9, 16, 21)])
def test_trunk_kernel_matches_plain(dev, dtype, hh, wc, H, W):
    """fp32: 1e-4 relative to max |plain|; bf16: the plain version rounds
    after every op, 3e-2 relative to max |plain|."""
    g = _gen(3)

    def uni(shape, fan_in):
        return ((torch.rand(shape, generator=g, device=dev) * 2 - 1)
                / math.sqrt(fan_in)).to(dtype)

    n, cin = 2, 64
    x = torch.randn((n, hh, wc, cin), generator=g, device=dev).to(dtype)
    args = (uni((128, cin, 3, 3), 9 * cin), uni((128,), 9 * cin),
            uni((128, 128, 3, 3), 1152), uni((128,), 1152),
            uni((4, 128, 1, 1), 128), uni((4,), 128), H, W)
    before = t_trunk.fused_regression_head_t.launches
    out = t_trunk.fused_regression_head_t(x, *args)
    assert t_trunk.fused_regression_head_t.launches == before + 1
    ref = t_trunk._plain_head(x.permute(0, 3, 1, 2), *args).reshape(n, 4, -1)
    rel = 1e-4 if dtype == torch.float32 else 3e-2
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= rel * ref.float().abs().max().item()


def test_trunk_kernel_rejects_other_widths(dev):
    x = torch.zeros((1, 4, 4, 64), device=dev)
    w = torch.zeros((64, 64, 3, 3), device=dev)
    b = torch.zeros(64, device=dev)
    with pytest.raises(ValueError, match="w1"):
        t_trunk.fused_regression_head_t(x, w, b, w, b, w, b, 8, 8)


def test_fused_blocks_raise_on_cuda(dev):
    import dataclasses

    import fast3r_torch

    cfg = fast3r_torch.Fast3RConfig.tiny()
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, fused_blocks=True))
    model = fast3r_torch.Fast3R.from_random(cfg, device="cuda")
    with pytest.raises(NotImplementedError, match="K3-K6"):
        fast3r_torch.fast3r_forward(model.params, cfg,
                                    torch.zeros((1, 2, 64, 64, 3), device=dev))


def test_forward_on_cuda_matches_cpu(dev):
    """head_dim 64 and the flagship head widths (the kernels' widths) at
    shallow depth, 2 views at 128x128: the kernel path on the card in fp32
    vs the plain path on the CPU, 1e-3 relative to max |ref|."""
    import fast3r_torch
    from fast3r_torch.models.decoder import DecoderConfig
    from fast3r_torch.models.dpt_head import DPTHeadConfig
    from fast3r_torch.models.encoder import EncoderConfig

    cfg = fast3r_torch.Fast3RConfig(
        encoder=EncoderConfig(embed_dim=128, num_heads=2, depth=2),
        decoder=DecoderConfig(enc_embed_dim=128, embed_dim=128, num_heads=2,
                              depth=4),
        head=DPTHeadConfig(dim_tokens=(128,) * 4))
    cpu = fast3r_torch.Fast3R.from_random(cfg, seed=0)
    gpu = cpu.to(device="cuda")
    imgs = torch.randn((1, 2, 128, 128, 3), generator=torch.Generator()
                       .manual_seed(0))
    ref = fast3r_torch.fast3r_forward(cpu.params, cfg, imgs)
    launches = (t_flash.flash_attention.launches, t_ln.fused_layernorm.launches,
                t_trunk.fused_regression_head_t.launches)
    out = fast3r_torch.fast3r_forward(gpu.params, cfg, imgs.to(dev))
    assert t_flash.flash_attention.launches > launches[0]
    assert t_ln.fused_layernorm.launches > launches[1]
    assert t_trunk.fused_regression_head_t.launches > launches[2]
    for k in ref:
        a, b = out[k].cpu(), ref[k]
        assert (a - b).abs().max().item() <= 1e-3 * b.abs().max().item(), k
