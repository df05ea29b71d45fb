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
                                   (1, 1000, 2), (2, 1037, 2)])
@pytest.mark.parametrize("D", [64, 80])
def test_attention_kernel_matches_plain(dev, dtype, atol, B, N, H, D):
    """Strided q/k/v views of a (B, N, 3, H, D) tensor, ragged N included
    (1037: a 392x518 DINO view), at head_dim 64 and 80."""
    qkv = torch.randn((B, N, 3, H, D), generator=_gen(0), device=dev).to(dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    before = t_flash.flash_attention.launches
    out = t_flash.flash_attention(q, k, v, 0.125)
    assert t_flash.flash_attention.launches == before + 1
    ref = t_flash.attention_ref(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert out.shape == (B, N, H, D) and out.dtype == dtype
    assert (out.float() - ref.float()).abs().max().item() < atol


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 1e-2)])
def test_attention_kernel_cross_lengths(dev, dtype, atol):
    """Nq != Nk, contiguous inputs, the decoder's inference scale."""
    g = _gen(1)
    q = torch.randn((1, 130, 2, 64), generator=g, device=dev).to(dtype)
    k = torch.randn((1, 300, 2, 64), generator=g, device=dev).to(dtype)
    v = torch.randn((1, 300, 2, 64), generator=g, device=dev).to(dtype)
    scale = 0.125 * math.sqrt(math.log(137) / math.log(20))
    out = t_flash.flash_attention(q, k, v, scale)
    ref = t_flash.attention_ref(q, k, v, scale)
    assert out.dtype == dtype
    assert (out.float() - ref.float()).abs().max().item() < atol


# bf16 forward: o as test_attention_kernel_matches_plain (p rounded before
# p @ v, the plain version rounds the normalised weights); lse: fp32 scores
# of the same inputs, summed in another order
FWD_BF16_TOL = (1e-2, 1e-3)


def _fwd_lse_close(q, k, v, scale):
    o, lse = t_flash.attention_fwd_lse(q, k, v, scale)
    ref_o, ref_lse = t_flash.attention_lse_ref(q, k, v, scale)
    torch.cuda.synchronize()
    assert o.shape == q.shape[:3] + (64,) and o.dtype == q.dtype
    assert lse.shape == ref_lse.shape and lse.dtype == torch.float32
    assert (o.float() - ref_o.float()).abs().max().item() < FWD_BF16_TOL[0]
    assert (lse - ref_lse).abs().max().item() < FWD_BF16_TOL[1]


@pytest.mark.parametrize("Nq,Nk", [(127, 127), (128, 128), (129, 129),
                                   (255, 255), (257, 257), (1000, 1000),
                                   # at most one 128-key tile: the only
                                   # tile is the masked last one
                                   (300, 50), (64, 1), (200, 127), (129, 128)])
def test_attention_kernel_lse_at_tile_edges(dev, Nq, Nk):
    """bf16 o and lse around the 128-query items' and 128-key tiles' edges
    (strided q/k/v views of (2, N, 3, 2, 64) buffers) against
    attention_lse_ref."""
    g = _gen(12)
    qb, kvb = (torch.randn((2, n, 3, 2, 64), generator=g, device=dev).to(
        torch.bfloat16) for n in (Nq, Nk))
    _fwd_lse_close(qb[:, :, 0], kvb[:, :, 1], kvb[:, :, 2], 0.125)


@pytest.mark.parametrize("B,N", [(2, 768), (3, 196)])
def test_attention_kernel_on_the_packed_buffer(dev, B, N):
    """o and lse from (B, N, 16, 64) views of one slice each of the
    encoder's packed (3, B, N, 1024) buffer, read in place (no copy)."""
    qkv3 = torch.randn((3, B, N, 1024), generator=_gen(14), device=dev).to(
        torch.bfloat16)
    before = t_flash.tma_view.copies
    _fwd_lse_close(*(qkv3[i].view(B, N, 16, 64) for i in range(3)), 0.125)
    assert t_flash.tma_view.copies == before


def test_attention_kernel_copies_a_layout_tma_refuses(dev):
    """bf16 q / k / v whose head stride is 66 elements (not 16-byte rows):
    each goes through one counted contiguous copy, and o still matches."""
    g = _gen(15)
    q, k, v = (torch.randn((1, 200, 2, 66), generator=g, device=dev).to(
        torch.bfloat16)[..., :64] for _ in range(3))
    assert t_flash.tma_dims(q) is None
    before = t_flash.tma_view.copies
    out = t_flash.flash_attention(q, k, v, 0.125)
    assert t_flash.tma_view.copies == before + 3
    ref = t_flash.attention_ref(q, k, v, 0.125)
    assert (out.float() - ref.float()).abs().max().item() < FWD_BF16_TOL[0]


@pytest.mark.parametrize("ctas", [1, 3, 7])
def test_attention_kernel_walk(dev, ctas):
    """The persistent walk over (batch * head, 128-query block) items with
    few CTAs (each takes many items, its stage and own-slot rings wrapping
    across them) gives what the default grid gives, bit for bit."""
    qkv = torch.randn((2, 700, 3, 3, 64), generator=_gen(16), device=dev).to(
        torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert torch.equal(t_flash.launch_attention(q, k, v, 0.125, ctas=ctas),
                       t_flash.launch_attention(q, k, v, 0.125))


def test_forward_kernels_are_deterministic(dev):
    """No atomics in either forward: K1's o and lse and the ring's o and lse
    are bitwise equal on two runs of the same inputs."""
    from fast3r_torch.parallel import ring_rdma as t_ring

    qkv = torch.randn((2, 700, 3, 4, 64), generator=_gen(17), device=dev).to(
        torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    runs = [t_flash.attention_fwd_lse(q, k, v, 0.125) for _ in range(2)]
    qr, kr, vr = _ring_inputs(4, 1, 300, 2, torch.bfloat16, 47)
    rings = [t_ring._rdma_forward(qr, kr, vr, 0.125, 4) for _ in range(2)]
    torch.cuda.synchronize()
    for first, second in (runs, rings):
        for a, b in zip(first, second):
            assert torch.equal(a, b)


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
@pytest.mark.parametrize("shape", [(300, 1024), (2, 5, 64), (7, 96),
                                   (15360, 1024),  # the blocks' shape
                                   (4, 16384),     # a CTA a row
                                   (9, 100)])      # bf16: the scalar road
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


@pytest.mark.parametrize("pdtype", [torch.float32, torch.bfloat16])
def test_layernorm_kernel_unaligned_and_mixed_params(dev, pdtype):
    """An x that starts 2 bytes past a 16-byte boundary takes the scalar
    road; bf16 x with fp32 (or bf16) weight and bias: one output rounding
    from fp32 values that differ in summation order."""
    g = _gen(21)
    buf = (torch.randn(1 + 33 * 512, generator=g, device=dev) * 3 + 1).to(
        torch.bfloat16)
    w = torch.randn(512, generator=g, device=dev).to(pdtype)
    b = torch.randn(512, generator=g, device=dev).to(pdtype)
    for x in (buf[1:].view(33, 512), buf[:-1].view(33, 512)):
        out = t_ln.fused_layernorm(x, w, b, 1e-6)
        ref = t_ln.layernorm_ref(x, w, b, 1e-6)
        assert (out.float() - ref.float()).abs().max().item() < 6e-2


def test_layernorm_kernel_is_deterministic(dev):
    """No atomics: two launches give the same bits, on each road."""
    g = _gen(22)
    for shape in ((15360, 1024), (4, 16384), (9, 100)):
        x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        w = torch.randn(shape[-1], generator=g, device=dev).to(torch.bfloat16)
        b = torch.randn(shape[-1], generator=g, device=dev).to(torch.bfloat16)
        assert torch.equal(t_ln.fused_layernorm(x, w, b, 1e-6),
                           t_ln.fused_layernorm(x, w, b, 1e-6))


def test_layernorm_kernel_rejects_what_it_cannot_take(dev):
    x = torch.zeros((8, 64), device=dev)
    with pytest.raises(ValueError, match="dtype"):
        t_ln.fused_layernorm(x.half(), torch.ones(64, device=dev),
                             torch.zeros(64, device=dev), 1e-6)
    with pytest.raises(ValueError, match="weight"):
        t_ln.fused_layernorm(x, torch.ones(64, device=dev).half(),
                             torch.zeros(64, device=dev), 1e-6)
    with pytest.raises(ValueError, match="16384"):
        t_ln.fused_layernorm(torch.zeros((2, 16400), device=dev),
                             torch.ones(16400, device=dev),
                             torch.zeros(16400, device=dev), 1e-6)


def _trunk_args(dev, dtype, n, hh, wc, cin, H, W, seed=3):
    g = _gen(seed)

    def uni(shape, fan_in):
        return ((torch.rand(shape, generator=g, device=dev) * 2 - 1)
                / math.sqrt(fan_in)).to(dtype)

    x = torch.randn((n, hh, wc, cin), generator=g, device=dev).to(dtype)
    return x, (uni((128, cin, 3, 3), 9 * cin), uni((128,), 9 * cin),
               uni((128, 128, 3, 3), 1152), uni((128,), 1152),
               uni((4, 128, 1, 1), 128), uni((4,), 128), H, W)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hh,wc,H,W", [
    (12, 20, 24, 40), (7, 9, 16, 21),   # ragged edge tiles
    (20, 12, 40, 24),                   # portrait
    (40, 150, 16, 30),                  # a downscale: taps read from memory
    (24, 32, 48, 64)])                  # whole tiles
@pytest.mark.parametrize("n,cin", [(2, 64), (1, 256)])
def test_trunk_kernel_matches_plain(dev, dtype, hh, wc, H, W, n, cin):
    """fp32: 1e-4 relative to max |plain|; bf16: the plain version rounds
    after every op, 3e-2 relative to max |plain|."""
    x, args = _trunk_args(dev, dtype, n, hh, wc, cin, H, W)
    before = t_trunk.fused_regression_head_t.launches
    out = t_trunk.fused_regression_head_t(x, *args)
    assert t_trunk.fused_regression_head_t.launches == before + 1
    ref = t_trunk._plain_head(x.permute(0, 3, 1, 2), *args).reshape(n, 4, -1)
    rel = 1e-4 if dtype == torch.float32 else 3e-2
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= rel * ref.float().abs().max().item()


@pytest.mark.parametrize("n,hh,wc,H,W", [
    (20, 192, 256, 384, 512),   # the 20-view request's chunk
    (25, 192, 256, 384, 512),   # a 1000 x 512x384 forward's head chunk
    (6, 256, 192, 512, 384)])   # the mixed request's portrait group
def test_trunk_kernel_at_the_request_shapes(dev, n, hh, wc, H, W):
    """bf16 at Cin 256: 3e-2 of max |plain|; two runs give the same bits."""
    x, args = _trunk_args(dev, torch.bfloat16, n, hh, wc, 256, H, W)
    out = t_trunk.fused_regression_head_t(x, *args)
    again = t_trunk.fused_regression_head_t(x, *args)
    ref = t_trunk._plain_head(x.permute(0, 3, 1, 2), *args).reshape(n, 4, -1)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 3e-2 * ref.float().abs().max().item()
    assert torch.equal(out, again)


def test_trunk_kernel_is_deterministic_and_takes_n_0(dev):
    x, args = _trunk_args(dev, torch.bfloat16, 3, 7, 9, 64, 16, 21)
    assert torch.equal(t_trunk.fused_regression_head_t(x, *args),
                       t_trunk.fused_regression_head_t(x, *args))
    before = t_trunk.fused_regression_head_t.launches
    out = t_trunk.fused_regression_head_t(x[:0], *args)
    assert out.shape == (0, 4, 16 * 21)
    assert t_trunk.fused_regression_head_t.launches == before


def test_trunk_kernel_rejects_other_widths(dev):
    x = torch.zeros((1, 4, 4, 64), device=dev)
    w = torch.zeros((64, 64, 3, 3), device=dev)
    b = torch.zeros(64, device=dev)
    with pytest.raises(ValueError, match="w1"):
        t_trunk.fused_regression_head_t(x, w, b, w, b, w, b, 8, 8)
    x, args = _trunk_args(dev, torch.bfloat16, 1, 4, 4, 24, 8, 8)
    with pytest.raises(ValueError, match="multiple of 16"):
        t_trunk.fused_regression_head_t(x, *args)


def _shallow_cfg(width, heads, fused):
    import fast3r_torch
    from fast3r_torch.models.decoder import DecoderConfig
    from fast3r_torch.models.dpt_head import DPTHeadConfig
    from fast3r_torch.models.encoder import EncoderConfig

    return fast3r_torch.Fast3RConfig(
        encoder=EncoderConfig(embed_dim=width, num_heads=heads, depth=2,
                              fused_blocks=fused),
        decoder=DecoderConfig(enc_embed_dim=width, embed_dim=width,
                              num_heads=heads, depth=4, fused_blocks=fused),
        head=DPTHeadConfig(dim_tokens=(width,) * 4))


def test_fused_forward_on_cuda_matches_cpu(dev):
    """The fused-GEMM road at the flagship widths (1024, 16 heads of 64) and
    shallow depth, 2 views at 112x128 (56 tokens a view: ragged row tiles),
    bf16 on the card vs the fp32 plain versions on the CPU, same weights:
    relative L2 within 2e-2 on every output (bf16 through 6 blocks), and
    every fused kernel launched."""
    import fast3r_torch
    from fast3r_torch.nn import fused_block as t_fb
    from fast3r_torch.ops import batched_attention as t_ba

    cfg = _shallow_cfg(1024, 16, fused=True)
    cpu = fast3r_torch.Fast3R.from_random(cfg, seed=0, device="cpu")
    gpu = cpu.to(device="cuda", dtype=torch.bfloat16)
    imgs = torch.rand((1, 2, 112, 128, 3),
                      generator=torch.Generator().manual_seed(0)) * 2 - 1
    ref = fast3r_torch.fast3r_forward(cpu.params, cfg, imgs)
    fns = (t_fb.ln_qkv_rope, t_ba.packed_qkv_attention, t_fb.ln_qkv,
           t_fb.matmul_residual, t_fb.ln_mlp)
    before = [f.launches for f in fns]
    out = fast3r_torch.fast3r_forward(gpu.params, cfg,
                                      imgs.to(dev, torch.bfloat16))
    torch.cuda.synchronize()
    assert all(f.launches > b for f, b in zip(fns, before))
    for k in ref:
        a, b = out[k].float().cpu(), ref[k]
        assert torch.isfinite(a).all(), k
        assert ((a - b).norm() / b.norm()).item() < 2e-2, k


def test_forward_on_cuda_matches_cpu(dev):
    """The plain block road (fused_blocks=False), head_dim 64 and the
    flagship head widths (the kernels' widths) at shallow depth, 2 views at
    128x128: the kernel path on the card in fp32 vs the plain path on the
    CPU, 1e-3 relative to max |ref|."""
    import fast3r_torch

    cfg = _shallow_cfg(128, 2, fused=False)
    cpu = fast3r_torch.Fast3R.from_random(cfg, seed=0, device="cpu")
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


# --------------------------------------------------------------------------
# fused-GEMM block kernels (csrc/fused_gemm.cu, csrc/ln_mlp.cu) and the
# packed-qkv attention road, bfloat16 (the kernels' only dtype)
# --------------------------------------------------------------------------

def _bf(shape, g, scale=1.0, shift=0.0):
    return (torch.randn(shape, generator=g, device="cuda") * scale
            + shift).to(torch.bfloat16)


def _linear(n_out, n_in, g):
    bound = n_in ** -0.5
    w = ((torch.rand((n_out, n_in), generator=g, device="cuda") * 2 - 1)
         * bound).to(torch.bfloat16)
    return w, _bf((n_out,), g, 0.02)


def _assert_bf16_close(out, ref, atol):
    """One bf16 step of the output (2^-7 relative) plus ``atol`` for a bf16
    intermediate (LN output, q / k, h) that rounds to the other side of a
    step because the two sides sum in different orders."""
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    a, b = out.float(), ref.float()
    assert torch.isfinite(a).all()
    bad = (a - b).abs() > atol + 2 ** -7 * b.abs()
    assert not bad.any(), (a - b).abs().max().item()


@pytest.mark.parametrize("M", [128, 300, 37])
@pytest.mark.parametrize("kind", ["ln_matmul", "ln_matmul_gelu", "ln_qkv",
                                  "ln_qkv_rope", "matmul_residual"])
@pytest.mark.parametrize("C", [256, 768, 1280])
def test_fused_gemm_kernels_match_plain(dev, kind, M, C):
    """Every epilogue of fused_gemm.cu vs its plain version, at whole and
    ragged row counts (C = 256, 768, 1280: the LN prologue's 1, 3 and 5
    chunks a lane, 1280 in the wide instantiations, which RoPE has not;
    heads of 64; hidden 4 C)."""
    from fast3r_torch.nn import fused_block as t_fb
    from fast3r_torch.ops.rope2d import expand_rope_tables, rope2d_cos_sin

    g = _gen(4)
    x = _bf((M, C), g, 2.0, 0.5)
    gamma, beta = _bf((C,), g, 0.1, 1.0), _bf((C,), g, 0.1)
    fn = {"ln_matmul_gelu": "ln_matmul"}.get(kind, kind)
    wrapper = getattr(t_fb, fn)
    before = wrapper.launches
    if kind.startswith("ln_matmul"):
        w, b = _linear(4 * C, C, g)
        act = "gelu" if kind.endswith("gelu") else None
        args = (x, gamma, beta, w, b, 1e-6)
        out = wrapper(*args, act=act)
        ref = t_fb.ln_matmul_ref(*args, act=act)
    elif kind == "ln_qkv":
        w, b = _linear(3 * C, C, g)
        out = torch.stack(wrapper(x, gamma, beta, w, b, 1e-5))
        ref = torch.stack(t_fb.ln_qkv_ref(x, gamma, beta, w, b, 1e-5))
    elif kind == "ln_qkv_rope":
        w, b = _linear(3 * C, C, g)
        pos = torch.randint(0, 40, (1, M, 2), device="cuda", generator=g)
        ct, st = expand_rope_tables(*rope2d_cos_sin(pos, 64), C,
                                    torch.bfloat16)
        args = (x, gamma, beta, w, b, ct, st, C // 64, 1e-6)
        if C > 1024:  # the RoPE epilogue serves the encoder's width only
            with pytest.raises(ValueError, match="K <= 1024"):
                wrapper(*args)
            return
        out = wrapper(*args)
        ref = t_fb.ln_qkv_rope_ref(*args)
    else:
        w, b = _linear(C, 4 * C, g)
        h = _bf((M, 4 * C), g, 0.5)
        out = wrapper(h, w, b, x)
        ref = t_fb.matmul_residual_ref(h, w, b, x)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    _assert_bf16_close(out, ref, atol=2e-2)


@pytest.mark.parametrize("M,hidden", [(128, 4096), (300, 1024), (37, 64)])
@pytest.mark.parametrize("C", [768, 1024, 1280])
def test_ln_mlp_kernel_matches_plain(dev, M, hidden, C):
    """The whole-MLP kernel (C = 768, 1024, 1280: 3, 4, 5 fc2 tiles a band)
    vs its plain version, ragged rows and short hidden loops included."""
    from fast3r_torch.nn import fused_block as t_fb

    g = _gen(5)
    x = _bf((M, C), g, 2.0, 0.5)
    gamma, beta = _bf((C,), g, 0.1, 1.0), _bf((C,), g, 0.1)
    w1, b1 = _linear(hidden, C, g)
    w2, b2 = _linear(C, hidden, g)
    args = (x, gamma, beta, w1, b1, w2, b2, 1e-6)
    before = t_fb.ln_mlp.launches
    out = t_fb.ln_mlp(*args)
    ref = t_fb.ln_mlp_ref(*args)
    torch.cuda.synchronize()
    assert t_fb.ln_mlp.launches == before + 1
    _assert_bf16_close(out, ref, atol=2e-2)


def test_ln_mlp_kernel_at_the_flagship_shape(dev):
    """The whole-MLP kernel at the flagship's 20-view shape (M = 15360,
    hidden 4096: 120 row bands through the 16-slot h ring)."""
    from fast3r_torch.nn import fused_block as t_fb

    g = _gen(17)
    M, C, hidden = 15360, 1024, 4096
    x = _bf((M, C), g, 2.0, 0.5)
    gamma, beta = _bf((C,), g, 0.1, 1.0), _bf((C,), g, 0.1)
    w1, b1 = _linear(hidden, C, g)
    w2, b2 = _linear(C, hidden, g)
    args = (x, gamma, beta, w1, b1, w2, b2, 1e-6)
    out = t_fb.ln_mlp(*args)
    ref = t_fb.ln_mlp_ref(*args)
    torch.cuda.synchronize()
    _assert_bf16_close(out, ref, atol=2e-2)


@pytest.mark.parametrize("ctas,slots,M,hidden", [
    (1, 16, 1000, 1024), (3, 16, 1000, 1024), (1, 2, 1000, 1024),
    (3, 2, 1000, 1024), (3, 3, 2000, 4096), (132, 2, 1000, 96)])
def test_ln_mlp_kernel_walk(dev, ctas, slots, M, hidden):
    """The whole-MLP kernel's persistent walk with few CTAs (1 and 3 hold
    every claim, wait and slot reuse in one or a few CTAs) and with more row
    bands than h ring slots (M = 1000: 8 bands through 2 or 3 slots), ragged
    rows and a hidden width off the 256-column tile (96)."""
    from fast3r_torch.nn import fused_block as t_fb

    g = _gen(18)
    C = 1024
    x = _bf((M, C), g, 2.0, 0.5)
    gamma, beta = _bf((C,), g, 0.1, 1.0), _bf((C,), g, 0.1)
    w1, b1 = _linear(hidden, C, g)
    w2, b2 = _linear(C, hidden, g)
    args = (x, gamma, beta, w1, b1, w2, b2, 1e-6)
    out = t_fb._ln_mlp(*args, ctas=ctas, slots=slots)
    ref = t_fb.ln_mlp_ref(*args)
    torch.cuda.synchronize()
    _assert_bf16_close(out, ref, atol=2e-2)


@pytest.mark.parametrize("kind", ["ln_qkv", "ln_qkv_rope", "replay_qkv",
                                  "replay_rope", "replay_gelu"])
def test_fused_gemm_kernels_at_the_flagship_shape(dev, kind):
    """The LN products at the flagship's shape (M = 15360, C = 1024, 16
    heads; fc1 hidden 4096), bf16, at the tolerances of the small cases:
    the product and z one bf16 step + 2e-2, u one step + 1e-2, mean and
    rstd 1e-5 relative."""
    from fast3r_torch.nn import fused_block as t_fb
    from fast3r_torch.ops.rope2d import expand_rope_tables, rope2d_cos_sin

    g = _gen(19)
    M, C = 15360, 1024
    x = _bf((M, C), g, 2.0, 0.5)
    gamma, beta = _bf((C,), g, 0.1, 1.0), _bf((C,), g, 0.1)
    w, b = _linear(4 * C if kind == "replay_gelu" else 3 * C, C, g)
    yy, xx = torch.meshgrid(torch.arange(24), torch.arange(32), indexing="ij")
    pos = torch.stack([yy, xx], -1).reshape(1, -1, 2).repeat(20, 1, 1).cuda()
    ct, st = expand_rope_tables(*rope2d_cos_sin(pos, 64), C, torch.bfloat16)
    if kind == "ln_qkv":
        out = torch.stack(t_fb.ln_qkv(x, gamma, beta, w, b, 1e-5))
        ref = torch.stack(t_fb.ln_qkv_ref(x, gamma, beta, w, b, 1e-5))
    elif kind == "ln_qkv_rope":
        args = (x, gamma, beta, w, b, ct, st, 16, 1e-6)
        out = t_fb.ln_qkv_rope(*args)
        ref = t_fb.ln_qkv_rope_ref(*args)
    else:
        mode = kind.split("_")[1]
        tables = (ct, st) if mode == "rope" else None
        got = t_fb._replay(mode, x, gamma, beta, w, b, 1e-6, tables, 16)
        exp = t_fb._replay_ref(mode, x, gamma, beta, w, b, 1e-6, tables, 16)
        torch.cuda.synchronize()
        _assert_bf16_close(got[1], exp[1], atol=1e-2)
        for a, r in zip(got[2:4], exp[2:4]):
            assert ((a - r).abs() <= 1e-5 * r.abs() + 1e-6).all()
        if mode == "gelu":
            _assert_bf16_close(got[4], exp[4], atol=2e-2)
        out, ref = got[0], exp[0].contiguous()
    torch.cuda.synchronize()
    _assert_bf16_close(out, ref, atol=2e-2)


@pytest.mark.parametrize("B,N", [(2, 768), (3, 196)])
def test_packed_qkv_attention_kernel_matches_plain(dev, B, N):
    from fast3r_torch.ops import batched_attention as t_ba

    qkv3 = _bf((3, B, N, 256), _gen(6))
    before = t_ba.packed_qkv_attention.launches
    out = t_ba.packed_qkv_attention(qkv3, 4, 0.125)
    q, k, v = (qkv3[i].view(B, N, 4, 64) for i in range(3))
    ref = t_flash.attention_ref(q, k, v, 0.125).reshape(B, N, 256)
    torch.cuda.synchronize()
    assert t_ba.packed_qkv_attention.launches == before + 1
    assert (out.float() - ref.float()).abs().max().item() < 1e-2


def test_fused_kernels_reject_what_they_cannot_take(dev):
    from fast3r_torch.nn import fused_block as t_fb

    g = _gen(7)
    x = _bf((64, 256), g)
    w, b = _linear(768, 256, g)
    ones, zeros = torch.ones(256, device=dev), torch.zeros(256, device=dev)
    with pytest.raises(ValueError, match="bfloat16"):
        t_fb.ln_matmul(x.float(), ones, zeros, w, b, 1e-6)
    with pytest.raises(ValueError, match="N % 128"):
        t_fb.ln_matmul(x, ones, zeros, w[:700], b[:700], 1e-6)
    with pytest.raises(ValueError, match="head_dim"):
        ct = torch.zeros((64, 256), device=dev, dtype=torch.bfloat16)
        t_fb.ln_qkv_rope(x, ones, zeros, w, b, ct, ct, 8, 1e-6)
    with pytest.raises(ValueError, match="1024"):  # not a model's width
        w1, b1 = _linear(1024, 256, g)
        w2, b2 = _linear(256, 1024, g)
        t_fb.ln_mlp(x, ones, zeros, w1, b1, w2, b2, 1e-6)


# --------------------------------------------------------------------------
# training kernels: attention backward (csrc/attention_bwd.cu) and the
# forward's lse, the LayerNorm backward (Triton), the LN -> GEMM replay
# --------------------------------------------------------------------------

def _rel_max(out, ref):
    """max |out - ref| over max |ref| (bf16 gradients: p and ds rounded to
    bf16 on both sides, summed in other orders)."""
    a, b = out.float(), ref.float()
    assert torch.isfinite(a).all()
    return ((a - b).abs().max() / b.abs().max()).item()


@pytest.mark.parametrize("B,N,H", [(2, 768, 4), (1, 196, 2), (1, 392, 2),
                                   (3, 64, 1), (1, 1000, 2),
                                   # the 128-row CTAs' and 64-row tiles' edges
                                   (1, 127, 2), (1, 129, 2), (1, 200, 2),
                                   (2, 50, 2), (3, 129, 2), (1, 3000, 16)])
@pytest.mark.parametrize("D", [64, 80])
def test_attention_bwd_kernel_matches_plain(dev, B, N, H, D):
    """Strided q/k/v views of (B, N, 3, H, D), D 64 and 80, ragged N
    included (one and two tiles past a 128-row CTA, N < 64, B = 3 through
    the rank-4 maps): the forward's lse against the plain logsumexp (fp32,
    1e-3 absolute on values ~5), and dq, dk, dv against the plain backward
    on the same o and lse within 2e-2 of max |plain|."""
    g = _gen(8)
    qkv = torch.randn((B, N, 3, H, D), generator=g, device=dev).to(
        torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    do = torch.randn((B, N, H, D), generator=g, device=dev).to(torch.bfloat16)
    o, lse = t_flash.attention_fwd_lse(q, k, v, 0.125)
    _, lse_ref = t_flash.attention_lse_ref(q, k, v, 0.125)
    assert (lse - lse_ref).abs().max().item() < 1e-3
    before = t_flash.attention_bwd.launches
    got = t_flash.attention_bwd(q, k, v, o, lse, do, 0.125)
    ref = t_flash.attention_bwd_ref(q, k, v, o, lse, do, 0.125)
    torch.cuda.synchronize()
    assert t_flash.attention_bwd.launches == before + 1
    for name, a, b in zip("qkv", got, ref):
        assert a.shape == b.shape and a.dtype == torch.bfloat16
        assert _rel_max(a, b) < 2e-2, name


def test_flash_attention_autograd_on_cuda(dev):
    """flash_attention under autograd: forward with lse, backward kernel;
    gradients match autograd through the fp32 plain version on the CPU
    (relative L2 2e-2, bf16 inputs and products)."""
    g = _gen(9)
    q, k, v = (torch.randn((1, 300, 2, 64), generator=g, device=dev)
               .to(torch.bfloat16).requires_grad_() for _ in range(3))
    do = torch.randn((1, 300, 2, 64), generator=g, device=dev).to(
        torch.bfloat16)
    before = t_flash.attention_bwd.launches
    torch.autograd.backward(t_flash.flash_attention(q, k, v, 0.15), do)
    assert t_flash.attention_bwd.launches == before + 1
    qc, kc, vc = (t.detach().float().cpu().requires_grad_() for t in (q, k, v))
    torch.autograd.backward(t_flash.attention_ref(qc, kc, vc, 0.15),
                            do.float().cpu())
    for a, b in ((q, qc), (k, kc), (v, vc)):
        ga, gb = a.grad.float().cpu(), b.grad
        assert ((ga - gb).norm() / gb.norm()).item() < 2e-2


@pytest.mark.parametrize("B,N", [(2, 768), (3, 196)])
def test_packed_qkv_attention_bwd_kernel_matches_plain(dev, B, N):
    """dq, dk, dv written through strides into one packed (3, B, N, C)
    buffer, against the plain backward of the same views."""
    from fast3r_torch.ops import batched_attention as t_ba

    g = _gen(10)
    qkv3 = _bf((3, B, N, 256), g).requires_grad_()
    do = _bf((B, N, 256), g)
    before = t_ba.packed_qkv_attention_bwd.launches
    torch.autograd.backward(t_ba.packed_qkv_attention(qkv3, 4, 0.125), do)
    torch.cuda.synchronize()
    assert t_ba.packed_qkv_attention_bwd.launches == before + 1
    q, k, v = (qkv3.detach()[i].view(B, N, 4, 64) for i in range(3))
    o, lse = t_flash.attention_fwd_lse(q, k, v, 0.125)
    ref = t_flash.attention_bwd_ref(q, k, v, o, lse, do.view(B, N, 4, 64),
                                    0.125)
    for i in range(3):
        assert _rel_max(qkv3.grad[i], ref[i].reshape(B, N, 256)) < 2e-2


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [
    (300, 1024), (2, 5, 64), (7, 96), (1500, 1024),  # a warp a row
    (15360, 1024),                                   # the blocks' shape
    (4, 16384), (3, 2056),                           # a CTA a row
    (9, 100), (5, 17)])                              # scalar (bf16; (5, 17) both)
def test_layernorm_bwd_kernel_matches_plain(dev, dtype, tol, shape):
    """dx within tol of max |plain| (bf16: one output rounding); fp32
    dweight / dbias sums over the rows in another order, 1e-4 relative."""
    g = _gen(11)
    x = (torch.randn(shape, generator=g, device=dev) * 3 + 1).to(dtype)
    w = torch.randn(shape[-1], generator=g, device=dev).to(dtype)
    dy = torch.randn(shape, generator=g, device=dev).to(dtype)
    before = t_ln.layernorm_bwd.launches
    dx, dw, db = t_ln.layernorm_bwd(x, w, dy, 1e-6)
    rdx, rdw, rdb = t_ln.layernorm_bwd_ref(x, w, dy, 1e-6)
    torch.cuda.synchronize()
    assert t_ln.layernorm_bwd.launches == before + 1
    assert dx.dtype == dtype and _rel_max(dx, rdx) < tol
    assert _rel_max(dw, rdw) < 1e-4 and _rel_max(db, rdb) < 1e-4


@pytest.mark.parametrize("pdtype", [torch.float32, torch.bfloat16])
def test_layernorm_bwd_kernel_unaligned_and_mixed_weight(dev, pdtype):
    """x and dy 2 bytes past a 16-byte boundary take the scalar road, the
    aligned ones the warp road; bf16 x with an fp32 or bf16 weight."""
    g = _gen(23)
    bx = (torch.randn(1 + 33 * 512, generator=g, device=dev) * 3 + 1).to(
        torch.bfloat16)
    bd = torch.randn(1 + 33 * 512, generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn(512, generator=g, device=dev).to(pdtype)
    for x, dy in ((bx[1:].view(33, 512), bd[1:].view(33, 512)),
                  (bx[:-1].view(33, 512), bd[:-1].view(33, 512))):
        dx, dw, db = t_ln.layernorm_bwd(x, w, dy, 1e-6)
        rdx, rdw, rdb = t_ln.layernorm_bwd_ref(x, w, dy, 1e-6)
        assert _rel_max(dx, rdx) < 2e-2
        assert _rel_max(dw, rdw) < 1e-4 and _rel_max(db, rdb) < 1e-4


def test_layernorm_bwd_kernel_takes_no_rows(dev):
    x = torch.zeros((0, 64), device=dev, dtype=torch.bfloat16)
    before = t_ln.layernorm_bwd.launches
    dx, dw, db = t_ln.layernorm_bwd(x, torch.ones(64, device=dev), x, 1e-6)
    assert dx.shape == (0, 64) and dx.dtype == torch.bfloat16
    assert torch.equal(dw, torch.zeros(64, device=dev))
    assert torch.equal(db, torch.zeros(64, device=dev))
    assert t_ln.layernorm_bwd.launches == before


def test_layernorm_bwd_kernel_is_deterministic(dev):
    """No float atomics: dx, dweight and dbias are the same bits on two
    launches, on each road and in each dtype."""
    g = _gen(24)
    for dtype in (torch.float32, torch.bfloat16):
        for shape in ((15360, 1024), (4, 16384), (9, 100), (5, 17)):
            x = torch.randn(shape, generator=g, device=dev).to(dtype)
            w = torch.randn(shape[-1], generator=g, device=dev).to(dtype)
            dy = torch.randn(shape, generator=g, device=dev).to(dtype)
            for a, b in zip(t_ln.layernorm_bwd(x, w, dy, 1e-6),
                            t_ln.layernorm_bwd(x, w, dy, 1e-6)):
                assert torch.equal(a, b)


def test_layernorm_autograd_on_cuda(dev):
    g = _gen(12)
    x = _bf((64, 1024), g, 2.0, 0.5).requires_grad_()
    w = _bf((1024,), g, 0.1, 1.0).requires_grad_()
    b = _bf((1024,), g, 0.1).requires_grad_()
    dy = _bf((64, 1024), g)
    torch.autograd.backward(t_ln.fused_layernorm(x, w, b, 1e-6), dy)
    rdx, rdw, rdb = t_ln.layernorm_bwd_ref(x.detach(), w.detach(), dy, 1e-6)
    assert _rel_max(x.grad, rdx) < 2e-2
    assert _rel_max(w.grad, rdw) < 1e-2 and _rel_max(b.grad, rdb) < 1e-2


@pytest.mark.parametrize("M", [128, 300, 37])
@pytest.mark.parametrize("mode", ["bias", "gelu", "qkv", "rope"])
def test_ln_matmul_replay_matches_plain(dev, mode, M):
    """The replay launch of fused_gemm.cu: the product as the plain version
    (one bf16 step + 2e-2) and the residuals u (bf16, one step), mean and
    rstd (fp32, 1e-5 relative) and z (bf16)."""
    from fast3r_torch.nn import fused_block as t_fb
    from fast3r_torch.ops.rope2d import expand_rope_tables, rope2d_cos_sin

    g = _gen(13)
    C = 256
    x = _bf((M, C), g, 2.0, 0.5)
    gamma, beta = _bf((C,), g, 0.1, 1.0), _bf((C,), g, 0.1)
    n_out = 4 * C if mode in ("bias", "gelu") else 3 * C
    w, b = _linear(n_out, C, g)
    tables = None
    if mode == "rope":
        pos = torch.randint(0, 40, (1, M, 2), device="cuda", generator=g)
        tables = expand_rope_tables(*rope2d_cos_sin(pos, 64), C,
                                    torch.bfloat16)
    before = t_fb.ln_matmul_replay.launches
    got = t_fb._replay(mode, x, gamma, beta, w, b, 1e-6, tables, 4)
    ref = t_fb._replay_ref(mode, x, gamma, beta, w, b, 1e-6, tables, 4)
    torch.cuda.synchronize()
    assert t_fb.ln_matmul_replay.launches == before + 1
    _assert_bf16_close(got[0], ref[0].contiguous(), atol=2e-2)
    _assert_bf16_close(got[1], ref[1], atol=1e-2)
    for a, r in zip(got[2:4], ref[2:4]):
        assert ((a - r).abs() <= 1e-5 * r.abs() + 1e-6).all()
    if mode == "gelu":
        _assert_bf16_close(got[4], ref[4], atol=2e-2)
    else:
        assert got[4] is None


@pytest.mark.parametrize("prefer_fused_mlp", [True, False])
def test_fused_block_grads_on_cuda_match_cpu(dev, prefer_fused_mlp,
                                             monkeypatch):
    """The fused block at the flagship width (1024, 16 heads) on 2 x 56
    tokens, both roads of attention (encoder: RoPE + packed; decoder):
    bf16 gradients on the card vs fp32 on the CPU within 3e-2 relative L2
    (bf16 through the block's products and the backward's)."""
    from fast3r_torch.nn import fused_block as t_fb
    from fast3r_torch.nn.layers import Block
    from fast3r_torch.ops.rope2d import expand_rope_tables, rope2d_cos_sin

    monkeypatch.setattr(t_fb, "PREFER_FUSED_MLP", prefer_fused_mlp)
    torch.manual_seed(0)
    blk = Block(1024)
    with torch.no_grad():
        for p in blk.parameters():
            p.add_(0.05 * torch.randn_like(p))
    x = torch.randn((2, 56, 1024)) * 2 + 0.5
    dy = torch.randn((2, 56, 1024))
    yy, xx = torch.meshgrid(torch.arange(7), torch.arange(8), indexing="ij")
    pos = torch.stack([yy, xx], -1).reshape(1, 56, 2).repeat(2, 1, 1)
    for impl, with_rope in (("batched", True), ("pallas", False)):
        res = {}
        for where, dt in (("cpu", torch.float32), ("cuda", torch.bfloat16)):
            b = Block(1024)
            b.load_state_dict(blk.state_dict())
            b = b.to(where, dt)
            xi = x.to(where, dt).detach().requires_grad_()
            rope = None
            if with_rope:
                cos, sin = rope2d_cos_sin(pos.to(where), 64)
                rope = (cos, sin) + expand_rope_tables(cos, sin, 1024, dt)
            y = t_fb.fused_vit_block(b, xi, rope, 16, 0.125, impl, 1e-6)
            torch.autograd.backward(y, dy.to(where, dt))
            res[where] = [xi.grad] + [p.grad for p in b.parameters()]
        for a, r in zip(res["cuda"], res["cpu"]):
            a = a.float().cpu()
            assert ((a - r).norm() / r.norm()).item() < 3e-2, impl


def test_train_step_on_cuda_matches_cpu(dev):
    """One train_step of the fused road at the flagship widths, shallow
    depth, 2 views at 112x128: bf16 params on the card vs fp32 on the CPU,
    the same weights, batch and image ids.  The first step runs at lr 0,
    so the loss (1e-2 relative) and each top-level group's gradient norm
    (3e-2 relative: bf16 through 6 blocks and their backward) are compared.
    Every training kernel launched."""
    from fast3r_torch.data.dummy import make_dummy_batch
    from fast3r_torch.nn import fused_block as t_fb
    from fast3r_torch.ops import batched_attention as t_ba
    from fast3r_torch.train.step import (OptimConfig, init_train_state,
                                         train_step)
    import fast3r_torch

    cfg = _shallow_cfg(1024, 16, fused=True)
    cpu = fast3r_torch.Fast3R.from_random(cfg, seed=0, device="cpu")
    gpu = cpu.to(device="cuda", dtype=torch.bfloat16)
    batch = make_dummy_batch(1, 2, 112, 128, seed=0)
    ids = torch.tensor([[0, 17]], dtype=torch.int32)
    opt = OptimConfig(warmup_steps=2, total_steps=100)
    fns = (t_flash.attention_bwd, t_ba.packed_qkv_attention_bwd,
           t_ln.layernorm_bwd, t_fb.ln_matmul_replay)
    before = [f.launches for f in fns]
    metrics = {}
    for where, model in (("cpu", cpu), ("cuda", gpu)):
        state = init_train_state(model.params, opt)
        _, metrics[where] = train_step(state, batch, cfg, opt, view_ids=ids)
    torch.cuda.synchronize()
    assert all(f.launches > b for f, b in zip(fns, before))
    m, r = metrics["cuda"], metrics["cpu"]
    assert m["skipped_nonfinite"] == 0
    assert abs(m["loss"].item() - r["loss"].item()) < 1e-2 * abs(r["loss"].item())
    for k in r:
        if k.startswith("watch/grad_norm/"):
            assert abs(m[k].item() - r[k].item()) < 3e-2 * r[k].item(), k


# --------------------------------------------------------------------------
# the llama decoder's RMS products (csrc/fused_gemm.cu, RMS prologue: K13)
# and the llama model on the card
# --------------------------------------------------------------------------

@pytest.mark.parametrize("M", [1000, 128, 37])
@pytest.mark.parametrize("kind", ["rms_matmul", "rms_matmul_silu", "rms_qkv3",
                                  "rms_qkv3_gqa", "replay", "replay_silu"])
def test_rms_kernels_match_plain(dev, kind, M):
    """Every RMS mode of fused_gemm.cu vs its plain version at K = 1024 (the
    prologue's width), ragged rows included: the product one bf16 step +
    2e-2 (as the LN modes); the replay's u one bf16 step + 1e-2, rstd
    1e-5 relative, z as the product.  gamma in fp32, so the forward's
    rounding of it and the replay's fp32 multiply both show."""
    from fast3r_torch.nn import fused_block as t_fb

    g = _gen(14)
    K = 1024
    x = _bf((M, K), g, 2.0, 0.5)
    gamma = 1 + 0.1 * torch.randn((K,), generator=g, device=dev)
    act = "silu" if kind.endswith("silu") else None
    if kind.startswith("rms_qkv3"):
        kvd = 256 if kind.endswith("gqa") else K  # 4 of 16 heads: N = 1536
        wq, _ = _linear(K, K, g)
        wk, _ = _linear(kvd, K, g)
        wv, _ = _linear(kvd, K, g)
        wrapper = t_fb.rms_qkv3
        before = wrapper.launches
        out = torch.cat(wrapper(x, gamma, wq, wk, wv, 1e-5), dim=1)
        ref = torch.cat(t_fb.rms_qkv3_ref(x, gamma, wq, wk, wv, 1e-5), dim=1)
    else:
        w, _ = _linear(2816, K, g)
        replay = kind.startswith("replay")
        wrapper = t_fb.rms_matmul_replay if replay else t_fb.rms_matmul
        before = wrapper.launches
        if replay:
            got = wrapper(x, gamma, w, 1e-5, act)
            ref = t_fb.rms_matmul_replay_ref(x, gamma, w, 1e-5, act)
            torch.cuda.synchronize()
            _assert_bf16_close(got[1], ref[1], atol=1e-2)
            assert ((got[2] - ref[2]).abs() <= 1e-5 * ref[2].abs()).all()
            if act:
                _assert_bf16_close(got[3], ref[3], atol=2e-2)
            else:
                assert got[3] is None
            out, ref = got[0], ref[0]
        else:
            out = wrapper(x, gamma, w, 1e-5, act=act)
            ref = t_fb.rms_matmul_ref(x, gamma, w, 1e-5, act=act)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    _assert_bf16_close(out, ref, atol=2e-2)


def test_matmul_residual_at_ffn_hidden_depth(dev):
    """The llama block's w2 product: K = 2816 (88 k-slices), N = 1024."""
    from fast3r_torch.nn import fused_block as t_fb

    g = _gen(15)
    h = _bf((300, 2816), g, 0.5)
    x = _bf((300, 1024), g, 2.0, 0.5)
    w, _ = _linear(1024, 2816, g)
    zero = torch.zeros(1024, device=dev, dtype=torch.bfloat16)
    out = t_fb.matmul_residual(h, w, zero, x)
    _assert_bf16_close(out, t_fb.matmul_residual_ref(h, w, zero, x), 2e-2)


def test_rms_kernels_reject_what_they_cannot_take(dev):
    from fast3r_torch.nn import fused_block as t_fb

    g = _gen(16)
    x = _bf((64, 640), g)
    w, _ = _linear(256, 640, g)
    with pytest.raises(ValueError, match="RMS prologue"):
        t_fb.rms_matmul(x, torch.ones(640, device=dev), w, 1e-5)
    x = _bf((64, 1024), g)
    w, _ = _linear(200, 1024, g)
    with pytest.raises(ValueError, match="N % 128"):
        t_fb.rms_matmul(x, torch.ones(1024, device=dev), w, 1e-5)


def _llama_shallow_cfg(n_kv_heads=None):
    """The slice's widths (1024, 16 heads of 64, hidden 2816): 2 encoder
    blocks, 4 llama layers, the flagship head."""
    import dataclasses

    from fast3r_torch.models.llama_decoder import LlamaDecoderConfig

    return dataclasses.replace(
        _shallow_cfg(1024, 16, fused=True),
        decoder=LlamaDecoderConfig(n_layers=4, n_kv_heads=n_kv_heads))


@pytest.mark.parametrize("n_kv_heads", [None, 4])
def test_llama_request_on_cuda_matches_cpu(dev, n_kv_heads):
    """A 2-view 112x128 llama request (56 tokens a view) on the fused road,
    bf16 on the card vs fp32 plain versions on the CPU, the same weights
    and ids: relative L2 within 2e-2 per output; the K13 kernels
    launched (and none on the plain road)."""
    import fast3r_torch
    from fast3r_torch.nn import fused_block as t_fb

    cfg = _llama_shallow_cfg(n_kv_heads)
    cpu = fast3r_torch.Fast3R.from_random(cfg, seed=0, device="cpu")
    gpu = cpu.to(device="cuda", dtype=torch.bfloat16)
    views = [{"img": torch.rand((1, 112, 128, 3), generator=torch.Generator()
                                .manual_seed(i)) * 2 - 1} for i in range(2)]
    ref = fast3r_torch.inference(views, cpu, verbose=False)["preds"]
    fns = (t_fb.rms_qkv3, t_fb.rms_matmul, t_fb.matmul_residual)
    before = [f.launches for f in fns]
    out = fast3r_torch.inference(views, gpu, verbose=False)["preds"]
    assert all(f.launches > b for f, b in zip(fns, before))
    for p, r in zip(out, ref):
        for k in r:
            assert torch.isfinite(p[k]).all(), k
            assert ((p[k] - r[k]).norm() / r[k].norm()).item() < 2e-2, k
    plain = fast3r_torch.Fast3R(cfg.with_fused_blocks(False), gpu.params)
    before = [f.launches for f in fns[:2]]
    fast3r_torch.inference(views, plain, verbose=False)
    assert [f.launches for f in fns[:2]] == before


def test_llama_train_step_on_cuda_matches_cpu(dev):
    """One llama train_step on the fused road at the slice's widths,
    shallow depth, 2 views at 112x128: bf16 on the card vs fp32 on the
    CPU, the same weights, batch and rotary ids.  The first step runs at
    lr 0: the loss (1e-2 relative) and each group's gradient norm (3e-2
    relative) are compared, and the replay launched."""
    import fast3r_torch
    from fast3r_torch.data.dummy import make_dummy_batch
    from fast3r_torch.nn import fused_block as t_fb
    from fast3r_torch.train.step import (OptimConfig, init_train_state,
                                         train_step)

    cfg = _llama_shallow_cfg()
    cpu = fast3r_torch.Fast3R.from_random(cfg, seed=0, device="cpu")
    gpu = cpu.to(device="cuda", dtype=torch.bfloat16)
    batch = make_dummy_batch(1, 2, 112, 128, seed=0)
    ids = torch.tensor([[0, 17]], dtype=torch.int32)
    opt = OptimConfig(warmup_steps=2, total_steps=100)
    fns = (t_fb.rms_matmul_replay, t_flash.attention_bwd)
    before = [f.launches for f in fns]
    metrics = {}
    for where, model in (("cpu", cpu), ("cuda", gpu)):
        state = init_train_state(model.params, opt)
        _, metrics[where] = train_step(state, batch, cfg, opt, view_ids=ids)
    torch.cuda.synchronize()
    assert all(f.launches > b for f, b in zip(fns, before))
    m, r = metrics["cuda"], metrics["cpu"]
    assert m["skipped_nonfinite"] == 0
    assert abs(m["loss"].item() - r["loss"].item()) < 1e-2 * abs(r["loss"].item())
    for k in r:
        if k.startswith("watch/grad_norm/"):
            assert abs(m[k].item() - r[k].item()) < 3e-2 * r[k].item(), k


def _bf16_step(x: torch.Tensor) -> float:
    """One bf16 step at x's largest magnitude."""
    return 2.0 ** (math.floor(math.log2(x.abs().max().item())) - 7)


@pytest.mark.parametrize("shape,out_hw", [
    ((1, 128, 256, 256), (512, 512)),   # the 512x512 view's trunk
    ((2, 128, 224, 256), (448, 512)),   # 448x512 views
    ((1, 256, 40, 56), (81, 117)),      # non-2x ratios, a ragged last group
    ((1, 128, 96, 64), (48, 32)),       # downscale
    ((20, 128, 256, 256), (512, 512)),  # the 20-view 512x512 request's head
    ((6, 128, 224, 256), (448, 512)),   # the mixed request's 448x512 group
    ((1, 128, 45, 37), (90, 74)),       # 74-byte rows: 2-byte copies
    ((1, 128, 256, 248), (512, 496)),   # 512x496 views
])
def test_resize_kernel_matches_plain(dev, shape, out_hw):
    """K12 against resize_matmul (the same two bf16 rounding points):
    within one bf16 step at the output's largest magnitude."""
    from fast3r_torch.ops import resize as t_resize
    from fast3r_torch.ops import resize_kernel as t_rk

    x = torch.randn(shape, generator=_gen(12), device=dev).to(torch.bfloat16)
    before = t_rk.resize_bilinear_kernel.launches
    out = t_rk.resize_bilinear_kernel(x, *out_hw)
    assert t_rk.resize_bilinear_kernel.launches == before + 1
    ref = t_resize.resize_matmul(x, *out_hw)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == torch.bfloat16
    assert (out.float() - ref.float()).abs().max().item() <= _bf16_step(ref)


def test_resize_kernel_walk_and_alignment(dev):
    """Few persistent CTAs (each walking many items through its ring of
    stages) give the default grid's bits; an input 2 bytes past a 16-byte
    boundary takes the 2-byte copies and the same bits again; two launches
    agree bit for bit; the kernel asks for the plan's shared memory."""
    from fast3r_torch.kernels import build
    from fast3r_torch.ops import resize_kernel as t_rk

    g = _gen(23)
    buf = torch.randn(1 + 128 * 64 * 96, generator=g, device=dev).to(
        torch.bfloat16)
    x = buf[:-1].view(1, 128, 64, 96)
    ref = t_rk._launch(x, 150, 200)
    for ctas in (1, 3, 7):
        assert torch.equal(t_rk._launch(x, 150, 200, ctas=ctas), ref)
    assert torch.equal(t_rk._launch(x, 150, 200), ref)
    moved = buf[1:].view(1, 128, 64, 96)
    moved_ref = t_rk._launch(moved.clone(), 150, 200)
    assert not t_rk.band_plan(64, 96, 150, 200, False).bulk
    assert torch.equal(t_rk._launch(moved, 150, 200), moved_ref)
    for shape in ((256, 256, 512, 512), (224, 256, 448, 512), (45, 37, 90, 74)):
        p = t_rk.band_plan(*shape)
        assert build.library().fast3r_resize_smem_bytes(
            p.rows, p.cols, p.stage_rows, p.pitch, p.stages) == p.smem_bytes


def test_resize_kernel_road_and_gradient(dev):
    """The dispatcher sends trunk-scale bf16 to K12 and the rest to the
    matmul form; the autograd backward is the transposed matrices."""
    from fast3r_torch.ops import resize as t_resize
    from fast3r_torch.ops import resize_kernel as t_rk

    x = torch.randn((1, 128, 192, 256), generator=_gen(13), device=dev)
    before = t_rk.resize_bilinear_kernel.launches
    t_resize.resize_bilinear_align_corners(x.bfloat16(), 384, 512)
    t_resize.resize_bilinear_align_corners(x, 384, 512)  # fp32: matmul
    t_resize.resize_bilinear_align_corners(x[:, :, :96].bfloat16(), 192, 512)
    assert t_rk.resize_bilinear_kernel.launches == before + 1
    xb = x.bfloat16().requires_grad_()
    g = torch.randn((1, 128, 384, 512), generator=_gen(14),
                    device=dev).bfloat16()
    t_rk.resize_bilinear_kernel(xb, 384, 512).backward(g)
    xr = x.bfloat16().requires_grad_()
    t_resize.resize_matmul(xr, 384, 512).backward(g)
    torch.testing.assert_close(xb.grad.float(), xr.grad.float())
    with pytest.raises(ValueError, match="bf16"):
        t_rk.resize_bilinear_kernel(x, 384, 512)


def test_pose_card_matches_cpu_on_a_seeded_scene(dev):
    """Pose recovery on the card against fp32 on the CPU, on the same
    predictions (three known cameras at 448x512 with noise and outliers,
    ``chip_smoke.pose_scene``) and the same minimal samples: within 1e-3."""
    import numpy as np

    from chip_smoke import pose_scene
    from fast3r_torch.eval.pose import estimate_camera_poses
    from fast3r_torch.ops.pnp import draw_samples

    preds, gt = pose_scene(3, 448, 512, seed=14)
    mask = torch.stack([p["conf"][0].reshape(-1) > 1.0 for p in preds]).cuda()
    idx = draw_samples(mask, 32, 8, _gen(0))
    on_gpu, _ = estimate_camera_poses(preds, device="cuda", sample_idx=[idx])
    on_cpu, _ = estimate_camera_poses(preds, device="cpu",
                                      sample_idx=[idx.cpu()])
    assert np.abs(np.stack(on_gpu[0]) - np.stack(on_cpu[0])).max() < 1e-3
    assert np.abs(np.stack(on_gpu[0]) - gt).max() < 1e-2


def _ring_inputs(n, B, S_loc, H, dtype, seed, D=64):
    """Rank-stacked q, k, v (n, B, S_loc, H, D): strided views of one
    (n, B, S_loc, 3, H, D) buffer, as the decoder's qkv projection gives."""
    qkv = torch.randn((n, B, S_loc, 3, H, D), generator=_gen(seed),
                      device="cuda").to(dtype)
    return qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]


# o: fp32 differs from the plain ring in summation order; bf16 rounds p
# before p @ v where the plain version rounds the normalised weights (the
# attention kernel's tolerance).  lse: fp32 scores from the same inputs.
RING_CUDA_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-2, 1e-3)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,B,S_loc,H", [(1, 1, 128, 2), (2, 2, 100, 2),
                                         (3, 1, 64, 3), (8, 1, 72, 2),
                                         # the 128-query items' and
                                         # 128-key tiles' edges
                                         (2, 1, 129, 2), (4, 2, 129, 2),
                                         (4, 1, 750, 16)])
def test_ring_kernel_matches_plain(dev, dtype, n, B, S_loc, H):
    """K14's forward over n ranks on one card (ragged S_loc, B = 2, strided
    inputs) against the plain ring: o and the natural-log lse."""
    from fast3r_torch.parallel import ring_rdma as t_ring
    from fast3r_torch.parallel.sequence import ring_flash_attention

    q, k, v = _ring_inputs(n, B, S_loc, H, dtype, 20 + n)
    before = t_ring.ring_flash_attention_rdma.launches
    o, lse = t_ring._rdma_forward(q, k, v, 0.125, n)
    assert t_ring.ring_flash_attention_rdma.launches == before + 1
    ref_o, ref_lse = ring_flash_attention(q, k, v, 0.125)
    torch.cuda.synchronize()
    o_tol, lse_tol = RING_CUDA_TOL[dtype]
    assert o.shape == (n, B, S_loc, H, 64) and o.dtype == dtype
    assert lse.shape == (n, B * H, S_loc) and lse.dtype == torch.float32
    assert (o.float() - ref_o.float()).abs().max().item() < o_tol
    assert (lse - ref_lse).abs().max().item() < lse_tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("epochs,S", [(2, 200), (4, 200), (5, 200), (4, 129),
                                      (3, 100)])
def test_ring_kernel_self_ring(dev, dtype, epochs, S):
    """n = 1 with E epochs over the rank's own slots: o equals plain
    attention, the lse is the plain lse + ln E."""
    from fast3r_torch.parallel import ring_rdma as t_ring

    q, k, v = _ring_inputs(1, 1, S, 2, dtype, 30)
    o, lse = t_ring._rdma_forward(q, k, v, 0.125, 1, self_ring_epochs=epochs)
    ref_o, ref_lse = t_flash.attention_lse_ref(q[0], k[0], v[0], 0.125)
    torch.cuda.synchronize()
    o_tol, lse_tol = RING_CUDA_TOL[dtype]
    assert (o[0].float() - ref_o.float()).abs().max().item() < o_tol
    shifted = ref_lse.reshape(2, S) + math.log(epochs)
    assert (lse[0] - shifted).abs().max().item() < lse_tol


@pytest.mark.parametrize("n,ctas", [(4, 1), (3, 2), (1, 1)])
def test_ring_kernel_walk(dev, n, ctas):
    """Few CTAs a rank (each walks many items every epoch, its state
    through the scratch between epochs): bitwise what the resident count
    gives."""
    from fast3r_torch.parallel import ring_rdma as t_ring

    q, k, v = _ring_inputs(n, 2, 300, 3, torch.bfloat16, 48)
    got = t_ring._rdma_forward(q, k, v, 0.125, n, ctas_per_rank=ctas)
    ref = t_ring._rdma_forward(q, k, v, 0.125, n)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_ring_kernel_copies_ranks_and_batches_that_do_not_merge(dev):
    """bf16 shards whose rank stride is below the batch stride ((B, n, ...)
    transposed): q, k and v each go through one counted copy (their maps
    merge rank and batch), and the ring still matches the plain one."""
    from fast3r_torch.parallel import ring_rdma as t_ring
    from fast3r_torch.parallel.sequence import ring_flash_attention

    qkv = torch.randn((2, 3, 100, 3, 2, 64), generator=_gen(49),
                      device=dev).to(torch.bfloat16).transpose(0, 1)
    q, k, v = qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]
    assert t_flash.tma_dims(q) is None
    before = t_flash.tma_view.copies
    o, lse = t_ring._rdma_forward(q, k, v, 0.125, 3)
    assert t_flash.tma_view.copies == before + 3
    ref_o, ref_lse = ring_flash_attention(q, k, v, 0.125)
    torch.cuda.synchronize()
    o_tol, lse_tol = RING_CUDA_TOL[torch.bfloat16]
    assert (o.float() - ref_o.float()).abs().max().item() < o_tol
    assert (lse - ref_lse).abs().max().item() < lse_tol


def test_ring_kernel_rejects_what_it_cannot_take(dev):
    """Raises, never falls back: head dim, dtype, rank count, the self-ring
    off n = 1, and CTAs that cannot all be resident at once."""
    from fast3r_torch.parallel import ring_rdma as t_ring

    q, k, v = _ring_inputs(2, 1, 64, 2, torch.bfloat16, 40)
    with pytest.raises(ValueError, match="64"):
        t_ring.ring_flash_attention_rdma(q[..., :32], k[..., :32],
                                         v[..., :32], 0.125, 2)
    with pytest.raises(ValueError, match="dtype"):
        x = q.half()
        t_ring.ring_flash_attention_rdma(x, x, x, 0.125, 2)
    with pytest.raises(ValueError, match="ranks"):
        t_ring.ring_flash_attention_rdma(q, k, v, 0.125, 4)
    with pytest.raises(ValueError, match="self-ring"):
        t_ring.ring_flash_attention_rdma(q, k, v, 0.125, 2,
                                         self_ring_epochs=3)
    resident = t_ring._plan(torch.bfloat16, 64, 2)[0]
    assert resident >= 1
    with pytest.raises(RuntimeError, match="CUDA error"):
        t_ring._rdma_forward(q, k, v, 0.125, 2, ctas_per_rank=resident + 1)
    torch.cuda.synchronize()  # the refused launch left the context usable
    o = t_ring.ring_flash_attention_rdma(q, k, v, 0.125, 2)
    assert torch.isfinite(o.float()).all()


# --------------------------------------------------------------------------
# K14's backward: the dq and dk/dv ring kernels (csrc/ring_attention_bwd.cu)
# and the seq-sharded training step on the card
# --------------------------------------------------------------------------

# dq, dk, dv against ring_attention_bwd_ref on the same o and lse, relative
# to max |plain|: fp32 differs in summation order only; bf16 as the
# attention backward's test (p or ds on the other side of a bf16 step)
RING_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,B,S_loc,H", [(1, 1, 128, 2), (2, 2, 100, 2),
                                         (3, 1, 64, 3), (8, 1, 72, 2),
                                         # the 128-row items' and 64-row
                                         # tiles' edges
                                         (2, 1, 127, 2), (2, 1, 129, 2),
                                         (3, 1, 200, 2), (4, 1, 50, 2),
                                         (2, 3, 129, 2), (4, 1, 750, 16)])
def test_ring_bwd_kernels_match_plain(dev, dtype, n, B, S_loc, H):
    """The dq ring and the dk/dv ring over n ranks on one card (ragged
    S_loc and S_loc < 64, B = 2 and 3, strided q/k/v, 16 heads over 3000
    tokens) from the forward kernel's o and lse, against the plain version
    of both rings; one launch each."""
    from fast3r_torch.parallel import ring_rdma as t_ring
    from fast3r_torch.parallel.sequence import ring_attention_bwd_ref

    q, k, v = _ring_inputs(n, B, S_loc, H, dtype, 50 + n)
    do = torch.randn((n, B, S_loc, H, 64), generator=_gen(60 + n),
                     device=dev).to(dtype)
    o, lse = t_ring._rdma_forward(q, k, v, 0.125, n)
    before = (t_ring.ring_attention_bwd_dq.launches,
              t_ring.ring_attention_bwd_dkv.launches)
    got = t_ring._ring_backward(q, k, v, o, lse, do, 0.125, n)
    ref = ring_attention_bwd_ref(q, k, v, o, lse, do, 0.125)
    torch.cuda.synchronize()
    assert (t_ring.ring_attention_bwd_dq.launches,
            t_ring.ring_attention_bwd_dkv.launches) == (before[0] + 1,
                                                        before[1] + 1)
    for name, a, b in zip("qkv", got, ref):
        assert a.shape == (n, B, S_loc, H, 64) and a.dtype == dtype
        assert _rel_max(a, b) < RING_BWD_TOL[dtype], name


def test_backward_kernels_are_deterministic(dev):
    """Two passes, no float atomics: K9 (decoder views and the packed
    buffer's) and the ring pair give bitwise-equal gradients on two runs of
    the same inputs."""
    from fast3r_torch.ops import batched_attention as t_ba
    from fast3r_torch.parallel import ring_rdma as t_ring

    g = _gen(11)
    qkv = torch.randn((2, 700, 3, 4, 64), generator=g, device=dev).to(
        torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    do = torch.randn((2, 700, 4, 64), generator=g, device=dev).to(
        torch.bfloat16)
    o, lse = t_flash.attention_fwd_lse(q, k, v, 0.125)
    runs = [t_flash.attention_bwd(q, k, v, o, lse, do, 0.125)
            for _ in range(2)]
    qkv3 = _bf((3, 2, 300, 256), g)
    qp, kp, vp = (qkv3[i].view(2, 300, 4, 64) for i in range(3))
    dop = _bf((2, 300, 256), g)
    op, lsep = t_flash.attention_fwd_lse(qp, kp, vp, 0.125)
    packed = [t_ba.packed_qkv_attention_bwd(qkv3, op, lsep, dop, 4, 0.125)
              for _ in range(2)]
    qr, kr, vr = _ring_inputs(4, 1, 300, 2, torch.bfloat16, 45)
    dor = torch.randn(qr.shape, generator=_gen(46), device=dev).to(
        torch.bfloat16)
    orr, lser = t_ring._rdma_forward(qr, kr, vr, 0.125, 4)
    rings = [t_ring._ring_backward(qr, kr, vr, orr, lser, dor, 0.125, 4)
             for _ in range(2)]
    torch.cuda.synchronize()
    for first, second in (runs, packed, rings):
        for a, b in zip(first, second):
            assert torch.equal(a, b)


def test_ring_bwd_kernels_reject_too_many_ctas(dev):
    """Each backward ring raises when asked for one CTA per rank more than
    can be resident; the context stays usable."""
    from fast3r_torch.parallel import ring_rdma as t_ring

    q, k, v = _ring_inputs(2, 1, 64, 2, torch.bfloat16, 41)
    do = torch.randn((2, 1, 64, 2, 64), generator=_gen(42),
                     device=dev).to(torch.bfloat16)
    o, lse = t_ring._rdma_forward(q, k, v, 0.125, 2)
    delta, meta = t_ring._bwd_rows(o, do, lse)
    for which in (0, 1):
        resident = t_ring._plan_bwd(which, torch.bfloat16, 64, 2)[0]
        assert resident >= 1
        with pytest.raises(RuntimeError, match="CUDA error"):
            if which == 0:
                t_ring.ring_attention_bwd_dq(q, k, v, do, lse, delta, 0.125, 2,
                                             ctas_per_rank=resident + 1)
            else:
                t_ring.ring_attention_bwd_dkv(q, k, v, do, meta, 0.125, 2,
                                              ctas_per_rank=resident + 1)
    torch.cuda.synchronize()
    got = t_ring._ring_backward(q, k, v, o, lse, do, 0.125, 2)
    assert all(torch.isfinite(g.float()).all() for g in got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,B,S_loc,H,ctas", [(1, 1, 200, 2, None),
                                              (3, 1, 129, 3, None),
                                              (8, 1, 72, 2, None),
                                              (3, 2, 100, 2, None),
                                              # one CTA a rank: every
                                              # item's state through the
                                              # scratch between epochs
                                              (3, 2, 300, 3, 1)])
def test_ring_kernels_head_dim_80_match_plain(dev, dtype, n, B, S_loc, H,
                                              ctas):
    """K14 at head_dim 80 (model_scaling_huge's decoder): the forward ring
    and both backward rings over n ranks (ragged S_loc, B = 2, strided
    inputs) against the plain ring and ring_attention_bwd_ref, under the
    head_dim-64 tests' tolerances; one launch each."""
    from fast3r_torch.parallel import ring_rdma as t_ring
    from fast3r_torch.parallel.sequence import (ring_attention_bwd_ref,
                                                ring_flash_attention)

    scale = 80 ** -0.5
    q, k, v = _ring_inputs(n, B, S_loc, H, dtype, 70 + n, D=80)
    do = torch.randn((n, B, S_loc, H, 80), generator=_gen(80 + n),
                     device=dev).to(dtype)
    fns = (t_ring.ring_flash_attention_rdma, t_ring.ring_attention_bwd_dq,
           t_ring.ring_attention_bwd_dkv)
    before = [f.launches for f in fns]
    o, lse = t_ring._rdma_forward(q, k, v, scale, n, ctas_per_rank=ctas)
    got = t_ring._ring_backward(q, k, v, o, lse, do, scale, n,
                                ctas_per_rank=ctas)
    ref_o, ref_lse = ring_flash_attention(q, k, v, scale)
    ref = ring_attention_bwd_ref(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(fns, before)] == [1, 1, 1]
    o_tol, lse_tol = RING_CUDA_TOL[dtype]
    assert o.shape == (n, B, S_loc, H, 80) and o.dtype == dtype
    assert (o.float() - ref_o.float()).abs().max().item() < o_tol
    assert (lse - ref_lse).abs().max().item() < lse_tol
    for name, a, b in zip("qkv", got, ref):
        assert a.shape == (n, B, S_loc, H, 80) and a.dtype == dtype
        assert _rel_max(a, b) < RING_BWD_TOL[dtype], name


def test_ring_kernels_reject_other_head_dims(dev):
    """A head_dim the kernels have no instantiation for raises on CUDA
    (the seq-sharded paths' own check: tests/test_torch_sequence_d80.py)."""
    from fast3r_torch.parallel import ring_rdma as t_ring

    q, k, v = _ring_inputs(2, 1, 64, 2, torch.bfloat16, 90, D=96)
    with pytest.raises(ValueError, match="96"):
        t_ring.ring_flash_attention_rdma(q, k, v, 0.125, 2)
    do = torch.zeros_like(q)
    lse = torch.zeros((2, 2, 64), device=dev)
    with pytest.raises(ValueError, match="96"):
        t_ring._ring_backward(q, k, v, q, lse, do, 0.125, 2)


def test_ring_attention_autograd_matches_plain_ring(dev):
    """ring_flash_attention_rdma_diff under autograd (the forward kernel,
    then both backward rings) against autograd of the plain ring in fp32 on
    the same bf16 inputs: relative L2 within 2e-2."""
    from fast3r_torch.parallel import ring_rdma as t_ring
    from fast3r_torch.parallel.sequence import ring_flash_attention

    n = 4
    q, k, v = (t.detach().clone().requires_grad_()
               for t in _ring_inputs(n, 1, 96, 2, torch.bfloat16, 43))
    do = torch.randn((n, 1, 96, 2, 64), generator=_gen(44),
                     device=dev).to(torch.bfloat16)
    before = (t_ring.ring_flash_attention_rdma.launches,
              t_ring.ring_attention_bwd_dq.launches,
              t_ring.ring_attention_bwd_dkv.launches)
    torch.autograd.backward(
        t_ring.ring_flash_attention_rdma_diff(q, k, v, 0.125, n), do)
    torch.cuda.synchronize()
    assert (t_ring.ring_flash_attention_rdma.launches,
            t_ring.ring_attention_bwd_dq.launches,
            t_ring.ring_attention_bwd_dkv.launches) == tuple(
                b + 1 for b in before)
    qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
    torch.autograd.backward(ring_flash_attention(qf, kf, vf, 0.125)[0],
                            do.float())
    for a, b in ((q, qf), (k, kf), (v, vf)):
        ga, gb = a.grad.float(), b.grad
        assert ((ga - gb).norm() / gb.norm()).item() < 2e-2


def test_seq_sharded_train_step_on_cuda_matches_single_device(dev):
    """One seq-sharded step over 2 ranks (ring kernels, remat) at the
    flagship widths and shallow depth, 2 views at 112x128, bf16, against
    the single-device card train_step on the same decoder road (plain
    blocks, K1 / K9 attention) with the same ids: the loss within 1e-2
    relative, each group's gradient norm within 3e-2 (bf16, two attention
    kernels); ring launches 2 x depth forward (remat), depth per backward
    ring, and no decoder K1 / K9."""
    import dataclasses

    import fast3r_torch
    from fast3r_torch.data.dummy import make_dummy_batch
    from fast3r_torch.parallel import ring_rdma as t_ring
    from fast3r_torch.parallel.sequence import make_seq_sharded_train_step
    from fast3r_torch.train.step import (OptimConfig, init_train_state,
                                         train_step)

    cfg = _shallow_cfg(1024, 16, fused=True)
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, fused_blocks=False))
    gpu = fast3r_torch.Fast3R.from_random(cfg, seed=0, device="cuda",
                                          dtype=torch.bfloat16)
    batch = make_dummy_batch(1, 2, 112, 128, seed=0)
    ids = torch.tensor([[0, 17]], dtype=torch.int32)
    opt = OptimConfig(warmup_steps=2, total_steps=100)
    _, ref = train_step(init_train_state(gpu.params, opt), batch, cfg, opt,
                        view_ids=ids)
    fns = (t_ring.ring_flash_attention_rdma, t_ring.ring_attention_bwd_dq,
           t_ring.ring_attention_bwd_dkv, t_flash.flash_attention,
           t_flash.attention_bwd)
    before = [f.launches for f in fns]
    step = make_seq_sharded_train_step(cfg, opt, 2)
    _, m = step(init_train_state(gpu.params, opt), batch, ids)
    torch.cuda.synchronize()
    depth = cfg.decoder.depth
    assert [f.launches - b for f, b in zip(fns, before)] == [
        2 * depth, depth, depth, 0, 0]
    assert m["skipped_nonfinite"] == 0
    assert abs(m["loss"].item() - ref["loss"].item()) < 1e-2 * abs(
        ref["loss"].item())
    for k in ref:
        if k.startswith("watch/grad_norm/"):
            assert abs(m[k].item() - ref[k].item()) < 3e-2 * ref[k].item(), k


# ---------------------------------------------------------------------------
# the 1000-view shapes: 1000 views of 512x384 are M = S = 768,000 tokens;
# the packed (3, M, 1024) qkv (2.36G elements) and fc1's (M, 4096) output
# (3.15G) pass 2^31 elements.  Each kernel runs whole; its plain version on
# the rows of kernels.rows (the first and last 1024 of each output and
# packed plane, 2048 seeded rows between; K1 and the ring on query rows a
# head), at the flagship-shape cases' tolerances.
# ---------------------------------------------------------------------------

def _bf_big(shape, g, scale=1.0, shift=0.0):
    """A bf16 normal tensor drawn in bf16 (no fp32 copy of a 6 GB one)."""
    return torch.randn(shape, generator=g, device="cuda",
                       dtype=torch.bfloat16).mul_(scale).add_(shift)


@pytest.mark.parametrize("kind", ["ln_qkv_rope", "ln_qkv", "fc1_gelu", "proj",
                                  "fc2", "ln_mlp", "layernorm"])
def test_block_kernels_at_the_1000_view_shape(dev, kind):
    """K3 / K4 (the encoder's LN -> qkv -> RoPE into the packed buffer), K3
    (the decoder's q | k | v split, fc1 with GELU on the two-kernel road),
    K5 (proj at K = 1024, fc2 at K = 4096), K6 and K7 at M = 768,000, C =
    1024, hidden 4096: one bf16 step + 2e-2 (K7: 6e-2 on its values up
    to ~8, as test_layernorm_kernel_matches_plain)."""
    from fast3r_torch.kernels.rows import MANY_VIEW_TOKENS, check_rows
    from fast3r_torch.nn import fused_block as t_fb
    from fast3r_torch.ops.rope2d import expand_rope_tables, rope2d_cos_sin

    g = _gen(31)
    M, C, hidden = MANY_VIEW_TOKENS, 1024, 4096
    rows = check_rows(M, seed=31, device=dev)
    x = _bf_big((M, C), g, 2.0, 0.5)
    gamma, beta = _bf((C,), g, 0.1, 1.0), _bf((C,), g, 0.1)
    xr = x[rows]
    atol = 2e-2
    if kind in ("ln_qkv_rope", "ln_qkv"):
        w, b = _linear(3 * C, C, g)
        if kind == "ln_qkv":
            out = torch.stack(t_fb.ln_qkv(x, gamma, beta, w, b, 1e-5))
            ref = torch.stack(t_fb.ln_qkv_ref(xr, gamma, beta, w, b, 1e-5))
        else:
            yy, xx = torch.meshgrid(torch.arange(24), torch.arange(32),
                                    indexing="ij")
            pos = torch.stack([yy, xx], -1).reshape(1, -1, 2).repeat(
                M // 768, 1, 1).cuda()
            ct, st = expand_rope_tables(*rope2d_cos_sin(pos, 64), C,
                                        torch.bfloat16)
            out = t_fb.ln_qkv_rope(x, gamma, beta, w, b, ct, st, 16, 1e-6)
            ref = t_fb.ln_qkv_rope_ref(xr, gamma, beta, w, b, ct[rows],
                                       st[rows], 16, 1e-6)
        out = out[:, rows]
    elif kind == "fc1_gelu":
        w, b = _linear(hidden, C, g)
        out = t_fb.ln_matmul(x, gamma, beta, w, b, 1e-6, act="gelu")[rows]
        ref = t_fb.ln_matmul_ref(xr, gamma, beta, w, b, 1e-6, act="gelu")
    elif kind in ("proj", "fc2"):
        k_in = C if kind == "proj" else hidden
        w, b = _linear(C, k_in, g)
        h = _bf_big((M, k_in), g, 0.5)
        out = t_fb.matmul_residual(h, w, b, x)[rows]
        ref = t_fb.matmul_residual_ref(h[rows], w, b, xr)
    elif kind == "ln_mlp":
        w1, b1 = _linear(hidden, C, g)
        w2, b2 = _linear(C, hidden, g)
        out = t_fb.ln_mlp(x, gamma, beta, w1, b1, w2, b2, 1e-6)[rows]
        ref = t_fb.ln_mlp_ref(xr, gamma, beta, w1, b1, w2, b2, 1e-6)
    else:
        x.mul_(1.5)  # values to ~8, as the LayerNorm case
        out = t_ln.fused_layernorm(x, gamma, beta, 1e-5)[rows]
        ref = t_ln.layernorm_ref(x[rows], gamma, beta, 1e-5)
        atol = 6e-2
    torch.cuda.synchronize()
    _assert_bf16_close(out, ref, atol=atol)


def test_attention_kernel_at_the_1000_view_shape(dev):
    """K1 at S = 768,000 (the decoder's 16 heads of 64, bf16, its inference
    scale) on 256 query rows a head (the last 128 and 128 seeded) against
    the plain attention of those rows over all keys: o one bf16 step +
    FWD_BF16_TOL's, lse at FWD_BF16_TOL's.  q is scaled so that the scores
    spread (std ~3) and each row's output rests on a few hundred keys (|o|
    ~0.1): a key or value read from the wrong place moves it."""
    from fast3r_torch.kernels.rows import MANY_VIEW_TOKENS, query_rows

    g = _gen(32)
    S, H, D = MANY_VIEW_TOKENS, 16, 64
    scale = 0.125 * math.sqrt(math.log(137) / math.log(20))
    q = _bf_big((1, S, H, D), g, 3.0 / (D ** 0.5 * scale))
    k, v = _bf_big((1, S, H, D), g), _bf_big((1, S, H, D), g)
    rows = query_rows(S, H, seed=32, device=dev)
    o, lse = t_flash.attention_fwd_lse(q, k, v, scale)
    ref_o, ref_lse = t_flash.attention_rows_lse_ref(q, k, v, scale, rows)
    torch.cuda.synchronize()
    heads = torch.arange(H, device=dev)[:, None]
    got_o = o[0, rows, heads]          # (H, n, D)
    got_lse = lse[0, heads, rows]      # (H, n)
    _assert_bf16_close(got_o, ref_o[0], FWD_BF16_TOL[0])
    assert (got_lse - ref_lse[0]).abs().max().item() < FWD_BF16_TOL[1]
    assert ref_o[0].float().abs().amax(-1).mean().item() > 0.05


def test_ring_kernel_at_the_1000_view_shape(dev):
    """K14's forward over 4 ranks at S_loc = 192,000 (the 1000-view
    512x384 sequence of S = 768,000 tokens sharded, 16 heads of 64, bf16;
    the slots (2, 16, 192,000, 64) a rank) on 256 query rows a head of the
    gathered sequence against the plain attention of those rows over all
    keys: o one bf16 step + RING_CUDA_TOL's, lse at RING_CUDA_TOL's; scores
    spread as in the K1 case."""
    from fast3r_torch.kernels.rows import MANY_VIEW_TOKENS, query_rows
    from fast3r_torch.parallel import ring_rdma as t_ring

    g = _gen(34)
    n, S, H, D = 4, MANY_VIEW_TOKENS, 16, 64
    scale = 0.125 * math.sqrt(math.log(137) / math.log(20))
    q = _bf_big((1, S, H, D), g, 3.0 / (D ** 0.5 * scale))
    k, v = _bf_big((1, S, H, D), g), _bf_big((1, S, H, D), g)
    rows = query_rows(S, H, seed=34, device=dev)
    o, lse = t_ring._rdma_forward(
        *(t.view(n, 1, S // n, H, D) for t in (q, k, v)), scale, n)
    ref_o, ref_lse = t_flash.attention_rows_lse_ref(q, k, v, scale, rows)
    torch.cuda.synchronize()
    heads = torch.arange(H, device=dev)[:, None]
    got_o = o.view(1, S, H, D)[0, rows, heads]                  # (H, n, D)
    got_lse = lse.permute(1, 0, 2).reshape(H, S)[heads, rows]   # (H, n)
    o_tol, lse_tol = RING_CUDA_TOL[torch.bfloat16]
    _assert_bf16_close(got_o, ref_o[0], o_tol)
    assert (got_lse - ref_lse[0]).abs().max().item() < lse_tol
    assert ref_o[0].float().abs().amax(-1).mean().item() > 0.05


def test_packed_qkv_attention_kernel_at_the_1000_view_shape(dev):
    """K2 on the encoder's packed (3, 1000, 768, 1024) buffer (16,000
    (view, head) items; k and v start 0.79G and 1.57G elements in) on 16
    views (the first 4, the last 4, 8 seeded) against the plain attention,
    bf16 at 1e-2; scores spread as in the K1 case."""
    from fast3r_torch.kernels.rows import check_rows
    from fast3r_torch.ops import batched_attention as t_ba

    g = _gen(33)
    B, N, C, H = 1000, 768, 1024, 16
    qkv3 = _bf_big((3, B, N, C), g)
    qkv3[0].mul_(2.0)
    out = t_ba.packed_qkv_attention(qkv3, H, 0.125)
    views = check_rows(B, seed=33, edge=4, between=8, device=dev)
    q, k, v = (qkv3[i][views].view(-1, N, H, 64) for i in range(3))
    ref = t_flash.attention_ref(q, k, v, 0.125).reshape(-1, N, C)
    torch.cuda.synchronize()
    _assert_bf16_close(out[views], ref, 1e-2)
