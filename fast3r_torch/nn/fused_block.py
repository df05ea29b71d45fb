"""Fused ViT-block forward: LayerNorm, bias, GELU, RoPE and the residual
folded into the block's products.

Counterpart of ``fast3r_tpu/nn/fused_block.py`` (forward only; the backward
belongs to the training slice).  The products run the hand-written kernels
of ``csrc/fused_gemm.cu`` and ``csrc/ln_mlp.cu``, whose source notes say what
bounds them on the H100:

  ln_matmul        act(LN(x) W^T + b)                    (_ln_matmul_kernel)
  ln_qkv           q, k, v = split(LN(x) Wqkv^T + b)     (_ln_qkv_kernel)
  ln_qkv_rope      packed (3, M, C) with RoPE2D on q, k  (_ln_qkv_rope_kernel)
  matmul_residual  r + x W^T + b                         (_matmul_res_kernel)
  ln_mlp           x + GELU(LN(x) W1^T + b1) W2^T + b2   (_ln_mlp_kernel)

Weights are in the ``nn.Linear`` layout, (out, in).  Each function takes its
plain version (``*_ref``) on CPU tensors and launches its kernel on CUDA
tensors; the kernels take bfloat16 (the served type) and raise on anything
else.  Each keeps a ``launches`` count.

Rounding points, those of the TPU kernels (the plain versions compute the
products in fp32 from operands rounded where the kernels round them):
LN statistics and affine in fp32, LN output rounded to the activation dtype
before the product; fp32 accumulation and bias; q and k rounded before the
fp32 rotation with tables rounded to the activation dtype; the residual
added in fp32 and rounded once; the MLP's h rounded between fc1 and fc2.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fast3r_torch.kernels import build
from fast3r_torch.ops.attention import dot_product_attention
from fast3r_torch.ops.batched_attention import packed_qkv_attention
from fast3r_torch.ops.fused_layernorm import layernorm_ref
from fast3r_torch.ops.rope2d import apply_rope2d_bnhd, rotate_half_lanes

# The whole-MLP kernel (ln_mlp) on every block, as in the JAX package; False
# takes the two-kernel road, ln_matmul(GELU) then matmul_residual.
PREFER_FUSED_MLP = True

ROPE_HEAD_DIM = 64  # the RoPE epilogue's rotate-half groups are 32 lanes
LN_MAX_K = 1024     # the LN prologue holds a row's statistics pass in registers
MLP_WIDTH = 1024    # ln_mlp's fc2 accumulator layout: 8 warps x 128 columns
_EPILOGUE = {"bias": 0, "gelu": 1, "qkv": 2, "rope": 3, "residual": 4}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w^T in fp32 from the operands as given (already rounded)."""
    return a.float() @ w.float().t()


def _gelu(z: torch.Tensor) -> torch.Tensor:
    return F.gelu(z, approximate="none")


def ln_matmul_ref(x, gamma, beta, w, bias, eps: float, act=None):
    z = _mm(layernorm_ref(x, gamma, beta, eps), w) + bias.float()
    return (_gelu(z) if act == "gelu" else z).to(x.dtype)


def ln_qkv_ref(x, gamma, beta, w, bias, eps: float):
    y = ln_matmul_ref(x, gamma, beta, w, bias, eps)
    return tuple(y.reshape(x.shape[0], 3, -1).unbind(1))


def ln_qkv_rope_ref(x, gamma, beta, w, bias, ct, st, num_heads: int,
                    eps: float):
    y = _mm(layernorm_ref(x, gamma, beta, eps), w) + bias.float()
    c = y.shape[1] // 3
    half = c // num_heads // 2

    def rope(t):  # round first, then rotate in fp32
        t = t.to(x.dtype).float()
        return (t * ct.float() + rotate_half_lanes(t, half) * st.float()
                ).to(x.dtype)

    return torch.stack([rope(y[:, :c]), rope(y[:, c:2 * c]),
                        y[:, 2 * c:].to(x.dtype)])


def matmul_residual_ref(x, w, bias, residual):
    return (residual.float() + (_mm(x, w) + bias.float())).to(x.dtype)


def ln_mlp_ref(x, gamma, beta, w1, b1, w2, b2, eps: float):
    h = ln_matmul_ref(x, gamma, beta, w1, b1, eps, act="gelu")
    return (x.float() + (_mm(h, w2) + b2.float())).to(x.dtype)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _bf16_rows(name: str, t: torch.Tensor, shape, device) -> None:
    if (t.device != device or t.dtype != torch.bfloat16
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous()
            or t.data_ptr() % 16):
        raise ValueError(
            f"{name}: need a contiguous, 16-byte aligned bfloat16 {tuple(shape)} "
            f"tensor on {device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _f32_vec(name: str, t: torch.Tensor, n: int, device) -> torch.Tensor:
    if tuple(t.shape) != (n,) or t.device != device:
        raise ValueError(f"{name}: need a ({n},) tensor on {device}, got "
                         f"{tuple(t.shape)} on {t.device}")
    return t.detach().to(torch.float32).contiguous()


def _check_device(fn: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: no kernel for device {x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{fn}: the kernel takes bfloat16, got {x.dtype}")


def _gemm(fn: str, epilogue: str, x, w, bias, out_shape, ln=None,
          residual=None, tables=None) -> torch.Tensor:
    """Check what fused_gemm.cu takes and launch it; a new output."""
    _check_device(fn, x)
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"{fn}: x must be (M, K) and w (N, K)")
    (M, K), N = x.shape, w.shape[0]
    dev = x.device
    _bf16_rows(f"{fn} x", x, (M, K), dev)
    _bf16_rows(f"{fn} w", w, (N, K), dev)
    if K % 32 or N % 128:
        raise ValueError(f"{fn}: needs K % 32 == 0 and N % 128 == 0, got "
                         f"K={K}, N={N}")
    if epilogue in ("qkv", "rope") and (N % 3 or (N // 3) % 128):
        raise ValueError(f"{fn}: needs N = 3 C with C % 128 == 0, got N={N}")
    bias = _f32_vec(f"{fn} bias", bias, N, dev)
    gamma = beta = None
    eps = 0.0
    if ln is not None and (K % 256 or K > LN_MAX_K):
        raise ValueError(f"{fn}: the LN prologue takes K % 256 == 0 and "
                         f"K <= {LN_MAX_K}, got K={K}")
    if ln is not None:
        gamma, beta, eps = ln
        gamma = _f32_vec(f"{fn} gamma", gamma, K, dev)
        beta = _f32_vec(f"{fn} beta", beta, K, dev)
    if residual is not None:
        _bf16_rows(f"{fn} residual", residual, (M, N), dev)
    if tables is not None:
        for name, t in zip(("ct", "st"), tables):
            _bf16_rows(f"{fn} {name}", t, (M, N // 3), dev)
    out = torch.empty(out_shape, device=dev, dtype=x.dtype)
    if M == 0:
        return out
    ptr = (lambda t: 0 if t is None else t.data_ptr())
    ct, st = tables if tables is not None else (None, None)
    err = build.library().fast3r_fused_gemm(
        _EPILOGUE[epilogue], x.data_ptr(), ptr(gamma), ptr(beta), w.data_ptr(),
        bias.data_ptr(), ptr(residual), ptr(ct), ptr(st), out.data_ptr(),
        M, N, K, float(eps), build.stream_handle(dev))
    build.check(err, "fast3r_fused_gemm")
    return out


def ln_matmul(x, gamma, beta, w, bias, eps: float, act=None):
    """act(LN(x) @ w^T + bias); x (M, K), w (N, K); (M, N) in x.dtype.
    ``act`` is None or "gelu" (exact erf)."""
    if act not in (None, "gelu"):
        raise ValueError(f"ln_matmul: unknown act {act!r}")
    if x.device.type == "cpu":
        return ln_matmul_ref(x, gamma, beta, w, bias, eps, act)
    out = _gemm("ln_matmul", act or "bias", x, w, bias,
                (x.shape[0], w.shape[0]), ln=(gamma, beta, eps))
    ln_matmul.launches += 1
    return out


def ln_qkv(x, gamma, beta, w, bias, eps: float):
    """LN(x) @ wqkv^T + bias split into q, k, v, each (M, C); wqkv (3C, K).
    On CUDA the three are the slices of one (3, M, C) buffer."""
    if x.device.type == "cpu":
        return ln_qkv_ref(x, gamma, beta, w, bias, eps)
    out = _gemm("ln_qkv", "qkv", x, w, bias, (3, x.shape[0], w.shape[0] // 3),
                ln=(gamma, beta, eps))
    ln_qkv.launches += 1
    return tuple(out.unbind(0))


def ln_qkv_rope(x, gamma, beta, w, bias, ct, st, num_heads: int, eps: float):
    """LN(x) @ wqkv^T + bias with RoPE2D on q and k, as ONE packed (3, M, C)
    tensor; ct / st are the flat (M, C) lane tables of
    :func:`fast3r_torch.ops.rope2d.expand_rope_tables` in x.dtype.  The
    kernel takes head_dim 64."""
    if x.device.type == "cpu":
        return ln_qkv_rope_ref(x, gamma, beta, w, bias, ct, st, num_heads, eps)
    c = w.shape[0] // 3
    if c % num_heads or c // num_heads != ROPE_HEAD_DIM:
        raise ValueError(f"ln_qkv_rope: the kernel takes head_dim "
                         f"{ROPE_HEAD_DIM}, got C={c} over {num_heads} heads")
    out = _gemm("ln_qkv_rope", "rope", x, w, bias, (3, x.shape[0], c),
                ln=(gamma, beta, eps), tables=(ct, st))
    ln_qkv_rope.launches += 1
    return out


def matmul_residual(x, w, bias, residual):
    """residual + x @ w^T + bias, added in fp32 and rounded once; x (M, K),
    w (N, K), residual (M, N).  The output is a new tensor."""
    if x.device.type == "cpu":
        return matmul_residual_ref(x, w, bias, residual)
    out = _gemm("matmul_residual", "residual", x, w, bias,
                (x.shape[0], w.shape[0]), residual=residual)
    matmul_residual.launches += 1
    return out


def ln_mlp(x, gamma, beta, w1, b1, w2, b2, eps: float):
    """x + GELU(LN(x) @ w1^T + b1) @ w2^T + b2 in one kernel; x (M, C),
    w1 (hidden, C), w2 (C, hidden).  The kernel takes C == 1024 and
    hidden % 32 == 0."""
    if x.device.type == "cpu":
        return ln_mlp_ref(x, gamma, beta, w1, b1, w2, b2, eps)
    _check_device("ln_mlp", x)
    if x.dim() != 2 or x.shape[1] != MLP_WIDTH or w1.dim() != 2:
        raise ValueError(f"ln_mlp: the kernel takes x (M, {MLP_WIDTH}), got "
                         f"{tuple(x.shape)}")
    M, C = x.shape
    hidden = w1.shape[0]
    if hidden % 32 or hidden == 0:
        raise ValueError(f"ln_mlp: hidden={hidden} must be a multiple of 32")
    dev = x.device
    _bf16_rows("ln_mlp x", x, (M, C), dev)
    _bf16_rows("ln_mlp w1", w1, (hidden, C), dev)
    _bf16_rows("ln_mlp w2", w2, (C, hidden), dev)
    vecs = [_f32_vec(f"ln_mlp {n}", t, k, dev) for n, t, k in
            (("gamma", gamma, C), ("beta", beta, C), ("b1", b1, hidden),
             ("b2", b2, C))]
    out = torch.empty_like(x)
    if M == 0:
        return out
    g, b, bb1, bb2 = vecs
    err = build.library().fast3r_ln_mlp(
        x.data_ptr(), g.data_ptr(), b.data_ptr(), w1.data_ptr(),
        bb1.data_ptr(), w2.data_ptr(), bb2.data_ptr(), out.data_ptr(), M,
        hidden, float(eps), build.stream_handle(dev))
    build.check(err, "fast3r_ln_mlp")
    ln_mlp.launches += 1
    return out


for _fn in (ln_matmul, ln_qkv, ln_qkv_rope, matmul_residual, ln_mlp):
    _fn.launches = 0


# ---------------------------------------------------------------------------
# the fused pre-LN ViT block
# ---------------------------------------------------------------------------

def fused_vit_block(p, x: torch.Tensor, rope_cos_sin, num_heads: int,
                    scale: float, attn_impl: str, ln_eps: float) -> torch.Tensor:
    """Pre-LN ViT block (``p`` a ``nn.layers.Block``) on x (B, N, C) with the
    elementwise work inside the products (``_fused_block_impl`` of the JAX
    package).  With ``attn_impl == "batched"`` and a 4-tuple
    (cos, sin, ct, st) of RoPE tables, q, k and v come out of
    :func:`ln_qkv_rope` as one packed buffer that the attention reads in
    place; otherwise :func:`ln_qkv`, the (B, N, H, D) RoPE when given, and
    :func:`dot_product_attention`.  A shape or dtype a kernel cannot take
    raises on CUDA."""
    B, N, C = x.shape
    hd = C // num_heads
    dt = x.dtype
    x2 = x.reshape(B * N, C).contiguous()
    n1, attn, n2, m = p.norm1, p.attn, p.norm2, p.mlp

    if (attn_impl == "batched" and rope_cos_sin is not None
            and len(rope_cos_sin) == 4):
        ct, st = rope_cos_sin[2], rope_cos_sin[3]
        qkv3 = ln_qkv_rope(x2, n1.weight, n1.bias, attn.qkv.weight.to(dt),
                           attn.qkv.bias.to(dt), ct, st, num_heads, ln_eps)
        o = packed_qkv_attention(qkv3.reshape(3, B, N, C), num_heads, scale)
    else:
        q, k, v = (t.reshape(B, N, num_heads, hd) for t in ln_qkv(
            x2, n1.weight, n1.bias, attn.qkv.weight.to(dt),
            attn.qkv.bias.to(dt), ln_eps))
        if rope_cos_sin is not None:
            cos, sin = rope_cos_sin[0], rope_cos_sin[1]
            q = apply_rope2d_bnhd(q, cos, sin)
            k = apply_rope2d_bnhd(k, cos, sin)
        o = dot_product_attention(q, k, v, scale=scale, impl=attn_impl)

    x2 = matmul_residual(o.reshape(B * N, C).contiguous(), attn.proj.weight.to(dt),
                         attn.proj.bias.to(dt), x2)
    if PREFER_FUSED_MLP:
        x2 = ln_mlp(x2, n2.weight, n2.bias, m.fc1.weight.to(dt),
                    m.fc1.bias.to(dt), m.fc2.weight.to(dt), m.fc2.bias.to(dt),
                    ln_eps)
    else:
        h = ln_matmul(x2, n2.weight, n2.bias, m.fc1.weight.to(dt),
                      m.fc1.bias.to(dt), ln_eps, act="gelu")
        x2 = matmul_residual(h, m.fc2.weight.to(dt), m.fc2.bias.to(dt), x2)
    return x2.reshape(B, N, C)
