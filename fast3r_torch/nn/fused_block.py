"""Fused ViT and llama blocks: LayerNorm / RMSNorm, bias, GELU / SiLU, RoPE
and the residual folded into the blocks' products, forward and (for
training) backward.

Counterpart of ``fast3r_tpu/nn/fused_block.py``.  The products run the
hand-written kernels of ``csrc/fused_gemm.cu`` and ``csrc/ln_mlp.cu``, whose
source notes say what bounds them on the H100:

  ln_matmul        act(LN(x) W^T + b)                    (_ln_matmul_kernel)
  ln_qkv           q, k, v = split(LN(x) Wqkv^T + b)     (_ln_qkv_kernel)
  ln_qkv_rope      packed (3, M, C) with RoPE2D on q, k  (_ln_qkv_rope_kernel)
  matmul_residual  r + x W^T + b                         (_matmul_res_kernel)
  ln_mlp           x + GELU(LN(x) W1^T + b1) W2^T + b2   (_ln_mlp_kernel)
  ln_matmul_replay the LN products' forward that also writes the backward's
                   residuals u = LN(x), mean, rstd (and z before GELU)
                   (_ln_matmul_replay_kernel)
  rms_matmul       act(RMS(x) W^T), bias-free, act None or SiLU
                   (_rms_matmul_kernel)
  rms_qkv3         q, k, v = column views of RMS(x) [Wq | Wk | Wv]^T, k and
                   v narrower than q under GQA (_rms_qkv3_kernel)
  rms_matmul_replay the RMS products' forward that also writes u = RMS(x),
                   rstd (and z before SiLU) (_rms_matmul_replay_kernel)

Weights are in the ``nn.Linear`` layout, (out, in).  Each function takes its
plain version (``*_ref``) on CPU tensors and launches its kernel on CUDA
tensors; the kernels take bfloat16 (the served and trained type) and raise
on anything else.  Each keeps a ``launches`` count.

Training, as the JAX package's custom VJPs: under autograd the LN products
run the replay and their backward (:func:`_ln_backward`, after
``_ln_backward_xla``) is plain products and elementwise code; the RoPE
backward is RoPE with the sine negated; ``matmul_residual``'s backward is
plain products; ``ln_mlp``'s replays the two-kernel road.
:func:`fused_vit_block` saves only (x, params) and recomputes in its
backward, without rerunning the MLP's forward product.  The RMS products
run their replay under autograd too, and their backward (:func:`_rms_backward`,
after ``_rms_backward_xla``) is plain products and elementwise code (the
SwiGLU pair, :func:`rms_swiglu`, adds its two products' du before one RMS
backward);
:func:`fused_llama_block` saves (x, params) and recomputes the whole block
in its backward (``_fused_llama_bwd``).  The backward's products are cuBLAS
matmuls (the JAX package leaves them to XLA): in bf16 they round du and dh
to bf16 where the JAX package keeps fp32.

Rounding points, those of the TPU kernels (the plain versions compute the
products in fp32 from operands rounded where the kernels round them):
LN statistics and affine in fp32, LN output rounded to the activation dtype
before the product; RMS statistics in fp32, x * rstd rounded to the
activation dtype, then times gamma and rounded again (``_rms_f32``: gamma
rounded to the activation dtype in the forward, as given in the replay);
fp32 accumulation and bias; SiLU on the fp32 accumulator with an exact
division; q and k rounded before the fp32 rotation with tables rounded to
the activation dtype; the residual added in fp32 and rounded once; the
MLP's h rounded between fc1 and fc2.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from fast3r_torch.kernels import build
from fast3r_torch.ops.attention import dot_product_attention
from fast3r_torch.ops.batched_attention import packed_qkv_attention
from fast3r_torch.ops.rope2d import apply_rope2d_bnhd, rotate_half_lanes

# The whole-MLP kernel (ln_mlp) on every block, as in the JAX package; False
# takes the two-kernel road, ln_matmul(GELU) then matmul_residual.
PREFER_FUSED_MLP = True

ROPE_HEAD_DIM = 64  # the RoPE epilogue's rotate-half groups are 32 lanes
# the norm prologues hold a row's K values in registers for its statistics
# (a warp's lane holds K / 32) and gamma / beta in shared memory: K % 256
# == 0 and K <= 1024, and for the LN products with bias, GELU or the q|k|v
# split (the decoders' blocks) K <= 1280 in wide instantiations
# (model_scaling_huge's 1280; base's 768 is a narrow one)
LN_MAX_K = 1280
NARROW_MAX_K = 1024  # RMS (llama) and the RoPE epilogue (the encoder)
# ln_mlp: one instantiation per model width (its fc1 tiles take the LN
# prologue over K = the width, its fc2 tiles cover the width in 256-column
# tiles)
MLP_WIDTHS = (768, 1024, 1280)
# h ring: 16 band slots of 128 x hidden bf16 in device memory at every
# width (20 MB at hidden 5120, inside the 50 MB L2; a 120-slot ring past
# the L2 ran as fast at the flagship's width, csrc/ln_mlp.cu)
MLP_RING_SLOTS = 16
# fused_gemm.cu's modes; with the RMS prologue "bias" is the bias-free product
_PROLOGUE = {None: 0, "ln": 1, "rms": 2}
_EPILOGUE = {"bias": 0, "gelu": 1, "qkv": 2, "rope": 3, "residual": 4,
             "silu": 5}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w^T in fp32 from the operands as given (already rounded)."""
    return a.float() @ w.float().t()


def _gelu(z: torch.Tensor) -> torch.Tensor:
    return F.gelu(z, approximate="none")


def _gelu_grad(z: torch.Tensor) -> torch.Tensor:
    """d/dz [z Phi(z)] = Phi(z) + z phi(z), fp32."""
    cdf = 0.5 * (1.0 + torch.erf(z * 0.7071067811865476))
    return cdf + z * torch.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)


def _rope_flat(t: torch.Tensor, ct, st, half: int) -> torch.Tensor:
    """t * ct + rotate_half_lanes(t) * st in fp32 on flat (M, C) lanes."""
    t = t.float()
    return t * ct.float() + rotate_half_lanes(t, half) * st.float()


def _replay_ref(mode: str, x, gamma, beta, w, bias, eps: float, tables=None,
                num_heads: int = 0):
    """(out, u, mean, rstd, z): the plain LN product of ``mode`` ("bias",
    "gelu", "qkv" or "rope", as the kernel's epilogues) with the backward's
    residuals, u = LN(x) in x's dtype, fp32 (M,) mean and rstd, and for
    "gelu" the pre-activation z in x's dtype (else None)."""
    dt = x.dtype
    xf = x.float()
    mean = xf.mean(-1)
    xc = xf - mean[:, None]
    rstd = torch.rsqrt((xc * xc).mean(-1) + eps)
    u = (xc * rstd[:, None] * gamma.float() + beta.float()).to(dt)
    y = _mm(u, w) + bias.float()
    z = None
    if mode == "gelu":
        z = y.to(dt)
        out = _gelu(y).to(dt)
    elif mode == "qkv":
        out = y.to(dt).reshape(x.shape[0], 3, -1).transpose(0, 1)
    elif mode == "rope":
        c = y.shape[1] // 3
        half = c // num_heads // 2
        ct, st = tables
        out = torch.stack([
            _rope_flat(y[:, :c].to(dt), ct, st, half).to(dt),  # round, rotate
            _rope_flat(y[:, c:2 * c].to(dt), ct, st, half).to(dt),
            y[:, 2 * c:].to(dt)])
    else:
        out = y.to(dt)
    return out, u, mean, rstd, z


def ln_matmul_ref(x, gamma, beta, w, bias, eps: float, act=None):
    return _replay_ref("gelu" if act == "gelu" else "bias", x, gamma, beta, w,
                       bias, eps)[0]


def ln_qkv_ref(x, gamma, beta, w, bias, eps: float):
    return tuple(_replay_ref("qkv", x, gamma, beta, w, bias, eps)[0].unbind(0))


def ln_qkv_rope_ref(x, gamma, beta, w, bias, ct, st, num_heads: int,
                    eps: float):
    return _replay_ref("rope", x, gamma, beta, w, bias, eps, (ct, st),
                       num_heads)[0]


def ln_matmul_replay_ref(x, gamma, beta, w, bias, eps: float, act=None):
    """(y, u, mean, rstd, z) of :func:`ln_matmul_replay`, plain."""
    return _replay_ref("gelu" if act == "gelu" else "bias", x, gamma, beta, w,
                       bias, eps)


def matmul_residual_ref(x, w, bias, residual):
    """residual + x w^T + bias; without a residual (None) x w^T + bias."""
    y = _mm(x, w) + bias.float()
    return (y if residual is None else residual.float() + y).to(x.dtype)


def ln_mlp_ref(x, gamma, beta, w1, b1, w2, b2, eps: float,
               residual: bool = True):
    h = ln_matmul_ref(x, gamma, beta, w1, b1, eps, act="gelu")
    y = _mm(h, w2) + b2.float()
    return (x.float() + y if residual else y).to(x.dtype)


def _silu(z: torch.Tensor) -> torch.Tensor:
    """z * sigmoid(z) with an exact division, fp32."""
    return z * (1.0 / (1.0 + torch.exp(-z)))


def rms_matmul_replay_ref(x, gamma, w, eps: float, act=None):
    """(y, u, rstd, z) of :func:`rms_matmul_replay`, plain, at the rounding
    points of ``_rms_matmul_replay_kernel``: fp32 rstd (M,); x * rstd
    rounded to x's dtype, times gamma in fp32 and rounded again (u); the
    product in fp32; with ``act == "silu"`` z = the rounded pre-activation
    and y = SiLU of the fp32 one, rounded (else z is None)."""
    dt = x.dtype
    xf = x.float()
    rstd = torch.rsqrt((xf * xf).mean(-1) + eps)
    u = ((xf * rstd[:, None]).to(dt).float() * gamma.float()).to(dt)
    y = _mm(u, w)
    if act == "silu":
        return _silu(y).to(dt), u, rstd, y.to(dt)
    return y.to(dt), u, rstd, None


def rms_matmul_ref(x, gamma, w, eps: float, act=None):
    """act(RMSNorm(x) @ w^T) as ``_rms_matmul_kernel`` computes it: gamma
    rounded to x's dtype before the multiply (``_rms_f32``)."""
    return rms_matmul_replay_ref(x, gamma.to(x.dtype), w, eps, act)[0]


def rms_qkv3_ref(x, gamma, wq, wk, wv, eps: float):
    """(q, k, v): column views of one RMSNorm(x) @ [wq | wk | wv]^T."""
    y = rms_matmul_ref(x, gamma, torch.cat([wq, wk, wv]), eps)
    return tuple(y.split([wq.shape[0], wk.shape[0], wv.shape[0]], dim=1))


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


def _out_shape(epilogue: str, M: int, N: int):
    return (3, M, N // 3) if epilogue in ("qkv", "rope") else (M, N)


def _gemm(fn: str, epilogue: str, x, w, bias, ln=None, rms=None,
          residual=None, tables=None, replay: bool = False):
    """Check what fused_gemm.cu takes and launch it: the LN prologue with
    ``ln = (gamma, beta, eps)``, the RMS prologue (bias-free: ``bias`` is
    None) with ``rms = (gamma, eps)``.  A new output, or with ``replay``
    (norm prologues) the tuple (out, u, mean, rstd, z); mean is None with
    RMS, z None but for GELU and SiLU."""
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
    pro = "ln" if ln is not None else "rms" if rms is not None else None
    max_k = (LN_MAX_K if pro == "ln" and epilogue != "rope"
             else NARROW_MAX_K)
    if pro is not None and (K % 256 or K > max_k):
        raise ValueError(f"{fn}: the {pro.upper()} prologue takes "
                         f"K % 256 == 0 and K <= {max_k}, got K={K}")
    gamma = beta = None
    eps = 0.0
    if pro == "ln":
        gamma, beta, eps = ln
        beta = _f32_vec(f"{fn} beta", beta, K, dev)
    elif pro == "rms":
        gamma, eps = rms
    if gamma is not None:
        gamma = _f32_vec(f"{fn} gamma", gamma, K, dev)
    if pro != "rms":
        bias = _f32_vec(f"{fn} bias", bias, N, dev)
    if residual is not None:
        _bf16_rows(f"{fn} residual", residual, (M, N), dev)
    if tables is not None:
        for name, t in zip(("ct", "st"), tables):
            _bf16_rows(f"{fn} {name}", t, (M, N // 3), dev)
    out = torch.empty(_out_shape(epilogue, M, N), device=dev, dtype=x.dtype)
    u = mean = rstd = z = None
    if replay:
        u = torch.empty_like(x)
        rstd = torch.empty((M,), device=dev, dtype=torch.float32)
        if pro == "ln":
            mean = torch.empty_like(rstd)
        if epilogue in ("gelu", "silu"):
            z = torch.empty((M, N), device=dev, dtype=x.dtype)
    if M:
        ptr = (lambda t: 0 if t is None else t.data_ptr())
        ct, st = tables if tables is not None else (None, None)
        err = build.library().fast3r_fused_gemm(
            _PROLOGUE[pro], _EPILOGUE[epilogue], x.data_ptr(), ptr(gamma),
            ptr(beta), w.data_ptr(), ptr(bias), ptr(residual), ptr(ct),
            ptr(st), out.data_ptr(), ptr(u), ptr(mean), ptr(rstd), ptr(z), M,
            N, K, float(eps), build.stream_handle(dev))
        build.check(err, "fast3r_fused_gemm")
    return (out, u, mean, rstd, z) if replay else out


def _check_rope_heads(fn: str, w, num_heads: int) -> None:
    c = w.shape[0] // 3
    if c % num_heads or c // num_heads != ROPE_HEAD_DIM:
        raise ValueError(f"{fn}: the kernel takes head_dim "
                         f"{ROPE_HEAD_DIM}, got C={c} over {num_heads} heads")


def _replay(mode: str, x, gamma, beta, w, bias, eps: float, tables=None,
            num_heads: int = 0):
    """The LN product of ``mode`` with the backward's residuals (see
    :func:`_replay_ref`): the plain version on the CPU, the replay launch of
    fused_gemm.cu on CUDA."""
    if x.device.type == "cpu":
        return _replay_ref(mode, x, gamma, beta, w, bias, eps, tables,
                           num_heads)
    if mode == "rope":
        _check_rope_heads("ln_matmul_replay", w, num_heads)
    res = _gemm("ln_matmul_replay", mode, x, w, bias, ln=(gamma, beta, eps),
                tables=tables, replay=True)
    if x.shape[0]:
        ln_matmul_replay.launches += 1
    return res


def ln_matmul_replay(x, gamma, beta, w, bias, eps: float, act=None):
    """(y, u, mean, rstd, z) for the training backward
    (``_ln_matmul_replay``): y = act(LN(x) @ w^T + bias) as
    :func:`ln_matmul`, u = LN(x) in x's dtype, the rows' fp32 mean and rstd
    (M,), and with ``act == "gelu"`` the pre-activation z in x's dtype
    (else None).  One launch; the qkv and RoPE products' replays go through
    the same launch (and count)."""
    return _replay("gelu" if act == "gelu" else "bias", x, gamma, beta, w,
                   bias, eps)


def _ln_backward(x, gamma, w, u, mean, rstd, dz, tp=None):
    """(dx, dgamma, dbeta, dw, dbias) of y = LN(x) w^T + bias from the
    replay's residuals and the cotangent dz of the pre-activation
    (``_ln_backward_xla``): du, dw and dx from plain products, the LN
    backward in fp32; dx and dw in the primal dtypes, the vectors fp32.
    With a tensor-parallel mesh ``tp`` (w a column slice) du is summed over
    the model group first (the sublayer's one backward collective), so dx,
    dgamma and dbeta are the whole's on every rank."""
    dzc = dz.to(x.dtype)
    du = (dzc @ w).float()
    if tp is not None:
        tp.all_reduce_model(du)
    dw = dzc.t() @ u
    xhat = (x.float() - mean[:, None]) * rstd[:, None]
    dxhat = du * gamma.float()
    dx = rstd[:, None] * (dxhat - dxhat.mean(-1, keepdim=True)
                          - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    return (dx.to(x.dtype), (du * xhat).sum(0), du.sum(0), dw.to(w.dtype),
            dz.float().sum(0))


class _LnProduct(torch.autograd.Function):
    """ln_matmul / ln_qkv / ln_qkv_rope under autograd: the replay forward,
    saved residuals (x, gamma, w, u, mean, rstd[, z][, tables])."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w, bias, ct, st, eps, mode, num_heads,
                tp):
        tables = (ct, st) if mode == "rope" else None
        out, u, mean, rstd, z = _replay(mode, x, gamma, beta, w, bias, eps,
                                        tables, num_heads)
        ctx.save_for_backward(x, gamma, w, u, mean, rstd, z, ct, st)
        ctx.mode, ctx.num_heads, ctx.tp = mode, num_heads, tp
        ctx.vec_dtypes = (gamma.dtype, beta.dtype, bias.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        x, gamma, w, u, mean, rstd, z, ct, st = ctx.saved_tensors
        if ctx.mode == "gelu":
            dz = g.float() * _gelu_grad(z.float())
        elif ctx.mode == "qkv":
            dz = g.transpose(0, 1).reshape(x.shape[0], -1)
        elif ctx.mode == "rope":
            # P^T = -P and the tables commute with P: RoPE with -sin
            half = g.shape[2] // ctx.num_heads // 2
            dz = torch.cat([_rope_flat(g[0], ct, -st, half),
                            _rope_flat(g[1], ct, -st, half), g[2].float()], 1)
        else:
            dz = g
        dx, dgamma, dbeta, dw, dbias = _ln_backward(x, gamma, w, u, mean,
                                                    rstd, dz, ctx.tp)
        gd, bd, biasd = ctx.vec_dtypes
        return (dx, dgamma.to(gd), dbeta.to(bd), dw, dbias.to(biasd), None,
                None, None, None, None, None)


def _training(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def ln_matmul(x, gamma, beta, w, bias, eps: float, act=None, tp=None):
    """act(LN(x) @ w^T + bias); x (M, K), w (N, K); (M, N) in x.dtype.
    ``act`` is None or "gelu" (exact erf).  Differentiable (the replay).
    ``tp``: a tensor-parallel mesh when w is a column slice (the gradient
    into x summed over its model group)."""
    if act not in (None, "gelu"):
        raise ValueError(f"ln_matmul: unknown act {act!r}")
    mode = act or "bias"
    if _training(x, gamma, beta, w, bias):
        return _LnProduct.apply(x, gamma, beta, w, bias, None, None, eps, mode,
                                0, tp)
    if x.device.type == "cpu":
        return ln_matmul_ref(x, gamma, beta, w, bias, eps, act)
    out = _gemm("ln_matmul", mode, x, w, bias, ln=(gamma, beta, eps))
    ln_matmul.launches += 1
    return out


def ln_qkv(x, gamma, beta, w, bias, eps: float, tp=None):
    """LN(x) @ wqkv^T + bias split into q, k, v, each (M, C); wqkv (3C, K).
    On CUDA the three are the slices of one (3, M, C) buffer.
    Differentiable (the replay); ``tp`` as :func:`ln_matmul`'s."""
    if _training(x, gamma, beta, w, bias):
        return tuple(_LnProduct.apply(x, gamma, beta, w, bias, None, None,
                                      eps, "qkv", 0, tp).unbind(0))
    if x.device.type == "cpu":
        return ln_qkv_ref(x, gamma, beta, w, bias, eps)
    out = _gemm("ln_qkv", "qkv", x, w, bias, ln=(gamma, beta, eps))
    ln_qkv.launches += 1
    return tuple(out.unbind(0))


def ln_qkv_rope(x, gamma, beta, w, bias, ct, st, num_heads: int, eps: float,
                tp=None):
    """LN(x) @ wqkv^T + bias with RoPE2D on q and k, as ONE packed (3, M, C)
    tensor; ct / st are the flat (M, C) lane tables of
    :func:`fast3r_torch.ops.rope2d.expand_rope_tables` in x.dtype.  The
    kernel takes head_dim 64.  Differentiable (the replay); ``tp`` as
    :func:`ln_matmul`'s."""
    if _training(x, gamma, beta, w, bias):
        return _LnProduct.apply(x, gamma, beta, w, bias, ct, st, eps, "rope",
                                num_heads, tp)
    if x.device.type == "cpu":
        return ln_qkv_rope_ref(x, gamma, beta, w, bias, ct, st, num_heads, eps)
    _check_rope_heads("ln_qkv_rope", w, num_heads)
    out = _gemm("ln_qkv_rope", "rope", x, w, bias, ln=(gamma, beta, eps),
                tables=(ct, st))
    ln_qkv_rope.launches += 1
    return out


def _matmul_residual(x, w, bias, residual, tp=None):
    """The product on one rank; with a tensor-parallel mesh ``tp`` every
    rank's kernel takes the bias epilogue (the bias on model rank 0, a zero
    bias on the others), the partial outputs are summed over the model
    group and the residual is added to the sum (in fp32, rounded once, as
    the one-process kernel's epilogue rounds it).  A residual inside rank
    0's epilogue would round the residual stream twice more a sublayer: on
    an H100 80GB HBM3 at 700 W that put a model-2 llama_dec step's loss
    2.8e-4 from the one-process step's, against 4.8e-5 this way
    (``scripts/tp_residual_rounding.py``)."""
    if tp is not None:
        if tp.model_rank != 0:
            bias = torch.zeros_like(bias)
        out = tp.all_reduce_model(_matmul_residual(x, w, bias, None))
        return out if residual is None else out.add_(residual)
    if x.device.type == "cpu":
        return matmul_residual_ref(x, w, bias, residual)
    out = _gemm("matmul_residual", "bias" if residual is None
                else "residual", x, w, bias, residual=residual)
    matmul_residual.launches += 1
    return out


class _MatmulResidual(torch.autograd.Function):
    """Backward of r + x w^T + b: plain products (``_matmul_res_p_bwd``).
    Under tensor parallelism g is the whole output's on every rank, so the
    residual's and the bias's gradients are whole there too."""

    @staticmethod
    def forward(ctx, x, w, bias, residual, tp):
        ctx.save_for_backward(x, w)
        ctx.bias_dtype = bias.dtype
        return _matmul_residual(x, w, bias, residual, tp)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return (g @ w, g.t() @ x, g.float().sum(0).to(ctx.bias_dtype), g,
                None)


def matmul_residual(x, w, bias, residual, tp=None):
    """residual + x @ w^T + bias, added in fp32 and rounded once; x (M, K),
    w (N, K), residual (M, N).  The output is a new tensor.
    Differentiable.  ``tp``: a tensor-parallel mesh when w is a row slice
    (x its input columns): the partial products (the bias on model rank 0)
    are summed over the model group, then the residual added."""
    if _training(x, w, bias, residual):
        return _MatmulResidual.apply(x, w, bias, residual, tp)
    return _matmul_residual(x, w, bias, residual, tp)


def _ln_mlp(x, gamma, beta, w1, b1, w2, b2, eps: float, ctas=None,
            slots=MLP_RING_SLOTS, prof=None, residual: bool = True):
    """The whole-MLP kernel: ``ctas`` persistent CTAs (default: one per SM)
    and a ring of ``slots`` band slots of h (128 x hidden bf16 each, at most
    one per row band); ``prof``, a zeroed (6,) int64 CUDA tensor, receives
    the kernel's clock64 tallies (fc1 items, fc2 items, waits for a free
    slot, for the next item, for fc1 bands, statistics items).  Without
    ``residual`` the fc2 epilogue adds no x (a tensor-parallel rank's
    partial output)."""
    if x.device.type == "cpu":
        return ln_mlp_ref(x, gamma, beta, w1, b1, w2, b2, eps, residual)
    _check_device("ln_mlp", x)
    if x.dim() != 2 or x.shape[1] not in MLP_WIDTHS or w1.dim() != 2:
        raise ValueError(f"ln_mlp: the kernel takes x (M, C) with C in "
                         f"{MLP_WIDTHS}, got {tuple(x.shape)}")
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
    bands = -(-M // 128)
    slots = min(slots, bands)
    if slots < 2 and bands > 1:
        raise ValueError(f"ln_mlp: the h ring needs 2 slots or more, got "
                         f"{slots}")
    if ctas is None:
        ctas = torch.cuda.get_device_properties(dev).multi_processor_count
    ring = torch.empty((slots * 128, hidden), device=dev, dtype=x.dtype)
    stats = torch.empty((2, bands * 128), device=dev, dtype=torch.float32)
    counters = torch.zeros((1 + 3 * bands,), device=dev, dtype=torch.int32)
    if prof is not None and (prof.shape != (6,) or prof.dtype != torch.int64
                             or prof.device != dev):
        raise ValueError("ln_mlp: prof must be a (6,) int64 tensor on "
                         f"{dev}")
    g, b, bb1, bb2 = vecs
    err = build.library().fast3r_ln_mlp(
        x.data_ptr(), g.data_ptr(), b.data_ptr(), w1.data_ptr(),
        bb1.data_ptr(), w2.data_ptr(), bb2.data_ptr(), out.data_ptr(),
        ring.data_ptr(), stats.data_ptr(), counters.data_ptr(),
        0 if prof is None else prof.data_ptr(), M, C, hidden, slots, int(ctas),
        int(residual), float(eps), build.stream_handle(dev))
    build.check(err, "fast3r_ln_mlp")
    ln_mlp.launches += 1
    return out


def _mlp_backward(x, gamma, beta, w1, b1, w2, b2, eps: float, g, tp=None):
    """Gradients of x + GELU(LN(x) w1^T + b1) w2^T + b2 for the cotangent g,
    through the two-kernel road (``_ln_mlp_p_bwd``): the fc1 replay gives h
    and z, fc2's backward is plain products, fc1's is :func:`_ln_backward`
    (with ``tp``, its du summed over the model group).
    Returns (dx, dgamma, dbeta, dw1, db1, dw2, db2); fc2's forward product
    is not run."""
    h, u, mean, rstd, z = _replay("gelu", x, gamma, beta, w1, b1, eps)
    g = g.to(x.dtype)
    dh = g @ w2
    dw2, db2 = g.t() @ h, g.float().sum(0)
    dz = dh.float() * _gelu_grad(z.float())
    dx, dgamma, dbeta, dw1, db1 = _ln_backward(x, gamma, w1, u, mean, rstd, dz,
                                               tp)
    return dx + g, dgamma, dbeta, dw1, db1, dw2.to(w2.dtype), db2


def _ln_mlp_tp(x, gamma, beta, w1, b1, w2, b2, eps: float, tp=None):
    """The MLP on one rank; with a tensor-parallel mesh (w1 a column slice,
    w2 a row slice) every rank's kernel adds no x and b2 enters on model
    rank 0 only; the partial outputs are summed over the model group and x
    added to the sum, rounded once (see :func:`_matmul_residual`)."""
    if tp is None:
        return _ln_mlp(x, gamma, beta, w1, b1, w2, b2, eps)
    first = tp.model_rank == 0
    out = _ln_mlp(x, gamma, beta, w1, b1, w2,
                  b2 if first else torch.zeros_like(b2), eps, residual=False)
    return tp.all_reduce_model(out).add_(x)


class _LnMlp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, w1, b1, w2, b2, eps, tp):
        ctx.save_for_backward(x, gamma, beta, w1, b1, w2, b2)
        ctx.eps, ctx.tp = eps, tp
        return _ln_mlp_tp(x, gamma, beta, w1, b1, w2, b2, eps, tp)

    @staticmethod
    def backward(ctx, g):
        ts = ctx.saved_tensors
        grads = _mlp_backward(*ts, ctx.eps, g, ctx.tp)
        return (*(d.to(t.dtype) for d, t in zip(grads, ts)), None, None)


def ln_mlp(x, gamma, beta, w1, b1, w2, b2, eps: float, tp=None):
    """x + GELU(LN(x) @ w1^T + b1) @ w2^T + b2 in one kernel; x (M, C),
    w1 (hidden, C), w2 (C, hidden).  The kernel takes C in 768, 1024 and
    1280 (the models' widths) and hidden % 32 == 0.  Differentiable (the
    two-kernel road's replay).  ``tp``: a tensor-parallel mesh when w1 and
    w2 are this rank's hidden slice."""
    if _training(x, gamma, beta, w1, b1, w2, b2):
        return _LnMlp.apply(x, gamma, beta, w1, b1, w2, b2, eps, tp)
    return _ln_mlp_tp(x, gamma, beta, w1, b1, w2, b2, eps, tp)


# ---------------------------------------------------------------------------
# the RMS products (llama blocks: bias-free linears)
# ---------------------------------------------------------------------------

def _rms_act(fn: str, act) -> str:
    if act not in (None, "silu"):
        raise ValueError(f"{fn}: unknown act {act!r}")
    return act or "bias"


def rms_matmul_replay(x, gamma, w, eps: float, act=None):
    """(y, u, rstd, z) for the training backward (``_rms_matmul_replay``):
    y = act(RMSNorm(x) @ w^T) with gamma multiplied as given (fp32 when the
    caller's gamma is), u = RMSNorm(x) in x's dtype, the rows' fp32 rstd
    (M,), and with ``act == "silu"`` the pre-activation z in x's dtype
    (else None).  The plain version on the CPU, one replay launch of
    fused_gemm.cu on CUDA."""
    mode = _rms_act("rms_matmul_replay", act)
    if x.device.type == "cpu":
        return rms_matmul_replay_ref(x, gamma, w, eps, act)
    out, u, _, rstd, z = _gemm("rms_matmul_replay", mode, x, w, None,
                               rms=(gamma, eps), replay=True)
    if x.shape[0]:
        rms_matmul_replay.launches += 1
    return out, u, rstd, z


def _rms_dz(g, z, act, dtype):
    """The pre-activation's cotangent in ``dtype``: g times SiLU's
    derivative at z in fp32 with ``act == "silu"``, else g."""
    dz = g.float()
    if act == "silu":
        zf = z.float()
        sig = torch.sigmoid(zf)
        dz = dz * sig * (1.0 + zf * (1.0 - sig))
    return dz.to(dtype)


def _rms_norm_backward(x, gamma, rstd, du, tp=None):
    """(dx, dgamma) of u = RMSNorm(x) from the fp32 cotangent du of u: the
    RMS backward in fp32, dx in x's dtype.  With a tensor-parallel mesh
    ``tp`` (u feeds column slices) du is summed over the model group first,
    the sublayer's one backward collective."""
    if tp is not None:
        tp.all_reduce_model(du)
    xhat = (x.float() * rstd[:, None]).to(x.dtype).float()
    dxhat = du * gamma.float()
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    dx = rstd[:, None] * (dxhat - xhat * m2)
    return dx.to(x.dtype), (du * xhat).sum(0)


def _rms_backward(x, gamma, w, u, rstd, z, g, act, tp=None):
    """(dx, dgamma, dw) of y = act(RMSNorm(x) w^T) from the replay's
    residuals (``_rms_backward_xla``): the SiLU derivative and the RMS
    backward in fp32, du and dw from plain products; dx and dw in the
    primal dtypes, dgamma fp32.  ``tp`` as :func:`_rms_norm_backward`'s."""
    dzc = _rms_dz(g, z, act, x.dtype)
    dw = dzc.t() @ u
    dx, dgamma = _rms_norm_backward(x, gamma, rstd, (dzc @ w).float(), tp)
    return dx, dgamma, dw.to(w.dtype)


class _RmsProduct(torch.autograd.Function):
    """rms_matmul (and rms_qkv3's product over the concatenated weights)
    under autograd: the replay forward, saved residuals (x, gamma, w, u,
    rstd[, z])."""

    @staticmethod
    def forward(ctx, x, gamma, w, eps, act, tp):
        y, u, rstd, z = rms_matmul_replay(x, gamma, w, eps, act)
        ctx.save_for_backward(x, gamma, w, u, rstd, z)
        ctx.act, ctx.tp = act, tp
        return y

    @staticmethod
    def backward(ctx, g):
        x, gamma, w, u, rstd, z = ctx.saved_tensors
        dx, dgamma, dw = _rms_backward(x, gamma, w, u, rstd, z, g, ctx.act,
                                       ctx.tp)
        return dx, dgamma.to(gamma.dtype), dw, None, None, None


def rms_matmul(x, gamma, w, eps: float, act=None):
    """act(RMSNorm(x) @ w^T), no bias; x (M, K), w (N, K); (M, N) in
    x.dtype.  ``act`` is None or "silu" (exact division).  Differentiable
    (the replay)."""
    mode = _rms_act("rms_matmul", act)
    if _training(x, gamma, w):
        return _RmsProduct.apply(x, gamma, w, eps, act, None)
    if x.device.type == "cpu":
        return rms_matmul_ref(x, gamma, w, eps, act)
    out = _gemm("rms_matmul", mode, x, w, None, rms=(gamma.to(x.dtype), eps))
    rms_matmul.launches += 1
    return out


def rms_qkv3(x, gamma, wq, wk, wv, eps: float, tp=None):
    """RMSNorm(x) projected through three bias-free weights (llama GQA
    attention: wk and wv may be narrower than wq): (q, k, v), column views
    of one (M, Nq + Nk + Nv) product over the concatenated weights, on
    CUDA one launch with the plain (M, N) store.  Differentiable: the
    replay over the concatenated weights, whose gradient autograd splits
    (``_rms_qkv3_p_fwd`` / ``_bwd``).  ``tp``: a tensor-parallel mesh when
    the weights are this rank's heads (the gradient into x and gamma
    summed over its model group)."""
    splits = [wq.shape[0], wk.shape[0], wv.shape[0]]
    wcat = torch.cat([wq, wk, wv])
    if _training(x, gamma, wq, wk, wv):
        y = _RmsProduct.apply(x, gamma, wcat, eps, None, tp)
    elif x.device.type == "cpu":
        return rms_qkv3_ref(x, gamma, wq, wk, wv, eps)
    else:
        y = _gemm("rms_qkv3", "bias", x, wcat, None,
                  rms=(gamma.to(x.dtype), eps))
        rms_qkv3.launches += 1
    return tuple(y.split(splits, dim=1))


class _RmsSwiGlu(torch.autograd.Function):
    """rms_swiglu under autograd: the two replays (SiLU over w1, plain over
    w3; both write the same u and rstd, the first's are kept); the
    backward adds the two products' du before one RMS backward (and, under
    tensor parallelism, one all-reduce)."""

    @staticmethod
    def forward(ctx, x, gamma, w1, w3, eps, tp):
        h1, u, rstd, z = rms_matmul_replay(x, gamma, w1, eps, "silu")
        h3 = rms_matmul_replay(x, gamma, w3, eps)[0]
        ctx.save_for_backward(x, gamma, w1, w3, u, rstd, z)
        ctx.tp = tp
        return h1, h3

    @staticmethod
    def backward(ctx, g1, g3):
        x, gamma, w1, w3, u, rstd, z = ctx.saved_tensors
        dz1 = _rms_dz(g1, z, "silu", x.dtype)
        dz3 = _rms_dz(g3, None, None, x.dtype)
        du = (dz1 @ w1).float() + (dz3 @ w3).float()
        dx, dgamma = _rms_norm_backward(x, gamma, rstd, du, ctx.tp)
        return (dx, dgamma.to(gamma.dtype), (dz1.t() @ u).to(w1.dtype),
                (dz3.t() @ u).to(w3.dtype), None, None)


def rms_swiglu(x, gamma, w1, w3, eps: float, tp=None):
    """(SiLU(RMSNorm(x) @ w1^T), RMSNorm(x) @ w3^T): the SwiGLU's two RMS
    products of one x, two launches (``rms_matmul``'s; under autograd two
    replays).  Differentiable, with one RMS backward for both products.
    ``tp``: a tensor-parallel mesh when w1 and w3 are this rank's hidden
    slice (the gradient into x and gamma summed over its model group)."""
    if _training(x, gamma, w1, w3):
        return _RmsSwiGlu.apply(x, gamma, w1, w3, eps, tp)
    return (rms_matmul(x, gamma, w1, eps, act="silu"),
            rms_matmul(x, gamma, w3, eps))


for _fn in (ln_matmul, ln_qkv, ln_qkv_rope, matmul_residual, ln_mlp,
            ln_matmul_replay, rms_matmul, rms_qkv3, rms_matmul_replay):
    _fn.launches = 0


# ---------------------------------------------------------------------------
# the fused pre-LN ViT block
# ---------------------------------------------------------------------------

BLOCK_PARAMS = ("norm1.weight", "norm1.bias", "attn.qkv.weight",
                "attn.qkv.bias", "attn.proj.weight", "attn.proj.bias",
                "norm2.weight", "norm2.bias", "mlp.fc1.weight", "mlp.fc1.bias",
                "mlp.fc2.weight", "mlp.fc2.bias")


def _attention_sublayer(t, x2, shape, rope_cos_sin, num_heads: int,
                        scale: float, attn_impl: str, ln_eps: float, tp=None):
    """x2 + proj(attention(LN1(x2))) on x2 (B * N, C); ``t`` the block's
    tensors in BLOCK_PARAMS order, already in x2's dtype.  With a
    tensor-parallel mesh ``tp``, ``t`` holds this rank's slices and
    ``num_heads`` its heads (width C' = rows of wqkv / 3)."""
    B, N, _ = shape
    g1, b1, wqkv, bqkv, wproj, bproj = t[:6]
    c = wqkv.shape[0] // 3
    if (attn_impl == "batched" and rope_cos_sin is not None
            and len(rope_cos_sin) == 4):
        ct, st = rope_cos_sin[2], rope_cos_sin[3]
        qkv3 = ln_qkv_rope(x2, g1, b1, wqkv, bqkv, ct, st, num_heads, ln_eps,
                           tp)
        o = packed_qkv_attention(qkv3.reshape(3, B, N, c), num_heads, scale)
    else:
        q, k, v = (u.reshape(B, N, num_heads, c // num_heads)
                   for u in ln_qkv(x2, g1, b1, wqkv, bqkv, ln_eps, tp))
        if rope_cos_sin is not None:
            cos, sin = rope_cos_sin[0], rope_cos_sin[1]
            q = apply_rope2d_bnhd(q, cos, sin)
            k = apply_rope2d_bnhd(k, cos, sin)
        o = dot_product_attention(q, k, v, scale=scale, impl=attn_impl)
    return matmul_residual(o.reshape(B * N, c).contiguous(), wproj, bproj, x2,
                           tp)


def _fused_block_impl(t, x, rope_cos_sin, num_heads: int, scale: float,
                      attn_impl: str, ln_eps: float, tps=(None, None)
                      ) -> torch.Tensor:
    B, N, C = x.shape
    t = [p.to(x.dtype) for p in t]
    tp_attn, tp_mlp = tps
    x2 = _attention_sublayer(t, x.reshape(B * N, C).contiguous(), x.shape,
                             rope_cos_sin, num_heads, scale, attn_impl, ln_eps,
                             tp_attn)
    if PREFER_FUSED_MLP:
        x2 = ln_mlp(x2, *t[6:], ln_eps, tp_mlp)
    else:
        h = ln_matmul(x2, *t[6:10], ln_eps, act="gelu", tp=tp_mlp)
        x2 = matmul_residual(h, t[10], t[11], x2, tp_mlp)
    return x2.reshape(B, N, C)


class _FusedBlock(torch.autograd.Function):
    """The fused block under autograd (``_fused_block_fwd`` / ``_bwd``):
    saves (x, params) only; the backward recomputes the attention sublayer
    through the differentiable fused functions (the replay, attention with
    lse) and differentiates it with autograd, and takes the MLP sublayer's
    gradients from :func:`_mlp_backward` (the MLP's output is not needed)."""

    @staticmethod
    def forward(ctx, x, rope_cos_sin, cfg, *params):
        ctx.save_for_backward(x, *params)
        ctx.rope_cos_sin, ctx.cfg = rope_cos_sin, cfg
        return _fused_block_impl(params, x, rope_cos_sin, *cfg)

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        num_heads, scale, attn_impl, ln_eps, (tp_attn, tp_mlp) = ctx.cfg
        need = ctx.needs_input_grad
        B, N, C = x.shape
        with torch.enable_grad():
            xs = x.detach().requires_grad_(need[0])
            ps = [p.detach().requires_grad_(n) for p, n in zip(params, need[3:])]
            t = [p.to(x.dtype) for p in ps]
            x2 = _attention_sublayer(t, xs.reshape(B * N, C), x.shape,
                                     ctx.rope_cos_sin, num_heads, scale,
                                     attn_impl, ln_eps, tp_attn)
        dx2, *dmlp = _mlp_backward(x2.detach(), *(p.detach() for p in t[6:]),
                                   ln_eps, g.reshape(B * N, C), tp_mlp)
        leaves = [u for u in (xs, *ps[:6]) if u.requires_grad]
        got = iter(torch.autograd.grad(x2, leaves, dx2) if leaves else ())
        dx = next(got).reshape(B, N, C) if need[0] else None
        dattn = [next(got) if n else None for n in need[3:9]]
        dmlp = [d.to(p.dtype) if n else None
                for d, p, n in zip(dmlp, params[6:], need[9:])]
        return (dx, None, None, *dattn, *dmlp)


def fused_vit_block(p, x: torch.Tensor, rope_cos_sin, num_heads: int,
                    scale: float, attn_impl: str, ln_eps: float,
                    tps=(None, None)) -> torch.Tensor:
    """Pre-LN ViT block (``p`` a ``nn.layers.Block``) on x (B, N, C) with the
    elementwise work inside the products (``_fused_block_impl`` of the JAX
    package).  With ``attn_impl == "batched"`` and a 4-tuple
    (cos, sin, ct, st) of RoPE tables, q, k and v come out of
    :func:`ln_qkv_rope` as one packed buffer that the attention reads in
    place; otherwise :func:`ln_qkv`, the (B, N, H, D) RoPE when given, and
    :func:`dot_product_attention`.  Differentiable: under autograd the block
    saves (x, params) and recomputes in its backward (``fused_vit_block``'s
    custom VJP).  A shape or dtype a kernel cannot take raises on CUDA.
    ``tps``: the (attention's, MLP's) tensor-parallel grids
    (``parallel.mesh.Mesh.sublayer_grids``).  A sublayer with one has this
    rank's slices of its params (``parallel.mesh.shard_params``; attention:
    ``num_heads`` its heads) and its output summed over the model group: a
    collective in the forward, and in the backward the recomputed forward's
    and one on the gradient at the sublayer's input."""
    params = [p.get_parameter(name) for name in BLOCK_PARAMS]
    cfg = (num_heads, scale, attn_impl, ln_eps, tuple(tps))
    if _training(x, *params):
        return _FusedBlock.apply(x, rope_cos_sin, cfg, *params)
    return _fused_block_impl(params, x, rope_cos_sin, *cfg)


# ---------------------------------------------------------------------------
# the fused llama block (RMSNorm / GQA attention / SwiGLU)
# ---------------------------------------------------------------------------

LLAMA_PARAMS = ("attention_norm.weight", "attn.wq.weight", "attn.wk.weight",
                "attn.wv.weight", "attn.wo.weight", "ffn_norm.weight",
                "ffn.w1.weight", "ffn.w2.weight", "ffn.w3.weight")


def _fused_llama_impl(t, x, cos, sin, cfg, tps=(None, None)) -> torch.Tensor:
    """``_fused_llama_impl`` of the JAX package; ``t`` the block's tensors in
    LLAMA_PARAMS order.  The weights are cast to x's dtype, the RMS scales
    go to the products as they are; ``matmul_residual`` takes a zero bias
    (the llama linears have none).  ``tps``: the (attention's, FFN's)
    tensor-parallel grids; with the attention's, ``t`` holds this rank's
    ``n_heads / model`` query heads over ``kv_heads / model`` kv heads,
    with the FFN's a slice of the hidden."""
    from fast3r_torch.models.llama_decoder import apply_rotary_pairs

    B, S, D = x.shape
    dt = x.dtype
    g1, wq, wk, wv, wo, g2, w1, w2, w3 = t
    wq, wk, wv, wo, w1, w2, w3 = (w.to(dt) for w in (wq, wk, wv, wo, w1, w2,
                                                     w3))
    tp_attn, tp_ffn = tps
    m = 1 if tp_attn is None else tp_attn.model
    heads, kv_heads = cfg.n_heads // m, cfg.kv_heads // m
    x2 = x.reshape(B * S, D)
    q, k, v = rms_qkv3(x2, g1, wq, wk, wv, cfg.norm_eps, tp_attn)
    hd = cfg.head_dim
    q = apply_rotary_pairs(q.reshape(B, S, heads, hd), cos, sin)
    k = apply_rotary_pairs(k.reshape(B, S, kv_heads, hd), cos, sin)
    v = v.reshape(B, S, kv_heads, hd)  # a strided view of the product
    n_rep = cfg.n_heads // cfg.kv_heads
    if n_rep > 1:  # GQA: repeat each kv head n_rep times in place
        k = k.repeat_interleave(n_rep, dim=2)
        v = v.repeat_interleave(n_rep, dim=2)
    o = dot_product_attention(q, k, v, scale=hd ** -0.5, impl=cfg.attn_impl)
    zero = torch.zeros((D,), device=x.device, dtype=dt)
    x2 = matmul_residual(o.reshape(B * S, heads * hd).contiguous(), wo, zero,
                         x2, tp_attn)
    # SwiGLU as two RMS products (x2 read twice, as the JAX package does)
    h1, h3 = rms_swiglu(x2, g2, w1, w3, cfg.norm_eps, tp_ffn)
    return matmul_residual(h1 * h3, w2, zero, x2, tp_ffn).reshape(B, S, D)


class _FusedLlama(torch.autograd.Function):
    """The fused llama block under autograd (``fused_llama_block``'s custom
    VJP): saves (x, params) only; the backward recomputes the block through
    the differentiable fused functions (the RMS replays, attention with
    lse) and differentiates it with autograd."""

    @staticmethod
    def forward(ctx, x, cos, sin, cfg, tps, *params):
        ctx.save_for_backward(x, cos, sin, *params)
        ctx.cfg, ctx.tps = cfg, tps
        return _fused_llama_impl(params, x, cos, sin, cfg, tps)

    @staticmethod
    def backward(ctx, g):
        x, cos, sin, *params = ctx.saved_tensors
        need = ctx.needs_input_grad
        with torch.enable_grad():
            xs = x.detach().requires_grad_(need[0])
            ps = [p.detach().requires_grad_(n) for p, n in zip(params, need[5:])]
            y = _fused_llama_impl(ps, xs, cos, sin, ctx.cfg, ctx.tps)
        leaves = [u for u in (xs, *ps) if u.requires_grad]
        got = iter(torch.autograd.grad(y, leaves, g) if leaves else ())
        dx = next(got) if need[0] else None
        return (dx, None, None, None, None,
                *(next(got) if n else None for n in need[5:]))


def fused_llama_supported(x_shape, cfg, model: int = 1) -> bool:
    """Whether the port's kernels take the fused llama block at these
    shapes on a rank of a ``model``-way tensor-parallel group (x (B, S, D);
    bfloat16 is checked at launch): the RMS prologue's K = D with
    D % 256 == 0 and D <= 1024; every product's N at the rank's widths
    (q | k | v, D, the FFN hidden, each over ``model`` where the group
    splits its sublayer: ``parallel.mesh.sublayer_splits``) % 128 == 0,
    and the row-parallel products' K (wo: D, w2: the hidden, split alike)
    % 32 == 0; head_dim 64 for the attention kernel."""
    from fast3r_torch.parallel.mesh import sublayer_splits

    d, hidden = cfg.embed_dim, cfg.ffn_hidden
    if cfg.n_heads % cfg.kv_heads:
        return False
    m_attn, m_ffn = (model if s else 1 for s in sublayer_splits(cfg, model))
    n_qkv = (cfg.n_heads + 2 * cfg.kv_heads) // m_attn * cfg.head_dim
    h = hidden // m_ffn
    return (len(x_shape) == 3 and x_shape[-1] == d and d % 256 == 0
            and d <= NARROW_MAX_K and n_qkv % 128 == 0 and h % 128 == 0
            and (d // m_attn) % 32 == 0 and cfg.head_dim == ROPE_HEAD_DIM)


def fused_llama_block(p, x: torch.Tensor, cos, sin, cfg,
                      tps=(None, None)) -> torch.Tensor:
    """Llama block (``p`` a ``models.llama_decoder.LlamaBlock``) on x
    (B, S, D) with RMSNorm, SiLU and the residuals inside the products
    (``fused_llama_block`` of the JAX package): :func:`rms_qkv3`, the
    consecutive-pair rotary on q and k (fp32, torch), the GQA repeat, the
    attention kernel, :func:`matmul_residual` for wo, :func:`rms_matmul`
    for w1 (SiLU) and w3, their product, and :func:`matmul_residual` for
    w2.  cos / sin (B, S, head_dim / 2) fp32.  Differentiable: saves (x,
    params) and recomputes in its backward.  A shape or dtype a kernel
    cannot take raises on CUDA.  ``tps``: the (attention's, FFN's)
    tensor-parallel grids (``parallel.mesh.Mesh.sublayer_grids``); a
    sublayer with one has this rank's slices of its params and its output
    summed over the model group inside ``matmul_residual`` (the residual
    added to the sum), and in the backward the gradient at its input is
    summed once (``rms_qkv3``'s, ``rms_swiglu``'s)."""
    params = [p.get_parameter(name) for name in LLAMA_PARAMS]
    tps = tuple(tps)
    if _training(x, *params):
        return _FusedLlama.apply(x, cos, sin, cfg, tps, *params)
    return _fused_llama_impl(params, x, cos, sin, cfg, tps)
