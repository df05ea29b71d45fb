"""Layers of the port: parameter-holding modules plus plain functions.

Counterpart of ``fast3r_tpu/nn/layers.py``.  The JAX package keeps params in
nested dicts (linear ``(in, out)`` weights, HWIO convs, ViT blocks stacked on
a leading depth axis).  Here they live in ``torch.nn`` modules whose names
follow the same keys (``blocks.{i}.attn.qkv``, ``norm1``, ``mlp.fc1``) in
torch layouts (``(out, in)`` linear weights, OIHW convs, one module per
block); ``fast3r_torch.utils.convert`` maps one onto the other.  The apply
functions take a module and a tensor, like the JAX ones take a dict.

Block math is the pre-LN ViT block: x + attn(LN(x)), then x + MLP(LN(x)),
exact-erf GELU.  With ``fused=True`` (the models' default, ``fused_blocks``)
a block is :func:`fast3r_torch.nn.fused_block.fused_vit_block`, whose
products are the hand-written fused-GEMM kernels.  The plain composition
(``fused=False``) runs LayerNorm through ``ops.fused_layernorm`` (the CUDA
kernels of ``csrc/layernorm.cu``), attention through ``ops.attention`` (the CUDA kernel for
the "batched" and "pallas" implementations) and its products as cuBLAS
matmuls, as the JAX package leaves them to XLA in that configuration.
Training: every block is differentiable; with ``remat`` the plain road's
blocks run under ``torch.utils.checkpoint`` (the JAX package's
``jax.checkpoint``), while the fused block recomputes in its own backward.

The reference Block's dropout knobs act in a training forward that is given
a generator: ``drop`` (inverted dropout on the GELU hidden, the MLP output
and the attention projection's output), ``attn_drop`` (on the softmax
weights, which the materialised-logits road computes) and ``drop_path``
(per-sample stochastic depth on both residual branches).  Any non-zero
rate sends the block down the plain road, as the JAX package's
``vit_block`` does.  Each block draws its masks from a generator of its own
on the activations' device, seeded from the stack's generator before the
block runs, so a recomputed block draws the same masks.

Tensor parallelism: given a ``parallel.mesh.Mesh`` with ``model > 1``, a
stack's attention runs on this rank's slices of its params
(``parallel.mesh.shard_params``: whole heads of qkv) and ``num_heads /
model`` heads where ``model`` divides the heads, and its MLP on a slice of
the hidden where ``model`` divides the hidden; a sublayer it does not
divide keeps its params whole and runs replicated on every model rank
(``parallel.mesh.Mesh.sublayer_grids``, which a stack's forward passes
its blocks).  The fused block sums a split
sublayer's partial output over the model group inside its products; the
plain road wraps the column-parallel products' input in
``mesh.copy_to_model`` and the row-parallel products' output in
``mesh.reduce_from_model``, and adds the row-parallel bias after the sum,
so every replicated tensor and its gradient are whole on every rank.  On a
grid (any ``mesh``) each dropout mask is drawn whole, for the global batch
and every head and hidden column, in the one-process road's order from the
block's generator (the same on every rank), and each rank takes its rows
(data) and, in a split sublayer, its heads or hidden columns (model; a
replicated sublayer's ranks draw the same mask): the grid's step equals
the one-process step on the global batch with the same seed, up to
summation order.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from fast3r_torch.nn.fused_block import fused_vit_block
from fast3r_torch.ops.attention import AttnImpl, dot_product_attention
from fast3r_torch.ops.fused_layernorm import fused_layernorm
from fast3r_torch.ops.rope2d import apply_rope2d_bnhd, expand_rope_tables


# ----------------------------------------------------------------------------
# modules (parameter holders)
# ----------------------------------------------------------------------------

class Attention(nn.Module):
    def __init__(self, dim: int, qkv_bias: bool = True):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class Block(nn.Module):
    """Pre-LN ViT block params: norm1, attn.{qkv, proj}, norm2, mlp.{fc1, fc2}."""

    def __init__(self, dim: int, mlp_ratio: float = 4.0, qkv_bias: bool = True):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn = Attention(dim, qkv_bias)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))


class RMSNorm(nn.Module):
    """RMSNorm scale (the llama decoder's norms; JAX key ``scale``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))


def has_dropout(cfg) -> bool:
    """Whether a stack configuration sets a non-zero dropout rate (the llama
    decoder has none)."""
    return any(getattr(cfg, k, 0.0) > 0.0
               for k in ("drop", "attn_drop", "drop_path"))


def make_vit_stack(depth: int, dim: int, mlp_ratio: float = 4.0,
                   qkv_bias: bool = True) -> nn.ModuleList:
    return nn.ModuleList(Block(dim, mlp_ratio, qkv_bias) for _ in range(depth))


@torch.no_grad()
def init_params_(module: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's initialisation, drawn from ``generator``: linear and
    conv weights and biases U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (torch's
    default bound), LayerNorm scale 1 and bias 0, RMSNorm scale 1, the
    llama decoder's ``view0_embed`` and the DINO encoder's ``pos_embed``
    N(0, 0.02), its ``cls_token`` 0 and LayerScale gammas 1."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            w = m.weight
            if isinstance(m, nn.Linear):
                fan_in = w.shape[1]
            elif isinstance(m, nn.ConvTranspose2d):
                # the JAX HWIO kernel (k, k, cin, cout) has fan_in k*k*cin
                fan_in = w.shape[0] * w.shape[2] * w.shape[3]
            else:
                fan_in = w.shape[1] * w.shape[2] * w.shape[3]
            bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
            for p in (w, m.bias):
                if p is not None:
                    p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1)
                            * bound)
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.fill_(0.0)
        elif isinstance(m, RMSNorm):
            m.weight.fill_(1.0)
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("view0_embed", "pos_embed"):
            p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
        elif leaf == "cls_token":
            p.zero_()
        elif leaf in ("ls1", "ls2"):
            p.fill_(1.0)


# ----------------------------------------------------------------------------
# apply functions
# ----------------------------------------------------------------------------

def linear(p: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    b = None if p.bias is None else p.bias.to(x.dtype)
    return F.linear(x, p.weight.to(x.dtype), b)


def layernorm(p: nn.LayerNorm, x: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm with fp32 statistics (the CUDA kernel on CUDA tensors)."""
    return fused_layernorm(x, p.weight, p.bias, eps)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def stack_grids(mesh, stack) -> Tuple:
    """The (attention's, MLP's) tensor-parallel grids of the blocks of a
    stack configured by ``stack`` on the grid ``mesh`` (None: one process):
    ``mesh.sublayer_grids(stack)``, each None where nothing is split."""
    return (None, None) if mesh is None else mesh.sublayer_grids(stack)


def _rand_below(shape, keep: float, generator: torch.Generator, device,
                mesh=None, model_dim: Optional[int] = None) -> torch.Tensor:
    """uniform < keep of ``shape``, this rank's part of the whole draw: on a
    grid ``mesh`` the draw covers the global batch (dim 0 times
    ``mesh.data``) and, with ``model_dim``, every model rank's columns of
    that dim; the rank keeps its rows and its columns."""
    whole = list(shape)
    if mesh is not None:
        whole[0] *= mesh.data
        if model_dim is not None:
            whole[model_dim] *= mesh.model
    mask = torch.rand(whole, generator=generator, device=device) < keep
    if mesh is not None:
        mask = mask.narrow(0, mesh.data_rank * shape[0], shape[0])
        if model_dim is not None:
            n = shape[model_dim]
            mask = mask.narrow(model_dim, mesh.model_rank * n, n)
    return mask


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator], mesh=None,
            model_dim: Optional[int] = None) -> torch.Tensor:
    """Inverted dropout (torch ``nn.Dropout`` in train mode): each element
    kept with probability 1 - rate and scaled by 1 / (1 - rate), the mask
    drawn from ``generator`` on x's device.  The identity when rate is 0 or
    there is no generator.  On a grid ``mesh`` x is this rank's part of the
    global tensor (its data rows; with ``model_dim`` its model slice of
    that dim) and the mask its part of the whole draw."""
    if rate == 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = _rand_below(x.shape, keep, generator, x.device, mesh, model_dim)
    return torch.where(mask, x / keep, torch.zeros_like(x))


def drop_path(x: torch.Tensor, rate: float,
              generator: Optional[torch.Generator], mesh=None) -> torch.Tensor:
    """Stochastic depth a sample: one draw per leading row, kept rows scaled
    by 1 / (1 - rate); at rate 1 the branch is zeroed unscaled (the
    reference's ``keep_prob > 0`` guard).  On a grid ``mesh`` x holds this
    data rank's rows of the global batch."""
    if rate == 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    mask = _rand_below(shape, keep, generator, x.device, mesh).to(x.dtype)
    if keep > 0.0:
        mask = mask / keep
    return x * mask


def row_parallel(p: nn.Linear, x: torch.Tensor, tp) -> torch.Tensor:
    """A row-parallel product (``p`` this rank's input columns) summed over
    the model group, then the whole bias if it has one; ``linear`` without
    ``tp``."""
    if tp is None:
        return linear(p, x)
    y = tp.reduce_from_model(F.linear(x, p.weight.to(x.dtype)))
    return y if p.bias is None else y + p.bias.to(x.dtype)


def mlp(p: Mlp, x: torch.Tensor, drop: float = 0.0,
        generator: Optional[torch.Generator] = None, mesh=None, tp=None
        ) -> torch.Tensor:
    """fc2(GELU(fc1(x))), dropout on the hidden and the output.  ``mesh``:
    the grid, if any; ``tp``: its grid where it splits this MLP
    (``Mesh.sublayer_grids``), and then ``p`` holds this rank's hidden
    slice."""
    if tp is not None:
        x = tp.copy_to_model(x)
    h = dropout(gelu(linear(p.fc1, x)), drop, generator, mesh,
                model_dim=-1 if tp is not None else None)
    return dropout(row_parallel(p.fc2, h, tp), drop, generator, mesh)


def conv2d(p: nn.Conv2d, x: torch.Tensor, stride: int = 1, padding=0,
           transpose_kernel_spatial: bool = False) -> torch.Tensor:
    """NCHW conv with the module's OIHW kernel; ``transpose_kernel_spatial``
    swaps the kernel's H and W axes (the portrait patch-embed branch)."""
    w = p.weight.to(x.dtype)
    if transpose_kernel_spatial:
        w = w.transpose(2, 3)
    b = None if p.bias is None else p.bias.to(x.dtype)
    return F.conv2d(x, w, b, stride=stride, padding=padding)


def conv_transpose2d(p: nn.ConvTranspose2d, x: torch.Tensor,
                     stride: int) -> torch.Tensor:
    """Transposed conv with kernel_size == stride (the DPT upsamplers): every
    output pixel receives exactly one input pixel times one kernel tap."""
    if p.weight.shape[2] != stride or p.weight.shape[3] != stride:
        raise ValueError("conv_transpose2d: kernel size must equal the stride")
    b = None if p.bias is None else p.bias.to(x.dtype)
    return F.conv_transpose2d(x, p.weight.to(x.dtype), b, stride=stride)


def attention_layer(p: Attention, x: torch.Tensor, num_heads: int,
                    scale: float,
                    rope_cos_sin: Optional[Tuple[torch.Tensor, ...]],
                    attn_impl: AttnImpl, attn_drop: float = 0.0,
                    proj_drop: float = 0.0,
                    generator: Optional[torch.Generator] = None,
                    mesh=None, tp=None) -> torch.Tensor:
    """Self-attention sublayer on x (B, N, C).  q, k and v stay strided views
    of the qkv projection's (B, N, 3, H, D) output; RoPE, when given,
    rotates q and k in fp32.  ``attn_impl`` is an implementation's name or
    a callable ``(q, k, v, scale) -> o`` (``ops.attention``).  With a
    generator and a non-zero ``attn_drop`` the softmax weights are
    materialised (fp32 logits, weights in x's dtype) and dropped before
    ``@ v``; ``proj_drop`` follows the output projection.  ``mesh``: the
    grid, if any; ``tp``: its grid where it splits this attention
    (``Mesh.sublayer_grids``), and then ``p`` holds this rank's ``num_heads`` heads
    (and the weights' mask is their part of every head's draw)."""
    B, N, _ = x.shape
    if tp is not None:
        x = tp.copy_to_model(x)
    qkv = linear(p.qkv, x)
    qkv = qkv.reshape(B, N, 3, num_heads, qkv.shape[-1] // (3 * num_heads))
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if rope_cos_sin is not None:
        cos, sin = rope_cos_sin[0], rope_cos_sin[1]
        q = apply_rope2d_bnhd(q, cos, sin)
        k = apply_rope2d_bnhd(k, cos, sin)
    if attn_drop > 0.0 and generator is not None:
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
        w = dropout(torch.softmax(logits, -1).to(q.dtype), attn_drop,
                    generator, mesh, model_dim=1 if tp is not None else None)
        o = torch.einsum("bhqk,bkhd->bqhd", w, v)
    else:
        o = dot_product_attention(q, k, v, scale=scale, impl=attn_impl)
    return dropout(row_parallel(p.proj, o.reshape(B, N, -1), tp), proj_drop,
                   generator, mesh)


def vit_block(p: Block, x: torch.Tensor, num_heads: int, scale: float,
              rope_cos_sin=None, attn_impl: AttnImpl = "pallas",
              ln_eps: float = 1e-6, fused: bool = False, drop: float = 0.0,
              attn_drop: float = 0.0, drop_path_rate: float = 0.0,
              seed: Optional[int] = None, mesh=None,
              tps=(None, None)) -> torch.Tensor:
    """Pre-LN ViT block: the fused block with ``fused=True``, else the plain
    composition of the JAX package.  With a ``seed`` and a non-zero rate the
    block drops (a generator seeded ``seed`` on x's device draws the masks,
    in the order attention weights, projection, first branch, MLP hidden,
    MLP output, second branch) and takes the plain road.  ``mesh``: the
    grid of ranks, if any (x this data rank's rows); ``tps``: its
    (attention's, MLP's) grids where it splits them (``p`` this rank's
    slices of a split sublayer, ``num_heads`` its heads)."""
    gen = None
    if seed is not None and (drop > 0.0 or attn_drop > 0.0
                             or drop_path_rate > 0.0):
        gen = torch.Generator(device=x.device).manual_seed(seed)
    if fused and gen is None:
        return fused_vit_block(p, x, rope_cos_sin, num_heads, scale,
                               attn_impl, ln_eps, tps)
    a = attention_layer(p.attn, layernorm(p.norm1, x, ln_eps), num_heads,
                        scale, rope_cos_sin, attn_impl, attn_drop, drop, gen,
                        mesh, tps[0])
    x = x + drop_path(a, drop_path_rate, gen, mesh)
    m = mlp(p.mlp, layernorm(p.norm2, x, ln_eps), drop, gen, mesh, tps[1])
    return x + drop_path(m, drop_path_rate, gen, mesh)


def run_vit_stack(blocks: Sequence[Block], x: torch.Tensor, num_heads: int,
                  scale: float, rope_cos_sin=None,
                  attn_impl: AttnImpl = "pallas",
                  ln_eps: float = 1e-6, hooks: Sequence[int] = (),
                  fused: bool = False, remat: bool = False,
                  drop: float = 0.0, attn_drop: float = 0.0,
                  drop_path_rate: float = 0.0,
                  generator: Optional[torch.Generator] = None, mesh=None,
                  tps=(None, None)
                  ) -> Tuple[torch.Tensor, Dict[int, torch.Tensor]]:
    """Run the blocks; return (output, {hook: activation}) with hook i the
    output after block i (1-based).  On the fused road with "batched"
    attention and RoPE, the flat (M, C) RoPE lane tables are expanded once
    for the whole stack and every block gets (cos, sin, ct, st).  A callable
    ``attn_impl`` (``(q, k, v, scale) -> o``) serves every block's
    attention.  ``remat`` recomputes each plain block in the backward (the
    fused block always does).  With a ``generator`` (a training forward's)
    and a non-zero dropout rate, each block drops with a seed drawn from it
    and runs on the plain road; the generator is not read otherwise.
    ``mesh``: the grid of ranks, if any; ``tps``: the blocks' (attention's,
    MLP's) tensor-parallel grids (``mesh.sublayer_grids`` of the stack's
    configuration): a sublayer with one runs on this rank's slices (the
    attention on ``num_heads / model`` heads), one without runs whole on
    every rank; x and the output stay whole on every rank."""
    drops = generator is not None and (drop > 0.0 or attn_drop > 0.0
                                       or drop_path_rate > 0.0)
    fused = fused and not drops
    width = x.shape[-1]
    if tps[0] is not None:
        num_heads //= tps[0].model
        width //= tps[0].model
    if (fused and attn_impl == "batched" and rope_cos_sin is not None
            and len(rope_cos_sin) == 2):
        ct, st = expand_rope_tables(rope_cos_sin[0], rope_cos_sin[1],
                                    width, x.dtype)
        rope_cos_sin = (rope_cos_sin[0], rope_cos_sin[1], ct, st)
    outputs: Dict[int, torch.Tensor] = {}
    checkpoint = remat and not fused and torch.is_grad_enabled()
    for i, block in enumerate(blocks):
        seed = (int(torch.randint(0, 2 ** 63 - 1, (), generator=generator))
                if drops else None)
        args = (block, x, num_heads, scale, rope_cos_sin, attn_impl, ln_eps,
                fused, drop, attn_drop, drop_path_rate, seed, mesh, tps)
        x = (torch.utils.checkpoint.checkpoint(vit_block, *args,
                                               use_reentrant=False)
             if checkpoint else vit_block(*args))
        if i + 1 in hooks:
            outputs[i + 1] = x
    return x, outputs
