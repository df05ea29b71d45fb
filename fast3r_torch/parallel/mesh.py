"""Data, ZeRO-2 and tensor parallelism over ``torch.distributed`` ranks.

Counterpart of ``fast3r_tpu/parallel/mesh.py``.  The JAX package lays its
devices out as a ``data x model`` ``jax.sharding.Mesh`` and lets XLA insert
the collectives; here the ranks of an initialised process group form the
same grid (global rank = data rank * model + model rank, JAX's
``np.array(devices).reshape(data, model)``) and the port calls the
collectives itself:

  data   batch parallelism: each data rank takes its rows of the global
         batch; gradients are reduce-scattered over the data group and
         each rank keeps its 1/data shard of the fp32 master and of AdamW's
         moments (ZeRO stage 2, the DeepSpeed analog JAX's docstring
         names), all-gathered into the compute copy after the update.
  model  Megatron tensor parallelism over attention heads and the MLP
         hidden, in every stack (the CroCo and DINO encoders, the fusion
         and llama decoders): qkv and fc1 (llama: wq, wk, wv, w1, w3)
         column-parallel (output rows), attn.proj and fc2 (llama: wo, w2)
         row-parallel (input columns); the rest replicated, as JAX's
         ``P()`` leaves it.  One collective per split sublayer in the
         forward (the row-parallel output's all-reduce) and one in the
         backward (the gradient at the column-parallel input).  A sublayer
         whose heads (and llama kv heads) or hidden ``model`` does not
         divide keeps its params whole and runs replicated on every model
         rank, with no collective (:func:`sublayer_splits`); its
         gradients are the same on every model rank (``share_batch`` gives
         them one batch) and take the data group's road, as the replicated
         params' do.  Dropout draws each mask whole, for the global batch,
         from the generator every rank holds, and each rank takes its slice
         (``nn.layers.dropout``; a replicated sublayer's ranks the same
         mask).

The layout of a rank's qkv rows is the port's own: each rank holds whole
heads, its q, k and v rows (JAX's spec splits the packed 3C output into
contiguous blocks, which GSPMD can afford and a per-rank attention cannot).
Where whole heads do not divide over ``model``, JAX splits mid-head (or
replicates) and the port replicates the sublayer; both compute the same
function.  Only the gathered params equal JAX's.

JAX's ``param_shardings``, ``replicated`` and ``train_state_shardings``
give ``jit`` its in and out specs; eager PyTorch has no counterpart.

Collectives go through :class:`Mesh`, on the process group's backend:
NCCL with a card per rank, or gloo, so that ranks sharing one card run
over it.  The step's collectives (``all_reduce``, ``reduce_scatter_tensor``,
``all_gather_into_tensor``) hand gloo the card's tensors, which it takes
(``scripts/probe_gloo_cuda.py`` checks a machine's torch); the gathers of a
checkpoint and the batch's broadcast, whose data lives on the host, give
gloo host tensors and NCCL card ones, chosen from the group's backend.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

# Megatron's column- and row-parallel products, by module name (JAX's
# ``param_pspec``: the ViT blocks' and the llama layers')
COLUMN = frozenset({"qkv", "fc1", "wq", "wk", "wv", "w1", "w3"})
ROW = frozenset({"fc2", "wo", "w2"})


class TensorParallelError(ValueError):
    """A configuration the tensor-parallel road (``model > 1``) does not
    run."""


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """How a tensor is split over the model group: along ``dim`` (0 the
    output rows of a (out, in) weight or a bias, 1 the input columns);
    ``packed`` for the q | k | v rows of qkv, split per block."""
    dim: int
    packed: bool = False


class Mesh:
    """A ``data x model`` grid of the process group's ranks, this rank's
    coordinates, and the sub-groups of its row and column."""

    def __init__(self, data: int, model: int):
        world = dist.get_world_size() if dist.is_initialized() else 1
        if data * model != world:
            raise ValueError(f"mesh {data}x{model} != {world} ranks")
        self.data, self.model = data, model
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.data_rank, self.model_rank = divmod(self.rank, model)
        self.data_group = self.model_group = None
        if world > 1:
            # every rank creates every group, in the same order
            for d in range(data):
                g = dist.new_group([d * model + m for m in range(model)])
                if d == self.data_rank:
                    self.model_group = g
            for m in range(model):
                g = dist.new_group([d * model + m for d in range(data)])
                if m == self.model_rank:
                    self.data_group = g

    def __repr__(self) -> str:
        return (f"Mesh(data={self.data}, model={self.model}, rank={self.rank}"
                f" = ({self.data_rank}, {self.model_rank}))")

    # ---- collectives -----------------------------------------------------
    def _run(self, group, size: int, op, *ts: torch.Tensor) -> None:
        """op(*ts, group=group) unless the group is this rank alone."""
        if size > 1:
            op(*ts, group=group)

    def all_reduce_model(self, t: torch.Tensor) -> torch.Tensor:
        """t summed over the model group, in place (t is contiguous)."""
        self._run(self.model_group, self.model, dist.all_reduce, t)
        return t

    def all_reduce_data(self, t: torch.Tensor) -> torch.Tensor:
        """t summed over the data group, in place (t is contiguous)."""
        self._run(self.data_group, self.data, dist.all_reduce, t)
        return t

    def sum_data(self, t: torch.Tensor) -> torch.Tensor:
        """A new tensor: t summed over the data group (no gradient)."""
        return self.all_reduce_data(t.detach().clone().contiguous())

    def reduce_scatter_data(self, flat: torch.Tensor) -> torch.Tensor:
        """This data rank's 1/data slice of ``flat`` summed over the data
        group; ``flat``'s length divides by ``data``."""
        if self.data == 1:
            return flat
        out = flat.new_empty(flat.numel() // self.data)
        self._run(self.data_group, self.data, dist.reduce_scatter_tensor,
                  out, flat)
        return out

    def all_gather_data(self, shard: torch.Tensor) -> torch.Tensor:
        """The data ranks' shards concatenated in rank order."""
        if self.data == 1:
            return shard
        out = shard.new_empty(shard.numel() * self.data)
        self._run(self.data_group, self.data, dist.all_gather_into_tensor,
                  out, shard.contiguous())
        return out

    def all_gather_model(self, t: torch.Tensor) -> List[torch.Tensor]:
        """The model ranks' tensors (of one shape), in rank order."""
        if self.model == 1:
            return [t]
        flat = t.reshape(-1).contiguous()
        out = flat.new_empty(self.model * flat.numel())
        self._run(self.model_group, self.model, dist.all_gather_into_tensor,
                  out, flat)
        return [c.view(t.shape) for c in out.chunk(self.model)]

    def _gather(self, group, size: int, dst: int, t: torch.Tensor
                ) -> Optional[List[torch.Tensor]]:
        """The group's tensors (of one shape) in rank order on the CPU of
        global rank ``dst``, None on the others.  gloo takes them from the
        host (where they are wanted), NCCL from the card."""
        t = t.contiguous()
        if size == 1:
            return [t.cpu()]
        if dist.get_backend(group) != dist.Backend.NCCL:
            t = t.cpu()
        parts = ([torch.empty_like(t) for _ in range(size)]
                 if self.rank == dst else None)
        dist.gather(t, parts, dst=dst, group=group)
        return None if parts is None else [p.cpu() for p in parts]

    def gather_data(self, shard: torch.Tensor) -> Optional[torch.Tensor]:
        """The data ranks' shards concatenated in rank order, on data rank
        0 (on the CPU); None on the others."""
        parts = self._gather(self.data_group, self.data, self.model_rank,
                             shard)
        return None if parts is None else torch.cat(parts)

    def gather_model(self, t: torch.Tensor) -> Optional[List[torch.Tensor]]:
        """The model ranks' tensors (of one shape) in rank order, on model
        rank 0 (on the CPU); None on the others."""
        return self._gather(self.model_group, self.model,
                            self.data_rank * self.model, t)

    def share_batch(self, batch: dict) -> dict:
        """The batch of the model group's first rank, on every rank of the
        group: a tensor-parallel forward takes one input, while a loader's
        crops, jitter and view choice draw from each process's own entropy
        where its dataset has no seed.  Numeric arrays go as tensors
        (through the card on NCCL) and come back as what they were, numpy
        or tensor; the rest (names, labels) as objects."""
        if self.model == 1:
            return batch
        src = self.data_rank * self.model
        arrays, head = {}, [None]
        if self.model_rank == 0:
            arrays = {k: torch.as_tensor(v).contiguous()
                      for k, v in batch.items() if _numeric(v)}
            head = [(list(batch),
                     {k: v for k, v in batch.items() if k not in arrays},
                     {k: (tuple(t.shape), t.dtype,
                          isinstance(batch[k], np.ndarray))
                      for k, t in arrays.items()})]
        dist.broadcast_object_list(head, src=src, group=self.model_group)
        keys, out, specs = head[0]
        nccl = dist.get_backend(self.model_group) == dist.Backend.NCCL
        for k, (shape, dtype, is_np) in specs.items():
            t = arrays.get(k)
            t = torch.empty(shape, dtype=dtype) if t is None else t
            t = t.cuda() if nccl else t
            dist.broadcast(t, src=src, group=self.model_group)
            out[k] = t.cpu().numpy() if is_np else t.cpu()
        return {k: out[k] for k in keys}

    def _int(self, n: int) -> torch.Tensor:
        """n as a one-element tensor where the backend takes it (NCCL: on
        the card)."""
        t = torch.tensor([n], dtype=torch.int64)
        return t.cuda() if dist.get_backend() == dist.Backend.NCCL else t

    def count(self, n: int) -> int:
        """n summed over the data group."""
        if self.data == 1:
            return n
        return int(self.all_reduce_data(self._int(n)).item())

    def any(self, flag: bool) -> bool:
        """Whether ``flag`` is set on any rank of the grid."""
        if self.data * self.model == 1:
            return flag
        t = self._int(int(flag))
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    # ---- the Megatron pair ----------------------------------------------
    def copy_to_model(self, x: torch.Tensor) -> torch.Tensor:
        """Identity forward, gradient all-reduced over the model group: the
        input of a column-parallel product."""
        return _CopyToModel.apply(x, self) if self.model > 1 else x

    def reduce_from_model(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the model group forward, identity backward: the output
        of a row-parallel product."""
        return _ReduceFromModel.apply(x, self) if self.model > 1 else x

    # ---- what the tensor-parallel road runs ------------------------------
    def check_model_config(self, cfg) -> None:
        """Raise :class:`TensorParallelError` for what ``model > 1`` does
        not run: the sequence-sharded road (a callable attention; JAX has
        no such path either).  Heads, kv heads or an MLP hidden that
        ``model`` does not divide run replicated (:func:`sublayer_splits`)."""
        if self.model > 1 and callable(cfg.decoder.attn_impl):
            raise TensorParallelError(
                "the sequence-sharded road does not run tensor-parallel "
                "(model > 1)")

    def sublayer_grids(self, stack) -> Tuple[Optional["Mesh"],
                                             Optional["Mesh"]]:
        """The (attention's, MLP's) tensor-parallel grid of the blocks of a
        stack configured by ``stack``: this grid where its model group
        splits the sublayer (:func:`sublayer_splits`), else None (the
        sublayer's params whole and the sublayer run replicated, with no
        collective).  What a stack's forward passes its blocks."""
        return tuple(self if s else None
                     for s in sublayer_splits(stack, self.model))


def tp_widths(stack) -> Tuple[int, int, int]:
    """(query heads, kv heads, MLP hidden) of a stack's configuration: a
    ViT stack (CroCo, DINO, the fusion decoder) has as many kv heads as
    heads, a llama decoder ``kv_heads`` and its SwiGLU ``ffn_hidden``."""
    if hasattr(stack, "n_heads"):
        return stack.n_heads, stack.kv_heads, stack.ffn_hidden
    return (stack.num_heads, stack.num_heads,
            int(stack.embed_dim * stack.mlp_ratio))


def sublayer_splits(stack, model: int) -> Tuple[bool, bool]:
    """Whether a ``model``-way group splits the (attention, MLP) of the
    blocks of a stack configured by ``stack``: the attention where
    ``model`` > 1 divides its heads and kv heads (a rank holds whole
    heads), the MLP / FFN where it divides the hidden.  The one rule both
    the params' layout (:func:`param_spec`) and the forward
    (:meth:`Mesh.sublayer_grids`) follow.  JAX's ``param_pspec`` splits a
    width that whole heads do not divide mid-head where its shape divides,
    or replicates it; GSPMD computes the same function either way."""
    heads, kv_heads, hidden = tp_widths(stack)
    return (model > 1 and heads % model == 0 and kv_heads % model == 0,
            model > 1 and hidden % model == 0)


def _numeric(v) -> bool:
    return isinstance(v, torch.Tensor) or (
        isinstance(v, np.ndarray) and v.dtype.kind in "biuf")


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce_model(g.contiguous().clone()), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce_model(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


def grid_shape(data: Optional[int], model: int, world: int
               ) -> Tuple[int, int]:
    """(data, model) of a grid over ``world`` ranks: ``data`` None, 0 or -1
    takes all the ranks ``model`` leaves (JAX's ``data_axis: -1``)."""
    model = max(1, model)
    if data in (None, 0, -1):
        data = world // model
    return data, model


def make_mesh(data: Optional[int] = None, model: int = 1) -> Mesh:
    """The grid of the initialised process group (one rank without one),
    shaped by :func:`grid_shape`; ``data * model`` must equal the world
    size."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return Mesh(*grid_shape(data, model, world))


# ---------------------------------------------------------------------------
# the tensor-parallel rule
# ---------------------------------------------------------------------------

def _sublayer_splits(name: str, cfg, model: int) -> bool:
    """Whether ``model`` ranks split the block sublayer that parameter
    ``name`` belongs to (True outside the stacks' sublayers)."""
    parts = name.split(".")
    stack = {"encoder": cfg.encoder, "decoder": cfg.decoder}.get(parts[0])
    if stack is None:
        return True
    attn, mlp = sublayer_splits(stack, model)
    if "attn" in parts:
        return attn
    if "mlp" in parts or "ffn" in parts:
        return mlp
    return True


def param_spec(name: str, shape: Tuple[int, ...], model: int, cfg
               ) -> Optional[ParamSpec]:
    """How the port's parameter ``name`` (``Fast3RNet.named_parameters``,
    torch's (out, in) layout) of ``shape`` splits over ``model`` ranks in
    the model ``cfg``, or None when it is replicated: JAX's ``param_pspec``
    on the port's names, except that the params of a sublayer ``model``
    does not split (:func:`sublayer_splits`) are replicated, where JAX's
    shape rule may split them mid-head; the port's forward runs such a
    sublayer whole on every model rank.
    Weights and biases of qkv / fc1 and of the llama ``wq``, ``wk``,
    ``wv``, ``w1``, ``w3`` split their output rows (qkv per q | k | v block,
    so a rank holds whole heads of each; a rank's contiguous ``wk`` / ``wv``
    rows are the kv heads its query heads read under the GQA repeat);
    weights of attn.proj / fc2 and of the llama ``wo``, ``w2`` their input
    columns, their bias replicated; a dim that ``model`` does not divide
    leaves the tensor replicated.  The DINO encoder's blocks follow the ViT
    rule, its LayerScale gammas, tokens and embeddings stay replicated."""
    if model == 1 or not _sublayer_splits(name, cfg, model):
        return None
    parts = name.split(".")
    names, leaf = set(parts[:-1]), parts[-1]
    if names & COLUMN and leaf in ("weight", "bias"):
        packed = "qkv" in names
        rows = shape[0] // 3 if packed else shape[0]
        if (not packed or shape[0] % 3 == 0) and rows % model == 0:
            return ParamSpec(0, packed)
        return None
    if ((("proj" in names and "attn" in names) or names & ROW)
            and leaf == "weight" and len(shape) == 2 and shape[1] % model == 0):
        return ParamSpec(1)
    return None


def shard_tensor(t: torch.Tensor, spec: Optional[ParamSpec], model: int,
                 rank: int) -> torch.Tensor:
    """Model rank ``rank``'s slice of the whole tensor ``t`` (a contiguous
    copy; ``t`` itself when replicated)."""
    if spec is None:
        return t
    if spec.packed:
        n = t.shape[0] // 3
        return t.reshape((3, model, n // model) + tuple(t.shape[1:]))[
            :, rank].reshape((-1,) + tuple(t.shape[1:])).contiguous()
    return t.chunk(model, spec.dim)[rank].contiguous()


def unshard_tensor(parts: List[torch.Tensor], spec: Optional[ParamSpec]
                   ) -> torch.Tensor:
    """The whole tensor from the model ranks' slices (the inverse of
    :func:`shard_tensor`); a replicated tensor's first copy."""
    if spec is None:
        return parts[0]
    if spec.packed:
        rest = tuple(parts[0].shape[1:])
        return torch.stack([p.reshape((3, -1) + rest) for p in parts], 1
                           ).reshape((-1,) + rest)
    return torch.cat(parts, spec.dim)


def full_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's whole shape in ``Fast3RNet(cfg)``."""
    from fast3r_torch.models.fast3r import Fast3RNet

    with torch.device("meta"):
        net = Fast3RNet(cfg)
    return {k: tuple(p.shape) for k, p in net.named_parameters()}


Params = Union[nn.Module, Dict[str, torch.Tensor]]


def shard_params(params: Params, mesh: Mesh, cfg) -> Params:
    """This rank's slice of whole params of the model ``cfg``: of a
    ``Fast3RNet`` a module of the same structure whose parameters are the
    local slices (for the tensor-parallel forward), of a name -> tensor dict
    (``params_from_jax``'s, a checkpoint's) the dict of slices."""
    if isinstance(params, nn.Module):
        named = dict(params.named_parameters())
        local = shard_params({k: p.detach() for k, p in named.items()}, mesh,
                             cfg)
        memo = {id(p): nn.Parameter(local[k], requires_grad=p.requires_grad)
                for k, p in named.items()}
        return copy.deepcopy(params, memo)
    return {k: shard_tensor(t, param_spec(k, tuple(t.shape), mesh.model, cfg),
                            mesh.model, mesh.model_rank)
            for k, t in params.items()}


def gather_params(params: Params, mesh: Mesh, cfg, to_all: bool = True
                  ) -> Optional[Dict[str, torch.Tensor]]:
    """The whole tensors (on the CPU) from every model rank's slices: a
    local ``Fast3RNet`` or a name -> tensor dict of the same names
    (moments, gradients).  Every rank of the model group calls it; ``cfg``
    gives the whole shapes, and so which tensors were split.  With
    ``to_all`` False only model rank 0 receives them (None elsewhere)."""
    if isinstance(params, nn.Module):
        params = {k: p.detach() for k, p in params.named_parameters()}
    shapes = full_shapes(cfg)
    out = {}
    for k, t in params.items():
        spec = param_spec(k, shapes[k], mesh.model, cfg)
        if spec is None:
            parts = [t]
        else:
            parts = (mesh.all_gather_model(t) if to_all
                     else mesh.gather_model(t))
        if parts is not None:
            out[k] = unshard_tensor([p.cpu() for p in parts], spec)
    return out if to_all or mesh.model_rank == 0 else None


def batch_rows(mesh: Mesh, global_batch: int) -> slice:
    """This data rank's rows of a global batch (JAX's ``batch_sharding``:
    the leading dim over "data"); every model rank of a data group takes
    the same rows."""
    if global_batch % mesh.data:
        raise ValueError(f"a global batch of {global_batch} does not split "
                         f"over data={mesh.data}")
    n = global_batch // mesh.data
    return slice(mesh.data_rank * n, (mesh.data_rank + 1) * n)


# ---------------------------------------------------------------------------
# ZeRO-2: the fp32 master and AdamW's moments sharded over "data"
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Bucket:
    """Params flattened into one buffer, padded to a multiple of the data
    size; this data rank owns elements [lo, hi).  One bucket per (top-level
    group, split over model or not, trainable): its key's first dotted
    part is the group, so ``OptimConfig.lr_scales`` applies per bucket."""
    key: str
    names: List[str]
    shapes: List[Tuple[int, ...]]
    sharded: bool
    trainable: bool
    padded: int
    lo: int
    hi: int


@dataclasses.dataclass
class ZeroState:
    """This rank's shard of the fp32 master and of AdamW's moments, one
    flat tensor per bucket (the ``AdamWState`` fields ``count``, ``mu`` and
    ``nu`` by bucket key)."""
    buckets: List[Bucket]
    master: Dict[str, torch.Tensor]
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: int = 0


def _buckets(net: nn.Module, cfg, mesh: Mesh) -> List[Bucket]:
    shapes = full_shapes(cfg)
    groups: Dict[str, Bucket] = {}
    for name, p in net.named_parameters():
        sharded = param_spec(name, shapes[name], mesh.model, cfg) is not None
        key = (f"{name.split('.', 1)[0]}.{'model' if sharded else 'whole'}"
               f"{'' if p.requires_grad else '.frozen'}")
        b = groups.setdefault(key, Bucket(key, [], [], sharded,
                                          p.requires_grad, 0, 0, 0))
        b.names.append(name)
        b.shapes.append(tuple(p.shape))
    for b in groups.values():
        n = sum(_numel(s) for s in b.shapes)
        b.padded = -(-n // mesh.data) * mesh.data
        size = b.padded // mesh.data
        b.lo, b.hi = mesh.data_rank * size, (mesh.data_rank + 1) * size
    return list(groups.values())


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def flatten(bucket: Bucket, tensors: Dict[str, torch.Tensor], dtype,
            device) -> torch.Tensor:
    """The bucket's tensors (by name; a missing one as zeros) in one flat
    buffer of ``dtype``, zero-padded."""
    flat = torch.zeros(bucket.padded, dtype=dtype, device=device)
    off = 0
    for name, shape in zip(bucket.names, bucket.shapes):
        n = _numel(shape)
        t = tensors.get(name)
        if t is not None:
            flat[off:off + n].copy_(t.reshape(-1))
        off += n
    return flat


def unflatten(bucket: Bucket, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Views of a whole flat buffer as the bucket's tensors."""
    out, off = {}, 0
    for name, shape in zip(bucket.names, bucket.shapes):
        n = _numel(shape)
        out[name] = flat[off:off + n].view(shape)
        off += n
    return out


def zero_init(net: nn.Module, cfg, mesh: Mesh, device=None) -> ZeroState:
    """ZeRO-2 state of a rank's local params (``shard_params``'s, in their
    full-precision values): the rank's fp32 shard of each bucket as the
    master, zero moments beside it (JAX's ``zero_init_opt_state``)."""
    named = {k: p.detach() for k, p in net.named_parameters()}
    device = device if device is not None else next(iter(named.values())).device
    buckets = _buckets(net, cfg, mesh)
    master = {b.key: flatten(b, named, torch.float32, device)[b.lo:b.hi].clone()
              for b in buckets}
    return ZeroState(buckets, master,
                     {k: torch.zeros_like(v) for k, v in master.items()},
                     {k: torch.zeros_like(v) for k, v in master.items()})


def zero_load(zero: ZeroState, master: Dict[str, torch.Tensor],
              mu: Optional[Dict[str, torch.Tensor]] = None,
              nu: Optional[Dict[str, torch.Tensor]] = None) -> None:
    """Set the shards from a rank's local (model-sliced, whole over data)
    master and moments, in place; moments not given stay as they are."""
    for b in zero.buckets:
        for mine, src in ((zero.master, master), (zero.mu, mu), (zero.nu, nu)):
            if src is not None:
                flat = flatten(b, src, torch.float32, mine[b.key].device)
                mine[b.key].copy_(flat[b.lo:b.hi])


def zero_gather(zero: ZeroState, mesh: Mesh, which: str = "master",
                to_all: bool = True) -> Optional[Dict[str, torch.Tensor]]:
    """A rank's local tensors of ``which`` ("master", "mu" or "nu"),
    whole over the data group (every data rank calls it); with ``to_all``
    False on data rank 0 only, on the CPU (None elsewhere)."""
    shards = getattr(zero, which)
    out = {}
    for b in zero.buckets:
        flat = (mesh.all_gather_data(shards[b.key]) if to_all
                else mesh.gather_data(shards[b.key]))
        if flat is not None:
            out.update({k: v.clone() for k, v in unflatten(b, flat).items()})
    return out if to_all or mesh.data_rank == 0 else None


@torch.no_grad()
def zero_grads(zero: ZeroState, grads: Dict[str, torch.Tensor], mesh: Mesh
               ) -> Dict[str, torch.Tensor]:
    """Each trainable bucket's gradient shard: the local gradients (by
    name) flattened in fp32 and reduce-scattered (summed) over the data
    group."""
    out = {}
    for b in zero.buckets:
        if b.trainable:
            dev = zero.master[b.key].device
            out[b.key] = mesh.reduce_scatter_data(
                flatten(b, grads, torch.float32, dev))
    return out


@torch.no_grad()
def zero_norms(zero: ZeroState, shards: Dict[str, torch.Tensor], mesh: Mesh
               ) -> Dict[str, torch.Tensor]:
    """Squared L2 norms of whole tensors, per bucket key, from the shards
    (``shards`` by bucket key, e.g. :func:`zero_grads`' or the master):
    summed over the data group, and over the model group for the buckets
    split over it; a replicated bucket counts once."""
    keys = [b.key for b in zero.buckets if b.key in shards]
    if not keys:
        return {}
    sq = torch.stack([shards[k].float().square().sum() for k in keys])
    mesh.all_reduce_data(sq)
    split = torch.tensor([b.sharded for b in zero.buckets if b.key in shards],
                         device=sq.device)
    part = torch.where(split, sq, torch.zeros_like(sq))
    mesh.all_reduce_model(part)
    sq = torch.where(split, part, sq)
    return dict(zip(keys, sq.unbind(0)))


@torch.no_grad()
def zero_publish(zero: ZeroState, net: nn.Module, mesh: Mesh) -> None:
    """The compute copy set from the master (rounded to its dtype):
    each bucket's shard all-gathered over the data group into ``net``'s
    parameters, in place."""
    params = dict(net.named_parameters())
    for b in zero.buckets:
        dt = params[b.names[0]].dtype
        whole = mesh.all_gather_data(zero.master[b.key].to(dt))
        views = unflatten(b, whole)
        torch._foreach_copy_([params[n] for n in b.names],
                             [views[n] for n in b.names])


def moment_bytes(zero: ZeroState) -> int:
    """Bytes of this rank's AdamW moments."""
    return sum(t.numel() * t.element_size()
               for d in (zero.mu, zero.nu) for t in d.values())
