"""Sequence parallelism: ring attention, the sequence-sharded serving
forward (the 1000-view path) and the sequence-sharded training step.

Counterpart of ``fast3r_tpu/parallel/sequence.py`` (``_merge_partials``,
``ring_flash_attention``, ``make_seq_sharded_forward``,
``seq_sharded_conf_loss``, ``make_seq_sharded_train_step``).  The fused
N-view token sequence is cut into n shards, one per rank; the fusion
decoder's global attention runs as ring attention (each rank's queries
against every rank's K/V, one shard per epoch, the partials merged by the
exact online-softmax rule); everything else in the decoder is per token,
and the encoder and the DPT heads are per view.

The JAX package runs the ranks as devices of a ``shard_map`` mesh.  Here
the ranks are stacked on one device: the decoder runs on the whole (B, S,
C) sequence, and its attention reads the (B, S, H, D) q, k and v as
rank-stacked ``(n, B, S_loc, H, D)`` shards through their strides (B
samples per rank: JAX's data axis).  With ``ring_impl="rdma"`` that
attention is the differentiable ring of kernels
(:func:`fast3r_torch.parallel.ring_rdma.ring_flash_attention_rdma_diff`:
the forward kernel, and the dq and dk/dv ring kernels in the backward, all
n ranks in one launch each); with ``"plain"`` it is
:func:`ring_flash_attention`, the forward kernel's plain version, whose
autograd stands for JAX's ``"xla"`` ring (:func:`ring_attention_bwd_ref`
is the backward kernels' plain version).  A ``psum`` over the sequence
axis is a reduction over the whole sequence, so the training step is the
single-device step with this decoder.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from fast3r_torch.models.decoder import decoder_forward, sample_random_image_ids
from fast3r_torch.models.dpt_head import dpt_head_forward
from fast3r_torch.models.encoder import encoder_forward
from fast3r_torch.models.fast3r import (
    Fast3RConfig,
    Fast3RNet,
    _chunk_views,
    _concat_chunks,
)
from fast3r_torch.ops.flash_attention import attention_lse_ref
from fast3r_torch.parallel.ring_rdma import HEAD_DIMS as RING_HEAD_DIMS
from fast3r_torch.parallel.ring_rdma import ring_flash_attention_rdma_diff
from fast3r_torch.train.losses import LossConfig, conf_loss_multiview_v2
from fast3r_torch.train.step import OptimConfig, TrainState, train_step

RING_IMPLS = ("rdma", "plain")


def _merge_partials(o1, lse1, o2, lse2):
    """Merge two normalised partial attention results (online softmax): o
    (B, S, H, D), lse (B, H, S) fp32.  Returns o in o1's dtype and the
    merged lse."""
    m = torch.maximum(lse1, lse2)
    w1 = torch.exp(lse1 - m)
    w2 = torch.exp(lse2 - m)
    denom = w1 + w2

    def per_row(w):  # (B, H, S) -> (B, S, H, 1)
        return w.transpose(1, 2)[..., None]

    o = (o1.float() * per_row(w1) + o2.float() * per_row(w2)) / per_row(denom)
    return o.to(o1.dtype), m + torch.log(denom)


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float, epochs: Optional[int] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain ring attention over rank-stacked q, k, v (n, B, S_loc, H, D),
    on any device: the ring kernel's plain version.  For each rank r and
    epoch s, plain attention with lse
    (:func:`fast3r_torch.ops.flash_attention.attention_lse_ref`, what
    ``attention_fwd_lse`` runs on the CPU) of q_r against the K/V of rank
    (r - s) mod n, merged into a running fp32 result.  ``epochs`` (n = 1:
    the self-ring) defaults to n.  Returns o (n, B, S_loc, H, D) in q's
    dtype and lse (n, B * H, S_loc) fp32 (JAX's ring returns o only; the
    lse is the kernel's other output)."""
    n, B, S, H, _ = q.shape
    epochs = n if epochs is None else epochs
    outs, lses = [], []
    for r in range(n):
        o, lse = attention_lse_ref(q[r], k[r], v[r], scale)
        o = o.float()
        for s in range(1, epochs):
            src = (r - s) % n
            o_s, lse_s = attention_lse_ref(q[r], k[src], v[src], scale)
            o, lse = _merge_partials(o, lse, o_s, lse_s)
        outs.append(o.to(q.dtype))
        lses.append(lse.reshape(B * H, S))
    return torch.stack(outs), torch.stack(lses)


def ring_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                          scale: float
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the backward ring kernels, on any device: (dq,
    dk, dv) in q's dtype of rank-stacked q, k, v (n, B, S_loc, H, D) from
    the forward's o and lse (n, B * H, S_loc) and the output gradient do.

    The two rotations of the kernels: in epoch s, rank r's dq adds the
    contribution of the K/V of rank (r - s) mod n (the dq ring), and the
    dk/dv of K/V owner r adds that of the q, do, lse and delta of rank
    (r - s) mod n (the dk/dv ring; both rings hop to the right, so a rank
    holds its left neighbours' payloads in turn).  Each contribution is
    ``attention_bwd_ref``'s arithmetic on one (query shard, key shard)
    block: p = exp(scale q k^T - lse) and ds = p (do v^T - delta) in fp32,
    delta = rowsum(do o) from the rounded o, p and ds rounded to q's dtype
    before their products; the sums across epochs in fp32, dq and dk scaled
    and rounded once."""
    n, B, S, H, _ = q.shape
    dt = q.dtype
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    lse = lse.reshape(n, B, H, S)
    delta = (dof * o.float()).sum(-1).transpose(2, 3)  # (n, B, H, S)
    dq, dk, dv = (torch.zeros_like(qf) for _ in range(3))
    for s in range(n):
        for r in range(n):  # query shard r against key shard (r - s) mod n
            src = (r - s) % n
            sc = torch.einsum("bqhd,bkhd->bhqk", qf[r], kf[src]) * scale
            p = torch.exp(sc - lse[r][..., None])
            dv[src] += torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), dof[r])
            dp = torch.einsum("bqhd,bkhd->bhqk", dof[r], vf[src])
            ds = (p * (dp - delta[r][..., None])).to(dt).float()
            dq[r] += torch.einsum("bhqk,bkhd->bqhd", ds, kf[src])
            dk[src] += torch.einsum("bhqk,bqhd->bkhd", ds, qf[r])
    return (dq * scale).to(dt), (dk * scale).to(dt), dv.to(dt)


def _ring_attention(ring_impl: str, n: int):
    """The decoder blocks' callable attention over the whole sequence: q, k,
    v (B, S, H, D) -> o of the same shape, S = n S_loc.  Rank r's shard is
    tokens [r S_loc, (r+1) S_loc); the ring reads the rank-stacked (n, B,
    S_loc, H, D) shards as a strided view of q, k and v, with no copy."""
    if ring_impl not in RING_IMPLS:
        raise ValueError(f"unknown ring_impl {ring_impl!r}; expected one of "
                         f"{RING_IMPLS}")

    def attn(q, k, v, scale):
        B, S, H, D = q.shape
        q, k, v = (t.unflatten(1, (n, S // n)).transpose(0, 1)
                   for t in (q, k, v))
        if ring_impl == "rdma":
            o = ring_flash_attention_rdma_diff(q, k, v, scale, n)
        else:
            o = ring_flash_attention(q, k, v, scale)[0]
        return o.transpose(0, 1).reshape(B, S, H, D)

    return attn


def seq_sharded_config(cfg: Fast3RConfig, n: int, ring_impl: str = "rdma"
                       ) -> Fast3RConfig:
    """``cfg`` with its decoder sharded over ``n`` ranks: the blocks on the
    plain road with the ring (``ring_impl``: "rdma", the kernels, or
    "plain", the plain ring under autograd) as their attention.  The
    sequence-sharded paths run ``fast3r_forward``'s decoder with it.  The
    llama decoder and an unknown ``ring_impl`` raise."""
    if cfg.decoder_type != "fast3r":
        raise NotImplementedError(
            "the sequence-sharded paths run the fusion decoder only (the JAX "
            "package's have no llama-decoder path)")
    attn = _ring_attention(ring_impl, n)
    return dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, attn_impl=attn, fused_blocks=False))


def _check_ring_head_dim(cfg: Fast3RConfig, ring_impl: str, device) -> None:
    """The ring kernels (K14, csrc/ring_attention.cu and
    ring_attention_bwd.cu) take the head_dims of ``RING_HEAD_DIMS``, every
    head_dim of the repo's configurations: on CUDA a decoder of another
    head_dim raises before the path runs."""
    if (ring_impl == "rdma" and torch.device(device).type == "cuda"
            and cfg.decoder.head_dim not in RING_HEAD_DIMS):
        dims = " or ".join(map(str, RING_HEAD_DIMS))
        raise ValueError(
            f"the ring kernels take head_dim {dims}; this decoder's is "
            f"{cfg.decoder.head_dim} (ring_impl='plain' runs any head_dim)")


def _run_heads(params: Fast3RNet, cfg: Fast3RConfig, tokens: list,
               hw: Tuple[int, int]) -> Dict[str, torch.Tensor]:
    g = dpt_head_forward(params.head_global, cfg.head, tokens, hw)
    res = {"pts3d_in_other_view": g["pts3d"], "conf": g["conf"]}
    if cfg.with_local_head:
        loc = dpt_head_forward(params.head_local, cfg.head, tokens, hw)
        res["pts3d_local"], res["conf_local"] = loc["pts3d"], loc["conf"]
    return res


def make_seq_sharded_forward(cfg: Fast3RConfig, n: int, num_views: int,
                             image_hw: Tuple[int, int],
                             head_chunk_views: Optional[int] = None,
                             ring_impl: str = "rdma", device="cuda"
                             ) -> Callable[..., Dict[str, torch.Tensor]]:
    """The sequence-sharded serving forward over ``n`` ranks.

    Returns ``fwd(params, imgs, view_ids=None)``: ``params`` a
    :class:`~fast3r_torch.models.fast3r.Fast3RNet` on ``device`` (the same
    weights as ``fast3r_forward``; ``utils.convert.params_from_jax`` carries
    JAX's across, and the path adds no parameter), ``imgs`` (1, V, H, W, 3)
    with V = ``num_views`` and (H, W) = ``image_hw``, moved to ``device``
    in the params' dtype; ``view_ids`` (V,) the decoder's image ids, by
    default drawn as the single-device forward draws them at inference
    (:func:`sample_random_image_ids` from a generator seeded 0, or arange
    without random ids).  Returns pts3d_in_other_view (1, V, H, W, 3), conf
    (1, V, H, W) [, pts3d_local, conf_local].

    Rank r holds views [r V/n, (r+1) V/n).  The encoder runs over all ranks'
    views in one call and the heads over all views (in chunks of the
    largest divisor of V/n <= ``head_chunk_views`` when given): both are
    per view, so this is the per-rank computation.  The decoder is
    :func:`seq_sharded_config`'s: the blocks on the plain block road with
    the ring over the rank shards of the sequence as their callable
    attention (``ring_impl``: "rdma", the kernel, or "plain", its plain
    version).  ``device`` is "cuda" unless the caller
    asks for the CPU.  V % n != 0, a batch other than 1 and the llama
    decoder raise.
    """
    if num_views % n != 0:
        raise ValueError(f"views {num_views} % ranks {n} != 0")
    dcfg = seq_sharded_config(cfg, n, ring_impl).decoder
    device = torch.device(device)
    V, (H, W) = num_views, image_hw

    @torch.inference_mode()
    def fwd(params: Fast3RNet, imgs: torch.Tensor,
            view_ids: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        p0 = next(params.parameters())
        if p0.device.type != device.type:
            raise ValueError(f"params are on {p0.device}, the forward on "
                             f"{device}")
        _check_ring_head_dim(cfg, ring_impl, device)
        if imgs.shape[0] != 1:
            raise ValueError("the 1000-view path is B=1 (reference: bs=1 "
                             f"inference), got a batch of {imgs.shape[0]}")
        if tuple(imgs.shape[1:]) != (V, H, W, 3):
            raise ValueError(f"imgs {tuple(imgs.shape)} != (1, {V}, {H}, {W}, 3)")
        if view_ids is None:
            view_ids = (sample_random_image_ids(None, 1, V)[0]
                        if dcfg.random_image_idx_embedding
                        else torch.arange(V, dtype=torch.int32))
        imgs = imgs.to(device=p0.device, dtype=p0.dtype)
        feats, _ = encoder_forward(params.encoder, cfg.encoder,
                                   imgs.reshape(V, H, W, 3))
        P = feats.shape[1]
        fused = feats.reshape(1, V * P, -1)
        ids = torch.as_tensor(view_ids).reshape(V).to(device=fused.device,
                                                      dtype=torch.long)
        out = decoder_forward(params.decoder, dcfg, fused,
                              ids.repeat_interleave(P)[None],
                              is_training=False)
        tokens = [out[h].reshape(V, P, -1) for h in dcfg.hooks]
        cv = _chunk_views(head_chunk_views, V // n) or V
        out = _concat_chunks((_run_heads(params, cfg, [t[c:c + cv]
                                                       for t in tokens],
                                         (H, W)) for c in range(0, V, cv)),
                             0, V)
        return {k: v[None] for k, v in out.items()}

    return fwd


# ---------------------------------------------------------------------------
# the sequence-sharded training step
# ---------------------------------------------------------------------------

def seq_sharded_conf_loss(gts: Dict[str, torch.Tensor],
                          preds: Dict[str, torch.Tensor],
                          loss_cfg: LossConfig = LossConfig()) -> torch.Tensor:
    """ConfLossMultiviewV2 over rank-stacked views: gts pts3d (n, B, V_loc,
    H, W, 3), valid_mask (n, B, V_loc, H, W), camera_pose (n, B, V_loc, 4,
    4); preds pts3d_in_other_view, conf [, pts3d_local, conf_local] of the
    same layout.  Rank r holds views [r V_loc, (r+1) V_loc) of every sample.
    Returns the scalar loss.

    On stacked ranks the JAX package's psums and its all_gather of the
    anchor pose are reductions over the unstacked (B, V) views, so this is
    :func:`~fast3r_torch.train.losses.conf_loss_multiview_v2` on them: the
    anchor is view 0, the joint 'avg_dis' factors are per sample over all
    ranks' views, the per-view means pool the B samples (JAX's data axis),
    and the local branch is per (sample, view) whatever
    ``local_scale_consistent`` says, as in the JAX package."""
    def unstack(x):  # (n, B, V_loc, ...) -> (B, V, ...)
        return torch.as_tensor(x).transpose(0, 1).flatten(1, 2)

    loss, _ = conf_loss_multiview_v2(
        {k: unstack(v) for k, v in gts.items()},
        {k: unstack(v) for k, v in preds.items()},
        dataclasses.replace(loss_cfg, local_scale_consistent=False))
    return loss


def make_seq_sharded_train_step(cfg: Fast3RConfig, optim_cfg: OptimConfig,
                                n: int, loss_cfg: Optional[LossConfig] = None,
                                remat: bool = True, ring_impl: str = "rdma",
                                device="cuda"
                                ) -> Callable[..., Tuple[TrainState, dict]]:
    """The training step with the view sequence sharded over ``n`` ranks,
    the long-sequence training path.

    Returns ``step(state, batch, view_ids=None) -> (state, metrics)``:
    ``state`` from :func:`fast3r_torch.train.step.init_train_state` with
    params on ``device``; ``batch`` imgs (B, V, H, W, 3), pts3d, valid_mask,
    camera_pose [, true_shapes] (landscape views, tensors or numpy arrays);
    ``view_ids`` (B, V) replace the decoder image ids drawn, as
    ``train_step`` draws them, by :func:`sample_random_image_ids` from
    ``state.generator``.  B >= 1 samples stand for the JAX step's data axis
    (a 2D data x seq mesh).

    This is :func:`~fast3r_torch.train.step.train_step` (``remat``) with
    the decoder of :func:`seq_sharded_config` (``ring_impl``) and the loss
    of :func:`seq_sharded_conf_loss` (``local_scale_consistent`` off): with
    the ranks stacked on one device a rank's shard is a strided view of the
    decoder's sequence, and every cross-rank reduction a reduction over the
    whole batch.  The llama decoder, V % n != 0 and params on another device
    raise.
    """
    scfg = seq_sharded_config(cfg, n, ring_impl)
    loss_cfg = dataclasses.replace(loss_cfg or LossConfig(),
                                   local_scale_consistent=False)
    device = torch.device(device)

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             view_ids: Optional[torch.Tensor] = None
             ) -> Tuple[TrainState, dict]:
        p0 = next(state.params.parameters())
        if p0.device.type != device.type:
            raise ValueError(f"params are on {p0.device}, the step on "
                             f"{device}")
        _check_ring_head_dim(cfg, ring_impl, device)
        B, V, H, W = batch["imgs"].shape[:4]
        if V % n != 0:
            raise ValueError(f"views {V} % ranks {n} != 0")
        if "true_shapes" not in batch:
            batch = dict(batch, true_shapes=torch.tensor(
                [H, W], dtype=torch.int32).expand(B, V, 2))
        return train_step(state, batch, scfg, optim_cfg, loss_cfg,
                          remat=remat, view_ids=view_ids)

    return step
