"""Fast3R: N images -> per-view global + local pointmaps and confidence.

Counterpart of ``fast3r_tpu/models/fast3r.py``: CroCo encoder (or the
DINOv2 ViT-L/14 of the ``encoder_type: dino`` variant when ``cfg.encoder``
is a ``DinoEncoderConfig``) -> fusion
decoder (the ViT decoder, or the llama decoder of the ``llama_dec``
ablation when ``cfg.decoder`` is a ``LlamaDecoderConfig``) -> two DPT heads
("global": pts3d in view 0's frame, "local": pts3d in each view's own
frame), with the transpose-to-landscape handling of mixed portrait /
landscape batches.

Outputs, stacked per view: pts3d_in_other_view (B, V, H, W, 3),
conf (B, V, H, W) >= 1, pts3d_local, conf_local.  ``fast3r_forward`` is
differentiable (the training step's forward); ``inference`` runs it under
``torch.inference_mode``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Union

import torch
from torch import nn
from torch.profiler import record_function

from fast3r_torch.models.decoder import (
    Decoder,
    DecoderConfig,
    decoder_forward,
    sample_random_image_ids,
)
from fast3r_torch.models.dino_encoder import (
    DinoEncoder,
    DinoEncoderConfig,
    dino_encoder_forward,
)
from fast3r_torch.models.dpt_head import DPTHead, DPTHeadConfig, dpt_head_forward
from fast3r_torch.models.encoder import Encoder, EncoderConfig, encoder_forward
from fast3r_torch.models.llama_decoder import (
    LlamaDecoder,
    LlamaDecoderConfig,
    llama_decoder_forward,
)
from fast3r_torch.nn.layers import has_dropout, init_params_

# the forward's record_function ranges (a profile's per-stage device time)
STAGES = ("fast3r.encoder", "fast3r.decoder", "fast3r.heads")


@dataclasses.dataclass(frozen=True)
class Fast3RConfig:
    encoder: Union[EncoderConfig, DinoEncoderConfig] = EncoderConfig()
    decoder: Union[DecoderConfig, LlamaDecoderConfig] = DecoderConfig()
    head: DPTHeadConfig = DPTHeadConfig()
    with_local_head: bool = True

    @property
    def decoder_type(self) -> str:
        return ("llama" if isinstance(self.decoder, LlamaDecoderConfig)
                else "fast3r")

    @property
    def encoder_type(self) -> str:
        return "dino" if isinstance(self.encoder, DinoEncoderConfig) else "croco"

    @staticmethod
    def flagship() -> "Fast3RConfig":
        """ViT-L/16 encoder + 1024 x 24 fusion decoder + dual DPT heads, both
        stacks on their default fused-GEMM blocks (``fused_blocks=True``),
        as the JAX package's flagship; :meth:`with_fused_blocks` gives the
        plain block composition."""
        enc = EncoderConfig(embed_dim=1024, num_heads=16, depth=24,
                            attn_impl="batched")
        dec = DecoderConfig(enc_embed_dim=1024, embed_dim=1024, num_heads=16,
                            depth=24, attn_impl="pallas")
        head = DPTHeadConfig(dim_tokens=(enc.embed_dim, dec.embed_dim,
                                         dec.embed_dim, dec.embed_dim))
        return Fast3RConfig(encoder=enc, decoder=dec, head=head)

    def with_fused_blocks(self, fused: bool) -> "Fast3RConfig":
        """This configuration with ``fused_blocks`` set in both stacks (the
        DINO encoder has one road and keeps it)."""
        enc = (self.encoder if self.encoder_type == "dino" else
               dataclasses.replace(self.encoder, fused_blocks=fused))
        return dataclasses.replace(
            self, encoder=enc,
            decoder=dataclasses.replace(self.decoder, fused_blocks=fused))

    @staticmethod
    def tiny(with_local_head: bool = True) -> "Fast3RConfig":
        """Small config for tests: the JAX package's ``tiny()`` widths."""
        enc = EncoderConfig(embed_dim=64, num_heads=2, depth=2)
        dec = DecoderConfig(enc_embed_dim=64, embed_dim=64, num_heads=2,
                            depth=4)
        head = DPTHeadConfig(dim_tokens=(64, 64, 64, 64), feature_dim=32,
                             last_dim=16, layer_dims=(8, 16, 24, 32))
        return Fast3RConfig(encoder=enc, decoder=dec, head=head,
                            with_local_head=with_local_head)


class Fast3RNet(nn.Module):
    """All parameters: encoder, decoder, head_global [, head_local]."""

    def __init__(self, cfg: Fast3RConfig):
        super().__init__()
        self.encoder = (DinoEncoder(cfg.encoder) if cfg.encoder_type == "dino"
                        else Encoder(cfg.encoder))
        self.decoder = (LlamaDecoder(cfg.decoder) if cfg.decoder_type == "llama"
                        else Decoder(cfg.decoder))
        self.head_global = DPTHead(cfg.head)
        if cfg.with_local_head:
            self.head_local = DPTHead(cfg.head)


def empty_fast3r(cfg: Fast3RConfig, device="cuda") -> Fast3RNet:
    """Fast3RNet with uninitialised float32 storage on ``device``."""
    with torch.device("meta"):
        net = Fast3RNet(cfg)
    return net.to_empty(device=device)


def init_fast3r(cfg: Fast3RConfig, seed: int = 0, dtype=torch.float32,
                device="cuda") -> Fast3RNet:
    """Random parameters with the JAX package's initialisation scheme, drawn
    on the CPU from a ``torch.Generator`` seeded ``seed`` (so the same seed
    gives the same weights on any device), then cast to ``dtype`` and moved
    to ``device``."""
    net = empty_fast3r(cfg, device="cpu")
    init_params_(net, torch.Generator().manual_seed(seed))
    return net.to(device=device, dtype=dtype).eval()


def _run_head_oriented(head_params, head_cfg, hook_tokens, H, W,
                       is_portrait=None, mixed_orientation=False):
    """transpose-to-landscape: run at (H, W); for mixed batches also at
    (W, H) with transposed outputs, selected per sample by ``is_portrait``."""
    res_l = dpt_head_forward(head_params, head_cfg, hook_tokens, (H, W))
    if not mixed_orientation:
        return res_l
    res_p = dpt_head_forward(head_params, head_cfg, hook_tokens, (W, H))
    out = {}
    for k in res_l:
        p = res_p[k].transpose(1, 2)
        sel = is_portrait.reshape((-1,) + (1,) * (res_l[k].dim() - 1))
        out[k] = torch.where(sel, p, res_l[k])
    return out


def _chunk_views(head_chunk_views: Optional[int], V: int) -> Optional[int]:
    """Round the head chunk down to the largest divisor of V; None when one
    chunk covers all views."""
    if head_chunk_views is None or V <= 1:
        return None
    cv = max(d for d in range(1, min(head_chunk_views, V) + 1) if V % d == 0)
    return None if cv == V else cv


def _concat_chunks(chunks: Iterable[Dict[str, torch.Tensor]], dim: int,
                   total: int) -> Dict[str, torch.Tensor]:
    """Each output's chunks concatenated along ``dim`` (``total`` long),
    each chunk copied into the output as it comes: the chunks' results are
    never all held beside the output (at 1000 views of 512x384 the four
    outputs are 6.3 GB in fp32).  Differentiable (a copy into a slice)."""
    out: Dict[str, torch.Tensor] = {}
    off = 0
    for res in chunks:
        for k, v in res.items():
            if k not in out:
                shape = list(v.shape)
                shape[dim] = total
                out[k] = v.new_empty(shape)
            out[k].narrow(dim, off, v.shape[dim]).copy_(v)
        off += v.shape[dim]
    return out


def freeze_mask(params: Fast3RNet, cfg: Fast3RConfig,
                freeze: str) -> Dict[str, bool]:
    """Trainability of every parameter, by name (True = trainable): the
    counterpart of ``fast3r_tpu``'s ``freeze_mask`` (reference
    ``set_freeze``): "none" trains everything, "encoder" freezes the
    encoder, "sandwich" freezes the encoder and the global head."""
    frozen = {"none": (), "encoder": ("encoder",),
              "sandwich": ("encoder", "head_global")}[freeze]
    return {name: name.split(".", 1)[0] not in frozen
            for name, _ in params.named_parameters()}


def fast3r_forward(params: Fast3RNet, cfg: Fast3RConfig, imgs: torch.Tensor,
                   true_shapes: Optional[torch.Tensor] = None,
                   mixed_orientation: bool = False,
                   head_chunk_views: Optional[int] = None,
                   view_ids: Optional[torch.Tensor] = None,
                   is_training: bool = False, remat: bool = False,
                   generator: Optional[torch.Generator] = None, mesh=None
                   ) -> Dict[str, torch.Tensor]:
    """The forward, for inference and for training (differentiable).

    Args:
      imgs: (B, V, H, W, 3) normalised images, landscape storage layout, on
        the parameters' device and in their dtype.
      true_shapes: (B, V, 2) int (h, w); defaults to the storage shape.
      mixed_orientation: set iff the batch holds portrait samples.
      head_chunk_views: run the heads over groups of this many views (rounded
        down to a divisor of V) to bound memory.
      view_ids: (B, V) image ids for the decoder's index embedding (the
        llama decoder's rotary index); when None, drawn before the encoder
        runs by :func:`sample_random_image_ids` from ``generator``
        (training needs one) or, at inference, from a generator seeded 0
        (on a ``mesh`` for the global batch, of which this data rank takes
        its rows); past ``MAX_IMAGE_IDX`` views the draw raises.
        The llama decoder's view-0 mask reads the views' order (arange
        ids).
      is_training: the decoder's training softmax scale (no entropy bias;
        the llama decoder has none in either case).
      remat: recompute the plain road's blocks in the backward.
      generator: a training forward's CPU generator.  When a stack sets a
        dropout rate, two seeds are drawn from it first (one a stack, as the
        JAX package splits its rng only then) for the blocks' dropout; the
        image ids follow.
      mesh: a ``parallel.mesh.Mesh``; ``imgs`` are this data rank's rows
        of the global batch, and with ``model > 1`` ``params`` are this
        rank's slices (``parallel.mesh.shard_params``) and both stacks run
        tensor-parallel (any encoder and decoder, dropout on the plain
        road), the heads replicated, and so is a block sublayer whose
        heads, llama kv heads or MLP hidden ``model`` does not divide.
        What that road does not run (the sequence-sharded decoder) raises
        ``parallel.mesh.TensorParallelError``.

    Returns pts3d_in_other_view (B, V, H, W, 3), conf (B, V, H, W)
    [, pts3d_local, conf_local].  The encoder, decoder and heads run under
    ``torch.profiler.record_function`` ranges named ``STAGES``.
    """
    B, V, H, W, _ = imgs.shape
    if mesh is not None:
        mesh.check_model_config(cfg)
    if true_shapes is None:
        true_shapes = torch.tensor([H, W], dtype=torch.int32).expand(B, V, 2)
    flat_shapes = true_shapes.reshape(B * V, 2)
    enc_gen = dec_gen = None
    if is_training and generator is not None and (
            has_dropout(cfg.encoder) or has_dropout(cfg.decoder)):
        enc_gen, dec_gen = (torch.Generator().manual_seed(int(torch.randint(
            0, 2 ** 63 - 1, (), generator=generator))) for _ in range(2))
    view_ids = _view_ids(cfg, B, V, view_ids, is_training, generator, mesh)
    with record_function(STAGES[0]):
        if cfg.encoder_type == "dino":
            feats, _ = dino_encoder_forward(params.encoder, cfg.encoder,
                                            imgs.reshape(B * V, H, W, 3),
                                            flat_shapes, mesh=mesh)
        else:
            feats, _ = encoder_forward(params.encoder, cfg.encoder,
                                       imgs.reshape(B * V, H, W, 3),
                                       flat_shapes, remat=remat,
                                       generator=enc_gen, mesh=mesh)
    P = feats.shape[1]
    fused = feats.reshape(B, V * P, -1)
    image_ids = view_ids.to(fused.device).repeat_interleave(P, dim=1)
    with record_function(STAGES[1]):
        if cfg.decoder_type == "llama":
            order = torch.arange(V, device=fused.device).expand(B, V)
            dec_out = llama_decoder_forward(
                params.decoder, cfg.decoder, fused,
                order.repeat_interleave(P, dim=1), rope_ids=image_ids,
                remat=remat, mesh=mesh)
        else:
            dec_out = decoder_forward(params.decoder, cfg.decoder, fused,
                                      image_ids, is_training=is_training,
                                      remat=remat, generator=dec_gen,
                                      mesh=mesh)
    hook_seq = [dec_out[h] for h in cfg.decoder.hooks]  # each (B, V*P, C)
    is_portrait = ((flat_shapes[:, 1] < flat_shapes[:, 0]).to(imgs.device)
                   if mixed_orientation else None)

    def run_heads(tokens, portrait_mask):
        res = {}
        g = _run_head_oriented(params.head_global, cfg.head, tokens, H, W,
                               portrait_mask, mixed_orientation)
        res["pts3d_in_other_view"] = g["pts3d"]
        if "conf" in g:
            res["conf"] = g["conf"]
        if cfg.with_local_head:
            loc = _run_head_oriented(params.head_local, cfg.head, tokens, H, W,
                                     portrait_mask, mixed_orientation)
            res["pts3d_local"] = loc["pts3d"]
            if "conf" in loc:
                res["conf_local"] = loc["conf"]
        return res

    cv = _chunk_views(head_chunk_views, V)
    with record_function(STAGES[2]):
        if cv is None:
            tokens = [t.reshape(B * V, P, -1) for t in hook_seq]
            res = run_heads(tokens, is_portrait)
            return {k: v.reshape((B, V) + v.shape[1:])
                    for k, v in res.items()}

        def chunk(c):
            toks = [t.reshape(B, V, P, -1)[:, c * cv:(c + 1) * cv]
                     .reshape(B * cv, P, -1) for t in hook_seq]
            pmask = (is_portrait.reshape(B, V)[:, c * cv:(c + 1) * cv]
                     .reshape(-1) if is_portrait is not None else None)
            return {k: v.reshape((B, cv) + v.shape[1:])
                    for k, v in run_heads(toks, pmask).items()}

        return _concat_chunks((chunk(c) for c in range(V // cv)), 1, V)


def _view_ids(cfg: Fast3RConfig, B: int, V: int,
              view_ids: Optional[torch.Tensor], is_training: bool,
              generator: Optional[torch.Generator], mesh) -> torch.Tensor:
    """fast3r_forward's (B, V) decoder image ids: with random ids
    ``view_ids``, else drawn; without, arange."""
    if not cfg.decoder.random_image_idx_embedding:
        return torch.arange(V, dtype=torch.int32).expand(B, V)
    if view_ids is None:
        if is_training and generator is None:
            raise ValueError("a training forward needs view_ids or a "
                             "generator to draw them")
        if mesh is None:
            return sample_random_image_ids(generator, B, V)
        # the global batch's, this data rank's rows of them
        from fast3r_torch.parallel.mesh import batch_rows

        ids = sample_random_image_ids(generator, B * mesh.data, V)
        return ids[batch_rows(mesh, B * mesh.data)]
    return view_ids
