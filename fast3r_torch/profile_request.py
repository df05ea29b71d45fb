"""Profile one warm serving request, or one warm training step, of the port
on one GPU.

    python -m fast3r_torch.profile_request [--views 20] [--train] \
        [--model flagship|llama] [--roads fused,plain,two_kernel_mlp] \
        [--seq-ranks N] [--hw 384 512] [--head-chunk N] [--out runs/profile]

For each road it builds the model (``--model``: the flagship, or
``llama``, the flagship with the llama_dec decoder of
``configs/experiment/llama_dec.yaml``) with random weights (seed 0) in
bfloat16 and serves one request of ``--views`` views of ``--hw`` (height,
width: 384x512 by default; 512x512 takes the DPT head's unfused road with
the resize kernel) as a warm-up, then one more under ``torch.profiler`` (CPU
and CUDA activities).  With ``--train`` it instead takes one ``train_step``
(remat, bf16 params and moments, a ``make_dummy_batch`` batch of
``--views`` views of ``--hw``) as the warm-up and profiles the next one:

  * fused: the default configuration (fused-GEMM blocks, whole-MLP kernel);
  * plain: both stacks with ``fused_blocks=False``;
  * two_kernel_mlp: fused blocks with ``PREFER_FUSED_MLP = False``.

With ``--head-chunk N`` the request is one ``fast3r_forward`` call of the
model's configuration over the views with the DPT heads run over chunks of
N views (``head_chunk_views``: the many-view call of
``scripts/bench_1000view.py``; ``--views 1000 --hw 384 512 --head-chunk
25`` is 1000 views of 512x384, S = 768,000 tokens), its outputs left on
the card.

With ``--seq-ranks N`` it profiles the flagship's sequence-sharded request
instead (``fast3r_torch.parallel.make_seq_sharded_forward`` over N ranks
with the ring kernel; the encoder on its fused road, the decoder on the
plain block road), as the road ``seq_sharded``; with ``--train --seq-ranks
N`` the sequence-sharded training step
(``fast3r_torch.parallel.make_seq_sharded_train_step``, remat, the ring
kernels forward and backward, the same roads and batch as ``--train``).

It prints one JSON line per road: the request's or step's wall time (host
clock, profiler on, ending in a synchronise), its peak device memory
(``torch.cuda.max_memory_allocated``), the sum of kernel time, the
device's busy share (kernel time over wall), kernel time by category, the
span on the device of each stage range of ``fast3r_forward`` (encoder,
decoder, heads; ``models.fast3r.STAGES``) and the heaviest kernels by
name; and writes a Chrome trace per road under ``--out``.  It needs a CUDA
device and raises without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from fast3r_torch.data.dummy import make_dummy_batch
from fast3r_torch.inference import Fast3R, inference
from fast3r_torch.models.decoder import sample_random_image_ids
from fast3r_torch.models.fast3r import STAGES, Fast3RConfig, fast3r_forward
from fast3r_torch.models.llama_decoder import LlamaDecoderConfig
from fast3r_torch.nn import fused_block
from fast3r_torch.parallel.sequence import (
    make_seq_sharded_forward,
    make_seq_sharded_train_step,
)
from fast3r_torch.train.step import OptimConfig, init_train_state, train_step

# (category, substrings of the kernel name), first match wins
CATEGORIES = (
    ("ring attention backward kernels", ("ring_bwd_",)),
    ("ring attention kernel", ("ring_attention",)),
    ("attention kernel", ("attention_fwd",)),
    ("attention backward kernels", ("attention_bwd",)),
    # the replay is a launch of the same kernel with extra outputs
    ("fused GEMM kernel (and replay)", ("fused_gemm_kernel",)),
    ("whole-MLP kernel", ("ln_mlp_kernel",)),
    ("LayerNorm kernel", ("ln_fwd_kernel",)),
    ("LayerNorm backward kernel", ("ln_bwd_",)),
    ("trunk kernel", ("trunk_conv_kernel", "conv3x3_f32")),
    ("resize kernel", ("resize_bilinear",)),
    ("library convs", ("conv", "fprop", "dgrad", "wgrad", "implicit",
                       "winograd")),
    ("library GEMMs", ("gemm", "cutlass", "xmma", "cublas", "nvjet")),
    ("copies", ("memcpy", "memset")),
)
# fused_gemm_kernel<prologue, epilogue> by the wrapper it serves
MODES = {"1, 0": "ln_matmul", "1, 1": "ln_matmul gelu", "1, 2": "ln_qkv",
         "1, 3": "ln_qkv_rope", "0, 4": "matmul_residual",
         "2, 0": "rms_qkv3 / rms_matmul", "2, 5": "rms_matmul silu"}


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "elementwise and other"


def kernel_label(name: str) -> str:
    """fused_gemm_kernel<PRO, EPI> by the wrapper it serves."""
    if "fused_gemm_kernel<" in name:
        mode = name.split("fused_gemm_kernel<", 1)[1].split(">", 1)[0]
        return "fused_gemm " + MODES.get(mode.strip(), mode)
    return name[:90]


def _request(model: Fast3R, views: list):
    """One serving request (the work to profile)."""
    return lambda: inference(views, model, verbose=False)


def _chunked_request(model: Fast3R, views: list, head_chunk: int):
    """One ``fast3r_forward`` over the views with the heads chunked (the
    work to profile); the images are on the card in the model's dtype."""
    imgs = torch.cat([v["img"] for v in views])[None].to(
        device=model.device, dtype=model.dtype)
    ids = sample_random_image_ids(None, 1, len(views))

    @torch.inference_mode()
    def run():
        return fast3r_forward(model.params, model.cfg, imgs,
                              head_chunk_views=head_chunk, view_ids=ids)
    return run


def _train_step(model: Fast3R, views: int, hw, seq_ranks: int = 0):
    """One training step from a fixed state and batch of ``views`` views of
    ``hw`` (the work to profile); sequence-sharded over ``seq_ranks`` ranks
    when not 0."""
    opt = OptimConfig(warmup_steps=2, total_steps=1000)
    state = init_train_state(model.params, opt)
    batch = {k: torch.as_tensor(v).cuda() for k, v in
             make_dummy_batch(1, views, *hw, seed=0).items()
             if k in ("imgs", "true_shapes", "pts3d", "valid_mask",
                      "camera_pose")}
    if seq_ranks:
        step = make_seq_sharded_train_step(model.cfg, opt, seq_ranks)
        return lambda: step(state, batch)
    return lambda: train_step(state, batch, model.cfg, opt, remat=True)


def _seq_request(model: Fast3R, views: list, ranks: int):
    """One sequence-sharded request over ``ranks`` ranks (ring kernel)."""
    H, W = views[0]["img"].shape[1:3]
    fwd = make_seq_sharded_forward(model.cfg, ranks, len(views), (H, W))
    imgs = torch.cat([v["img"] for v in views])[None]
    return lambda: fwd(model.params, imgs)


def profile_road(model: Fast3R, road: str, views: list, out_dir: Path,
                 train: bool = False, seq_ranks: int = 0,
                 head_chunk: int = 0) -> dict:
    m = Fast3R(model.cfg.with_fused_blocks(road != "plain"), model.params)
    hw = tuple(views[0]["img"].shape[1:3])
    fused_block.PREFER_FUSED_MLP = road != "two_kernel_mlp"
    try:
        if train:
            work = _train_step(m, len(views), hw, seq_ranks)
        elif seq_ranks:
            work = _seq_request(model, views, seq_ranks)
        elif head_chunk:
            work = _chunked_request(m, views, head_chunk)
        else:
            work = _request(m, views)
        work()  # warm-up of the same size
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            work()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
    finally:
        fused_block.PREFER_FUSED_MLP = True
    peak = torch.cuda.max_memory_allocated()
    by_cat, by_name, stages, total = {}, {}, {}, 0.0
    for evt in prof.key_averages():
        cuda = evt.device_type == torch.autograd.DeviceType.CUDA
        if evt.key in STAGES:  # a range (its span on the device), no kernel
            if cuda:
                us = getattr(evt, "device_time_total", None)
                stages[evt.key] = (evt.cuda_time_total if us is None
                                   else us) / 1e3
            continue
        if not cuda:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if us <= 0:
            continue
        ms = us / 1e3
        total += ms
        cat = category(evt.key)
        by_cat[cat] = by_cat.get(cat, 0.0) + ms
        label = kernel_label(evt.key)
        n, t_ms = by_name.get(label, (0, 0.0))
        by_name[label] = (n + evt.count, t_ms + ms)
    out_dir.mkdir(parents=True, exist_ok=True)
    what = "train" if train else "request"
    prof.export_chrome_trace(str(
        out_dir / f"trace_{what}_{road}_{len(views)}_{hw[0]}x{hw[1]}.json"))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    return {"road": road, "work": what, "views": len(views),
            "head_chunk": head_chunk or None, "wall_ms": wall * 1e3,
            "peak_mem_gb": peak / 1e9,
            "kernel_ms": total, "busy_share": total / (wall * 1e3),
            "stage_device_ms": stages,
            "by_category_ms": dict(sorted(by_cat.items(),
                                          key=lambda kv: -kv[1])),
            "top_kernels": [{"name": k, "calls": n, "ms": t}
                            for k, (n, t) in top]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--views", type=int, default=20)
    ap.add_argument("--roads", default="fused,plain,two_kernel_mlp")
    ap.add_argument("--model", choices=("flagship", "llama"),
                    default="flagship")
    ap.add_argument("--train", action="store_true",
                    help="profile a training step instead of a request")
    ap.add_argument("--seq-ranks", type=int, default=0,
                    help="profile the sequence-sharded request (with "
                         "--train: training step) over this many ranks "
                         "instead")
    ap.add_argument("--hw", type=int, nargs=2, default=(384, 512),
                    metavar=("H", "W"), help="the views' height and width")
    ap.add_argument("--head-chunk", type=int, default=0, metavar="N",
                    help="one fast3r_forward call with the heads over "
                         "chunks of N views instead of inference()")
    ap.add_argument("--out", default="runs/profile")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_request: no CUDA device")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"gpu: {gpu}", flush=True)
    cfg = Fast3RConfig.flagship()
    if args.model == "llama":
        cfg = dataclasses.replace(cfg, decoder=LlamaDecoderConfig())
    model = Fast3R.from_random(cfg, seed=0, dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(args.views)
    H, W = args.hw
    views = [{"img": torch.rand((1, H, W, 3), generator=g) * 2 - 1,
              "true_shape": [[H, W]]} for _ in range(args.views)]
    roads = ["seq_sharded"] if args.seq_ranks else args.roads.split(",")
    for road in roads:
        res = profile_road(model, road, views, Path(args.out), args.train,
                           args.seq_ranks, args.head_chunk)
        res["gpu"], res["model"], res["hw"] = gpu, args.model, [H, W]
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
