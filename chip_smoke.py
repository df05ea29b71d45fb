"""Smoke run of the PyTorch port (fast3r_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written kernels from ``fast3r_torch/csrc`` and
``fast3r_torch/ops`` and runs its phases, synchronising after each and
printing each one's seconds:

  1. device: the card's name and power limit, torch / CUDA versions, the
     kernel build time and what ptxas reports for every kernel; for the
     Hopper kernels (``fused_gemm_kernel<PRO, EPI>``, ``ln_mlp_kernel``,
     the attention backward's ``attention_bwd_dq_kernel`` and
     ``attention_bwd_dkv_kernel`` and the bf16 backward rings
     ``ring_bwd_dq_kernel<bf16>`` and ``ring_bwd_dkv_kernel<bf16>``) their
     registers, spills and dynamic shared memory, and the counts of HGMMA
     (wgmma) and UTMALDG (TMA load) instructions in their SASS
     (``cuobjdump -sass`` on the built library), each of which must be
     above 0;
  2. kernels: each kernel against its plain PyTorch version on the card at
     the flagship forward's and training step's shapes, in float32 (tight
     tolerance, where the kernel has an fp32 variant) and bfloat16 (the
     served and trained type), with max
     abs / rel errors, median CUDA-event times of the kernel, of the plain
     version and of the PyTorch library calls that compute the same
     function (named in each line), and the kernel's bound: the larger of
     its FLOPs over the card's 989 TFLOP/s bf16 peak and its bytes (inputs
     read once, outputs written once) over 3.35 TB/s.  The attention
     forward's encoder line (20 views x 768 tokens) is also the plain
     road's batched attention.  The training kernels: the LayerNorm
     backward, the attention backward on the decoder shape (held against
     the plain version one head at a time: its score matrices would not
     fit at once) and from the encoder's packed buffer, each line with its
     dq and dk/dv kernels' device times (profiler) and their TFLOP/s over
     the products each runs (3 and 4), and the LN -> GEMM replay on the
     qkv, RoPE and fc1 GELU products.  The
     whole-MLP kernel's line also carries its two-kernel road's time, its
     clock64 shares (fc1, fc2 and statistics items, waits) and its time with
     the h ring past the L2 (120 slots instead of 16).  The
     llama decoder's RMS -> GEMM kernels (K13) at its shapes (M = 15360,
     K = 1024): ``rms_qkv3`` (N = 3072, and 1536 with 4 kv heads),
     ``rms_matmul`` with SiLU (w1) and without (w3) at N = 2816, the RMS
     replay (y, u, rstd and z) on the qkv, w1 and w3 products, and
     ``matmul_residual`` at w2's K = 2816;
  3. requests: the flagship model with random weights (seed 0) in bfloat16
     serves ``fast3r_torch.inference`` requests at 512x384 on three paths,
     the launch counts set to 0 just before each path and read just after:
       * fused (the default, fused-GEMM blocks): 2, 8 and 20 views, twice
         each;
       * plain (the plain block road, fused_blocks=False): 20 views, twice;
       * two-kernel MLP (fused blocks with PREFER_FUSED_MLP = False): 8
         views, once;
     outputs must be finite, of the right shapes, with conf >= 1;
  4. end to end: the same weights in float32 on the CPU (the plain
     versions) and in bfloat16 on the card, on the fused and on the plain
     road, answer one 2-view 224x224 request; every output must agree
     within the stated tolerance;
  5. training: the same flagship weights in bfloat16 (and bf16 moments)
     take 4 ``train_step``s of 20 views at 512x384 (remat,
     ``OptimConfig(warmup_steps=2, total_steps=1000)``) on a fixed
     ``make_dummy_batch`` batch on the fused road, then 2 on the plain road
     and 2 on the two-kernel MLP road, the launch counts set to 0 just
     before each road and read just after; every loss and gradient norm
     must be finite and no step skipped;
  6. training end to end: one 2-view 224x224 batch, the loss and each
     top-level group's gradient in bfloat16 on the card (fused and plain
     road) against float32 on the CPU (the plain versions);
  7. llama requests: the ``llama_dec`` model (the flagship with its decoder
     replaced by the 1024 x 24 llama decoder, 653,572,488 parameters),
     random weights (seed 0) in bfloat16, serves 20 views at 512x384 twice
     on the fused road and once on the decoder's plain road
     (``fused_blocks=False`` in the decoder), counts reset and read per
     road;
  8. llama end to end: phase 4 for the llama model;
  9. llama training: 3 ``train_step``s of 20 views on the fused road, each
     step's time and the peak memory;
  10. llama training end to end: phase 6 for the llama model;
  11. a square request: the flagship (random weights, seed 0, bfloat16,
     fused road) serves 20 views at 512x512 twice, the head on its unfused
     road, so the trunk kernel must launch 0 times and the resize kernel
     (K12) once per head call; then once with ``profiling=True`` at
     512x512 and at 384x512 (the trunk kernel's road);
  12. a mixed request: 8 views at 384x512, 6 at 512x384 and 6 at 448x512 in
     one request; the trunk kernel must launch for the first two shape
     groups' heads only and K12 for the third's only;
  13. the head end to end at a K12 shape: ``dpt_head_forward`` on one
     512x512 view from seeded hook tokens, bf16 on the card (unfused road,
     K12) against fp32 on the CPU;
  14. images to poses: ``fast3r_torch.cli.reconstruct`` on 6 seeded
     1152x1008 PNGs (448x512 views) on the card, its poses.json and
     scene.ply checked and each stage timed; ``inference_from_raw`` against
     ``load_images`` + ``inference`` on the same frames; pose recovery on
     the card against fp32 on the CPU for the same predictions (a seeded
     scene of three known cameras at 448x512) and minimal samples;
  15. the ring kernel (K14's forward, ``csrc/ring_attention.cu``) at the
     decoder's shape (15,360 tokens, 16 heads, head dim 64, bf16) over n =
     1, 2, 3, 4 and 8 ranks on the card, and the self-ring (n = 1, 4
     epochs), each against the plain ring (held one head at a time): o
     within the attention tolerance, the natural-log lse within 1e-3 (the
     self-ring's shifted by ln 4); the fp32 variant at n = 4 within 2e-5;
     its time at every n, and at n = 4 the plain ring's, the attention
     kernel's (K1) and SDPA's over the whole gathered sequence, and the
     bound;
  16. the sequence-sharded request: ``make_seq_sharded_forward`` over 4
     ranks with the ring kernel serves the flagship (random weights, seed
     0, bf16) 20 views at 384x512, once cold and twice warm, counts reset
     just before and read just after (24 ring launches and no decoder
     attention-kernel launch per request); its outputs within 2% (relative
     L2) of the single-device forward on the card with the same weights and
     decoder block road (also timed, warm), and a 2-view 224x224 request
     over 2 ranks within 5% of fp32 on the CPU;
  17. the backward ring kernels (K14's backward: the dq and dk/dv rings,
     ``csrc/ring_attention_bwd.cu``) at the decoder's shape over n = 1, 2,
     3, 4 and 8 ranks, in bf16 and fp32, against ``ring_attention_bwd_ref``
     (held one head at a time), each ring's time and TFLOP/s over the
     products it runs (dq 3, dk/dv 4) and the pair's; at n = 4 the plain
     version's time, K9's and the autograd of SDPA on the gathered
     sequence, and the bounds;
  18. the sequence-sharded training step: three
     ``make_seq_sharded_train_step`` steps of 20 views over 4 ranks (ring
     kernels, remat), counts reset just before and read just after (K14
     forward 48, each backward ring 24, decoder K1 / K9 0 per step), each
     step's time and the peak memory; and one 2-view 224x224 step's loss
     and gradients within 5% of fp32 on the CPU and of the single-device
     card step;
  19. launch counts: every kernel of a path must have launched on it, the
     RMS kernels on no path but the llama fused road's, K12 on no path of
     384x512 views, the trunk kernel on no path of 512x512 or 448x512
     views, the ring kernels on no path but the sequence-sharded ones.

Any failure raises (exit code 1).  Without a CUDA device the script exits
with code 2 before printing any result.  The last line of standard output
is ``{"ok": true, "device": {...}}``; the line before it holds the card's
name and power limit, and before that one JSON line describes each kernel.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import PIL.Image

import torch
import torch.nn.functional as F

from fast3r_torch import Fast3R, Fast3RConfig, fast3r_forward, inference
from fast3r_torch.cli import reconstruct
from fast3r_torch.data.dummy import make_dummy_batch
from fast3r_torch.eval.pose import estimate_camera_poses
from fast3r_torch.eval.recon import align_local_pts3d_to_global
from fast3r_torch.inference import inference_from_raw
from fast3r_torch.kernels import build
from fast3r_torch.models.decoder import sample_random_image_ids
from fast3r_torch.models.dpt_head import dpt_head_forward
from fast3r_torch.models.llama_decoder import LlamaDecoderConfig
from fast3r_torch.nn import fused_block as fb
from fast3r_torch.ops.batched_attention import (
    packed_qkv_attention,
    packed_qkv_attention_bwd,
)
from fast3r_torch.ops.flash_attention import (
    attention_bwd,
    attention_bwd_ref,
    attention_fwd_lse,
    attention_ref,
    flash_attention,
)
from fast3r_torch.ops.fused_layernorm import (
    fused_layernorm,
    layernorm_bwd,
    layernorm_bwd_ref,
    layernorm_ref,
)
from fast3r_torch.ops.pnp import draw_samples
from fast3r_torch.ops.resize import resize_matmul
from fast3r_torch.ops.resize_kernel import resize_bilinear_kernel
from fast3r_torch.ops.rope2d import (
    expand_rope_tables,
    rope2d_cos_sin,
    rotate_half_lanes,
)
from fast3r_torch.ops.trunk_kernel import _plain_head, fused_regression_head_t
from fast3r_torch.parallel.ring_rdma import (
    _bwd_rows,
    _rdma_forward,
    _ring_backward,
    ring_attention_bwd_dkv,
    ring_attention_bwd_dq,
    ring_flash_attention_rdma,
)
from fast3r_torch.parallel.sequence import (
    make_seq_sharded_forward,
    make_seq_sharded_train_step,
    ring_attention_bwd_ref,
    ring_flash_attention,
    seq_sharded_config,
)
from fast3r_torch.train.losses import conf_loss_multiview_v2
from fast3r_torch.train.step import OptimConfig, init_train_state, train_step
from fast3r_torch.utils.image import load_images, load_images_raw

DEC_SCALE = 0.125 * math.sqrt(math.log(137) / math.log(20))
PEAK_FLOPS = {torch.bfloat16: 989e12,  # H100 SXM: dense bf16 tensor cores
              torch.float32: 67e12}    # fp32 outside the tensor cores
PEAK_BYTES = 3.35e12                   # H100 SXM HBM3
M_TOK, C, HID = 15360, 1024, 4096  # 20 views x 768 tokens; width; MLP hidden
L_HID = 2816  # the llama FFN hidden: round_up(int(2 * 4 * 1024 / 3), 256)

# Tolerances, elementwise |kernel - plain| <= atol + rtol * |plain|.
#  * float32: both sides compute in fp32 and differ only in summation order
#    (and in fast-math exp2 / rsqrt), so a few 1e-6 relative at most.
#  * bfloat16: attention rounds p to bf16 before p @ v where the plain version
#    rounds the normalised weights (both 2^-8 relative per weight, averaged
#    over the keys) and both round the output once; LayerNorm outputs round
#    once from fp32 values that differ in the last fp32 bits (at most one bf16
#    step, 2^-7 relative); the trunk's plain version rounds to bf16 after
#    conv1, the resize matrices, the resize, conv2 and conv3 while the kernel
#    accumulates everything in fp32, so its bound is taken on max |plain|.
TOL = {
    ("attention", torch.float32): dict(atol=1e-4, rtol=0.0),
    ("attention", torch.bfloat16): dict(atol=4e-3, rtol=2 ** -7),
    ("layernorm", torch.float32): dict(atol=1e-4, rtol=1e-5),
    ("layernorm", torch.bfloat16): dict(atol=1e-2, rtol=2 ** -7),
    ("trunk", torch.float32): dict(atol=1e-4, rtol=1e-4),
    ("trunk", torch.bfloat16): dict(atol_of_max=0.03, rtol=0.0),
    # the fused-GEMM kernels (bf16 only): the plain versions round at the
    # same points and differ in summation order, so outputs land at most
    # one bf16 step apart (2^-7 relative), plus a bf16 intermediate (LN
    # output, q / k before RoPE, the MLP's h) on the other side of a step
    # on outputs of magnitude ~1-10
    ("fused_gemm", torch.bfloat16): dict(atol=2e-2, rtol=2 ** -7),
    ("ln_mlp", torch.bfloat16): dict(atol=2e-2, rtol=2 ** -7),
    # training kernels (bf16).  The attention backward's plain version
    # rounds p and ds to bf16 at the kernel's points, from the same o and
    # lse; a p or ds on the other side of a bf16 step moves a gradient,
    # a sum over up to 15360 keys, by a small fraction of its largest value,
    # so the bound is taken on max |plain|.  The LayerNorm backward's dx and
    # the replay's u round once from fp32 values that differ in summation
    # order (one bf16 step); its product and z as the fused-GEMM kernels;
    # the fp32 dweight / dbias sums over 15360 rows in another order.
    ("attention_bwd", torch.bfloat16): dict(atol_of_max=2e-2, rtol=2 ** -7),
    ("layernorm_bwd", torch.bfloat16): dict(atol=1e-2, rtol=2 ** -7),
    ("layernorm_bwd_w", torch.bfloat16): dict(atol_of_max=1e-4, rtol=0.0),
    ("replay_u", torch.bfloat16): dict(atol=1e-2, rtol=2 ** -7),
    ("replay_stats", torch.bfloat16): dict(atol=1e-6, rtol=1e-5),
    # the resize kernel rounds at the plain version's two points (the H
    # pass and the W pass, each a 2-tap fp32 sum); a value within an fp32
    # rounding of a bf16 tie lands one step away: one bf16 step at the
    # output's largest magnitude
    ("resize", torch.bfloat16): dict(bf16_steps_of_max=1, rtol=0.0),
    # the ring kernel's o: the attention kernel's tolerances above (fp32:
    # summation order only, held to 2e-5); its lse: fp32 logsumexp of the
    # same scores (natural log), within 1e-3
    ("ring", torch.float32): dict(atol=2e-5, rtol=0.0),
    ("ring", torch.bfloat16): dict(atol=4e-3, rtol=2 ** -7),
    ("ring_lse", torch.float32): dict(atol=1e-3, rtol=0.0),
    ("ring_lse", torch.bfloat16): dict(atol=1e-3, rtol=0.0),
    # the backward rings in fp32: summation order only (over up to 15360
    # keys or queries), on max |plain|; in bf16 they are held to the
    # attention backward's bound above
    ("ring_bwd", torch.float32): dict(atol_of_max=1e-4, rtol=0.0),
}


def log(msg: str = "") -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def bound(flops: float, nbytes: float, dtype=torch.bfloat16) -> dict:
    """The least time the card could take: FLOPs at the card's peak for
    their type or bytes at the HBM rate, whichever is larger."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_mem = nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_mem),
            "bound_by": "operations" if t_ops >= t_mem else "bytes",
            "flops": flops, "bytes": nbytes}


def median_ms(fn, reps: int) -> float:
    """Median CUDA-event time of fn() over reps launches, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(kind: str, out: torch.Tensor, ref: torch.Tensor, dtype) -> dict:
    a, b = out.float(), ref.float()
    if a.shape != b.shape:
        raise AssertionError(f"{kind}: shape {tuple(a.shape)} != {tuple(b.shape)}")
    if not torch.isfinite(a).all():
        raise AssertionError(f"{kind}: kernel output is not finite")
    tol = TOL[(kind, dtype)]
    err = (a - b).abs()
    top = b.abs().max().item()
    atol = tol.get("atol", 0.0) + tol.get("atol_of_max", 0.0) * top
    if "bf16_steps_of_max" in tol:  # one step = 2^(exponent - 7)
        atol += tol["bf16_steps_of_max"] * 2.0 ** (math.floor(math.log2(top)) - 7)
    bound = atol + tol["rtol"] * b.abs()
    max_abs = err.max().item()
    max_rel = (err / b.abs().clamp(min=1e-6)).max().item()
    ok = bool((err <= bound).all())
    if not ok:
        raise AssertionError(
            f"{kind} {dtype}: max abs err {max_abs:.3e} exceeds tolerance {tol}")
    return {"max_abs_err": max_abs, "max_rel_err": max_rel, "atol": atol,
            "rtol": tol["rtol"]}


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def _sass_tool() -> str:
    """cuobjdump from the CUDA toolkit, or the copy Triton ships."""
    import shutil

    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "cuobjdump"), shutil.which("cuobjdump")]
    try:
        import triton

        cands.append(os.path.join(os.path.dirname(triton.__file__), "backends",
                                  "nvidia", "bin", "cuobjdump"))
    except ImportError:
        pass
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("cuobjdump not found")


def _kernel_label(mangled: str):
    """fused_gemm_kernel<1, 3>, ln_mlp_kernel, attention_bwd_dq_kernel,
    ring_bwd_dkv_kernel<bf16>, ... from a mangled name; None for a kernel
    that is not on wgmma and TMA (the fp32 rings, the others)."""
    if "fused_gemm_kernel" in mangled:
        tail = mangled.split("fused_gemm_kernel", 1)[1]
        modes = tail.split("EE", 1)[0].replace("ILi", "").split("ELi")
        return f"fused_gemm_kernel<{', '.join(modes)}>"
    for name in BWD_KERNELS:
        if name in mangled:
            if name.startswith("ring_"):
                return f"{name}<bf16>" if "bfloat16" in mangled else None
            return name
    return "ln_mlp_kernel" if "ln_mlp_kernel" in mangled else None


# the attention backward's kernels on attention_bwd_tile.cuh (K9; K14's
# backward in bf16)
BWD_KERNELS = ("attention_bwd_dq_kernel", "attention_bwd_dkv_kernel",
               "ring_bwd_dq_kernel", "ring_bwd_dkv_kernel")


def hopper_kernel_report(blog: str) -> dict:
    """ptxas's registers and spills of every fused_gemm_kernel and
    ln_mlp_kernel instantiation, K9's two kernels and the bf16 backward
    rings, their dynamic shared memory, and the counts of HGMMA (wgmma) and
    UTMALDG (TMA load) instructions in their SASS; raises if any of them
    has none of either, or if one of the backward kernels is missing."""
    report, name = {}, None
    for line in blog.splitlines():
        if "Function properties for" in line:
            name = _kernel_label(
                line.split("Function properties for", 1)[1].strip())
            if name:
                report[name] = {"ptxas": []}
        elif name and ("spill" in line or "Used" in line):
            report[name]["ptxas"].append(line.split("info    :")[-1].strip())
    sass = subprocess.run([_sass_tool(), "-sass", str(build.library_path())],
                          capture_output=True, text=True, check=True).stdout
    name = None
    for line in sass.splitlines():
        if "Function :" in line:
            name = _kernel_label(line.split("Function :", 1)[1].strip())
            if name:
                report.setdefault(name, {"ptxas": []}).update(HGMMA=0,
                                                              UTMALDG=0)
        elif name:
            for op in ("HGMMA", "UTMALDG"):
                if op in line:
                    report[name][op] += 1
    bwd = [n if n.startswith("attention") else f"{n}<bf16>"
           for n in BWD_KERNELS]
    missing = [n for n in bwd if n not in report]
    if not report or missing:
        raise AssertionError(f"Hopper kernels missing from the library: "
                             f"{missing or 'all'}")
    lib = build.library()
    gemm_smem, bwd_smem = (lib.fast3r_gemm_smem_bytes(),
                           lib.fast3r_attention_bwd_smem_bytes())
    for name, r in sorted(report.items()):
        r["smem"] = bwd_smem if name in bwd else gemm_smem
        log(f"hopper kernel {name}: {'; '.join(r['ptxas'])}; dynamic shared "
            f"memory {r['smem']} bytes; SASS HGMMA {r.get('HGMMA', 0)}, "
            f"UTMALDG {r.get('UTMALDG', 0)}")
        if not r.get("HGMMA") or not r.get("UTMALDG"):
            raise AssertionError(f"{name}: no HGMMA or no UTMALDG in its SASS")
    return report


def phase_device() -> dict:
    log("== phase 1: device")
    line = gpu_line()
    log(f"gpu: {line}")
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  devices {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    build.library()
    t_build = time.perf_counter() - t0
    log(f"cuda kernels built and loaded in {t_build:.2f} s "
        f"({build.library_path().name})")
    blog = build.library_path().with_suffix(".log").read_text()
    for entry in blog.splitlines():  # registers / spills of every kernel
        if "registers" in entry or "spill" in entry or "Compiling" in entry:
            log("ptxas: " + entry.strip())
    hopper_kernel_report(blog)
    torch.cuda.synchronize()
    return {"gpu": line, "build_s": t_build}


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

def _gen(seed: int) -> torch.Generator:
    return torch.Generator(device="cuda").manual_seed(seed)


def check_attention(results: list) -> None:
    shapes = [("encoder", (20, 768, 16, 64), 0.125),
              ("decoder", (1, 15360, 16, 64), DEC_SCALE)]
    for dtype in (torch.float32, torch.bfloat16):
        for name, (B, N, H, D), scale in shapes:
            g = _gen(1)
            qkv = torch.randn((B, N, 3, H, D), generator=g, device="cuda",
                              dtype=torch.float32).to(dtype)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # strided views
            out = flash_attention(q, k, v, scale)
            ref = attention_ref(q, k, v, scale)
            torch.cuda.synchronize()
            r = compare("attention", out, ref, dtype)
            del ref
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            if name == "encoder":  # also the plain road's batched attention
                r["tpu_kernel"] = ("fast3r_tpu/ops/batched_attention.py:443 "
                                   "_packed_bnhd -> _packed_kernel :340; :199 "
                                   "_run_kernel -> _batched_kernel :105")
            r.update(kernel="attention", case=f"{name} {B}x{N}x{H}x{D}",
                     dtype=str(dtype).split(".")[-1],
                     ms=median_ms(lambda: flash_attention(q, k, v, scale), 10),
                     plain_ms=median_ms(lambda: attention_ref(q, k, v, scale), 3),
                     library="F.scaled_dot_product_attention",
                     library_ms=median_ms(lambda: F.scaled_dot_product_attention(
                         qt, kt, vt, scale=scale), 10),
                     **bound(4.0 * B * H * N * N * D,
                             4 * B * N * H * D * qkv.element_size(), dtype))
            results.append(r)
            log(json.dumps(r))
            del qkv, q, k, v, out, qt, kt, vt
            torch.cuda.empty_cache()


def check_layernorm(results: list) -> None:
    M = M_TOK
    for dtype in (torch.float32, torch.bfloat16):
        for eps in (1e-6, 1e-5):
            g = _gen(2)
            x = (torch.randn((M, C), generator=g, device="cuda") * 3 + 1).to(dtype)
            w = torch.randn((C,), generator=g, device="cuda").to(dtype)
            b = torch.randn((C,), generator=g, device="cuda").to(dtype)
            out = fused_layernorm(x, w, b, eps)
            ref = layernorm_ref(x, w, b, eps)
            torch.cuda.synchronize()
            r = compare("layernorm", out, ref, dtype)
            r.update(kernel="layernorm", case=f"{M}x{C} eps={eps:g}",
                     dtype=str(dtype).split(".")[-1],
                     ms=median_ms(lambda: fused_layernorm(x, w, b, eps), 20),
                     plain_ms=median_ms(lambda: layernorm_ref(x, w, b, eps), 20),
                     library="F.layer_norm",
                     library_ms=median_ms(lambda: F.layer_norm(
                         x, (C,), w, b, eps), 20),
                     **bound(8.0 * M * C, 2 * M * C * x.element_size(),
                             torch.float32))
            results.append(r)
            log(json.dumps(r))


def check_trunk(results: list) -> None:
    n, hh, wc, cin, c1, H, W = 4, 192, 256, 256, 128, 384, 512
    for dtype in (torch.float32, torch.bfloat16):
        g = _gen(3)

        def uni(shape, fan_in):
            bound = 1.0 / math.sqrt(fan_in)
            return ((torch.rand(shape, generator=g, device="cuda") * 2 - 1)
                    * bound).to(dtype)

        x = torch.randn((n, hh, wc, cin), generator=g, device="cuda").to(dtype)
        w1, b1 = uni((c1, cin, 3, 3), 9 * cin), uni((c1,), 9 * cin)
        w2, b2 = uni((c1, c1, 3, 3), 9 * c1), uni((c1,), 9 * c1)
        w3, b3 = uni((4, c1, 1, 1), c1), uni((4,), c1)
        args = (w1, b1, w2, b2, w3, b3, H, W)
        xc = x.permute(0, 3, 1, 2)

        def plain():
            return _plain_head(xc, *args).reshape(n, 4, H * W)

        def library():
            y = F.conv2d(xc, w1, b1, padding=1)
            y = F.interpolate(y, size=(H, W), mode="bilinear",
                              align_corners=True)
            y = F.relu(F.conv2d(y, w2, b2, padding=1))
            return F.conv2d(y, w3, b3).reshape(n, 4, H * W)

        out = fused_regression_head_t(x, *args)
        ref = plain()
        torch.cuda.synchronize()
        r = compare("trunk", out, ref, dtype)
        r.update(kernel="trunk", case=f"{n}x{hh}x{wc}x{cin} -> {H}x{W}",
                 dtype=str(dtype).split(".")[-1],
                 ms=median_ms(lambda: fused_regression_head_t(x, *args), 5),
                 plain_ms=median_ms(plain, 5),
                 library="F.conv2d + F.interpolate(bilinear, align_corners) + "
                         "F.conv2d + F.relu + F.conv2d",
                 library_ms=median_ms(library, 5),
                 **bound(2.0 * (n * hh * wc * c1 * cin * 9
                                + n * H * W * (c1 * c1 * 9 + c1 * 4)),
                         (x.numel() + n * 4 * H * W) * x.element_size(),
                         dtype))
        results.append(r)
        log(json.dumps(r))


def check_resize(results: list) -> None:
    """K12 at the regression trunk's shapes on the unfused road: one view's
    conv1 output at 512x512 and at 448x512 (bf16, 128 channels)."""
    bf = torch.bfloat16
    for shape, (H, W) in (((1, 128, 256, 256), (512, 512)),
                          ((1, 128, 224, 256), (448, 512))):
        x = torch.randn(shape, generator=_gen(9), device="cuda").to(bf)
        out = resize_bilinear_kernel(x, H, W)
        ref = resize_matmul(x, H, W)
        torch.cuda.synchronize()
        b, c, h, w = shape
        r = compare("resize", out, ref, bf)
        r.update(kernel="resize", case=f"{b}x{c}x{h}x{w} -> {H}x{W}",
                 dtype="bfloat16",
                 ms=median_ms(lambda: resize_bilinear_kernel(x, H, W), 50),
                 plain_ms=median_ms(lambda: resize_matmul(x, H, W), 20),
                 library="F.interpolate(bilinear, align_corners=True)",
                 library_ms=median_ms(lambda: F.interpolate(
                     x, size=(H, W), mode="bilinear", align_corners=True), 50),
                 # a 3-flop lerp per H-pass value (b c H w) and per output,
                 # in fp32 on the CUDA cores
                 **bound(3.0 * b * c * H * (w + W),
                         (x.numel() + out.numel()) * 2, torch.float32))
        results.append(r)
        log(json.dumps(r))


def _linear(n_out, n_in, g):
    bound_ = n_in ** -0.5
    w = ((torch.rand((n_out, n_in), generator=g, device="cuda") * 2 - 1)
         * bound_).to(torch.bfloat16)
    b = (torch.randn((n_out,), generator=g, device="cuda") * 0.02).to(
        torch.bfloat16)
    return w, b


def _record(results, kernel, kind, case, out, ref, fn, plain, library,
            library_name, flops, nbytes, reps=10, **extra):
    torch.cuda.synchronize()
    r = compare(kind, out, ref, torch.bfloat16)
    r.update(kernel=kernel, case=case, dtype="bfloat16",
             ms=median_ms(fn, reps), plain_ms=median_ms(plain, 3),
             library=library_name, library_ms=median_ms(library, reps),
             **bound(flops, nbytes), **extra)
    results.append(r)
    log(json.dumps(r))


def check_fused_blocks(results: list) -> None:
    """The fused-GEMM block kernels at the flagship's 20-view shapes: every
    product has M = 15360 rows (20 x 768 encoder tokens, or the decoder's
    fused sequence of the same length), C = 1024, hidden 4096."""
    g = _gen(4)
    bf = torch.bfloat16
    x = (torch.randn((M_TOK, C), generator=g, device="cuda") * 2 + 0.5).to(bf)
    gamma = (1 + 0.1 * torch.randn((C,), generator=g, device="cuda")).to(bf)
    beta = (0.1 * torch.randn((C,), generator=g, device="cuda")).to(bf)
    wqkv, bqkv = _linear(3 * C, C, g)
    wproj, bproj = _linear(C, C, g)
    w1, b1 = _linear(HID, C, g)
    w2, b2 = _linear(C, HID, g)
    # the encoder's RoPE tables: 20 views of 24 x 32 patches
    yy, xx = torch.meshgrid(torch.arange(24), torch.arange(32), indexing="ij")
    pos = torch.stack([yy, xx], -1).reshape(1, -1, 2).repeat(20, 1, 1).cuda()
    cos, sin = rope2d_cos_sin(pos, 64)
    ct, st = expand_rope_tables(cos, sin, C, bf)
    it = 2  # bytes per bf16 element
    qkv_flops = 2.0 * M_TOK * C * 3 * C
    qkv_w_bytes = (3 * C * C + 3 * C + 2 * C) * it

    def ln_linear(w, b, eps):
        return F.linear(F.layer_norm(x, (C,), gamma, beta, eps), w, b)

    def library_rope():
        y = ln_linear(wqkv, bqkv, 1e-6)

        def rope(t):
            t = t.float()
            return (t * ct + rotate_half_lanes(t, 32) * st).to(bf)
        return torch.stack([rope(y[:, :C]), rope(y[:, C:2 * C]), y[:, 2 * C:]])

    args = (x, gamma, beta, wqkv, bqkv, ct, st, 16, 1e-6)
    _record(results, "ln_qkv_rope", "fused_gemm", f"{M_TOK}x{C} -> 3x{C}",
            fb.ln_qkv_rope(*args), fb.ln_qkv_rope_ref(*args),
            lambda: fb.ln_qkv_rope(*args), lambda: fb.ln_qkv_rope_ref(*args),
            library_rope, "F.layer_norm + F.linear + torch elementwise RoPE",
            qkv_flops, qkv_w_bytes + (M_TOK * C * 3 + 3 * M_TOK * C) * it)

    args = (x, gamma, beta, wqkv, bqkv, 1e-5)
    _record(results, "ln_qkv", "fused_gemm", f"{M_TOK}x{C} -> 3x{C}",
            torch.stack(fb.ln_qkv(*args)), torch.stack(fb.ln_qkv_ref(*args)),
            lambda: fb.ln_qkv(*args), lambda: fb.ln_qkv_ref(*args),
            lambda: ln_linear(wqkv, bqkv, 1e-5).split(C, dim=1),
            "F.layer_norm + F.linear", qkv_flops,
            qkv_w_bytes + (M_TOK * C + 3 * M_TOK * C) * it)

    args = (x, gamma, beta, w1, b1, 1e-6)
    _record(results, "ln_matmul", "fused_gemm", f"{M_TOK}x{C} -> {HID} gelu",
            fb.ln_matmul(*args, act="gelu"), fb.ln_matmul_ref(*args, act="gelu"),
            lambda: fb.ln_matmul(*args, act="gelu"),
            lambda: fb.ln_matmul_ref(*args, act="gelu"),
            lambda: F.gelu(ln_linear(w1, b1, 1e-6)),
            "F.layer_norm + F.linear + F.gelu", 2.0 * M_TOK * C * HID,
            (M_TOK * C + HID * C + HID + 2 * C + M_TOK * HID) * it)

    o = (torch.randn((M_TOK, C), generator=g, device="cuda") * 0.5).to(bf)
    args = (o, wproj, bproj, x)
    _record(results, "matmul_residual", "fused_gemm", f"proj {M_TOK}x{C} -> {C}",
            fb.matmul_residual(*args), fb.matmul_residual_ref(*args),
            lambda: fb.matmul_residual(*args),
            lambda: fb.matmul_residual_ref(*args),
            lambda: F.linear(o, wproj, bproj) + x, "F.linear + add",
            2.0 * M_TOK * C * C, (3 * M_TOK * C + C * C + C) * it, reps=20)
    h = fb.ln_matmul(x, gamma, beta, w1, b1, 1e-6, act="gelu")
    args = (h, w2, b2, x)
    _record(results, "matmul_residual", "fused_gemm", f"fc2 {M_TOK}x{HID} -> {C}",
            fb.matmul_residual(*args), fb.matmul_residual_ref(*args),
            lambda: fb.matmul_residual(*args),
            lambda: fb.matmul_residual_ref(*args),
            lambda: F.linear(h, w2, b2) + x, "F.linear + add",
            2.0 * M_TOK * HID * C, (M_TOK * HID + 2 * M_TOK * C + HID * C + C) * it)

    args = (x, gamma, beta, w1, b1, w2, b2, 1e-6)

    def two_kernel():
        hh = fb.ln_matmul(x, gamma, beta, w1, b1, 1e-6, act="gelu")
        return fb.matmul_residual(hh, w2, b2, x)

    # the kernel's clock64 tallies: the fc1 / fc2 / statistics items' shares
    # of the consumers' item time, and the waits for a free h slot, the next
    # item (consumers) and an fc1 band (producer) against the same total
    prof = torch.zeros(6, dtype=torch.int64, device="cuda")
    fb._ln_mlp(*args, prof=prof)
    t_fc1, t_fc2, t_slot, t_item, t_dep, t_stats = prof.tolist()
    busy = t_fc1 + t_fc2 + t_stats
    _record(results, "ln_mlp", "ln_mlp", f"{M_TOK}x{C}, hidden {HID}",
            fb.ln_mlp(*args), fb.ln_mlp_ref(*args),
            lambda: fb.ln_mlp(*args), lambda: fb.ln_mlp_ref(*args),
            lambda: x + F.linear(F.gelu(ln_linear(w1, b1, 1e-6)), w2, b2),
            "F.layer_norm + F.linear + F.gelu + F.linear + add",
            4.0 * M_TOK * C * HID,
            (2 * M_TOK * C + 2 * HID * C + HID + 3 * C) * it,
            two_kernel_ms=median_ms(two_kernel, 10),
            fc1_share=t_fc1 / busy, fc2_share=t_fc2 / busy,
            stats_share=t_stats / busy,
            # h through a 120-slot ring (120 MB, past the 50 MB L2) instead
            # of the default 16 (16 MB)
            ring_past_l2_ms=median_ms(lambda: fb._ln_mlp(*args, slots=120), 10),
            slot_wait_share=t_slot / busy, item_wait_share=t_item / busy,
            fc1_band_wait_share=t_dep / busy)
    del h, o

    # the encoder's attention, read in place from the packed qkv buffer
    B, N, H, D = 20, 768, 16, 64
    qkv3 = torch.randn((3, B, N, C), generator=g, device="cuda").to(bf)
    q, k, v = (qkv3[i].view(B, N, H, D) for i in range(3))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    _record(results, "packed_qkv_attention", "attention",
            f"(3, {B}, {N}, {C}), {H} heads",
            packed_qkv_attention(qkv3, H, 0.125),
            attention_ref(q, k, v, 0.125).reshape(B, N, C),
            lambda: packed_qkv_attention(qkv3, H, 0.125),
            lambda: attention_ref(q, k, v, 0.125),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=0.125),
            "F.scaled_dot_product_attention", 4.0 * B * H * N * N * D,
            4 * B * N * C * it)


TRAIN_SCALE = 0.125  # head_dim ** -0.5: training has no entropy bias


def _rope_tables_20views(dtype):
    """The encoder's flat RoPE lane tables for 20 views of 24 x 32 patches."""
    yy, xx = torch.meshgrid(torch.arange(24), torch.arange(32), indexing="ij")
    pos = torch.stack([yy, xx], -1).reshape(1, -1, 2).repeat(20, 1, 1).cuda()
    cos, sin = rope2d_cos_sin(pos, 64)
    return expand_rope_tables(cos, sin, C, dtype)


def _grad_ms(out, inputs, cot, reps: int) -> float:
    """Median time of one backward through a kept autograd graph."""
    return median_ms(lambda: torch.autograd.grad(out, inputs, cot,
                                                 retain_graph=True), reps)


def check_layernorm_bwd(results: list) -> None:
    """The LayerNorm backward at the block shape (15360, 1024), bf16."""
    g = _gen(5)
    bf, eps = torch.bfloat16, 1e-6
    x = (torch.randn((M_TOK, C), generator=g, device="cuda") * 3 + 1).to(bf)
    w = (1 + 0.1 * torch.randn((C,), generator=g, device="cuda")).to(bf)
    b = (0.1 * torch.randn((C,), generator=g, device="cuda")).to(bf)
    dy = torch.randn((M_TOK, C), generator=g, device="cuda").to(bf)
    dx, dw, db = layernorm_bwd(x, w, dy, eps)
    rdx, rdw, rdb = layernorm_bwd_ref(x, w, dy, eps)
    torch.cuda.synchronize()
    r = compare("layernorm_bwd", dx, rdx, bf)
    rw = [compare("layernorm_bwd_w", u, v, bf) for u, v in ((dw, rdw),
                                                          (db, rdb))]
    xl, wl, bl = (t.detach().clone().requires_grad_() for t in (x, w, b))
    y = F.layer_norm(xl, (C,), wl, bl, eps)
    r.update(kernel="layernorm_bwd", case=f"{M_TOK}x{C}", dtype="bfloat16",
             max_abs_err_dweight_dbias=max(q["max_abs_err"] for q in rw),
             ms=median_ms(lambda: layernorm_bwd(x, w, dy, eps), 20),
             plain_ms=median_ms(lambda: layernorm_bwd_ref(x, w, dy, eps), 5),
             library="autograd of F.layer_norm (dx, dweight, dbias)",
             library_ms=_grad_ms(y, (xl, wl, bl), dy, 20),
             **bound(16.0 * M_TOK * C, 3 * M_TOK * C * 2 + 3 * C * 2 + 2 * C * 4,
                     torch.float32))
    results.append(r)
    log(json.dumps(r))


def _attn_bwd_bound(B, N, H, D):
    """2.5x the forward's 4 B H N^2 D FLOPs (five products); q, k, v, o, do
    read and dq, dk, dv written in bf16, lse and delta in fp32."""
    return bound(10.0 * B * H * N * N * D,
                 8 * B * N * H * D * 2 + 2 * B * H * N * 4)


def _device_ms(fn, names: dict, reps: int = 5) -> dict:
    """Mean device time a call of each kernel whose name contains
    names[key], over reps calls of fn under the profiler: {key: ms}."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(names, 0.0)
    for evt in prof.key_averages():
        us = (getattr(evt, "self_device_time_total", 0)
              or getattr(evt, "self_cuda_time_total", 0))
        for key, sub in names.items():
            if sub in evt.key:
                out[key] += us / reps / 1e3
    return out


def _pass_rates(B, N, H, D, ms: dict) -> dict:
    """The dq pass's and the dk/dv pass's device times and TFLOP/s over the
    products each runs: dq 3 (6 B H N^2 D FLOPs), dk/dv 4 (8)."""
    flops = {"dq": 6.0 * B * H * N * N * D, "dkv": 8.0 * B * H * N * N * D}
    return {**{f"{k}_ms": v for k, v in ms.items()},
            **{f"{k}_tflops": flops[k] / (v * 1e-3) / 1e12
               for k, v in ms.items()}}


ATTN_BWD_PASSES = {"dq": "attention_bwd_dq_kernel",
                   "dkv": "attention_bwd_dkv_kernel"}


def _merge(errs: list) -> dict:
    return {"max_abs_err": max(e["max_abs_err"] for e in errs),
            "max_rel_err": max(e["max_rel_err"] for e in errs),
            "atol": max(e["atol"] for e in errs), "rtol": errs[0]["rtol"]}


def check_attention_bwd(results: list) -> None:
    """The attention backward at the training step's shapes (scale
    head_dim ** -0.5), from the forward kernel's o and lse: the decoder's
    (1, 15360, 16, 64) strided views, held against the plain version one
    head at a time, and the encoder's packed (3, 20, 768, 1024) buffer."""
    bf = torch.bfloat16
    B, N, H, D = 1, M_TOK, 16, 64
    g = _gen(6)
    qkv = torch.randn((B, N, 3, H, D), generator=g, device="cuda").to(bf)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    do = torch.randn((B, N, H, D), generator=g, device="cuda").to(bf)
    o, lse = attention_fwd_lse(q, k, v, TRAIN_SCALE)
    got = attention_bwd(q, k, v, o, lse, do, TRAIN_SCALE)
    torch.cuda.synchronize()

    def plain_head(h):
        sl = slice(h, h + 1)
        return attention_bwd_ref(q[:, :, sl], k[:, :, sl], v[:, :, sl],
                                 o[:, :, sl], lse[:, sl], do[:, :, sl],
                                 TRAIN_SCALE)

    errs = [compare("attention_bwd", a[:, :, h:h + 1], ref, bf)
            for h in range(H) for a, ref in zip(got, plain_head(h))]
    torch.cuda.empty_cache()
    ql, kl, vl = (t.detach().transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    ol = F.scaled_dot_product_attention(ql, kl, vl, scale=TRAIN_SCALE)
    r = dict(_merge(errs), kernel="attention_bwd",
             case=f"decoder {B}x{N}x{H}x{D}", dtype="bfloat16",
             ms=median_ms(lambda: attention_bwd(q, k, v, o, lse, do,
                                                TRAIN_SCALE), 10),
             plain_ms=median_ms(lambda: [plain_head(h) for h in range(H)], 1),
             plain="attention_bwd_ref, one head at a time",
             library="autograd of F.scaled_dot_product_attention",
             library_ms=_grad_ms(ol, (ql, kl, vl), do.transpose(1, 2), 10),
             **_pass_rates(B, N, H, D, _device_ms(
                 lambda: attention_bwd(q, k, v, o, lse, do, TRAIN_SCALE),
                 ATTN_BWD_PASSES)),
             **_attn_bwd_bound(B, N, H, D))
    results.append(r)
    log(json.dumps(r))
    del qkv, q, k, v, do, o, lse, got, ql, kl, vl, ol
    torch.cuda.empty_cache()

    B, N = 20, 768
    qkv3 = torch.randn((3, B, N, C), generator=g, device="cuda").to(bf)
    q, k, v = (qkv3[i].view(B, N, H, D) for i in range(3))
    do = torch.randn((B, N, C), generator=g, device="cuda").to(bf)
    o, lse = attention_fwd_lse(q, k, v, TRAIN_SCALE)
    got = packed_qkv_attention_bwd(qkv3, o, lse, do, H, TRAIN_SCALE)
    ref = attention_bwd_ref(q, k, v, o, lse, do.view(B, N, H, D), TRAIN_SCALE)
    torch.cuda.synchronize()
    errs = [compare("attention_bwd", got[i], ref[i].reshape(B, N, C), bf)
            for i in range(3)]
    del ref
    ql, kl, vl = (t.detach().transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    ol = F.scaled_dot_product_attention(ql, kl, vl, scale=TRAIN_SCALE)
    r = dict(_merge(errs), kernel="packed_qkv_attention_bwd",
             case=f"(3, {B}, {N}, {C}), {H} heads", dtype="bfloat16",
             ms=median_ms(lambda: packed_qkv_attention_bwd(
                 qkv3, o, lse, do, H, TRAIN_SCALE), 10),
             plain_ms=median_ms(lambda: attention_bwd_ref(
                 q, k, v, o, lse, do.view(B, N, H, D), TRAIN_SCALE), 2),
             library="autograd of F.scaled_dot_product_attention",
             library_ms=_grad_ms(ol, (ql, kl, vl),
                                 do.view(B, N, H, D).transpose(1, 2), 10),
             **_pass_rates(B, N, H, D, _device_ms(
                 lambda: packed_qkv_attention_bwd(qkv3, o, lse, do, H,
                                                  TRAIN_SCALE),
                 ATTN_BWD_PASSES)),
             **_attn_bwd_bound(B, N, H, D))
    results.append(r)
    log(json.dumps(r))
    torch.cuda.empty_cache()


def check_replay(results: list) -> None:
    """The replay launch of fused_gemm.cu (the forward that also writes u,
    mean, rstd and, with GELU, z) at the training step's products."""
    g = _gen(7)
    bf, it = torch.bfloat16, 2
    x = (torch.randn((M_TOK, C), generator=g, device="cuda") * 2 + 0.5).to(bf)
    gamma = (1 + 0.1 * torch.randn((C,), generator=g, device="cuda")).to(bf)
    beta = (0.1 * torch.randn((C,), generator=g, device="cuda")).to(bf)
    wqkv, bqkv = _linear(3 * C, C, g)
    w1, b1 = _linear(HID, C, g)
    ct, st = _rope_tables_20views(bf)

    def ln(eps):
        return F.layer_norm(x, (C,), gamma, beta, eps)

    def library_rope():
        y = F.linear(ln(1e-6), wqkv, bqkv)

        def rope(t):
            t = t.float()
            return (t * ct + rotate_half_lanes(t, 32) * st).to(bf)
        return torch.stack([rope(y[:, :C]), rope(y[:, C:2 * C]), y[:, 2 * C:]])

    cases = (
        ("qkv", wqkv, bqkv, None, 1e-5, f"qkv {M_TOK}x{C} -> 3x{C}",
         "F.layer_norm + F.linear",
         lambda: F.linear(ln(1e-5), wqkv, bqkv)),
        ("rope", wqkv, bqkv, (ct, st), 1e-6, f"qkv+rope {M_TOK}x{C} -> 3x{C}",
         "F.layer_norm + F.linear + torch elementwise RoPE", library_rope),
        ("gelu", w1, b1, None, 1e-6, f"fc1 {M_TOK}x{C} -> {HID} gelu",
         "F.layer_norm + F.linear + F.gelu",
         lambda: F.gelu(F.linear(ln(1e-6), w1, b1))),
    )
    for mode, w, b, tables, eps, case, lib_name, lib in cases:
        args = (mode, x, gamma, beta, w, b, eps, tables, 16)
        got = fb._replay(*args)
        ref = fb._replay_ref(*args)
        torch.cuda.synchronize()
        n = w.shape[0]
        errs = [compare("fused_gemm", got[0], ref[0], bf),
                compare("replay_u", got[1], ref[1], bf)]
        errs += [compare("replay_stats", a, c, bf) for a, c in
                 zip(got[2:4], ref[2:4])]
        if mode == "gelu":
            errs.append(compare("fused_gemm", got[4], ref[4], bf))
        nbytes = ((M_TOK * C + n * C + M_TOK * n + M_TOK * C) * it
                  + (n + 2 * C + 2 * M_TOK) * 4
                  + (M_TOK * n * it if mode == "gelu" else 0)
                  + (2 * M_TOK * C * it if mode == "rope" else 0))
        r = dict(errs[0], kernel="ln_matmul_replay", case=case,
                 dtype="bfloat16", max_abs_err_residuals=max(
                     e["max_abs_err"] for e in errs[1:]),
                 ms=median_ms(lambda: fb._replay(*args), 10),
                 plain_ms=median_ms(lambda: fb._replay_ref(*args), 3),
                 library=lib_name, library_ms=median_ms(lib, 10),
                 **bound(2.0 * M_TOK * C * n, nbytes))
        results.append(r)
        log(json.dumps(r))
    torch.cuda.empty_cache()


def check_rms(results: list) -> None:
    """The RMS -> GEMM modes of fused_gemm.cu (K13) at the llama slice's
    shapes, M = 15360, K = 1024, bf16 scale and weights as the model's:
    q | k | v (N = 3072, and 1536 with 4 kv heads), w1 with SiLU and w3
    without (N = 2816), the replay on the qkv, w1 and w3 products, and
    matmul_residual at w2's K = 2816."""
    g = _gen(8)
    bf, it, eps = torch.bfloat16, 2, 1e-5
    x = (torch.randn((M_TOK, C), generator=g, device="cuda") * 2 + 0.5).to(bf)
    gamma = (1 + 0.1 * torch.randn((C,), generator=g, device="cuda")).to(bf)
    wq, wk, wv = (_linear(C, C, g)[0] for _ in range(3))
    w1, w3 = (_linear(L_HID, C, g)[0] for _ in range(2))
    w2 = _linear(C, L_HID, g)[0]

    def rms():
        return F.rms_norm(x, (C,), gamma, eps)

    def io_bytes(n, replay=False, z=False):
        """x, w and gamma read, y written; the replay's u, rstd and z."""
        return ((M_TOK * C + n * C + C + M_TOK * n) * it
                + ((M_TOK * C * it + M_TOK * 4) if replay else 0)
                + (M_TOK * n * it if z else 0))

    for case, kv in (("qkv", C), ("qkv gqa 4 kv heads", C // 4)):
        ws = (wq, wk[:kv], wv[:kv])
        wcat, n = torch.cat(ws), C + 2 * kv
        args = (x, gamma, *ws, eps)
        _record(results, "rms_qkv3", "fused_gemm", f"{case} {M_TOK}x{C} -> {n}",
                torch.cat(fb.rms_qkv3(*args), 1),
                torch.cat(fb.rms_qkv3_ref(*args), 1),
                lambda: fb.rms_qkv3(*args), lambda: fb.rms_qkv3_ref(*args),
                lambda: F.linear(rms(), wcat).split([C, kv, kv], 1),
                "F.rms_norm + F.linear", 2.0 * M_TOK * C * n, io_bytes(n))
    for case, w, act in (("w1 silu", w1, "silu"), ("w3", w3, None)):
        args = (x, gamma, w, eps)
        _record(results, "rms_matmul", "fused_gemm",
                f"{case} {M_TOK}x{C} -> {L_HID}",
                fb.rms_matmul(*args, act=act), fb.rms_matmul_ref(*args, act=act),
                lambda: fb.rms_matmul(*args, act=act),
                lambda: fb.rms_matmul_ref(*args, act=act),
                (lambda: F.silu(F.linear(rms(), w))) if act
                else (lambda: F.linear(rms(), w)),
                "F.rms_norm + F.linear" + (" + F.silu" if act else ""),
                2.0 * M_TOK * C * L_HID, io_bytes(L_HID))
    for case, w, act in (("qkv", torch.cat([wq, wk, wv]), None),
                         ("w1 silu", w1, "silu"), ("w3", w3, None)):
        n = w.shape[0]
        args = (x, gamma, w, eps, act)
        got = fb.rms_matmul_replay(*args)
        ref = fb.rms_matmul_replay_ref(*args)
        torch.cuda.synchronize()
        errs = [compare("fused_gemm", got[0], ref[0], bf),
                compare("replay_u", got[1], ref[1], bf),
                compare("replay_stats", got[2], ref[2], bf)]
        if act:
            errs.append(compare("fused_gemm", got[3], ref[3], bf))
        lib = ((lambda: F.silu(F.linear(rms(), w))) if act
               else (lambda: F.linear(rms(), w)))
        r = dict(errs[0], kernel="rms_matmul_replay",
                 case=f"{case} {M_TOK}x{C} -> {n}", dtype="bfloat16",
                 max_abs_err_residuals=max(e["max_abs_err"] for e in errs[1:]),
                 ms=median_ms(lambda: fb.rms_matmul_replay(*args), 10),
                 plain_ms=median_ms(lambda: fb.rms_matmul_replay_ref(*args), 3),
                 library="F.rms_norm + F.linear" + (" + F.silu" if act else ""),
                 library_ms=median_ms(lib, 10),
                 **bound(2.0 * M_TOK * C * n, io_bytes(n, True, bool(act))))
        results.append(r)
        log(json.dumps(r))
    h = fb.rms_matmul(x, gamma, w1, eps, act="silu")
    zero = torch.zeros((C,), device="cuda", dtype=bf)
    args = (h, w2, zero, x)
    _record(results, "matmul_residual", "fused_gemm",
            f"w2 {M_TOK}x{L_HID} -> {C}",
            fb.matmul_residual(*args), fb.matmul_residual_ref(*args),
            lambda: fb.matmul_residual(*args),
            lambda: fb.matmul_residual_ref(*args),
            lambda: F.linear(h, w2) + x, "F.linear + add",
            2.0 * M_TOK * L_HID * C,
            (M_TOK * L_HID + 2 * M_TOK * C + L_HID * C + C) * it)
    torch.cuda.empty_cache()


def phase_kernels() -> list:
    log("== phase 2: kernels vs plain versions")
    # the plain versions compute fp32 products in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results: list = []
    check_layernorm(results)
    check_attention(results)
    check_trunk(results)
    check_resize(results)
    check_fused_blocks(results)
    check_layernorm_bwd(results)
    check_attention_bwd(results)
    check_replay(results)
    check_rms(results)
    torch.cuda.synchronize()
    return results


# ---------------------------------------------------------------------------
# phases 3-5
# ---------------------------------------------------------------------------

FUSED_CU = "fast3r_torch/csrc/fused_gemm.cu"
KERNELS = {  # name -> (wrapper, route, source, TPU kernel it replaces)
    "attention": (flash_attention, "cuda", "fast3r_torch/csrc/attention_fwd.cu",
                  "fast3r_tpu/ops/flash_attention.py:745 (_fwd_kernel_packed); "
                  "fast3r_tpu/ops/batched_attention.py:340 (_packed_kernel)"),
    "packed_qkv_attention": (
        packed_qkv_attention, "cuda", "fast3r_torch/csrc/attention_fwd.cu",
        "fast3r_tpu/ops/batched_attention.py:497 (_fusedqkv_kernel)"),
    "layernorm": (fused_layernorm, "triton", "fast3r_torch/ops/fused_layernorm.py",
                  "fast3r_tpu/ops/fused_layernorm.py:46 (_fwd_kernel)"),
    "trunk": (fused_regression_head_t, "cuda", "fast3r_torch/csrc/trunk.cu",
              "fast3r_tpu/ops/trunk_kernel.py:165 (_trunk_kern)"),
    "resize": (resize_bilinear_kernel, "cuda", "fast3r_torch/csrc/resize.cu",
               "fast3r_tpu/ops/resize_kernel.py:141 (_resize_kern)"),
    "ln_qkv_rope": (fb.ln_qkv_rope, "cuda", FUSED_CU,
                    "fast3r_tpu/nn/fused_block.py:595 (_ln_qkv_rope_kernel)"),
    "ln_qkv": (fb.ln_qkv, "cuda", FUSED_CU,
               "fast3r_tpu/nn/fused_block.py:276 (_ln_qkv_kernel)"),
    "ln_matmul": (fb.ln_matmul, "cuda", FUSED_CU,
                  "fast3r_tpu/nn/fused_block.py:264 (_ln_matmul_kernel)"),
    "matmul_residual": (fb.matmul_residual, "cuda", FUSED_CU,
                        "fast3r_tpu/nn/fused_block.py:310 (_matmul_res_kernel)"),
    "ln_mlp": (fb.ln_mlp, "cuda", "fast3r_torch/csrc/ln_mlp.cu",
               "fast3r_tpu/nn/fused_block.py:318 (_ln_mlp_kernel)"),
    "layernorm_bwd": (layernorm_bwd, "triton",
                      "fast3r_torch/ops/fused_layernorm.py",
                      "fast3r_tpu/ops/fused_layernorm.py:56 (_bwd_kernel)"),
    "attention_bwd": (
        attention_bwd, "cuda", "fast3r_torch/csrc/attention_bwd.cu",
        "fast3r_tpu/ops/flash_attention.py:874 (_bwd_dq_kernel_packed), "
        ":914 (_bwd_dkv_kernel_packed); :475 (_bwd_dq_kernel), "
        ":520 (_bwd_dkv_kernel)"),
    "packed_qkv_attention_bwd": (
        packed_qkv_attention_bwd, "cuda", "fast3r_torch/csrc/attention_bwd.cu",
        "fast3r_tpu/ops/batched_attention.py:696 (_fusedqkv_bwd_kernel)"),
    "ln_matmul_replay": (
        fb.ln_matmul_replay, "cuda", FUSED_CU,
        "fast3r_tpu/nn/fused_block.py:340 (_ln_matmul_replay_kernel)"),
    "rms_qkv3": (fb.rms_qkv3, "cuda", FUSED_CU,
                 "fast3r_tpu/nn/fused_block.py:300 (_rms_qkv3_kernel)"),
    "rms_matmul": (fb.rms_matmul, "cuda", FUSED_CU,
                   "fast3r_tpu/nn/fused_block.py:288 (_rms_matmul_kernel)"),
    "rms_matmul_replay": (
        fb.rms_matmul_replay, "cuda", FUSED_CU,
        "fast3r_tpu/nn/fused_block.py:712 (_rms_matmul_replay_kernel)"),
    "ring_attention": (
        ring_flash_attention_rdma, "cuda", "fast3r_torch/csrc/ring_attention.cu",
        "fast3r_tpu/parallel/ring_rdma.py:137 (_ring_fwd_kernel, from "
        "_rdma_forward :358)"),
    "ring_attention_bwd_dq": (
        ring_attention_bwd_dq, "cuda", "fast3r_torch/csrc/ring_attention_bwd.cu",
        "fast3r_tpu/parallel/ring_rdma.py:484 (_ring_bwd_dq_kernel, from "
        "_ring_backward :736)"),
    "ring_attention_bwd_dkv": (
        ring_attention_bwd_dkv, "cuda", "fast3r_torch/csrc/ring_attention_bwd.cu",
        "fast3r_tpu/parallel/ring_rdma.py:586 (_ring_bwd_dkv_kernel, from "
        "_ring_backward :776)"),
}
TRAIN_KERNELS = ("layernorm_bwd", "attention_bwd", "packed_qkv_attention_bwd",
                 "ln_matmul_replay")
# the kernels each path of phase 3 must launch
PATHS = {
    "fused": ("attention", "packed_qkv_attention", "layernorm", "trunk",
              "ln_qkv_rope", "ln_qkv", "matmul_residual", "ln_mlp"),
    "plain": ("attention", "layernorm", "trunk"),
    "two_kernel_mlp": ("attention", "packed_qkv_attention", "layernorm",
                       "trunk", "ln_qkv_rope", "ln_qkv", "ln_matmul",
                       "matmul_residual"),
}
# the training roads of phase 5: the forward kernels of the serving road,
# plus the backward kernels and the replay (the plain road has no fused
# products and no packed attention)
PATHS["train"] = PATHS["fused"] + TRAIN_KERNELS
PATHS["train_plain"] = PATHS["plain"] + ("layernorm_bwd", "attention_bwd")
PATHS["train_two_kernel_mlp"] = PATHS["two_kernel_mlp"] + TRAIN_KERNELS
# the llama model (phases 7 and 9): the encoder's fused road, the heads, and
# on the decoder's fused road the RMS kernels, attention and matmul_residual
K13 = ("rms_qkv3", "rms_matmul", "rms_matmul_replay")
LLAMA_ENCODER = ("packed_qkv_attention", "layernorm", "trunk", "ln_qkv_rope",
                 "matmul_residual", "ln_mlp", "attention")
PATHS["llama"] = LLAMA_ENCODER + K13[:2]
PATHS["llama_plain"] = LLAMA_ENCODER
PATHS["llama_train"] = PATHS["llama"] + TRAIN_KERNELS + K13[2:]
# phases 11, 12 and 14: the flagship's fused road at 512x512 (the head's
# unfused road with K12), mixed 384x512 / 512x384 / 448x512 views (both
# roads) and the CLI's 448x512 views (K12)
PATHS["square"] = tuple(k for k in PATHS["fused"] if k != "trunk") + (
    "resize",)
PATHS["mixed"] = PATHS["fused"] + ("resize",)
PATHS["images_to_poses"] = PATHS["square"]
# phase 16: the encoder's fused road, the heads' trunk kernel, and the
# decoder on the plain block road with the ring kernel as its attention
PATHS["seq_sharded"] = ("ring_attention", "packed_qkv_attention", "layernorm",
                        "trunk", "ln_qkv_rope", "matmul_residual", "ln_mlp")
# phase 18: the same forward kernels, K14's backward rings and the encoder's
# fused road's training kernels
RING_BWD = ("ring_attention_bwd_dq", "ring_attention_bwd_dkv")
PATHS["seq_train"] = PATHS["seq_sharded"] + RING_BWD + (
    "layernorm_bwd", "packed_qkv_attention_bwd", "ln_matmul_replay")
SEQ_PATHS = ("seq_sharded", "seq_train")
# K13 launches on the llama fused roads only, K12 on no path of 384x512
# views, the trunk kernel on no path of 512x512 or 448x512 views, K14 on
# the sequence-sharded paths only (its backward on the training one), the
# decoder's K1 / K9 on neither
NO_LAUNCH = {
    path: ((() if path in ("llama", "llama_train") else K13)
           + (() if path in ("square", "mixed", "images_to_poses")
              else ("resize",))
           + (("trunk",) if path in ("square", "images_to_poses") else ())
           + (("attention", "ln_qkv") if path in SEQ_PATHS
              else ("ring_attention",))
           + (("attention_bwd",) if path == "seq_train" else RING_BWD))
    for path in PATHS}
OUT_KEYS = ("pts3d_in_other_view", "conf", "pts3d_local", "conf_local")
# phase 4: |gpu bf16 - cpu fp32| / |cpu fp32| in the L2 norm, per output.
# bf16 keeps 8 bits of mantissa; through 48 blocks and two heads the
# relative error of activations grows to a few 1e-3 .. 1e-2.
E2E_REL_L2 = 0.05


def request_views(n: int, H: int, W: int, seed: int) -> list:
    g = torch.Generator().manual_seed(seed)
    return [{"img": torch.rand((1, H, W, 3), generator=g) * 2 - 1,
             "true_shape": [[H, W]], "idx": i, "instance": str(i)}
            for i in range(n)]


def check_preds(preds: list, shapes: list) -> None:
    """Every output of view i finite, of shape shapes[i], conf >= 1."""
    if len(preds) != len(shapes):
        raise AssertionError(f"{len(preds)} predictions for {len(shapes)} "
                             "views")
    for i, (p, (H, W)) in enumerate(zip(preds, shapes)):
        if set(p) != set(OUT_KEYS):
            raise AssertionError(f"view {i}: outputs {sorted(p)}")
        for k, v in p.items():
            want = (1, H, W, 3) if k.startswith("pts3d") else (1, H, W)
            if tuple(v.shape) != want:
                raise AssertionError(f"view {i} {k}: shape {tuple(v.shape)}")
            if not torch.isfinite(v).all():
                raise AssertionError(f"view {i} {k}: not finite")
        for k in ("conf", "conf_local"):
            if not (p[k] >= 1).all():
                raise AssertionError(f"view {i} {k}: below 1")


def serve_path(path: str, model, sizes, gpu: str) -> dict:
    """Serve the requests of one path with every launch count set to 0
    just before and read just after."""
    _reset_counts()
    for n, serves in sizes:
        # twice per size where asked: the first request of a size also pays
        # its one-off costs (allocator growth, pinned host buffers, conv
        # algorithm picks)
        for serve in range(1, serves + 1):
            _serve(path, model, request_views(n, 384, 512, n + serve), serve,
                   gpu)
    return _read_counts()


def phase_requests(gpu: str):
    log("== phase 3: requests (flagship, random weights seed 0, bfloat16)")
    t0 = time.perf_counter()
    cpu_model = Fast3R.from_random(Fast3RConfig.flagship(), seed=0,
                                   device="cpu")
    model = cpu_model.to(device="cuda", dtype=torch.bfloat16)
    plain = Fast3R(model.cfg.with_fused_blocks(False), model.params)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.params.parameters())
    log(f"model: {n_params} parameters, built and moved in "
        f"{time.perf_counter() - t0:.1f} s")
    for m in (model, plain):  # warm-up
        inference(request_views(2, 384, 512, 99), m, verbose=False)
    counts = {"fused": serve_path("fused", model, ((2, 2), (8, 2), (20, 2)),
                                  gpu),
              "plain": serve_path("plain", plain, ((20, 2),), gpu)}
    fb.PREFER_FUSED_MLP = False
    try:
        counts["two_kernel_mlp"] = serve_path("two_kernel_mlp", model,
                                              ((8, 1),), gpu)
    finally:
        fb.PREFER_FUSED_MLP = True
    return cpu_model, model, plain, counts


def phase_end_to_end(cpu_model, model, plain, phase: str = "phase 4") -> dict:
    log(f"== {phase}: bf16 kernel paths on the card vs fp32 plain versions "
        "on the CPU (serving)")
    views = request_views(2, 224, 224, 7)
    t = time.perf_counter()
    ref = inference(views, cpu_model, verbose=False)["preds"]
    t_cpu = time.perf_counter() - t
    bad = {}
    errs = {}
    for road, m in (("fused", model), ("plain", plain)):
        out = inference(views, m, verbose=False)["preds"]
        torch.cuda.synchronize()
        check_preds(out, [(224, 224)] * 2)
        errs[road] = {}
        for k in OUT_KEYS:
            a = torch.cat([p[k] for p in out])
            b = torch.cat([p[k] for p in ref])
            e = ((a - b).norm() / b.norm()).item()
            errs[road][k] = e
            if not e <= E2E_REL_L2:
                bad[f"{road} {k}"] = e
    log(json.dumps({"rel_l2_err": errs, "tolerance": E2E_REL_L2,
                    "cpu_fp32_s": t_cpu}))
    if bad:
        raise AssertionError(f"end-to-end error above {E2E_REL_L2}: {bad}")
    return errs


BATCH_KEYS = ("imgs", "true_shapes", "pts3d", "valid_mask", "camera_pose")
TRAIN_OPT = OptimConfig(warmup_steps=2, total_steps=1000)


def _reset_counts() -> None:
    torch.cuda.synchronize()
    for fn, *_ in KERNELS.values():
        fn.launches = 0


def _read_counts() -> dict:
    torch.cuda.synchronize()
    return {name: fn.launches for name, (fn, *_) in KERNELS.items()}


def train_road(road: str, net, cfg, batch, steps: int, gpu: str,
               step=None) -> dict:
    """``steps`` train_steps (or ``step(state, batch)``s) from fresh
    optimizer state, the launch counts set to 0 just before and read just
    after; every loss and gradient norm finite, no step skipped."""
    if step is None:
        def step(state, batch):
            return train_step(state, batch, cfg, TRAIN_OPT, remat=True)
    state = init_train_state(net, TRAIN_OPT)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    V = batch["imgs"].shape[1]
    for i in range(steps):
        t = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        rec = {"path": road, "train_step": i + 1, "views": V,
               "image_hw": list(batch["imgs"].shape[2:4]),
               "step_s": time.perf_counter() - t, "loss": float(m["loss"]),
               "grad_norm": float(m["grad_norm"]), "lr": m["lr"],
               "skipped_nonfinite": int(m["skipped_nonfinite"]),
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "gpu": gpu}
        log(json.dumps(rec))
        if rec["skipped_nonfinite"] or not (math.isfinite(rec["loss"])
                                            and math.isfinite(rec["grad_norm"])):
            raise AssertionError(f"{road} step {i + 1} not finite or skipped")
    return _read_counts()


def phase_training(gpu: str, cpu_model) -> dict:
    log("== phase 5: training steps (flagship, random weights seed 0, "
        "bf16 params and moments, 20 views at 512x384, remat)")
    net = cpu_model.to(device="cuda", dtype=torch.bfloat16).params
    cfg = cpu_model.cfg
    batch = {k: torch.as_tensor(v).cuda() for k, v in
             make_dummy_batch(1, 20, 384, 512, seed=0).items()
             if k in BATCH_KEYS}
    counts = {"train": train_road("train", net, cfg, batch, 4, gpu),
              "train_plain": train_road("train_plain", net,
                                        cfg.with_fused_blocks(False), batch, 2,
                                        gpu)}
    fb.PREFER_FUSED_MLP = False
    try:
        counts["train_two_kernel_mlp"] = train_road(
            "train_two_kernel_mlp", net, cfg, batch, 2, gpu)
    finally:
        fb.PREFER_FUSED_MLP = True
    del net, batch
    torch.cuda.empty_cache()
    return counts


# phase 6: |gpu bf16 - cpu fp32| / |cpu fp32|, of the loss and in the L2
# norm of each top-level group's gradient.  Start from the forward's 0.05
# (phase 4): the backward runs through the same 48 bf16 blocks, rounds
# du, dh and each weight gradient to bf16 once more and sums the weight
# gradients over 392 tokens, which adds error of the forward's order.
E2E_TRAIN_REL = 0.05


def _loss_and_grads(net, cfg, batch, ids):
    """The training forward's loss and each top-level group's gradient,
    flattened, fp32 on the CPU."""
    p0 = next(net.parameters())
    b = {k: v.to(p0.device) for k, v in batch.items()}
    with torch.enable_grad():
        preds = fast3r_forward(net, cfg, b["imgs"].to(p0.dtype),
                               batch["true_shapes"], view_ids=ids,
                               is_training=True, remat=True)
        loss, _ = conf_loss_multiview_v2(b, preds)
        return loss.item(), _grads_by_group(net, loss)


def _grads_by_group(net, loss) -> dict:
    """Each top-level group's gradient of loss, flattened, fp32 on the
    CPU."""
    names, ps = zip(*net.named_parameters())
    gs = torch.autograd.grad(loss, ps, allow_unused=True)
    groups: dict = {}
    for n, p, g in zip(names, ps, gs):
        g = torch.zeros_like(p) if g is None else g
        groups.setdefault(n.split(".")[0], []).append(g.float().cpu().reshape(-1))
    return {k: torch.cat(v) for k, v in groups.items()}


def phase_train_end_to_end(cpu_model, plain_cfg,
                           phase: str = "phase 6") -> dict:
    log(f"== {phase}: one training step's loss and gradients, bf16 on the "
        "card vs fp32 plain versions on the CPU")
    batch = {k: torch.as_tensor(v) for k, v in
             make_dummy_batch(1, 2, 224, 224, seed=1).items()
             if k in BATCH_KEYS}
    ids = sample_random_image_ids(torch.Generator().manual_seed(0), 1, 2)
    t = time.perf_counter()
    ref_loss, ref = _loss_and_grads(cpu_model.params, cpu_model.cfg, batch, ids)
    t_cpu = time.perf_counter() - t
    gpu_model = cpu_model.to(device="cuda", dtype=torch.bfloat16)
    errs, bad = {}, {}
    for road, cfg in (("fused", cpu_model.cfg), ("plain", plain_cfg)):
        loss, grads = _loss_and_grads(gpu_model.params, cfg, batch, ids)
        errs[road] = {"loss": abs(loss - ref_loss) / abs(ref_loss),
                      **{f"grad/{k}": ((grads[k] - ref[k]).norm()
                                       / ref[k].norm()).item() for k in ref}}
        bad.update({f"{road} {k}": e for k, e in errs[road].items()
                    if not e <= E2E_TRAIN_REL})
    log(json.dumps({"train_rel_err": errs, "tolerance": E2E_TRAIN_REL,
                    "loss_cpu_fp32": ref_loss, "cpu_fp32_s": t_cpu}))
    del gpu_model
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"training end-to-end error above "
                             f"{E2E_TRAIN_REL}: {bad}")
    return errs


# the slice of phases 7-10: the flagship with its decoder replaced by the
# reference's llama_dec decoder (configs/experiment/llama_dec.yaml)
LLAMA_DEC = LlamaDecoderConfig(
    enc_embed_dim=1024, embed_dim=1024, n_layers=24, n_heads=16,
    n_kv_heads=None, multiple_of=256, norm_eps=1e-5, rope_theta=10000.0,
    max_seq_len=1000, random_image_idx_embedding=True, attn_impl="pallas",
    fused_blocks=True)
LLAMA_PARAMS = 653_572_488


def llama_cfg(fused_decoder: bool = True) -> Fast3RConfig:
    return dataclasses.replace(
        Fast3RConfig.flagship(),
        decoder=dataclasses.replace(LLAMA_DEC, fused_blocks=fused_decoder))


def phase_llama_requests(gpu: str):
    log("== phase 7: llama requests (llama_dec: flagship encoder and heads, "
        "1024 x 24 llama decoder; random weights seed 0, bfloat16)")
    t0 = time.perf_counter()
    cpu_model = Fast3R.from_random(llama_cfg(), seed=0, device="cpu")
    model = cpu_model.to(device="cuda", dtype=torch.bfloat16)
    plain = Fast3R(llama_cfg(fused_decoder=False), model.params)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.params.parameters())
    log(f"model: {n_params} parameters, built and moved in "
        f"{time.perf_counter() - t0:.1f} s")
    if n_params != LLAMA_PARAMS:
        raise AssertionError(f"llama model has {n_params} parameters, "
                             f"expected {LLAMA_PARAMS}")
    for m in (model, plain):  # warm-up
        inference(request_views(2, 384, 512, 98), m, verbose=False)
    counts = {"llama": serve_path("llama", model, ((20, 2),), gpu),
              "llama_plain": serve_path("llama_plain", plain, ((20, 1),), gpu)}
    return cpu_model, model, plain, counts


def phase_llama_training(gpu: str, cpu_model) -> dict:
    log("== phase 9: llama training steps (random weights seed 0, bf16 "
        "params and moments, 20 views at 512x384, fused road)")
    net = cpu_model.to(device="cuda", dtype=torch.bfloat16).params
    batch = {k: torch.as_tensor(v).cuda() for k, v in
             make_dummy_batch(1, 20, 384, 512, seed=0).items()
             if k in BATCH_KEYS}
    counts = {"llama_train": train_road("llama_train", net, cpu_model.cfg,
                                        batch, 3, gpu)}
    del net, batch
    torch.cuda.empty_cache()
    return counts


def _serve(path: str, model, views, serve: int, gpu: str) -> dict:
    """One timed request; its outputs checked."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = inference(views, model, verbose=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    shapes = [tuple(np.asarray(v["true_shape"]).reshape(-1)) for v in views]
    check_preds(out["preds"], shapes)
    rec = {"path": path, "request_views": len(views), "serve": serve,
           "image_hw": sorted({(int(h), int(w)) for h, w in shapes}),
           "latency_s": dt, "images_per_s": len(views) / dt, "gpu": gpu,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(json.dumps(rec))
    return rec


def _expect(path: str, counts: dict, **want) -> None:
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"{path}: launches {got}, expected {want}")


def phase_square(gpu: str):
    log("== phase 11: a square request (flagship, random weights seed 0, "
        "bfloat16, fused road, 20 views at 512x512)")
    t0 = time.perf_counter()
    cpu_model = Fast3R.from_random(Fast3RConfig.flagship(), seed=0,
                                   device="cpu")
    model = cpu_model.to(device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"model built and moved in {time.perf_counter() - t0:.1f} s")
    inference(request_views(2, 512, 512, 97), model, verbose=False)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    for serve in (1, 2):
        _serve("square", model, request_views(20, 512, 512, 200 + serve),
               serve, gpu)
    counts = _read_counts()
    # two requests x two head calls (global, local), all on the unfused road
    _expect("square", counts, trunk=0, resize=4)
    # the stage split at 512x512 (unfused head road) and, for the heads'
    # other road, at 384x512 (trunk kernel)
    for H, W in ((512, 512), (384, 512)):
        result, info = inference(request_views(20, H, W, 203), model,
                                 verbose=False, profiling=True)
        check_preds(result["preds"], [(H, W)] * 20)
        log(json.dumps({"path": "square", "request_views": 20,
                        "image_hw": [H, W], "profiling_info": info,
                        "gpu": gpu}))
    return cpu_model, model, {"square": counts}


def phase_mixed(gpu: str, model) -> dict:
    log("== phase 12: a mixed request (8 views at 384x512, 6 at 512x384, 6 "
        "at 448x512)")
    g = torch.Generator().manual_seed(12)
    views = [{"img": torch.rand((1, H, W, 3), generator=g) * 2 - 1,
              "true_shape": [[H, W]]}
             for n, H, W in ((8, 384, 512), (6, 512, 384), (6, 448, 512))
             for _ in range(n)]
    _reset_counts()
    for serve in (1, 2):
        _serve("mixed", model, views, serve, gpu)
    counts = _read_counts()
    # per request: the heads run once per shape group, global and local;
    # the 384x512 and 512x384 groups on the trunk kernel, 448x512 on K12
    _expect("mixed", counts, trunk=8, resize=4)
    return {"mixed": counts}


def phase_head_end_to_end(cpu_model, model) -> dict:
    log("== phase 13: the head at 512x512, bf16 on the card (unfused road, "
        "K12) vs fp32 on the CPU")
    g = torch.Generator().manual_seed(13)
    toks = [torch.randn((1, 1024, 1024), generator=g) for _ in range(4)]
    hw = (512, 512)
    with torch.inference_mode():
        t = time.perf_counter()
        ref = dpt_head_forward(cpu_model.params.head_global,
                               cpu_model.cfg.head, toks, hw)
        t_cpu = time.perf_counter() - t
        _reset_counts()
        out = dpt_head_forward(model.params.head_global, model.cfg.head,
                               [x.cuda().bfloat16() for x in toks], hw)
        counts = _read_counts()
    _expect("head 512x512", counts, trunk=0, resize=1)
    errs = {k: ((out[k].float().cpu() - ref[k]).norm() / ref[k].norm()).item()
            for k in ref}
    log(json.dumps({"head_rel_l2_err": errs, "tolerance": E2E_REL_L2,
                    "cpu_fp32_s": t_cpu}))
    bad = {k: e for k, e in errs.items() if not e <= E2E_REL_L2}
    if bad:
        raise AssertionError(f"head end-to-end error above {E2E_REL_L2}: "
                             f"{bad}")
    return errs


# phase 14: the device resample against PIL's moves inputs by a few uint8
# steps, and outputs by less than this (relative, L2)
RAW_REL_L2 = 0.02
POSE_ATOL = 1e-3  # card vs CPU, fp32, same predictions and minimal samples


def _photo(h: int, w: int, seed: int) -> np.ndarray:
    """A smooth seeded photo (low-frequency content, as photos have)."""
    rng = np.random.default_rng(seed)
    small = rng.uniform(0, 255, (h // 32, w // 32, 3)).astype(np.uint8)
    return np.asarray(PIL.Image.fromarray(small).resize(
        (w, h), PIL.Image.BICUBIC), np.uint8)


def _read_ply_header(path: str):
    with open(path, "rb") as f:
        lines = []
        while not lines or lines[-1] != b"end_header":
            lines.append(f.readline().strip())
        return [x.decode() for x in lines], f.tell(), os.path.getsize(path)


def phase_images_to_poses(gpu: str, model) -> dict:
    log("== phase 14: images to poses (fast3r_torch.cli.reconstruct on 6 "
        "seeded 1152x1008 PNGs, random flagship weights seed 0, bfloat16)")
    with tempfile.TemporaryDirectory() as tmp:
        images, out_dir = os.path.join(tmp, "images"), os.path.join(tmp, "out")
        os.makedirs(images)
        for i in range(6):
            PIL.Image.fromarray(_photo(1008, 1152, 140 + i)).save(
                os.path.join(images, f"{i:02d}.png"))
        _reset_counts()
        t = time.perf_counter()
        res = reconstruct.main([images, "--out", out_dir])
        total = time.perf_counter() - t
        counts = _read_counts()
        check_preds([{k: p[k] for k in OUT_KEYS} for p in res["preds"]],
                    [(448, 512)] * 6)
        with open(os.path.join(out_dir, "poses.json")) as f:
            poses = json.load(f)
        c2w, focals = np.asarray(poses["poses_c2w"]), np.asarray(
            poses["focals"])
        if c2w.shape != (6, 4, 4) or focals.shape != (6,) or not (
                np.isfinite(c2w).all() and np.isfinite(focals).all()):
            raise AssertionError(f"poses.json: c2w {c2w.shape}, focals "
                                 f"{focals.tolist()}")
        header, start, size = _read_ply_header(os.path.join(out_dir,
                                                            "scene.ply"))
        n = int(header[2].split()[-1])
        if (header[:2] != ["ply", "format binary_little_endian 1.0"]
                or n != res["points"] or n == 0 or size != start + 15 * n):
            raise AssertionError(f"scene.ply: header {header}, {size} bytes, "
                                 f"{res['points']} points")
        log(json.dumps({"path": "images_to_poses", "views": 6,
                        "image_hw": [448, 512], "stage_s": res["times"],
                        "total_s": total, "points": n, "gpu": gpu}))

        # the device resample against PIL, same model and frames
        t = time.perf_counter()
        raw = inference_from_raw(load_images_raw(images, verbose=False),
                                 model, verbose=False)["preds"]
        t_raw = time.perf_counter() - t
        host = inference(load_images(images, size=512, verbose=False), model,
                         verbose=False)["preds"]
        errs = {k: (torch.cat([p[k] for p in raw])
                    - torch.cat([p[k] for p in host])).norm().item()
                / torch.cat([p[k] for p in host]).norm().item()
                for k in OUT_KEYS}
        log(json.dumps({"raw_vs_host_rel_l2": errs, "tolerance": RAW_REL_L2,
                        "inference_from_raw_s": t_raw}))
        if max(errs.values()) > RAW_REL_L2:
            raise AssertionError(f"inference_from_raw vs load_images: {errs}")

    # the CLI's first calls pay one-off costs (the linear-algebra
    # libraries' set-up): its align and pose stages again, warm
    t = time.perf_counter()
    align_local_pts3d_to_global(res["preds"], min_conf_thr_percentile=85.0)
    torch.cuda.synchronize()
    t_align = time.perf_counter() - t
    t = time.perf_counter()
    estimate_camera_poses(res["preds"])
    log(json.dumps({"path": "images_to_poses", "warm_align_s": t_align,
                    "warm_pose_s": time.perf_counter() - t}))

    # pose recovery: the card against fp32 on the CPU on the same
    # predictions and minimal samples.  The random model's pointmaps give an
    # ill-posed problem (any tie between hypotheses decides), so the
    # predictions are a seeded scene seen by known cameras, with noise and
    # confident outliers, at the CLI's view shape
    preds, gt = pose_scene(3, 448, 512, seed=14)
    mask = torch.stack([torch.as_tensor(p["conf"][0]).reshape(-1) > 1.0
                        for p in preds]).cuda()
    idx = draw_samples(mask, 32, 8,
                       torch.Generator(device="cuda").manual_seed(0))
    t = time.perf_counter()
    on_gpu, f_gpu = estimate_camera_poses(preds, device="cuda",
                                          sample_idx=[idx])
    t_gpu = time.perf_counter() - t
    t = time.perf_counter()
    on_cpu, f_cpu = estimate_camera_poses(preds, device="cpu",
                                          sample_idx=[idx.cpu()])
    t_cpu = time.perf_counter() - t
    err = float(np.abs(np.stack(on_gpu[0]) - np.stack(on_cpu[0])).max())
    gt_err = float(np.abs(np.stack(on_gpu[0]) - gt).max())
    log(json.dumps({"pose_gpu_vs_cpu_max_abs": err, "tolerance": POSE_ATOL,
                    "pose_gpu_vs_truth_max_abs": gt_err,
                    "focal_gpu": f_gpu[0][0], "focal_cpu": f_cpu[0][0],
                    "focal_truth": POSE_FOCAL, "pose_gpu_s": t_gpu,
                    "pose_cpu_s": t_cpu}))
    if not err <= POSE_ATOL:
        raise AssertionError(f"pose recovery, card vs CPU: {err}")
    return {"images_to_poses": counts}


POSE_FOCAL = 420.0


def pose_scene(V: int, H: int, W: int, seed: int):
    """Predictions of a seeded scene: V cameras (view 0 the identity) with
    focal POSE_FOCAL see depths of 2-4, the pointmaps in view 0's frame with
    1% depth noise, 5% confident outliers and 15% pixels under the conf > 1
    mask.  Returns the preds and the true c2w (V, 4, 4)."""
    rng = np.random.default_rng(seed)
    c2w = np.tile(np.eye(4), (V, 1, 1))
    for v in range(1, V):
        a = rng.normal(size=3)
        a *= rng.uniform(0.05, 0.25) / np.linalg.norm(a)
        K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        th = np.linalg.norm(a)
        c2w[v, :3, :3] = (np.eye(3) + np.sin(th) / th * K
                          + (1 - np.cos(th)) / th ** 2 * K @ K)
        c2w[v, :3, 3] = rng.normal(size=3) * 0.3
    ys, xs = np.mgrid[:H, :W].astype(np.float64)
    depth = rng.uniform(2.0, 4.0, (V, H, W))
    cam = np.stack([depth * (xs - W / 2) / POSE_FOCAL,
                    depth * (ys - H / 2) / POSE_FOCAL, depth], -1)
    cam *= 1 + 0.01 * rng.normal(size=(V, H, W, 1))
    pts = np.einsum("vij,vhwj->vhwi", c2w[:, :3, :3], cam) \
        + c2w[:, None, None, :3, 3]
    conf = rng.uniform(1.2, 3.0, (V, H, W))
    out = rng.random((V, H, W)) < 0.05
    pts[out] += rng.normal(0, 0.5, (int(out.sum()), 3))
    conf[rng.random((V, H, W)) < 0.15] = 0.5
    preds = [{"pts3d_in_other_view": torch.from_numpy(
                  pts[v:v + 1].astype(np.float32)),
              "conf": torch.from_numpy(conf[v:v + 1].astype(np.float32))}
             for v in range(V)]
    return preds, c2w.astype(np.float32)


# ---------------------------------------------------------------------------
# phases 15-16: the ring kernel and the sequence-sharded request
# ---------------------------------------------------------------------------

RING_N = (1, 2, 3, 4, 8)
SELF_EPOCHS = 4
SEQ_RANKS = 4
SEQ_REL_L2 = 0.02  # seq-sharded vs single-device, both bf16 on the card


def _ring_qkv(n: int, dtype, seed: int):
    """Rank-stacked q, k, v (n, 1, 15360 / n, 16, 64): strided views of one
    qkv buffer, as the decoder's projection gives them."""
    qkv = torch.randn((n, 1, M_TOK // n, 3, 16, 64), generator=_gen(seed),
                      device="cuda").to(dtype)
    return qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]


def _ring_plain_by_head(q, k, v, scale, epochs=None):
    """The plain ring one head at a time (at n = 1 the full score matrices
    of all heads would not fit at once); B = 1."""
    outs, lses = zip(*(ring_flash_attention(
        q[:, :, :, h:h + 1], k[:, :, :, h:h + 1], v[:, :, :, h:h + 1], scale,
        epochs) for h in range(q.shape[3])))
    return torch.cat(outs, dim=3), torch.cat(lses, dim=1)


def _ring_bound(n: int, epochs: int, s_loc: int, dtype) -> dict:
    """FLOPs of n ranks x E epochs of S_loc x S_loc attention at the bf16
    peak (fp32: the CUDA-core peak), or the bytes: q, k, v read and o, lse
    written once, the bootstrap copy, E - 1 hops of K and V per rank and the
    online-softmax state (acc, m, l in fp32) stored and loaded at each of
    the E - 1 epoch boundaries, at 3.35 TB/s."""
    H, D, it = 16, 64, torch.tensor([], dtype=dtype).element_size()
    tok = n * s_loc * H * D * it  # one (n, S_loc, H, D) tensor
    nbytes = (4 * tok + n * H * s_loc * 4 + 4 * tok + 4 * (epochs - 1) * tok
              + 2 * (epochs - 1) * n * s_loc * H * (D + 2) * 4)
    return bound(4.0 * n * epochs * s_loc * s_loc * H * D, nbytes, dtype)


def phase_ring(results: list) -> None:
    log("== phase 15: the ring kernel (K14's forward) at the decoder's shape "
        "vs the plain ring")
    bf = torch.bfloat16
    for n, epochs in [(n, n) for n in RING_N] + [(1, SELF_EPOCHS)]:
        self_ring = epochs != n
        q, k, v = _ring_qkv(n, bf, 15 + n + epochs)
        o, lse = _rdma_forward(q, k, v, DEC_SCALE, n,
                               SELF_EPOCHS if self_ring else None)
        # the self-ring's reference is plain attention, its lse + ln E
        ref_o, ref_lse = _ring_plain_by_head(q, k, v, DEC_SCALE)
        torch.cuda.synchronize()
        r = compare("ring", o, ref_o, bf)
        shift = math.log(epochs) if self_ring else 0.0
        r_lse = compare("ring_lse", lse, ref_lse + shift, bf)
        del ref_o, ref_lse
        s_loc = M_TOK // n
        case = (f"n=1 self-ring E={epochs}" if self_ring else f"n={n} ") + \
            f" {n}x1x{s_loc}x16x64 ({M_TOK} tokens)"
        args = (q, k, v, DEC_SCALE, n) + ((SELF_EPOCHS,) if self_ring else ())
        r.update(kernel="ring_attention", case=case, dtype="bfloat16",
                 lse_max_abs_err=r_lse["max_abs_err"],
                 lse_shift=shift,
                 ms=median_ms(lambda: ring_flash_attention_rdma(*args),
                              10 if n == SEQ_RANKS else 5),
                 plain_ms=None, library=None, library_ms=None,
                 **_ring_bound(n, epochs, s_loc, bf))
        if n == SEQ_RANKS and not self_ring:
            r["plain_ms"] = median_ms(
                lambda: ring_flash_attention(q, k, v, DEC_SCALE), 3)
            # the same function on the gathered sequence: K1 and SDPA
            qf, kf, vf = (t.reshape(1, M_TOK, 16, 64) for t in (q, k, v))
            r["k1_ms"] = median_ms(
                lambda: flash_attention(qf, kf, vf, DEC_SCALE), 10)
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (qf, kf, vf))
            r["library"] = "F.scaled_dot_product_attention (gathered)"
            r["library_ms"] = median_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, scale=DEC_SCALE), 10)
            del qf, kf, vf, qt, kt, vt
        results.append(r)
        log(json.dumps(r))
        del q, k, v, o, lse
        torch.cuda.empty_cache()

    # the fp32 variant at n = SEQ_RANKS, tight
    q, k, v = _ring_qkv(SEQ_RANKS, torch.float32, 16)
    o, lse = _rdma_forward(q, k, v, DEC_SCALE, SEQ_RANKS)
    ref_o, ref_lse = _ring_plain_by_head(q, k, v, DEC_SCALE)
    torch.cuda.synchronize()
    r = compare("ring", o, ref_o, torch.float32)
    r.update(kernel="ring_attention", dtype="float32",
             case=f"n={SEQ_RANKS} fp32",
             lse_max_abs_err=compare("ring_lse", lse, ref_lse,
                                     torch.float32)["max_abs_err"],
             ms=median_ms(lambda: _rdma_forward(q, k, v, DEC_SCALE,
                                                SEQ_RANKS), 3),
             **_ring_bound(SEQ_RANKS, SEQ_RANKS, M_TOK // SEQ_RANKS,
                           torch.float32))
    results.append(r)
    log(json.dumps(r))
    del q, k, v, o, lse, ref_o, ref_lse
    torch.cuda.empty_cache()


def _seq_imgs(V: int, H: int, W: int, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.rand((1, V, H, W, 3), generator=g) * 2 - 1


def _rel_l2(out: dict, ref: dict) -> dict:
    return {k: ((out[k].float().cpu() - ref[k].float().cpu()).norm()
                / ref[k].float().cpu().norm()).item() for k in OUT_KEYS}


def phase_seq_sharded(gpu: str) -> dict:
    log(f"== phase 16: the sequence-sharded request (flagship, random "
        f"weights seed 0, bfloat16, {SEQ_RANKS} ranks, ring kernel)")
    t0 = time.perf_counter()
    cfg = Fast3RConfig.flagship()
    cpu_model = Fast3R.from_random(cfg, seed=0, device="cpu")
    model = cpu_model.to(device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"model built and moved in {time.perf_counter() - t0:.1f} s")
    V, H, W = 20, 384, 512
    fwd = make_seq_sharded_forward(cfg, SEQ_RANKS, V, (H, W),
                                   ring_impl="rdma")
    imgs = _seq_imgs(V, H, W, 16)
    ids = sample_random_image_ids(None, 1, V)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    for serve in (1, 2, 3):  # one cold request, two warm
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fwd(model.params, imgs, ids[0])
        out = {k: v.float().cpu() for k, v in out.items()}
        dt = time.perf_counter() - t
        log(json.dumps({"path": "seq_sharded", "ranks": SEQ_RANKS,
                        "request_views": V, "image_hw": [H, W],
                        "serve": serve, "latency_s": dt,
                        "images_per_s": V / dt, "gpu": gpu,
                        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}))
    counts = _read_counts()
    log(json.dumps({"path": "seq_sharded", "requests": 3,
                    "launches_per_request": {k: c / 3 for k, c in
                                             counts.items()}}))
    _expect("seq_sharded", counts, ring_attention=3 * cfg.decoder.depth,
            attention=0)
    check_preds([{k: v[:, i] for k, v in out.items()} for i in range(V)],
                [(H, W)] * V)

    # the single-device forward on the card: same weights, same decoder
    # block road (plain), same image ids
    plain_dec = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, fused_blocks=False))
    with torch.inference_mode():
        for _ in range(2):  # the second one warm, timed as the requests
            torch.cuda.synchronize()
            t = time.perf_counter()
            ref = fast3r_forward(model.params, plain_dec,
                                 imgs.cuda().bfloat16(), view_ids=ids)
            ref = {k: v.float().cpu() for k, v in ref.items()}
            t_single = time.perf_counter() - t
    errs = _rel_l2(out, ref)
    del ref

    # a 2-view 224x224 request over 2 ranks against fp32 on the CPU
    imgs2, ids2 = _seq_imgs(2, 224, 224, 17), sample_random_image_ids(None, 1, 2)
    out2 = make_seq_sharded_forward(cfg, 2, 2, (224, 224))(model.params,
                                                          imgs2, ids2[0])
    with torch.inference_mode():
        ref2 = fast3r_forward(cpu_model.params, cfg, imgs2, view_ids=ids2)
    errs2 = _rel_l2(out2, ref2)
    log(json.dumps({"single_device_warm_latency_s": t_single,
                    "seq_vs_single_device_rel_l2": errs,
                    "tolerance": SEQ_REL_L2,
                    "seq_2x224_vs_cpu_fp32_rel_l2": errs2,
                    "tolerance_cpu": E2E_REL_L2}))
    bad = {k: e for k, e in errs.items() if not e <= SEQ_REL_L2}
    bad.update({f"2x224 {k}": e for k, e in errs2.items()
                if not e <= E2E_REL_L2})
    if bad:
        raise AssertionError(f"sequence-sharded outputs off: {bad}")
    return {"seq_sharded": counts}


# ---------------------------------------------------------------------------
# phases 17-18: the backward ring kernels and the sequence-sharded training
# step
# ---------------------------------------------------------------------------

def _ring_bwd_bound(n: int, s_loc: int, dtype, kernel: str) -> dict:
    """The least time of the dq ring, the dk/dv ring or the pair at the
    decoder's shape.  FLOPs: the five products per (query, key) pair, 10 N^2
    H D, 2.5x the forward's (K9's bound); the dq ring alone does three of
    them (6 N^2 H D: it recomputes s and dp), the dk/dv ring four (8).
    Bytes: each ring's inputs read and outputs written once (q, k, v, do,
    dq, lse, delta; q, k, v, do, dk, dv, the (lse, delta) pairs; the pair:
    q, k, v, o, do, lse, dq, dk, dv), its n copies of its payloads (the
    bootstrap and n - 1 hops, each read and written: K and V; q, do and the
    pairs) and its fp32 accumulators stored and loaded at the n - 1 epoch
    boundaries (dq; dk and dv), at 3.35 TB/s."""
    H, D, it = 16, 64, torch.tensor([], dtype=dtype).element_size()
    tok = n * s_loc * H * D * it  # one (n, S_loc, H, D) tensor
    rows = n * s_loc * H
    acc = n * H * -(-s_loc // 64) * 64 * D * 4  # one fp32 accumulator per item
    hops_dq = 2 * n * 2 * tok + 2 * (n - 1) * acc
    hops_dkv = 2 * n * (2 * tok + rows * 8) + 2 * (n - 1) * 2 * acc
    nbytes = {"dq": 5 * tok + 2 * rows * 4 + hops_dq,
              "dkv": 6 * tok + rows * 8 + hops_dkv,
              "pair": 8 * tok + rows * 4 + hops_dq + hops_dkv}[kernel]
    flops = {"dq": 6, "dkv": 8, "pair": 10}[kernel] * float(n * s_loc) ** 2 * H * D
    return bound(flops, nbytes, dtype)


def _ring_bwd_plain_by_head(q, k, v, o, lse, do, scale):
    """ring_attention_bwd_ref one head at a time (at n = 1 the full score
    matrices of all heads would not fit at once); B = 1."""
    per_head = [ring_attention_bwd_ref(
        q[:, :, :, h:h + 1], k[:, :, :, h:h + 1], v[:, :, :, h:h + 1],
        o[:, :, :, h:h + 1], lse[:, h:h + 1], do[:, :, :, h:h + 1], scale)
        for h in range(q.shape[3])]
    return tuple(torch.cat([g[i] for g in per_head], dim=3) for i in range(3))


def phase_ring_bwd(results: list) -> None:
    log("== phase 17: the backward ring kernels (K14's backward) at the "
        "decoder's shape vs their plain version")
    for dtype in (torch.bfloat16, torch.float32):
        name = "bfloat16" if dtype == torch.bfloat16 else "float32"
        for n in RING_N:
            q, k, v = _ring_qkv(n, dtype, 70 + n)
            do = torch.randn(q.shape, generator=_gen(80 + n),
                             device="cuda").to(dtype)
            o, lse = _rdma_forward(q, k, v, TRAIN_SCALE, n)
            got = _ring_backward(q, k, v, o, lse, do, TRAIN_SCALE, n)
            ref = _ring_bwd_plain_by_head(q, k, v, o, lse, do, TRAIN_SCALE)
            torch.cuda.synchronize()
            kind = "attention_bwd" if dtype == torch.bfloat16 else "ring_bwd"
            errs = [compare(kind, a, b, dtype) for a, b in zip(got, ref)]
            del got, ref
            torch.cuda.empty_cache()
            delta, meta = _bwd_rows(o, do, lse)
            main = n == SEQ_RANKS
            reps = (10 if main else 5) if dtype == torch.bfloat16 else (
                3 if main else 1)
            s_loc = M_TOK // n
            extra = {
                "pair_ms": median_ms(lambda: _ring_backward(
                    q, k, v, o, lse, do, TRAIN_SCALE, n), reps),
                "pair_bound_ms": _ring_bwd_bound(n, s_loc, dtype,
                                                 "pair")["bound_ms"],
                "plain_ms": None, "library": None, "library_ms": None}
            times = {
                "ring_attention_bwd_dq": median_ms(lambda: ring_attention_bwd_dq(
                    q, k, v, do, lse, delta, TRAIN_SCALE, n), reps),
                "ring_attention_bwd_dkv": median_ms(
                    lambda: ring_attention_bwd_dkv(q, k, v, do, meta,
                                                   TRAIN_SCALE, n), reps)}
            if main:
                extra["plain_ms"] = median_ms(lambda: _ring_bwd_plain_by_head(
                    q, k, v, o, lse, do, TRAIN_SCALE), 1)
                extra["plain"] = ("ring_attention_bwd_ref, one head at a "
                                  "time (both rings)")
            if main and dtype == torch.bfloat16:
                # the same function on the gathered sequence: K9 and the
                # autograd of SDPA
                qf, kf, vf, dof = (t.reshape(1, M_TOK, 16, 64)
                                   for t in (q, k, v, do))
                of, lsef = attention_fwd_lse(qf, kf, vf, TRAIN_SCALE)
                extra["k9_ms"] = median_ms(lambda: attention_bwd(
                    qf, kf, vf, of, lsef, dof, TRAIN_SCALE), 10)
                ql, kl, vl = (t.detach().transpose(1, 2).contiguous()
                              .requires_grad_() for t in (qf, kf, vf))
                ol = F.scaled_dot_product_attention(ql, kl, vl,
                                                    scale=TRAIN_SCALE)
                extra["library"] = ("autograd of F.scaled_dot_product_attention "
                                    "(gathered)")
                extra["library_ms"] = _grad_ms(ol, (ql, kl, vl),
                                               dof.transpose(1, 2), 10)
                del qf, kf, vf, dof, of, lsef, ql, kl, vl, ol
            flops = {"dq": 6.0, "dkv": 8.0}  # the products each ring runs
            for kname, e, which in (("ring_attention_bwd_dq", errs[:1], "dq"),
                                    ("ring_attention_bwd_dkv", errs[1:], "dkv")):
                r = dict(_merge(e), kernel=kname, dtype=name,
                         case=f"n={n} {n}x1x{s_loc}x16x64 ({M_TOK} tokens)",
                         ms=times[kname],
                         tflops=flops[which] * float(M_TOK) ** 2 * 16 * 64
                         / (times[kname] * 1e-3) / 1e12, **extra,
                         **_ring_bwd_bound(n, s_loc, dtype, which))
                results.append(r)
                log(json.dumps(r))
            del q, k, v, do, o, lse, delta, meta
            torch.cuda.empty_cache()


def phase_seq_train(gpu: str) -> dict:
    log(f"== phase 18: the sequence-sharded training step (flagship, random "
        f"weights seed 0, bf16 params and moments, 20 views at 512x384 over "
        f"{SEQ_RANKS} ranks, remat, the ring kernels forward and backward)")
    t0 = time.perf_counter()
    cfg = Fast3RConfig.flagship()
    cpu_model = Fast3R.from_random(cfg, seed=0, device="cpu")
    net = cpu_model.to(device="cuda", dtype=torch.bfloat16).params
    torch.cuda.synchronize()
    log(f"model built and moved in {time.perf_counter() - t0:.1f} s")
    batch = {k: torch.as_tensor(v).cuda() for k, v in
             make_dummy_batch(1, 20, 384, 512, seed=0).items()
             if k in BATCH_KEYS}
    steps = 3
    counts = train_road("seq_train", net, cfg, batch, steps, gpu,
                        step=make_seq_sharded_train_step(cfg, TRAIN_OPT,
                                                         SEQ_RANKS))
    log(json.dumps({"path": "seq_train", "ranks": SEQ_RANKS, "steps": steps,
                    "launches_per_step": {k: c / steps for k, c in
                                          counts.items()}}))
    d = cfg.decoder.depth
    _expect("seq_train", counts, ring_attention=steps * 2 * d,
            ring_attention_bwd_dq=steps * d, ring_attention_bwd_dkv=steps * d,
            attention=0, attention_bwd=0)
    del net, batch
    torch.cuda.empty_cache()

    # end to end: one 2-view 224x224 step over 2 ranks, bf16 on the card,
    # against fp32 on the CPU (plain ring) and the single-device card step
    # on the same decoder road (plain blocks, K1 / K9)
    batch = {k: torch.as_tensor(v) for k, v in
             make_dummy_batch(1, 2, 224, 224, seed=1).items()
             if k in BATCH_KEYS}
    ids = sample_random_image_ids(torch.Generator().manual_seed(0), 1, 2)
    t = time.perf_counter()
    ref_loss, ref = _loss_and_grads(cpu_model.params,
                                    seq_sharded_config(cfg, 2, "plain"),
                                    batch, ids)
    t_cpu = time.perf_counter() - t
    gpu_model = cpu_model.to(device="cuda", dtype=torch.bfloat16)
    loss, grads = _loss_and_grads(gpu_model.params, seq_sharded_config(cfg, 2),
                                  batch, ids)
    plain_dec = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, fused_blocks=False))
    one_loss, one = _loss_and_grads(gpu_model.params, plain_dec, batch, ids)
    errs, bad = {}, {}
    for what, (l_ref, g_ref) in (("vs_cpu_fp32", (ref_loss, ref)),
                                 ("vs_single_device_card", (one_loss, one))):
        errs[what] = {"loss": abs(loss - l_ref) / abs(l_ref),
                      **{f"grad/{k}": ((grads[k] - g_ref[k]).norm()
                                       / g_ref[k].norm()).item()
                         for k in g_ref}}
        bad.update({f"{what} {k}": e for k, e in errs[what].items()
                    if not e <= E2E_TRAIN_REL})
    log(json.dumps({"seq_train_2x224_rel_err": errs,
                    "tolerance": E2E_TRAIN_REL, "loss_cpu_fp32": ref_loss,
                    "loss_card_seq": loss, "loss_card_single": one_loss,
                    "cpu_fp32_s": t_cpu}))
    del gpu_model
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"seq-sharded training error above "
                             f"{E2E_TRAIN_REL}: {bad}")
    return {"seq_train": counts}


def phase_counts(counts: dict) -> None:
    log("== phase 19: kernel launches on each path of phases 3, 5, 7, 9, 11, "
        "12, 14, 16 and 18")
    log(json.dumps(counts))
    missing = [f"{path}: {k}" for path, names in PATHS.items()
               for k in names if counts[path][k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on their path: {missing}")
    stray = [f"{path}: {k}" for path, names in NO_LAUNCH.items()
             for k in names if counts[path][k] != 0]
    if stray:
        raise AssertionError(f"kernels launched off their path: {stray}")


# the heaviest main-path shape of each kernel, for the summary line
MAIN_CASE = {"attention": "decoder", "layernorm": "eps=1e-05",
             "matmul_residual": "proj", "attention_bwd": "decoder",
             "ln_matmul_replay": "fc1", "rms_qkv3": f"qkv {M_TOK}",
             "rms_matmul": "w1", "rms_matmul_replay": "w1",
             "resize": "256x256", "ring_attention": "n=4 ",
             "ring_attention_bwd_dq": "n=4 ", "ring_attention_bwd_dkv": "n=4 "}


def kernel_summary(results: list, counts: dict) -> dict:
    """One entry per kernel: launches summed over the paths of phases 3, 5,
    7, 9, 11, 12, 14, 16 and 18 (and per path); the largest bfloat16 error,
    and the bfloat16 times and bound at its heaviest main-path shape, from
    phase 2 (the ring kernel: phase 15, n = 4; its backward rings: phase
    17, n = 4)."""
    kernels = []
    for name, (_, route, source, replaces) in KERNELS.items():
        rows = [r for r in results
                if r["kernel"] == name and r["dtype"] == "bfloat16"]
        main = next(r for r in rows if MAIN_CASE.get(name, "") in r["case"])
        entry = {
            "name": name, "route": route, "source": source,
            "replaces": replaces,
            "launches": sum(c[name] for c in counts.values()),
            "launches_by_path": {p: c[name] for p, c in counts.items()},
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "atol": main["atol"], "rtol": main["rtol"],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "library": main["library"],
            "case": main["case"] + " bfloat16"}
        for key in ("two_kernel_ms", "k1_ms", "k9_ms", "pair_ms",
                    "pair_bound_ms"):
            if key in main:
                entry[key] = main[key]
        kernels.append(entry)
    return {"kernels": kernels}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()

    def done(phase: str) -> None:
        log(f"-- {phase} done at {time.perf_counter() - t0:.1f} s")

    gpu = phase_device()["gpu"]
    done("phase 1")
    results = phase_kernels()
    done("phase 2")
    cpu_model, model, plain, counts = phase_requests(gpu)
    done("phase 3")
    phase_end_to_end(cpu_model, model, plain)
    del model, plain
    torch.cuda.empty_cache()
    done("phase 4")
    counts.update(phase_training(gpu, cpu_model))
    done("phase 5")
    phase_train_end_to_end(cpu_model, cpu_model.cfg.with_fused_blocks(False))
    del cpu_model
    done("phase 6")
    cpu_model, model, plain, llama_counts = phase_llama_requests(gpu)
    counts.update(llama_counts)
    done("phase 7")
    phase_end_to_end(cpu_model, model, plain, "phase 8 (llama)")
    del model, plain
    torch.cuda.empty_cache()
    done("phase 8")
    counts.update(phase_llama_training(gpu, cpu_model))
    done("phase 9")
    phase_train_end_to_end(cpu_model, llama_cfg(fused_decoder=False),
                           "phase 10 (llama)")
    del cpu_model
    done("phase 10")
    cpu_model, model, square_counts = phase_square(gpu)
    counts.update(square_counts)
    done("phase 11")
    counts.update(phase_mixed(gpu, model))
    done("phase 12")
    phase_head_end_to_end(cpu_model, model)
    del cpu_model
    done("phase 13")
    counts.update(phase_images_to_poses(gpu, model))
    del model
    torch.cuda.empty_cache()
    done("phase 14")
    phase_ring(results)
    done("phase 15")
    counts.update(phase_seq_sharded(gpu))
    torch.cuda.empty_cache()
    done("phase 16")
    phase_ring_bwd(results)
    done("phase 17")
    counts.update(phase_seq_train(gpu))
    done("phase 18")
    phase_counts(counts)
    done("phase 19")
    log(json.dumps(kernel_summary(results, counts)))
    log(gpu_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
