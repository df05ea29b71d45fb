"""Smoke run of the PyTorch port (fast3r_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written kernels from ``fast3r_torch/csrc`` and
``fast3r_torch/ops`` and runs five phases, synchronising after each:

  1. device: the card's name and power limit, torch / CUDA versions, the
     kernel build time;
  2. kernels: each kernel against its plain PyTorch version on the card at
     the flagship forward's shapes, in float32 (tight tolerance) and bfloat16
     (the served type), with max abs / rel errors and median CUDA-event times;
  3. requests: the flagship model with random weights (seed 0) in bfloat16
     serves three ``fast3r_torch.inference`` requests of 2, 8 and 20 views at
     512x384, each twice; outputs must be finite, of the right shapes,
     with conf >= 1;
  4. end to end: the same weights in float32 on the CPU (the plain path) and
     in bfloat16 on the card (the kernels) answer one 2-view 224x224 request;
     pts3d and conf must agree within the stated tolerance;
  5. launch counts: every kernel must have launched during phase 3.

Any failure raises (exit code 1).  Without a CUDA device the script exits
with code 2 before printing any result.  The last line of standard output
is ``{"ok": true, "device": {...}}``; the line before it holds the card's
name and power limit, and before that one JSON line describes each kernel.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import torch

from fast3r_torch import Fast3R, Fast3RConfig, inference
from fast3r_torch.kernels import build
from fast3r_torch.ops.flash_attention import attention_ref, flash_attention
from fast3r_torch.ops.fused_layernorm import fused_layernorm, layernorm_ref
from fast3r_torch.ops.trunk_kernel import _plain_head, fused_regression_head_t

DEC_SCALE = 0.125 * math.sqrt(math.log(137) / math.log(20))

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
}


def log(msg: str = "") -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


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
    atol = tol.get("atol", 0.0) + tol.get("atol_of_max", 0.0) * b.abs().max().item()
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
            r.update(kernel="attention", case=f"{name} {B}x{N}x{H}x{D}",
                     dtype=str(dtype).split(".")[-1],
                     ms=median_ms(lambda: flash_attention(q, k, v, scale), 10),
                     plain_ms=median_ms(lambda: attention_ref(q, k, v, scale), 3))
            results.append(r)
            log(json.dumps(r))
            del qkv, q, k, v, out
            torch.cuda.empty_cache()


def check_layernorm(results: list) -> None:
    M, C = 15360, 1024
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
                     plain_ms=median_ms(lambda: layernorm_ref(x, w, b, eps), 20))
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

        out = fused_regression_head_t(x, *args)
        ref = plain()
        torch.cuda.synchronize()
        r = compare("trunk", out, ref, dtype)
        r.update(kernel="trunk", case=f"{n}x{hh}x{wc}x{cin} -> {H}x{W}",
                 dtype=str(dtype).split(".")[-1],
                 ms=median_ms(lambda: fused_regression_head_t(x, *args), 5),
                 plain_ms=median_ms(plain, 5))
        results.append(r)
        log(json.dumps(r))


def phase_kernels() -> list:
    log("== phase 2: kernels vs plain versions")
    # the plain versions compute fp32 products in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results: list = []
    check_layernorm(results)
    check_attention(results)
    check_trunk(results)
    torch.cuda.synchronize()
    return results


# ---------------------------------------------------------------------------
# phases 3-5
# ---------------------------------------------------------------------------

KERNELS = {  # wrapper -> (name, route, source, TPU kernel it replaces)
    "attention": (flash_attention, "cuda", "fast3r_torch/csrc/attention_fwd.cu",
                  "fast3r_tpu/ops/flash_attention.py:745 (_fwd_kernel_packed); "
                  "fast3r_tpu/ops/batched_attention.py:340 (_packed_kernel)"),
    "layernorm": (fused_layernorm, "triton", "fast3r_torch/ops/fused_layernorm.py",
                  "fast3r_tpu/ops/fused_layernorm.py:46 (_fwd_kernel)"),
    "trunk": (fused_regression_head_t, "cuda", "fast3r_torch/csrc/trunk.cu",
              "fast3r_tpu/ops/trunk_kernel.py:165 (_trunk_kern)"),
}
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


def check_preds(preds: list, n: int, H: int, W: int) -> None:
    if len(preds) != n:
        raise AssertionError(f"{len(preds)} predictions for {n} views")
    for i, p in enumerate(preds):
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


def phase_requests(gpu: str):
    log("== phase 3: requests (flagship, random weights seed 0, bfloat16)")
    t0 = time.perf_counter()
    cpu_model = Fast3R.from_random(Fast3RConfig.flagship(), seed=0)
    model = cpu_model.to(device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.params.parameters())
    log(f"model: {n_params} parameters, built and moved in "
        f"{time.perf_counter() - t0:.1f} s")
    H, W = 384, 512
    inference(request_views(2, H, W, 99), model, verbose=False)  # warm-up
    torch.cuda.synchronize()
    for fn, *_ in KERNELS.values():
        fn.launches = 0
    for n in (2, 8, 20):
        # twice per size: the first request of a size also pays its one-off
        # costs (allocator growth, pinned host buffers, conv algorithm picks)
        for serve in (1, 2):
            views = request_views(n, H, W, n + serve)
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = inference(views, model, verbose=False)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            check_preds(out["preds"], n, H, W)
            log(json.dumps({
                "request_views": n, "serve": serve, "image_hw": [H, W],
                "latency_s": dt, "images_per_s": n / dt, "gpu": gpu,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}))
    counts = {name: fn.launches for name, (fn, *_) in KERNELS.items()}
    return cpu_model, model, counts


def phase_end_to_end(cpu_model, model) -> dict:
    log("== phase 4: bf16 kernel path on the card vs fp32 plain path on the CPU")
    views = request_views(2, 224, 224, 7)
    t = time.perf_counter()
    ref = inference(views, cpu_model, verbose=False)["preds"]
    t_cpu = time.perf_counter() - t
    out = inference(views, model, verbose=False)["preds"]
    torch.cuda.synchronize()
    check_preds(out, 2, 224, 224)
    errs = {}
    for k in OUT_KEYS:
        a = torch.cat([p[k] for p in out])
        b = torch.cat([p[k] for p in ref])
        errs[k] = ((a - b).norm() / b.norm()).item()
    log(json.dumps({"rel_l2_err": errs, "tolerance": E2E_REL_L2,
                    "cpu_fp32_s": t_cpu}))
    bad = {k: e for k, e in errs.items() if not e <= E2E_REL_L2}
    if bad:
        raise AssertionError(f"end-to-end error above {E2E_REL_L2}: {bad}")
    return errs


def phase_counts(counts: dict) -> None:
    log("== phase 5: kernel launches during phase 3")
    log(json.dumps(counts))
    missing = [k for k, c in counts.items() if c <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")


def kernel_summary(results: list, counts: dict) -> dict:
    """One entry per kernel: launches from phase 3; the largest bfloat16
    error and the bfloat16 times at its heaviest main-path shape (decoder
    attention, decoder-block LN eps 1e-5, the trunk) from phase 2."""
    heaviest = {"attention": "decoder", "layernorm": "eps=1e-05", "trunk": ""}
    kernels = []
    for name, (_, route, source, replaces) in KERNELS.items():
        rows = [r for r in results
                if r["kernel"] == name and r["dtype"] == "bfloat16"]
        main = next(r for r in rows if heaviest[name] in r["case"])
        kernels.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "case": main["case"] + " bfloat16"})
    return {"kernels": kernels}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    gpu = phase_device()["gpu"]
    results = phase_kernels()
    cpu_model, model, counts = phase_requests(gpu)
    phase_end_to_end(cpu_model, model)
    phase_counts(counts)
    log(json.dumps(kernel_summary(results, counts)))
    log(gpu_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
