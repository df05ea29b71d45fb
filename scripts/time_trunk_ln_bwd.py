"""Time the DPT head trunk (K8) and the LayerNorm backward (K7's backward)
of copies of fast3r_torch on one card, in turns, beside their yardsticks.

    python scripts/time_trunk_ln_bwd.py [--rounds 2] [--ablate base,...] [DIR ...]

Each DIR holds a ``fast3r_torch`` package; with none, this checkout's.  The
parent commit's, for instance: ``mkdir -p _check/parent && git archive
HEAD~1 fast3r_torch | tar -x -C _check/parent`` and pass ``_check/parent``
(each copy builds its own kernels).  ``--ablate`` adds copies of this
checkout's package with one edit each:

  * ``base``: the wgmma descriptors carry their start row's swizzle phase
    in the base-offset field (``hopper.cuh`` ``desc_sw128``; it changes only
    the trunk's shifted halo windows, and makes them wrong on the H100: the
    card swizzles by address);
  * ``nowin``: conv2 reads each halo pixel's four taps from device memory,
    not from the window in shared memory (``trunk_kernel.WIN_ROWS`` 0);
  * ``bstages2``, ``bstages5``: two or five weight stages in conv1, not
    four;
  * ``noepi``: no epilogue stores (timing only: no output);
  * ``nobuild``: conv2's halo stages left unwritten (timing only: the
    products alone).

Round by round, each copy runs in a process of its own and prints one JSON
line with, for each case:

  * ``device_ms``: the profiler's device time of one call, over the
    kernels whose name holds the case's kernel name (K8: ``trunk_conv`` or
    the earlier ``conv3x3``, and ``conv1_ms`` / ``conv2_ms`` its two
    launches; K7's backward: ``ln_bwd``); ``call_device_ms``:
    every kernel the call runs (the weights' layout casts, the earlier
    backward's memset and torch sum);
  * ``batched_ms``: CUDA-event time of back-to-back calls over their count;
  * ``single_ms``: median CUDA-event time of one call, host time included;
  * ``host_ms``: host clock over many calls without a synchronise;
  * ``tflops`` (K8): the chain's FLOPs over ``device_ms``, and
    ``bound_share``: the bound over ``device_ms``;
  * ``err_of_max``: max |kernel - plain| / max |plain| (K8, bf16), or the
    max abs error of dx and of dweight / dbias against the plain version
    (K7's backward); ``sha256``: of the output's bytes, and whether a second
    call gave the same bytes (``deterministic``).

The cases: K8 at the 20-view 384x512 request's chunk (20, 192, 256, 256) ->
384x512, at the mixed request's portrait group (6, 256, 192, 256) ->
512x384 and at (4, 192, 256, 256) -> 384x512 (the earlier row's), with the
port's unfused road at the same shape as its yardstick, its parts timed
apart (``unfused: conv1`` cuDNN, ``unfused: resize`` K12, ``unfused: conv2
+ relu + conv3`` cuDNN, and ``lib: F.interpolate``); K7's backward at
(15360, 1024) in bf16 and fp32 beside autograd of ``F.layer_norm``.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT_DIR = ROOT / "_check" / "ab"
ABLATIONS = {  # name -> (file under fast3r_torch, text, replacement)
    "base": ("csrc/hopper.cuh",
             "  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | (1ull << 16) |\n"
             "         (64ull << 32) | (1ull << 62);",
             "  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | (1ull << 16) |\n"
             "         (64ull << 32) | ((uint64_t)((smem_u32(tile) >> 7) & 7) << 49) |\n"
             "         (1ull << 62);"),
    "nowin": ("ops/trunk_kernel.py", "WIN_ROWS, WIN_COLS = 6, 40",
              "WIN_ROWS, WIN_COLS = 0, 40"),
    "bstages2": ("csrc/trunk.cu", "constexpr int kBStages = kMode == 1 ? 4 : 3;",
                 "constexpr int kBStages = kMode == 1 ? 2 : 3;"),
    "bstages5": ("csrc/trunk.cu", "constexpr int kBStages = kMode == 1 ? 4 : 3;",
                 "constexpr int kBStages = kMode == 1 ? 5 : 3;"),
    "noepi": ("csrc/trunk.cu", "const int y = q.y0 + 2 * wg;",
              "const int y = q.y0 + 2 * wg + (1 << 20);"),
    "nobuild": ("csrc/trunk.cu",
                "for (int u = i; u < kHaloCols * 8; u += kXform) {",
                "for (int u = i; u < 0; u += kXform) {"),
}
TRUNK = {  # name -> (n, hh, wc, cin, H, W)
    "trunk 20x192x256x256->384x512": (20, 192, 256, 256, 384, 512),
    "trunk 6x256x192x256->512x384": (6, 256, 192, 256, 512, 384),
    "trunk 4x192x256x256->384x512": (4, 192, 256, 256, 384, 512),
}


def trunk_flops(n, hh, wc, cin, H, W, c1=128):
    return 2.0 * (n * hh * wc * c1 * cin * 9 + n * H * W * (c1 * c1 * 9 + c1 * 4))


def measure(pkg: str, only: str = "") -> dict:
    """The timings of the package under ``pkg`` (run in its own process)."""
    sys.path.insert(0, pkg)
    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fast3r_torch.ops import fused_layernorm as fl
    from fast3r_torch.ops import trunk_kernel as tk
    from fast3r_torch.ops.resize_kernel import resize_bilinear_kernel

    assert tk.__file__.startswith(os.path.abspath(pkg)), tk.__file__
    torch.backends.cudnn.allow_tf32 = False

    def device_ms(fn, subs, reps=10):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum((getattr(e, "self_device_time_total", 0)
                  or getattr(e, "self_cuda_time_total", 0))
                 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA
                 and (subs is None or any(s in e.key for s in subs)))
        return us / reps / 1e3

    def events_ms(fn, calls):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / calls

    def times(fn, subs, host_calls, batch=10):
        fn()
        torch.cuda.synchronize()
        r = {"device_ms": device_ms(fn, subs),
             "call_device_ms": device_ms(fn, None),
             "batched_ms": statistics.median(events_ms(fn, batch)
                                             for _ in range(3)),
             "single_ms": statistics.median(events_ms(fn, 1)
                                            for _ in range(10))}
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(host_calls):
            fn()
        r["host_ms"] = (time.perf_counter() - t) / host_calls * 1e3
        torch.cuda.synchronize()
        return r

    def sha(t):
        return hashlib.sha256(t.contiguous().view(torch.uint8).cpu()
                              .numpy().tobytes()).hexdigest()[:16]

    from fast3r_torch.kernels import build

    build.library()
    blog = build.library_path().with_suffix(".log").read_text().splitlines()
    res = {"ptxas": {ln.split("Function properties for")[1].strip()[-40:]:
                     " | ".join(x.split("info    :")[-1].strip()
                                for x in blog[i + 1:i + 3])
                     for i, ln in enumerate(blog)
                     if "Function properties for" in ln
                     and ("trunk_conv" in ln or "13ln_bwd_kernel" in ln)}}
    bf = torch.bfloat16
    for name, (n, hh, wc, cin, H, W) in TRUNK.items():
        if only == "layernorm":
            break
        g = torch.Generator(device="cuda").manual_seed(3)

        def uni(shape, fan_in):
            return ((torch.rand(shape, generator=g, device="cuda") * 2 - 1)
                    / math.sqrt(fan_in)).to(bf)

        x = torch.randn((n, hh, wc, cin), generator=g, device="cuda").to(bf)
        w1, b1 = uni((128, cin, 3, 3), 9 * cin), uni((128,), 9 * cin)
        w2, b2 = uni((128, 128, 3, 3), 1152), uni((128,), 1152)
        w3, b3 = uni((4, 128, 1, 1), 128), uni((4,), 128)
        args = (w1, b1, w2, b2, w3, b3, H, W)
        r = {}
        try:
            out = tk.fused_regression_head_t(x, *args)
            again = tk.fused_regression_head_t(x, *args)
            torch.cuda.synchronize()
            ref = tk._plain_head(x.permute(0, 3, 1, 2), *args).reshape(
                n, 4, H * W).float()
            r["err_of_max"] = ((out.float() - ref).abs().max().item()
                               / ref.abs().max().item())
            r["finite"] = bool(torch.isfinite(out.float()).all())
            r["sha256"], r["deterministic"] = sha(out), torch.equal(out, again)
            del ref, again
            r.update(times(lambda: tk.fused_regression_head_t(x, *args),
                           ("trunk_conv", "conv3x3"), 20, batch=5))
            for k, sub in (("conv1_ms", "trunk_conv_kernel<1>"),
                           ("conv2_ms", "trunk_conv_kernel<2>")):
                r[k] = device_ms(lambda: tk.fused_regression_head_t(x, *args),
                                 (sub,))
            fl_ = trunk_flops(n, hh, wc, cin, H, W)
            r["tflops"] = fl_ / (r["device_ms"] * 1e-3) / 1e12
            r["bound_ms"] = fl_ / 989e12 * 1e3
            r["bound_share"] = r["bound_ms"] / r["device_ms"]
        except Exception as e:  # a copy whose kernel fails: say so, go on
            r["error"] = f"{type(e).__name__}: {e}"[:2000]
        res[name] = r
        if n in (20, 6):  # the port's unfused road at the same shape
            xc = x.permute(0, 3, 1, 2).contiguous()
            y1 = F.conv2d(xc, w1, b1, padding=1)
            yr = resize_bilinear_kernel(y1, H, W)
            res["unfused: conv1 " + name] = times(
                lambda: F.conv2d(xc, w1, b1, padding=1), None, 20, batch=5)
            res["unfused: resize " + name] = times(
                lambda: resize_bilinear_kernel(y1, H, W), None, 20, batch=5)
            res["unfused: conv2 + relu + conv3 " + name] = times(
                lambda: F.conv2d(F.relu(F.conv2d(yr, w2, b2, padding=1)), w3,
                                 b3), None, 20, batch=5)
            res["lib: F.interpolate " + name] = times(
                lambda: F.interpolate(y1, size=(H, W), mode="bilinear",
                                      align_corners=True), None, 20, batch=5)
            res["unfused: total " + name] = {
                k: sum(res[f"{p} {name}"][k] for p in (
                    "unfused: conv1", "unfused: resize",
                    "unfused: conv2 + relu + conv3"))
                for k in ("device_ms", "call_device_ms")}
            del xc, y1, yr
        del x
        torch.cuda.empty_cache()
    for dtype in (torch.bfloat16, torch.float32):
        if only == "trunk":
            break
        g = torch.Generator(device="cuda").manual_seed(5)
        x = (torch.randn((15360, 1024), generator=g, device="cuda") * 3
             + 1).to(dtype)
        w = (1 + 0.1 * torch.randn((1024,), generator=g, device="cuda")).to(dtype)
        b = (0.1 * torch.randn((1024,), generator=g, device="cuda")).to(dtype)
        dy = torch.randn((15360, 1024), generator=g, device="cuda").to(dtype)
        name = f"layernorm_bwd 15360x1024 {str(dtype).split('.')[-1]}"
        r = {}
        try:
            dx, dw, db = fl.layernorm_bwd(x, w, dy, 1e-6)
            dx2, dw2, db2 = fl.layernorm_bwd(x, w, dy, 1e-6)
            rdx, rdw, rdb = fl.layernorm_bwd_ref(x, w, dy, 1e-6)
            r["max_abs_dx"] = (dx.float() - rdx.float()).abs().max().item()
            r["max_abs_dw_db"] = max((dw - rdw).abs().max().item(),
                                     (db - rdb).abs().max().item())
            r["sha256"] = sha(torch.cat([dx.float().flatten(), dw, db]))
            r["deterministic"] = (torch.equal(dx, dx2) and torch.equal(dw, dw2)
                                  and torch.equal(db, db2))
            # 200 calls (400 launches) stay inside the launch queue, so the
            # host clock is not held back by the device
            r.update(times(lambda: fl.layernorm_bwd(x, w, dy, 1e-6),
                           ("ln_bwd",), 200))
            r["bound_ms"] = 3 * x.numel() * x.element_size() / 3.35e12 * 1e3
            r["bound_share"] = r["bound_ms"] / r["call_device_ms"]
        except Exception as e:
            r["error"] = f"{type(e).__name__}: {e}"[:2000]
        res[name] = r
        xl, wl, bl = (t.detach().clone().requires_grad_() for t in (x, w, b))
        y = F.layer_norm(xl, (1024,), wl, bl, 1e-6)
        res["lib: " + name] = times(lambda: torch.autograd.grad(
            y, (xl, wl, bl), dy, retain_graph=True), None, 1000)
        del x, dy, xl, y
        torch.cuda.empty_cache()
    return res


def ablated_copy(name: str) -> Path:
    """This checkout's package with the edit ``name`` applied."""
    import shutil

    d = OUT_DIR / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(ROOT / "fast3r_torch", d / "fast3r_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    fname, old, new = ABLATIONS[name]
    src = d / "fast3r_torch" / fname
    text = src.read_text()
    if old not in text:
        raise SystemExit(f"{name}: the edited text is not in {fname}")
    src.write_text(text.replace(old, new))
    return d


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dirs", nargs="*", help="directories holding fast3r_torch")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--ablate", default="", help="comma-separated: "
                    + ", ".join(ABLATIONS))
    ap.add_argument("--only", choices=("trunk", "layernorm"), default="",
                    help="time one kernel only")
    ap.add_argument("--measure", nargs=1, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        print(json.dumps(measure(args.measure[0], args.only)), flush=True)
        return 0
    copies = [Path(d).resolve() for d in args.dirs] or [ROOT]
    copies += [ablated_copy(a) for a in filter(None, args.ablate.split(","))]
    labels = [f"{i}_{d.name}" for i, d in enumerate(copies)]
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"gpu: {gpu}", flush=True)
    for rnd in range(args.rounds):
        for d, label in zip(copies, labels):
            only = ["--only", args.only] if args.only else []
            r = subprocess.run([sys.executable, __file__, "--measure", str(d),
                                *only], capture_output=True, text=True)
            if r.returncode:
                print(json.dumps({"round": rnd, "copy": label,
                                  "failed": r.stderr[-3000:]}), flush=True)
                continue
            print(json.dumps({"round": rnd, "copy": label,
                              **json.loads(r.stdout.strip().splitlines()[-1])}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
