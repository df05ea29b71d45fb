"""Time the bilinear resize (K12) and the LayerNorm forward (K7) of copies of
fast3r_torch on one card, in turns, beside their library calls.

    python scripts/time_resize_ln.py [--rounds 2] [--ablate rows16,...] [DIR ...]

Each DIR holds a ``fast3r_torch`` package; with none, this checkout's.  The
parent commit's, for instance: ``mkdir -p _check/parent && git archive
HEAD~1 fast3r_torch | tar -x -C _check/parent`` and pass ``_check/parent``
(each copy builds its own kernels).  ``--ablate`` adds copies of this
checkout's package with one edit each:

  * ``rows16``: bands of 16 output rows (``MAX_BAND_ROWS``), not 32;
  * ``stages3``: three stages of staged input, not two;
  * ``nohpass``: the resize's H pass stores nothing (timing only: its
    output is wrong);
  * ``nowread``: the resize's W pass reads no H-pass value (timing only);
  * ``lnwalk2``: the LayerNorm forward's row groups each walk two rows,
    the second's loads in flight during the first's reductions, on every
    road (not only on 4 KB rows);
  * ``lncta128``: rows of 65 to 128 16-byte chunks (C = 1024 in bf16) on
    a 128-thread CTA a row, one chunk a thread, not a warp a row;
  * ``lnocc``: the LayerNorm forward's vector roads held to 6 CTAs an SM
    by their launch bounds (registers for more warps).

With ``--requests`` each DIR copy (not the ablated ones) also serves warm
requests of the flagship (random weights, seed 0, bf16) and reports the
median of 5 host-clock latencies of each: 20 views at 512x512 (fused road:
two K12 launches), the mixed 8 x 384x512 + 6 x 512x384 + 6 x 448x512
request (fused: two K12 launches), and 20 views at 384x512 on the plain
road (98 K7 launches).

Round by round, each copy runs in a
process of its own and prints one JSON line with, for each case:

  * ``device_ms``: the profiler's device time of one call (the kernels whose
    name holds ``resize_bilinear`` or ``ln_fwd``; for a library call, every
    kernel it runs);
  * ``batched_ms``: CUDA-event time of back-to-back calls over their count;
  * ``single_ms``: median CUDA-event time of one call, host time included;
  * ``host_ms``: host clock over many calls without a synchronise, over
    their count (1000 calls; 100 for the request-shape resizes);
  * ``sha256``: of the output's bytes, so that two copies can be seen
    bitwise equal.

The cases: K12 at the head's request shapes (20 views of 512x512: (20, 128,
256, 256) -> 512x512; the mixed request's 448x512 group: (6, 128, 224, 256)
-> 448x512) and at one view of each; K7 at (15360, 1024) in bf16 and fp32,
eps 1e-6; ``F.interpolate`` and ``F.layer_norm`` on the same inputs
(``lib:`` cases).  Each copy also saves its one-view resize outputs under
``_check/ab/``; after the last round the script prints, for each copy
against the first, how many elements differ and by how many bf16 steps at
most.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT_DIR = ROOT / "_check" / "ab"
ABLATIONS = {  # name -> (file under fast3r_torch, text, replacement)
    "rows16": ("ops/resize_kernel.py", "MAX_BAND_ROWS = 32", "MAX_BAND_ROWS = 16"),
    "stages3": ("ops/resize_kernel.py", "STAGES = 2 ", "STAGES = 3 "),
    "nohpass": ("csrc/resize.cu",
                "            *reinterpret_cast<uint4*>(dst[r] + ch * kCols) =\n"
                "                *reinterpret_cast<const uint4*>(v);\n", ""),
    "nowread": ("csrc/resize.cu",
                "            const float y0 = __bfloat162float(hrow[c0]);\n"
                "            const float y1 = __bfloat162float(hrow[c1]);\n",
                "            const float y0 = c0, y1 = c1;\n"),
    "lnwalk2": ("csrc/layernorm.cu",
                "constexpr int kWalk = RT == 32 && NCH == 8 ? 2 : 1;",
                "constexpr int kWalk = 2;"),
    "lncta128": ("csrc/layernorm.cu",
                 "    launch_vec<T, 4, 32>(x, w, b, y, rows, C, eps, w_bf16, b_bf16, s);",
                 "    launch_vec<T, 1, 128>(x, w, b, y, rows, C, eps, w_bf16, b_bf16, s);"),
    "lnocc": ("csrc/layernorm.cu",
              "__global__ void __launch_bounds__(RT == 32 ? kBlock : RT)",
              "__global__ void __launch_bounds__(RT == 32 ? kBlock : RT, 6)"),
}
RESIZE = {  # name -> (input shape, output (H, W)); host_ms over `calls`
    "resize 20x128x256x256->512x512": ((20, 128, 256, 256), (512, 512)),
    "resize 6x128x224x256->448x512": ((6, 128, 224, 256), (448, 512)),
    "resize 1x128x256x256->512x512": ((1, 128, 256, 256), (512, 512)),
    "resize 1x128x224x256->448x512": ((1, 128, 224, 256), (448, 512)),
}
SAVED = ("resize 1x128x256x256->512x512", "resize 1x128x224x256->448x512")


def requests(torch) -> dict:
    """Median warm latencies (s) of the flagship's requests (module doc)."""
    from fast3r_torch import Fast3R, Fast3RConfig, inference

    def views(shapes, seed):
        g = torch.Generator().manual_seed(seed)
        return [{"img": torch.rand((1, h, w, 3), generator=g) * 2 - 1,
                 "true_shape": [[h, w]]} for h, w in shapes]

    cfg = Fast3RConfig.flagship()
    model = Fast3R.from_random(cfg, seed=0, dtype=torch.bfloat16)
    plain = Fast3R(cfg.with_fused_blocks(False), model.params)
    mixed = [(384, 512)] * 8 + [(512, 384)] * 6 + [(448, 512)] * 6
    out = {}
    for name, m, shapes in (("fused 20x512x512", model, [(512, 512)] * 20),
                            ("fused mixed", model, mixed),
                            ("plain 20x384x512", plain, [(384, 512)] * 20)):
        v = views(shapes, 0)
        inference(v, m, verbose=False)
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            inference(v, m, verbose=False)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        out[name] = statistics.median(times)
    return out


def measure(pkg: str, label: str, with_requests: bool,
            only: str = "") -> dict:
    """The timings of the package under ``pkg`` (run in its own process);
    ``only`` "resize" or "layernorm" skips the other kernel."""
    sys.path.insert(0, pkg)
    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fast3r_torch.ops import fused_layernorm as fl
    from fast3r_torch.ops import resize_kernel as rk

    assert rk.__file__.startswith(os.path.abspath(pkg)), rk.__file__

    def device_ms(fn, sub, reps=50):
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
                 and (sub is None or sub in e.key))
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

    def times(fn, sub, host_calls):
        fn()
        torch.cuda.synchronize()
        r = {"device_ms": device_ms(fn, sub),
             "batched_ms": statistics.median(events_ms(fn, 10)
                                             for _ in range(3)),
             "single_ms": statistics.median(events_ms(fn, 1)
                                            for _ in range(20))}
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

    g = torch.Generator(device="cuda").manual_seed(0)
    res = {}
    for name, (shape, (H, W)) in RESIZE.items():
        if only == "layernorm":
            break
        x = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
        calls = 100 if shape[0] > 1 else 1000
        out = rk.resize_bilinear_kernel(x, H, W)
        res[name] = {**times(lambda: rk.resize_bilinear_kernel(x, H, W),
                             "resize_bilinear", calls), "sha256": sha(out)}
        if name in SAVED:
            OUT_DIR.mkdir(parents=True, exist_ok=True)
            torch.save(out.cpu(), OUT_DIR / f"{label}_{name.split()[1]}.pt")
        del out
        res["lib: " + name] = times(lambda: F.interpolate(
            x, size=(H, W), mode="bilinear", align_corners=True), None, calls)
        del x
        torch.cuda.empty_cache()
    for dtype in (torch.bfloat16, torch.float32):
        if only == "resize":
            break
        x = (torch.randn((15360, 1024), generator=g, device="cuda") * 3
             + 1).to(dtype)
        w = (1 + 0.1 * torch.randn((1024,), generator=g, device="cuda")).to(dtype)
        b = (0.1 * torch.randn((1024,), generator=g, device="cuda")).to(dtype)
        name = f"layernorm 15360x1024 {str(dtype).split('.')[-1]}"
        out = fl.fused_layernorm(x, w, b, 1e-6)
        ref = fl.layernorm_ref(x, w, b, 1e-6)
        res[name] = {**times(lambda: fl.fused_layernorm(x, w, b, 1e-6),
                             "ln_fwd", 1000), "sha256": sha(out),
                     "max_abs_vs_plain": (out.float() - ref.float()).abs()
                     .max().item()}
        res["lib: " + name] = times(lambda: F.layer_norm(x, (1024,), w, b, 1e-6),
                                    None, 1000)
    # pieces of a wrapper's host time, in microseconds a call
    from fast3r_torch.kernels import build

    lib = build.library()
    x = torch.empty((15360, 1024), device="cuda", dtype=torch.bfloat16)
    for name, fn in (("empty_like", lambda: torch.empty_like(x)),
                     ("ctypes_call", lib.fast3r_gemm_smem_bytes),
                     ("stream", lambda: torch.cuda.current_stream(x.device)
                      .cuda_stream)):
        t = time.perf_counter()
        for _ in range(1000):
            fn()
        res.setdefault("host_parts_us", {})[name] = (
            (time.perf_counter() - t) * 1e3)
    if with_requests:
        res["request_latency_s"] = requests(torch)
    return res


def compare_saved(labels: list) -> dict:
    """Elements of each copy's saved one-view outputs that differ from the
    first copy's, and the largest difference in bf16 steps of the first
    copy's largest magnitude."""
    import math

    import torch

    out = {}
    for name in SAVED:
        key = name.split()[1]
        first = torch.load(OUT_DIR / f"{labels[0]}_{key}.pt").float()
        step = 2.0 ** (math.floor(math.log2(first.abs().max().item())) - 7)
        for label in labels[1:]:
            other = torch.load(OUT_DIR / f"{label}_{key}.pt").float()
            d = (other - first).abs()
            out[f"{label} vs {labels[0]}: {name}"] = {
                "differ": int((d > 0).sum()),
                "max_bf16_steps": d.max().item() / step}
    return out


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
    ap.add_argument("--requests", action="store_true",
                    help="also time the flagship's requests on each DIR copy")
    ap.add_argument("--only", choices=("resize", "layernorm"), default="",
                    help="time one kernel only")
    ap.add_argument("--measure", nargs=3, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        pkg, label, reqs = args.measure
        print(json.dumps(measure(pkg, label, reqs == "1", args.only)),
              flush=True)
        return 0
    copies = [Path(d).resolve() for d in args.dirs] or [ROOT]
    timed = {c: args.requests for c in copies}
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
                                label, "1" if timed.get(d) else "0", *only],
                               capture_output=True, text=True)
            if r.returncode:
                print(r.stderr[-3000:], file=sys.stderr)
                return r.returncode
            print(json.dumps({"round": rnd, "copy": label,
                              **json.loads(r.stdout.strip().splitlines()[-1])}),
                  flush=True)
    if len(copies) > 1 and args.only != "layernorm":
        print(json.dumps({"saved_outputs": compare_saved(labels)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
