"""Time the attention forward kernels of copies of fast3r_torch on one card,
in turns.

    python scripts/time_attention_fwd.py [--rounds 2] [--ablate noexp,nohop] [DIR ...]

Each DIR holds a ``fast3r_torch`` package; with none, this checkout's.  The
parent commit's, for instance: ``mkdir -p _check/parent && git archive
HEAD~1 fast3r_torch | tar -x -C _check/parent`` and pass ``_check/parent``.  ``--ablate`` adds copies of
this checkout's package with one timing-only edit of the CUDA sources
(their outputs are wrong; the ring's error below shows it):

  * ``noexp``: p = s c - m c without the exponential (MUFU's share);
  * ``nohop``: the ring's hops not copied (the protocol's traffic);
  * ``nostate``: the ring's online-softmax state not loaded back between
    epochs (still saved).

The copies live under ``_check/ab/`` (listed in ``.gitignore``) and build
their own kernels.  Round by round, each copy runs in a process of its own
and prints one JSON line: for K1 on the decoder's shape (1 x 15360 x 16 x
64, strided views of one qkv buffer), K2 on the encoder's packed (3, 20,
768, 1024) buffer and the ring at n = 1, 4 and 8 over the decoder's
sequence, [profiler device time of the bf16 forward kernels, CUDA-event
time of back-to-back calls over their count] in ms, and the ring's max
|o - plain ring| on two heads at n = 4.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ABLATIONS = {  # name -> (source, text, replacement)
    "noexp": ("attention_fwd_tile.cuh",
              "        v = ab::ex2(fmaf(v, scale_log2, -ms[h]));",
              "        v = fmaf(v, scale_log2, -ms[h]);"),
    "nohop": ("ring_protocol.cuh",
              "    if (j == 1)\n      first_hop(right, tid, nth);\n    else\n"
              "      hop_share(g, r, right, t, j & 1, c, tid, nth);\n", ""),
    "nostate": ("ring_attention.cu", "        x.load(st);", "        x.zero();"),
}


def measure(pkg: str) -> dict:
    """The timings of the package under ``pkg`` (run in its own process)."""
    sys.path.insert(0, pkg)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fast3r_torch.ops import flash_attention as fa
    from fast3r_torch.ops.batched_attention import packed_qkv_attention
    from fast3r_torch.parallel import ring_rdma as rr
    from fast3r_torch.parallel.sequence import ring_flash_attention

    assert fa.__file__.startswith(os.path.abspath(pkg)), fa.__file__
    g = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    dec = 0.125 * math.sqrt(math.log(137) / math.log(20))

    def times(fn, reps: int = 10):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum((getattr(e, "self_device_time_total", 0)
                  or getattr(e, "self_cuda_time_total", 0))
                 for e in prof.key_averages()
                 if "attention_fwd" in e.key and "f32" not in e.key
                 and "<float>" not in e.key)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return [us / reps / 1e3, a.elapsed_time(b) / reps]

    qkv = torch.randn((1, 15360, 3, 16, 64), generator=g, device="cuda").to(bf)
    qkv3 = torch.randn((3, 20, 768, 1024), generator=g, device="cuda").to(bf)
    res = {"k1": times(lambda: fa.launch_attention(
               qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], dec)),
           "k2": times(lambda: packed_qkv_attention(qkv3, 16, 0.125), 20)}
    for n in (1, 4, 8):
        x = torch.randn((n, 1, 15360 // n, 3, 16, 64), generator=g,
                        device="cuda").to(bf)
        q, k, v = x[:, :, :, 0], x[:, :, :, 1], x[:, :, :, 2]
        res[f"ring{n}"] = times(
            lambda: rr.ring_flash_attention_rdma(q, k, v, dec, n))
        if n == 4:
            o = rr.ring_flash_attention_rdma(q, k, v, dec, n)
            ref, _ = ring_flash_attention(q[..., :2, :], k[..., :2, :],
                                          v[..., :2, :], dec)
            res["ring4_err_2heads"] = (o[..., :2, :].float()
                                       - ref.float()).abs().max().item()
    return res


def ablated_copy(name: str) -> Path:
    """This checkout's package with the edit ``name`` applied."""
    d = ROOT / "_check" / "ab" / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(ROOT / "fast3r_torch", d / "fast3r_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    fname, old, new = ABLATIONS[name]
    src = d / "fast3r_torch" / "csrc" / fname
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
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        print(json.dumps(measure(args.measure)), flush=True)
        return 0
    copies = [Path(d).resolve() for d in args.dirs] or [ROOT]
    copies += [ablated_copy(a) for a in filter(None, args.ablate.split(","))]
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"gpu: {gpu}", flush=True)
    for rnd in range(args.rounds):
        for d in copies:
            r = subprocess.run([sys.executable, __file__, "--measure", str(d)],
                               capture_output=True, text=True)
            if r.returncode:
                print(r.stderr[-3000:], file=sys.stderr)
                return r.returncode
            label = d.name if d != ROOT else "this checkout"
            print(json.dumps({"round": rnd, "copy": label,
                              **json.loads(r.stdout.strip().splitlines()[-1])}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
