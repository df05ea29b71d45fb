"""Time the kernels that the head_dim-80 / width-1280 widening touched, in
copies of fast3r_torch on one card, in turns, at the flagship's shapes.

    python scripts/time_widened.py [--rounds 2] DIR [DIR ...]

Each DIR holds a ``fast3r_torch`` package (the parent commit's, for
instance: ``mkdir -p _check/parent && git archive HEAD~1 fast3r_torch | tar
-x -C _check/parent``); each copy builds its own kernels.  Round by round,
each copy runs in a process of its own and prints one JSON line: for each
kernel at its flagship shape (head_dim 64, width 1024: M = 15360 rows, the
decoder's 1 x 15360 x 16 x 64 attention, the encoder's 20 x 768 one),
[CUDA-event time of one launch, CUDA-event time of 10 back-to-back calls
over their count] in ms, and a checksum of its output (the copies compute
the same bits where their arithmetic is the same).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def measure(pkg: str) -> dict:
    """The timings of the package under ``pkg`` (run in its own process)."""
    sys.path.insert(0, pkg)
    import torch

    from fast3r_torch.nn import fused_block as fb
    from fast3r_torch.ops import flash_attention as fa
    from fast3r_torch.ops.rope2d import expand_rope_tables, rope2d_cos_sin

    assert fb.__file__.startswith(os.path.abspath(pkg)), fb.__file__
    g = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    M, C, HID = 15360, 1024, 4096

    def rnd(shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale
                + shift).to(bf)

    def lin(n_out, n_in):
        return rnd((n_out, n_in), n_in ** -0.5), rnd((n_out,), 0.02)

    def event_ms(fn, calls):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / calls

    def times(fn):
        fn()
        torch.cuda.synchronize()
        single = statistics.median(event_ms(fn, 1) for _ in range(20))
        batched = statistics.median(event_ms(fn, 10) for _ in range(3))
        return [single, batched]

    def checksum(t):
        t = torch.stack(t) if isinstance(t, (tuple, list)) else t
        return float(t.float().abs().sum())

    x, gamma, beta = rnd((M, C), 2.0, 0.5), rnd((C,), 0.1, 1.0), rnd((C,), 0.1)
    wqkv, bqkv = lin(3 * C, C)
    wproj, bproj = lin(C, C)
    w1, b1 = lin(HID, C)
    w2, b2 = lin(C, HID)
    o, h = rnd((M, C), 0.5), rnd((M, HID), 0.5)
    yy, xx = torch.meshgrid(torch.arange(24), torch.arange(32), indexing="ij")
    pos = torch.stack([yy, xx], -1).reshape(1, -1, 2).repeat(20, 1, 1).cuda()
    ct, st = expand_rope_tables(*rope2d_cos_sin(pos, 64), C, bf)
    dec = rnd((1, M, 3, 16, 64))
    enc = rnd((20, 768, 3, 16, 64))
    dq, dk, dv = dec[:, :, 0], dec[:, :, 1], dec[:, :, 2]
    do = rnd((1, M, 16, 64))
    o_dec, lse = fa.attention_fwd_lse(dq, dk, dv, 0.125)
    cases = {
        "ln_qkv": lambda: fb.ln_qkv(x, gamma, beta, wqkv, bqkv, 1e-5),
        "ln_qkv_rope": lambda: fb.ln_qkv_rope(x, gamma, beta, wqkv, bqkv, ct,
                                              st, 16, 1e-6),
        "ln_matmul_gelu": lambda: fb.ln_matmul(x, gamma, beta, w1, b1, 1e-6,
                                               act="gelu"),
        "replay_fc1": lambda: fb.ln_matmul_replay(x, gamma, beta, w1, b1, 1e-6,
                                                  act="gelu")[0],
        "matmul_residual_proj": lambda: fb.matmul_residual(o, wproj, bproj, x),
        "matmul_residual_fc2": lambda: fb.matmul_residual(h, w2, b2, x),
        "ln_mlp": lambda: fb.ln_mlp(x, gamma, beta, w1, b1, w2, b2, 1e-6),
        "rms_qkv3": lambda: fb.rms_qkv3(x, gamma, wqkv[:C], wqkv[C:2 * C],
                                        wqkv[2 * C:], 1e-5)[0],
        "attention_decoder": lambda: fa.flash_attention(dq, dk, dv, 0.125),
        "attention_encoder": lambda: fa.flash_attention(
            enc[:, :, 0], enc[:, :, 1], enc[:, :, 2], 0.125),
        "attention_bwd_decoder": lambda: fa.attention_bwd(
            dq, dk, dv, o_dec, lse, do, 0.125)[0],
    }
    out = {}
    with torch.inference_mode():
        for name, fn in cases.items():
            out[name] = times(fn) + [checksum(fn())]
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        print(json.dumps(measure(args.measure)), flush=True)
        return 0
    dirs = [os.path.abspath(d) for d in args.dirs]
    order = []
    for r in range(args.rounds):  # A B ... then ... B A
        order += dirs if r % 2 == 0 else dirs[::-1]
    for d in order:
        res = subprocess.run([sys.executable, __file__, "--measure", d, d],
                             capture_output=True, text=True, cwd=str(ROOT))
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return res.returncode
        print(json.dumps({"copy": os.path.relpath(d, ROOT),
                          **json.loads(res.stdout.strip().splitlines()[-1])}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
