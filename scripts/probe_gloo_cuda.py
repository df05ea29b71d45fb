"""Which collectives gloo takes on CUDA tensors, on this machine's torch.

    python scripts/probe_gloo_cuda.py

Spawns two processes on GPU 0 in one gloo process group and calls each
collective the port's mesh uses (``all_reduce``, ``reduce_scatter_tensor``,
``all_gather_into_tensor``) plus ``broadcast`` on CUDA tensors, one process
group per collective so that a refusal leaves the next one untouched.
Prints one JSON line: for each collective "ok" (the result right), the
wrong result, or the error's first line.  ``fast3r_torch.parallel.mesh``
hands CUDA tensors to gloo as they are, which holds where this script
prints "ok" for all four.
"""

from __future__ import annotations

import json
import socket
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 2


def _port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _calls(rank: int):
    dev = torch.device("cuda", 0)
    return {
        "all_reduce": (lambda: dist.all_reduce(
            t := torch.full((8,), float(rank + 1), device=dev)) or t,
            lambda t: t.tolist() == [3.0] * 8),
        "reduce_scatter_tensor": (lambda: _rs(dev, rank),
                                  lambda t: t.tolist() == [2.0 * (2 * rank + i)
                                                           for i in range(2)]),
        "all_gather_into_tensor": (lambda: _ag(dev, rank),
                                   lambda t: t.tolist() == [0.0, 0.0, 1.0, 1.0]),
        "broadcast": (lambda: _bc(dev, rank),
                      lambda t: t.tolist() == [7.0] * 4),
    }


def _rs(dev, rank):
    out = torch.empty(2, device=dev)
    dist.reduce_scatter_tensor(out, torch.arange(4.0, device=dev))
    return out


def _ag(dev, rank):
    out = torch.empty(4, device=dev)
    dist.all_gather_into_tensor(out, torch.full((2,), float(rank), device=dev))
    return out


def _bc(dev, rank):
    t = torch.full((4,), 7.0 if rank == 0 else 0.0, device=dev)
    dist.broadcast(t, 0)
    return t


def _worker(rank: int, ports: dict, queue) -> None:
    torch.cuda.set_device(0)
    res = {}
    for name, (call, check) in _calls(rank).items():
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                                f"{ports[name]}", world_size=WORLD, rank=rank)
        try:
            out = call()
            torch.cuda.synchronize()
            res[name] = "ok" if check(out.cpu()) else f"wrong {out.tolist()}"
        except RuntimeError as e:  # gloo's refusal of the tensor's device
            res[name] = str(e).splitlines()[0][:200]
        finally:
            dist.destroy_process_group()
    queue.put((rank, res))


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_gloo_cuda: no CUDA device", file=sys.stderr)
        return 2
    ports = {name: _port() for name in _calls(0)}
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_worker, args=(r, ports, queue))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    got = dict(queue.get(timeout=300) for _ in procs)
    for p in procs:
        p.join(timeout=60)
        if p.is_alive():
            p.kill()
    print(json.dumps({"torch": torch.__version__, "gloo_on_cuda": got[0],
                      "rank1": got[1]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
