"""Where a tensor-parallel sublayer adds its residual, and what it costs in
bf16, on one card.

    python scripts/tp_residual_rounding.py [case] [road ...]

``case`` is one of ``chip_smoke.tp_cfg``'s ("llama", the default; "dino";
"drop").  Each road takes ``chip_smoke.py`` phase 28's two steps of that
case on a data 1 x model 2 grid of two processes sharing the card over
gloo, from the one-process Trainer's weights:

  after_sum  the port's road: each rank's K5 / K6 partial output (no
             residual, the bias on model rank 0), summed over the model
             group, then the residual added and rounded once;
  rank0      the residual inside model rank 0's epilogue (K5's residual
             epilogue, K6 with x), then the sum: the residual stream
             rounded twice more a sublayer.

and prints, beside the one-process road's losses and its rounding floor
(the same steps on the plain block roads), each road's losses, their
relative distance from the one-process road's, and each top-level group's
update against the one-process road's (relative L2), with the card's name
and power limit.  Needs the CUDA toolkit and one card.
"""

import json
import os
import socket
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

ROADS = ("after_sum", "rank0")


def _port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank0_residual_road() -> None:
    """Put the residual back inside model rank 0's epilogue."""
    from fast3r_torch.nn import fused_block as fb

    def matmul_residual(x, w, bias, residual, tp=None):
        if tp is None:
            return mine(x, w, bias, residual)
        if tp.model_rank != 0:
            residual, bias = None, torch.zeros_like(bias)
        return tp.all_reduce_model(mine(x, w, bias, residual))

    def ln_mlp(x, gamma, beta, w1, b1, w2, b2, eps, tp=None):
        if tp is None:
            return fb._ln_mlp(x, gamma, beta, w1, b1, w2, b2, eps)
        first = tp.model_rank == 0
        return tp.all_reduce_model(fb._ln_mlp(
            x, gamma, beta, w1, b1, w2, b2 if first else torch.zeros_like(b2),
            eps, residual=first))

    mine = fb._matmul_residual
    fb._matmul_residual = matmul_residual
    fb._ln_mlp_tp = ln_mlp


def _worker(rank, world, port, case, road, out):
    import chip_smoke as cs
    from fast3r_torch.train.trainer import Trainer, TrainerConfig

    torch.cuda.set_device(0)
    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    if road == "rank0":
        _rank0_residual_road()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    cfg = cs.tp_cfg(case)
    tr = Trainer(cfg, cs.TP_OPT, trainer_cfg=TrainerConfig(
        run_dir=f"{out}_run", loggers=(), use_mesh=True,
        model_axis=cs.TP_MODEL), device="cuda")
    losses = []
    for batch in cs._tp_batches(case):
        tr.state, m = cs.train_step(tr.state, batch, cfg, cs.TP_OPT, remat=True)
        losses.append(float(m["loss"]))
    master = tr.params_state_dict()
    if rank == 0:
        torch.save({"losses": losses, "master": master}, out)
    dist.destroy_process_group()


def main(argv) -> int:
    import chip_smoke as cs
    from fast3r_torch.train.trainer import TrainerConfig

    if not torch.cuda.is_available():
        print("tp_residual_rounding: no CUDA device", file=sys.stderr)
        return 2
    case = argv[0] if argv else "llama"
    roads = argv[1:] or list(ROADS)
    gpu = cs.phase_device()["gpu"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cs.tp_cfg(case)
    net = cs.init_fast3r(cfg, seed=TrainerConfig().seed, device="cpu")
    before = {k: v.detach() for k, v in net.named_parameters()}
    ref = cs._tp_one_process(case, cfg, net, gpu)
    del net
    cs.log(json.dumps({
        "case": case, "one_process_losses": ref["losses"],
        "floor_losses": ref["floor_losses"],
        "floor_update_rel_l2": cs._group_update_err(
            before, ref["floor_after"], ref["after"])}))
    with tempfile.TemporaryDirectory() as tmp:
        for road in roads:
            out = os.path.join(tmp, f"{road}.pt")
            t = time.perf_counter()
            mp.spawn(_worker, args=(cs.TP_MODEL, _port(), case, road, out),
                     nprocs=cs.TP_MODEL)
            res = torch.load(out, mmap=True)
            cs.log(json.dumps({
                "case": case, "road": road, "losses": res["losses"],
                "loss_rel": [abs(a - b) / abs(b)
                             for a, b in zip(res["losses"], ref["losses"])],
                "update_rel_l2": cs._group_update_err(before, res["master"],
                                                      ref["after"]),
                "seconds": time.perf_counter() - t, "gpu": gpu}))
            del res
    cs.log(cs.gpu_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
