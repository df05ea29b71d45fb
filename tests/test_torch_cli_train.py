"""The port's training entry point on the CPU: the metric sinks, the pose
metrics, the signal-driven checkpoint, validation's suite dispatch and
``python -m fast3r_torch.cli.train``, against fast3r_tpu where JAX has the
same piece.

* TensorBoard events: crc32c's known vectors; JAX's reader
  (``iter_records`` / ``decode_scalar_event``) reads the port's file.
  ``MetricLogger`` writes JAX's CSV for the same calls and keeps its rows
  across a resume.
* ``pose_metrics`` equals JAX's within 1e-5 on seeded random pose sets.  The
  angles themselves agree within 2e-3 degrees: both sides compute in float32
  and round in another order, and acos / arccos near +-1 turn a one-ulp
  difference of a cosine into up to 4e-4 degrees (measured).
* The CLI with ``--experiment debug_smoke --device cpu`` writes JAX's
  ``config.yaml`` for the same arguments, metrics.csv, TensorBoard events and
  checkpoints/last.pt; SIGUSR1 after the first step saves "last" and exits
  0, and ``--resume`` continues the step count; ``pretrained:`` loads a run
  directory the port wrote.
* Validation on a ``Co3d_Multiview`` loader gives JAX's key set, the pose
  keys included; a reconstruction dispatch raises (not ported yet).
"""

import csv
import glob
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from fast3r_torch.cli import train as cli
from fast3r_torch.eval import pose_metrics as tpm
from fast3r_torch.models.fast3r import Fast3RConfig
from fast3r_torch.train.step import OptimConfig
from fast3r_torch.train.trainer import Trainer, TrainerConfig
from fast3r_torch.utils import tb_writer as ttb
from fast3r_torch.utils.logging import MetricLogger

from fast3r_tpu.eval import pose_metrics as jpm
from fast3r_tpu.utils import tb_writer as jtb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE_DS = "DummyMultiview(num_scenes=4, num_views=2, resolution=[(64, 48)], seed=777)"
# debug_smoke with one head, no epoch checkpoint and small epochs: the
# paths under test are the same, the CPU time a fraction
LIGHT = ["model.head_args.with_local_head=False",
         "trainer.ckpt_every_n_epochs=100",
         f"data.validation_datasets=['2 @ {SMOKE_DS}']"]
THREADS = 2  # torch threads here and in the subprocess: the suite runs
             # several test processes on the same cores


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, THREADS))
    yield
    torch.set_num_threads(n)


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


# ---------------------------------------------------------------------------
# metric sinks
# ---------------------------------------------------------------------------

def test_crc32c_known_vectors():
    assert ttb.crc32c(b"") == 0x00000000
    assert ttb.crc32c(b"123456789") == 0xE3069283
    assert ttb.crc32c(bytes(32)) == 0x8A9136AA
    for data in (b"", b"abc", bytes(range(256))):
        assert ttb.masked_crc32c(data) == jtb.masked_crc32c(data)


def test_tb_events_read_by_jax(tmp_path):
    w = ttb.TBEventWriter(str(tmp_path))
    w.add_scalars(0, {"loss": 2.0})
    w.add_scalars(7, {"loss": 1.5, "val/x/pose/RRA_at_15": 0.25, "bad": "s"})
    (path,) = glob.glob(str(tmp_path / "events.out.tfevents.*"))
    recs = list(jtb.iter_records(open(path, "rb").read()))
    assert len(recs) == 3
    assert [jtb.decode_scalar_event(r) for r in recs[1:]] == [
        (0, {"loss": 2.0}), (7, {"loss": 1.5, "val/x/pose/RRA_at_15": 0.25})]
    assert recs[1] != ttb.encode_scalar_event(0, 0.0, {"loss": 2.0})  # time
    assert ttb.encode_scalar_event(3, 1.5, {"a": 1.0}) == \
        jtb.encode_scalar_event(3, 1.5, {"a": 1.0})


def test_metric_logger_matches_jax_and_survives_resume(tmp_path):
    from fast3r_tpu.utils.logging import MetricLogger as JaxLogger

    calls = [dict(step=1, epoch=0, loss=3.5), dict(step=2, epoch=0, loss=2.5,
                                                  lr=1e-4),
             dict(step=2, epoch=0, **{"val/d/loss": 1.0})]
    for cls, name in ((MetricLogger, "port"), (JaxLogger, "jax")):
        m = cls(str(tmp_path / name / "metrics.csv"), sinks=("tensorboard",))
        for c in calls[:2]:
            m.log(**c)
        m = cls(str(tmp_path / name / "metrics.csv"), sinks=("tensorboard",))
        m.log(**calls[2])
    port = (tmp_path / "port" / "metrics.csv").read_text()
    assert port == (tmp_path / "jax" / "metrics.csv").read_text()
    rows = _rows(tmp_path / "port" / "metrics.csv")
    assert [r["step"] for r in rows] == ["1", "2", "2"]
    assert rows[1]["lr"] == "0.0001" and rows[2]["val/d/loss"] == "1.0"
    events = [jtb.decode_scalar_event(r) for path in glob.glob(
        str(tmp_path / "port" / "tensorboard" / "*"))
        for r in jtb.iter_records(open(path, "rb").read())]
    assert sorted(step for step, m in events if m) == [1, 2, 2]
    MetricLogger(str(tmp_path / "m.csv"),
                 sinks=("mlflow", "comet", "neptune", "aim")).log(step=1)
    with pytest.raises(ValueError, match="unknown metric sink"):
        MetricLogger(str(tmp_path / "n.csv"), sinks=("nope",))


# ---------------------------------------------------------------------------
# pose metrics
# ---------------------------------------------------------------------------

def _pose_sets(seed):
    rng = np.random.default_rng(seed)
    n = 9  # one shape: JAX compiles its functions once
    gt = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    gt[:, :3, :3] = Rotation.random(n, random_state=seed).as_matrix()
    gt[:, :3, 3] = rng.standard_normal((n, 3))
    pred = gt.copy()
    noise = Rotation.from_rotvec(rng.standard_normal((n, 3)) * np.deg2rad(
        rng.uniform(1, 25))).as_matrix()
    pred[:, :3, :3] = noise @ gt[:, :3, :3]
    pred[:, :3, 3] += rng.standard_normal((n, 3)) * rng.uniform(0.05, 0.6)
    return pred, gt


@pytest.mark.parametrize("seed", range(6))
def test_pose_metrics_match_jax(seed):
    pred, gt = _pose_sets(seed)
    got, want = tpm.pose_metrics(pred, gt), jpm.pose_metrics(pred, gt)
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5, k
    for a, b in zip(tpm.camera_to_rel_deg(pred, gt),
                    jpm.camera_to_rel_deg(pred, gt)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=2e-3)
    assert tpm.calculate_auc(*tpm.camera_to_rel_deg(pred, gt)) == \
        jpm.calculate_auc(*jpm.camera_to_rel_deg(pred, gt))


def test_pose_metrics_exact_poses():
    _, gt = _pose_sets(7)
    m = tpm.pose_metrics(gt, gt)
    assert m == jpm.pose_metrics(gt, gt)
    assert all(m[f"RRA_at_{t}"] == 1.0 for t in (5, 15, 30))


# ---------------------------------------------------------------------------
# the trainer: signals and validation dispatch
# ---------------------------------------------------------------------------

def _tiny_trainer(tmp_path, **kw):
    return Trainer(Fast3RConfig.tiny(), OptimConfig(warmup_steps=2,
                                                    total_steps=50),
                   trainer_cfg=TrainerConfig(run_dir=str(tmp_path), remat=False,
                                             log_every_n_steps=1, **kw),
                   device="cpu")


def test_signal_handlers_set_a_flag_and_restore(tmp_path):
    before = signal.getsignal(signal.SIGUSR1)
    tr = _tiny_trainer(tmp_path)
    tr.install_signal_handlers()
    os.kill(os.getpid(), signal.SIGUSR1)
    time.sleep(0.05)
    assert tr._stop_requested
    tr.restore_signal_handlers()
    assert signal.getsignal(signal.SIGUSR1) is before


def test_validation_keys_match_jax_on_co3d(tmp_path):
    """The port's validate on a Co3d_Multiview loader (pose suite
    auto-dispatched from the "Co3d_v2" label) against JAX's on the same
    DSL string and weights: the same result keys."""
    from test_torch_data import make_co3d_root

    from fast3r_tpu.data.loader import get_data_loader as jax_loader
    from fast3r_tpu.models.fast3r import Fast3RConfig as JaxConfig
    from fast3r_tpu.train.losses import LossConfig as JaxLoss
    from fast3r_tpu.train.step import OptimConfig as JaxOptim
    from fast3r_tpu.train.trainer import Trainer as JaxTrainer
    from fast3r_tpu.train.trainer import TrainerConfig as JaxTrainerConfig

    from fast3r_torch.data.loader import get_data_loader
    from fast3r_torch.utils.convert import params_to_jax

    root = make_co3d_root(str(tmp_path / "co3d"))
    spec = (f"1 @ Co3d_Multiview(split='test', num_views=2, "
            f"window_degree_range=360, num_samples_per_window=2, "
            f"ROOT='{root}', resolution=(64, 48), seed=777)")
    loader = get_data_loader(spec, 1, num_workers=0, shuffle=False)
    loader.set_epoch(0)
    port_tr = _tiny_trainer(tmp_path / "port")
    port = port_tr.validate({"co3d": loader}, epoch=1)
    jl = jax_loader(spec, 1, num_workers=0, shuffle=False)
    jl.set_epoch(0)
    jt = JaxTrainer(JaxConfig.tiny(), JaxOptim(warmup_steps=2, total_steps=50),
                    JaxLoss(), JaxTrainerConfig(run_dir=str(tmp_path / "jax"),
                                                remat=False),
                    init_params=params_to_jax(port_tr.state.params.state_dict(),
                                              port_tr.model_cfg))
    ref = jt.validate({"co3d": jl}, epoch=1)
    assert sorted(port) == sorted(ref)
    assert "val/co3d/pose/RRA_at_15" in port and "val/co3d/loss" in port
    assert all(np.isfinite(v) for v in port.values())
    forced = port_tr.validate({"co3d": loader}, epoch=1,
                              eval_recon={"co3d": True})
    recon = {k: v for k, v in forced.items() if "/recon/" in k}
    assert sorted(recon) == [f"val/co3d/recon/{k}" for k in (
        "accuracy", "accuracy_median", "completion", "completion_median",
        "nc1", "nc1_median", "nc2", "nc2_median")]
    assert all(np.isfinite(v) for v in recon.values())
    rows = _rows(tmp_path / "port" / "metrics.csv")
    assert rows[-1]["val/co3d/pose/mAA_30"] != ""


@pytest.mark.parametrize("every, raising", [(5, (0, 4)), (2, (0, 1, 3))])
def test_recon_val_every_n_epochs(tmp_path, every, raising):
    """A loader whose dataset names a reconstruction suite dispatches it at
    epoch 0 and every ``recon_val_every_n_epochs``-th epoch (``raising``
    lists them): the recon metrics join its loss there, finite; at the
    others only its loss is recorded."""
    from fast3r_torch.data.dummy import make_dummy_batch

    batch = dict(make_dummy_batch(1, 2, 48, 64, seed=0),
                 dataset=[["DTU", "DTU"]])
    tr = _tiny_trainer(tmp_path, recon_val_every_n_epochs=every)
    for epoch in range(5):
        out = tr.validate({"dtu": [batch]}, epoch=epoch)
        assert np.isfinite(out["val/dtu/loss"])
        recon = sorted(k for k in out if k.startswith("val/dtu/recon/"))
        if epoch in raising:
            assert "val/dtu/recon/accuracy" in recon and len(recon) == 8
            assert all(np.isfinite(out[k]) for k in recon)
        else:
            assert sorted(out) == ["val/dtu/loss"]


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def _smoke_args(run_dir, *extra):
    return ["--experiment", "debug_smoke", "--device", "cpu",
            f"paths.run_dir={run_dir}", *LIGHT, *extra]


def test_cli_debug_smoke_writes_the_run(tmp_path):
    from fast3r_tpu.config import load_config as jax_load
    from fast3r_tpu.config import save_config as jax_save

    import fast3r_tpu

    run = tmp_path / "run"
    extra = ["optim.lr=2e-4", f"data.train_datasets=['4 @ {SMOKE_DS}']"]
    tr = cli.main(["--no-resume", *_smoke_args(run, *extra)])
    want = jax_save(jax_load(os.path.join(os.path.dirname(fast3r_tpu.__file__),
                                          "configs", "train.yaml"),
                             "debug_smoke",
                             [f"paths.run_dir={run}", *LIGHT, *extra]),
                    str(tmp_path / "jax"))
    assert (run / "config.yaml").read_text() == open(want).read()
    assert tr.state.step == 2 and tr.epoch == 1
    rows = _rows(run / "metrics.csv")
    losses = [float(r["loss"]) for r in rows if r["loss"]]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert rows[-1]["val/dataset_0/loss"]
    assert glob.glob(str(run / "tensorboard" / "events.out.tfevents.*"))
    assert (run / "checkpoints" / "last.pt").exists()
    assert next(tr.state.params.parameters()).dtype == torch.float32

    # pretrained: a port run directory's weights replace the random ones;
    # --profile-dir traces steps 3-5 of the 6 (one skipped, one warm-up)
    prof = tmp_path / "prof"
    tr2 = cli.main([
        "--no-resume", "--profile-dir", str(prof),
        *_smoke_args(tmp_path / "run2", f"pretrained={run}", "optim.lr=0.0",
                     "data.validation_datasets=[]",
                     f"data.train_datasets=['12 @ {SMOKE_DS}']")])
    assert tr2.state.step == 6
    for k, v in tr.state.params.state_dict().items():
        torch.testing.assert_close(tr2.state.params.state_dict()[k], v,
                                   rtol=0, atol=0, msg=k)
    (trace,) = glob.glob(str(prof / "*.json"))
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    assert {e["name"] for e in events if e.get("name", "").startswith(
        "ProfilerStep#")} == {f"ProfilerStep#{i}" for i in (2, 3, 4)}


def test_cli_sigusr1_checkpoint_then_resume(tmp_path):
    """Run 1 (a subprocess, a 100-step epoch) gets SIGUSR1 once metrics.csv
    has a row: it saves "last" and exits 0 well before the epoch's end.
    Run 2 resumes in this process on a 2-step epoch and continues the step
    count."""
    run = tmp_path / "run"
    handler = signal.getsignal(signal.SIGUSR1)
    log = open(tmp_path / "run1.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "fast3r_torch.cli.train", "--no-resume",
         *_smoke_args(run, f"data.train_datasets=['200 @ {SMOKE_DS}']")],
        cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS=str(THREADS)))
    try:
        deadline = time.time() + 240
        while proc.poll() is None and time.time() < deadline:
            if (run / "metrics.csv").exists() and _rows(run / "metrics.csv"):
                proc.send_signal(signal.SIGUSR1)
                break
            time.sleep(0.05)
        assert proc.wait(timeout=240) == 0, (tmp_path / "run1.log").read_text()
    finally:
        if proc.poll() is None:
            proc.kill()
    assert "stopping for requeue" in (tmp_path / "run1.log").read_text()
    assert (run / "checkpoints" / "last.pt").exists()
    stopped = int(_rows(run / "metrics.csv")[-1]["step"])
    assert 1 <= stopped < 100
    blob = torch.load(run / "checkpoints" / "last.pt", weights_only=True)
    assert blob["step"] == stopped and blob["epoch"] == 0

    tr = cli.main(["--resume", *_smoke_args(
        run, f"data.train_datasets=['4 @ {SMOKE_DS}']")])
    assert tr.state.step == stopped + 2 and tr.epoch == 1
    rows = _rows(run / "metrics.csv")
    steps = [int(r["step"]) for r in rows if r["loss"]]
    assert steps == list(range(1, stopped + 3))
    assert rows[-1]["val/dataset_0/loss"]
    assert signal.getsignal(signal.SIGUSR1) is handler
