"""Rank-aware logging + CSV metric sink.

Counterpart of ``fast3r_tpu/utils/logging.py``.  Behavioral reference:
fast3r/utils/pylogger.py:13-57 (RankedLogger — rank-prefixed messages,
rank-zero-only filtering) and the csv/wandb logger group (configs/logger/*).
The rank is ``torch.distributed``'s when it is initialised, else 0; the
TensorBoard sink is the port's own event writer (``utils/tb_writer.py``),
the third-party sinks attach only if importable.
"""

from __future__ import annotations

import csv
import logging
import os
from typing import Any, Dict, Optional, Sequence

logging.basicConfig(
    level=os.environ.get("FAST3R_TORCH_LOGLEVEL", "INFO"),
    format="%(asctime)s %(levelname)s %(name)s: %(message)s",
)


def _rank() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class RankedLogger(logging.LoggerAdapter):
    """Prefixes messages with the process rank; optionally rank-zero only."""

    def __init__(self, name: str = __name__, rank_zero_only: bool = True):
        super().__init__(logging.getLogger(name), {})
        self.rank_zero_only = rank_zero_only

    def log(self, level, msg, *args, **kwargs):
        if self.isEnabledFor(level):
            rank = _rank()
            if self.rank_zero_only and rank != 0:
                return
            msg = f"[rank {rank}] {msg}"
            self.logger.log(level, msg, *args, **kwargs)


class _WandbSink:
    """Gated wandb mirror (configs/logger/wandb.yaml)."""

    def __init__(self):
        import wandb

        self._wandb = wandb
        wandb.init(project="fast3r_torch")

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        self._wandb.log(metrics, step=step)


class _MlflowSink:
    """Gated mlflow mirror (configs/logger/mlflow.yaml)."""

    def __init__(self):
        import mlflow

        self._mlflow = mlflow
        mlflow.start_run()

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        self._mlflow.log_metrics(
            {k.replace("/", "."): v for k, v in metrics.items()
             if isinstance(v, (int, float))}, step=step)


class _CometSink:
    """Gated comet mirror (configs/logger/comet.yaml)."""

    def __init__(self):
        import comet_ml

        self._exp = comet_ml.Experiment()

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        self._exp.log_metrics(metrics, step=step)


class _NeptuneSink:
    """Gated neptune mirror (configs/logger/neptune.yaml)."""

    def __init__(self):
        import neptune

        self._run = neptune.init_run()

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        for k, v in metrics.items():
            if isinstance(v, (int, float)):
                self._run[k].append(v, step=step)


class _AimSink:
    """Gated aim mirror (configs/logger/aim.yaml)."""

    def __init__(self):
        import aim

        self._run = aim.Run()

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        for k, v in metrics.items():
            if isinstance(v, (int, float)):
                self._run.track(v, name=k, step=step)


_GATED_SINKS = {
    "wandb": _WandbSink,
    "mlflow": _MlflowSink,
    "comet": _CometSink,
    "neptune": _NeptuneSink,
    "aim": _AimSink,
}


class MetricLogger:
    """Multiplexing metric logger (the reference's logger group,
    configs/logger/*.yaml incl. many_loggers.yaml).

    Always appends to a CSV (union-of-keys header managed lazily,
    csv.yaml); `sinks` attaches additional backends by name:
    "tensorboard" (self-contained event writer — works without the
    tensorboard package, utils/tb_writer.py) and the gated third-party
    mirrors wandb/mlflow/comet/neptune/aim (skipped with a warning when the
    package is missing)."""

    def __init__(self, csv_path: str,
                 sinks: Optional[Sequence[str]] = None):
        self.csv_path = csv_path
        os.makedirs(os.path.dirname(csv_path) or ".", exist_ok=True)
        self._fieldnames = None
        if os.path.exists(csv_path):
            # resume: adopt the existing header so prior rows are preserved
            with open(csv_path, newline="") as f:
                header = next(csv.reader(f), None)
            if header:
                self._fieldnames = list(header)

        self._sinks = []
        if _rank() == 0:
            for name in sinks or ():
                if name == "csv":
                    continue  # always on
                try:
                    if name == "tensorboard":
                        from fast3r_torch.utils.tb_writer import TBEventWriter

                        self._sinks.append(TBEventWriter(os.path.join(
                            os.path.dirname(csv_path) or ".", "tensorboard")))
                    elif name in _GATED_SINKS:
                        self._sinks.append(_GATED_SINKS[name]())
                    else:
                        raise ValueError(f"unknown metric sink {name!r}")
                except ImportError as e:
                    logging.getLogger(__name__).warning(
                        "metric sink %r unavailable (%s) — skipping", name, e)

    def log(self, **metrics: Any) -> None:
        if _rank() != 0:
            return
        if self._fieldnames is None or any(
            k not in self._fieldnames for k in metrics
        ):
            self._rewrite_with_fields(metrics)
        with open(self.csv_path, "a", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self._fieldnames)
            writer.writerow(metrics)
        step = int(metrics.get("step", 0))
        scalars = {k: float(v) for k, v in metrics.items()
                   if isinstance(v, (int, float))}
        for sink in self._sinks:
            if hasattr(sink, "add_scalars"):  # TBEventWriter
                sink.add_scalars(step, scalars)
            else:
                sink.log(step, scalars)

    def _rewrite_with_fields(self, metrics: Dict) -> None:
        old_rows = []
        if os.path.exists(self.csv_path):
            with open(self.csv_path) as f:
                old_rows = list(csv.DictReader(f))
        fields = list(self._fieldnames or [])
        for k in metrics:
            if k not in fields:
                fields.append(k)
        self._fieldnames = fields
        with open(self.csv_path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=fields)
            writer.writeheader()
            for row in old_rows:
                writer.writerow(row)
