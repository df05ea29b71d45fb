"""Multiview data module: train/val loader construction from DSL strings.

Counterpart of ``fast3r_tpu/data/datamodule.py``.  The data is sliced over
the data-parallel ranks: ``world_size`` and ``rank`` are the data axis's
size and this process's data rank (on a ``data x model`` grid every model
rank of a data group takes the same indices, and the Trainer hands them
the first model rank's batch, since an unseeded dataset's augmentations
draw from each process's own entropy); they default to
``torch.distributed``'s world size and rank when it is initialised (1 and
0 otherwise), the grid of a run without tensor parallelism.  Behavioral reference: fast3r/data/multiview_dust3r_datamodule.py:18-209
(MultiViewDUSt3RDataModule): train datasets joined with '+' into one loader;
one val loader per dataset (resolutions differ across eval sets, so batches
stay single-dataset — the reference's CombinedLoader(sequential) semantics);
the spann3r eval sets (DTU/SevenScenes/NRGBD) forced to batch size 1
(:143-146).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from fast3r_torch.data.loader import DataLoader, get_data_loader

FORCED_BS1 = ("DTU", "SevenScenes", "NRGBD")


def _dist_world():
    """(world size, rank) of torch.distributed, (1, 0) without it."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class MultiViewDataModule:
    def __init__(
        self,
        train_datasets: Optional[List[str]] = None,
        validation_datasets: Optional[List[str]] = None,
        batch_size_per_device: int = 1,
        num_workers: int = 4,
        num_workers_val: int = 0,
        world_size: Optional[int] = None,
        rank: Optional[int] = None,
    ):
        if world_size is None or rank is None:
            ws, rk = _dist_world()
            world_size = ws if world_size is None else world_size
            rank = rk if rank is None else rank
        self.train_datasets = train_datasets or []
        self.validation_datasets = validation_datasets or []
        self.batch_size = batch_size_per_device
        self.num_workers = num_workers
        self.num_workers_val = num_workers_val
        self.world_size = world_size
        self.rank = rank

    def train_dataloader(self) -> Optional[DataLoader]:
        if not self.train_datasets:
            return None
        expr = " + ".join(self.train_datasets)
        return get_data_loader(
            expr, batch_size=self.batch_size, num_workers=self.num_workers,
            world_size=self.world_size, rank=self.rank,
        )

    def val_dataloaders(self) -> Dict[str, DataLoader]:
        out = {}
        for i, expr in enumerate(self.validation_datasets):
            bs = 1 if any(d in expr for d in FORCED_BS1) else self.batch_size
            vl = get_data_loader(
                expr, batch_size=bs, num_workers=self.num_workers_val,
                shuffle=False, drop_last=self.world_size > 1,
                world_size=self.world_size, rank=self.rank,
            )
            vl.set_epoch(0)
            out[f"dataset_{i}"] = vl
        return out
