"""Batch collation + multiprocess data loading.

Counterpart of ``fast3r_tpu/data/loader.py``.  Replaces the reference's torch
DataLoader + collate usage (dust3r/datasets/__init__.py:28-64, inference
collate_with_cat in dust3r/utils/device.py) with a torch-free host pipeline:
a ``spawn`` process pool keyed by a per-worker dataset copy, bounded
prefetch, a shared-memory transport for the large arrays, and numpy
collation straight into the (B, V, ...) stacked layout the train step
consumes.  Workers never touch CUDA: the datasets are numpy and PIL, batches
cross as numpy, and the trainer moves them to the card.  Workers ignore
SIGUSR1 (the trainer's requeue signal, which a cluster may send to the whole
process group), so the parent checkpoints with its pool intact.

Determinism contract preserved: the sampler is epoch-seeded (epoch + 777) and
seeded datasets draw per-item rngs (seed + idx), so worker scheduling cannot
change the data (reference §5.6 / base_stereo_view_dataset.py:86-91).
"""

from __future__ import annotations

import functools
import itertools
from concurrent.futures import ProcessPoolExecutor
from typing import Any, Dict, Iterable, List, Optional, Sequence

import numpy as np

_WORKER_DATASET = None

STACK_KEYS = (
    "img", "true_shape", "pts3d", "valid_mask", "camera_pose",
    "camera_intrinsics", "depthmap",
)
BATCH_KEY_RENAME = {"img": "imgs", "true_shape": "true_shapes"}


def collate_views(samples: Sequence[Sequence[Dict]]) -> Dict[str, Any]:
    """Stack a list over batch of lists over views into (B, V, ...) arrays.

    Non-array metadata (labels, instances, idx) is kept as nested lists.
    """
    B = len(samples)
    V = len(samples[0])
    assert all(len(s) == V for s in samples), "uneven view counts in batch"
    out: Dict[str, Any] = {}
    for key in samples[0][0]:
        if key in STACK_KEYS:
            arr = np.stack([
                np.stack([np.asarray(s[v][key]) for v in range(V)])
                for s in samples
            ])
            out[BATCH_KEY_RENAME.get(key, key)] = arr
        else:
            out[key] = [[s[v].get(key) for v in range(V)] for s in samples]
    return out


_WORKER_EPOCH = None


def _init_worker(dataset):
    import signal

    global _WORKER_DATASET
    signal.signal(signal.SIGUSR1, signal.SIG_IGN)
    _WORKER_DATASET = dataset


def _load_batch(epoch: Optional[int], idxs: List):
    # propagate the epoch into the worker's dataset copy: ResizedDataset's
    # index permutation is epoch-seeded, so a stale epoch would silently
    # replay epoch-0 data every epoch
    global _WORKER_EPOCH
    if epoch is not None and epoch != _WORKER_EPOCH:
        _WORKER_DATASET.set_epoch(epoch)
        _WORKER_EPOCH = epoch
    return [_WORKER_DATASET[i] for i in idxs]


# ---------------------------------------------------------------------------
# shared-memory array transport
# ---------------------------------------------------------------------------
#
# Pickling a batch's arrays through the pool's result pipe caps the loader's
# throughput (the JAX package measured its 6 workers slower than inline, on
# a TPU host, at ~6 MB/view of f32 payload).  Instead the worker packs every large array of the batch into ONE
# SharedMemory block and returns just (block name, index); the parent
# reconstructs with a single memcpy per array and unlinks the block.  This
# is the same trick torch's DataLoader plays with tensors in shared memory
# (reference relies on it implicitly via torch multiprocessing).

_SHM_MIN_BYTES = 1 << 16  # small arrays ride the pickle path

# block names carry a tag of this checkout, the OWNING PARENT's pid and a
# per-loader tag, so that (a) a fresh loader can sweep blocks leaked by a
# crashed/killed parent of the same checkout (liveness-checked by pid) and
# (b) close() can reclaim exactly its own loader's in-flight blocks — a hard
# parent kill between worker return and _shm_unpack would otherwise leak
# /dev/shm blocks permanently.  /dev/shm is machine-wide: the checkout tag
# (its temporary directory and PID namespace) keeps a sweep away from the
# blocks of other checkouts, whose pids it cannot check
_SHM_DIR = "/dev/shm"
_SHM_BLOCK_COUNTER = itertools.count()


def _shm_tag() -> str:
    """``f3r{hash}_``: the hash of this process's temporary directory and PID
    namespace, the same for every process of one checkout's runs."""
    import hashlib
    import os
    import tempfile

    try:
        ns = os.readlink("/proc/self/ns/pid")
    except OSError:
        ns = ""
    key = f"{os.path.realpath(tempfile.gettempdir())}|{ns}"
    return f"f3r{hashlib.sha1(key.encode()).hexdigest()[:10]}_"


def _sweep_stale_shm(prefix: Optional[str] = None) -> int:
    """Unlink /dev/shm blocks of this checkout whose embedded owner pid is
    no longer alive.

    Names look like {prefix}{parent_pid}_{loader_tag}_{worker_pid}_{n} with
    ``prefix`` this checkout's ``_shm_tag()``.  Blocks of LIVE parents and
    of other checkouts are never touched.  Returns the number removed."""
    import os

    prefix = prefix or _shm_tag()
    removed = 0
    if not os.path.isdir(_SHM_DIR):
        return 0
    for name in os.listdir(_SHM_DIR):
        if not name.startswith(prefix):
            continue
        try:
            pid = int(name[len(prefix):].split("_", 1)[0])
        except (ValueError, IndexError):
            continue
        try:
            os.kill(pid, 0)
            continue  # owner alive — not ours to reclaim
        except ProcessLookupError:
            pass
        except PermissionError:
            continue  # alive, different user
        try:
            os.unlink(os.path.join(_SHM_DIR, name))
            removed += 1
        except OSError:
            pass
    return removed


def _shm_pack(views_batch, name_prefix=None):
    """Replace large ndarrays in [scene][view] dicts with placeholders and
    pack their bytes into one SharedMemory block."""
    import os

    from multiprocessing import shared_memory

    arrays = []
    total = 0
    skeleton = []
    for views in views_batch:
        out_views = []
        for view in views:
            out = {}
            for key, val in view.items():
                if (isinstance(val, np.ndarray)
                        and val.nbytes >= _SHM_MIN_BYTES):
                    arr = np.ascontiguousarray(val)
                    out[key] = ("__shm__", len(arrays), arr.shape,
                                arr.dtype.str)
                    arrays.append((total, arr))
                    total += arr.nbytes
                else:
                    out[key] = val
            out_views.append(out)
        skeleton.append(out_views)
    if not arrays:
        return None, skeleton
    if name_prefix:
        block = f"{name_prefix}{os.getpid()}_{next(_SHM_BLOCK_COUNTER)}"
        shm = shared_memory.SharedMemory(name=block, create=True, size=total)
    else:
        shm = shared_memory.SharedMemory(create=True, size=total)
    for offset, arr in arrays:
        shm.buf[offset:offset + arr.nbytes] = arr.tobytes()
    name = shm.name
    shm.close()
    # the PARENT owns the block's lifetime (it unlinks after the copy-out);
    # keep this worker's resource_tracker from reclaiming it at pool
    # shutdown and warning about a leak
    try:
        from multiprocessing import resource_tracker

        resource_tracker.unregister(f"/{name}", "shared_memory")
    except Exception:
        pass
    offsets = [off for off, _ in arrays]
    return (name, offsets), skeleton


def _shm_unpack(packed):
    """Parent side: rebuild the [scene][view] dicts, one memcpy per array."""
    from multiprocessing import shared_memory

    meta, skeleton = packed
    if meta is None:
        return skeleton
    name, offsets = meta
    shm = shared_memory.SharedMemory(name=name)
    try:
        out_batches = []
        for views in skeleton:
            out_views = []
            for view in views:
                out = {}
                for key, val in view.items():
                    if isinstance(val, tuple) and len(val) == 4 \
                            and val[0] == "__shm__":
                        _, i, shape, dtype = val
                        arr = np.ndarray(shape, dtype,
                                         buffer=shm.buf, offset=offsets[i])
                        out[key] = arr.copy()
                    else:
                        out[key] = val
                out_views.append(out)
            out_batches.append(out_views)
        return out_batches
    finally:
        shm.close()
        shm.unlink()


def _load_batch_shm(epoch: Optional[int], idxs: List, name_prefix=None):
    return _shm_pack(_load_batch(epoch, idxs), name_prefix=name_prefix)


class DataLoader:
    """Minimal prefetching loader over a BatchedRandomSampler.

    num_workers=0 loads inline (debugging); otherwise a process pool with
    `prefetch` batches in flight.
    """

    def __init__(self, dataset, batch_size: int, sampler=None,
                 num_workers: int = 0, collate_fn=collate_views,
                 prefetch: int = 4, drop_last: bool = True,
                 shm: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.num_workers = num_workers
        self.collate_fn = collate_fn
        self.prefetch = max(prefetch, 1)
        self.drop_last = drop_last
        # shared-memory array transport (see _shm_pack): multiplies loader
        # throughput at flagship view sizes vs pickling through the result
        # pipe; disable to debug worker payloads
        self.shm = shm
        self._pool: Optional[ProcessPoolExecutor] = None
        self._epoch: Optional[int] = None
        # per-loader SHM tag: {checkout tag}{parent_pid}_{loader_tag}_ —
        # lets close() reclaim exactly this loader's blocks and a later
        # parent of this checkout sweep dead-pid leftovers (_sweep_stale_shm)
        import os

        self._shm_prefix = f"{_shm_tag()}{os.getpid()}_{id(self):x}_"

    def set_epoch(self, epoch: int):
        """Seed the sampler + dataset (and, lazily, each worker's dataset
        copy) for `epoch`.  Call before iterating each epoch."""
        self._epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)
        if self.sampler is not None and hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)

    def __len__(self):
        n = len(self.sampler) if self.sampler is not None else len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self) -> Iterable[List]:
        it = iter(self.sampler) if self.sampler is not None else iter(
            range(len(self.dataset)))
        while True:
            batch = list(itertools.islice(it, self.batch_size))
            if not batch or (self.drop_last and len(batch) < self.batch_size):
                return
            yield batch

    def __iter__(self):
        if self.num_workers == 0:
            for idxs in self._index_batches():
                yield self.collate_fn([self.dataset[i] for i in idxs])
            return

        epoch = self._epoch
        self.start()
        if self.shm:
            load = functools.partial(_load_batch_shm,
                                     name_prefix=self._shm_prefix)
            unpack = _shm_unpack
        else:
            load, unpack = _load_batch, (lambda r: r)
        batches = self._index_batches()
        inflight = []
        try:
            for idxs in itertools.islice(batches, self.prefetch):
                inflight.append(self._pool.submit(load, epoch, idxs))
            for idxs in batches:
                done = inflight.pop(0)
                inflight.append(self._pool.submit(load, epoch, idxs))
                yield self.collate_fn(unpack(done.result()))
            while inflight:
                yield self.collate_fn(unpack(inflight.pop(0).result()))
        finally:
            # keep the pool for the next epoch, but if the consumer stopped
            # mid-epoch, reclaim the in-flight SHM blocks (their lifetime is
            # parent-owned — see _shm_pack)
            if self.shm:
                for fut in inflight:
                    try:
                        _shm_unpack(fut.result())
                    except Exception:
                        pass

    def start(self) -> None:
        """Start the worker processes now, ahead of the first batch: each
        imports the dataset's modules and unpickles its copy while the
        caller goes on (building the model, say).  Iterating starts them
        anyway; no-op inline or when already started."""
        if self.num_workers == 0 or self._pool is not None:
            return
        import multiprocessing as mp

        # reclaim blocks leaked by previously-killed parents before
        # creating new ones (a SIGKILL/OOM between worker return and
        # unpack leaks prefetch x batch-size of /dev/shm)
        if self.shm:
            _sweep_stale_shm()
        # spawn: fork is unsafe with CUDA (and torch's threads) in the
        # parent (the reference forces spawn under DeepSpeed,
        # multiview_dust3r_datamodule.py:116)
        self._pool = ProcessPoolExecutor(
            max_workers=self.num_workers,
            mp_context=mp.get_context("spawn"),
            initializer=_init_worker,
            initargs=(self.dataset,),
        )
        # the pool spawns a worker per submitted task while none is idle
        for _ in range(self.num_workers):
            self._pool.submit(int)

    def close(self):
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None
        if self.shm:
            # reclaim any of THIS loader's blocks still on disk (e.g. an
            # iterator suspended mid-epoch when close() was called — its
            # finally never drained the in-flight futures)
            import os

            if os.path.isdir(_SHM_DIR):
                for name in os.listdir(_SHM_DIR):
                    if name.startswith(self._shm_prefix):
                        try:
                            os.unlink(os.path.join(_SHM_DIR, name))
                        except OSError:
                            pass


def get_data_loader(
    dataset,
    batch_size: int,
    num_workers: int = 4,
    shuffle: bool = True,
    drop_last: bool = True,
    world_size: int = 1,
    rank: int = 0,
) -> DataLoader:
    """Build a loader from a dataset object or DSL string
    (reference dust3r/datasets/__init__.py:28-64)."""
    if isinstance(dataset, str):
        from fast3r_torch.data.dsl import build_dataset

        dataset = build_dataset(dataset)
    sampler = None
    if hasattr(dataset, "make_sampler"):
        sampler = dataset.make_sampler(
            batch_size, shuffle=shuffle, world_size=world_size, rank=rank,
            drop_last=drop_last,
        )
    return DataLoader(dataset, batch_size, sampler=sampler,
                      num_workers=num_workers, drop_last=drop_last)
