"""Base multiview dataset + dataset algebra + batched sampler.

Counterpart of ``fast3r_tpu/data/base.py``.  Behavioral reference:
  * BaseStereoViewDataset (dust3r/datasets/base/base_stereo_view_dataset.py:23-262):
    per-item deterministic rng (seed+idx when seeded — val determinism),
    subclass hook `_get_views(idx, resolution, rng)`, pts3d+valid_mask computed
    from depth+intrinsics+pose, [-1,1] image normalization, portrait views
    transposed to landscape storage (incl. intrinsics row swap);
  * EasyDataset algebra (easy_dataset.py:18-193): `a + b` concat, `n * d`
    repeat, `n @ d` resize with epoch-seeded shuffle (seed = epoch + 777);
  * BatchedRandomSampler (batched_sampler.py:17-88): yields
    (sample_idx, ar_idx) with one aspect-ratio per batch, rank-sliced,
    epoch-seeded (seed = epoch + 777).

Differences from the reference: images are channel-last (H, W, 3) float32
numpy (the JAX package's layout, which the port's model takes) instead of
torch CHW tensors; the sampler draws its unseeded fallback from numpy instead
of torch.initial_seed().  Everything here is numpy and PIL: loader workers
import it under ``spawn`` and never touch CUDA.  Back-projection is the numpy
:func:`depthmap_to_absolute_camera_coordinates_np` (JAX calls its C++
extension there when built, whose float32 arithmetic can differ in the last
bits).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import PIL.Image

from fast3r_torch.data import cropping
from fast3r_torch.utils.image import img_norm


# ---------------------------------------------------------------------------
# dataset algebra
# ---------------------------------------------------------------------------

class EasyDataset:
    """Composable dataset: ``a + b``, ``n * d``, ``n @ d``."""

    def __add__(self, other):
        return CatDataset([self, other])

    def __rmul__(self, factor):
        return MulDataset(factor, self)

    def __rmatmul__(self, factor):
        return ResizedDataset(factor, self)

    def set_epoch(self, epoch: int):
        pass

    def make_sampler(self, batch_size, shuffle=True, world_size=1, rank=0,
                     drop_last=True):
        if not shuffle:
            # validation loaders: deterministic sequential order (the
            # reference uses torch's SequentialSampler there)
            return SequentialBatchedSampler(
                self, batch_size, len(self._resolutions),
                world_size=world_size, rank=rank, drop_last=drop_last,
            )
        return BatchedRandomSampler(
            self, batch_size, len(self._resolutions),
            world_size=world_size, rank=rank, drop_last=drop_last,
        )


class MulDataset(EasyDataset):
    def __init__(self, multiplicator: int, dataset):
        assert isinstance(multiplicator, int) and multiplicator > 0
        self.multiplicator = multiplicator
        self.dataset = dataset

    def __len__(self):
        return self.multiplicator * len(self.dataset)

    def __repr__(self):
        return f"{self.multiplicator}*{self.dataset!r}"

    def __getitem__(self, idx):
        if isinstance(idx, tuple):
            idx, other = idx
            return self.dataset[idx // self.multiplicator, other]
        return self.dataset[idx // self.multiplicator]

    def set_epoch(self, epoch):
        self.dataset.set_epoch(epoch)

    @property
    def _resolutions(self):
        return self.dataset._resolutions


class ResizedDataset(EasyDataset):
    def __init__(self, new_size: int, dataset):
        assert isinstance(new_size, int) and new_size > 0
        self.new_size = new_size
        self.dataset = dataset

    def __len__(self):
        return self.new_size

    def __repr__(self):
        return f"{self.new_size:_} @ {self.dataset!r}"

    def set_epoch(self, epoch):
        # deterministic per-epoch shuffle (reference easy_dataset.py:108-119)
        rng = np.random.default_rng(seed=epoch + 777)
        perm = rng.permutation(len(self.dataset))
        shuffled = np.concatenate(
            [perm] * (1 + (len(self) - 1) // len(self.dataset))
        )
        self._idxs_mapping = shuffled[: self.new_size]
        self.dataset.set_epoch(epoch)

    def __getitem__(self, idx):
        assert hasattr(self, "_idxs_mapping"), (
            "call set_epoch() before indexing a ResizedDataset"
        )
        if isinstance(idx, tuple):
            idx, other = idx
            return self.dataset[self._idxs_mapping[idx], other]
        return self.dataset[self._idxs_mapping[idx]]

    @property
    def _resolutions(self):
        return self.dataset._resolutions


class CatDataset(EasyDataset):
    def __init__(self, datasets: Sequence):
        for d in datasets:
            assert isinstance(d, EasyDataset)
        self.datasets = list(datasets)
        self._cum_sizes = np.cumsum([len(d) for d in datasets])

    def __len__(self):
        return int(self._cum_sizes[-1])

    def __repr__(self):
        return " + ".join(repr(d) for d in self.datasets)

    def set_epoch(self, epoch):
        for d in self.datasets:
            d.set_epoch(epoch)

    def __getitem__(self, idx):
        other = None
        if isinstance(idx, tuple):
            idx, other = idx
        if not 0 <= idx < len(self):
            raise IndexError()
        db_idx = int(np.searchsorted(self._cum_sizes, idx, "right"))
        dataset = self.datasets[db_idx]
        new_idx = idx - (self._cum_sizes[db_idx - 1] if db_idx > 0 else 0)
        if other is not None:
            return dataset[new_idx, other]
        return dataset[new_idx]

    @property
    def _resolutions(self):
        res = self.datasets[0]._resolutions
        for d in self.datasets[1:]:
            assert tuple(d._resolutions) == tuple(res)
        return res


# ---------------------------------------------------------------------------
# batched sampler
# ---------------------------------------------------------------------------

def _round_by(total, multiple, up=False):
    if up:
        total = total + multiple - 1
    return (total // multiple) * multiple


class BatchedRandomSampler:
    """Yields (sample_idx, ar_idx) tuples; one aspect-ratio per batch;
    deterministic per epoch (seed = epoch + 777); rank-sliced for data
    parallelism (reference batched_sampler.py:17-88)."""

    def __init__(self, dataset, batch_size, pool_size, world_size=1, rank=0,
                 drop_last=True):
        self.batch_size = batch_size
        self.pool_size = pool_size
        self.len_dataset = N = len(dataset)
        self.total_size = _round_by(N, batch_size * world_size) if drop_last else N
        assert world_size == 1 or drop_last, (
            "must drop the last batch in distributed mode"
        )
        self.world_size = world_size
        self.rank = rank
        self.epoch: Optional[int] = None

    def __len__(self):
        return self.total_size // self.world_size

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        if self.epoch is None:
            assert self.world_size == 1 and self.rank == 0, (
                "use set_epoch() in distributed mode"
            )
            seed = int(np.random.SeedSequence().generate_state(1)[0])
        else:
            seed = self.epoch + 777
        rng = np.random.default_rng(seed=seed)

        sample_idxs = np.arange(self.total_size)
        rng.shuffle(sample_idxs)

        n_batches = (self.total_size + self.batch_size - 1) // self.batch_size
        feat_idxs = rng.integers(self.pool_size, size=n_batches)
        feat_idxs = np.broadcast_to(feat_idxs[:, None],
                                    (n_batches, self.batch_size))
        feat_idxs = feat_idxs.ravel()[: self.total_size]
        idxs = np.c_[sample_idxs, feat_idxs]

        size_per_proc = self.batch_size * (
            (self.total_size + self.world_size * self.batch_size - 1)
            // (self.world_size * self.batch_size)
        )
        # ceil-division per rank vs floor-rounded total_size: equal slices
        # are only guaranteed when total_size divides by world_size *
        # batch_size, which the drop_last invariant (asserted in __init__)
        # enforces whenever world_size > 1; single-process drop_last=False
        # just takes the whole array.
        assert self.world_size == 1 or \
            size_per_proc * self.world_size == self.total_size
        idxs = idxs[self.rank * size_per_proc:(self.rank + 1) * size_per_proc]
        yield from (tuple(int(v) for v in idx) for idx in idxs)


class SequentialBatchedSampler:
    """Deterministic in-order sampler for validation: yields (sample_idx,
    ar_idx) with one aspect-ratio per batch (cycled round-robin so every
    resolution is exercised), rank-sliced by contiguous stripes.  Matches
    the reference's shuffle=False torch SequentialSampler behavior while
    staying compatible with multi-resolution datasets."""

    def __init__(self, dataset, batch_size, pool_size, world_size=1, rank=0,
                 drop_last=True):
        self.batch_size = batch_size
        self.pool_size = pool_size
        self.len_dataset = N = len(dataset)
        self.total_size = _round_by(N, batch_size * world_size) if drop_last else N
        assert world_size == 1 or drop_last, (
            "must drop the last batch in distributed mode"
        )
        self.world_size = world_size
        self.rank = rank

    def __len__(self):
        return self.total_size // self.world_size

    def set_epoch(self, epoch):
        pass  # order is epoch-independent by design

    def __iter__(self):
        per_rank = len(self)
        start = self.rank * per_rank
        for i in range(start, start + per_rank):
            idx = i % self.len_dataset  # wrap the round-up padding
            ar_idx = (i // self.batch_size) % self.pool_size
            yield (idx, ar_idx)


# ---------------------------------------------------------------------------
# base view dataset
# ---------------------------------------------------------------------------

def depthmap_to_absolute_camera_coordinates_np(depthmap, camera_intrinsics,
                                               camera_pose, **kw):
    """Host-side numpy back-projection (reference geometry.py:180-245)."""
    H, W = depthmap.shape
    fx, fy = camera_intrinsics[0, 0], camera_intrinsics[1, 1]
    cx, cy = camera_intrinsics[0, 2], camera_intrinsics[1, 2]
    assert camera_intrinsics[0, 1] == 0.0, "intrinsics must have zero skew"
    u, v = np.meshgrid(np.arange(W), np.arange(H))
    z = depthmap
    x = z * (u - cx) / fx
    y = z * (v - cy) / fy
    pts_cam = np.stack([x, y, z], axis=-1).astype(np.float32)
    valid = depthmap > 0.0
    if camera_pose is not None and np.isfinite(camera_pose).all():
        R = camera_pose[:3, :3]
        t = camera_pose[:3, 3]
        pts = np.einsum("ik,vuk->vui", R, pts_cam) + t[None, None]
    else:
        pts = pts_cam
    return pts.astype(np.float32), valid


def _pointmap_from_depth(depth, intrinsics, camera_pose):
    """(H, W) depth -> (pts3d (H, W, 3), valid (H, W) bool), on the float32
    contiguous inputs and zero-skew contract of JAX's
    ``native.pointmap_from_depth_native``."""
    depth = np.ascontiguousarray(depth, np.float32)
    K = np.ascontiguousarray(intrinsics, np.float32)
    assert K[0, 1] == 0.0 and K[1, 0] == 0.0, (
        f"intrinsics must have zero skew, got {K[:2, :2]}"
    )
    return depthmap_to_absolute_camera_coordinates_np(depth, K, camera_pose)


def transpose_view_to_landscape(view: Dict) -> None:
    """In-place portrait -> landscape storage transpose
    (reference base_stereo_view_dataset.py:243-262), channel-last layout."""
    height, width = view["true_shape"]
    if width < height:
        assert view["img"].shape == (height, width, 3)
        view["img"] = view["img"].swapaxes(0, 1)
        view["valid_mask"] = view["valid_mask"].swapaxes(0, 1)
        view["depthmap"] = view["depthmap"].swapaxes(0, 1)
        view["pts3d"] = view["pts3d"].swapaxes(0, 1)
        view["camera_intrinsics"] = view["camera_intrinsics"][[1, 0, 2]]


class BaseViewDataset(EasyDataset):
    """Subclass and implement ``_get_views(idx, resolution, rng) -> [view]``
    where each view dict has at least img (PIL), depthmap, camera_intrinsics,
    and optionally camera_pose, dataset/label/instance tags."""

    def __init__(self, *, split=None, resolution=None, transform=img_norm,
                 aug_crop=False, seed=None, num_views=2):
        self.num_views = num_views
        self.split = split
        self._set_resolutions(resolution)
        if isinstance(transform, str):
            # DSL configs pass names, e.g. transform=ColorJitter (the
            # reference eval()s them, base_stereo_view_dataset.py:48-49)
            from fast3r_torch.data.transforms import resolve_transform

            transform = resolve_transform(transform)
        self.transform = transform
        self.aug_crop = aug_crop
        self.seed = seed

    def __len__(self):
        return len(self.scenes)

    def get_stats(self):
        return f"{len(self)} samples"

    def __repr__(self):
        res = "[" + ";".join(f"{w}x{h}" for w, h in self._resolutions) + "]"
        return (f"{type(self).__name__}({self.get_stats()}, split={self.split}, "
                f"seed={self.seed}, resolutions={res})")

    def _get_views(self, idx, resolution, rng) -> List[Dict]:
        raise NotImplementedError()

    def __getitem__(self, idx):
        if isinstance(idx, tuple):
            idx, ar_idx = idx
        else:
            assert len(self._resolutions) == 1
            ar_idx = 0

        if self.seed:
            # deterministic per item — validation reproducibility
            self._rng = np.random.default_rng(seed=self.seed + idx)
        elif not hasattr(self, "_rng"):
            self._rng = np.random.default_rng(
                seed=int(np.random.SeedSequence().generate_state(1)[0])
            )

        resolution = self._resolutions[ar_idx]
        views = self._get_views(idx, resolution, self._rng)

        for v, view in enumerate(views):
            assert "pts3d" not in view and "valid_mask" not in view, (
                "pts3d/valid_mask are derived from depth+intrinsics+pose"
            )
            view["idx"] = (idx, ar_idx, v)
            width, height = view["img"].size
            view["true_shape"] = np.int32((height, width))
            if hasattr(self.transform, "set_rng"):
                # stochastic transforms (ColorJitter) draw from the per-item
                # rng so seeded datasets stay deterministic
                self.transform.set_rng(self._rng)
            view["img"] = self.transform(view["img"]).astype(np.float32)

            assert "camera_intrinsics" in view
            if "camera_pose" not in view:
                view["camera_pose"] = np.full((4, 4), np.nan, np.float32)
            else:
                assert np.isfinite(view["camera_pose"]).all(), (
                    f"NaN in camera pose for view {view.get('label')}"
                )
            assert np.isfinite(view["depthmap"]).all(), (
                f"NaN in depthmap for view {view.get('label')}"
            )
            pts3d, valid_mask = _pointmap_from_depth(
                view["depthmap"], view["camera_intrinsics"],
                view["camera_pose"]
            )
            view["pts3d"] = pts3d
            view["valid_mask"] = valid_mask & np.isfinite(pts3d).all(axis=-1)

        for view in views:
            transpose_view_to_landscape(view)
            view["rng"] = int.from_bytes(self._rng.bytes(4), "big")
        return views

    def _set_resolutions(self, resolutions):
        assert resolutions is not None, "undefined resolution"
        if not isinstance(resolutions, list):
            resolutions = [resolutions]
        self._resolutions = []
        for resolution in resolutions:
            if isinstance(resolution, int):
                width = height = resolution
            else:
                width, height = resolution
            assert isinstance(width, int) and isinstance(height, int)
            assert width >= height
            self._resolutions.append((width, height))

    def _crop_resize_if_necessary(self, image, depthmap, intrinsics,
                                  resolution, rng=None, info=None):
        """Center crop on the principal point, Lanczos rescale, AR-select
        portrait vs landscape, final crop
        (reference base_stereo_view_dataset.py:165-221)."""
        if not isinstance(image, PIL.Image.Image):
            image = PIL.Image.fromarray(image)

        W, H = image.size
        cx, cy = intrinsics[:2, 2].round().astype(int)
        min_margin_x = min(cx, W - cx)
        min_margin_y = min(cy, H - cy)
        assert min_margin_x > W / 5, f"Bad principal point in view={info}"
        assert min_margin_y > H / 5, f"Bad principal point in view={info}"
        l, t = cx - min_margin_x, cy - min_margin_y
        r, b = cx + min_margin_x, cy + min_margin_y
        image, depthmap, intrinsics = cropping.crop_image_depthmap(
            image, depthmap, intrinsics, (l, t, r, b)
        )

        W, H = image.size
        assert resolution[0] >= resolution[1]
        if H > 1.1 * W:
            resolution = resolution[::-1]  # portrait
        elif 0.9 < H / W < 1.1 and resolution[0] != resolution[1]:
            if rng.integers(2):  # square: random orientation
                resolution = resolution[::-1]

        target_resolution = np.array(resolution)
        if self.aug_crop and self.aug_crop > 1:
            target_resolution += rng.integers(0, self.aug_crop)
        image, depthmap, intrinsics = cropping.rescale_image_depthmap(
            image, depthmap, intrinsics, target_resolution
        )

        intrinsics2 = cropping.camera_matrix_of_crop(
            intrinsics, image.size, resolution, offset_factor=0.5
        )
        crop_bbox = cropping.bbox_from_intrinsics_in_out(
            intrinsics, intrinsics2, resolution
        )
        image, depthmap, intrinsics2 = cropping.crop_image_depthmap(
            image, depthmap, intrinsics, crop_bbox
        )
        return image, depthmap, intrinsics2
