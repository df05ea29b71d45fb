"""Legacy pairwise (2-view) dataset loaders: Co3d, WildRGBD, StaticThings3D,
Waymo.

Behavioral reference: fast3r/dust3r/datasets/{co3d.py, wildrgbd.py,
staticthings3d.py, waymo.py}.  These are the DUSt3R-era stereo loaders the
multiview classes grew out of; file-format contracts preserved:
  * Co3d pairwise (co3d.py:27-155): selected_seqs_{split}.json; combinations
    (i, j) with 0 < |i-j| <= 30, |i-j| % 5 == 0 over 100 frames; +-4 jitter;
    uint16 depth / 65535 * maximum_depth; invalid frames flagged per
    resolution and replaced by walking the pool;
  * WildRGBD (wildrgbd.py:25-47): subclass of pairwise Co3d with rgb/depth/
    masks/metadata subdirs, 5-digit frame names, depth png / 1000;
  * StaticThings3D (staticthings3d.py:22-77): staticthings_pairs.npy rows
    (scene, seq, cam1, im1, cam2, im2); TRAIN/<scene>/<seq:04d>/<left|right>/
    with randomly chosen _clean.jpg vs _final.jpg renders, exr depth,
    npz {intrinsics, cam2world}; mask_bg zeroes depth > 200;
  * Waymo (waymo.py:22-73): waymo_pairs.npz {scenes, frames, pairs}; flat
    <frame>.jpg/.exr/.npz per scene dir.

Counterpart of ``fast3r_tpu/data/datasets/pairwise_legacy.py`` with the
port's PIL and EXR reads.

The reference registers the pairwise Co3d under the same name the spann3r
eval loader uses here, so the DSL name is ``Co3dPairwise``.
"""

from __future__ import annotations

import itertools
import json
import os.path as osp
from collections import deque
from typing import Dict, List

import numpy as np

from fast3r_torch.data.base import BaseViewDataset
from fast3r_torch.data.dsl import register_dataset
from fast3r_torch.data.io import IMREAD_UNCHANGED, imread_cv2


@register_dataset(name="Co3dPairwise")
class Co3dPairwise(BaseViewDataset):
    dataset_label = "Co3d_v2"

    def __init__(self, mask_bg=True, *args, ROOT, **kwargs):
        super().__init__(num_views=2, *args, **kwargs)
        self.ROOT = ROOT
        assert mask_bg in (True, False, "rand")
        self.mask_bg = mask_bg
        with open(osp.join(ROOT, f"selected_seqs_{self.split}.json")) as f:
            scenes = json.load(f)
        scenes = {k: v for k, v in scenes.items() if len(v) > 0}
        self.scenes = {(k, k2): v2 for k, v in scenes.items()
                       for k2, v2 in v.items()}
        self.scene_list = list(self.scenes.keys())
        # (i, j) pairs spanning +/- [5..90] degrees over the 100-frame orbit
        self.combinations = [
            (i, j) for i, j in itertools.combinations(range(100), 2)
            if 0 < abs(i - j) <= 30 and abs(i - j) % 5 == 0
        ]
        self.invalidate = {s: {} for s in self.scene_list}

    def __len__(self):
        return len(self.scene_list) * len(self.combinations)

    # path hooks, overridden by WildRGBD (reference wildrgbd.py:30-41)
    def _get_impath(self, obj, instance, view_idx):
        return osp.join(self.ROOT, obj, instance, "images",
                        f"frame{view_idx:06d}.jpg")

    def _get_depthpath(self, obj, instance, view_idx):
        return osp.join(self.ROOT, obj, instance, "depths",
                        f"frame{view_idx:06d}.jpg.geometric.png")

    def _get_maskpath(self, obj, instance, view_idx):
        return osp.join(self.ROOT, obj, instance, "masks",
                        f"frame{view_idx:06d}.png")

    def _get_metadatapath(self, obj, instance, view_idx):
        return osp.join(self.ROOT, obj, instance, "images",
                        f"frame{view_idx:06d}.npz")

    def _read_depthmap(self, depthpath, metadata):
        depth = imread_cv2(depthpath, IMREAD_UNCHANGED)
        return (depth.astype(np.float32) / 65535
                * np.nan_to_num(metadata["maximum_depth"]))

    def _get_views(self, idx, resolution, rng):
        obj, instance = self.scene_list[idx // len(self.combinations)]
        pool = self.scenes[obj, instance]
        im1_idx, im2_idx = self.combinations[idx % len(self.combinations)]
        last = len(pool) - 1
        inval = self.invalidate[obj, instance].setdefault(
            resolution, [False] * len(pool))
        mask_bg = self.mask_bg is True or (
            self.mask_bg == "rand" and rng.choice(2))

        views = []
        imgs_idxs = deque(
            max(0, min(i + int(rng.integers(-4, 5)), last))
            for i in [im2_idx, im1_idx]
        )
        while imgs_idxs:
            im_idx = imgs_idxs.pop()
            if inval[im_idx]:  # walk to a nearby valid frame
                direction = 2 * int(rng.choice(2)) - 1
                for off in range(1, len(pool)):
                    cand = (im_idx + direction * off) % len(pool)
                    if not inval[cand]:
                        im_idx = cand
                        break
            view_idx = pool[im_idx]
            impath = self._get_impath(obj, instance, view_idx)
            meta = np.load(self._get_metadatapath(obj, instance, view_idx))
            pose = meta["camera_pose"].astype(np.float32)
            K = meta["camera_intrinsics"].astype(np.float32)
            rgb = imread_cv2(impath)
            depth = self._read_depthmap(
                self._get_depthpath(obj, instance, view_idx), meta)
            if mask_bg:
                mask = imread_cv2(self._get_maskpath(obj, instance, view_idx),
                                  IMREAD_UNCHANGED)
                depth *= (mask.astype(np.float32) / 255.0) > 0.1
            rgb, depth, K = self._crop_resize_if_necessary(
                rgb, depth, K, resolution, rng=rng, info=impath)
            if (depth > 0.0).sum() == 0:
                inval[im_idx] = True
                imgs_idxs.append(im_idx)
                continue
            views.append(dict(
                img=rgb, depthmap=depth, camera_pose=pose,
                camera_intrinsics=K, dataset=self.dataset_label,
                label=osp.join(obj, instance), instance=osp.split(impath)[1],
            ))
        return views


@register_dataset
class WildRGBD(Co3dPairwise):
    dataset_label = "WildRGBD"

    def __init__(self, mask_bg=True, *args, ROOT, **kwargs):
        super().__init__(mask_bg, *args, ROOT=ROOT, **kwargs)

    def _get_metadatapath(self, obj, instance, view_idx):
        return osp.join(self.ROOT, obj, instance, "metadata",
                        f"{view_idx:0>5d}.npz")

    def _get_impath(self, obj, instance, view_idx):
        return osp.join(self.ROOT, obj, instance, "rgb",
                        f"{view_idx:0>5d}.jpg")

    def _get_depthpath(self, obj, instance, view_idx):
        return osp.join(self.ROOT, obj, instance, "depth",
                        f"{view_idx:0>5d}.png")

    def _get_maskpath(self, obj, instance, view_idx):
        return osp.join(self.ROOT, obj, instance, "masks",
                        f"{view_idx:0>5d}.png")

    def _read_depthmap(self, depthpath, metadata):
        depth = imread_cv2(depthpath, IMREAD_UNCHANGED)
        return depth.astype(np.float32) / 1000.0


@register_dataset
class StaticThings3D(BaseViewDataset):
    """Indoor synthetic pair dataset (staticthings3d.py:22-77)."""

    def __init__(self, *args, ROOT, mask_bg="rand", **kwargs):
        super().__init__(num_views=2, *args, **kwargs)
        self.ROOT = ROOT
        assert mask_bg in (True, False, "rand")
        self.mask_bg = mask_bg
        assert self.split is None
        self.pairs = np.load(osp.join(ROOT, "staticthings_pairs.npy"))

    def __len__(self):
        return len(self.pairs)

    def get_stats(self):
        return f"{len(self)} pairs"

    def _get_views(self, pair_idx, resolution, rng):
        scene, seq, cam1, im1, cam2, im2 = self.pairs[pair_idx]
        scene = scene.decode("ascii") if isinstance(scene, bytes) else str(scene)
        seq_path = osp.join("TRAIN", scene, f"{int(seq):04d}")
        mask_bg = self.mask_bg is True or (
            self.mask_bg == "rand" and rng.choice(2))

        CAM = {b"l": "left", b"r": "right", "l": "left", "r": "right"}
        views = []
        for cam, idx in [(CAM[cam1], im1), (CAM[cam2], im2)]:
            num = f"{int(idx):04d}"
            img = num + ("_clean.jpg" if rng.choice(2) else "_final.jpg")
            image = imread_cv2(osp.join(self.ROOT, seq_path, cam, img))
            depth = imread_cv2(osp.join(self.ROOT, seq_path, cam, num + ".exr"))
            cam_params = np.load(
                osp.join(self.ROOT, seq_path, cam, num + ".npz"))
            K = cam_params["intrinsics"]
            pose = cam_params["cam2world"]
            if mask_bg:
                depth = depth.copy()
                depth[depth > 200] = 0
            image, depth, K = self._crop_resize_if_necessary(
                image, depth, K, resolution, rng, info=(seq_path, cam, img))
            views.append(dict(
                img=image, depthmap=depth, camera_pose=pose,
                camera_intrinsics=K, dataset="StaticThings3D",
                label=seq_path, instance=cam + "_" + img,
            ))
        return views


@register_dataset
class Waymo(BaseViewDataset):
    """Outdoor street-scene pair dataset (waymo.py:22-73)."""

    def __init__(self, *args, ROOT, **kwargs):
        super().__init__(num_views=2, *args, **kwargs)
        self.ROOT = ROOT
        with np.load(osp.join(ROOT, "waymo_pairs.npz")) as data:
            self.scenes = data["scenes"]
            self.frames = data["frames"]
            self.pairs = data["pairs"]  # rows (scene_id, img1_id, img2_id)
        assert self.pairs[:, 0].max() == len(self.scenes) - 1

    def __len__(self):
        return len(self.pairs)

    def get_stats(self):
        return f"{len(self)} pairs from {len(self.scenes)} scenes"

    def _get_views(self, pair_idx, resolution, rng):
        seq, img1, img2 = self.pairs[pair_idx]
        seq_path = osp.join(self.ROOT, str(self.scenes[seq]))
        views = []
        for view_index in [img1, img2]:
            impath = str(self.frames[view_index])
            image = imread_cv2(osp.join(seq_path, impath + ".jpg"))
            depth = imread_cv2(osp.join(seq_path, impath + ".exr"))
            cam = np.load(osp.join(seq_path, impath + ".npz"))
            K = np.float32(cam["intrinsics"])
            pose = np.float32(cam["cam2world"])
            image, depth, K = self._crop_resize_if_necessary(
                image, depth, K, resolution, rng, info=(seq_path, impath))
            views.append(dict(
                img=image, depthmap=depth, camera_pose=pose,
                camera_intrinsics=K, dataset="Waymo",
                label=osp.relpath(seq_path, self.ROOT), instance=impath,
            ))
        return views
