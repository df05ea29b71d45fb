"""Evaluation many-view datasets (spann3r-style): DTU, 7-Scenes, NRGBD.

Counterpart of ``fast3r_tpu/data/datasets/eval_many_view.py``: the same
classes, arguments, sampling and ``dataset`` labels, reading through the
port's PIL ``data/io.py`` and computing cv2's resizes and erosion with
``data/imgproc.py`` and ``data/cropping.resize_nearest``.

Behavioral reference: fast3r/data/components/spann3r_datasets/ —
  * BaseManyViewDataset.sample_frames (base_many_view_dataset.py:11-57):
    stride-constrained random frame sampling, or every-kf_every keyframing
    when full_video;
  * DTU (dtu.py): MVSNet cam txt parsing, npy depths, eroded binary masks;
  * SevenScenes (seven_scenes.py): frame-XXXXXX.{color,depth.proj,pose} with
    fixed intrinsics (525, 525, 320, 240);
  * NRGBD (nrgbd.py): poses.txt (4x4 blocks, y/z axes flipped), fixed
    intrinsics (554.256..., 320, 240), depth clamped to (1e-3, 10].
"""

from __future__ import annotations

import os
import os.path as osp
from typing import List, Optional

import numpy as np

from fast3r_torch.data.base import BaseViewDataset
from fast3r_torch.data.dsl import register_dataset
from fast3r_torch.data.cropping import resize_nearest
from fast3r_torch.data.imgproc import erode, resize_linear
from fast3r_torch.data.io import IMREAD_UNCHANGED, imread_cv2


class BaseManyViewDataset(BaseViewDataset):
    train_ratio: float = 1.0

    def sample_frames(self, img_idxs, rng) -> List:
        """Stride-constrained sampling (base_many_view_dataset.py:15-47).

        The reference recurses unboundedly on a failed draw; we bound the
        retries and fall back to evenly-spaced frames (always valid) so a
        pathological sequence cannot hang the loader."""
        num_frames = self.num_frames
        thresh = int(self.min_thresh
                     + self.train_ratio * (self.max_thresh - self.min_thresh))
        n = len(img_idxs)
        selected: List[int] = []
        for _ in range(32):  # bounded retry instead of unbounded recursion
            selected = []
            initial_range = max(n // num_frames, n - thresh * (num_frames - 1))
            current = int(rng.choice(np.arange(n)[:initial_range]))
            selected.append(current)
            ok = True
            while len(selected) < num_frames:
                lo = current + 1
                hi = min(current + thresh, n - (num_frames - len(selected)))
                cand = [i for i in range(lo, hi + 1) if i not in selected]
                if not cand:
                    ok = False
                    break
                current = int(rng.choice(cand))
                selected.append(current)
            if ok:
                break
        if len(selected) < num_frames:
            # deterministic fallback: evenly spaced over the sequence
            selected = list(np.linspace(0, n - 1, num_frames).round()
                            .astype(int))
        ids = [img_idxs[i] for i in selected]
        if rng.choice([True, False]):
            ids.reverse()
        return ids

    def sample_frame_idx(self, img_idxs, rng, full_video=False):
        if not full_video:
            return self.sample_frames(img_idxs, rng)
        return img_idxs[:: self.kf_every]


@register_dataset
class DTU(BaseManyViewDataset):
    def __init__(self, num_seq=49, num_frames=5, min_thresh=10, max_thresh=30,
                 test_id=None, full_video=False, kf_every=1, *args, ROOT,
                 **kwargs):
        super().__init__(num_views=num_frames, *args, **kwargs)
        self.ROOT = ROOT
        self.num_seq = num_seq
        self.num_frames = num_frames
        self.min_thresh, self.max_thresh = min_thresh, max_thresh
        self.test_id = test_id
        self.full_video = full_video
        self.kf_every = kf_every
        if test_id is not None:
            self.scene_list = [test_id]
        else:
            self.scene_list = sorted(os.listdir(ROOT))

    def __len__(self):
        return len(self.scene_list) * self.num_seq

    @staticmethod
    def load_cam_mvsnet(file, interval_scale=1):
        """MVSNet cam txt: 4x4 extrinsic (w2c) + 3x3 intrinsic
        (reference dtu.py:56-97)."""
        words = file.read().split()
        extrinsic = np.array(
            [float(words[4 * i + j + 1]) for i in range(4) for j in range(4)],
            np.float32,
        ).reshape(4, 4)
        intrinsic = np.zeros((3, 3), np.float32)
        for i in range(3):
            for j in range(3):
                intrinsic[i, j] = float(words[3 * i + j + 18])
        return intrinsic, extrinsic

    def sample_pairs(self, pairs_path, seq_id):
        lines = open(pairs_path).read().splitlines()
        ref_idx = int(lines[2 * seq_id + 1])
        info = lines[2 * seq_id + 2].split()
        ids = [f"{ref_idx:08d}.jpg"]
        for c in range(self.num_frames):
            ids.append(f"{int(info[2 * c + 1]):08d}.jpg")
        ids.reverse()
        return ids

    def _get_views(self, idx, resolution, rng):
        scene_id = self.scene_list[idx // self.num_seq]
        seq_id = idx % self.num_seq
        image_path = osp.join(self.ROOT, scene_id, "images")
        if not self.full_video:
            img_idxs = self.sample_pairs(
                osp.join(self.ROOT, scene_id, "pair.txt"), seq_id)
        else:
            img_idxs = self.sample_frame_idx(
                sorted(os.listdir(image_path)), rng, full_video=True)

        views = []
        for im_idx in reversed(list(img_idxs)):
            impath = osp.join(image_path, im_idx)
            rgb = imread_cv2(impath)
            depth = np.nan_to_num(np.load(
                osp.join(self.ROOT, scene_id, "depths",
                         im_idx.replace(".jpg", ".npy"))).astype(np.float32))
            mask = imread_cv2(
                osp.join(self.ROOT, scene_id, "binary_masks",
                         im_idx.replace(".jpg", ".png")),
                IMREAD_UNCHANGED).astype(np.float32) / 255.0
            mask = (mask > 0.5).astype(np.float32)
            mask = resize_nearest(mask, (depth.shape[1], depth.shape[0]))
            mask = erode(mask, (10, 10))
            depth = depth * mask
            K, w2c = self.load_cam_mvsnet(
                open(osp.join(self.ROOT, scene_id, "cams",
                              im_idx.replace(".jpg", "_cam.txt"))))
            pose = np.linalg.inv(w2c)
            rgb, depth, K = self._crop_resize_if_necessary(
                rgb, depth, K, resolution, rng=rng, info=impath)
            views.append(dict(
                img=rgb, depthmap=depth, camera_pose=pose,
                camera_intrinsics=K, dataset="dtu",
                label=osp.join(scene_id, im_idx),
                instance=osp.split(impath)[1],
            ))
        return views


@register_dataset
class SevenScenes(BaseManyViewDataset):
    def __init__(self, num_seq=1, num_frames=5, min_thresh=10, max_thresh=100,
                 test_id=None, full_video=False, tuple_path=None, seq_id=None,
                 kf_every=1, *args, ROOT, **kwargs):
        super().__init__(num_views=num_frames, *args, **kwargs)
        self.ROOT = ROOT
        self.num_seq = num_seq
        self.num_frames = num_frames
        self.min_thresh, self.max_thresh = min_thresh, max_thresh
        self.test_id = test_id
        self.full_video = full_video
        self.kf_every = kf_every
        self.seq_id = seq_id
        self.tuple_list = (open(tuple_path).read().splitlines()
                           if tuple_path else None)
        self._load_scenes()

    def _load_scenes(self):
        if self.tuple_list is not None:
            self.scene_list = [
                "stairs/seq-06", "stairs/seq-02", "pumpkin/seq-06",
                "chess/seq-01", "heads/seq-02", "fire/seq-02",
                "office/seq-03", "pumpkin/seq-03", "redkitchen/seq-07",
                "chess/seq-02", "office/seq-01", "redkitchen/seq-01",
                "fire/seq-01",
            ]
            return
        file_split = {"train": "TrainSplit.txt",
                      "test": "TestSplit.txt"}[self.split]
        self.scene_list = []
        for scene in sorted(os.listdir(self.ROOT)):
            if self.test_id is not None and scene != self.test_id:
                continue
            split_file = osp.join(self.ROOT, scene, file_split)
            if not osp.exists(split_file):
                continue
            for seq in open(split_file).read().splitlines():
                num = "".join(filter(str.isdigit, seq))
                seq = f"seq-{num.zfill(2)}"
                if self.seq_id is not None and seq != self.seq_id:
                    continue
                self.scene_list.append(f"{scene}/{seq}")

    def __len__(self):
        if self.tuple_list is not None:
            return len(self.tuple_list)
        return len(self.scene_list) * self.num_seq

    def _get_views(self, idx, resolution, rng):
        if self.tuple_list is not None:
            line = self.tuple_list[idx].split(" ")
            scene_id, img_idxs = line[0], line[1:]
        else:
            scene_id = self.scene_list[idx // self.num_seq]
            data_path = osp.join(self.ROOT, scene_id)
            n = len([f for f in os.listdir(data_path) if "color" in f])
            img_idxs = self.sample_frame_idx(
                [f"{i:06d}" for i in range(n)], rng,
                full_video=self.full_video)

        K0 = np.array([[525, 0, 320], [0, 525, 240], [0, 0, 1]], np.float32)
        views = []
        for im_idx in img_idxs:
            base = osp.join(self.ROOT, scene_id, f"frame-{im_idx}")
            rgb = imread_cv2(base + ".color.png")
            depth = imread_cv2(base + ".depth.proj.png", IMREAD_UNCHANGED)
            rgb = resize_linear(rgb, (depth.shape[1], depth.shape[0]))
            depth = depth.astype(np.float32)
            depth[depth == 65535] = 0
            depth = np.nan_to_num(depth) / 1000.0
            pose = np.loadtxt(base + ".pose.txt").astype(np.float32)
            rgb, depthmap, K = self._crop_resize_if_necessary(
                rgb, depth, K0.copy(), resolution, rng=rng, info=base)
            views.append(dict(
                img=rgb, depthmap=depthmap, camera_pose=pose,
                camera_intrinsics=K, dataset="7scenes",
                label=osp.join(scene_id, im_idx), instance=im_idx,
            ))
        return views


@register_dataset
class Co3d(BaseManyViewDataset):
    """CO3D eval variant (reference spann3r_datasets/co3d.py): same file
    formats as the Co3d_Multiview train loader; frame selection either by
    stride-filtered combinations (use_comb) or sample_frames; invalid frames
    replaced by walking the pool."""

    def __init__(self, num_seq=100, num_frames=5, min_thresh=10,
                 max_thresh=100, mask_bg=True, use_comb=True, lb=5, ub=30,
                 scene_class=None, scene_id=None, full_video=False,
                 kf_every=1, *args, ROOT, **kwargs):
        super().__init__(num_views=num_frames, *args, **kwargs)
        self.ROOT = ROOT
        self.num_frames = num_frames
        self.min_thresh, self.max_thresh = min_thresh, max_thresh
        assert mask_bg in (True, False, "rand")
        self.mask_bg = mask_bg
        self.full_video = full_video
        self.kf_every = kf_every

        import itertools
        import json

        with open(osp.join(ROOT, f"selected_seqs_{self.split}.json")) as f:
            scenes = json.load(f)
        if scene_class is not None:
            scenes = {k: v for k, v in scenes.items() if k == scene_class}
        else:
            scenes = {k: v for k, v in scenes.items() if len(v) > 0}
        self.scenes = {
            (k, k2): v2 for k, v in scenes.items() for k2, v2 in v.items()
            if scene_id is None or k2 == scene_id
        }
        self.scene_list = list(self.scenes.keys())

        if use_comb and not full_video:
            combos = [
                c for c in itertools.combinations(range(100), num_frames)
                if all(lb < abs(x - y) <= ub and abs(x - y) % 5 == 0
                       for x, y in zip(c, c[1:]))
            ]
            self.combinations = combos
            self.num_seq = len(combos)
        else:
            self.combinations = None
            self.num_seq = num_seq
        self.invalidate = {s: {} for s in self.scene_list}

    def __len__(self):
        return len(self.scene_list) * self.num_seq

    def _get_views(self, idx, resolution, rng):
        obj, instance = self.scene_list[idx // self.num_seq]
        pool = self.scenes[obj, instance]
        if self.combinations is not None:
            frame_idx = self.combinations[idx % len(self.combinations)]
            last = len(pool) - 1
            imgs_idxs = [max(0, min(i + int(rng.integers(-4, 5)), last))
                         for i in frame_idx]
        else:
            imgs_idxs = self.sample_frame_idx(
                list(range(len(pool))), rng, full_video=self.full_video)
        inval = self.invalidate[obj, instance].setdefault(
            resolution, [False] * len(pool))
        mask_bg = self.mask_bg is True or (
            self.mask_bg == "rand" and rng.choice(2))

        from collections import deque

        views = []
        imgs_idxs = deque(imgs_idxs)
        while imgs_idxs:
            im_idx = imgs_idxs.popleft()
            if inval[im_idx]:  # walk to a nearby valid frame
                direction = 2 * int(rng.choice(2)) - 1
                for off in range(1, len(pool)):
                    cand = (im_idx + direction * off) % len(pool)
                    if not inval[cand]:
                        im_idx = cand
                        break
            view_idx = pool[im_idx]
            impath = osp.join(self.ROOT, obj, instance, "images",
                              f"frame{view_idx:06d}.jpg")
            meta = np.load(impath.replace("jpg", "npz"))
            pose = meta["camera_pose"].astype(np.float32)
            K = meta["camera_intrinsics"].astype(np.float32)
            rgb = imread_cv2(impath)
            depth = imread_cv2(
                impath.replace("images", "depths") + ".geometric.png",
                IMREAD_UNCHANGED,
            ).astype(np.float32) / 65535 * np.nan_to_num(meta["maximum_depth"])
            if mask_bg:
                mask = imread_cv2(
                    osp.join(self.ROOT, obj, instance, "masks",
                             f"frame{view_idx:06d}.png"), IMREAD_UNCHANGED)
                depth *= (mask.astype(np.float32) / 255.0) > 0.1
            rgb, depth, K = self._crop_resize_if_necessary(
                rgb, depth, K, resolution, rng=rng, info=impath)
            if (depth > 0.0).sum() == 0:
                # invalidate and retry the slot so the view count stays
                # fixed (reference co3d.py:152-157: appendleft + walk)
                inval[im_idx] = True
                imgs_idxs.appendleft(im_idx)
                continue
            views.append(dict(
                img=rgb, depthmap=depth, camera_pose=pose,
                camera_intrinsics=K, dataset="co3d",
                label=osp.join(obj, instance),
                instance=osp.split(impath)[1],
            ))
        return views


@register_dataset
class Scannet(BaseManyViewDataset):
    """ScanNet eval (reference spann3r_datasets/scannet.py): scans[_test]
    layout with sensor_data/frame-XXXXXX.{color.jpg,depth.png,pose.txt} and
    intrinsic/intrinsic_depth.txt; invalid frames skipped in full_video."""

    def __init__(self, num_seq=100, num_frames=5, min_thresh=10,
                 max_thresh=100, test_id=None, full_video=False, kf_every=1,
                 *args, ROOT, **kwargs):
        super().__init__(num_views=num_frames, *args, **kwargs)
        self.ROOT = ROOT
        self.num_seq = num_seq
        self.num_frames = num_frames
        self.min_thresh, self.max_thresh = min_thresh, max_thresh
        self.full_video = full_video
        self.kf_every = kf_every
        self.folder = {"train": "scans", "val": "scans",
                       "test": "scans_test"}[self.split]
        if test_id is None:
            split_file = osp.join(ROOT, "splits",
                                  f"scannetv2_{self.split}.txt")
            self.scene_list = open(split_file).read().splitlines()
        else:
            self.scene_list = (test_id if isinstance(test_id, list)
                               else [test_id])

    def __len__(self):
        return len(self.scene_list) * self.num_seq

    def _get_views(self, idx, resolution, rng, attempts=0):
        scene_id = self.scene_list[idx // self.num_seq]
        K0 = np.loadtxt(osp.join(self.ROOT, self.folder, scene_id,
                                 "intrinsic/intrinsic_depth.txt")
                        ).astype(np.float32)[:3, :3]
        data_path = osp.join(self.ROOT, self.folder, scene_id, "sensor_data")
        n = len([f for f in os.listdir(data_path) if "color" in f])
        img_idxs = self.sample_frame_idx(
            [f"{i:06d}" for i in range(n)], rng, full_video=self.full_video)

        views = []
        for im_idx in img_idxs:
            base = osp.join(data_path, f"frame-{im_idx}")
            rgb = imread_cv2(base + ".color.jpg")
            depth = imread_cv2(base + ".depth.png", IMREAD_UNCHANGED)
            rgb = resize_linear(rgb, (depth.shape[1], depth.shape[0]))
            depth = np.nan_to_num(depth.astype(np.float32)) / 1000.0
            pose = np.loadtxt(base + ".pose.txt").astype(np.float32)
            rgb, depthmap, K = self._crop_resize_if_necessary(
                rgb, depth, K0.copy(), resolution, rng=rng, info=base)
            if (depthmap > 0).sum() == 0 or not np.isfinite(pose).all():
                # reference scannet.py:103-110: in full_video mode skip the
                # frame; otherwise retry the item (5 attempts) then resample
                # a fresh random index — never return a short view list
                if self.full_video:
                    continue
                if attempts >= 5:
                    new_idx = int(rng.integers(0, len(self) - 1))
                    return self._get_views(new_idx, resolution, rng)
                return self._get_views(idx, resolution, rng, attempts + 1)
            views.append(dict(
                img=rgb, depthmap=depthmap, camera_pose=pose,
                camera_intrinsics=K, dataset="scannet",
                label=osp.join(scene_id, im_idx), instance=im_idx,
            ))
        return views


@register_dataset
class Demo(BaseManyViewDataset):
    """Folder-of-images eval (reference spann3r_datasets/demo.py): optional
    per-image *_depth.png + .npz metadata (camera_pose/camera_intrinsics/
    maximum_depth); fabricated intrinsics otherwise."""

    def __init__(self, num_seq=1, num_frames=5, min_thresh=10, max_thresh=100,
                 full_video=True, kf_every=1, *args, ROOT, **kwargs):
        super().__init__(num_views=num_frames, *args, **kwargs)
        self.ROOT = ROOT
        self.num_seq = num_seq
        self.num_frames = num_frames
        self.min_thresh, self.max_thresh = min_thresh, max_thresh
        self.full_video = full_video
        self.kf_every = kf_every

    def __len__(self):
        return self.num_seq

    def _get_views(self, idx, resolution, rng):
        exts = (".jpg", ".jpeg", ".png", ".heic")
        names = [f for f in sorted(os.listdir(self.ROOT))
                 if f.lower().endswith(exts) and "depth" not in f.lower()]
        names = self.sample_frame_idx(names, rng, full_video=self.full_video)

        views = []
        for name in names:
            impath = osp.join(self.ROOT, name)
            rgb = imread_cv2(impath)
            stem = impath.rsplit(".", 1)[0]
            meta_path = stem + ".npz"
            depth_path = stem + "_depth.png"
            H0, W0 = rgb.shape[:2]
            if osp.exists(meta_path):
                meta = np.load(meta_path)
                pose = meta["camera_pose"].astype(np.float32)
                K = meta["camera_intrinsics"].astype(np.float32)
            else:
                f = 1.2 * max(H0, W0)
                K = np.array([[f, 0, W0 / 2], [0, f, H0 / 2], [0, 0, 1]],
                             np.float32)
                pose = np.eye(4, dtype=np.float32)
            if osp.exists(depth_path):
                depth = imread_cv2(depth_path, IMREAD_UNCHANGED)
                depth = np.nan_to_num(depth.astype(np.float32)) / 1000.0
                rgb = resize_linear(rgb, (depth.shape[1], depth.shape[0]))
            else:
                depth = np.ones(rgb.shape[:2], np.float32)
            rgb, depthmap, K = self._crop_resize_if_necessary(
                rgb, depth, K, resolution, rng=rng, info=impath)
            views.append(dict(
                img=rgb, depthmap=depthmap, camera_pose=pose,
                camera_intrinsics=K, dataset="demo", label=name,
                instance=name,
            ))
        return views


@register_dataset
class NRGBD(BaseManyViewDataset):
    def __init__(self, num_seq=1, num_frames=5, min_thresh=10, max_thresh=100,
                 test_id=None, full_video=False, tuple_path=None, seq_id=None,
                 kf_every=1, *args, ROOT, **kwargs):
        super().__init__(num_views=num_frames, *args, **kwargs)
        self.ROOT = ROOT
        self.num_seq = num_seq
        self.num_frames = num_frames
        self.min_thresh, self.max_thresh = min_thresh, max_thresh
        self.full_video = full_video
        self.kf_every = kf_every
        self.tuple_list = (open(tuple_path).read().splitlines()
                           if tuple_path else None)
        self.scene_list = ([test_id] if test_id is not None
                           else sorted(os.listdir(ROOT)))

    def __len__(self):
        if self.tuple_list is not None:
            return len(self.tuple_list)
        return len(self.scene_list) * self.num_seq

    @staticmethod
    def load_poses(path):
        lines = open(path).readlines()
        poses, valid = [], []
        for i in range(0, len(lines), 4):
            if "nan" in lines[i]:
                valid.append(False)
                poses.append(np.eye(4, dtype=np.float32))
            else:
                valid.append(True)
                poses.append(np.array(
                    [[float(x) for x in l.split()] for l in lines[i:i + 4]],
                    np.float32))
        return np.stack(poses), valid

    def _get_views(self, idx, resolution, rng):
        if self.tuple_list is not None:
            line = self.tuple_list[idx].split(" ")
            scene_id, img_idxs = line[0], line[1:]
        else:
            scene_id = self.scene_list[idx // self.num_seq]
            n = len(os.listdir(osp.join(self.ROOT, scene_id, "images")))
            img_idxs = self.sample_frame_idx(
                [f"{i}" for i in range(n)], rng, full_video=self.full_video)

        K0 = np.array([[554.2562584220408, 0, 320],
                       [0, 554.2562584220408, 240], [0, 0, 1]], np.float32)
        poses, _valids = self.load_poses(
            osp.join(self.ROOT, scene_id, "poses.txt"))
        views = []
        for im_idx in img_idxs:
            impath = osp.join(self.ROOT, scene_id, "images", f"img{im_idx}.png")
            rgb = imread_cv2(impath)
            depth = imread_cv2(
                osp.join(self.ROOT, scene_id, "depth", f"depth{im_idx}.png"),
                IMREAD_UNCHANGED)
            depth = np.nan_to_num(depth.astype(np.float32)) / 1000.0
            depth[depth > 10] = 0
            depth[depth < 1e-3] = 0
            rgb = resize_linear(rgb, (depth.shape[1], depth.shape[0]))
            pose = poses[int(im_idx)].copy()
            pose[:, 1:3] *= -1.0  # OpenGL -> OpenCV axes (nrgbd.py)
            rgb, depthmap, K = self._crop_resize_if_necessary(
                rgb, depth, K0.copy(), resolution, rng=rng, info=impath)
            views.append(dict(
                img=rgb, depthmap=depthmap, camera_pose=pose,
                camera_intrinsics=K, dataset="nrgbd",
                label=osp.join(scene_id, im_idx), instance=im_idx,
            ))
        return views
