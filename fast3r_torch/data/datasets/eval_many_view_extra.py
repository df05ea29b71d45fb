"""Additional spann3r-style eval datasets: ScanNet++ DSLR, ARKit raw, BlendedMVS.

Counterpart of ``fast3r_tpu/data/datasets/eval_many_view_extra.py``, with
the port's PIL reads (PFM and EXR by its own readers) and ``cv2.Rodrigues``
as ``data/imgproc.rodrigues``.

Behavioral reference: fast3r/data/components/spann3r_datasets/{scannetpp.py,
arkit.py, blendedmvs.py}.  File-format contracts preserved:
  * Scannetpp: nerfstudio transforms_undistorted.json (fl/c + per-frame
    transform_matrix with OpenGL->OpenCV axis flip), undistorted_images /
    undistorted_depths (mm), train_test_lists.json frame list;
  * ArkitScene: raw Training/Validation scenes with lowres_depth frame ids,
    .pincam intrinsics (fuzzy timestamp match), axis-angle trajectory file
    with the ARKit axis permutation;
  * BlendMVSEval: MVSNet-style cams txt + pfm depths, BFS neighbor sampling
    over pair.txt cluster scores.
"""

from __future__ import annotations

import json
import os
import os.path as osp
from collections import deque
from typing import List, Optional

import numpy as np

from fast3r_torch.data.datasets.eval_many_view import BaseManyViewDataset
from fast3r_torch.data.dsl import register_dataset
from fast3r_torch.data.imgproc import rodrigues
from fast3r_torch.data.io import IMREAD_UNCHANGED, imread_cv2


class _EvalCommon(BaseManyViewDataset):
    def __init__(self, num_seq=100, num_frames=5, min_thresh=10,
                 max_thresh=100, test_id=None, full_video=False, kf_every=1,
                 *args, ROOT, **kwargs):
        super().__init__(num_views=num_frames, *args, **kwargs)
        self.ROOT = ROOT
        self.num_seq = num_seq
        self.num_frames = num_frames
        self.min_thresh, self.max_thresh = min_thresh, max_thresh
        self.test_id = test_id
        self.full_video = full_video
        self.kf_every = kf_every
        self._load_scenes()

    def __len__(self):
        return len(self.scene_list) * self.num_seq

    def _load_scenes(self):
        raise NotImplementedError


@register_dataset
class Scannetpp(_EvalCommon):
    def _load_scenes(self):
        if self.test_id is None:
            split_file = osp.join(self.ROOT, "splits",
                                  f"nvs_sem_{self.split}.txt")
            self.scene_list = open(split_file).read().splitlines()
        else:
            self.scene_list = (self.test_id if isinstance(self.test_id, list)
                               else [self.test_id])

    def _get_views(self, idx, resolution, rng):
        scene_id = self.scene_list[idx // self.num_seq]
        base = osp.join(self.ROOT, "data", scene_id, "dslr")
        meta = json.load(open(osp.join(base, "nerfstudio",
                                       "transforms_undistorted.json")))
        K = np.array([[meta["fl_x"], 0, meta["cx"]],
                      [0, meta["fl_y"], meta["cy"]], [0, 0, 1]], np.float32)
        frames = meta["frames"]
        path_to_idx = {f["file_path"]: i for i, f in enumerate(frames)}
        train_info = json.load(open(osp.join(base, "train_test_lists.json")))
        img_idxs = self.sample_frame_idx(
            sorted(train_info["train"]), rng, full_video=self.full_video)

        views = []
        for name in img_idxs:
            rgb = imread_cv2(osp.join(base, "undistorted_images", name))
            depth = imread_cv2(
                osp.join(base, "undistorted_depths",
                         name.replace(".JPG", ".png")), IMREAD_UNCHANGED)
            depth = np.nan_to_num(depth.astype(np.float32)) / 1000.0
            pose = np.array(frames[path_to_idx[name]]["transform_matrix"],
                            np.float32)
            pose[:, 1:3] *= -1.0  # OpenGL -> OpenCV
            rgb, depthmap, Ki = self._crop_resize_if_necessary(
                rgb, depth, K.copy(), resolution, rng=rng, info=name)
            if (depthmap > 0).sum() == 0 or not np.isfinite(pose).all():
                continue
            views.append(dict(
                img=rgb, depthmap=depthmap, camera_pose=pose,
                camera_intrinsics=Ki, dataset="scannetpp",
                label=osp.join(scene_id, name), instance=name,
            ))
        return views


@register_dataset
class ArkitScene(_EvalCommon):
    def _load_scenes(self):
        if self.test_id is None:
            sub = {"train": "Training", "val": "Validation"}[self.split]
            self.scene_path = osp.join(self.ROOT, "raw", sub)
            self.scene_list = sorted(os.listdir(self.scene_path))
        else:
            self.scene_path = osp.join(self.ROOT, "raw", "Training")
            self.scene_list = (self.test_id if isinstance(self.test_id, list)
                               else [self.test_id])

    @staticmethod
    def _traj_to_pose(line: str) -> np.ndarray:
        """axis-angle + translation (w2p) -> 4x4 Rt (reference arkit.py
        traj_string_to_matrix)."""
        tok = line.split()
        r = rodrigues(np.asarray([float(t) for t in tok[1:4]]))
        t = np.asarray([float(x) for x in tok[4:7]])
        ext = np.eye(4)
        ext[:3, :3] = r
        ext[:3, 3] = t
        return np.linalg.inv(ext)  # cam-to-world

    def _get_pose(self, frame_id, poses):
        pose = poses.get(str(frame_id))
        if pose is None:
            for key in poses:
                if abs(float(frame_id) - float(key)) < 0.1:
                    pose = poses[key]
                    break
        if pose is None:
            return None
        pose = pose.copy()
        pose[0:3, 1:3] *= -1
        pose = pose[np.array([1, 0, 2, 3]), :]
        pose[2, :] *= -1
        return pose

    def _get_intrinsic(self, intr_dir, frame_id, video_id):
        for fid in (frame_id, f"{float(frame_id) - 0.001:.3f}",
                    f"{float(frame_id) + 0.001:.3f}"):
            fn = osp.join(intr_dir, f"{video_id}_{fid}.pincam")
            if osp.exists(fn):
                _, _, fx, fy, hw, hh = np.loadtxt(fn)
                return np.asarray([[fx, 0, hw], [0, fy, hh], [0, 0, 1]],
                                  np.float32)
        raise FileNotFoundError(f"{video_id}_{frame_id}.pincam")

    def _get_views(self, idx, resolution, rng):
        scene_id = self.scene_list[idx // self.num_seq]
        sdir = osp.join(self.scene_path, scene_id)
        image_path = osp.join(sdir, "vga_wide")
        depth_path = osp.join(sdir, "lowres_depth")
        intr_path = osp.join(sdir, "vga_wide_intrinsics")
        pose_path = osp.join(sdir, "lowres_wide.traj")

        names = sorted(os.listdir(depth_path))
        frame_ids = [n.split(".png")[0].split("_")[1] for n in names]
        frame_ids = self.sample_frame_idx(frame_ids, rng,
                                          full_video=self.full_video)

        poses = {}
        for line in open(pose_path, encoding="utf-8"):
            key = f"{round(float(line.split(' ')[0]), 3):.3f}"
            poses[key] = self._traj_to_pose(line)

        views = []
        for fid in frame_ids:
            impath = osp.join(image_path, f"{scene_id}_{fid}.png")
            dpath = osp.join(depth_path, f"{scene_id}_{fid}.png")
            pose = self._get_pose(fid, poses)
            if pose is None or not osp.exists(impath) or not osp.exists(dpath):
                continue
            try:
                K = self._get_intrinsic(intr_path, fid, scene_id)
            except FileNotFoundError:
                continue  # skip the frame like the missing-image/pose guards
            rgb = imread_cv2(impath)
            depth = imread_cv2(dpath, IMREAD_UNCHANGED)
            depth = np.nan_to_num(depth.astype(np.float32)) / 1000.0
            pose = pose.astype(np.float32)
            # second flip on top of _get_pose's: the reference applies BOTH
            # (arkit.py get_pose axis fix + _get_views OpenGL->OpenCV flip)
            pose[:, 1:3] *= -1.0
            rgb, depthmap, Ki = self._crop_resize_if_necessary(
                rgb, depth, K, resolution, rng=rng, info=impath)
            if (depthmap > 0).sum() == 0 or not np.isfinite(pose).all():
                continue
            views.append(dict(
                img=rgb, depthmap=depthmap, camera_pose=pose,
                camera_intrinsics=Ki, dataset="arkit",
                label=osp.join(scene_id, fid), instance=fid,
            ))
        return views


@register_dataset
class HabitatEval(_EvalCommon):
    """Habitat eval variant (reference spann3r_datasets/habitat.py: lowercase
    `habitat`): ROOT/<category>/<scene>/<seq:08d>_<i>.jpeg + _depth.exr +
    _camera_params.json, frames 1..num_frames per sequence, shuffled order."""

    def _load_scenes(self):
        cats = sorted(d for d in os.listdir(self.ROOT)
                      if osp.isdir(osp.join(self.ROOT, d)))
        self.scene_list = []
        for cat in cats:
            for scene in sorted(os.listdir(osp.join(self.ROOT, cat))):
                self.scene_list.append((cat, scene))
        if self.test_id is not None:
            self.scene_list = [s for s in self.scene_list
                               if s[1] == self.test_id]

    def _get_views(self, idx, resolution, rng):
        import json as _json

        cat, scene = self.scene_list[idx // self.num_seq]
        seq_id = idx % self.num_seq
        order = list(range(1, self.num_frames + 1))
        rng.shuffle(order)

        views = []
        for i in order:
            base = osp.join(self.ROOT, cat, scene, f"{seq_id:08}_{i}")
            if not osp.exists(base + ".jpeg"):
                continue
            rgb = imread_cv2(base + ".jpeg")
            depth = imread_cv2(base + "_depth.exr", IMREAD_UNCHANGED)
            cam = _json.load(open(base + "_camera_params.json"))
            K = np.array(cam["camera_intrinsics"], np.float32)
            pose = np.eye(4, dtype=np.float32)
            pose[:3, :3] = np.array(cam["R_cam2world"], np.float32)
            pose[:3, 3] = np.array(cam["t_cam2world"], np.float32)
            rgb, depthmap, Ki = self._crop_resize_if_necessary(
                rgb, depth, K, resolution, rng=rng, info=base)
            if (depthmap > 0).sum() == 0 or not np.isfinite(pose).all():
                continue
            views.append(dict(
                img=rgb, depthmap=depthmap, camera_pose=pose,
                camera_intrinsics=Ki, dataset="habitat",
                label=osp.join(cat, scene), instance=f"{seq_id:08}_{i}",
            ))
        return views


@register_dataset
@register_dataset(name="BlendMVSEval")  # backward-compat alias
class BlendMVS(_EvalCommon):
    """BlendedMVS loader (reference spann3r blendedmvs.py:17-240) — the
    class the reference training configs use as `BlendMVS(...)` in the DSL
    (configs/experiment/super_long_training/super_long_training.yaml:39):
    raw layout ROOT/scene/{blended_images,rendered_depth_maps,cams} with
    MVSNet cam txts and BFS neighbor sampling over cams/pair.txt scores.
    The dust3r-processed flat layout lives in BlendedMVS_Multiview."""

    def _load_scenes(self):
        if self.test_id is None:
            split_file = osp.join(self.ROOT, f"{self.split}_list.txt")
            self.scene_list = open(split_file).read().splitlines()
        else:
            self.scene_list = (self.test_id if isinstance(self.test_id, list)
                               else [self.test_id])

    @staticmethod
    def load_cam_mvsnet(f):
        RT = np.loadtxt(f, skiprows=1, max_rows=4, dtype=np.float32)
        f.seek(0)
        words = f.read().split()
        K = np.zeros((3, 3), np.float32)
        for i in range(3):
            for j in range(3):
                K[i, j] = float(words[3 * i + j + 18])
        return K, RT

    def sample_pairs(self, pairs_path, rng, max_trials=10):
        lines = open(pairs_path).read().splitlines()
        n = int(lines[0])
        neighbors = {}
        for i in range(n):
            ref = int(lines[2 * i + 1])
            info = lines[2 * i + 2].split()
            neighbors[ref] = [
                (int(info[2 * j + 1]), float(info[2 * j + 2]))
                for j in range(int(info[0]))
            ]
        for _ in range(max_trials):
            ref = int(rng.choice(list(neighbors.keys())))
            visited = {ref}
            cand = [ref]
            queue = deque(sorted(neighbors.get(ref, []),
                                 key=lambda _: rng.random()))
            while len(cand) < self.num_frames and queue:
                nb, _score = queue.popleft()
                if nb not in visited:
                    visited.add(nb)
                    cand.append(nb)
                    queue.extend(sorted(neighbors.get(nb, []),
                                        key=lambda _: rng.random()))
            if len(cand) >= self.num_frames:
                if rng.choice([True, False]):
                    cand.reverse()
                return [f"{i:08d}.jpg" for i in cand[: self.num_frames]]
        return None

    def _get_views(self, idx, resolution, rng, attempts=0):
        scene_id = self.scene_list[idx // self.num_seq]
        base = osp.join(self.ROOT, scene_id)
        image_path = osp.join(base, "blended_images")
        if not self.full_video:
            img_idxs = self.sample_pairs(osp.join(base, "cams", "pair.txt"),
                                         rng)
            if img_idxs is None:
                # reference blendedmvs.py:170-172: resample a random item
                new_idx = int(rng.integers(0, len(self) - 1))
                return self._get_views(new_idx, resolution, rng)
        else:
            img_idxs = self.sample_frame_idx(
                sorted(os.listdir(image_path)), rng, full_video=True)

        views = []
        for name in img_idxs:
            impath = osp.join(image_path, name)
            rgb = imread_cv2(impath)
            depth = imread_cv2(
                osp.join(base, "rendered_depth_maps",
                         name.replace(".jpg", ".pfm")), IMREAD_UNCHANGED)
            depth = np.nan_to_num(depth.astype(np.float32))
            with open(osp.join(base, "cams",
                               name.replace(".jpg", "_cam.txt"))) as f:
                K, w2c = self.load_cam_mvsnet(f)
            pose = np.linalg.inv(w2c)
            H, W = rgb.shape[:2]
            cx, cy = K[:2, 2].round().astype(int)
            if min(cx, W - cx) <= W / 5 or min(cy, H - cy) <= H / 5:
                # bad principal point: resample a fresh random item
                # (reference blendedmvs.py:207-209)
                new_idx = int(rng.integers(0, len(self) - 1))
                return self._get_views(new_idx, resolution, rng)
            rgb, depthmap, Ki = self._crop_resize_if_necessary(
                rgb, depth, K, resolution, rng=rng, info=impath)
            if (depthmap > 0).sum() == 0 or not np.isfinite(pose).all():
                # retry-or-resample (reference blendedmvs.py:224-231):
                # never return a short view list outside full_video
                if self.full_video:
                    continue
                if attempts >= 5:
                    new_idx = int(rng.integers(0, len(self) - 1))
                    return self._get_views(new_idx, resolution, rng)
                return self._get_views(idx, resolution, rng, attempts + 1)
            views.append(dict(
                img=rgb, depthmap=depthmap, camera_pose=pose,
                camera_intrinsics=Ki, dataset="blendmvs",
                label=osp.join(scene_id, name), instance=name,
            ))
        return views
