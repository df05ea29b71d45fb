"""Aria Synthetic Environments (ASE) multiview training dataset.

Counterpart of ``fast3r_tpu/data/datasets/ase_multiview.py``: the
rectification's remaps and the 90-degree rotation by ``data/imgproc.py``.

Behavioral reference: fast3r/dust3r/datasets/ase_multiview.py:166-307
(ASE_Multiview): per-scene trajectory.csv (timestamp + translation +
xyzw quaternion, device-to-world), vignette-corrected fisheye jpgs +
mm-depth pngs, Fisheye624 -> pinhole rectification, 90-degree clockwise
rotation (Aria's sensors are mounted rotated) with matching intrinsics and
pose-about-Z adjustments, windowed view combinations.
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np

from fast3r_torch.data.aria_camera import (
    ASE_INTRINSICS,
    FISHEYE_CAM_PARAMS,
    PINHOLE_CAM_PARAMS,
    T_DEVICE_FROM_CAMERA,
    VignetteCorrector,
    undistort_fisheye_to_pinhole_rgbd,
)
from fast3r_torch.data.base import BaseViewDataset
from fast3r_torch.data.datasets.multiview import windowed_combinations
from fast3r_torch.data.dsl import register_dataset
from fast3r_torch.data.imgproc import rotate90_cw
from fast3r_torch.data.io import IMREAD_COLOR, IMREAD_UNCHANGED, imread_cv2


def read_trajectory_file(filepath: str):
    """trajectory.csv: header + rows ..,timestamp,..,tx,ty,tz,qx,qy,qz,qw,..
    (reference ase_multiview.py:78-106)."""
    from scipy.spatial.transform import Rotation as R

    transforms, timestamps = [], []
    with open(filepath) as f:
        f.readline()  # header
        for line in f:
            parts = line.strip().split(",")
            if len(parts) < 10:
                continue
            t = np.array([float(parts[3]), float(parts[4]), float(parts[5])],
                         np.float32)
            quat_xyzw = [float(parts[6]), float(parts[7]), float(parts[8]),
                         float(parts[9])]
            T = np.eye(4, dtype=np.float32)
            T[:3, :3] = R.from_quat(quat_xyzw).as_matrix()
            T[:3, 3] = t
            transforms.append(T)
            timestamps.append(int(parts[1]))
    return {
        "Ts_world_from_device": np.stack(transforms),
        "timestamps": np.array(timestamps),
    }


def rotation_z_90cw() -> np.ndarray:
    """4x4 rotation 90 deg clockwise about camera Z (ase_multiview.py:110-131)."""
    Rt = np.eye(4, dtype=np.float32)
    Rt[:3, :3] = np.array([[0, 1, 0], [-1, 0, 0], [0, 0, 1]], np.float32)
    return Rt


def adjust_intrinsics_for_90cw(K: np.ndarray, width: int, height: int
                               ) -> np.ndarray:
    """Intrinsics after rotating the image 90 deg clockwise
    (ase_multiview.py:137-163): new (cx, cy) = (H-1-cy, cx); fx/fy swap."""
    K2 = K.copy()
    K2[0, 0], K2[1, 1] = K[1, 1], K[0, 0]
    K2[0, 2] = height - 1 - K[1, 2]
    K2[1, 2] = K[0, 2]
    return K2


@register_dataset
class ASE_Multiview(BaseViewDataset):
    def __init__(self, ROOT, split="train", num_views=4, window_size=10,
                 num_samples_per_window=10, data_scaling=1.0, ordered=False,
                 max_scenes=None, vignette_file=None, *args, **kwargs):
        super().__init__(num_views=num_views, split=split, *args, **kwargs)
        self.ROOT = ROOT
        self.scenes = sorted(
            d for d in os.listdir(ROOT) if osp.isdir(osp.join(ROOT, d)))
        if max_scenes:
            self.scenes = self.scenes[:max_scenes]
        if data_scaling < 1.0:
            self.scenes = self.scenes[: max(1, int(len(self.scenes)
                                                   * data_scaling))]

        self.metadata = []
        scene_to_indices = {}
        for sid, name in enumerate(self.scenes):
            traj = read_trajectory_file(osp.join(ROOT, name, "trajectory.csv"))
            idxs = []
            for frame_idx in range(len(traj["Ts_world_from_device"])):
                idxs.append(len(self.metadata))
                self.metadata.append((sid, frame_idx, name, traj))
            scene_to_indices[sid] = idxs

        combo_rng = np.random.default_rng(1234)
        self.combinations = []
        for idxs in scene_to_indices.values():
            self.combinations += windowed_combinations(
                idxs, num_views, window_size, num_samples_per_window,
                combo_rng, ordered)
        self.combinations = sorted(set(self.combinations))
        self.vignette = VignetteCorrector(vignette_file)

    def __len__(self):
        return len(self.combinations)

    def _get_views(self, idx, resolution, rng):
        import PIL.Image

        views = []
        for view_idx in self.combinations[idx]:
            sid, frame_idx, name, traj = self.metadata[view_idx]
            sdir = osp.join(self.ROOT, name)

            pose = traj["Ts_world_from_device"][frame_idx].copy()
            pose = pose @ T_DEVICE_FROM_CAMERA

            rgb = imread_cv2(
                osp.join(sdir, "rgb", f"vignette{frame_idx:07d}.jpg"),
                IMREAD_COLOR).astype(np.float32)
            depth = imread_cv2(
                osp.join(sdir, "depth", f"depth{frame_idx:07d}.png"),
                IMREAD_UNCHANGED).astype(np.float32)

            rgb = self.vignette.correct(rgb)
            rgb_u, depth_u = undistort_fisheye_to_pinhole_rgbd(
                rgb, depth, FISHEYE_CAM_PARAMS, PINHOLE_CAM_PARAMS)

            H, W = rgb_u.shape[:2]
            rgb_r = rotate90_cw(rgb_u)
            depth_r = rotate90_cw(depth_u)
            K = adjust_intrinsics_for_90cw(ASE_INTRINSICS.copy(), W, H)
            pose = pose @ rotation_z_90cw()
            depthmap = depth_r / 1000.0

            img = PIL.Image.fromarray(
                np.clip(rgb_r, 0, 255).astype(np.uint8), mode="RGB")
            img, depthmap, K = self._crop_resize_if_necessary(
                img, depthmap, K, resolution, rng=rng, info=view_idx)
            views.append(dict(
                img=img, depthmap=depthmap.astype(np.float32),
                camera_pose=pose.astype(np.float32),
                camera_intrinsics=K.astype(np.float32),
                dataset="ASE", label=f"{name}_{frame_idx:07d}",
                instance=f"{idx}_{view_idx}",
            ))
        return views
