"""Multiview training dataset loaders.

Counterpart of ``fast3r_tpu/data/datasets/multiview.py``, with the file
reads of the port's ``data/io.py`` (PIL and the port's EXR codec, no cv2).
Behavioral reference (fast3r/dust3r/datasets/*_multiview.py): each dataset
builds a precomputed list of view combinations sampled within temporal/angular
windows, then loads RGB + depth + camera parameters per view and routes them
through the base crop/resize pipeline.  File-format contracts (paths, depth
scalings, metadata layouts) follow each reference loader exactly; the windowed
combination generator is shared here instead of being copy-pasted per dataset.

Combination sampling uses the dataset-level rng seeded at construction (the
reference uses the global `random` module seeded implicitly; we make it
explicit and deterministic).
"""

from __future__ import annotations

import json
import os
import os.path as osp
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from fast3r_torch.data.base import BaseViewDataset
from fast3r_torch.data.dsl import register_dataset
from fast3r_torch.data.io import IMREAD_UNCHANGED, imread_cv2


def windowed_combinations(
    indices: Sequence[int],
    num_views: int,
    window_size: int,
    num_samples_per_window: int,
    rng: np.random.Generator,
    ordered: bool = False,
) -> List[Tuple[int, ...]]:
    """Sample view combinations within sliding windows
    (reference scannetpp_multiview.py:67-90 et al.): for each anchor index, a
    window of `window_size` neighbors; `num_samples_per_window` random
    `num_views`-subsets; dedup + sort."""
    combos = []
    indices = list(indices)
    n = len(indices)
    if n < num_views:
        return []
    half = window_size // 2
    for i in range(n):
        window = indices[max(0, i - half):min(n, i + half)]
        if len(window) < num_views:
            continue
        for _ in range(num_samples_per_window):
            combo = list(rng.choice(window, size=num_views, replace=False))
            if ordered:
                combo = sorted(combo, key=window.index)
            combos.append(tuple(int(c) for c in combo))
    return sorted(set(combos))


class _MetadataNpzDataset(BaseViewDataset):
    """Shared base for datasets stored as an all_metadata.npz table
    (scenes, sceneids, images, intrinsics, trajectories)."""

    def _load_metadata(self, path: str):
        with np.load(path) as data:
            self.scenes = data["scenes"]
            self.sceneids = data["sceneids"]
            self.images = data["images"]
            self.intrinsics = data["intrinsics"].astype(np.float32)
            self.trajectories = data["trajectories"].astype(np.float32)

    def __len__(self):
        return len(self.combinations)

    def _jitter_within(self, image_indices, valid_indices, rng, spread=2):
        """+-spread jitter along the ordered valid index list
        (reference scannetpp_multiview.py:101-106)."""
        out = []
        for im_idx in image_indices:
            off = int(rng.integers(-spread, spread + 1))
            pos = valid_indices.index(im_idx) + off
            pos = max(0, min(pos, len(valid_indices) - 1))
            out.append(valid_indices[pos])
        return out


@register_dataset
class ScanNetpp_Multiview(_MetadataNpzDataset):
    """ScanNet++ (reference scannetpp_multiview.py): all_metadata.npz; frames
    segregated into iPhone ('frame_' prefix) vs DSLR streams; depth png/1000."""

    def __init__(self, num_views=4, window_size=60, num_samples_per_window=100,
                 ordered=False, data_scaling=1.0, *args, ROOT, **kwargs):
        super().__init__(num_views=num_views, *args, **kwargs)
        self.ROOT = ROOT
        self.window_size = window_size
        self.ordered = ordered
        assert self.split == "train"
        self._load_metadata(osp.join(ROOT, "all_metadata.npz"))

        self.scene_to_indices: Dict[int, Dict[str, List[int]]] = {}
        for idx, sid in enumerate(self.sceneids):
            d = self.scene_to_indices.setdefault(int(sid), {"iphone": [], "dslr": []})
            kind = "iphone" if "frame_" in str(self.images[idx]) else "dslr"
            d[kind].append(idx)
        if data_scaling < 1.0:
            keep = sorted(self.scene_to_indices)[
                : max(1, int(len(self.scene_to_indices) * data_scaling))]
            self.scene_to_indices = {k: self.scene_to_indices[k] for k in keep}
        for d in self.scene_to_indices.values():
            for k in d:
                d[k].sort(key=lambda i: str(self.images[i]))

        combo_rng = np.random.default_rng(1234)
        self.combinations = []
        for d in self.scene_to_indices.values():
            for k in ("iphone", "dslr"):
                self.combinations += windowed_combinations(
                    d[k], num_views, window_size, num_samples_per_window,
                    combo_rng, ordered,
                )
        self.combinations = sorted(set(self.combinations))

    def _get_views(self, idx, resolution, rng):
        image_indices = list(self.combinations[idx])
        sid = int(self.sceneids[image_indices[0]])
        kind = "iphone" if "frame_" in str(self.images[image_indices[0]]) else "dslr"
        image_indices = self._jitter_within(
            image_indices, self.scene_to_indices[sid][kind], rng)

        views = []
        for view_idx in image_indices:
            sid = int(self.sceneids[view_idx])
            scene_dir = osp.join(self.ROOT, str(self.scenes[sid]))
            basename = str(self.images[view_idx])
            rgb = imread_cv2(osp.join(scene_dir, "images", basename + ".jpg"))
            depth = imread_cv2(osp.join(scene_dir, "depth", basename + ".png"),
                               IMREAD_UNCHANGED).astype(np.float32) / 1000
            depth[~np.isfinite(depth)] = 0
            rgb, depth, K = self._crop_resize_if_necessary(
                rgb, depth, self.intrinsics[view_idx].copy(), resolution,
                rng=rng, info=view_idx)
            views.append(dict(
                img=rgb, depthmap=depth.astype(np.float32),
                camera_pose=self.trajectories[view_idx].astype(np.float32),
                camera_intrinsics=K.astype(np.float32),
                dataset="ScanNet++",
                label=f"{self.scenes[sid]}_{basename}",
                instance=f"{idx}_{view_idx}",
            ))
        return views


@register_dataset
class ARKitScenes_Multiview(_MetadataNpzDataset):
    """ARKitScenes (reference arkitscenes_multiview.py): per-split metadata;
    vga_wide jpgs + lowres_depth pngs (mm)."""

    def __init__(self, num_views=4, window_size=6, num_samples_per_window=10,
                 ordered=False, data_scaling=1.0, *args, split, ROOT, **kwargs):
        super().__init__(num_views=num_views, split=split, *args, **kwargs)
        self.ROOT = ROOT
        self._load_metadata(osp.join(ROOT, split, "all_metadata.npz"))

        scene_to_indices: Dict[int, List[int]] = {}
        for idx, sid in enumerate(self.sceneids):
            scene_to_indices.setdefault(int(sid), []).append(idx)
        if data_scaling < 1.0:
            keep = sorted(scene_to_indices)[
                : max(1, int(len(scene_to_indices) * data_scaling))]
            scene_to_indices = {k: scene_to_indices[k] for k in keep}
        for v in scene_to_indices.values():
            v.sort(key=lambda i: str(self.images[i]))
        self.scene_to_indices = scene_to_indices

        combo_rng = np.random.default_rng(1234)
        self.combinations = []
        for indices in scene_to_indices.values():
            self.combinations += windowed_combinations(
                indices, num_views, window_size, num_samples_per_window,
                combo_rng, ordered,
            )
        self.combinations = sorted(set(self.combinations))

    def _get_views(self, idx, resolution, rng):
        views = []
        for view_idx in self.combinations[idx]:
            sid = int(self.sceneids[view_idx])
            scene_dir = osp.join(self.ROOT, self.split, str(self.scenes[sid]))
            basename = str(self.images[view_idx])
            rgb = imread_cv2(
                osp.join(scene_dir, "vga_wide", basename.replace(".png", ".jpg")))
            depth = imread_cv2(osp.join(scene_dir, "lowres_depth", basename),
                               IMREAD_UNCHANGED).astype(np.float32) / 1000
            depth[~np.isfinite(depth)] = 0
            rgb, depth, K = self._crop_resize_if_necessary(
                rgb, depth, self.intrinsics[view_idx].copy(), resolution,
                rng=rng, info=view_idx)
            views.append(dict(
                img=rgb, depthmap=depth.astype(np.float32),
                camera_pose=self.trajectories[view_idx].astype(np.float32),
                camera_intrinsics=K.astype(np.float32),
                dataset="arkitscenes",
                label=f"{self.scenes[sid]}_{basename}",
                instance=f"{idx}_{view_idx}",
            ))
        return views


@register_dataset
class Co3d_Multiview(BaseViewDataset):
    """CO3Dv2 (reference co3d_multiview.py): selected_seqs json of
    (category, sequence) -> frame pool; 16-bit depth png scaled by
    maximum_depth/65535; optional background masking; invalid-scene retry."""

    def __init__(self, num_views=4, window_degree_range=360,
                 num_samples_per_window=100, data_scaling=1.0, mask_bg=True,
                 *args, ROOT, **kwargs):
        super().__init__(num_views=num_views, *args, **kwargs)
        self.ROOT = ROOT
        assert mask_bg in (True, False, "rand")
        self.mask_bg = mask_bg
        self.invalid_scene_tracker = set()

        with open(osp.join(ROOT, f"selected_seqs_{self.split}.json")) as f:
            scenes = json.load(f)
        scenes = {k: v for k, v in scenes.items() if len(v) > 0}
        if data_scaling < 1.0:
            for obj in scenes:
                traj = scenes[obj]
                n = max(1, int(len(traj) * data_scaling))
                scenes[obj] = dict(list(traj.items())[:n])
        self.scenes = {(k, k2): v2 for k, v in scenes.items()
                       for k2, v2 in v.items()}
        self.scene_list = list(self.scenes.keys())

        combo_rng = np.random.default_rng(1234)
        num_images = 100
        max_diff = window_degree_range * num_images // 360
        self.combinations = windowed_combinations(
            range(num_images), num_views, max_diff, num_samples_per_window,
            combo_rng,
        )
        self.invalidate = {s: {} for s in self.scene_list}

    def __len__(self):
        return len(self.scene_list) * len(self.combinations)

    def _get_views(self, idx, resolution, rng, max_scene_retries=5):
        def try_scene(obj, instance):
            pool = self.scenes[obj, instance]
            inval = self.invalidate[obj, instance].setdefault(
                resolution, [False] * len(pool))
            views = self._fetch_pool(idx, obj, instance, pool, inval,
                                     resolution, rng)
            if not views:
                self.invalid_scene_tracker.add((obj, instance))
            return views

        # cheap deterministic window first: walk forward from idx
        for attempt in range(max_scene_retries):
            scene_idx = (idx + attempt) % len(self.scene_list)
            obj, instance = self.scene_list[scene_idx]
            if (obj, instance) in self.invalid_scene_tracker:
                continue
            views = try_scene(obj, instance)
            if views:
                return views
        # clustered-failure recovery (reference co3d_multiview.py:107-130:
        # persistent invalid set + resampling a fresh scene): try every
        # not-yet-invalidated scene in a seeded random order; raise only
        # when the WHOLE dataset is invalid — loud, not a hang
        remaining = [s for s in self.scene_list
                     if s not in self.invalid_scene_tracker]
        for si in rng.permutation(len(remaining)):
            views = try_scene(*remaining[si])
            if views:
                return views
        raise ValueError(
            f"no valid views: {max_scene_retries} scenes from idx {idx} and "
            f"all {len(remaining)} remaining scenes failed "
            f"({len(self.invalid_scene_tracker)}/{len(self.scene_list)} "
            "scenes invalidated)")

    def _fetch_pool(self, idx, obj, instance, pool, inval, resolution, rng):
        last = len(pool) - 1
        combo = self.combinations[idx % len(self.combinations)]
        todo = [max(0, min(i + int(rng.integers(-4, 5)), last)) for i in combo]
        views, valid = [], []
        for im_idx in todo:
            if inval[im_idx]:
                continue
            v = self._load_view(obj, instance, pool, im_idx, resolution, rng,
                                inval)
            if v:
                views.append(v)
                valid.append(im_idx)
                if len(views) == self.num_views:
                    return views
        while len(views) < self.num_views and valid:
            v = self._load_view(obj, instance, pool,
                                valid[int(rng.integers(len(valid)))],
                                resolution, rng, inval)
            if v:
                views.append(v)
        return views if len(views) == self.num_views else None

    def _load_view(self, obj, instance, pool, im_idx, resolution, rng, inval):
        try:
            view_idx = pool[im_idx]
            impath = osp.join(self.ROOT, obj, instance, "images",
                              f"frame{view_idx:06n}.jpg")
            meta = np.load(impath.replace("jpg", "npz"))
            pose = meta["camera_pose"].astype(np.float32)
            K = meta["camera_intrinsics"].astype(np.float32)
            rgb = imread_cv2(impath)
            depth = imread_cv2(
                impath.replace("images", "depths") + ".geometric.png",
                IMREAD_UNCHANGED,
            ).astype(np.float32) / 65535 * np.nan_to_num(meta["maximum_depth"])
            mask_bg = self.mask_bg is True or (
                self.mask_bg == "rand" and rng.integers(2))
            if mask_bg:
                maskpath = osp.join(self.ROOT, obj, instance, "masks",
                                    f"frame{view_idx:06n}.png")
                mask = imread_cv2(maskpath, IMREAD_UNCHANGED)
                depth *= (mask.astype(np.float32) / 255.0) > 0.1
            rgb, depth, K = self._crop_resize_if_necessary(
                rgb, depth, K, resolution, rng=rng, info=impath)
            if (depth > 0.0).sum() == 0:
                inval[im_idx] = True
                return None
            return dict(
                img=rgb, depthmap=depth, camera_pose=pose,
                camera_intrinsics=K, dataset="Co3d_v2",
                label=osp.join(obj, instance),
                instance=osp.split(impath)[1],
            )
        except Exception:
            return None


@register_dataset
class MegaDepth_Multiview(BaseViewDataset):
    """MegaDepth (reference megadepth_multiview.py): per-image exr depth +
    npz cam (intrinsics, cam2world); scene/subscene directory layout."""

    def __init__(self, num_views=4, window_size=60, num_samples_per_window=100,
                 *args, ROOT, **kwargs):
        super().__init__(num_views=num_views, *args, **kwargs)
        self.ROOT = ROOT
        with np.load(osp.join(ROOT, "all_metadata_for_multiview.npz")) as data:
            self.scenes = data["scenes"]
            self.sceneids = data["sceneids"]
            self.images = data["images"]
        self.scene_to_images: Dict[str, List[int]] = {}
        self.image_to_scene: Dict[int, str] = {}
        for img_idx, sid in enumerate(self.sceneids):
            scene = str(self.scenes[sid])
            self.scene_to_images.setdefault(scene, []).append(img_idx)
            self.image_to_scene[img_idx] = scene

        combo_rng = np.random.default_rng(1234)
        self.combinations = []
        for indices in self.scene_to_images.values():
            self.combinations += windowed_combinations(
                indices, num_views, window_size, num_samples_per_window,
                combo_rng,
            )
        self.combinations = sorted(set(self.combinations))

    def __len__(self):
        return len(self.combinations)

    def _get_views(self, idx, resolution, rng):
        image_indices = list(self.combinations[idx])
        scene_name = self.image_to_scene[image_indices[0]]
        valid = self.scene_to_images[scene_name]
        out = []
        for im_idx in image_indices:
            off = int(rng.integers(-2, 3))
            pos = max(0, min(valid.index(im_idx) + off, len(valid) - 1))
            out.append(valid[pos])

        scene, subscene = scene_name.split("/")
        seq_path = osp.join(self.ROOT, scene, subscene)
        views = []
        for im_id in out:
            img = str(self.images[im_id])
            image = imread_cv2(osp.join(seq_path, img + ".jpg"))
            depth = imread_cv2(osp.join(seq_path, img + ".exr"))
            cam = np.load(osp.join(seq_path, img + ".npz"))
            K = np.float32(cam["intrinsics"])
            pose = np.float32(cam["cam2world"])
            image, depth, K = self._crop_resize_if_necessary(
                image, depth, K, resolution, rng, info=(seq_path, img))
            views.append(dict(
                img=image, depthmap=depth, camera_pose=pose,
                camera_intrinsics=K, dataset="MegaDepth",
                label=osp.relpath(seq_path, self.ROOT), instance=img,
            ))
        return views


@register_dataset
class Habitat_Multiview(BaseViewDataset):
    """Habitat renders (reference habitat_multiview.py): 5 views per scene key,
    jpeg + exr depth + json camera params; view 0 always anchors."""

    def __init__(self, size=1_000_000, num_views=4, data_scaling=1.0, *args,
                 ROOT, **kwargs):
        super().__init__(num_views=num_views, *args, **kwargs)
        self.ROOT = ROOT
        with open(osp.join(ROOT, f"Habitat_{size}_scenes_{self.split}.txt")) as f:
            self.scenes = f.read().splitlines()
        if data_scaling < 1.0:
            n = max(1, int(len(self.scenes) * data_scaling))
            self.scenes = sorted(self.scenes)[:n]
        self.instances = list(range(1, 5))

    def _get_views(self, idx, resolution, rng):
        scene = self.scenes[idx]
        data_path, key = osp.split(osp.join(self.ROOT, scene))
        selected = [0]
        if self.num_views > 5:
            selected += list(rng.choice(self.instances, size=self.num_views - 1,
                                        replace=True))
        else:
            selected += list(rng.choice(
                self.instances, size=min(len(self.instances), self.num_views - 1),
                replace=False))

        views = []
        for view_index in selected:
            found = None
            for ii in range(view_index, view_index + 5):
                try:
                    image, depth, K, pose = self._load_one_view(
                        data_path, key, ii % 5, resolution, rng)
                except FileNotFoundError:
                    continue
                if np.isfinite(pose).all():
                    found = view_index
                    break
            if found is None:
                # all 5 candidates missing/invalid: fail loudly instead of
                # reusing stale (or unbound) image/pose from a prior view
                raise RuntimeError(
                    f"Habitat scene {key!r} under {data_path} has no loadable "
                    f"view near index {view_index}")
            views.append(dict(
                img=image, depthmap=depth, camera_pose=pose,
                camera_intrinsics=K, dataset="Habitat",
                label=osp.relpath(data_path, self.ROOT),
                instance=f"{key}_{view_index}",
            ))
        return views

    def _load_one_view(self, data_path, key, view_index, resolution, rng):
        import PIL.Image

        view_index += 1  # file indices start at 1
        impath = osp.join(data_path, f"{key}_{view_index}.jpeg")
        if not osp.exists(impath):
            raise FileNotFoundError(impath)
        image = PIL.Image.open(impath)
        # reference habitat.py:55 uses cv2.imread(GRAYSCALE|ANYDEPTH);
        # imread_cv2 reads the EXR through the port's own codec
        depth = imread_cv2(
            osp.join(data_path, f"{key}_{view_index}_depth.exr"))
        with open(osp.join(data_path,
                           f"{key}_{view_index}_camera_params.json")) as f:
            cam = json.load(f)
        K = np.float32(cam["camera_intrinsics"])
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = cam["R_cam2world"]
        pose[:3, 3] = cam["t_cam2world"]
        image, depth, K = self._crop_resize_if_necessary(
            image, depth, K, resolution, rng, info=impath)
        return image, depth, K, pose


@register_dataset
class BlendedMVS_Multiview(BaseViewDataset):
    """BlendedMVS multiview training loader (reference
    dust3r/datasets/blendedmvs_multiview.py:14-111): blendedmvs_pairs.npy is
    a STRUCTURED array with fields (seq_high, seq_low, img1, img2, score);
    scene dirs are the 24-hex-char f"{seqh:08x}{seql:016x}"; per-image flat
    files <idx>.jpg/.exr/.npz with {intrinsics, R_cam2world, t_cam2world};
    train/val split by seq_low % 10.

    NOTE: the training configs' `BlendMVS` is the *spann3r* loader
    (blended_images/ + cams/pair.txt layout) of the JAX package's
    eval_many_view_extra.py, not yet ported — this class covers the
    dust3r-processed flat layout."""

    def __init__(self, num_views=4, num_samples_per_window=10, window_size=6,
                 ordered=False, *args, ROOT, split=None, **kwargs):
        super().__init__(num_views=num_views, split=split, *args, **kwargs)
        self.ROOT = ROOT
        pairs = np.load(osp.join(ROOT, "blendedmvs_pairs.npy"))
        if pairs.dtype.names:  # structured array (the shipped format)
            seq_low = np.asarray(pairs[pairs.dtype.names[1]])
        else:  # plain 2D fallback
            seq_low = np.asarray(pairs[:, 1])
        if split == "train":
            pairs = pairs[seq_low.astype(np.int64) % 10 > 0]
        elif split == "val":
            pairs = pairs[seq_low.astype(np.int64) % 10 == 0]

        scene_to_indices: Dict[str, List[int]] = {}
        for seqh, seql, img1, img2, score in (tuple(r) for r in pairs):
            scene_id = f"{int(seqh):08x}{int(seql):016x}"
            d = scene_to_indices.setdefault(scene_id, [])
            d.extend([int(img1), int(img2)])
        self.scene_to_indices = {
            k: sorted(set(v)) for k, v in scene_to_indices.items()
        }

        combo_rng = np.random.default_rng(1234)
        self.combinations = []
        for scene_id, indices in self.scene_to_indices.items():
            for combo in windowed_combinations(
                    indices, self.num_views, window_size,
                    num_samples_per_window, combo_rng, ordered):
                self.combinations.append((scene_id, combo))
        self.combinations = sorted(set(self.combinations))

    def __len__(self):
        return len(self.combinations)

    def _get_views(self, idx, resolution, rng):
        scene_id, combo = self.combinations[idx]
        seq_path = osp.join(self.ROOT, scene_id)
        views = []
        for im_id in combo:
            name = f"{im_id:08d}"
            image = imread_cv2(osp.join(seq_path, name + ".jpg"))
            depth = imread_cv2(osp.join(seq_path, name + ".exr"))
            cam = np.load(osp.join(seq_path, name + ".npz"))
            K = np.float32(cam["intrinsics"])
            pose = np.eye(4, dtype=np.float32)
            pose[:3, :3] = cam["R_cam2world"]
            pose[:3, 3] = cam["t_cam2world"]
            image, depth, K = self._crop_resize_if_necessary(
                image, depth, K, resolution, rng, info=(seq_path, name))
            views.append(dict(
                img=image, depthmap=depth, camera_pose=pose,
                camera_intrinsics=K, dataset="BlendedMVS",
                label=scene_id, instance=name,
            ))
        return views
