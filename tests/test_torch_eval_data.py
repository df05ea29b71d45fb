"""The port's eval data (fast3r_torch.data) against fast3r_tpu's and cv2 on
the CPU, on synthetic roots in each dataset's own on-disk format.

* ``data/imgproc.py`` and the PFM reader against cv2 (5.0):
  erode, rotate, nearest remap, linear remap and the PFM reads exactly,
  Rodrigues within 1e-12, the linear resize exactly on downscales and equal
  sizes and within one level on upscales (cv2's first and last rows round
  differently there; under 2% of the pixels).  The nearest resize is
  ``cropping.resize_nearest`` (``tests/test_torch_data.py``).
* Every eval and pairwise dataset of the JAX registry (``DTU``,
  ``SevenScenes``, ``NRGBD``, ``Co3d``, ``Scannet``, ``Demo``,
  ``ArkitScene``, ``BlendMVS``, ``HabitatEval``, ``Scannetpp``,
  ``ASE_Multiview``, ``Co3dPairwise``, ``WildRGBD``, ``StaticThings3D``,
  ``Waymo``): the same DSL string and seed give views whose every key
  (img, depthmap, camera_intrinsics, camera_pose, pts3d, valid_mask,
  true_shape, dataset, label, ...) equals JAX's exactly.
* The port's registry holds JAX's names, and ``super_long_training``'s own
  train and validation lists build in both with their ROOTs on synthetic
  roots.
"""

import json
import os
import pathlib

import cv2
import numpy as np
import PIL.Image
import pytest
from scipy.spatial.transform import Rotation

from fast3r_tpu.data import aria_camera as jaria
from fast3r_tpu.data.dsl import DATASET_REGISTRY as JAX_REGISTRY
from fast3r_tpu.data.dsl import build_dataset as jax_build
from fast3r_tpu.data.exr import write_exr

from fast3r_torch.data import aria_camera as taria
from fast3r_torch.data import imgproc
from fast3r_torch.data.dsl import DATASET_REGISTRY as PORT_REGISTRY
from fast3r_torch.data.dsl import build_dataset as port_build
from fast3r_torch.data.io import IMREAD_UNCHANGED, imread_cv2, read_pfm

from test_real_datasets import (
    make_dtu_root,
    make_nrgbd_root,
    make_sevenscenes_root,
)
from test_torch_data import (  # noqa: F401 (jax_numpy_pts is a fixture)
    _assert_views_equal,
    _depth_mm,
    _jpg,
    _K,
    _mk,
    _png16,
    _pose,
    jax_numpy_pts,
    make_arkitscenes_root,
    make_co3d_root,
    make_habitat_root,
    make_megadepth_root,
    make_scannetpp_root,
)
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

RES = "[(64, 48)]"


# ---------------------------------------------------------------------------
# (a) cv2's operations and the PFM read
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src,dst", [
    ((480, 640), (384, 512)), ((968, 1296), (480, 640)), ((96, 128), (48, 64)),
    ((194, 259), (96, 128)), ((480, 640), (480, 640)), ((96, 128), (200, 300)),
    ((30, 40), (31, 41)), ((37, 53), (111, 9)),
])
@pytest.mark.parametrize("channels", [3, 1])
def test_resize_linear_matches_cv2(src, dst, channels):
    rng = np.random.default_rng(0)
    shape = src + ((channels,) if channels == 3 else ())
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    want = cv2.resize(img, dst[::-1])
    got = imgproc.resize_linear(img, dst[::-1])
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)   # every shape, upscales too


def test_cv2_ops_match():
    rng = np.random.default_rng(1)
    mask = (rng.random((120, 160)) > 0.2).astype(np.float32)
    mask[50:53] = 0
    np.testing.assert_array_equal(
        imgproc.erode(mask, (10, 10)),
        cv2.erode(mask, np.ones((10, 10), np.uint8), iterations=1))
    for r in [rng.normal(size=3), 1e-3 * rng.normal(size=3), np.zeros(3)]:
        np.testing.assert_allclose(imgproc.rodrigues(r), cv2.Rodrigues(r)[0],
                                   rtol=0, atol=1e-12)
    img = rng.random((70, 90, 3)).astype(np.float32) * 255
    np.testing.assert_array_equal(imgproc.rotate90_cw(img),
                                  cv2.rotate(img, cv2.ROTATE_90_CLOCKWISE))
    mx = (rng.random((60, 80)) * 110 - 10).astype(np.float32)
    my = (rng.random((60, 80)) * 90 - 10).astype(np.float32)
    mx[0, :4] = [3.5, 4.5, -0.5, 89.0]                 # ties, edges
    for linear, interp in ((True, cv2.INTER_LINEAR),
                           (False, cv2.INTER_NEAREST)):
        for im in (img, np.ascontiguousarray(img[..., 0])):
            want = cv2.remap(im, mx, my, interpolation=interp,
                             borderMode=cv2.BORDER_CONSTANT, borderValue=0)
            np.testing.assert_array_equal(
                imgproc.remap(im, mx, my, linear=linear), want)


def test_pfm_matches_cv2(tmp_path):
    rng = np.random.default_rng(2)
    for i, shape in enumerate([(96, 128), (7, 9, 3)]):
        path = str(tmp_path / f"d{i}.pfm")
        cv2.imwrite(path, rng.uniform(-3, 5, shape).astype(np.float32))
        from fast3r_tpu.data.io import imread_cv2 as jax_read

        want = jax_read(path, cv2.IMREAD_UNCHANGED)
        for got in (read_pfm(path), imread_cv2(path, IMREAD_UNCHANGED)):
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)


def test_aria_camera_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    xyz = rng.normal(size=(200, 3)) + [0, 0, 3]
    np.testing.assert_array_equal(
        taria.fisheye624_project(xyz, taria.FISHEYE_CAM_PARAMS),
        jaria.fisheye624_project(xyz, jaria.FISHEYE_CAM_PARAMS))
    uv = rng.uniform(100, 600, (200, 2))
    np.testing.assert_array_equal(
        taria.fisheye624_unproject(uv, taria.FISHEYE_CAM_PARAMS),
        jaria.fisheye624_unproject(uv, jaria.FISHEYE_CAM_PARAMS))
    img = (rng.random((160, 176, 3)) * 255).astype(np.float32)
    depth = rng.uniform(800, 4000, (160, 176)).astype(np.float32)
    fish = np.array([80.0, 88.0, 80.0, 0.3, -0.1, 0, 0, 0, 0, 1e-3, -5e-4,
                     0, 0, 0, 0], np.float32)
    pin = np.array([80.0, 80.0, 88.0, 80.0], np.float32)
    for got, want in zip(
            taria.undistort_fisheye_to_pinhole_rgbd(img, depth, fish, pin),
            jaria.undistort_fisheye_to_pinhole_rgbd(img, depth, fish, pin)):
        np.testing.assert_array_equal(got, want)
    # the vignette image is kept in cv2.imread's BGR order
    vig = rng.integers(1, 256, (8, 10, 3), dtype=np.uint8)
    vig[0, 0] = 0
    PIL.Image.fromarray(vig).save(str(tmp_path / "vig.png"))
    port = taria.VignetteCorrector(str(tmp_path / "vig.png"))
    ref = jaria.VignetteCorrector(str(tmp_path / "vig.png"))
    np.testing.assert_array_equal(port.vignette, ref.vignette)
    x = rng.uniform(0, 255, (8, 10, 3)).astype(np.float32)
    np.testing.assert_array_equal(port.correct(x), ref.correct(x))
    assert taria.VignetteCorrector(str(tmp_path / "none.png")).vignette is None


# ---------------------------------------------------------------------------
# (b) synthetic roots in each dataset's own layout
# ---------------------------------------------------------------------------

def _write_dtu_pairs(root):
    """DTU's pair.txt for the sampled (non-full_video) road."""
    scene = os.path.join(root, "scan1")
    names = sorted(os.listdir(os.path.join(scene, "images")))
    lines = [str(len(names))]
    for i in range(len(names)):
        others = [j for j in range(len(names)) if j != i]
        lines += [str(i), f"{len(others)} " + " ".join(
            f"{j} {100 - abs(i - j)}" for j in others)]
    with open(os.path.join(scene, "pair.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return root


def make_scannet_root(root):
    """scans_test/<scene>/sensor_data frame-XXXXXX.{color.jpg, depth.png,
    pose.txt}: colour at ScanNet's 1296x968 aspect, depth at 128x96 (a
    cv2 linear downscale), one frame without valid depth."""
    rng = np.random.default_rng(21)
    scene = "scene0707_00"
    sdir = _mk(os.path.join(root, "scans_test", scene, "sensor_data"))
    intr = _mk(os.path.join(root, "scans_test", scene, "intrinsic"))
    K4 = np.eye(4)
    K4[:3, :3] = _K(128, 96, 110.0)
    np.savetxt(os.path.join(intr, "intrinsic_depth.txt"), K4)
    for i in range(6):
        _jpg(os.path.join(sdir, f"frame-{i:06d}.color.jpg"), rng, 259, 194)
        depth = _depth_mm(rng, 128, 96)
        if i == 3:
            depth[:] = 0
        _png16(os.path.join(sdir, f"frame-{i:06d}.depth.png"), depth)
        np.savetxt(os.path.join(sdir, f"frame-{i:06d}.pose.txt"), _pose(i))
    with open(os.path.join(_mk(os.path.join(root, "splits")),
                           "scannetv2_test.txt"), "w") as f:
        f.write(scene + "\n")
    return root


def make_demo_root(root):
    """A folder of photos: two with *_depth.png (half the photo's size: the
    photo takes a linear downscale) and .npz cameras of the depth's size,
    one bare."""
    rng = np.random.default_rng(22)
    _mk(root)
    for i in range(3):
        _jpg(os.path.join(root, f"img{i}.jpg"), rng, 160, 120)
        if i < 2:
            _png16(os.path.join(root, f"img{i}_depth.png"),
                   _depth_mm(rng, 80, 60))
            np.savez(os.path.join(root, f"img{i}.npz"), camera_pose=_pose(i),
                     camera_intrinsics=_K(80, 60, 50.0))
    return root


def make_arkit_raw_root(root):
    """raw/Training/<scene>/{vga_wide, lowres_depth, vga_wide_intrinsics,
    lowres_wide.traj}: timestamps as frame ids, one intrinsics file off by
    0.001 s (the fuzzy match), one frame without a pose."""
    rng = np.random.default_rng(23)
    scene = "41069025"
    sdir = os.path.join(root, "raw", "Training", scene)
    traj = []
    for i in range(6):
        fid = f"{100 + 0.5 * i:.3f}"
        _jpg(os.path.join(sdir, "vga_wide", f"{scene}_{fid}.png"), rng)
        _png16(os.path.join(sdir, "lowres_depth", f"{scene}_{fid}.png"),
               _depth_mm(rng))
        pin_id = f"{float(fid) + 0.001:.3f}" if i == 2 else fid
        with open(os.path.join(_mk(os.path.join(sdir, "vga_wide_intrinsics")),
                               f"{scene}_{pin_id}.pincam"), "w") as f:
            f.write(f"128 96 100.0 101.0 {64 + i} 48\n")
        if i != 4:
            r = 0.1 * rng.normal(size=3)
            traj.append(f"{float(fid)} {r[0]} {r[1]} {r[2]} {0.1 * i} 0.02 "
                        f"{-0.05 * i}")
    with open(os.path.join(sdir, "lowres_wide.traj"), "w") as f:
        f.write("\n".join(traj) + "\n")
    return root


def make_habitat_eval_root(root):
    """<category>/<scene>/<seq:08>_<i>.jpeg + _depth.exr +
    _camera_params.json, frames 1..num_frames of two sequences."""
    rng = np.random.default_rng(24)
    for cat, scene in (("apt", "s0"), ("office", "s1")):
        sdir = _mk(os.path.join(root, cat, scene))
        for seq in range(2):
            for i in range(1, 5):
                base = os.path.join(sdir, f"{seq:08}_{i}")
                _jpg(base + ".jpeg", rng)
                write_exr(base + "_depth.exr",
                          rng.uniform(1.0, 4.0, (96, 128)).astype(np.float32))
                pose = _pose(i + seq)
                with open(base + "_camera_params.json", "w") as f:
                    json.dump({"camera_intrinsics": _K().tolist(),
                               "R_cam2world": pose[:3, :3].tolist(),
                               "t_cam2world": pose[:3, 3].tolist()}, f)
    return root


def make_scannetpp_dslr_root(root):
    """data/<scene>/dslr/{nerfstudio/transforms_undistorted.json,
    train_test_lists.json, undistorted_images, undistorted_depths} and
    splits/nvs_sem_train.txt."""
    rng = np.random.default_rng(25)
    scene = "0a5c013435"
    base = os.path.join(root, "data", scene, "dslr")
    names = [f"DSC{i:05d}.JPG" for i in range(6)]
    frames = []
    for i, name in enumerate(names):
        _jpg(os.path.join(base, "undistorted_images", name), rng)
        _png16(os.path.join(base, "undistorted_depths",
                            name.replace(".JPG", ".png")), _depth_mm(rng))
        frames.append({"file_path": name,
                       "transform_matrix": _pose(i).tolist()})
    with open(os.path.join(_mk(os.path.join(base, "nerfstudio")),
                           "transforms_undistorted.json"), "w") as f:
        json.dump({"fl_x": 100.0, "fl_y": 101.0, "cx": 64.0, "cy": 48.0,
                   "frames": frames}, f)
    with open(os.path.join(base, "train_test_lists.json"), "w") as f:
        json.dump({"train": names[::-1], "test": []}, f)
    with open(os.path.join(_mk(os.path.join(root, "splits")),
                           "nvs_sem_train.txt"), "w") as f:
        f.write(scene + "\n")
    return root


def make_blendmvs_root(root, splits=("train",)):
    """The raw BlendedMVS layout: <scene>/{blended_images, cams (MVSNet
    cams and pair.txt), rendered_depth_maps (PFM)} and {split}_list.txt."""
    rng = np.random.default_rng(26)
    scene = "5a0271884e62597cdee0d0eb"
    base = os.path.join(root, scene)
    n = 6
    for i in range(n):
        name = f"{i:08d}"
        _jpg(os.path.join(base, "blended_images", name + ".jpg"), rng)
        cv2.imwrite(os.path.join(_mk(os.path.join(base, "rendered_depth_maps")),
                                 name + ".pfm"),
                    rng.uniform(1.0, 5.0, (96, 128)).astype(np.float32))
        w2c = np.linalg.inv(_pose(i))
        lines = (["extrinsic"] + [" ".join(f"{v:.6f}" for v in r) for r in w2c]
                 + ["", "intrinsic"]
                 + [" ".join(f"{v:.6f}" for v in r) for r in _K()]
                 + ["", "1.0 0.01"])
        with open(os.path.join(_mk(os.path.join(base, "cams")),
                               name + "_cam.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    pair = [str(n)]
    for i in range(n):
        others = [j for j in range(n) if j != i]
        pair += [str(i), f"{len(others)} " + " ".join(
            f"{j} {100 - abs(i - j)}" for j in others)]
    with open(os.path.join(base, "cams", "pair.txt"), "w") as f:
        f.write("\n".join(pair) + "\n")
    for split in splits:
        with open(os.path.join(root, f"{split}_list.txt"), "w") as f:
            f.write(scene + "\n")
    return root


def make_ase_root(root):
    """<scene>/{trajectory.csv, rgb/vignetteXXXXXXX.jpg,
    depth/depthXXXXXXX.png} at the ASE camera's 704x704."""
    rng = np.random.default_rng(27)
    scene = os.path.join(root, "scene0000")
    lines = ["header"]
    for i in range(3):
        _jpg(os.path.join(scene, "rgb", f"vignette{i:07d}.jpg"), rng, 704, 704)
        _png16(os.path.join(scene, "depth", f"depth{i:07d}.png"),
               rng.integers(800, 4000, (704, 704)))
        q = Rotation.from_euler("y", 0.1 * i).as_quat()
        lines.append(f"dev,{i},graph,{0.2 * i},0,0,{q[0]},{q[1]},{q[2]},"
                     f"{q[3]},x")
    with open(os.path.join(scene, "trajectory.csv"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return root


def make_wildrgbd_root(root):
    rng = np.random.default_rng(28)
    frames = list(range(40))
    with open(os.path.join(_mk(root), "selected_seqs_train.json"), "w") as f:
        json.dump({"cup": {"s1": frames}}, f)
    base = os.path.join(root, "cup", "s1")
    for i in frames:
        _jpg(os.path.join(base, "rgb", f"{i:05d}.jpg"), rng)
        _png16(os.path.join(base, "depth", f"{i:05d}.png"), _depth_mm(rng))
        mask = np.zeros((96, 128), np.uint8)
        mask[10:-10, 12:-12] = 255
        os.makedirs(os.path.join(base, "masks"), exist_ok=True)
        PIL.Image.fromarray(mask).save(os.path.join(base, "masks",
                                                    f"{i:05d}.png"))
        np.savez(os.path.join(_mk(os.path.join(base, "metadata")),
                              f"{i:05d}.npz"),
                 camera_pose=_pose(i), camera_intrinsics=_K())
    return root


def make_staticthings_root(root):
    rng = np.random.default_rng(29)
    pairs = np.array([(b"A/X", 1, b"l", 0, b"r", 1), (b"A/X", 1, b"r", 1,
                                                      b"l", 0)],
                     dtype=[("scene", "S8"), ("seq", "i4"), ("cam1", "S1"),
                            ("im1", "i4"), ("cam2", "S1"), ("im2", "i4")])
    np.save(os.path.join(_mk(root), "staticthings_pairs.npy"), pairs)
    for cam in ("left", "right"):
        base = os.path.join(root, "TRAIN", "A/X", "0001", cam)
        for i in range(2):
            _jpg(os.path.join(base, f"{i:04d}_clean.jpg"), rng)
            _jpg(os.path.join(base, f"{i:04d}_final.jpg"), rng)
            depth = rng.uniform(1.0, 300.0, (96, 128)).astype(np.float32)
            write_exr(os.path.join(base, f"{i:04d}.exr"), depth)
            np.savez(os.path.join(base, f"{i:04d}.npz"), intrinsics=_K(),
                     cam2world=_pose(i))
    return root


def make_waymo_root(root):
    rng = np.random.default_rng(30)
    scene = "segment-001"
    sdir = _mk(os.path.join(root, scene))
    frames = [f"cam1_{i:03d}" for i in range(4)]
    for i, name in enumerate(frames):
        _jpg(os.path.join(sdir, name + ".jpg"), rng)
        write_exr(os.path.join(sdir, name + ".exr"),
                  rng.uniform(2.0, 60.0, (96, 128)).astype(np.float32))
        np.savez(os.path.join(sdir, name + ".npz"), intrinsics=_K(),
                 cam2world=_pose(i))
    np.savez(os.path.join(root, "waymo_pairs.npz"), scenes=np.array([scene]),
             frames=np.array(frames), pairs=np.array([[0, 0, 1], [0, 1, 3]]))
    return root


# name -> (root builder, DSL string, sample indices)
EVAL_SPECS = {
    "DTU": (lambda r: make_dtu_root(pathlib.Path(r)),
            "DTU(split='test', ROOT='{root}', resolution=" + RES
            + ", num_seq=1, full_video=True, kf_every=2, seed=777)", [0]),
    "DTU_sampled": (lambda r: _write_dtu_pairs(make_dtu_root(
        pathlib.Path(r))),
        "DTU(split='test', ROOT='{root}', resolution=" + RES
        + ", num_seq=2, num_frames=2, seed=777)", [0, 1]),
    "SevenScenes": (lambda r: make_sevenscenes_root(
        pathlib.Path(r)),
        "SevenScenes(split='test', ROOT='{root}', resolution=" + RES
        + ", num_seq=2, num_frames=3, min_thresh=1, max_thresh=3, "
          "seed=777)", [0, 1]),
    "NRGBD": (lambda r: make_nrgbd_root(pathlib.Path(r)),
              "NRGBD(split='test', ROOT='{root}', resolution=" + RES
              + ", num_seq=1, full_video=True, kf_every=2, seed=777)", [0]),
    "Co3d": (make_co3d_root,
             "Co3d(split='test', ROOT='{root}', num_frames=3, lb=0, ub=10, "
             "scene_id='mix', mask_bg='rand', resolution=" + RES
             + ", seed=777)", [0, 5, 97]),
    "Co3d_full_video": (make_co3d_root,
                        "Co3d(split='test', ROOT='{root}', num_seq=1, "
                        "scene_id='mix', full_video=True, kf_every=7, "
                        "resolution=" + RES + ", seed=777)", [0]),
    "Scannet": (make_scannet_root,
                "Scannet(split='test', ROOT='{root}', num_seq=1, "
                "full_video=True, kf_every=1, resolution=" + RES
                + ", seed=777)", [0]),
    "Demo": (make_demo_root,
             "Demo(ROOT='{root}', resolution=" + RES + ", seed=777)", [0]),
    "ArkitScene": (make_arkit_raw_root,
                   "ArkitScene(split='train', ROOT='{root}', num_seq=1, "
                   "full_video=True, resolution=" + RES + ", seed=777)", [0]),
    "BlendMVS": (make_blendmvs_root,
                 "BlendMVS(split='train', num_frames=3, num_seq=2, "
                 "ROOT='{root}', resolution=" + RES + ", seed=777)", [0, 1]),
    "HabitatEval": (make_habitat_eval_root,
                    "HabitatEval(num_seq=2, num_frames=4, ROOT='{root}', "
                    "resolution=" + RES + ", seed=777)", [0, 1, 3]),
    "Scannetpp": (make_scannetpp_dslr_root,
                  "Scannetpp(split='train', num_seq=1, full_video=True, "
                  "kf_every=2, ROOT='{root}', resolution=" + RES
                  + ", seed=777)", [0]),
    "ASE_Multiview": (make_ase_root,
                      "ASE_Multiview(ROOT='{root}', split='train', "
                      "num_views=2, window_size=3, num_samples_per_window=1, "
                      "resolution=" + RES + ", seed=777)", [0]),
    "Co3dPairwise": (make_co3d_root,
                     "Co3dPairwise(split='train', ROOT='{root}', "
                     "mask_bg='rand', resolution=" + RES + ", seed=777)",
                     [50, 61]),
    "WildRGBD": (make_wildrgbd_root,
                 "WildRGBD(split='train', ROOT='{root}', resolution=" + RES
                 + ", seed=777)", [0, 7]),
    "StaticThings3D": (make_staticthings_root,
                       "StaticThings3D(ROOT='{root}', resolution=" + RES
                       + ", seed=777)", [0, 1]),
    "Waymo": (make_waymo_root,
              "Waymo(ROOT='{root}', resolution=" + RES + ", seed=777)",
              [0, 1]),
}


@pytest.mark.parametrize("name", sorted(EVAL_SPECS))
def test_eval_dataset_views_match_jax(name, tmp_path, jax_numpy_pts):
    make, spec, idxs = EVAL_SPECS[name]
    spec = spec.format(root=make(str(tmp_path / name)))
    port, ref = port_build(spec), jax_build(spec)
    assert type(port).__name__ == type(ref).__name__
    assert len(port) == len(ref) > 0
    for idx in idxs:
        views = port[(idx, 0)]
        assert len(views) > 0
        _assert_views_equal(views, ref[(idx, 0)])


def test_registry_matches_jax():
    import fast3r_torch.data.datasets  # noqa: F401

    assert sorted(PORT_REGISTRY) == sorted(JAX_REGISTRY)
    assert PORT_REGISTRY["BlendMVSEval"] is PORT_REGISTRY["BlendMVS"]


# ---------------------------------------------------------------------------
# (c) super_long_training's own dataset lists
# ---------------------------------------------------------------------------

def test_super_long_training_lists_build(tmp_path):
    """Each train and validation entry of the experiment, its ROOT on a
    synthetic root of its own layout, builds in the port with JAX's length
    (the sample counts cut to 2)."""
    from fast3r_torch.config import CONFIG_DIR, load_config

    tp = pathlib.Path(tmp_path)
    arkit = make_arkitscenes_root(str(tp / "arkit"))
    os.symlink(os.path.join(arkit, "Training"), os.path.join(arkit, "train"))
    habitat = make_habitat_root(str(tp / "habitat"))
    with open(os.path.join(habitat, "Habitat_100_scenes_val.txt"), "w") as f:
        f.write("sceneB/key\n")
    roots = {
        "Co3d_Multiview": make_co3d_root(str(tp / "co3d")),
        "ScanNetpp_Multiview": make_scannetpp_root(str(tp / "scannetpp")),
        "ARKitScenes_Multiview": arkit,
        "Habitat_Multiview": habitat,
        "BlendMVS": make_blendmvs_root(str(tp / "blendmvs"),
                                       ("train", "test")),
        "MegaDepth_Multiview": make_megadepth_root(str(tp / "megadepth")),
        "DTU": make_dtu_root(tp / "dtu"),
        "SevenScenes": make_sevenscenes_root(tp / "7scenes"),
        "NRGBD": make_nrgbd_root(tp / "nrgbd"),
    }
    data = load_config(os.path.join(CONFIG_DIR, "train.yaml"),
                       "super_long_training")["data"]
    entries = data["train_datasets"] + data["validation_datasets"]
    assert any("BlendMVS(" in e for e in data["train_datasets"])
    built = set()
    for entry in entries:
        call = entry.split(" @ ", 1)[-1]
        name = call.split("(", 1)[0]
        old = call.split("ROOT='", 1)[1].split("'", 1)[0]
        spec = call.replace(f"ROOT='{old}'", f"ROOT='{roots[name]}'")
        spec = f"2 @ {spec}" if " @ " in entry else spec
        port, ref = port_build(spec), jax_build(spec)
        assert len(port) == len(ref) > 0, spec
        built.add(name)
    assert built == set(roots)
