"""The port's data pipeline (fast3r_torch.data) against fast3r_tpu's on the
CPU, on synthetic roots in each dataset's own on-disk format.

* File reads: the port reads with PIL (and its own EXR codec) where JAX reads
  with cv2; JPEG colour, 16-bit PNG depth, 8-bit PNG masks, RGB PNG and EXR
  give equal arrays.
* The nearest-neighbour depth rescale equals ``cv2.resize(INTER_NEAREST)``
  exactly, up and down.
* The seven ported datasets: the same DSL string and seed give views whose
  img, depthmap, camera_intrinsics, camera_pose, pts3d, valid_mask,
  true_shape, idx, rng and metadata equal JAX's exactly.  JAX back-projects
  through its C++ extension when that is built, in float32 arithmetic where
  the port (and JAX's own numpy fallback) computes the pixel offsets in
  float64: those tests route JAX through its numpy fallback, and
  ``test_pts3d_against_jax_native`` holds the port to the C++ path within
  2e-6 relative to the largest coordinate (float32 rounding of
  three-term sums).
* Samplers, loaders (inline and with 2 ``spawn`` workers, two epochs), the
  shared-memory transport, the workers' SIGUSR1 immunity and the data
  module.
"""

import json
import os
import pickle
import signal
import subprocess
import sys

import cv2
import numpy as np
import PIL.Image
import pytest

import fast3r_tpu.native
from fast3r_tpu.data import base as jbase
from fast3r_tpu.data import cropping as jcrop
from fast3r_tpu.data import io as jio
from fast3r_tpu.data import loader as jloader
from fast3r_tpu.data.dsl import build_dataset as jax_build
from fast3r_tpu.data.exr import write_exr

from fast3r_torch.data import base as tbase
from fast3r_torch.data import cropping as tcrop
from fast3r_torch.data import io as tio
from fast3r_torch.data import loader as tloader
from fast3r_torch.data.datamodule import MultiViewDataModule
from fast3r_torch.data.dsl import build_dataset as port_build
from fast3r_torch.data.dsl import validate_dataset_spec

from torch_threads import few_torch_threads  # noqa: F401 (autouse)

H, W = 96, 128          # landscape source frames
RES = "[(64, 48), (64, 32)]"
PTS_REL = 2e-6          # JAX's C++ back-projection (float32) vs numpy


@pytest.fixture
def jax_numpy_pts(monkeypatch):
    """JAX's loader back-projects through its numpy fallback."""
    monkeypatch.setattr(
        fast3r_tpu.native, "pointmap_from_depth_native",
        lambda d, K, pose=None: jbase.depthmap_to_absolute_camera_coordinates_np(
            np.ascontiguousarray(d, np.float32),
            np.ascontiguousarray(K, np.float32), pose))


# ---------------------------------------------------------------------------
# synthetic roots
# ---------------------------------------------------------------------------

def _K(w=W, h=H, f=100.0):
    return np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)


def _pose(i):
    a = 0.2 * i
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    T[:3, 3] = [0.1 * i, 0.05 * i, -0.02 * i]
    return T


def _jpg(path, rng, w=W, h=H):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    small = rng.integers(0, 255, (h // 8, w // 8, 3), dtype=np.uint8)
    img = np.asarray(PIL.Image.fromarray(small).resize((w, h),
                                                       PIL.Image.BICUBIC))
    noise = rng.integers(-20, 21, img.shape)
    PIL.Image.fromarray(np.clip(img + noise, 0, 255).astype(np.uint8)).save(
        path, quality=90)


def _png16(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    PIL.Image.fromarray(arr.astype(np.uint16)).save(path)


def _depth_mm(rng, w=W, h=H):
    d = rng.integers(500, 5000, (h, w)).astype(np.uint16)
    d[rng.random((h, w)) < 0.05] = 0
    return d


def make_scannetpp_root(root):
    rng = np.random.default_rng(11)
    names = [f"frame_{i:05d}" for i in range(8)] + [f"DSC{i:05d}"
                                                    for i in range(6)]
    n = len(names)
    np.savez(os.path.join(_mk(root), "all_metadata.npz"),
             scenes=np.array(["scene_a"]), sceneids=np.zeros(n, np.int64),
             images=np.array(names), intrinsics=np.stack([_K()] * n),
             trajectories=np.stack([_pose(i) for i in range(n)]))
    for name in names:
        _jpg(os.path.join(root, "scene_a", "images", name + ".jpg"), rng)
        _png16(os.path.join(root, "scene_a", "depth", name + ".png"),
               _depth_mm(rng))
    return root


def make_arkitscenes_root(root):
    rng = np.random.default_rng(12)
    split = os.path.join(root, "Training")
    scenes = ["40753679", "40753686"]
    names, sids = [], []
    for s, scene in enumerate(scenes):
        for i in range(6):
            names.append(f"{scene}_{i:07d}.png")
            sids.append(s)
    n = len(names)
    np.savez(os.path.join(_mk(split), "all_metadata.npz"),
             scenes=np.array(scenes), sceneids=np.array(sids, np.int64),
             images=np.array(names), intrinsics=np.stack([_K()] * n),
             trajectories=np.stack([_pose(i) for i in range(n)]))
    for name, s in zip(names, sids):
        sdir = os.path.join(split, scenes[s])
        _jpg(os.path.join(sdir, "vga_wide", name.replace(".png", ".jpg")), rng)
        _png16(os.path.join(sdir, "lowres_depth", name), _depth_mm(rng))
    return root


def make_co3d_root(root):
    """Two sequences: "land" of 30 landscape frames listed as 40 (10 missing
    on disk: the invalid-frame path) and "mix" alternating landscape and
    portrait frames; masks blank out a border."""
    rng = np.random.default_rng(13)
    seqs = {"land": list(range(1, 41)), "mix": list(range(1, 31))}
    for split in ("train", "test"):
        with open(os.path.join(_mk(root), f"selected_seqs_{split}.json"),
                  "w") as f:
            json.dump({"teddybear": seqs}, f)
    for seq, frames in seqs.items():
        for i in frames[:30]:
            w, h = (H, W) if seq == "mix" and i % 2 else (W, H)
            base = os.path.join(root, "teddybear", seq)
            _jpg(os.path.join(base, "images", f"frame{i:06d}.jpg"), rng, w, h)
            np.savez(os.path.join(base, "images", f"frame{i:06d}.npz"),
                     camera_pose=_pose(i), camera_intrinsics=_K(w, h),
                     maximum_depth=np.float32(10.0))
            _png16(os.path.join(base, "depths", f"frame{i:06d}.jpg.geometric.png"),
                   rng.integers(1000, 60000, (h, w)))
            mask = np.zeros((h, w), np.uint8)
            mask[h // 8:-h // 8, w // 8:-w // 8] = 255
            os.makedirs(os.path.join(base, "masks"), exist_ok=True)
            PIL.Image.fromarray(mask).save(
                os.path.join(base, "masks", f"frame{i:06d}.png"))
    return root


def make_megadepth_root(root):
    rng = np.random.default_rng(14)
    names = [f"im{i:04d}" for i in range(7)]
    np.savez(os.path.join(_mk(root), "all_metadata_for_multiview.npz"),
             scenes=np.array(["0001/dense0"]),
             sceneids=np.zeros(len(names), np.int64), images=np.array(names))
    sdir = os.path.join(root, "0001", "dense0")
    for i, name in enumerate(names):
        _jpg(os.path.join(sdir, name + ".jpg"), rng)
        depth = rng.uniform(2.0, 6.0, (H, W)).astype(np.float32)
        depth[rng.random((H, W)) < 0.1] = 0
        write_exr(os.path.join(sdir, name + ".exr"), depth)
        np.savez(os.path.join(sdir, name + ".npz"), intrinsics=_K(),
                 cam2world=_pose(i))
    return root


def make_habitat_root(root):
    rng = np.random.default_rng(15)
    for scene in ("sceneA", "sceneB"):
        sdir = _mk(os.path.join(root, scene))
        for i in range(1, 6):
            _jpg(os.path.join(sdir, f"key_{i}.jpeg"), rng)
            write_exr(os.path.join(sdir, f"key_{i}_depth.exr"),
                      rng.uniform(1.0, 4.0, (H, W)).astype(np.float16))
            pose = _pose(i)
            with open(os.path.join(sdir, f"key_{i}_camera_params.json"),
                      "w") as f:
                json.dump({"camera_intrinsics": _K().tolist(),
                           "R_cam2world": pose[:3, :3].tolist(),
                           "t_cam2world": pose[:3, 3].tolist()}, f)
    with open(os.path.join(root, "Habitat_1000_scenes_train.txt"), "w") as f:
        f.write("sceneA/key\nsceneB/key\n")
    return root


def make_blendedmvs_root(root):
    rng = np.random.default_rng(16)
    rows = []
    for seqh, seql in [(0x5A, 1), (0x5B, 3), (0x5C, 10)]:
        sdir = _mk(os.path.join(root, f"{seqh:08x}{seql:016x}"))
        for i in range(6):
            name = f"{i:08d}"
            _jpg(os.path.join(sdir, name + ".jpg"), rng)
            write_exr(os.path.join(sdir, name + ".exr"),
                      rng.uniform(1.0, 8.0, (H, W)).astype(np.float32))
            pose = _pose(i)
            np.savez(os.path.join(sdir, name + ".npz"), intrinsics=_K(),
                     R_cam2world=pose[:3, :3], t_cam2world=pose[:3, 3])
        for a in range(5):
            rows.append((seqh, seql, a, a + 1, 0.5))
    pairs = np.array(rows, dtype=[("seq_high", "u4"), ("seq_low", "u8"),
                                  ("img1", "u2"), ("img2", "u2"),
                                  ("score", "f4")])
    np.save(os.path.join(root, "blendedmvs_pairs.npy"), pairs)
    return root


def _mk(d):
    os.makedirs(d, exist_ok=True)
    return d


SPECS = {
    "DummyMultiview": (None, "DummyMultiview(num_scenes=5, num_views=3, "
                             "source_size=(128, 96), resolution=" + RES
                       + ", aug_crop=8, transform=ColorJitter, seed=777)"),
    "ScanNetpp_Multiview": (make_scannetpp_root, "ScanNetpp_Multiview("
                            "split='train', num_views=3, window_size=6, "
                            "num_samples_per_window=2, ROOT='{root}', "
                            "aug_crop=16, resolution=" + RES
                            + ", transform=ColorJitter, seed=777)"),
    "ARKitScenes_Multiview": (make_arkitscenes_root, "ARKitScenes_Multiview("
                              "split='Training', num_views=3, window_size=6, "
                              "num_samples_per_window=2, ROOT='{root}', "
                              "aug_crop=16, resolution=" + RES
                              + ", transform=ColorJitter, seed=777)"),
    "Co3d_Multiview": (make_co3d_root, "Co3d_Multiview(split='train', "
                       "num_views=4, window_degree_range=360, "
                       "num_samples_per_window=2, ROOT='{root}', aug_crop=16, "
                       "mask_bg='rand', resolution=" + RES
                       + ", transform=ColorJitter, seed=777)"),
    "MegaDepth_Multiview": (make_megadepth_root, "MegaDepth_Multiview("
                            "split='train', num_views=3, window_size=6, "
                            "num_samples_per_window=2, ROOT='{root}', "
                            "aug_crop=16, resolution=" + RES
                            + ", transform=ColorJitter, seed=777)"),
    "Habitat_Multiview": (make_habitat_root, "Habitat_Multiview(1000, "
                          "split='train', num_views=3, ROOT='{root}', "
                          "aug_crop=16, resolution=" + RES
                          + ", transform=ColorJitter, seed=777)"),
    "BlendedMVS_Multiview": (make_blendedmvs_root, "BlendedMVS_Multiview("
                             "split='train', num_views=3, window_size=6, "
                             "num_samples_per_window=2, ROOT='{root}', "
                             "resolution=" + RES + ", seed=777)"),
}


def _spec(name, tmp_path):
    make, spec = SPECS[name]
    if make is None:
        return spec
    return spec.format(root=make(str(tmp_path / name)))


def _assert_views_equal(port, ref, pts_rel=0.0):
    assert len(port) == len(ref)
    for pv, rv in zip(port, ref):
        assert set(pv) == set(rv)
        for k, rval in rv.items():
            pval = pv[k]
            if k == "pts3d" and pts_rel:
                tol = pts_rel * max(1.0, float(np.abs(rval).max()))
                np.testing.assert_allclose(pval, rval, rtol=0, atol=tol)
            elif isinstance(rval, np.ndarray):
                assert pval.dtype == rval.dtype, k
                np.testing.assert_array_equal(pval, rval, err_msg=k)
            else:
                assert pval == rval, (k, pval, rval)


# ---------------------------------------------------------------------------
# file reads and the depth rescale
# ---------------------------------------------------------------------------

def test_imread_matches_cv2(tmp_path):
    rng = np.random.default_rng(0)
    _jpg(str(tmp_path / "c.jpg"), rng)
    _png16(str(tmp_path / "d.png"), rng.integers(0, 65536, (H, W)))
    cv2.imwrite(str(tmp_path / "d_cv2.png"),
                rng.integers(0, 65536, (H, W)).astype(np.uint16))
    PIL.Image.fromarray(rng.integers(0, 256, (H, W), dtype=np.uint8)).save(
        str(tmp_path / "m.png"))
    PIL.Image.fromarray(rng.integers(0, 256, (H, W, 3), dtype=np.uint8)).save(
        str(tmp_path / "rgb.png"))
    write_exr(str(tmp_path / "f.exr"), rng.random((H, W)).astype(np.float32))
    write_exr(str(tmp_path / "h.exr"), rng.random((H, W)).astype(np.float16))
    cases = [("c.jpg", "COLOR"), ("rgb.png", "COLOR"), ("d.png", "UNCHANGED"),
             ("d_cv2.png", "UNCHANGED"), ("m.png", "UNCHANGED"),
             ("rgb.png", "UNCHANGED"), ("f.exr", "UNCHANGED"),
             ("h.exr", "COLOR")]
    for name, flag in cases:
        path = str(tmp_path / name)
        ref = jio.imread_cv2(path, getattr(cv2, "IMREAD_" + flag))
        got = tio.imread_cv2(path, getattr(tio, "IMREAD_" + flag))
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        np.testing.assert_array_equal(got, ref, err_msg=f"{name} {flag}")
    with pytest.raises(IOError):
        tio.imread_cv2(str(tmp_path / "missing.jpg"))


@pytest.mark.parametrize("src,dst", [
    ((480, 640), (388, 517)), ((480, 640), (525, 700)), ((480, 640), (300, 400)),
    ((640, 480), (683, 512)), ((96, 128), (48, 64)), ((96, 128), (97, 131)),
    ((37, 53), (111, 9)), ((384, 512), (384, 512)), ((1008, 1152), (397, 453)),
])
def test_resize_nearest_matches_cv2(src, dst):
    a = np.random.default_rng(1).random(src).astype(np.float32)
    want = cv2.resize(a, dst[::-1], interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(tcrop.resize_nearest(a, dst[::-1]), want)


def test_rescale_image_depthmap_matches_jax():
    rng = np.random.default_rng(2)
    img = PIL.Image.fromarray(rng.integers(0, 255, (480, 640, 3), np.uint8))
    depth = rng.random((480, 640)).astype(np.float32)
    K = _K(640, 480, 500.0)
    for out in [(517, 388), (700, 525), (400, 300), (256, 160)]:
        for force in (True, False):
            ri, rd, rK = jcrop.rescale_image_depthmap(img, depth, K, out, force)
            pi, pd, pK = tcrop.rescale_image_depthmap(img, depth, K, out, force)
            np.testing.assert_array_equal(np.asarray(pi), np.asarray(ri))
            np.testing.assert_array_equal(pd, rd)
            np.testing.assert_array_equal(pK, rK)


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SPECS))
def test_dataset_views_match_jax(name, tmp_path, jax_numpy_pts):
    spec = _spec(name, tmp_path)
    port, ref = port_build(spec), jax_build(spec)
    assert type(port).__name__ == type(ref).__name__ == name
    assert len(port) == len(ref) > 0
    n = len(ref)
    for idx in sorted({(0, 0), (1 % n, 1), (n // 2, 0), (n - 1, 1)}):
        _assert_views_equal(port[idx], ref[idx])


def test_co3d_portrait_views_transposed(tmp_path, jax_numpy_pts):
    """The "mix" sequence's portrait frames are cropped portrait and stored
    landscape, as JAX stores them; both sequences are drawn."""
    spec = _spec("Co3d_Multiview", tmp_path)
    port, ref = port_build(spec), jax_build(spec)
    portrait, labels = 0, set()
    for i in range(6):
        views = port[(i, 0)]
        _assert_views_equal(views, ref[(i, 0)])
        labels |= {v["label"] for v in views}
        for v in views:
            assert v["img"].shape == (48, 64, 3)
            portrait += int(v["true_shape"][0] > v["true_shape"][1])
    assert portrait > 0 and labels == {"teddybear/land", "teddybear/mix"}


def test_pts3d_against_jax_native(tmp_path):
    """JAX's C++ back-projection, where built, against the port's numpy."""
    if not fast3r_tpu.native.native_available():
        pytest.skip("fast3r_tpu's native library is not built here")
    spec = _spec("Co3d_Multiview", tmp_path)
    _assert_views_equal(port_build(spec)[(2, 1)], jax_build(spec)[(2, 1)],
                        pts_rel=PTS_REL)


def test_unported_dataset_names_raise(tmp_path):
    """The eval sets build on fixture roots (DTU, BlendMVS); an unknown
    name raises."""
    from test_real_datasets import make_dtu_root
    from test_torch_eval_data import make_blendmvs_root

    dtu = make_dtu_root(tmp_path / "dtu")
    ds = port_build(f"DTU(split='test', ROOT='{dtu}', resolution=(64, 48), "
                    "num_seq=1, full_video=True, kf_every=2, seed=777)")
    assert type(ds).__name__ == "DTU" and len(ds[(0, 0)]) == 2
    root = make_blendmvs_root(str(tmp_path / "blendmvs"))
    spec = (f"10 @ BlendMVS(split='train', num_frames=3, ROOT='{root}', "
            "resolution=(512, 384))")
    validate_dataset_spec(spec)
    assert len(port_build(spec)) == 10
    with pytest.raises(KeyError, match="unknown dataset 'Nope'"):
        port_build("Nope(resolution=64)")
    with pytest.raises(ValueError):
        port_build("DummyMultiview(num_scenes=__import__('os').getpid())")


def test_dataset_algebra_matches_jax(jax_numpy_pts):
    spec = ("3 @ DummyMultiview(num_scenes=4, num_views=2, resolution="
            + RES + ", seed=5) + 2 * DummyMultiview(num_scenes=2, "
            "num_views=2, resolution=" + RES + ", seed=9)")
    port, ref = port_build(spec), jax_build(spec)
    assert repr(port) == repr(ref) and len(port) == len(ref) == 7
    for epoch in (0, 1):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        for i in range(len(ref)):
            _assert_views_equal(port[(i, i % 2)], ref[(i, i % 2)])


# ---------------------------------------------------------------------------
# samplers, loaders, transport
# ---------------------------------------------------------------------------

class _Sized:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


@pytest.mark.parametrize("world_size", [1, 2, 3])
def test_samplers_match_jax(world_size):
    ds = _Sized(24)
    for rank in range(world_size):
        port = tbase.BatchedRandomSampler(ds, 4, 3, world_size, rank)
        ref = jbase.BatchedRandomSampler(ds, 4, 3, world_size, rank)
        for epoch in (0, 1):
            port.set_epoch(epoch)
            ref.set_epoch(epoch)
            got = list(port)
            assert got == list(ref)
            assert len(got) == len(port) == 24 // world_size
            for b in range(0, len(got), 4):  # one aspect ratio a batch
                assert len({ar for _, ar in got[b:b + 4]}) == 1
        seq = tbase.SequentialBatchedSampler(ds, 4, 3, world_size, rank)
        assert list(seq) == list(jbase.SequentialBatchedSampler(
            ds, 4, 3, world_size, rank))
    port = [tbase.BatchedRandomSampler(ds, 4, 3, world_size, r)
            for r in range(world_size)]
    for s in port:
        s.set_epoch(3)
    idx = [i for s in port for i, _ in s]
    assert sorted(idx) == list(range(24))  # the ranks split the epoch


LOADER_SPEC = ("10 @ DummyMultiview(num_scenes=7, num_views=2, "
               "source_size=(128, 96), resolution=" + RES
               + ", transform=ColorJitter, seed=3)")


def _epochs(loader, n=2):
    out = []
    for epoch in range(n):
        loader.set_epoch(epoch)
        out.append(list(loader))
    return out


def _assert_batches_equal(port, ref, pts_rel=0.0):
    assert len(port) == len(ref)
    for pb, rb in zip(port, ref):
        assert set(pb) == set(rb)
        for k, rv in rb.items():
            if k == "pts3d" and pts_rel:
                np.testing.assert_allclose(
                    pb[k], rv, rtol=0,
                    atol=pts_rel * max(1.0, float(np.abs(rv).max())))
            elif isinstance(rv, np.ndarray):
                np.testing.assert_array_equal(pb[k], rv, err_msg=k)
            else:
                assert pb[k] == rv, k


def test_loader_inline_matches_jax(jax_numpy_pts):
    port = _epochs(tloader.get_data_loader(LOADER_SPEC, 2, num_workers=0))
    ref = _epochs(jloader.get_data_loader(LOADER_SPEC, 2, num_workers=0))
    for p, r in zip(port, ref):
        assert len(p) == 5
        _assert_batches_equal(p, r)
        assert p[0]["imgs"].shape[:2] == (2, 2)
    assert not np.array_equal(port[0][0]["imgs"], port[1][0]["imgs"])


def test_loader_spawn_workers_match_jax(jax_numpy_pts):
    """Two spawn workers each side, two epochs, the shared-memory transport:
    the port's batches equal its inline loader's, and JAX's (whose workers
    back-project through its C++ library where built).  ``start`` spawns
    the port's workers ahead of the first batch.  A worker sent SIGUSR1
    keeps serving; ``close`` leaves none of the loader's blocks."""
    inline = _epochs(tloader.get_data_loader(LOADER_SPEC, 2, num_workers=0))
    pl = tloader.get_data_loader(LOADER_SPEC, 2, num_workers=2)
    jl = jloader.get_data_loader(LOADER_SPEC, 2, num_workers=2)
    try:
        pl.start()
        assert len(pl._pool._processes) == 2
        port = _epochs(pl)
        ref = _epochs(jl)
        for p, i, r in zip(port, inline, ref):
            _assert_batches_equal(p, i)
            _assert_batches_equal(p, r, pts_rel=PTS_REL)
        for pid in list(pl._pool._processes):
            os.kill(pid, signal.SIGUSR1)
        again = _epochs(pl, 1)[0]
        _assert_batches_equal(again, inline[0])
    finally:
        pl.close()
        jl.close()
    assert not [n for n in os.listdir("/dev/shm")
                if n.startswith(pl._shm_prefix)]


def test_shm_sweep_spares_other_checkouts():
    """The stale-block sweep unlinks a dead owner's block only under this
    checkout's tag: /dev/shm is shared with other checkouts (another
    temporary directory or PID namespace), whose pids it cannot check."""
    dead = subprocess.Popen([sys.executable, "-c", "pass"])
    dead.wait()
    ours = f"{tloader._shm_tag()}{dead.pid}_0_1_0"
    other = f"f3r{'0' * 10}_{dead.pid}_0_1_0"
    paths = [os.path.join("/dev/shm", n) for n in (ours, other)]
    try:
        for path in paths:
            with open(path, "wb") as f:
                f.write(b"\0" * 16)
        assert tloader._sweep_stale_shm() >= 1
        assert not os.path.exists(paths[0]) and os.path.exists(paths[1])
    finally:
        for path in paths:
            if os.path.exists(path):
                os.unlink(path)


def test_shm_transport_equals_pickling(jax_numpy_pts):
    ds = port_build(LOADER_SPEC)
    ds.set_epoch(0)
    views = [ds[(i, 1)] for i in range(3)]
    via_pickle = pickle.loads(pickle.dumps(views))
    via_shm = tloader._shm_unpack(tloader._shm_pack(views, "f3rtest"))
    for a, b in zip(via_shm, via_pickle):
        _assert_views_equal(a, b)
    assert tloader.collate_views(via_shm).keys() == jloader.collate_views(
        via_pickle).keys()


def test_datamodule_matches_jax():
    from fast3r_tpu.data.datamodule import MultiViewDataModule as JaxDM

    val = ["4 @ DummyMultiview(num_scenes=4, num_views=2, resolution=[(64, 48)],"
           " seed=777)"]
    port = MultiViewDataModule([LOADER_SPEC], val, batch_size_per_device=2,
                               num_workers=0)
    ref = JaxDM([LOADER_SPEC], val, batch_size_per_device=2, num_workers=0)
    assert (port.world_size, port.rank) == (1, 0)
    tl_, rl = port.train_dataloader(), ref.train_dataloader()
    assert len(tl_) == len(rl) == 5
    pv, rv = port.val_dataloaders(), ref.val_dataloaders()
    assert list(pv) == list(rv) == ["dataset_0"]
    _assert_batches_equal(list(pv["dataset_0"]), list(rv["dataset_0"]),
                          pts_rel=PTS_REL)
    assert MultiViewDataModule(world_size=4, rank=3).rank == 3
