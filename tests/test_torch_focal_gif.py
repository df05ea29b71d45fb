"""The rest of serving in the port against fast3r_tpu, on the CPU: the
"individual" focal mode (a focal a view) and the orbit GIF.

* Focals: JAX's cv2 backend (``fast_pnp_cv2``) tries 100 focals from S / 2
  to 3 S (S = max(H, W)) a view with a RANSAC-PnP each and keeps the one
  with the most inliers.  The port's search (``ops.pnp.focal_sweep``) does
  the same with its own hypotheses, so the focals are compared, not the
  draws: on a seeded 384x512 scene of three views with three focals (1%
  depth noise, 5% confident outliers, 3% of the pixels confident), each
  focal the port picks is within two grid steps (a step is 6^(1/99), 1.8%)
  of the truth and of cv2's pick.  At the card's view width a grid step
  moves the image's border by 4.6 pixels against the 5-pixel inlier
  threshold; a narrower image cannot tell neighbouring focals apart.
  ``estimate_camera_poses`` then solves each view at its focal: the same
  focals and poses as the search and ``estimate_poses`` on the same
  generator, same-shape and mixed-shape.
* The orbit GIF: ``render_scene_frame`` and every frame of
  ``render_scene_gif``'s file equal JAX's bit for bit (both numpy and PIL).
"""

import json

import numpy as np
import PIL.Image
import pytest

import jax  # noqa: F401  (JAX on the CPU for the reference side)
import torch

from fast3r_torch.cli import reconstruct as t_cli
from fast3r_torch.eval import pose as t_pose
from fast3r_torch.ops import pnp as t_pnp
from fast3r_torch.serve import visualizer as t_vis

from fast3r_tpu.eval import pose as j_pose
from fast3r_tpu.serve import visualizer as j_vis

GRID_STEP = np.log(6.0) / 99

THREADS = 2  # torch threads: the suite runs several test processes on the
             # same cores


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, THREADS))
    yield
    torch.set_num_threads(n)


def focal_scene(focals, H, W, seed, noise=0.01, confident=1.0):
    """V cameras with their own focals (view 0 the identity) seeing depths
    of 2-4, the pointmaps in view 0's frame with ``noise`` relative depth
    noise and 5% confident outliers; ``confident`` of the pixels have
    conf > 1.  Returns pts (V, H, W, 3), conf (V, H, W), c2w (V, 4, 4)."""
    rng = np.random.default_rng(seed)
    V = len(focals)
    c2w = np.tile(np.eye(4), (V, 1, 1))
    for v in range(1, V):
        a = rng.normal(size=3)
        a *= rng.uniform(0.05, 0.25) / np.linalg.norm(a)
        K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        th = np.linalg.norm(a)
        c2w[v, :3, :3] = (np.eye(3) + np.sin(th) / th * K
                          + (1 - np.cos(th)) / th ** 2 * K @ K)
        c2w[v, :3, 3] = rng.normal(size=3) * 0.3
    ys, xs = np.mgrid[:H, :W].astype(np.float64)
    depth = rng.uniform(2.0, 4.0, (V, H, W))
    f = np.asarray(focals, np.float64)[:, None, None]
    cam = np.stack([depth * (xs - W / 2) / f, depth * (ys - H / 2) / f,
                    depth], -1)
    cam *= 1 + noise * rng.normal(size=(V, H, W, 1))
    pts = np.einsum("vij,vhwj->vhwi", c2w[:, :3, :3], cam) \
        + c2w[:, None, None, :3, 3]
    conf = rng.uniform(1.2, 3.0, (V, H, W))
    out = rng.random((V, H, W)) < 0.05
    pts[out] += rng.normal(0, 0.5, (int(out.sum()), 3))
    conf[rng.random((V, H, W)) >= confident] = 0.5
    return (pts.astype(np.float32), conf.astype(np.float32),
            c2w.astype(np.float32))


def _preds(pts, conf):
    return [{"pts3d_in_other_view": pts[None, v], "conf": conf[None, v]}
            for v in range(pts.shape[0])]


def test_individual_focals_match_cv2_search():
    seed, focals = 0, (300.0, 450.0, 800.0)
    pts, conf, _ = focal_scene(focals, 384, 512, seed, confident=0.03)
    got = t_pose.individual_focals(torch.from_numpy(pts),
                                   torch.from_numpy(conf), 32,
                                   torch.Generator().manual_seed(seed))
    _, cv2_f = j_pose.estimate_camera_poses(
        _preds(pts, conf), focal_length_estimation_method="individual",
        backend="cv2")
    steps_truth = np.log(got.numpy() / np.asarray(focals)) / GRID_STEP
    steps_cv2 = np.log(got.numpy() / np.asarray(cv2_f[0])) / GRID_STEP
    assert np.abs(steps_truth).max() <= 2.0 + 1e-3, steps_truth
    assert np.abs(steps_cv2).max() <= 2.0 + 1e-3, steps_cv2
    grid = t_pnp.focal_grid(384, 512, torch.float64)
    assert grid.shape == (100,) and grid[0] == 256 and grid[-1] == 1536
    assert all(torch.isclose(grid.float(), g).any() for g in got)


def test_individual_focal_poses_on_their_focals():
    """Same-shape views: the focals of the search on the seeded generator,
    then the poses of estimate_poses at them on the same generator; mixed
    shapes: a search and a solve a view.  A clean scene's rotations come
    back (at 48x64 a focal trades against the translation along the
    optical axis, as the module docstring says)."""
    pts, conf, gt = focal_scene((70.0, 90.0, 110.0), 48, 64, 3, noise=0.0)
    preds = _preds(pts, conf)
    poses, focals = t_pose.estimate_camera_poses(
        preds, focal_length_estimation_method="individual", device="cpu",
        seed=4)
    gen = torch.Generator().manual_seed(4)
    P, C = torch.from_numpy(pts), torch.from_numpy(conf)
    f = t_pose.individual_focals(P, C, 32, gen)
    c2w, _, _ = t_pose.estimate_poses(P, C, f, 32, gen)
    assert focals[0] == [float(x) for x in f]
    np.testing.assert_array_equal(np.stack(poses[0]), c2w.numpy())
    assert np.abs(np.stack(poses[0])[:, :3, :3] - gt[:, :3, :3]).max() < 2e-2

    preds[2] = {k: a[:, :40, :56] for k, a in preds[2].items()}
    poses, focals = t_pose.estimate_camera_poses(
        preds, focal_length_estimation_method="individual", device="cpu")
    assert len(focals[0]) == 3 and len(set(focals[0])) > 1
    assert np.isfinite(np.stack(poses[0])).all()


# ---------------------------------------------------------------------------
# the orbit GIF
# ---------------------------------------------------------------------------

def _scene(seed, n=4000):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)) * [1.0, 0.5, 0.8] + [0.2, -0.1, 3.0]
    return {"points": pts.astype(np.float32),
            "colors": rng.random((n, 3)).astype(np.float32)}


def test_render_scene_frame_matches_jax():
    scene = _scene(0)
    for eye, target in (((0.0, 0.0, -2.0), (0.0, 0.0, 3.0)),
                        ((3.0, -1.0, 0.5), (0.2, -0.1, 3.0))):
        eye, target = np.asarray(eye), np.asarray(target)
        got = t_vis.render_scene_frame(scene, eye, target, hw=(60, 80),
                                       focal=70.0)
        want = j_vis.render_scene_frame(scene, eye, target, hw=(60, 80),
                                        focal=70.0)
        assert got.dtype == np.uint8 and got.shape == (60, 80, 3)
        np.testing.assert_array_equal(got, want)
        assert (got != 255).any()
    empty = {"points": np.zeros((0, 3)), "colors": np.zeros((0, 3))}
    np.testing.assert_array_equal(
        t_vis.render_scene_frame(empty, eye, target, hw=(8, 8)),
        j_vis.render_scene_frame(empty, eye, target, hw=(8, 8)))


def _frames(path):
    with PIL.Image.open(path) as im:
        out = []
        for i in range(im.n_frames):
            im.seek(i)
            out.append(np.asarray(im.convert("RGB")))
        return out, im.info.get("duration"), im.info.get("loop")


def test_render_scene_gif_matches_jax(tmp_path):
    scene = _scene(1)
    t_vis.render_scene_gif(scene, str(tmp_path / "t.gif"), n_frames=6,
                           hw=(48, 64), fps=5)
    j_vis.render_scene_gif(scene, str(tmp_path / "j.gif"), n_frames=6,
                           hw=(48, 64), fps=5)
    got, dur, loop = _frames(tmp_path / "t.gif")
    want, jdur, jloop = _frames(tmp_path / "j.gif")
    assert len(got) == len(want) == 6 and (dur, loop) == (jdur, jloop)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert (tmp_path / "t.gif").read_bytes() == (tmp_path / "j.gif").read_bytes()


def test_reconstruct_cli_writes_the_gif(tmp_path):
    """``--gif``: orbit.gif beside scene.ply, 24 frames, its own stage."""
    rng = np.random.default_rng(6)
    folder = tmp_path / "imgs"
    folder.mkdir()
    for i in range(2):
        PIL.Image.fromarray(rng.integers(0, 256, (48, 64, 3),
                                         dtype=np.uint8)).save(
            folder / f"{i}.png")
    out = tmp_path / "out"
    res = t_cli.main([str(folder), "--out", str(out), "--device", "cpu",
                      "--size", "64", "--gif"])
    frames, _, _ = _frames(out / "orbit.gif")
    assert len(frames) == 24 and frames[0].shape == (480, 640, 3)
    assert (out / "scene.ply").exists() and "gif_s" in res["times"]
    assert len(json.loads((out / "poses.json").read_text())["focals"]) == 2
