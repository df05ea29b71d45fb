"""The port's alignment, focal and pose recovery, scene export and
reconstruction CLI (fast3r_torch) against fast3r_tpu on the CPU.

Scenes are the JAX pose tests' seeded synthetic ones.  The port cannot
reproduce JAX's threefry draws, so the RANSAC tests hand JAX's minimal
samples (``jax.random.categorical`` over keys from ``jax.random.split``,
as ``pnp_ransac_jax`` and ``estimate_poses_jax`` draw them) to the port's
``sample_idx``.  Both sides compute in fp32; tolerances are stated per test.
"""

import json

import numpy as np
import PIL.Image
import pytest

import jax
import jax.numpy as jnp
import torch

from fast3r_torch.cli import reconstruct as t_cli
from fast3r_torch.eval import pose as t_pose
from fast3r_torch.eval import recon as t_recon
from fast3r_torch.ops import pnp as t_pnp
from fast3r_torch.ops import umeyama as t_ume
from fast3r_torch.ops.geometry import xy_grid
from fast3r_torch.serve import ply as t_ply
from fast3r_torch.serve import visualizer as t_vis

from fast3r_tpu.eval import pose as j_pose
from fast3r_tpu.eval import recon as j_recon
from fast3r_tpu.ops import pnp as j_pnp
from fast3r_tpu.ops import umeyama as j_ume
from fast3r_tpu.serve import ply as j_ply
from fast3r_tpu.serve import visualizer as j_vis

from test_pose import randomized_scene, synthetic_scene
from torch_threads import few_torch_threads  # noqa: F401 (autouse)


def _jax_draws(keys, masks, iters=32, sample_size=8):
    """(V, iters, sample_size): pnp_ransac_jax's minimal samples of each
    view from its key."""
    draw = jax.jit(jax.vmap(
        lambda k, logits: jax.random.categorical(k, logits,
                                                 shape=(sample_size,)),
        in_axes=(0, None)))
    return np.stack([np.asarray(draw(jax.random.split(key, iters),
                                     jnp.where(jnp.asarray(mask), 0.0, -1e9)))
                     for key, mask in zip(keys, masks)])


def _preds(pts, conf):
    return [{"pts3d_in_other_view": pts[None, v], "conf": conf[None, v]}
            for v in range(pts.shape[0])]


# ---------------------------------------------------------------------------
# alignment
# ---------------------------------------------------------------------------

def test_umeyama_matches_jax():
    """A batch of weighted similarity solves (zero weights included) against
    JAX's one by one, fp32, 1e-5."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 50, 3)).astype(np.float32)
    y = (1.7 * x[..., ::-1] + rng.standard_normal((3, 1, 3))
         + 0.01 * rng.standard_normal(x.shape)).astype(np.float32)
    w = (rng.random((3, 50)) > 0.3).astype(np.float32)
    R, t, s = t_ume.rigid_points_registration(*map(torch.from_numpy, (x, y, w)))
    for b in range(3):
        ref = j_ume.rigid_points_registration(*map(jnp.asarray,
                                                   (x[b], y[b], w[b])))
        for got, want in zip((R[b], t[b], s[b]), ref):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)
    ref = j_ume.apply_similarity(jnp.asarray(x[0]), *(jnp.asarray(
        a[0].numpy()) for a in (R, t, s)))
    np.testing.assert_allclose(t_ume.apply_similarity(
        torch.from_numpy(x), R, t, s)[0].numpy(), np.asarray(ref),
        rtol=1e-5, atol=1e-5)


def test_align_local_to_global_matches_jax():
    """Views of two pixel-grid shapes, B = 2, a confidence percentile and a
    view whose valid mask keeps fewer than three points (the identity
    fallback): against JAX's aligned maps, fp32, 1e-5."""
    rng = np.random.default_rng(1)
    preds, views = [], []
    for v, (H, W) in enumerate([(8, 12), (8, 12), (12, 8)]):
        loc = rng.standard_normal((2, H, W, 3)).astype(np.float32)
        preds.append({
            "pts3d_local": loc,
            "pts3d_in_other_view": (0.5 * loc[..., ::-1] + 0.3
                                    + 0.01 * rng.standard_normal(loc.shape)
                                    ).astype(np.float32),
            "conf": rng.uniform(1, 3, (2, H, W)).astype(np.float32),
            "conf_local": rng.uniform(1, 3, (2, H, W)).astype(np.float32)})
        valid = np.ones((2, H, W), bool)
        if v == 1:
            valid[1] = False
            valid[1, 0, :2] = True
        views.append({"valid_mask": valid})
    ref = [dict(p) for p in preds]
    j_recon.align_local_pts3d_to_global(ref[:2], views[:2], 40.0)
    j_recon.align_local_pts3d_to_global(ref[2:], views[2:], 40.0)
    t_recon.align_local_pts3d_to_global(preds, views, 40.0, device="cpu")
    for p, r in zip(preds, ref):
        np.testing.assert_allclose(
            p["pts3d_local_aligned_to_global"].numpy(),
            np.asarray(r["pts3d_local_aligned_to_global"]), rtol=1e-5,
            atol=1e-5)


# ---------------------------------------------------------------------------
# focal and pose
# ---------------------------------------------------------------------------

def test_weiszfeld_matches_jax():
    """fp32, rtol 1e-4 (100 IRLS steps over sums in another order)."""
    pts, conf, _ = randomized_scene(seed=7)
    for v in range(2):
        ref = float(j_pnp.estimate_focal_weiszfeld(jnp.asarray(pts[v]),
                                                   jnp.asarray(conf[v])))
        got = float(t_pnp.estimate_focal_weiszfeld(torch.from_numpy(pts[v]),
                                                   torch.from_numpy(conf[v])))
        assert abs(got - ref) <= 1e-4 * abs(ref), (got, ref)


def test_pnp_ransac_matches_jax_with_its_draws():
    """A noisy scene with high-confidence gross outliers, all views in one
    batched call, JAX's minimal samples fed in: c2w within 1e-4."""
    seed = 1000
    pts, conf, _ = randomized_scene(seed=seed)
    V, H, W, _ = pts.shape
    pix = np.asarray(xy_grid(W, H).reshape(-1, 2))
    pp = np.float32([W / 2, H / 2])
    focal = 60.0
    masks = conf.reshape(V, -1) > 1.0
    keys = jax.random.split(jax.random.key(seed), V)
    pnp = jax.jit(j_pnp.pnp_ransac_jax)
    ref = np.stack([np.asarray(pnp(
        jnp.asarray(pts[v].reshape(-1, 3)), jnp.asarray(pix),
        jnp.asarray(masks[v]), jnp.float32(focal), jnp.asarray(pp),
        keys[v])[0]) for v in range(V)])
    got, inl = t_pnp.pnp_ransac(
        torch.from_numpy(pts.reshape(V, -1, 3)), torch.from_numpy(pix),
        torch.from_numpy(masks), torch.tensor(focal), torch.from_numpy(pp),
        sample_idx=torch.from_numpy(_jax_draws(keys, masks)))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=0)
    assert (inl > 0).all()


def test_estimate_camera_poses_matches_jax_backend():
    """Same-shape views (one batched solve) and mixed shapes (a solve per
    view, keys folded per view), against the "jax" backend with its draws
    fed in: focal rtol 1e-5, c2w within 1e-4."""
    seed = 3
    pts, conf, _ = synthetic_scene(V=4, focal=60.0, noise=0.002, seed=seed)
    preds = _preds(pts, conf)
    ref, ref_f = j_pose.estimate_camera_poses(preds, backend="jax", seed=seed)
    idx = _jax_draws(jax.random.split(jax.random.key(seed), 4),
                     conf.reshape(4, -1) > 1.0)
    got, got_f = t_pose.estimate_camera_poses(preds, device="cpu", seed=seed,
                                              sample_idx=[idx])
    np.testing.assert_allclose(np.stack(got[0]), np.stack(ref[0]), atol=1e-4)
    np.testing.assert_allclose(got_f[0], ref_f[0], rtol=1e-5)

    for v in (2, 3):  # crop two views: mixed shapes
        preds[v] = {k: a[:, :32, :40] for k, a in preds[v].items()}
    ref, _ = j_pose.estimate_camera_poses(preds, backend="jax", seed=seed)
    idx = np.concatenate([_jax_draws(
        [jax.random.split(jax.random.fold_in(jax.random.key(seed), v), 1)[0]],
        [np.asarray(p["conf"][0]).reshape(1, -1) > 1.0])
        for v, p in enumerate(preds)])
    got, _ = t_pose.estimate_camera_poses(preds, device="cpu", seed=seed,
                                          sample_idx=[idx])
    np.testing.assert_allclose(np.stack(got[0]), np.stack(ref[0]), atol=1e-4)


def test_pose_from_local_head_and_seeded_draws():
    """The local-head focal mode aligns first and takes view 0's aligned
    local map, as JAX's (its focal: JAX's alignment and Weiszfeld, rtol
    1e-4); the port's own draws (a seeded generator) recover a clean
    scene's cameras."""
    pts, conf, gt = synthetic_scene(V=3, focal=60.0, noise=0.001, seed=1)
    preds = [dict(p, pts3d_local=p["pts3d_in_other_view"],
                  conf_local=p["conf"]) for p in _preds(pts, conf)]
    ref = [dict(p) for p in preds]
    j_recon.align_local_pts3d_to_global(ref)
    ref_f = float(j_pnp.estimate_focal_weiszfeld(
        jnp.asarray(ref[0]["pts3d_local_aligned_to_global"][0]),
        jnp.asarray(ref[0]["conf_local"][0])))
    got, got_f = t_pose.estimate_camera_poses(
        preds, focal_length_estimation_method="first_view_from_local_head",
        device="cpu")
    assert "pts3d_local_aligned_to_global" in preds[0]
    np.testing.assert_allclose(got_f[0], [ref_f] * 3, rtol=1e-4)
    np.testing.assert_allclose(np.stack(got[0]), gt, atol=2e-2)


def test_individual_focal_raises():
    """The "individual" mode gives a focal a view (held against JAX's cv2
    backend in tests/test_torch_focal_gif.py); an unknown mode raises."""
    pts, conf, _ = synthetic_scene(V=2)
    _, focals = t_pose.estimate_camera_poses(
        _preds(pts, conf), focal_length_estimation_method="individual",
        device="cpu")
    assert len(focals[0]) == 2 and all(np.isfinite(focals[0]))
    with pytest.raises(ValueError, match="per_view"):
        t_pose.estimate_camera_poses(
            _preds(pts, conf), focal_length_estimation_method="per_view",
            device="cpu")


def test_correct_preds_orientation_matches_jax():
    rng = np.random.default_rng(2)
    preds = [{"conf": rng.random((2, 4, 6)).astype(np.float32),
              "pts3d_in_other_view": rng.random((2, 4, 6, 3)).astype(
                  np.float32)}]
    views = [{"true_shape": np.int32([[4, 6], [6, 4]])}]
    ref = [dict(p) for p in preds]
    j_pose.correct_preds_orientation(ref, views)
    t_pose.correct_preds_orientation(preds, views)
    t_pose.correct_preds_orientation(preds, views)  # idempotent
    for k in ref[0]:
        for a, b in zip(preds[0][k], ref[0][k]):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# scene export and the CLI
# ---------------------------------------------------------------------------

def _sky_image(seed):
    """A [-1, 1] image with a blue top band, a white patch and clutter."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (40, 56, 3)).astype(np.float32)
    img[:12] = [120, 170, 235]
    img[14:18, 5:20] = [250, 250, 250]
    return img / 127.5 - 1.0


def test_visualizer_matches_jax(tmp_path):
    """Sky masks (OpenCV HSV and morphology on the JAX side, numpy and
    scipy here) equal; confidence colours within one step of OpenCV's JET
    table; the merged scene and its PLY equal."""
    for s in range(3):
        img = _sky_image(s)
        np.testing.assert_array_equal(t_vis.detect_sky_mask(img),
                                      j_vis.detect_sky_mask(img))
    conf = np.random.default_rng(3).uniform(1, 50, 500)
    np.testing.assert_allclose(t_vis.confidence_colors(conf),
                               j_vis.confidence_colors(conf), atol=1.01 / 255)
    rng = np.random.default_rng(4)
    views = [{"img": _sky_image(s)[None]} for s in range(2)]
    preds = [{"pts3d_in_other_view": rng.random((1, 40, 56, 3)),
              "conf": rng.uniform(1, 3, (1, 40, 56)),
              "pts3d_local_aligned_to_global": rng.random((1, 40, 56, 3)),
              "conf_local": rng.uniform(1, 3, (1, 40, 56))} for _ in range(2)]
    for kw in (dict(), dict(use_local_head=False, mask_sky=True,
                            conf_percentile=30.0)):
        got, ref = (m.assemble_scene(views, preds, **kw)
                    for m in (t_vis, j_vis))
        assert got["outdoor"] == ref["outdoor"]
        for k in ("points", "colors"):
            np.testing.assert_array_equal(got[k], ref[k])
        t_vis.export_scene_ply(str(tmp_path / "t.ply"), got)
        j_vis.export_scene_ply(str(tmp_path / "j.ply"), ref)
        assert (tmp_path / "t.ply").read_bytes() == \
            (tmp_path / "j.ply").read_bytes()
    pts, cols = t_ply.read_ply(str(tmp_path / "j.ply"))
    np.testing.assert_array_equal(pts, j_ply.read_ply(str(tmp_path /
                                                          "t.ply"))[0])


@pytest.mark.parametrize("mixed", [False, True])
def test_reconstruct_cli_cpu(tmp_path, mixed):
    """The CLI at tiny size on the CPU: same-shape frames take the device
    ingest, mixed ones the host path; it writes scene.ply, poses.json and
    the .npz files, and its poses equal estimate_camera_poses on the same
    predictions."""
    rng = np.random.default_rng(5)
    folder = tmp_path / "imgs"
    folder.mkdir()
    shapes = [(72, 96), (96, 72), (60, 100)] if mixed else [(72, 96)] * 3
    for i, (h, w) in enumerate(shapes):
        PIL.Image.fromarray(rng.integers(0, 256, (h, w, 3),
                                         dtype=np.uint8)).save(
            folder / f"{i}.png")
    out = tmp_path / "out"
    res = t_cli.main([str(folder), "--out", str(out), "--device", "cpu",
                      "--size", "64", "--save-npz"])
    poses = json.loads((out / "poses.json").read_text())
    assert len(poses["poses_c2w"]) == len(poses["focals"]) == 3
    assert np.isfinite(np.asarray(poses["poses_c2w"])).all()
    ref, ref_f = t_pose.estimate_camera_poses(res["preds"], device="cpu")
    np.testing.assert_allclose(np.asarray(poses["poses_c2w"]),
                               np.stack(ref[0]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(poses["focals"], ref_f[0], rtol=1e-6)
    pts, cols = t_ply.read_ply(str(out / "scene.ply"))
    assert len(pts) == len(cols) == res["points"] > 0
    for i in range(3):
        npz = np.load(out / f"view_{i:04d}.npz")
        assert set(npz.files) >= {"pts3d_in_other_view", "conf",
                                  "pts3d_local_aligned_to_global"}
    assert set(res["times"]) == {"load_s", "forward_s", "align_s", "pose_s",
                                 "ply_s"}
