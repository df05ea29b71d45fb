"""The port's evaluation (fast3r_torch.eval.recon metrics, cli.eval,
cli.re10k_pose_eval, cli.robustmvd_eval) against fast3r_tpu's on the CPU.

* The recon metrics on seeded predictions and views: ``estimate_normals``
  (up to sign), ``accuracy``, ``completion``, ``completion_ratio`` and
  ``evaluate_reconstruction`` (both heads, non-zero confidence
  percentiles, a sample of fewer than 3 points) within 1e-5 relative; the
  median distances of ``evaluate_reconstruction`` within 1e-5 of the
  scene's extent (the similarity fits differ in fp32 summation order, and
  a median picks one of two near-equal distances: up to 2.4e-5 of the
  value here, 1e-7 of the extent).
* ``cli.eval --device cpu`` on each of the four presets, their datasets
  retargeted to fixture roots as ``tests/test_eval_scripts.py`` does,
  against JAX's ``cli.eval`` on the same HF checkpoint and overrides (run
  once, on the preset of all four datasets): the same result keys, losses
  within 1e-4, recon metrics within 1e-3 relative, pose metrics by key
  (RANSAC-PnP on a random model's pointmaps picks among near-equal
  hypotheses by summation order).  The checkpoint's decoder draws no
  random image ids, so both packages run the same forward.
* The RE10K and RobustMVD drivers with ``--device cpu`` on the fixtures of
  ``tests/test_eval_scripts.py``: the JAX scripts' output keys;
  ``depth_metrics`` equal to JAX's.  The RE10K driver runs with the model
  replaced by the scenes' exact pointmaps (its forward on the card is
  ``chip_smoke.py`` phase 20's; on a CPU the port's PnP takes minutes at
  512x288) on the fixture's cameras and on a seeded scene of
  cameras that turn and move: every relative rotation and translation
  direction within 5 degrees (RRA@5 = RTA@5 = 1).
"""

import copy
import json
import os
import pathlib
import sys

import numpy as np
import PIL.Image
import pytest
import torch

from fast3r_tpu.eval import recon as jrecon

from fast3r_torch.eval import recon as trecon

SCRIPTS = pathlib.Path(__file__).resolve().parents[1] / "scripts"
THREADS = 2  # torch threads: the suite runs several test processes on the
             # same cores


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, THREADS))
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# (d) the reconstruction metrics
# ---------------------------------------------------------------------------

def _surface(rng, B, V, H, W):
    """Views of a bumpy surface: pts3d (B, H, W, 3) per view and valid
    masks; sample 1 of B > 1 keeps only 2 valid pixels in all."""
    views = []
    for v in range(V):
        u, w = np.meshgrid(np.linspace(-1, 1, W), np.linspace(-1, 1, H))
        pts = []
        for b in range(B):
            x = u + 0.3 * v + 0.05 * b
            z = 3 + 0.2 * np.sin(3 * x) * np.cos(2 * w) + 0.01 * rng.normal(
                size=x.shape)
            pts.append(np.stack([x, w, z], -1))
        valid = rng.random((B, H, W)) > 0.2
        if B > 1:
            valid[1] = False
            if v == 0:
                valid[1, 0, :2] = True
        views.append({"pts3d": np.stack(pts).astype(np.float32),
                      "valid_mask": valid})
    return views


def _preds(rng, views):
    """Noisy predictions in a moved frame (global head) and a second moved
    frame (local head), with confidences >= 1."""
    R = np.array([[0.96, -0.28, 0], [0.28, 0.96, 0], [0, 0, 1]], np.float32)
    preds = []
    for view in views:
        g = view["pts3d"] @ R.T * 1.7 + [0.1, -0.2, 0.3]
        loc = view["pts3d"] * 0.8 - [0.05, 0.0, 0.1]
        shape = view["valid_mask"].shape
        preds.append({
            "pts3d_in_other_view": (g + 0.02 * rng.normal(size=g.shape)
                                    ).astype(np.float32),
            "conf": (1 + rng.random(shape) * 3).astype(np.float32),
            "pts3d_local": (loc + 0.02 * rng.normal(size=loc.shape)
                            ).astype(np.float32),
            "conf_local": (1 + rng.random(shape) * 3).astype(np.float32),
        })
    return preds


def _close(a, b, rel):
    assert abs(a - b) <= rel * max(abs(a), abs(b), 1e-12), (a, b)


def test_recon_metrics_match_jax():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(500, 3)).astype(np.float32) * [1, 1, 0.05]
    gt = pts + 0.01 * rng.normal(size=pts.shape).astype(np.float32)
    n_port, n_jax = trecon.estimate_normals(pts), jrecon.estimate_normals(pts)
    np.testing.assert_allclose(np.abs(np.sum(n_port * n_jax, -1)), 1.0,
                               atol=1e-5)
    gn = jrecon.estimate_normals(gt)
    for port, ref in ((trecon.accuracy(gt, pts, gn, n_jax),
                       jrecon.accuracy(gt, pts, gn, n_jax)),
                      (trecon.completion(gt, pts, gn, n_jax),
                       jrecon.completion(gt, pts, gn, n_jax)),
                      (trecon.accuracy(gt, pts), jrecon.accuracy(gt, pts)),
                      (trecon.completion(gt, pts),
                       jrecon.completion(gt, pts))):
        assert len(port) == len(ref)
        for a, b in zip(port, ref):
            _close(a, b, 1e-5)
    for th in (0.005, 0.05):
        _close(trecon.completion_ratio(gt, pts, th),
               jrecon.completion_ratio(gt, pts, th), 1e-5)


@pytest.mark.parametrize("local", [True, False])
@pytest.mark.parametrize("pcts", [(0.0, 0.0), (30.0, 10.0)])
def test_evaluate_reconstruction_matches_jax(local, pcts):
    rng = np.random.default_rng(1)
    views = _surface(rng, 2, 3, 24, 32)
    preds = _preds(rng, views)
    kw = dict(min_conf_thr_percentile_for_local_alignment_and_icp=pcts[0],
              min_conf_thr_percentile_for_metric_calculation=pcts[1],
              use_pts3d_from_local_head=local)
    ref = jrecon.evaluate_reconstruction(views, copy.deepcopy(preds), **kw)
    port_preds = [{k: torch.from_numpy(v) for k, v in p.items()}
                  for p in preds]
    got = trecon.evaluate_reconstruction(views, port_preds, device="cpu",
                                         **kw)
    assert len(got) == len(ref) == 2
    assert got[1] is None and ref[1] is None      # under 3 points
    assert set(got[0]) == set(ref[0])
    extent = np.ptp(np.concatenate([v["pts3d"].reshape(-1, 3)
                                    for v in views]), axis=0).max()
    for k in ref[0]:
        if k in ("accuracy_median", "completion_median"):
            assert abs(got[0][k] - ref[0][k]) <= 1e-5 * extent, k
        else:
            _close(got[0][k], ref[0][k], 1e-5)


# ---------------------------------------------------------------------------
# (e) the eval CLI against JAX's on the four presets
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hf_checkpoint(tmp_path_factory):
    """A small model at the DPT head's published widths (the reference's
    *_args carry no head widths) without random image ids, exported by
    fast3r_tpu's convert_checkpoint_to_hf; both packages read it."""
    import dataclasses

    from fast3r_tpu.inference import Fast3R as JaxFast3R
    from fast3r_tpu.models.decoder import DecoderConfig
    from fast3r_tpu.models.dpt_head import DPTHeadConfig
    from fast3r_tpu.models.encoder import EncoderConfig
    from fast3r_tpu.models.fast3r import Fast3RConfig
    from fast3r_tpu.utils.checkpoint_utils import convert_checkpoint_to_hf

    from fast3r_torch.models.fast3r import init_fast3r
    from fast3r_torch.utils.convert import params_to_jax
    from test_torch_model import _port_cfg

    cfg = Fast3RConfig(
        encoder=EncoderConfig(embed_dim=64, num_heads=2, depth=2),
        decoder=DecoderConfig(enc_embed_dim=64, embed_dim=64, num_heads=2,
                              depth=4, random_image_idx_embedding=False),
        head=DPTHeadConfig(dim_tokens=(64, 64, 64, 64)))
    pcfg = _port_cfg(cfg)
    pcfg = dataclasses.replace(pcfg, decoder=dataclasses.replace(
        pcfg.decoder, random_image_idx_embedding=False))
    # seeded weights drawn by the port (faster than JAX's eager init)
    tree = params_to_jax(init_fast3r(pcfg, 3, torch.float32, "cpu")
                         .state_dict(), pcfg)
    out = str(tmp_path_factory.mktemp("ckpt") / "hf")
    convert_checkpoint_to_hf(JaxFast3R(cfg, tree), out)
    return out


@pytest.fixture(scope="module")
def eval_exprs(tmp_path_factory):
    """The four datasets of ablation_recon_better_inference_hp on fixture
    roots at 64x48."""
    from test_real_datasets import (
        make_co3d_root,
        make_dtu_root,
        make_nrgbd_root,
        make_sevenscenes_root,
    )

    tmp = tmp_path_factory.mktemp("roots")
    co3d = make_co3d_root(tmp / "co3d", declare_missing=False)
    res = [(64, 48)]
    return [
        f"2 @ Co3d_Multiview(split='train', num_views=${{data.num_views_val}},"
        f" window_degree_range=360, num_samples_per_window=1, ROOT='{co3d}',"
        f" resolution={res!r}, seed=777)",
        f"DTU(split='test', ROOT='{make_dtu_root(tmp / 'dtu')}', "
        f"resolution={res!r}, num_seq=1, full_video=True, kf_every=2, "
        f"seed=777)",
        f"SevenScenes(split='test', ROOT='{make_sevenscenes_root(tmp / '7s')}',"
        f" resolution={res!r}, num_seq=1, full_video=True, kf_every=3, "
        f"seed=777)",
        f"NRGBD(split='test', ROOT='{make_nrgbd_root(tmp / 'nrgbd')}', "
        f"resolution={res!r}, num_seq=1, full_video=True, kf_every=2, "
        f"seed=777)",
    ]


def _eval_args(preset, ckpt, exprs):
    return ["--eval-config", preset, "--hf-checkpoint", ckpt,
            f"data.validation_datasets={exprs!r}", "data.num_views_val=2",
            "data.num_workers_val=0"]


@pytest.fixture(scope="module")
def jax_results(hf_checkpoint, eval_exprs):
    from fast3r_tpu.cli import eval as jax_eval

    return jax_eval.main(_eval_args("ablation_recon_better_inference_hp",
                                    hf_checkpoint, eval_exprs))


# preset -> datasets it is given; the suites each dataset must get
PRESETS = {
    "ablation_recon_better_inference_hp": 4,
    "eval_cam_pose": 1,
    "ablation_recon_without_local_head": 2,
    "ablation_varying_test_views": 2,
}


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_eval_cli_presets_match_jax(preset, hf_checkpoint, eval_exprs,
                                    jax_results, monkeypatch, tmp_path):
    from fast3r_torch.cli import eval as eval_cli

    monkeypatch.chdir(tmp_path)   # eval_out/ lands here
    n = PRESETS[preset]
    got = eval_cli.main(_eval_args(preset, hf_checkpoint, eval_exprs[:n])
                        + ["--device", "cpu"])
    assert all(np.isfinite(v) for v in got.values())
    ds = [f"val/dataset_{i}/" for i in range(n)]
    # pose on CO3D only, recon on DTU / 7-Scenes / NRGBD only
    assert f"{ds[0]}pose/RRA_at_15" in got
    assert not any(k.startswith(ds[0] + "recon/") for k in got)
    for d in ds[1:]:
        assert f"{d}recon/accuracy" in got
        assert not any(k.startswith(d + "pose/") for k in got)
    ref = {k: v for k, v in jax_results.items()
           if any(k.startswith(d) for d in ds)}
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        if k.endswith("/loss"):
            assert abs(got[k] - v) <= 1e-4, (k, got[k], v)
        elif "/recon/" in k and preset != "ablation_recon_without_local_head":
            _close(got[k], v, 1e-3)
    assert os.path.exists(tmp_path / "eval_out" / "metrics.csv")


# ---------------------------------------------------------------------------
# (f) the RE10K and RobustMVD drivers
# ---------------------------------------------------------------------------

def _re10k_root(tmp_path, scene, n, H0, W0, w2cs, K_norm, rng):
    vroot, troot = tmp_path / "videos", tmp_path / "txts"
    os.makedirs(vroot / scene)
    os.makedirs(troot, exist_ok=True)
    lines = ["https://example.com/watch"]
    for i in range(n):
        fid = f"{i * 1000}"
        PIL.Image.fromarray(rng.integers(0, 255, (H0, W0, 3), dtype=np.uint8)
                            ).save(vroot / scene / f"{fid}.jpg")
        lines.append(" ".join([fid, *(f"{k}" for k in K_norm), "0", "0"]
                              + [f"{v:.9f}" for v in w2cs[i][:3].reshape(-1)]))
    (troot / f"{scene}.txt").write_text("\n".join(lines) + "\n")
    (tmp_path / "list.txt").write_text(scene + "\n")
    return vroot, troot


def _look(yaw, t):
    """c2w: a rotation about y by ``yaw`` and a translation."""
    c, s = np.cos(yaw), np.sin(yaw)
    T = np.eye(4)
    T[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    T[:3, 3] = t
    return T


def _scene_points(c2w, K, H, W):
    """World points seen at each pixel: a sphere (centre (0, 0, 4), radius
    1.5) in front of a plane at z = 7."""
    u, v = np.meshgrid(np.arange(W), np.arange(H))
    d = np.stack([(u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1],
                  np.ones_like(u, dtype=float)], -1) @ c2w[:3, :3].T
    o = c2w[:3, 3]
    oc = o - [0, 0, 4]
    b = (d * oc).sum(-1)
    a = (d * d).sum(-1)
    disc = b * b - a * ((oc * oc).sum() - 1.5 ** 2)
    t_sphere = np.where(disc > 0, (-b - np.sqrt(np.maximum(disc, 0))) / a,
                        np.inf)
    t = np.minimum(t_sphere, (7 - o[2]) / d[..., 2])
    return o + t[..., None] * d


def _oracle(monkeypatch, c2ws, H0, W0, K_norm):
    """Replaces the RE10K driver's forward by the scene's exact pointmaps in
    view 0's frame (conf 2), on a grid 8x coarser than the 512x288 views
    (the crop's camera scaled to it): the same poses, a 64th of the
    PnP's points (the port's RANSAC-PnP polishes every hypothesis over
    all points, about 15 s a 288x512 view on one CPU)."""
    from fast3r_torch.cli import re10k_pose_eval

    K0 = np.array([[K_norm[0] * W0, 0, K_norm[2] * W0],
                   [0, K_norm[1] * H0, K_norm[3] * H0], [0, 0, 1]],
                  np.float32)
    _, K = re10k_pose_eval.crop_resize_for_re10k(
        PIL.Image.new("RGB", (W0, H0)), K0)
    Kq = K.astype(np.float64).copy()
    Kq[:2] /= 8
    Kq[:2, 2] += 0.5 / 8 - 0.5   # pixel centres of the coarse grid
    w2c0 = np.linalg.inv(c2ws[0])

    def forward_views(model, views, **kw):
        preds = []
        for i, view in enumerate(views):
            H, W = (s // 8 for s in view["img"].shape[1:3])
            X = _scene_points(c2ws[i], Kq, H, W)
            X0 = X @ w2c0[:3, :3].T + w2c0[:3, 3]
            preds.append({"pts3d_in_other_view":
                          torch.from_numpy(X0[None].astype(np.float32)),
                          "conf": torch.full((1, H, W), 2.0)})
        return preds

    monkeypatch.setattr(sys.modules["fast3r_torch.inference"],
                        "forward_views", forward_views)


def test_re10k_driver_matches_jax_keys(hf_checkpoint, tmp_path, monkeypatch):
    """tests/test_eval_scripts.py's RE10K fixture (four frames of cameras
    translated along x): JAX's script with the model, the port's driver
    with the scene's exact pointmaps (``_oracle``; the checkpoint loads):
    the same output keys, every pose within 5 degrees; the txt parsing and
    the crop equal JAX's."""
    sys.path.insert(0, str(SCRIPTS))
    import re10k_pose_eval as jax_re10k

    from fast3r_torch.cli import re10k_pose_eval

    scene = "000c09e7ea8d8fb9"
    w2cs = []
    for i in range(4):
        w2c = np.eye(4)
        w2c[0, 3] = 0.1 * i
        w2cs.append(w2c)
    K_norm = (0.8, 1.0, 0.5, 0.5)
    vroot, troot = _re10k_root(tmp_path, scene, 4, 96, 128, w2cs, K_norm,
                               np.random.default_rng(0))
    args = ["--video-root", str(vroot), "--txt-root", str(troot),
            "--checkpoint", hf_checkpoint, "--scene-list",
            str(tmp_path / "list.txt"), "--num-frames", "4"]
    jax_re10k.main(args + ["--out", str(tmp_path / "j.json")])
    ref = json.load(open(tmp_path / "j.json"))
    _oracle(monkeypatch, [np.linalg.inv(w) for w in w2cs], 96, 128, K_norm)
    got = re10k_pose_eval.main(args + ["--device", "cpu",
                                       "--out", str(tmp_path / "p.json")])
    assert json.load(open(tmp_path / "p.json")) == got
    assert sorted(got) == sorted(ref) == ["aggregate", "per_scene"]
    assert sorted(got["per_scene"]) == sorted(ref["per_scene"]) == [scene]
    assert sorted(got["aggregate"]) == sorted(ref["aggregate"])
    assert got["aggregate"]["RRA_at_5"] == got["aggregate"]["RTA_at_5"] == 1
    p = re10k_pose_eval.parse_re10k_txt(str(troot / f"{scene}.txt"))
    j = jax_re10k.parse_re10k_txt(str(troot / f"{scene}.txt"))
    assert sorted(p) == sorted(j)
    for k in j:
        assert p[k][0] == j[k][0]
        np.testing.assert_array_equal(p[k][1], j[k][1])
    img = PIL.Image.open(vroot / scene / "0.jpg")
    K = np.array([[102.4, 0, 64], [0, 96, 48], [0, 0, 1]], np.float32)
    pi, pK = re10k_pose_eval.crop_resize_for_re10k(img, K.copy())
    ji, jK = jax_re10k.crop_resize_for_re10k(img, K.copy())
    np.testing.assert_array_equal(np.asarray(pi), np.asarray(ji))
    np.testing.assert_array_equal(pK, jK)


def test_re10k_driver_recovers_known_cameras(tmp_path, monkeypatch):
    """Four frames of known cameras that turn and move in 3D, the model
    replaced by the scene's exact pointmaps (``_oracle``): every relative
    rotation and translation direction within 5 degrees."""
    from fast3r_torch.cli import re10k_pose_eval
    from fast3r_torch.utils import checkpoint_utils

    H0, W0, n = 180, 320, 4
    K_norm = (0.9, 1.6, 0.5, 0.5)
    c2ws = [_look(0.06 * i - 0.1, [0.25 * i, 0.03 * i, -0.1 * i])
            for i in range(n)]
    vroot, troot = _re10k_root(tmp_path, "known", n, H0, W0,
                               [np.linalg.inv(c) for c in c2ws], K_norm,
                               np.random.default_rng(1))
    _oracle(monkeypatch, c2ws, H0, W0, K_norm)
    monkeypatch.setattr(checkpoint_utils, "load_model",
                        lambda *a, **kw: None)
    got = re10k_pose_eval.main([
        "--video-root", str(vroot), "--txt-root", str(troot),
        "--checkpoint", "unused", "--scene-list", str(tmp_path / "list.txt"),
        "--num-frames", str(n), "--device", "cpu",
        "--out", str(tmp_path / "r.json")])
    m = got["per_scene"]["known"]
    assert m["RRA_at_5"] == 1.0 and m["RTA_at_5"] == 1.0, m


def test_robustmvd_driver_matches_jax(hf_checkpoint, tmp_path):
    sys.path.insert(0, str(SCRIPTS))
    import robustmvd_eval as jax_rmvd

    from fast3r_torch.cli import robustmvd_eval

    rng = np.random.default_rng(1)
    scene = tmp_path / "rmvd" / "scene0"
    os.makedirs(scene / "images")
    os.makedirs(scene / "depth")
    for i in range(3):
        PIL.Image.fromarray(rng.integers(0, 255, (96, 128, 3), dtype=np.uint8)
                            ).save(scene / "images" / f"{i:04d}.jpg")
    np.save(scene / "depth" / "0000.npy",
            rng.uniform(1.0, 5.0, (48, 64)).astype(np.float32))
    args = ["--checkpoint", hf_checkpoint, "--data-root",
            str(tmp_path / "rmvd"), "--views", "3"]
    got = robustmvd_eval.main(args + ["--device", "cpu",
                                      "--out", str(tmp_path / "p.json")])
    jax_rmvd.main(args + ["--out", str(tmp_path / "j.json")])
    ref = json.load(open(tmp_path / "j.json"))
    assert sorted(got) == sorted(ref)
    assert sorted(got["per_scene"]) == sorted(ref["per_scene"]) == ["scene0"]
    m = got["per_scene"]["scene0"]
    assert sorted(m) == sorted(ref["per_scene"]["scene0"])
    assert all(np.isfinite(v) for v in m.values())
    pred = rng.uniform(0.5, 3, (48, 64)).astype(np.float32)
    gt = rng.uniform(1, 5, (48, 64)).astype(np.float32)
    valid = rng.random((48, 64)) > 0.3
    assert (robustmvd_eval.depth_metrics(pred, gt, valid)
            == jax_rmvd.depth_metrics(pred, gt, valid))
    assert robustmvd_eval.depth_metrics(pred, gt, valid & False) is None
    with pytest.raises(ImportError, match="rmvd"):
        robustmvd_eval.main(["--checkpoint", hf_checkpoint, "--rmvd",
                             "--device", "cpu"])
