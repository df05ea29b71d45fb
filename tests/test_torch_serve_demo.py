"""The port's interactive serving (``fast3r_torch/serve``: the Gradio demo,
the Viser server, the session manager, video input) against fast3r_tpu's
on the CPU.

Neither machine has gradio or viser: both packages' demos and servers run
on the fake modules of ``tests/torch_fake_ui.py``, whose controls fire
their callbacks as a browser would.  The two models carry the same tiny
weights (numpy-seeded in JAX's tree, converted to the port), with the
decoder's random image ids off, so both forwards see arange ids.  Both
sides compute in fp32 and differ in summation order (about 1e-5 on the
pointmaps); tolerances are stated per test.  ``ffmpeg`` is faked by a
script on PATH that records its arguments and writes seeded JPEGs.
"""

import dataclasses
import importlib
import json
import os
import stat
import sys
import tempfile

import numpy as np
import PIL.Image
import pytest

import jax
import torch

from fast3r_torch.cli import reconstruct as t_cli
from fast3r_torch.inference import Fast3R
from fast3r_torch.serve import demo as t_demo
from fast3r_torch.serve import ply as t_ply
from fast3r_torch.serve import server_manager as t_sm
from fast3r_torch.serve import video as t_video
from fast3r_torch.serve import viser_server as t_vs
from fast3r_torch.utils import image as t_image

from fast3r_tpu.cli import reconstruct as j_cli
from fast3r_tpu.models import fast3r as jf
from fast3r_tpu.serve import demo as j_demo
from fast3r_tpu.serve import server_manager as j_sm
from fast3r_tpu.serve import video as j_video
from fast3r_tpu.serve import viser_server as j_vs
from fast3r_tpu.utils import checkpoint_utils as j_cu
from fast3r_tpu.utils import image as j_image

from chip_smoke import pose_scene
from test_torch_model import _jax_params, _port_cfg
from torch_fake_ui import fake_ui, sleepy_server  # noqa: F401 (fixture)
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

j_inf = importlib.import_module("fast3r_tpu.inference")

# a PLY point of each side within this fraction of the scene's extent
PLY_REL = 1e-4
# frustum poses of the posed scene
POSE_TOL = 1e-4


def _no_random_ids(cfg):
    return dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, random_image_idx_embedding=False))


@pytest.fixture(scope="module")
def models():
    """(JAX Fast3R, port Fast3R) of the tiny configuration on the same
    weights, the decoder's random image ids off."""
    jcfg = _no_random_ids(jf.Fast3RConfig.tiny())
    params = _jax_params(jcfg, seed=2)
    port = Fast3R.from_jax_params(jax.tree.map(np.asarray, params),
                                  _no_random_ids(_port_cfg(jcfg)),
                                  device="cpu")
    return j_inf.Fast3R(jcfg, params), port


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    rng = np.random.default_rng(3)
    d = tmp_path_factory.mktemp("demo_imgs")
    paths = []
    for i in range(2):
        p = str(d / f"img{i}.jpg")
        PIL.Image.fromarray(
            rng.integers(0, 255, (96, 128, 3), dtype=np.uint8)).save(p)
        paths.append(p)
    return paths


class _File:  # a gradio upload
    def __init__(self, name):
        self.name = name


def _assert_ply_close(path_port, path_jax, color_steps=0):
    """Equal counts; every point within PLY_REL of the scene's extent;
    colours within ``color_steps`` of 255."""
    pts, cols = t_ply.read_ply(path_port)
    ref, ref_cols = t_ply.read_ply(path_jax)
    assert len(pts) == len(ref) > 0
    extent = float(np.ptp(ref, axis=0).max())
    assert np.abs(pts - ref).max() <= PLY_REL * extent
    assert np.abs(cols.astype(int) - ref_cols.astype(int)).max() <= \
        color_steps


def _status_keys(status):
    """The lines of a status box without their numbers."""
    return [line.split(":")[0].split(" in ")[0].strip()
            for line in status.splitlines()]


# ---------------------------------------------------------------------------
# the demo
# ---------------------------------------------------------------------------

def test_demo_matches_jax(fake_ui, models, image_files, monkeypatch,
                          tmp_path):
    """Both demos on the fake Gradio: the same wiring (five clicks, the
    gallery's change), status lines (view count, resolution, the speed
    report's stages, the session's port), PLYs, feedback records (apart
    from their time), session release and GC timer."""
    started, stopped = {}, {}
    for name, sm in (("jax", j_sm), ("port", t_sm)):
        monkeypatch.setattr(
            sm.ViserServerManager, "start_server",
            lambda self, sid, *a, _n=name, **k:
            started.setdefault(_n, []).append((sid, a, k)) or 8020)
        monkeypatch.setattr(
            sm.ViserServerManager, "stop_server",
            lambda self, sid, _n=name: stopped.setdefault(_n, []).append(sid)
            or True)
    monkeypatch.setattr(tempfile, "gettempdir", lambda: str(tmp_path))
    jmodel, tmodel = models
    demos = {"jax": j_demo.create_demo(jmodel),
             "port": t_demo.create_demo(tmodel)}
    try:
        for d in demos.values():
            assert len(d.clicks) == 5 and len(d.changes) == 1
            assert isinstance(d._fast3r["manager"],
                              (j_sm.ViserServerManager,
                               t_sm.ViserServerManager))
            timer = d._fast3r["gc_timer"]
            assert timer.daemon and timer.is_alive()
            assert timer.interval == t_demo.GC_INTERVAL_S == \
                j_demo.GC_INTERVAL_S
        assert [len(c[1]) for c in demos["port"].clicks] == \
            [len(c[1]) for c in demos["jax"].clicks]
        assert t_demo.RESOLUTION_CHOICES == j_demo.RESOLUTION_CHOICES
        files = [_File(p) for p in image_files]
        out = {}
        for name, d in demos.items():
            gallery = d.changes[0][0]
            assert gallery(files) == image_files
            process, up, down, send, end = (c[0] for c in d.clicks)
            ply, status = process(files, None, 10.0, resolution="224")
            assert process([], None, 10.0) == (None,
                                                "upload images or a video")
            assert "saved" in send("great tool")
            assert "saved" in up() and "saved" in down()
            assert send("") == "enter feedback first"
            assert "released" in end()
            out[name] = (ply, status)
        (pj, sj), (pt, st) = out["jax"], out["port"]
        assert _status_keys(st) == _status_keys(sj)
        for s in (sj, st):
            assert "2 views" in s and "224px" in s
            assert "viser on port 8020" in s
            for stage in ("encode_images", "decoder", "head_forward"):
                assert f"  {stage}: " in s
        assert sj.splitlines()[0] == st.splitlines()[0]  # "N points @ 224px"
        _assert_ply_close(pt, pj)
        (sid_j, args_j, kw_j), = started["jax"]
        (sid_t, args_t, kw_t), = started["port"]
        assert sid_j == sid_t == "default"
        assert kw_t == {"device": "cpu"} and kw_j == {}
        assert len(args_t[0]["preds"]) == len(args_j[0]["preds"]) == 2
        assert stopped == {"jax": ["default"], "port": ["default"]}
        recs = {}
        for name in ("tpu", "torch"):
            path = tmp_path / f"fast3r_{name}_feedback.jsonl"
            recs[name] = [{k: v for k, v in json.loads(line).items()
                           if k != "time"}
                          for line in path.read_text().splitlines()]
        assert recs["torch"] == recs["tpu"]
        assert [r["rating"] for r in recs["torch"]] == [
            "", "thumbs_up", "thumbs_down"]
    finally:
        for d in demos.values():
            d._fast3r["gc_timer"].cancel()


def test_demo_main_needs_gradio(monkeypatch):
    """Without gradio the entry point says so (and loads nothing);
    ``--device`` defaults to cuda and takes cpu."""
    monkeypatch.setitem(sys.modules, "gradio", None)
    for argv in (["--checkpoint", "x"], ["--checkpoint", "x",
                                         "--device", "cpu"]):
        with pytest.raises(SystemExit, match="gradio is not installed"):
            t_demo.main(argv)


# ---------------------------------------------------------------------------
# the Viser server
# ---------------------------------------------------------------------------

def _visible(fd, head):
    return [f[f"point_node_{head}"].visible for f in fd]


def _drive(server, n):
    """The JAX harness's walk through the control panel; returns what each
    step shows: the visibility lists, the cloud sizes, and the exports."""
    gui, fd = server.gui, server._fast3r["frame_data"]
    seen = []

    def look(tag):
        seen.append((tag, _visible(fd, "local"), _visible(fd, "global"),
                     [f["frustum_node"].visible for f in fd],
                     [len(h.points) for h in server.scene.point_clouds]))

    look("start")
    gui.slider("Timestep").set(0)
    look("timestep 0")
    gui.button("Next Frame").click()
    look("next")
    gui.button("Prev Frame").click()
    look("prev")
    gui.slider("Timestep").set(n - 1)
    gui.checkbox("Global").set(True)
    gui.checkbox("Local").set(False)
    look("heads")
    gui.checkbox("Show Cameras").set(False)
    look("cameras off")
    gui.slider("High/Low Conf Threshold").set(12.0)
    look("gate")
    gui.checkbox("Show Low-Conf Views").set(True)
    look("low-conf views")
    gui.slider("Per-View Conf Percentile").set(80.0)
    look("percentile 80")
    gui.checkbox("Color by View").set(True)
    c0 = np.asarray(server.scene.point_clouds[0].colors)
    assert len(np.unique(c0, axis=0)) <= 1
    gui.checkbox("Color by View").set(False)
    gui.checkbox("Show Confidence").set(True)
    gui.slider("Point Size").set(0.001)
    assert all(f["point_node_global"].point_size == 0.001 for f in fd)
    gui.slider("Camera Size (%)").set(5.0)
    gif = gui.button("Render a GIF").click()
    ply = gui.button("Download PLY").click()
    assert os.path.exists(gif) and os.path.exists(ply)
    server._fast3r["stop"].set()
    return seen, ply


def _port_inference(paths, model):
    """The port's inference on ``paths`` loaded at 64."""
    from fast3r_torch.inference import inference

    return inference(t_image.load_images(paths, size=64, verbose=False),
                     model, verbose=False)


def test_viser_server_matches_jax_on_the_model_output(fake_ui, models,
                                                      image_files,
                                                      monkeypatch, tmp_path):
    """Both servers on the tiny model's output for two views: a global and
    an aligned-local cloud a frame and a frustum a view (finite: on random
    pointmaps the poses themselves are ill-posed), then the same
    visibility lists and cloud sizes at every step of the control-panel
    walk (the timestep, next / previous, head and camera toggles, the
    confidence gate, the percentile slider, which shrinks the clouds, the
    colour modes and sizes), and exported GIFs and PLYs, the PLYs of the
    same size."""
    monkeypatch.setattr(tempfile, "gettempdir", lambda: str(tmp_path))
    jmodel, tmodel = models
    jres = j_inf.inference(j_image.load_images(image_files, size=64,
                                               verbose=False),
                           jmodel, verbose=False)
    tres = _port_inference(image_files, tmodel)
    walks = {}
    for name, server in (
            ("jax", j_vs.run_viser_server(jres, port=8042, blocking=False)),
            ("port", t_vs.run_viser_server(tres, port=8043, blocking=False,
                                           device="cpu"))):
        assert len(server.scene.point_clouds) == 2 * 2
        assert len(server.scene.frustums) == 2
        for h in server.scene.frustums:
            assert np.isfinite(h.wxyz).all() and np.isfinite(h.position).all()
            assert 0 < h.fov < np.pi
        walks[name] = _drive(server, 2)
    assert walks["port"][0] == walks["jax"][0]
    sizes = {tag: sum(s) for tag, *_, s in walks["port"][0]}
    assert sizes["percentile 80"] < sizes["low-conf views"]
    assert len(t_ply.read_ply(walks["port"][1])[0]) == \
        len(t_ply.read_ply(walks["jax"][1])[0])


def test_viser_frustums_match_jax_on_a_posed_scene(fake_ui):
    """On a seeded scene of three known cameras (chip_smoke.pose_scene:
    1% depth noise, 5% outliers) both servers place the frustums alike:
    wxyz and position within 1e-4, and within 1e-2 of the truth."""
    preds, c2w = pose_scene(3, 96, 128, seed=21)
    rng = np.random.default_rng(22)
    views = [{"img": rng.uniform(-1, 1, (1, 96, 128, 3)).astype(np.float32)}
             for _ in range(3)]
    jpreds = [{k: np.asarray(v) for k, v in p.items()} for p in preds]
    js = j_vs.run_viser_server({"views": views, "preds": jpreds}, port=8044,
                               blocking=False)
    ts = t_vs.run_viser_server({"views": views, "preds": preds}, port=8045,
                               blocking=False, device="cpu")
    for s in (js, ts):
        s._fast3r["stop"].set()
    for a, b, truth in zip(ts.scene.frustums, js.scene.frustums, c2w):
        np.testing.assert_allclose(a.wxyz, b.wxyz, atol=POSE_TOL)
        np.testing.assert_allclose(a.position, b.position, atol=POSE_TOL)
        np.testing.assert_allclose(a.position, truth[:3, 3], atol=1e-2)
        assert a.fov == pytest.approx(b.fov, rel=1e-4)


# ---------------------------------------------------------------------------
# the session manager
# ---------------------------------------------------------------------------

def test_viser_server_manager_lifecycle():
    """Real spawned processes of a trivial target over a pool of three
    ports: two sessions, a restart that keeps the registry's size, a clean
    error when the pool is spent, stop, and a GC at age 0 that collects
    the rest."""
    m = t_sm.ViserServerManager(port_range=(9010, 9012),
                                target=sleepy_server)
    try:
        p1 = m.start_server("alice")
        p2 = m.start_server("bob")
        assert p1 != p2 and len(m) == 2
        p1b = m.start_server("alice")
        assert len(m) == 2 and p1b in (9010, 9011, 9012)
        m.start_server("carol")
        with pytest.raises(RuntimeError, match="no free port"):
            m.start_server("dave")
        procs = [info["proc"] for info in m._sessions.values()]
        assert all(p.is_alive() for p in procs)
        assert m.stop_server("bob") and not m.stop_server("bob")
        m.touch("alice")
        assert m.gc(max_age_s=0.0) == 2 and len(m) == 0
        assert not any(p.is_alive() for p in procs)
    finally:
        m.shutdown()


def test_save_feedback_matches_jax(tmp_path):
    """The same JSON lines, apart from the time."""
    rows = {}
    for name, fn in (("jax", j_sm.save_feedback), ("port", t_sm.save_feedback)):
        path = str(tmp_path / name / "fb.jsonl")
        fn(path, "great tool", {"session": "a"})
        fn(path, "second")
        rows[name] = [{k: v for k, v in json.loads(line).items()
                       if k != "time"} for line in open(path)]
    assert rows["port"] == rows["jax"] == [
        {"text": "great tool", "session": "a"}, {"text": "second"}]


# ---------------------------------------------------------------------------
# video input
# ---------------------------------------------------------------------------

FFMPEG = '''#!{python}
import json, os, sys
import numpy as np
import PIL.Image

with open(os.environ["FAKE_FFMPEG_LOG"], "a") as f:
    f.write(json.dumps(sys.argv[1:]) + "\\n")
pattern = sys.argv[-1]
rng = np.random.default_rng(7)
for i in range(3):
    PIL.Image.fromarray(rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
                        ).save(pattern % (i + 1), quality=95)
'''


@pytest.fixture()
def fake_ffmpeg(tmp_path, monkeypatch):
    """An ``ffmpeg`` on PATH that logs its arguments (one JSON list a call)
    and writes three seeded 48x64 JPEGs by the output pattern; returns
    the log's path."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    exe = bin_dir / "ffmpeg"
    exe.write_text(FFMPEG.format(python=sys.executable))
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    log = tmp_path / "ffmpeg.log"
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("FAKE_FFMPEG_LOG", str(log))
    return log


def test_video_frames_match_jax(fake_ffmpeg, tmp_path):
    """Both packages send ffmpeg the same arguments (but the output folder)
    and return the same listing of the same frames."""
    outs = {}
    for name, mod in (("jax", j_video), ("port", t_video)):
        d = str(tmp_path / name)
        assert mod.extract_frames_from_video("clip.mp4", d, fps=2.0) == d
        outs[name] = d
    calls = [json.loads(line) for line in fake_ffmpeg.read_text().splitlines()]
    assert len(calls) == 2
    j_call, t_call = calls
    assert t_call[:-1] == j_call[:-1] == [
        "-y", "-loglevel", "error", "-i", "clip.mp4", "-vf", "fps=2.0"]
    assert t_call[-1] == os.path.join(outs["port"], "frame_%05d.jpg")
    assert j_call[-1] == os.path.join(outs["jax"], "frame_%05d.jpg")
    listing = sorted(os.listdir(outs["port"]))
    assert listing == sorted(os.listdir(outs["jax"])) == [
        "frame_00001.jpg", "frame_00002.jpg", "frame_00003.jpg"]
    for f in listing:
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes()


def test_video_without_ffmpeg_raises(tmp_path, monkeypatch):
    """No ffmpeg on PATH: the port raises (it has no OpenCV fallback) and
    the CLI with it."""
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="ffmpeg"):
        t_video.extract_frames_from_video("clip.mp4", str(tmp_path / "fr"))
    with pytest.raises(RuntimeError, match="ffmpeg"):
        t_cli.main(["clip.mp4", "--out", str(tmp_path / "out"),
                    "--device", "cpu"])


def test_reconstruct_cli_video_matches_jax(fake_ffmpeg, tmp_path):
    """``cli.reconstruct`` on an .mp4 in both packages, on one HF-format
    export (tiny encoder and decoder, the head at its published widths,
    random image ids off): the same frames extracted under OUT/frames, the
    per-view pointmaps (.npz) within the raw-frame serving path's
    tolerance (5e-4: the device resize against JAX's), a PLY of the same
    size within PLY_REL of the scene's extent, its colours within two
    steps of 255 (that path's preprocessed images differ by up to 2 /
    127.5), and a pose and a focal a view.  The poses' RANSAC draws differ
    between the packages and random pointmaps pose no well-posed PnP, so
    poses are held to be finite."""
    from fast3r_tpu.models.decoder import DecoderConfig
    from fast3r_tpu.models.dpt_head import DPTHeadConfig
    from fast3r_tpu.models.encoder import EncoderConfig

    jcfg = jf.Fast3RConfig(
        encoder=EncoderConfig(embed_dim=64, num_heads=2, depth=2),
        decoder=DecoderConfig(enc_embed_dim=64, embed_dim=64, num_heads=2,
                              depth=4, random_image_idx_embedding=False),
        head=DPTHeadConfig(dim_tokens=(64, 64, 64, 64)))
    hf = tmp_path / "hf"
    j_cu.convert_checkpoint_to_hf(j_inf.Fast3R(jcfg, _jax_params(jcfg, 8)),
                                  str(hf))
    video = str(tmp_path / "clip.mp4")
    outs = {name: tmp_path / name for name in ("jax", "port")}
    common = ["--checkpoint", str(hf), "--size", "64", "--save-npz"]
    j_cli.main([video, "--out", str(outs["jax"])] + common)
    res = t_cli.main([video, "--out", str(outs["port"]), "--device", "cpu"]
                     + common)
    assert sorted(os.listdir(outs["port"] / "frames")) == \
        sorted(os.listdir(outs["jax"] / "frames"))
    assert len(res["views"]) == 3
    for i in range(3):
        got = np.load(outs["port"] / f"view_{i:04d}.npz")
        ref = np.load(outs["jax"] / f"view_{i:04d}.npz")
        for k in ("pts3d_in_other_view", "conf", "pts3d_local",
                  "conf_local"):
            np.testing.assert_allclose(got[k], ref[k], rtol=5e-4, atol=5e-4,
                                       err_msg=k)
    _assert_ply_close(str(outs["port"] / "scene.ply"),
                      str(outs["jax"] / "scene.ply"), color_steps=2)
    poses = {n: json.loads((o / "poses.json").read_text())
             for n, o in outs.items()}
    for p in poses.values():
        assert len(p["poses_c2w"]) == len(p["focals"]) == 3
        assert np.isfinite(np.asarray(p["poses_c2w"])).all()
