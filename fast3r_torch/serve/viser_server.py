"""The interactive Viser server of a reconstruction.

Counterpart of ``fast3r_tpu/serve/viser_server.py`` (the reference's
``fast3r/viz/viser_visualizer.py`` ``start_visualization``): a point cloud
a frame from each head (global, and local aligned to global), the camera
frustums of the PnP poses, and the control panel: point and frustum size,
sky masking, confidence and by-view colours, playback (timestep slider,
next / previous, play at an FPS), high / low confidence gating of views, a
per-view confidence percentile, and the GIF and PLY exports.  The same
control names, handlers, playback thread and ``server._fast3r`` dict as
the JAX package's; the poses come from the port's
``eval.pose.estimate_camera_poses`` on ``device``.  ``viser`` is imported
inside :func:`run_viser_server`, so the module imports without it (the
tests drive it through a fake one, ``tests/torch_fake_ui.py``).
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
from typing import Dict

import numpy as np


def _per_frame_clouds(views, preds, conf_percentile, mask_sky,
                      conf_colors, by_view_colors):
    """Per frame, for each head present: its points above the frame's
    ``conf_percentile``-th confidence (and not sky with ``mask_sky``),
    their colours (the image's, a confidence heatmap or one hue a view)
    and the frame's mean confidence."""
    from fast3r_torch.serve.visualizer import (confidence_colors,
                                               detect_sky_mask)
    from fast3r_torch.utils.image import unnormalize_rgb

    frames = []
    n = len(views)
    for i, (view, pred) in enumerate(zip(views, preds)):
        img = np.asarray(view["img"])
        if img.ndim == 4:
            img = img[0]
        base_colors = unnormalize_rgb(img)
        not_sky = detect_sky_mask(img).astype(bool) if mask_sky else None
        entry = {"img": img}
        for head, key, conf_key in (
                ("global", "pts3d_in_other_view", "conf"),
                ("local", "pts3d_local_aligned_to_global", "conf_local")):
            if key not in pred:
                continue
            pts = np.asarray(pred[key])[0]
            conf = np.asarray(pred[conf_key])[0]
            thr = np.quantile(conf.reshape(-1), conf_percentile / 100.0)
            mask = conf >= thr
            if not_sky is not None:
                mask &= not_sky
            if conf_colors:
                colors = confidence_colors(conf[mask].reshape(-1))
            elif by_view_colors:
                import colorsys

                rgb = colorsys.hsv_to_rgb(i / max(n, 1), 0.8, 0.9)
                colors = np.tile(np.asarray(rgb, np.float32),
                                 (int(mask.sum()), 1))
            else:
                colors = base_colors[mask]
            entry[head] = {"points": pts[mask].reshape(-1, 3),
                           "colors": colors.reshape(-1, 3),
                           "mean_conf": float(np.mean(conf))}
        frames.append(entry)
    return frames


def run_viser_server(output: Dict, port: int = 8020,
                     use_local_head: bool = True,
                     conf_percentile: float = 10.0,
                     point_size: float = 0.002,
                     global_conf_thr_value_to_drop_view: float = 1.5,
                     blocking: bool = True, device="cuda"):
    """Serve the reconstruction ``output`` (the ``inference`` result:
    {"views", "preds"}) on ``port``.  The local head's alignment (when it
    is missing) and the pose recovery run on ``device``.  Returns the
    server; ``server._fast3r`` holds the handlers the tests drive.  With
    ``blocking`` it serves until interrupted."""
    import viser
    import viser.transforms as tf

    from fast3r_torch.eval.pose import estimate_camera_poses
    from fast3r_torch.serve.visualizer import render_scene_gif

    views, preds = output["views"], output["preds"]
    if use_local_head and preds and "pts3d_local" in preds[0] \
            and "pts3d_local_aligned_to_global" not in preds[0]:
        from fast3r_torch.eval.recon import align_local_pts3d_to_global

        align_local_pts3d_to_global(preds, min_conf_thr_percentile=85.0,
                                    device=device)
    num_frames = len(views)
    server = viser.ViserServer(port=port)

    # ---- the control panel ---------------------------------------------
    gui = server.gui
    gui_point_size = gui.add_slider("Point Size", 1e-6, 0.002, 1e-5,
                                    point_size)
    gui_frustum_size = gui.add_slider("Camera Size (%)", 0.1, 10.0, 0.1, 2.0)
    gui_mask_sky = gui.add_checkbox("Mask Sky", False)
    gui_show_conf = gui.add_checkbox("Show Confidence", False)
    gui_by_view = gui.add_checkbox("Color by View", False)
    gui_timestep = gui.add_slider("Timestep", 0, max(num_frames - 1, 0), 1,
                                  max(num_frames - 1, 0))
    gui_next = gui.add_button("Next Frame")
    gui_prev = gui.add_button("Prev Frame")
    gui_playing = gui.add_checkbox("Playing", False)
    gui_fps = gui.add_slider("FPS", 0.25, 60.0, 0.25, 10.0)
    gui_show_global = gui.add_checkbox("Global", not use_local_head)
    gui_show_local = gui.add_checkbox("Local", use_local_head)
    gui_show_frustums = gui.add_checkbox("Show Cameras", True)
    gui_show_high = gui.add_checkbox("Show High-Conf Views", True)
    gui_show_low = gui.add_checkbox("Show Low-Conf Views", False)
    gui_conf_gate = gui.add_slider("High/Low Conf Threshold", 1.0, 12.0, 0.1,
                                   global_conf_thr_value_to_drop_view)
    gui_percentile = gui.add_slider("Per-View Conf Percentile", 0.0, 99.0,
                                    1.0, conf_percentile)
    btn_gif = gui.add_button("Render a GIF")
    btn_ply = gui.add_button("Download PLY")

    # ---- the scene's nodes -----------------------------------------------
    frames = _per_frame_clouds(views, preds, conf_percentile,
                               mask_sky=False, conf_colors=False,
                               by_view_colors=False)
    all_pts = np.concatenate(
        [f[h]["points"] for f in frames for h in ("global", "local")
         if h in f] or [np.zeros((1, 3))])
    max_extent = float(np.max(np.ptp(all_pts, axis=0))) or 1.0

    poses, focals = estimate_camera_poses(preds, device=device)
    frame_data = []
    for i, f in enumerate(frames):
        fd = {"mean_conf": f.get("local", f.get("global",
                                                {"mean_conf": 1.0}))
              ["mean_conf"]}
        for head in ("global", "local"):
            if head not in f:
                continue
            fd[f"point_node_{head}"] = server.scene.add_point_cloud(
                f"/frames/{i}/points_{head}",
                points=f[head]["points"], colors=f[head]["colors"],
                point_size=point_size)
        img = f["img"]
        h, w = img.shape[:2]
        c2w = np.asarray(poses[0][i])
        fd["frustum_node"] = server.scene.add_camera_frustum(
            f"/frames/{i}/camera",
            fov=2 * np.arctan2(h / 2, float(focals[0][i] or max(h, w))),
            aspect=w / h,
            scale=max_extent * (gui_frustum_size.value / 100.0),
            wxyz=tf.SO3.from_matrix(c2w[:3, :3]).wxyz,
            position=c2w[:3, 3],
            image=np.clip(img * 0.5 + 0.5, 0, 1))
        frame_data.append(fd)

    # ---- visibility: frames up to the timestep, gated by confidence -------
    def update_visibility(_evt=None) -> None:
        t = int(gui_timestep.value)
        for i, fd in enumerate(frame_data):
            high = fd["mean_conf"] >= float(gui_conf_gate.value)
            conf_ok = (high and gui_show_high.value) or \
                      (not high and gui_show_low.value)
            show = (i <= t) and conf_ok
            if "point_node_global" in fd:
                fd["point_node_global"].visible = \
                    show and gui_show_global.value
            if "point_node_local" in fd:
                fd["point_node_local"].visible = show and gui_show_local.value
            fd["frustum_node"].visible = show and gui_show_frustums.value

    def rebuild(_evt=None) -> None:
        new = _per_frame_clouds(
            views, preds, float(gui_percentile.value),
            mask_sky=bool(gui_mask_sky.value),
            conf_colors=bool(gui_show_conf.value),
            by_view_colors=bool(gui_by_view.value))
        for fd, f in zip(frame_data, new):
            for head in ("global", "local"):
                node = fd.get(f"point_node_{head}")
                if node is not None and head in f:
                    node.points = f[head]["points"]
                    node.colors = f[head]["colors"]
        update_visibility()

    def set_point_size(_evt=None) -> None:
        for fd in frame_data:
            for head in ("global", "local"):
                node = fd.get(f"point_node_{head}")
                if node is not None:
                    node.point_size = float(gui_point_size.value)

    def set_frustum_size(_evt=None) -> None:
        for fd in frame_data:
            fd["frustum_node"].scale = max_extent * (
                float(gui_frustum_size.value) / 100.0)

    def step_frame(delta: int):
        gui_timestep.value = int(
            (int(gui_timestep.value) + delta) % max(num_frames, 1))
        update_visibility()

    def visible_scene() -> Dict:
        """The merged cloud of the visible nodes."""
        pts, cols = [], []
        for fd in frame_data:
            for head in ("global", "local"):
                node = fd.get(f"point_node_{head}")
                if node is not None and getattr(node, "visible", True) \
                        and len(node.points):
                    pts.append(np.asarray(node.points))
                    cols.append(np.asarray(node.colors))
        return {
            "points": np.concatenate(pts) if pts else np.zeros((0, 3)),
            "colors": np.concatenate(cols) if cols else np.zeros((0, 3)),
        }

    def render_gif(_evt=None) -> str:
        path = os.path.join(tempfile.gettempdir(),
                            f"fast3r_viser_{port}.gif")
        return render_scene_gif(visible_scene(), path, n_frames=12,
                                hw=(240, 320))

    def download_ply(_evt=None) -> str:
        from fast3r_torch.serve.ply import write_ply

        path = os.path.join(tempfile.gettempdir(),
                            f"fast3r_viser_{port}.ply")
        scene = visible_scene()
        write_ply(path, scene["points"], scene["colors"])
        return path

    gui_timestep.on_update(update_visibility)
    for ctl in (gui_show_global, gui_show_local, gui_show_frustums,
                gui_show_high, gui_show_low, gui_conf_gate):
        ctl.on_update(update_visibility)
    for ctl in (gui_percentile, gui_mask_sky, gui_show_conf, gui_by_view):
        ctl.on_update(rebuild)
    gui_point_size.on_update(set_point_size)
    gui_frustum_size.on_update(set_frustum_size)
    gui_next.on_click(lambda _e: step_frame(1))
    gui_prev.on_click(lambda _e: step_frame(-1))
    btn_gif.on_click(render_gif)
    btn_ply.on_click(download_ply)

    update_visibility()

    # playback: a daemon thread steps the timestep while Playing is checked
    stop = threading.Event()

    def playback_loop():
        while not stop.is_set():
            if gui_playing.value:
                step_frame(1)
            time.sleep(1.0 / max(float(gui_fps.value), 0.25))

    player = threading.Thread(target=playback_loop, daemon=True)
    player.start()

    server._fast3r = {
        "frame_data": frame_data,
        "update_visibility": update_visibility,
        "rebuild": rebuild,
        "step_frame": step_frame,
        "visible_scene": visible_scene,
        "render_gif": render_gif,
        "download_ply": download_ply,
        "stop": stop,
    }

    print(f"viser server on port {port}")
    if blocking:
        try:
            while True:
                time.sleep(1.0)
        finally:
            stop.set()
    return server
