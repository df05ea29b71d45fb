"""Headless reconstruction CLI: images or a video -> pointmaps, poses and
a PLY.

Counterpart of ``fast3r_tpu/cli/reconstruct.py``, the serving path of the
reference demo without its UI: load the images, run the model, align the
local head onto the global one, recover the cameras, write the cloud.

    python -m fast3r_torch.cli.reconstruct IMAGE_DIR --out OUT_DIR \
        [--checkpoint DIR] [--size 512] [--device cuda|cpu]

IMAGE_DIR may be a video (.mp4, .mov, .avi, .webm): its frames, two a
second, are extracted into OUT_DIR/frames by ``ffmpeg``
(``serve/video.py``; without ``ffmpeg`` on PATH it raises).  A folder
whose frames share one raw shape goes through ``inference_from_raw``
(resize and crop on the device); mixed raw shapes, or
``--host-preprocess``, through ``load_images`` and ``inference``.
Without ``--checkpoint`` the weights are random (seed 0): the flagship's on
the card, whose kernels take the flagship's widths only, and the tiny
configuration's on the CPU.  Writes scene.ply (the merged coloured cloud),
poses.json (per-view c2w and focals), with ``--gif`` orbit.gif (an orbit
of the cloud, rendered on the host) and, with ``--save-npz``, one .npz of
pointmaps per view.  ``--backend cv2`` is not ported.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Fast3R reconstruction")
    ap.add_argument("images", help="image folder or video file")
    ap.add_argument("--out", default="recon_out")
    ap.add_argument("--checkpoint", default=None,
                    help="HF-format checkpoint dir or a fast3r_torch run "
                         "dir; random weights if omitted")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--backend", default="torch", choices=["torch"],
                    help="pose extraction: batched RANSAC-PnP on the device "
                         "(the cv2 backend is not ported)")
    ap.add_argument("--conf-percentile", type=float, default=10.0)
    ap.add_argument("--frame", type=int, default=None,
                    help="export only frames [0..FRAME]")
    ap.add_argument("--head", default="local", choices=["local", "global"],
                    help="point source: the aligned local head (default) or "
                         "the global head")
    ap.add_argument("--mask-sky", action="store_true")
    ap.add_argument("--save-npz", action="store_true")
    ap.add_argument("--gif", action="store_true",
                    help="also render an orbit GIF of the merged cloud")
    ap.add_argument("--color-mode", default="rgb", choices=["rgb", "conf"],
                    help="point colors: image RGB or confidence heatmap")
    ap.add_argument("--host-preprocess", action="store_true",
                    help="resize / crop / normalise on the host with PIL "
                         "instead of on the device")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from fast3r_torch.eval.pose import estimate_camera_poses
    from fast3r_torch.eval.recon import align_local_pts3d_to_global
    from fast3r_torch.inference import Fast3R, inference, inference_from_raw
    from fast3r_torch.models.fast3r import Fast3RConfig
    from fast3r_torch.serve.visualizer import (
        assemble_scene,
        confidence_colors,
        export_scene_ply,
        render_scene_gif,
    )
    from fast3r_torch.utils.image import load_images, load_images_raw

    dev = torch.device(args.device)
    times = {}
    src = args.images
    if src.lower().endswith((".mp4", ".mov", ".avi", ".webm")):
        from fast3r_torch.serve.video import extract_frames_from_video

        src = extract_frames_from_video(src, os.path.join(args.out, "frames"))

    def mark(stage: str, t0: float) -> float:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t = time.perf_counter()
        times[stage] = t - t0
        return t

    if args.checkpoint:
        from fast3r_torch.utils.checkpoint_utils import load_model

        dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
        model = load_model(args.checkpoint, dtype=dtype, device=dev)
    else:
        print("WARNING: no checkpoint given; using random weights (smoke run)")
        if dev.type == "cuda":
            model = Fast3R.from_random(Fast3RConfig.flagship(), seed=0,
                                       dtype=torch.bfloat16, device=dev)
        else:
            model = Fast3R.from_random(Fast3RConfig.tiny(), seed=0,
                                       device=dev)

    t = time.perf_counter()
    raw = None
    if not args.host_preprocess:
        frames = load_images_raw(src, verbose=True)
        if len({f.shape for f in frames}) == 1:
            raw = frames
        else:
            print(" (mixed raw shapes -> host preprocessing)")
    if raw is None:
        views = load_images(src, size=args.size)
    t = mark("load_s", t)
    if raw is not None:
        result = inference_from_raw(raw, model, size=args.size)
        views = result["views"]
    else:
        result = inference(views, model)
    preds = result["preds"]
    t = mark("forward_s", t)
    align_local_pts3d_to_global(preds, min_conf_thr_percentile=85.0,
                                device=dev)
    t = mark("align_s", t)
    poses, focals = estimate_camera_poses(preds, backend=args.backend,
                                          device=dev)
    t = mark("pose_s", t)

    os.makedirs(args.out, exist_ok=True)
    scene_views, scene_preds = views, preds
    if args.frame is not None:
        n = max(0, min(args.frame, len(views) - 1)) + 1
        scene_views, scene_preds = views[:n], preds[:n]
    scene = assemble_scene(scene_views, scene_preds,
                           use_local_head=args.head == "local",
                           conf_percentile=args.conf_percentile,
                           mask_sky=args.mask_sky)
    if args.color_mode == "conf":
        local = args.head == "local"
        scene["colors"] = confidence_colors(np.concatenate([
            np.asarray(p["conf_local" if local else "conf"])[0][f["mask"]]
            for p, f in zip(scene_preds, scene["per_frame"])]))
    ply_path = export_scene_ply(os.path.join(args.out, "scene.ply"), scene)
    with open(os.path.join(args.out, "poses.json"), "w") as f:
        json.dump({"poses_c2w": [p.tolist() for p in poses[0]],
                   "focals": [float(x) for x in focals[0]]}, f, indent=2)
    if args.save_npz:
        for i, p in enumerate(preds):
            np.savez(os.path.join(args.out, f"view_{i:04d}.npz"),
                     **{k: np.asarray(v) for k, v in p.items()})
    t = mark("ply_s", t)
    if args.gif:
        render_scene_gif(scene, os.path.join(args.out, "orbit.gif"))
        mark("gif_s", t)
    print(f"wrote {ply_path} ({len(scene['points'])} points) and poses.json")
    print(json.dumps({"stage_times": times}))
    return {"views": views, "preds": preds, "poses": poses, "focals": focals,
            "points": len(scene["points"]), "times": times}


if __name__ == "__main__":
    main()
