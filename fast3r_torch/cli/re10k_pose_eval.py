"""RealEstate10K camera-pose evaluation.

Counterpart of ``scripts/re10k_pose_eval.py`` (reference
scripts/fast3r_re10k_pose_eval.py): for each test scene, sample up to 10
frames, parse the RealEstate10K txt (line: frame_id fx fy cx cy _ _ +
row-major 3x4 w2c extrinsic; intrinsics normalised by the image size),
invert to c2w ground truth, crop / resize the frames to 512x288 around the
principal point, run the model, estimate poses (focal from the first view's
global head, RANSAC-PnP with niter=100) and report RRA / RTA at 5, 15, 30
degrees and mAA(30) averaged over scenes.  Scene list:
``fast3r_torch/configs/re10k_test_1800.txt`` (the reference's, data).

    python -m fast3r_torch.cli.re10k_pose_eval --video-root DIR \
        --txt-root DIR --checkpoint HF_DIR [--scene-list FILE] \
        [--max-scenes N] [--device cuda|cpu]

The model runs on the card in bfloat16 unless ``--device cpu`` is given
(float32).  The pose backend is the port's torch one (JAX's cv2 backend
has no counterpart here: the card's machine has no cv2).
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np

SCENE_LIST = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "re10k_test_1800.txt")


def crop_resize_for_re10k(pil_img, K, target_resolution=(512, 288)):
    """Principal-point-centred crop + rescale (reference :84-134)."""
    from fast3r_torch.data import cropping

    W, H = pil_img.size
    cx, cy = int(round(K[0, 2])), int(round(K[1, 2]))
    mx, my = min(cx, W - cx), min(cy, H - cy)
    img, _, K = cropping.crop_image_depthmap(
        pil_img, None, K, (cx - mx, cy - my, cx + mx, cy + my))
    img, _, K = cropping.rescale_image_depthmap(
        img, None, K, np.array(target_resolution))
    K2 = cropping.camera_matrix_of_crop(K, img.size, target_resolution,
                                        offset_factor=0.5)
    bbox = cropping.bbox_from_intrinsics_in_out(K, K2, target_resolution)
    img, _, K = cropping.crop_image_depthmap(img, None, K, bbox)
    return img, K


def parse_re10k_txt(txt_path):
    """frame_id -> (K_normalized(fx, fy, cx, cy), c2w 4x4)."""
    with open(txt_path) as f:
        lines = f.read().strip().split("\n")[1:]  # skip URL line
    out = {}
    for line in lines:
        parts = line.strip().split()
        if len(parts) < 19:
            continue
        frame_id = parts[0]
        fx, fy, cx, cy = (float(x) for x in parts[1:5])
        ext = np.array([float(v) for v in parts[7:19]],
                       np.float64).reshape(3, 4)
        w2c = np.eye(4, dtype=np.float64)
        w2c[:3, :4] = ext
        out[frame_id] = ((fx, fy, cx, cy),
                         np.linalg.inv(w2c).astype(np.float32))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--video-root", required=True)
    ap.add_argument("--txt-root", required=True)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--scene-list", default=SCENE_LIST)
    ap.add_argument("--max-scenes", type=int, default=None)
    ap.add_argument("--num-frames", type=int, default=10)
    ap.add_argument("--backend", default="torch", choices=["torch"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default="re10k_results.json")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import PIL.Image
    import torch

    from fast3r_torch.data.io import imread_cv2
    from fast3r_torch.eval.pose import estimate_camera_poses
    from fast3r_torch.eval.pose_metrics import pose_metrics
    from fast3r_torch.inference import forward_views
    from fast3r_torch.utils.checkpoint_utils import load_model
    from fast3r_torch.utils.image import img_norm

    device = torch.device(args.device, torch.cuda.current_device()
                          if args.device == "cuda" else None)
    model = load_model(args.checkpoint, device=device,
                       dtype=torch.bfloat16 if args.device == "cuda"
                       else torch.float32)
    rng = np.random.default_rng(args.seed)

    with open(args.scene_list) as f:
        scenes = f.read().split()
    if args.max_scenes:
        scenes = scenes[: args.max_scenes]

    per_scene = {}
    for scene in scenes:
        folder = os.path.join(args.video_root, scene)
        txt_path = os.path.join(args.txt_root, scene + ".txt")
        if not (os.path.isdir(folder) and os.path.exists(txt_path)):
            continue
        lines_map = parse_re10k_txt(txt_path)
        frames = sorted(glob.glob(os.path.join(folder, "*.jpg")))
        if len(frames) < 2:
            continue
        n = min(args.num_frames, len(frames))
        sampled = sorted(rng.choice(frames, size=n, replace=False))

        views, gt_poses = [], []
        for fp in sampled:
            base = os.path.splitext(os.path.basename(fp))[0]
            if base not in lines_map:
                continue
            (fx, fy, cx, cy), c2w = lines_map[base]
            img = imread_cv2(fp)
            H0, W0 = img.shape[:2]
            K = np.array([[fx * W0, 0, cx * W0], [0, fy * H0, cy * H0],
                          [0, 0, 1]], np.float32)
            pil, K = crop_resize_for_re10k(PIL.Image.fromarray(img), K)
            views.append({
                "img": img_norm(pil)[None],
                "true_shape": np.int32([[pil.size[1], pil.size[0]]]),
            })
            gt_poses.append(c2w)
        if len(views) < 2:
            continue

        preds = forward_views(model, views)
        poses, _ = estimate_camera_poses(
            preds, niter_PnP=100,
            focal_length_estimation_method="first_view_from_global_head",
            backend=args.backend, device=device,
        )
        m = pose_metrics(np.stack(poses[0]), np.stack(gt_poses))
        per_scene[scene] = m
        print(scene, {k: round(v, 4) for k, v in m.items()})

    if not per_scene:
        print("no scenes evaluated — check --video-root/--txt-root")
        return None
    agg = {k: float(np.mean([m[k] for m in per_scene.values()]))
           for k in next(iter(per_scene.values()))}
    print("AGGREGATE over", len(per_scene), "scenes:",
          json.dumps(agg, indent=2))
    result = {"aggregate": agg, "per_scene": per_scene}
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main()
