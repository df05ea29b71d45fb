"""RobustMVD multi-view depth evaluation.

Counterpart of ``scripts/robustmvd_eval.py`` (reference
scripts/robustmvd_eval.py): a ``Fast3RWrapperModel`` adapter (input_adapter
/ forward / output_adapter) that plugs Fast3R into the external ``rmvd``
benchmark; the predicted depth is the keyview pointmap's z and the depth
uncertainty the inverse of the confidence.

With ``--rmvd`` the ``rmvd`` package runs its benchmark (its import raises
where the package is absent); without it, a built-in loop over directories
of {images, GT depth} computes the standard robustmvd metrics (absrel,
inliers@1.03 after median scale alignment).

    python -m fast3r_torch.cli.robustmvd_eval --checkpoint HF_DIR \
        [--rmvd --dataset kitti ...] | [--data-root DIR] [--views N] \
        [--device cuda|cpu]

The model runs on the card in bfloat16 unless ``--device cpu`` is given
(float32).
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np


class Fast3RWrapperModel:
    """rmvd custom-model adapter (reference robustmvd_eval.py:54-210)."""

    name = "Fast3R"

    def __init__(self, model):
        self.model = model

    def input_adapter(self, images, keyview_idx, poses=None, intrinsics=None,
                      depth_range=None):
        import PIL.Image

        from fast3r_torch.utils.image import img_norm

        if not isinstance(images, list):
            raise TypeError("images must be a list of (1,3,H,W) arrays")
        views = []
        for arr in images:
            arr = np.asarray(arr)
            if arr.ndim != 4 or arr.shape[0] != 1 or arr.shape[1] != 3:
                raise ValueError(f"image of shape {arr.shape}, want "
                                 "(1, 3, H, W)")
            pil = PIL.Image.fromarray(
                arr[0].astype(np.uint8).transpose(1, 2, 0))
            views.append({
                "img": img_norm(pil)[None],
                "true_shape": np.int32([[pil.size[1], pil.size[0]]]),
            })
        return {
            "list_of_views": views,
            "keyview_idx": int(keyview_idx) if np.ndim(keyview_idx) == 0
            else int(np.asarray(keyview_idx).reshape(-1)[0]),
        }

    def forward(self, list_of_views=None, keyview_idx=0):
        from fast3r_torch.inference import inference

        if list_of_views is None:
            return {}
        out = inference(list_of_views, self.model, verbose=False)
        out["keyview_idx"] = keyview_idx
        return out

    def output_adapter(self, model_output):
        if not model_output or "preds" not in model_output:
            return {}, {}
        preds = model_output["preds"]
        keyidx = model_output.get("keyview_idx", 0)
        if keyidx >= len(preds):
            keyidx = 0
        ref = preds[keyidx]
        pts3d = np.asarray(ref["pts3d_in_other_view"], np.float32)  # (1,H,W,3)
        conf = np.asarray(ref["conf"], np.float32)                   # (1,H,W)
        depth = pts3d[..., 2][:, None]                               # (1,1,H,W)
        uncertainty = (1.0 / np.maximum(conf, 1.0))[:, None]
        return {"depth": depth, "depth_uncertainty": uncertainty}, {}

    def run(self, images, keyview_idx=0, **kw):
        sample = self.input_adapter(images, keyview_idx, **kw)
        return self.output_adapter(self.forward(**sample))


def depth_metrics(pred, gt, valid):
    """Standard robustmvd depth metrics with median scale alignment."""
    p, g = pred[valid], gt[valid]
    if len(g) == 0:
        return None
    scale = np.median(g) / max(np.median(p), 1e-8)
    p = p * scale
    absrel = float(np.mean(np.abs(p - g) / g))
    inliers_103 = float(np.mean(np.maximum(p / g, g / p) < 1.03))
    return {"absrel": absrel, "inliers_1.03": inliers_103,
            "scale": float(scale)}


def builtin_eval(adapter, data_root, num_views):
    """Directories of scene/{images/*.jpg|png, depth/*.npy} -> metrics."""
    from fast3r_torch.data.cropping import resize_nearest
    from fast3r_torch.data.io import imread_cv2

    results = {}
    for scene in sorted(os.listdir(data_root)):
        sdir = os.path.join(data_root, scene)
        imgs = sorted(glob.glob(os.path.join(sdir, "images", "*")))[:num_views]
        if len(imgs) < 2:
            continue
        arrays = [imread_cv2(p).astype(np.float32).transpose(2, 0, 1)[None]
                  for p in imgs]
        out, _ = adapter.run(arrays, keyview_idx=0)
        pred_depth = out["depth"][0, 0]
        gt_path = os.path.join(
            sdir, "depth",
            os.path.splitext(os.path.basename(imgs[0]))[0] + ".npy")
        if not os.path.exists(gt_path):
            continue
        gt = np.load(gt_path).astype(np.float32)
        if gt.shape != pred_depth.shape:
            gt = resize_nearest(gt, pred_depth.shape[::-1])
        m = depth_metrics(pred_depth, gt, gt > 0)
        if m:
            results[scene] = m
            print(scene, m)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--rmvd", action="store_true",
                    help="run the external rmvd benchmark")
    ap.add_argument("--dataset", default="kitti")
    ap.add_argument("--data-root", default=None,
                    help="builtin eval: root of scene dirs")
    ap.add_argument("--views", type=int, default=5)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default="robustmvd_results.json")
    args = ap.parse_args(argv)
    if not (args.rmvd or args.data_root):
        ap.error("--data-root required without --rmvd")

    import torch

    from fast3r_torch.utils.checkpoint_utils import load_model

    device = torch.device(args.device, torch.cuda.current_device()
                          if args.device == "cuda" else None)
    adapter = Fast3RWrapperModel(load_model(
        args.checkpoint, device=device,
        dtype=torch.bfloat16 if args.device == "cuda" else torch.float32))

    if args.rmvd:
        import rmvd

        model = rmvd.prepare_custom_model(adapter)
        eval_ = rmvd.create_evaluation(
            evaluation_type="robustmvd", out_dir="rmvd_out",
            inputs=["intrinsics", "poses"])
        dataset = rmvd.create_dataset(args.dataset, "robustmvd", "test")
        results = eval_(dataset=dataset, model=model)
        print(results)
        return results

    results = builtin_eval(adapter, args.data_root, args.views)
    if not results:
        return None
    agg = {k: float(np.mean([m[k] for m in results.values()]))
           for k in next(iter(results.values()))}
    print("AGGREGATE:", json.dumps(agg, indent=2))
    out = {"aggregate": agg, "per_scene": results}
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
