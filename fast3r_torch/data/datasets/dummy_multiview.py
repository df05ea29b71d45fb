"""Synthetic multiview dataset — no data on disk required.

Counterpart of ``fast3r_tpu/data/datasets/dummy_multiview.py``.  Behavioral
reference: fast3r/dust3r/datasets/dummy_multiview.py:11-67
(DummyMultiview): random image/depth/pose/intrinsics tensors shaped like
ARKitScenes, used to smoke-test the model+data pipeline.  This version routes
through the full BaseViewDataset path (crop/resize/pts3d/transpose) so it
exercises the real preprocessing, not just tensor shapes.
"""

from __future__ import annotations

import numpy as np
import PIL.Image

from fast3r_torch.data.base import BaseViewDataset
from fast3r_torch.data.dsl import register_dataset


@register_dataset
class DummyMultiview(BaseViewDataset):
    def __init__(self, num_scenes: int = 100, num_views: int = 4,
                 source_size=(256, 192), **kwargs):
        super().__init__(num_views=num_views, **kwargs)
        self.source_size = tuple(source_size)  # (W, H) of the fake captures
        self.scenes = [f"dummy_scene_{i:04d}" for i in range(num_scenes)]

    def _get_views(self, idx, resolution, rng):
        W, H = self.source_size
        views = []
        for v in range(self.num_views):
            img = PIL.Image.fromarray(
                rng.integers(0, 255, size=(H, W, 3), dtype=np.uint8)
            )
            depthmap = rng.uniform(1.0, 4.0, size=(H, W)).astype(np.float32)
            depthmap *= (rng.random((H, W)) > 0.05).astype(np.float32)
            f = 0.9 * max(W, H)
            intrinsics = np.array(
                [[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32
            )
            angle = 0.1 * v
            c, s = np.cos(angle), np.sin(angle)
            pose = np.eye(4, dtype=np.float32)
            pose[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]],
                                    np.float32)
            pose[:3, 3] = rng.standard_normal(3).astype(np.float32) * 0.1

            img, depthmap, intrinsics = self._crop_resize_if_necessary(
                img, depthmap, intrinsics, resolution, rng=rng,
                info=f"{self.scenes[idx]}/{v}",
            )
            views.append(dict(
                img=img,
                depthmap=depthmap,
                camera_pose=pose,
                camera_intrinsics=intrinsics,
                dataset="DummyMultiview",
                label=self.scenes[idx],
                instance=str(v),
            ))
        return views
