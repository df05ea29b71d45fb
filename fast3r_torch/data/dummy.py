"""Synthetic multiview batches, geometrically consistent, from a seed.

The port's own copy of ``fast3r_tpu/data/dummy.py`` ``make_dummy_batch``
(reference DummyMultiview): a random depth map (about 10% of pixels
invalid) is back-projected through a pinhole camera and random rigid poses,
so world-frame pts3d, valid_mask and camera_pose satisfy what the training
losses expect.  numpy, seeded: the same seed gives the JAX package's batch.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _random_pose(rng) -> np.ndarray:
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    t = np.eye(4, dtype=np.float32)
    t[:3, :3] = q.astype(np.float32)
    t[:3, 3] = rng.standard_normal(3).astype(np.float32)
    return t


def make_dummy_batch(batch_size: int = 1, num_views: int = 4, height: int = 64,
                     width: int = 80, seed: int = 0) -> Dict[str, np.ndarray]:
    """A batch of the train-step contract: imgs (B, V, H, W, 3) in [-1, 1],
    true_shapes (B, V, 2), pts3d (B, V, H, W, 3), valid_mask (B, V, H, W),
    camera_pose (B, V, 4, 4), camera_intrinsics, depthmap."""
    rng = np.random.default_rng(seed)
    B, V, H, W = batch_size, num_views, height, width
    imgs = rng.uniform(-1, 1, size=(B, V, H, W, 3)).astype(np.float32)
    true_shapes = np.tile(np.array([H, W], np.int32), (B, V, 1))
    depth = rng.uniform(1.0, 5.0, size=(B, V, H, W)).astype(np.float32)
    depth *= (rng.random((B, V, H, W)) > 0.1).astype(np.float32)
    f = 0.8 * max(H, W)
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    poses = np.stack([np.stack([_random_pose(rng) for _ in range(V)])
                      for _ in range(B)])
    xs, ys = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32))
    pts_cam = np.stack([depth * (xs - W / 2) / f, depth * (ys - H / 2) / f,
                        depth], axis=-1)
    pts3d = (np.einsum("bvik,bvhwk->bvhwi", poses[..., :3, :3], pts_cam)
             + poses[..., None, None, :3, 3])
    return {
        "imgs": imgs,
        "true_shapes": true_shapes,
        "pts3d": pts3d.astype(np.float32),
        "valid_mask": depth > 0,
        "camera_pose": poses,
        "camera_intrinsics": np.tile(K, (B, V, 1, 1)),
        "depthmap": depth,
    }
