"""K8's host side on the CPU: the tap tables and the tile walk that
``csrc/trunk.cu`` reads (``ops/trunk_kernel.tap_tables``, ``trunk_plan``,
``coarse_windows``), and the trunk's plain version against fast3r_tpu's
Pallas trunk kernel at the flagship's trunk widths.

The head shapes are every view shape ``make_plan`` gives at 512 and 224
over raw shapes of aspect ratios 0.3 to 3.3 (landscape and portrait, the
384x512 and 512x384 views among them); the DPT head hands the trunk its
half-resolution grid.  The ragged shapes are those the CUDA tests give
the kernel, and a downscale whose coarse windows do not fit.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from fast3r_tpu.ops.resize import _interp_taps as jax_interp_taps
from fast3r_torch.ops import trunk_kernel as tk
from fast3r_torch.ops.preprocess import make_plan


def _view_shapes():
    out = set()
    for ratio in np.linspace(0.3, 3.3, 61):
        raw = (1000, max(1, int(round(1000 * ratio))))
        for size in (512, 224):
            out.add(make_plan(raw, size).out_hw)
    return sorted(out)


VIEW_SHAPES = _view_shapes()
HEAD_SHAPES = [((H // 2, W // 2), (H, W)) for H, W in VIEW_SHAPES]
RAGGED = [((7, 9), (16, 21)), ((12, 20), (24, 40)), ((96, 64), (190, 130)),
          ((3, 5), (1, 1)), ((40, 150), (16, 30))]


def test_view_shapes_hold_the_request_shapes():
    assert (384, 512) in VIEW_SHAPES and (512, 384) in VIEW_SHAPES
    assert (224, 224) in VIEW_SHAPES and len(VIEW_SHAPES) > 20


@pytest.mark.parametrize("hw,out_hw", HEAD_SHAPES + RAGGED)
def test_tap_tables_equal_jax_taps(hw, out_hw):
    """The int32 (lo_y, hi_y, lo_x, hi_x) and fp32 (frac_y, frac_x) tables
    equal fast3r_tpu's ``_interp_taps`` exactly."""
    (hh, wc), (H, W) = hw, out_hw
    ti, tf = tk.tap_tables(H, W, hh, wc)
    ly, hy, fy = jax_interp_taps(H, hh)
    lx, hx, fx = jax_interp_taps(W, wc)
    assert ti.dtype == np.int32 and tf.dtype == np.float32
    np.testing.assert_array_equal(ti, np.concatenate([ly, hy, lx, hx]))
    np.testing.assert_array_equal(tf, np.concatenate([fy, fx]))


@pytest.mark.parametrize("hw,out_hw", HEAD_SHAPES + RAGGED)
def test_coarse_windows_hold_every_tap(hw, out_hw):
    """Each conv2 band's window holds the taps of every fine row / column
    its halo reads (the band, one more on each side, clipped); at the head
    shapes every window fits, so conv2 builds its halos from one in shared
    memory."""
    (hh, wc), (H, W) = hw, out_hw
    r0, nr, c0, nc = tk.coarse_windows(hh, wc, H, W)
    for lo_t, hi_t, n_out, size, first, count in (
            (*jax_interp_taps(H, hh)[:2], H, tk.TILE_ROWS, r0, nr),
            (*jax_interp_taps(W, wc)[:2], W, tk.TILE_COLS, c0, nc)):
        for b, (s0, n) in enumerate(zip(first, count)):
            f = np.arange(b * size - 1, b * size + size + 1)
            f = f[(f >= 0) & (f < n_out)]
            assert s0 <= lo_t[f].min() and hi_t[f].max() <= s0 + n - 1
    plan = tk.trunk_plan(2, hh, wc, H, W, sms=132)
    assert plan.windowed == (nr.max() <= tk.WIN_ROWS and nc.max() <= tk.WIN_COLS)
    if (hw, out_hw) in HEAD_SHAPES:
        assert plan.windowed
    if out_hw == (16, 30):
        assert not plan.windowed  # the road that reads the taps from memory


@pytest.mark.parametrize("n,hw,out_hw,sms", [
    (2, (7, 9), (16, 21), 132), (1, (12, 20), (24, 40), 132),
    (3, (96, 64), (190, 130), 5), (1, (3, 5), (1, 1), 132),
    (0, (12, 20), (24, 40), 132), (20, (192, 256), (384, 512), 132),
    (6, (256, 192), (512, 384), 132), (20, (192, 256), (384, 512), 7)])
def test_walk_covers_every_output_pixel_once(n, hw, out_hw, sms):
    """Both launches' persistent walks (CTA b: tiles b, b + grid, ...) put
    every output pixel in exactly one tile, on a grid of at most one CTA an
    SM."""
    (hh, wc), (H, W) = hw, out_hw
    plan = tk.trunk_plan(n, hh, wc, H, W, sms)
    for walk, (h, w) in ((plan.conv1, (hh, wc)), (plan.conv2, (H, W))):
        assert walk.grid == min(walk.tiles, sms)
        seen = np.zeros((n, h, w), np.int32)
        for cta in range(walk.grid):
            for t in walk.tiles_of(cta):
                img, y0, x0 = walk.origin(t)
                assert y0 < h and x0 < w  # no empty tile
                seen[img, y0:y0 + tk.TILE_ROWS, x0:x0 + tk.TILE_COLS] += 1
        assert np.all(seen == 1)


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1))))


@pytest.mark.parametrize("hw,out_hw", [((16, 24), (32, 48)),
                                       ((24, 16), (48, 32))])
def test_trunk_plain_matches_jax_kernel_at_flagship_widths(hw, out_hw):
    """The port's plain trunk (the kernel's plain version) against
    fast3r_tpu's ``fused_regression_head_t`` (its Pallas kernel in interpret
    mode) at Cin 256 and 128 trunk channels, a landscape and a portrait
    grid.  fp32, 1e-4 relative / 1e-5 absolute (the JAX trunk tests')."""
    from jax.experimental.pallas import tpu as pltpu

    from fast3r_tpu.ops.trunk_kernel import fused_regression_head_t

    (hh, wc), (H, W) = hw, out_hw
    rng = np.random.default_rng(7)
    cin, c1 = 256, 128
    x = (rng.standard_normal((2, hh, wc, cin)) * 0.3).astype(np.float32)
    w1 = (rng.standard_normal((3, 3, cin, c1)) * 0.03).astype(np.float32)
    b1 = (rng.standard_normal((c1,)) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((3, 3, c1, c1)) * 0.05).astype(np.float32)
    b2 = (rng.standard_normal((c1,)) * 0.1).astype(np.float32)
    w3 = (rng.standard_normal((1, 1, c1, 4)) * 0.05).astype(np.float32)
    b3 = (rng.standard_normal((4,)) * 0.1).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(fused_regression_head_t(
            *map(jnp.asarray, (x, w1, b1, w2, b2, w3, b3)), H, W))
    got = tk.fused_regression_head_t(
        torch.from_numpy(x), _oihw(w1), torch.from_numpy(b1), _oihw(w2),
        torch.from_numpy(b2), _oihw(w3), torch.from_numpy(b3), H, W)
    assert got.shape == (2, 4, H * W)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)
