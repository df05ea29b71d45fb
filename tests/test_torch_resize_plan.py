"""The resize kernel's band plan (``ops/resize_kernel.band_plan``) on the
CPU: over every head shape ``make_plan`` gives at size 512 (landscape and
portrait, the long side 512 and the short side a multiple of 16) and at
224 (a 224 square), each resized from half its size as the DPT trunk does,
and over the shapes the CUDA tests give the kernel.

The plan is what ``csrc/resize.cu`` walks: each item stages the input rows
``lo_h[first] .. hi_h[last]`` of its band of output rows and the input
columns its band of output columns reads, in shared memory it sizes.
"""

import numpy as np
import pytest

from fast3r_torch.ops import resize_kernel as t_rk
from fast3r_torch.ops.resize import _interp_taps


def _head_shapes():
    shorts = range(160, 513, 16)
    out = [(h, 512) for h in shorts] + [(512, w) for w in shorts] + [(224, 224)]
    return [((H // 2, W // 2), (H, W)) for H, W in out]


CUDA_TEST_SHAPES = [((256, 256), (512, 512)), ((224, 256), (448, 512)),
                    ((40, 56), (81, 117)), ((96, 64), (48, 32)),
                    ((45, 37), (90, 74)), ((256, 248), (512, 496)),
                    ((64, 96), (150, 200))]
SHAPES = _head_shapes() + CUDA_TEST_SHAPES


def _check_plan(hw, out_hw, aligned):
    (h, w), (H, W) = hw, out_hw
    p = t_rk.band_plan(h, w, H, W, aligned)
    lo_h, hi_h, _ = _interp_taps(H, h)
    lo_w, hi_w, _ = _interp_taps(W, w)
    # the row bands partition the output rows, and each stages the input
    # rows of its rows' taps, within a stage
    i0, i1, r0, r1 = t_rk.staged_rows(p.rows, H, h)
    assert i0[0] == 0 and i1[-1] == H and np.all(i1[:-1] == i0[1:])
    assert np.all(i1 > i0) and np.all(i1 - i0 <= p.rows)
    for a, b, s0, s1 in zip(i0, i1, r0, r1):
        assert s0 <= lo_h[a:b].min() and hi_h[a:b].max() <= s1
        assert s1 - s0 + 1 <= p.stage_rows
    # the column bands partition the output columns, and each stages the
    # input columns of its columns' taps, within a row's pitch; on the bulk
    # road every row copy is 16-byte aligned and a multiple of 16 bytes
    j0, j1, c0, span = t_rk.staged_cols(p.cols, W, w, p.bulk)
    assert j0[0] == 0 and j1[-1] == W and np.all(j1[:-1] == j0[1:])
    for a, b, s0, n in zip(j0, j1, c0, span):
        assert s0 <= lo_w[a:b].min() and hi_w[a:b].max() < s0 + n
        assert 0 <= s0 and s0 + n <= w and n <= p.pitch
        if p.bulk:
            assert s0 % 8 == 0 and (2 * n) % 16 == 0
    assert p.pitch % 8 == 0
    assert p.bulk == (aligned and w % 8 == 0)
    assert p.stages == (t_rk.STAGES if p.bulk else 1)
    assert p.smem_bytes == t_rk.smem_bytes(p.rows, p.cols, p.stage_rows,
                                           p.pitch, p.stages)
    assert p.smem_bytes <= t_rk.SMEM_LIMIT  # 227 KB
    return p


@pytest.mark.parametrize("hw,out_hw", SHAPES)
def test_band_plan_covers_the_taps(hw, out_hw):
    p = _check_plan(hw, out_hw, aligned=True)
    _check_plan(hw, out_hw, aligned=False)
    # the head's shapes stage whole rows, 32 output rows an item, and leave
    # room for four CTAs an SM
    assert p.cols == out_hw[1] and p.rows == 32
    assert p.smem_bytes <= t_rk.SMEM_TARGET


def test_band_plan_at_the_request_shapes():
    """The 512x512 and 448x512 heads: 16-byte copies of whole rows, 18
    input rows staged for 32 output rows, the ring's stages."""
    for hw, out_hw in (((256, 256), (512, 512)), ((224, 256), (448, 512))):
        p = t_rk.band_plan(*hw, *out_hw)
        assert (p.rows, p.cols, p.stage_rows, p.pitch, p.stages, p.bulk) == (
            32, out_hw[1], 18, 256, t_rk.STAGES, True)


def test_band_plan_cuts_wide_rows_and_refuses_what_cannot_fit():
    """Rows too wide for shared memory take column bands; a downscale whose
    single output row needs more than 227 KB of input raises."""
    p = _check_plan((4, 100000), (8, 200000), aligned=True)
    assert p.cols < 200000
    with pytest.raises(ValueError, match="shared memory"):
        t_rk.band_plan(3, 1000000, 3, 2)
