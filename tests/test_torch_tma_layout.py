"""The backward kernels' tensor-map layout helper on the CPU.

``fast3r_torch.ops.flash_attention.tma_dims`` gives the rank-4 view,
(64, token, head, batch) innermost first with the strides in elements,
through which the attention backward (K9, and the encoder's packed buffer)
and the backward rings read their inputs by TMA; the C entry points build
their maps from the same strides.  Each case checks, with element ids in
place of values, that ``as_strided`` with those dims and strides reaches
exactly the elements of q / k / v in the layouts the port hands the
kernels, and that a layout TMA cannot take is refused.
"""

import pytest
import torch

from fast3r_torch.ops.flash_attention import tma_dims


def _ids(shape):
    """bf16 zeros for the helper and int64 element ids of the same storage
    layout (the same strides in elements and the same offsets)."""
    return (torch.zeros(shape, dtype=torch.bfloat16),
            torch.arange(torch.Size(shape).numel()).view(shape))


def _reached(ids_view, dims, strides):
    """The ids the rank-4 map reaches, as (B', H, N, D)."""
    return torch.as_strided(ids_view, size=dims[::-1], stride=strides[::-1],
                            storage_offset=ids_view.storage_offset())


def _check(t, ids_view, expect):
    got = tma_dims(t)
    assert got is not None
    dims, strides = got
    assert dims[0] == 64 and strides[0] == 1
    assert torch.equal(_reached(ids_view, dims, strides), expect)


@pytest.mark.parametrize("part", [0, 1, 2])
@pytest.mark.parametrize("B,N,H", [(1, 1536, 16), (3, 129, 2), (2, 50, 4)])
def test_decoder_qkv_views(B, N, H, part):
    """q, k, v as strided views of the decoder's (B, N, 3, H, 64) qkv."""
    buf, ids = _ids((B, N, 3, H, 64))
    t, it = buf[:, :, part], ids[:, :, part]
    _check(t, it, it.permute(0, 2, 1, 3))


@pytest.mark.parametrize("part", [0, 1, 2])
@pytest.mark.parametrize("B,N,C", [(2, 768, 1024), (3, 196, 256)])
def test_packed_buffer_slices(B, N, C, part):
    """q, k, v as (B, N, H, 64) views of one slice of the encoder's packed
    (3, B, N, C) buffer."""
    H = C // 64
    buf, ids = _ids((3, B, N, C))
    t, it = buf[part].view(B, N, H, 64), ids[part].view(B, N, H, 64)
    _check(t, it, it.permute(0, 2, 1, 3))


def test_contiguous():
    buf, ids = _ids((2, 100, 3, 64))
    _check(buf, ids, ids.permute(0, 2, 1, 3))


@pytest.mark.parametrize("part", [0, 1, 2])
@pytest.mark.parametrize("n,B,S,H", [(4, 1, 384, 16), (2, 3, 129, 2),
                                     (1, 2, 100, 2)])
def test_ring_rank_stacked(n, B, S, H, part):
    """The rings' (n, B, S, H, 64) q / k / v, views of (n, B, S, 3, H, 64):
    rank and batch merge into the map's outer dimension, rank-major."""
    buf, ids = _ids((n, B, S, 3, H, 64))
    t, it = buf[:, :, :, part], ids[:, :, :, part]
    expect = torch.stack([it[r, b] for r in range(n) for b in range(B)])
    _check(t, it, expect.permute(0, 2, 1, 3))


def test_ring_single_batch_takes_the_rank_stride():
    """B = 1 merges whatever the rank stride: a rank-strided slice."""
    buf, ids = _ids((4, 2, 80, 2, 64))
    t, it = buf[:, :1], ids[:, :1]
    _check(t, it, it[:, 0].permute(0, 2, 1, 3))


def test_refused_layouts():
    """Head dim not contiguous, a stride not a multiple of 16 bytes, a base
    off 16 bytes, and rank / batch strides that do not merge."""
    x = torch.zeros((2, 10, 4, 64), dtype=torch.bfloat16)
    assert tma_dims(x.transpose(2, 3)) is None
    padded = torch.zeros((2, 10, 4, 68), dtype=torch.bfloat16)[..., :64]
    assert tma_dims(padded) is None
    flat = torch.zeros(2 * 10 * 4 * 64 + 4, dtype=torch.bfloat16)
    assert tma_dims(flat[4:].view(2, 10, 4, 64)) is None
    # (2 ranks, 3 batches) whose rank stride is below the batch stride
    swapped = torch.zeros((3, 2, 16, 2, 64),
                          dtype=torch.bfloat16).transpose(0, 1)
    assert tma_dims(swapped) is None
    assert tma_dims(torch.zeros((10, 4, 64), dtype=torch.bfloat16)) is None
