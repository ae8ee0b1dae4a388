"""The host-side tiling plans of the port's wgmma kernels, on the CPU.

``conv3x3.conv_plan`` (csrc/conv3x3.cu) and ``wconv.dw_plan``
(csrc/wconv_dw.cu) decide the boxes that TMA loads and the grid; the kernels
trust them.  Across the shapes that the inference, training and dense-K
paths and the card tests give the kernels: the boxes cover every voxel of the
volume exactly once, dw's chunks cover every box exactly once and in order,
and every TMA box is within TMA's limits.
"""

import numpy as np
import pytest
import torch

from neuroclear_tpu_torch.ops import conv3x3, wconv

# (B, D, H, W) of the paths: the inference tile batch (2 x 140^3) and its
# half and quarter resolutions, the 108^3 training step and its halves, the
# test_dice CLI tests' tiles, and the ragged card-test shapes
PATH_SHAPES = [(2, 140, 140, 140), (2, 70, 70, 70), (2, 35, 35, 35), (1, 108, 108, 108),
               (1, 54, 54, 54), (1, 27, 27, 27), (1, 24, 24, 24), (1, 16, 16, 16)]
RAGGED_SHAPES = [(1, 3, 5, 6), (2, 4, 3, 10), (1, 5, 7, 10), (1, 2, 2, 4), (1, 9, 11, 12),
                 (1, 5, 7, 33), (1, 2, 2, 3), (1, 6, 4, 32), (1, 1, 9, 17), (2, 2, 7, 5),
                 (1, 20, 24, 36), (1, 19, 23, 52), (1, 1, 1, 1)]
SHAPES = PATH_SHAPES + RAGGED_SHAPES


def _coverage(shape, box, counts, box_ids) -> np.ndarray:
    """How often each voxel of (B, D, H, W) lies in one of the boxes
    ``box_ids``, numbered x fastest, then y, z and the batch."""
    b, d, h, w = shape
    bz, by, bx = box
    nz, ny, nx = counts
    hits = np.zeros((b, d, h, w), dtype=np.int32)
    for i in box_ids:
        ix, rest = i % nx, i // nx
        iy, rest = rest % ny, rest // ny
        iz, ib = rest % nz, rest // nz
        hits[ib, iz * bz:(iz + 1) * bz, iy * by:(iy + 1) * by, ix * bx:(ix + 1) * bx] += 1
    return hits


def _within_tma_limits(box: tuple, swizzle_bytes: int) -> bool:
    """Every extent within 1..256; the bf16 innermost extent a whole number
    of 16-byte units and, under a swizzle, within its span."""
    inner = box[0] * 2
    return (all(1 <= e <= conv3x3.TMA_BOX_MAX for e in box) and inner % 16 == 0
            and (swizzle_bytes == 0 or inner <= swizzle_bytes))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("cin", [32, 64, 96, 128, 256])
def test_conv_plan_covers_each_output_voxel_once(shape, cin):
    for cout in (32, 64, 96, 128):
        plan = conv3x3.conv_plan(shape, cin, cout)
        bz, by, bx = plan.box
        # two warpgroups: two planes of 224 voxels, or two cout tiles of one of 112
        assert plan.box == ((1, 14, 8) if cout > 64 else (2, 28, 8))
        assert plan.grid == shape[0] * int(np.prod(plan.counts)) < 2 ** 31
        hits = _coverage(shape, plan.box, plan.counts, range(plan.grid))
        assert (hits == 1).all()
        # 32-channel stages tile every cin the kernel takes, 96 and 32 included
        assert cin % plan.kc == 0 and plan.kc % 16 == 0
        assert plan.swizzle_bytes == 2 * plan.kc
        halo, weights = plan.tma_boxes(cout)
        assert halo[1:4] == (bx + 2, by + 2, bz + 2)
        assert _within_tma_limits(halo, 0), (halo, plan)  # 16-byte rows, no swizzle
        assert _within_tma_limits(weights, plan.swizzle_bytes), (weights, plan)
        assert weights[1] in (64, 128) and weights[1] >= cout  # wgmma's M: 64-row tiles


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("cin", [64, 128])
def test_dw_plan_chunks_cover_each_voxel_once_in_order(shape, cin):
    plan = wconv.dw_plan(shape, cin)
    bz, by, bx = plan.box
    assert plan.box == wconv.DW_BOX and bz * by * bx == 128  # the K box: 8 k16 steps
    assert _within_tma_limits((64, bx, by, bz, 1), 128)  # x and g, 128-byte swizzle
    assert plan.nboxes == shape[0] * int(np.prod(plan.counts))
    # the row tiles hold every (tap, c) row, in 64-row halves of one tap
    assert plan.tiles * wconv.DW_TILE_ROWS >= 27 * cin > (plan.tiles - 1) * wconv.DW_TILE_ROWS
    assert cin % 64 == 0
    # chunks: consecutive, in order, none empty, every box once
    order = [i for k in range(plan.chunks) for i in plan.chunk_boxes(k)]
    assert order == list(range(plan.nboxes))
    assert all(len(plan.chunk_boxes(k)) > 0 for k in range(plan.chunks))
    assert 1 <= plan.chunks <= 65535 and plan.chunks * plan.per_chunk >= plan.nboxes
    hits = np.zeros((shape[0],) + tuple(shape[1:]), dtype=np.int32)
    for k in range(plan.chunks):
        hits += _coverage(shape, plan.box, plan.counts, plan.chunk_boxes(k))
    assert (hits == 1).all()


def test_dw_plan_fills_the_card_at_the_training_step():
    """At 108^3 the split gives about four waves of one resident block per SM
    on 132 SMs, and its f32 partials stay under 20 MB."""
    for cin in (64, 128):
        plan = wconv.dw_plan((1, 108, 108, 108), cin)
        assert 400 <= plan.tiles * plan.chunks <= 528
        assert plan.chunks * 27 * cin * 64 * 4 < 20e6


def test_wrappers_refuse_a_misaligned_view():
    """TMA reads only from 16-byte aligned addresses: a contiguous view that
    starts 2 bytes into its storage is refused before any build or launch."""
    buf = torch.zeros(2 * 4 * 6 * 8 * 64 + 1, dtype=torch.bfloat16)
    x = buf[1:].view(2, 4, 6, 8, 64)
    assert x.is_contiguous() and x.data_ptr() % 16
    wt = torch.zeros((27, 64, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        conv3x3.launch(x, wt, None, "conv3x3 kernel")
    with pytest.raises(ValueError, match="aligned"):  # the check dw's wrapper runs
        wconv.check_operand("wconv dw", "x", x, x.device, torch.bfloat16)
