"""The host-side plan of the port's instance-norm statistics kernel, on the
CPU.

``inorm.stats_plan`` (csrc/inorm.cu, ``pair_sums`` and ``pair_sums_gy``)
decides the channel slabs, the row chunks and the scratch of the one launch;
the kernel trusts it.  Across the shapes that the inference, training and
card-test paths give the kernel, in bf16 and f32: the blocks cover every
(n, r, c) exactly once, a plan of one chunk has no cross-block step, and the
streaming shapes fill the card.
"""

import numpy as np
import pytest

from neuroclear_tpu_torch.ops import inorm

# (N, R, C): the inference tile batch's norms (2 x 140^3 and its halves), the
# 108^3 training step's (G_A's three levels, the discriminators' three), and
# the card tests' shapes
PATH_SHAPES = [(2, 140 ** 3, 64), (2, 70 ** 3, 128), (2, 35 ** 3, 256), (1, 108 ** 3, 64),
               (1, 54 ** 3, 128), (1, 27 ** 3, 256), (1, 27 ** 2, 128), (1, 13 ** 2, 256),
               (1, 12 ** 2, 512)]
CARD_SHAPES = [(1, 7, 64), (2, 1000, 128), (3, 333, 256), (1, 5, 8), (1, 300_000, 64),
               (1, 1, 64), (1, 1, 8), (2, 4000, 512), (300, 5000, 64), (1, 100_000, 1024)]
SMALL_SHAPES = [(1, 7, 64), (2, 1000, 128), (3, 333, 256), (1, 5, 8), (1, 1, 64),
                (2, 6000, 64), (1, 4000, 512), (1, 3000, 16)]


def _widest(itemsize):
    return 256 * 16 // itemsize  # C / V = 256


def _shapes(itemsize):
    vec = 16 // itemsize
    out = [s for s in PATH_SHAPES + CARD_SHAPES
           if s[2] % vec == 0 and s[2] // vec <= 256]
    return out + [(1, 729, _widest(itemsize)), (1, 60_000, _widest(itemsize))]


def _check_geometry(plan, n, rows, c, itemsize):
    vec = 16 // itemsize
    assert plan.slab * plan.slabs == c and plan.slab % vec == 0
    assert 256 % (plan.slab // vec) == 0
    sweep = 256 * vec // plan.slab  # rows one sweep of a block reads
    ranges = [plan.chunk_rows(k, rows) for k in range(plan.chunks)]
    # the chunks tile the rows in order, none empty, each of whole sweeps but the last
    assert ranges[0].start == 0 and ranges[-1].stop == rows
    assert all(a.stop == b.start for a, b in zip(ranges, ranges[1:]))
    assert all(len(r) > 0 for r in ranges)
    assert all(len(r) % sweep == 0 for r in ranges[:-1])
    if plan.chunks == 1:
        assert plan.scratch == 0 and plan.tickets == 0
    else:
        assert plan.tickets == n * plan.slabs <= inorm._MAX_TICKETS
        assert plan.scratch == n * plan.slabs * plan.chunks * 2 * plan.slab
        assert plan.chunks * 2 * plan.slab * 4 <= inorm._PARTIAL_BYTES
        assert plan.slab * itemsize >= inorm._MIN_SEGMENT_STREAM or plan.slab == c


@pytest.mark.parametrize("itemsize", [2, 4])
def test_stats_plan_tiles_every_path_shape(itemsize):
    for n, rows, c in _shapes(itemsize):
        plan = inorm.stats_plan(n, rows, c, itemsize)
        _check_geometry(plan, n, rows, c, itemsize)
        if plan.chunks == 1 and plan.slab * itemsize < inorm._MIN_SEGMENT_STREAM:
            # one block per slab reads its rows whole: a short read
            assert rows * plan.slab * itemsize <= inorm._ONE_BLOCK_BYTES


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape", SMALL_SHAPES)
def test_stats_plan_covers_each_element_once(shape, itemsize):
    n, rows, c = shape
    plan = inorm.stats_plan(n, rows, c, itemsize)
    hits = np.zeros(shape, dtype=np.int32)
    for b in range(n):
        for s in range(plan.slabs):
            for k in range(plan.chunks):
                r = plan.chunk_rows(k, rows)
                hits[b, r.start:r.stop, s * plan.slab:(s + 1) * plan.slab] += 1
    assert (hits == 1).all()


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape", [(1, 108 ** 3, 64), (2, 140 ** 3, 64)])
def test_stats_plan_fills_the_card_on_the_streaming_shapes(shape, itemsize):
    """The 108^3 step's and the tile batch's full-resolution norms stream
    with at least one block per H100 SM, combined in the same launch."""
    plan = inorm.stats_plan(*shape, itemsize)
    assert shape[0] * plan.slabs * plan.chunks >= 132
    assert plan.chunks > 1 and plan.tickets >= 1


@pytest.mark.parametrize("shape", [(1, 27 ** 2, 128), (1, 13 ** 2, 256), (1, 12 ** 2, 512)])
def test_stats_plan_reads_the_discriminators_norms_in_one_step(shape):
    """The 54 norms per step at the discriminators' shapes: one block per
    (n, slab) reads every row, so the call is one short launch with no
    cross-block step, over several blocks."""
    plan = inorm.stats_plan(*shape, 2)
    assert plan.chunks == 1 and plan.scratch == 0 and plan.tickets == 0
    assert plan.slabs >= 8
