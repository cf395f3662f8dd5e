"""The launch plan of the port's `scatter_streams` kernel
(`dint_tpu_torch.ops.row_kernels.scatter_plan`), on the CPU.

csrc/scatter_streams.cu launches one flat grid: stream s owns blocks
[first_block[s], first_block[s+1]), sized from its own K and row width,
and a group of threads takes whole rows with stores of ``vec`` words. The
plan is computed on the host; `_block_rows` mirrors how a block of the
kernel finds its stream and rows, so these tests hold the kernel's
coverage without a card (the kernel itself is held against its plain
version by tests/test_torch_cuda.py and chip_smoke.py). Exact checks
throughout."""
import ctypes

import numpy as np
import pytest
import torch

from dint_tpu_torch.ops import row_kernels as rk


def _block_rows(plan, ks, b):
    """What block ``b`` of the planned launch writes, found as the kernel
    finds it: the stream is the last one whose first block is <= b, and
    the block takes 256 / group rows of it (clipped to the stream's K).
    Returns (stream, first row, end row)."""
    n = len(plan.blocks)
    s = sum(1 for i in range(1, n) if plan.first_block[i] <= b)
    rows_per_block = rk.SCATTER_THREADS // plan.group[s]
    lo = (b - plan.first_block[s]) * rows_per_block
    return s, min(lo, ks[s]), min(lo + rows_per_block, ks[s])


def _covered(plan, ks):
    """Every (stream, row) a block of the plan writes, with its count."""
    seen = [np.zeros(k, np.int64) for k in ks]
    for b in range(plan.total):
        s, lo, hi = _block_rows(plan, ks, b)
        assert lo < hi, f"block {b} of stream {s} writes no row"
        seen[s][lo:hi] += 1
    return seen


@pytest.mark.parametrize("n_streams", range(1, rk.MAX_STREAMS + 1))
def test_plan_covers_every_row_once(n_streams):
    r = np.random.default_rng(n_streams)
    ks = [int(x) for x in r.integers(0, 3000, n_streams)]
    ks[r.integers(0, n_streams)] = 0                 # one empty stream
    vws = [int(x) for x in r.choice([1, 2, 3, 4, 7, 10, 18, 42], n_streams)]
    aligns = [int(x) for x in r.choice([4, 8, 16], n_streams)]
    plan = rk.scatter_plan(ks, vws, aligns)
    assert plan.total == sum(plan.blocks)
    assert plan.first_block[0] == 0 and len(plan.first_block) == n_streams + 1
    for s, k in enumerate(ks):
        assert plan.first_block[s + 1] - plan.first_block[s] == plan.blocks[s]
        if k == 0:
            assert plan.blocks[s] == 0
    for s, seen in enumerate(_covered(plan, ks)):
        assert (seen == 1).all(), f"stream {s}: rows not covered exactly once"


@pytest.mark.parametrize("ks", [(0,) * 3, (0, 5), (5, 0), (0, 0, 1, 0),
                                (1,) * 8])
def test_plan_empty_and_tiny_streams(ks):
    plan = rk.scatter_plan(ks, [3] * len(ks), [16] * len(ks))
    assert plan.blocks == tuple(1 if k else 0 for k in ks)
    assert plan.total == sum(1 for k in ks if k)
    assert all((seen == 1).all() for seen in _covered(plan, ks))


@pytest.mark.parametrize("vw,align,vec", [
    (1, 16, 1),
    (3, 16, 1),        # odd rows: 4-byte words
    (7, 16, 1),
    (2, 16, 2),
    (10, 16, 2),       # 40-byte rows are 8-byte aligned, not 16
    (10, 8, 2),
    (10, 4, 1),        # a misaligned pointer: 4-byte words
    (18, 16, 2),
    (42, 16, 2),
    (4, 16, 4),
    (4, 8, 2),
    (12, 16, 4),
    (8, 4, 1),
])
def test_plan_vector_width(vw, align, vec):
    plan = rk.scatter_plan([100], [vw], [align])
    assert plan.vec == (vec,)
    stores = vw // vec
    g = plan.group[0]
    assert g & (g - 1) == 0 and g <= rk.SCATTER_MAX_GROUP
    assert g >= stores or g == rk.SCATTER_MAX_GROUP   # covers the stores
    assert g == 1 or g // 2 < stores        # ... and is the smallest that does


@pytest.mark.parametrize("vw,align,group", [
    (42, 16, 16),      # 21 stores: a half warp, five threads loop twice
    (42, 4, 16),       # 42 four-byte stores
    (64, 16, 16),      # 16 sixteen-byte stores: one each
    (130, 8, 16),      # 65 stores: every thread loops
    (33, 16, 16),
    (17, 8, 16),       # odd: 17 four-byte stores
    (16, 4, 16),
    (9, 16, 16),
    (8, 16, 2),        # 2 sixteen-byte stores
    (6, 16, 4),        # 3 eight-byte stores
])
def test_plan_groups_of_long_rows(vw, align, group):
    """Rows of more stores than SCATTER_MAX_GROUP threads are looped over
    by a group of that many; shorter rows get the smallest power of two
    that covers them."""
    ks = (700, 1000)
    plan = rk.scatter_plan(ks, (vw, 1), (align, 16))
    assert plan.group == (group, 1) and group <= rk.SCATTER_MAX_GROUP
    assert all((seen == 1).all() for seen in _covered(plan, ks))


@pytest.mark.parametrize("name,ks,vws,vec,group,blocks", [
    # TATP fused install_log at w = 8192: val, meta, log x3 (16,384 lanes)
    ("tatp3", (16384,) * 3, (10, 1, 42), (2, 1, 2), (8, 1, 16),
     (512, 64, 1024)),
    # ... and with the hot tier's two mirrors
    ("tatp5", (16384,) * 5, (10, 1, 42, 10, 1), (2, 1, 2, 2, 1),
     (8, 1, 16, 8, 1), (512, 64, 1024, 512, 64)),
    # SmallBank fused install_log at w = 8192: bal, log x3, mirror (3w lanes)
    ("smallbank", (24576,) * 3, (1, 18, 1), (1, 2, 1), (1, 16, 1),
     (96, 1536, 96)),
])
def test_plan_main_path_shapes(name, ks, vws, vec, group, blocks):
    plan = rk.scatter_plan(ks, vws, [16] * len(ks))
    assert (plan.vec, plan.group, plan.blocks) == (vec, group, blocks)
    # fewer blocks than one (lane, word) thread each over a grid sized by
    # the widest stream for every stream
    widest = max(-(-k * vw // 256) for k, vw in zip(ks, vws))
    assert plan.total < len(ks) * widest
    assert all((seen == 1).all() for seen in _covered(plan, ks))


@pytest.mark.parametrize("offset,align", [(0, 16), (1, 4), (2, 8), (3, 4),
                                          (4, 16)])
def test_alignment_of_offset_views(offset, align):
    base = torch.zeros(64, dtype=torch.int32)
    assert base.data_ptr() % 16 == 0
    view = base[offset:offset + 40]
    assert rk.alignment(base.data_ptr(), view.data_ptr()) == align
    plan = rk.scatter_plan([4], [10], [align])
    assert plan.vec == ((2,) if align >= 8 else (1,))


def test_alignment_edge_cases():
    assert rk.alignment() == 16
    assert rk.alignment(0, 0) == 16                  # empty tensors
    assert rk.alignment(0, 1024 + 8) == 8
    assert rk.alignment(1 << 20, 1 << 21) == 16


def test_plan_struct_matches_the_kernel_layout():
    """csrc/scatter_streams.cu static_asserts sizeof(ScatterPlan) == 456."""
    assert ctypes.sizeof(rk._ScatterPlan) == 456
    assert rk._ScatterPlan.first_block.offset == 416
    assert rk._ScatterPlan.n_streams.offset == 452


def test_scatter_streams_with_an_empty_stream_on_the_cpu():
    tab0 = torch.arange(12, dtype=torch.int32)
    tab1 = torch.zeros(6, dtype=torch.int32)
    before = rk.scatter_streams.launches
    rk.scatter_streams([tab0, tab1],
                       [torch.zeros(0, dtype=torch.int32),
                        torch.tensor([2, -1], dtype=torch.int32)],
                       [torch.zeros(0, dtype=torch.int32),
                        torch.tensor([5, 6, 7, 8], dtype=torch.int32)],
                       (3, 2))
    assert rk.scatter_streams.launches == before
    assert torch.equal(tab0, torch.arange(12, dtype=torch.int32))
    assert tab1.tolist() == [0, 0, 0, 0, 5, 6]
