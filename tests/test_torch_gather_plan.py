"""The launch plan of the port's gather pass
(`dint_tpu_torch.ops.row_kernels.gather_plan`, csrc/gather_pass.cuh: B1
`gather_rows` and B6 `gather_rows_hot`), on the CPU.

The pass launches one flat grid: stream s owns blocks [first_block[s],
first_block[s+1]), sized from its own K and row width. At vw = 1 a thread
takes ``vec`` lanes; at vw > 1 a group of threads takes whole rows with
loads of ``vec`` words. The plan is computed on the host; `_coverage`
mirrors how a thread of the kernel finds its stream, lanes and words, so
these tests hold the kernel's coverage without a card (the kernel itself
is held against its plain version by tests/test_torch_cuda.py and
chip_smoke.py). Exact checks throughout."""
import ctypes

import numpy as np
import pytest
import torch

from dint_tpu_torch.ops import row_kernels as rk


def _coverage(plan, ks, vws):
    """How many times each (stream, lane, word) is gathered when every
    block of the plan runs as the kernel runs it: the block's stream is
    the last one whose first block is <= b; thread t of the stream takes
    lanes [t*vec, t*vec + vec) at vw = 1, else word units c = lane, lane +
    group, ... of row t >> log2(group). Asserts that no block is idle."""
    seen = [np.zeros((k, vw), np.int64) for k, vw in zip(ks, vws)]
    n = len(ks)
    for b in range(plan.total):
        s = sum(1 for i in range(1, n) if plan.first_block[i] <= b)
        t = (b - plan.first_block[s]) * rk.GATHER_THREADS + np.arange(
            rk.GATHER_THREADS)
        v, g, k, vw = plan.vec[s], plan.group[s], ks[s], vws[s]
        if vw == 1:
            assert g == 1
            lanes = (t[:, None] * v + np.arange(v)).ravel()
            lanes = lanes[lanes < k]
            assert lanes.size, f"block {b} of stream {s} gathers nothing"
            np.add.at(seen[s][:, 0], lanes, 1)
            continue
        lg = g.bit_length() - 1
        row, lane = t >> lg, t & (g - 1)
        ok = row < k
        assert ok.any(), f"block {b} of stream {s} gathers nothing"
        units = vw // v
        for step in range(0, units, g):
            c = lane + step
            m = ok & (c < units)
            for j in range(v):
                np.add.at(seen[s], (row[m], c[m] * v + j), 1)
    return seen


def _once(plan, ks, vws):
    return all((seen == 1).all() for seen in _coverage(plan, ks, vws))


@pytest.mark.parametrize("n_streams", range(1, rk.MAX_STREAMS + 1))
def test_plan_covers_every_word_once(n_streams):
    r = np.random.default_rng(n_streams)
    ks = [int(x) for x in r.integers(1, 3000, n_streams)]
    ks[r.integers(0, n_streams)] = 0                 # one empty stream
    ks[-1] += 4 - ks[-1] % 4 + 1 if ks[-1] else 0    # K % 4 == 1: a tail
    vws = [int(x) for x in r.choice([1, 1, 10, 2, 3, 4, 18], n_streams)]
    aligns = [int(x) for x in r.choice([4, 8, 16], n_streams)]
    plan = rk.gather_plan(ks, vws, aligns)
    assert plan.total == sum(plan.blocks)
    assert plan.first_block[0] == 0 and len(plan.first_block) == n_streams + 1
    for s, k in enumerate(ks):
        assert plan.first_block[s + 1] - plan.first_block[s] == plan.blocks[s]
        if k == 0:
            assert plan.blocks[s] == 0
    assert _once(plan, ks, vws)


@pytest.mark.parametrize("vw", [1, 10])
@pytest.mark.parametrize("k", [1, 2, 3, 5, 1023, 1025, 4099])
def test_plan_k_not_a_multiple_of_the_lanes(k, vw):
    """K past a multiple of the lanes a thread (or the rows a block):
    the tail lanes are gathered once, and no block is idle."""
    for align in (4, 8, 16):
        plan = rk.gather_plan([k, 7], [vw, 1], [align, 16])
        assert _once(plan, [k, 7], [vw, 1])


@pytest.mark.parametrize("ks", [(0,) * 3, (0, 5), (5, 0), (0, 0, 1, 0),
                                (1,) * 8])
def test_plan_empty_and_tiny_streams(ks):
    vws = [10 if s % 2 else 1 for s in range(len(ks))]
    plan = rk.gather_plan(ks, vws, [16] * len(ks))
    assert plan.blocks == tuple(1 if k else 0 for k in ks)
    assert plan.total == sum(1 for k in ks if k)
    assert _once(plan, ks, vws)


@pytest.mark.parametrize("vw,align,vec,group", [
    (1, 16, 2, 1),     # two lanes a thread: one 8-byte index load
    (1, 8, 2, 1),
    (1, 4, 1, 1),      # an offset view: one lane a thread
    (2, 16, 2, 1),
    (3, 16, 1, 4),     # odd rows: 4-byte words
    (4, 16, 4, 1),
    (4, 8, 2, 2),
    (10, 16, 2, 8),    # 40-byte rows are 8-byte aligned, not 16
    (10, 8, 2, 8),
    (10, 4, 1, 16),    # a misaligned pointer: 4-byte words
    (18, 16, 2, 16),
    (42, 16, 2, 16),   # 21 loads: a group of 16 loops
    (12, 16, 4, 4),
])
def test_plan_vector_width_and_group(vw, align, vec, group):
    plan = rk.gather_plan([100], [vw], [align])
    assert (plan.vec, plan.group) == ((vec,), (group,))
    if vw > 1:
        loads = vw // vec
        assert group <= rk.GATHER_MAX_GROUP
        assert group >= loads or group == rk.GATHER_MAX_GROUP
        assert group == 1 or group // 2 < loads
    assert _once(plan, [100], [vw])


@pytest.mark.parametrize("name,ks,vws,vec,group,blocks", [
    # TATP default/hotset at w = 8192: the meta gather (2wK lanes) and the
    # magic gather (wK word offsets)
    ("tatp", (65_536, 32_768), (1, 1), (2, 2), (1, 1), (256, 128)),
    # SmallBank default at w = 8192: x, s stamps and balances (3w lanes)
    ("smallbank", (24_576,) * 3, (1, 1, 1), (2, 2, 2), (1, 1, 1),
     (96, 96, 96)),
    # SmallBank hotset, hashed lock regime: the stamps alone
    ("smallbank-hashed-hot", (24_576,) * 2, (1, 1), (2, 2), (1, 1),
     (96, 96)),
    # the store's and the cache tier's hot reads at w = 4096: val, ver
    ("store", (4096, 4096), (10, 1), (2, 2), (8, 1), (256, 16)),
])
def test_plan_main_path_shapes(name, ks, vws, vec, group, blocks):
    """The main paths' calls at the shipped 128 threads a block."""
    assert rk.GATHER_THREADS == 128
    plan = rk.gather_plan(ks, vws, [16] * len(ks))
    assert (plan.vec, plan.group, plan.blocks) == (vec, group, blocks)
    # fewer threads than the old one thread per (lane, word)
    threads = sum(-(-k // v) * g if vw == 1 else k * g for k, vw, v, g in
                  zip(ks, vws, vec, group))
    assert threads < sum(k * vw for k, vw in zip(ks, vws))
    assert _once(plan, ks, vws)


@pytest.mark.parametrize("offset,align", [(0, 16), (1, 4), (2, 8), (3, 4),
                                          (4, 16)])
def test_alignment_of_offset_views(offset, align):
    """At vw = 1 the index, mirror-index and output pointers decide the
    lanes a thread; at vw > 1 the table, mirror and output rows decide the
    load width. Offset views fall back to 4-byte words."""
    base = torch.zeros(64, dtype=torch.int32)
    out = torch.zeros(64, dtype=torch.int32)
    assert base.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    view = base[offset:offset + 40]
    assert rk.gather_alignment(1, base, None, view, None, out) == align
    assert rk.gather_alignment(1, view, view, base, base, out) == 16
    assert rk.gather_alignment(1, base, base, base, view, out) == align
    assert rk.gather_alignment(10, view, None, base, None, out) == align
    assert rk.gather_alignment(10, base, view, view, view, out) == align
    assert rk.gather_alignment(10, base, base, view, view, out) == 16
    plan = rk.gather_plan([40, 4], [1, 10], [align, align])
    assert plan.vec == ((2, 2) if align >= 8 else (1, 1))


@pytest.mark.parametrize("cap,size", [(1, 88), (2, 160), (4, 312),
                                      (8, 616)])
def test_plan_struct_matches_the_kernel_layout(cap, size):
    """csrc/gather_pass.cuh static_asserts sizeof(GatherPlan<cap>): 88,
    160, 312 and 616 bytes; the fields lie in the kernel's order."""
    p = rk._GATHER_STRUCTS[cap]
    assert ctypes.sizeof(p) == size
    off, offsets = 0, {}
    for f, width in (("tab", 8), ("mirror", 8), ("idx", 8), ("midx", 8),
                     ("out", 8), ("n_rows", 8), ("n_mirror_rows", 8),
                     ("k", 4), ("vw", 4), ("vec", 4), ("tpr_log2", 4)):
        offsets[f] = off
        off += width * cap
    offsets["first_block"] = off
    offsets["n_streams"] = off + 4 * (cap + 1)
    assert {f: getattr(p, f).offset for f in offsets} == offsets
    assert rk.CAPACITIES == (1, 2, 4, 8)
    assert rk._GATHER_STRUCTS[8].first_block.offset == 576


def test_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="streams"):
        rk.gather_plan([1] * 9, [1] * 9, [16] * 9)
    with pytest.raises(ValueError, match="streams"):
        rk.gather_plan([], [], [])
    with pytest.raises(ValueError, match="2\\^31"):
        rk.gather_plan([1 << 28], [8], [16])        # K * vw == 2^31
    with pytest.raises(ValueError, match="2\\^31"):
        rk.gather_plan([5, 1 << 31], [1, 1], [16, 16])
    plan = rk.gather_plan([(1 << 28) - 1], [8], [16])   # just below
    assert plan.blocks == (-(-((1 << 28) - 1) * 2 // rk.GATHER_THREADS),)


def test_wrappers_refuse_bad_stream_tuples():
    tab = torch.zeros(16, dtype=torch.int32)
    idx = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="streams"):
        rk.gather_rows((tab,) * 9, (idx,) * 9, (1,) * 9)
    with pytest.raises(ValueError, match="number"):
        rk.gather_rows((tab, tab), (idx,), (1, 1))
    with pytest.raises(ValueError, match="midx"):
        rk.gather_rows_hot((tab, tab), (tab, tab), (idx, idx),
                           (idx, idx[:3]), (1, 1))
    with pytest.raises(ValueError, match="number"):
        rk.gather_rows_hot((tab, tab), (tab,), (idx, idx), (idx, idx),
                           (1, 1))
    with pytest.raises(TypeError):
        rk.gather_rows_hot((tab,), (tab,), (idx,), (idx.long(),), (1,))


def test_tuple_forms_with_an_empty_stream_on_the_cpu():
    tab0 = torch.arange(12, dtype=torch.int32)
    tab1 = torch.arange(100, 106, dtype=torch.int32)
    none = torch.zeros(0, dtype=torch.int32)
    before = (rk.gather_rows.launches, rk.gather_rows_hot.launches)
    a, b = rk.gather_rows((tab0, tab1), (none, torch.tensor(
        [2, 0], dtype=torch.int32)), (3, 2))
    assert a.numel() == 0 and b.tolist() == [104, 105, 100, 101]
    mirror = torch.tensor([7, 8], dtype=torch.int32)
    c, d = rk.gather_rows_hot((tab0, tab1), (tab0[:3], mirror),
                              (none, torch.tensor([5, 2], dtype=torch.int32)),
                              (none, torch.tensor([-1, 1], dtype=torch.int32)),
                              (3, 1))
    assert c.numel() == 0 and d.tolist() == [105, 8]
    assert (rk.gather_rows.launches,
            rk.gather_rows_hot.launches) == before    # CPU: no kernel
