"""The launch plan of the port's scatter pass
(`dint_tpu_torch.ops.row_kernels.scatter_plan`, csrc/scatter_pass.cuh: B3
`scatter_streams` and B7 `scatter_rows_hot`), on the CPU.

The pass launches one flat grid: stream s owns blocks [first_block[s],
first_block[s+1]), sized from its own K and row width. At vw = 1 a thread
takes ``vec`` lanes; at vw > 1 a group of threads takes whole rows with
loads and stores of ``vec`` words. The plan is computed on the host;
`_coverage` mirrors how a thread of the kernel finds its stream, lanes and
words, so these tests hold the kernel's coverage without a card (the
kernel itself is held against its plain version by tests/test_torch_cuda.py
and chip_smoke.py). The launch argument is held against the kernel's
layout by filling it through the wrappers' own host path with the launch
replaced. Exact checks throughout."""
import ctypes

import numpy as np
import pytest
import torch

from dint_tpu_torch.ops import row_kernels as rk


def _coverage(plan, ks, vws):
    """How many times each (stream, lane, word) is written when every
    block of the plan runs as the kernel runs it: the block's stream is
    the last one whose first block is <= b; thread t of the stream takes
    lanes [t*vec, t*vec + vec) at vw = 1, else word units c = lane, lane +
    group, ... of row t >> log2(group). Asserts that no block is idle."""
    seen = [np.zeros((k, vw), np.int64) for k, vw in zip(ks, vws)]
    n = len(ks)
    for b in range(plan.total):
        s = sum(1 for i in range(1, n) if plan.first_block[i] <= b)
        t = (b - plan.first_block[s]) * rk.SCATTER_THREADS + np.arange(
            rk.SCATTER_THREADS)
        v, g, k, vw = plan.vec[s], plan.group[s], ks[s], vws[s]
        if vw == 1:
            assert g == 1
            lanes = (t[:, None] * v + np.arange(v)).ravel()
            lanes = lanes[lanes < k]
            assert lanes.size, f"block {b} of stream {s} writes nothing"
            np.add.at(seen[s][:, 0], lanes, 1)
            continue
        lg = g.bit_length() - 1
        row, lane = t >> lg, t & (g - 1)
        ok = row < k
        assert ok.any(), f"block {b} of stream {s} writes nothing"
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
def test_plan_covers_every_row_once(n_streams):
    r = np.random.default_rng(n_streams)
    ks = [int(x) for x in r.integers(0, 3000, n_streams)]
    ks[r.integers(0, n_streams)] = 0                 # one empty stream
    ks[-1] += 4 - ks[-1] % 4 + 1 if ks[-1] else 0    # K % 4 == 1: a tail
    vws = [int(x) for x in r.choice([1, 1, 2, 3, 4, 7, 10, 18, 42],
                                    n_streams)]
    aligns = [int(x) for x in r.choice([4, 8, 16], n_streams)]
    plan = rk.scatter_plan(ks, vws, aligns)
    assert plan.total == sum(plan.blocks)
    assert plan.first_block[0] == 0 and len(plan.first_block) == n_streams + 1
    for s, k in enumerate(ks):
        assert plan.first_block[s + 1] - plan.first_block[s] == plan.blocks[s]
        if k == 0:
            assert plan.blocks[s] == 0
    assert _once(plan, ks, vws)


@pytest.mark.parametrize("ks", [(0,) * 3, (0, 5), (5, 0), (0, 0, 1, 0),
                                (1,) * 8])
def test_plan_empty_and_tiny_streams(ks):
    vws = [3 if s % 2 else 1 for s in range(len(ks))]
    plan = rk.scatter_plan(ks, vws, [16] * len(ks))
    assert plan.blocks == tuple(1 if k else 0 for k in ks)
    assert plan.total == sum(1 for k in ks if k)
    assert _once(plan, ks, vws)


@pytest.mark.parametrize("vw,align,vec", [
    (1, 16, 2),        # two lanes a thread: 8-byte index and value loads
    (1, 8, 2),
    (1, 4, 1),         # an offset view: one lane a thread
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
    g = plan.group[0]
    assert g & (g - 1) == 0 and g <= rk.SCATTER_MAX_GROUP
    if vw == 1:
        assert g == 1
    else:
        stores = vw // vec
        assert g >= stores or g == rk.SCATTER_MAX_GROUP   # covers them
        assert g == 1 or g // 2 < stores    # ... and is the smallest that does
    assert _once(plan, [100], [vw])


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
    assert _once(plan, ks, (vw, 1))


@pytest.mark.parametrize("name,ks,vws,vec,group,blocks", [
    # B3, TATP fused install_log at w = 8192: val, meta, log x3 (16,384
    # lanes)
    ("tatp3", (16384,) * 3, (10, 1, 42), (2, 2, 2), (8, 1, 16),
     (1024, 64, 2048)),
    # ... and with the hot tier's two mirrors
    ("tatp5", (16384,) * 5, (10, 1, 42, 10, 1), (2, 2, 2, 2, 2),
     (8, 1, 16, 8, 1), (1024, 64, 2048, 1024, 64)),
    # B3, SmallBank fused install_log at w = 8192: bal, log x3, mirror (3w
    # lanes)
    ("smallbank", (24576,) * 3, (1, 18, 1), (2, 2, 2), (1, 16, 1),
     (96, 3072, 96)),
    # B7, TATP hotset install at w = 8192: meta and val on the same lanes
    ("tatp-hot", (16384,) * 2, (1, 10), (2, 2), (1, 8), (64, 1024)),
    # B7, SmallBank hotset: the balances
    ("smallbank-hot", (24576,), (1,), (2,), (1,), (96,)),
    # B7, the store's hot route and the cache tier's write-back and refill
    # at w = 4096: val and ver
    ("store", (4096, 4096), (10, 1), (2, 2), (8, 1), (256, 16)),
])
def test_plan_main_path_shapes(name, ks, vws, vec, group, blocks):
    """The main paths' calls at the shipped 128 threads a block."""
    assert rk.SCATTER_THREADS == 128
    plan = rk.scatter_plan(ks, vws, [16] * len(ks))
    assert (plan.vec, plan.group, plan.blocks) == (vec, group, blocks)
    # fewer threads than one thread per (lane, word)
    threads = sum(-(-k // v) * g if vw == 1 else k * g for k, vw, v, g in
                  zip(ks, vws, vec, group))
    assert threads < sum(k * vw for k, vw in zip(ks, vws))
    assert _once(plan, ks, vws)


@pytest.mark.parametrize("offset,align", [(0, 16), (1, 4), (2, 8), (3, 4),
                                          (4, 16)])
def test_alignment_of_offset_views(offset, align):
    """At vw = 1 the index, mirror-index and value pointers and the mask
    (as lanes: a 2-byte aligned mask serves 8-byte aligned lane pairs)
    decide the lanes a thread; at vw > 1 the table, mirror and value rows
    decide the load and store width. Offset views fall back to 4-byte
    words: an unaligned mirror alone lowers vec."""
    base = torch.zeros(64, dtype=torch.int32)
    flags = torch.zeros(64, dtype=torch.bool)
    assert base.data_ptr() % 16 == 0 and flags.data_ptr() % 16 == 0
    view = base[offset:offset + 40]
    assert rk.alignment(base.data_ptr(), view.data_ptr()) == align
    sa = rk.scatter_alignment
    assert sa(1, base, None, view, None, None, base) == align
    assert sa(1, base, None, base, None, None, view) == align
    assert sa(1, view, view, base, base, flags, base) == 16   # tables free
    assert sa(1, base, base, base, view, flags, base) == align
    assert sa(1, base, base, base, base, flags[offset:], base) == align
    assert sa(10, view, None, base, None, None, base) == align
    assert sa(10, base, view, base, base, flags, base) == align  # mirror
    assert sa(10, base, base, view, view, flags[offset:], view) == align
    assert sa(10, base, base, view, view, flags[1:], base) == 16
    plan = rk.scatter_plan([40, 4], [1, 10], [align, align])
    assert plan.vec == ((2, 2) if align >= 8 else (1, 1))


def test_alignment_edge_cases():
    assert rk.alignment() == 16
    assert rk.alignment(0, 0) == 16                  # empty tensors
    assert rk.alignment(0, 1024 + 8) == 8
    assert rk.alignment(1 << 20, 1 << 21) == 16


def test_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="streams"):
        rk.scatter_plan([1] * 9, [1] * 9, [16] * 9)
    with pytest.raises(ValueError, match="streams"):
        rk.scatter_plan([], [], [])
    with pytest.raises(ValueError, match="2\\^31"):
        rk.scatter_plan([1 << 28], [8], [16])       # K * vw == 2^31
    plan = rk.scatter_plan([(1 << 28) - 1], [8], [16])   # just below
    assert plan.blocks == (-(-((1 << 28) - 1) * 2 // rk.SCATTER_THREADS),)


def _captured_plans(monkeypatch):
    """Replace the card in the wrappers' host path: the tensors' device
    reads as CUDA, and the C entry copies the launch argument it is given
    (as the kernel's launch does) into the returned list as
    (entry, capacity, plan struct)."""
    got = []

    def entry(name):
        def launch(addr, cap, stream):
            plan = rk._SCATTER_STRUCTS[cap].from_buffer_copy(
                ctypes.string_at(addr, ctypes.sizeof(rk._SCATTER_STRUCTS[cap])))
            got.append((name, cap, plan))
            return 0
        return launch
    monkeypatch.setattr(rk, "_same_device", lambda *xs: torch.device("cuda"))
    monkeypatch.setattr(rk, "_stream", lambda dev: 0)
    monkeypatch.setattr(rk, "_kernel", lambda name, dev: entry(name))
    return got


@pytest.mark.parametrize("hot", [False, True])
@pytest.mark.parametrize("cap,size", [(1, 96), (2, 176), (4, 344),
                                      (8, 680)])
def test_plan_struct_matches_the_kernel_layout(monkeypatch, cap, size, hot):
    """csrc/scatter_pass.cuh static_asserts sizeof(ScatterPlan<cap>): 96,
    176, 344 and 680 bytes, for both `scatter_pass_kernel<kHot>`; the
    fields lie in the kernel's order. A call of ``cap`` streams through
    scatter_streams (kHot false) or scatter_rows_hot (kHot true) fills
    that capacity's struct: every stream's pointers, rows, K, vw and plan,
    and null mirrors, mirror indices and masks without the hot tier."""
    p = rk._SCATTER_STRUCTS[cap]
    assert ctypes.sizeof(p) == size
    off, offsets = 0, {}
    for f, width in (("tab", 8), ("mirror", 8), ("idx", 8), ("midx", 8),
                     ("mask", 8), ("vals", 8), ("n_rows", 8),
                     ("n_mirror_rows", 8), ("k", 4), ("vw", 4), ("vec", 4),
                     ("tpr_log2", 4)):
        offsets[f] = off
        off += width * cap
    offsets["first_block"] = off
    offsets["n_streams"] = off + 4 * (cap + 1)
    assert {f: getattr(p, f).offset for f in offsets} == offsets
    assert rk.CAPACITIES == (1, 2, 4, 8)

    n = cap if cap < 4 else cap - 1      # 3 streams take capacity 4, 7 take 8
    vws = [(1, 10, 42, 3)[s % 4] for s in range(n)]
    ks = [20 + 4 * s for s in range(n)]
    tabs = [torch.zeros(50 * vw, dtype=torch.int32) for vw in vws]
    mirrors = [torch.zeros(5 * vw, dtype=torch.int32) for vw in vws]
    idxs = [torch.arange(k, dtype=torch.int32) for k in ks]
    midxs = [torch.full((k,), -1, dtype=torch.int32) for k in ks]
    masks = [torch.ones(k, dtype=torch.bool) for k in ks]
    vals = [torch.zeros(k * vw, dtype=torch.int32) for k, vw in zip(ks, vws)]
    got = _captured_plans(monkeypatch)
    fn = rk.scatter_rows_hot if hot else rk.scatter_streams
    before = fn.launches
    if hot:
        rk.scatter_rows_hot(tabs, mirrors, idxs, midxs, masks, vals, vws)
    else:
        rk.scatter_streams(tabs, idxs, vals, vws)
    assert [(g[0], g[1]) for g in got] == [(fn.__name__, cap)]
    a = got[0][2]
    plan = rk.scatter_plan(ks, vws, [16] * n)
    ptr = [t.data_ptr() for t in tabs]
    assert list(a.tab[:n]) == ptr and list(a.vals[:n]) == [
        v.data_ptr() for v in vals]
    assert list(a.idx[:n]) == [i.data_ptr() for i in idxs]
    if hot:
        assert list(a.mirror[:n]) == [m.data_ptr() for m in mirrors]
        assert list(a.midx[:n]) == [m.data_ptr() for m in midxs]
        assert list(a.mask[:n]) == [m.data_ptr() for m in masks]
        assert list(a.n_mirror_rows[:n]) == [5] * n
    else:
        assert not any(a.mirror) and not any(a.midx) and not any(a.mask)
        assert not any(a.n_mirror_rows)
    assert list(a.n_rows[:n]) == [50] * n
    assert (list(a.k[:n]), list(a.vw[:n])) == (ks, vws)
    assert tuple(a.vec[:n]) == plan.vec
    assert [1 << g for g in a.tpr_log2[:n]] == list(plan.group)
    assert tuple(a.first_block[:n + 1]) == plan.first_block
    assert a.n_streams == n
    assert fn.launches == before + 1


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
