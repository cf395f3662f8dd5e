"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes (chip_smoke.py covers the main-path shapes). Skips without
a CUDA device. This file imports neither JAX nor the JAX package, so it
runs on a machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: exact (integer data)."""
import numpy as np
import pytest
import torch

from dint_tpu_torch.engines import tatp_dense as td
from dint_tpu_torch.ops import row_kernels as rk
from dint_tpu_torch.ops import scan_kernels as sk
from dint_tpu_torch.ops import u32
from dint_tpu_torch.timing import captured_nodes, device_events, graph_nodes


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("vw", [1, 10])
def test_gather_rows_kernel_matches_plain(cuda, vw):
    r = np.random.default_rng(vw)
    n = 5000
    tab = u32.from_numpy(r.integers(0, 1 << 32, n * vw, dtype=np.uint64)
                         .astype(np.uint32), cuda)
    idx = r.integers(0, n, 3001).astype(np.int32)
    idx[::7] = n - 1
    idx = torch.from_numpy(idx).to(cuda)
    before = rk.gather_rows.launches
    got = rk.gather_rows(tab, idx, vw)
    assert rk.gather_rows.launches == before + 1
    assert torch.equal(got, rk.gather_rows_ref(tab, idx, vw))


@pytest.mark.cuda
@pytest.mark.parametrize("t", [5, td.REBASE_AT - 1])
def test_lock_arbitrate_kernel_matches_plain(cuda, t):
    r = np.random.default_rng(t)
    n1, m = 1000, 4096
    arb0 = np.zeros(n1, np.uint32)
    for row in r.choice(n1 - 1, 100, replace=False):
        arb0[row] = np.uint32((int(r.choice([t - 1, t - 2])) << td.K_ARB) | 3)
    rows = r.integers(0, 300, m).astype(np.int32)      # heavy duplicates
    act = r.random(m) < 0.75
    rows[~act] = n1 - 1
    rows, act = torch.from_numpy(rows).to(cuda), torch.from_numpy(act).to(cuda)
    before = rk.lock_arbitrate.launches
    a_k, g_k = rk.lock_arbitrate(u32.from_numpy(arb0, cuda), rows, act, t,
                                 td.K_ARB)
    assert rk.lock_arbitrate.launches == before + 1
    a_r, g_r = rk.lock_arbitrate_ref(u32.from_numpy(arb0, cuda), rows, act,
                                     t, td.K_ARB)
    torch.cuda.synchronize()
    assert torch.equal(a_k, a_r) and torch.equal(g_k, g_r)
    assert bool(g_k.any())


@pytest.mark.cuda
@pytest.mark.parametrize("t", [5, td.REBASE_AT - 1])
def test_lock_validate_kernel_matches_plain(cuda, t):
    r = np.random.default_rng(t + 1)
    n1, m, v, k = 1000, 4096, 3000, 2500
    arb0 = np.zeros(n1, np.uint32)
    for row in r.choice(n1 - 1, 100, replace=False):
        arb0[row] = np.uint32((int(r.choice([t - 1, t - 2])) << td.K_ARB) | 3)
    meta = r.integers(0, 1 << 32, n1, dtype=np.uint64).astype(np.uint32)
    rows = r.integers(0, 300, m).astype(np.int32)      # heavy duplicates
    act = r.random(m) < 0.75
    rows[~act] = n1 - 1
    vidx = r.integers(0, n1, v).astype(np.int32)
    vv1 = np.where(r.random(v) < 0.5, meta[vidx], meta[vidx] ^ 2)
    args = [u32.from_numpy(meta, cuda),
            torch.from_numpy(vidx).to(cuda), u32.from_numpy(vv1, cuda),
            torch.from_numpy(r.integers(0, n1, k).astype(np.int32)).to(cuda),
            torch.from_numpy(rows).to(cuda), torch.from_numpy(act).to(cuda)]
    before = rk.lock_validate.launches
    got = rk.lock_validate(u32.from_numpy(arb0, cuda), *args, t, td.K_ARB)
    assert rk.lock_validate.launches == before + 1
    want = rk.lock_validate_ref(u32.from_numpy(arb0, cuda), *args, t,
                                td.K_ARB)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert bool(got[1].any()) and bool(got[2].any())


def _lanes(r, n, k, hot, cuda):
    """K lanes over n rows, ~90% of them in the hot prefix [0, hot)."""
    rows = np.where(r.random(k) < 0.9, r.integers(0, hot, k),
                    r.integers(0, n, k)).astype(np.int32)
    midx = np.where(rows < hot, rows, -1).astype(np.int32)
    return (torch.from_numpy(rows).to(cuda), torch.from_numpy(midx).to(cuda))


def _words(r, n, cuda):
    return u32.from_numpy(r.integers(0, 1 << 32, n, dtype=np.uint64)
                          .astype(np.uint32), cuda)


@pytest.mark.cuda
def test_gather_streams_kernel_matches_plain(cuda):
    r = np.random.default_rng(1)
    vws = (1, 18, 1)
    tabs = [_words(r, 4000 * vw, cuda) for vw in vws]
    idxs = [torch.from_numpy(r.integers(0, 4000, k).astype(np.int32)).to(cuda)
            for k in (3000, 700, 1)]
    before = rk.gather_streams.launches
    got = rk.gather_streams(tabs, idxs, vws)
    assert rk.gather_streams.launches == before + 1
    for g, w in zip(got, rk.gather_streams_ref(tabs, idxs, vws)):
        assert torch.equal(g, w)
    # B5 is the gather pass: bit-identical to gather_rows' tuple form
    assert all(torch.equal(g, w) for g, w in zip(
        got, rk.gather_rows(tabs, idxs, vws)))


@pytest.mark.cuda
def test_scatter_streams_kernel_matches_plain(cuda):
    r = np.random.default_rng(2)
    vws = (1, 18)
    n, k = 5000, 3000
    idxs = [torch.from_numpy(np.where(r.random(k) < 0.7,
                                      r.permutation(n)[:k], -1)
                             .astype(np.int32)).to(cuda) for _ in vws]
    vals = [_words(r, k * vw, cuda) for vw in vws]
    tabs = [_words(r, n * vw, cuda) for vw in vws]
    want = rk.scatter_streams_ref([t.clone() for t in tabs], idxs, vals, vws)
    before = rk.scatter_streams.launches
    got = rk.scatter_streams(tabs, idxs, vals, vws)
    assert rk.scatter_streams.launches == before + 1
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _masked_rows(r, n, k, frac, cuda):
    """K lanes over n rows: unique rows on ~frac of them, -1 elsewhere."""
    keep = r.random(k) < frac
    return torch.from_numpy(np.where(keep, r.permutation(n)[:k], -1)
                            .astype(np.int32)).to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 2])
def test_scatter_streams_kernel_eight_streams(cuda, offset):
    """Eight streams: odd and even vw up to 42 (uint4, uint2 and 4-byte
    stores), stream 2 empty, stream 5 all masked, and stream 4's values an
    offset view of ``offset`` words (16-, 4- and 8-byte aligned)."""
    r = np.random.default_rng(10 + offset)
    n = 4000
    vws = (1, 42, 3, 4, 10, 18, 2, 7)
    ks = (3000, 1500, 0, 2000, 2500, 800, 1000, 1200)
    idxs = [_masked_rows(r, n, k, 0.0 if s == 5 else 0.7, cuda)
            for s, k in enumerate(ks)]
    vals = [_words(r, k * vw, cuda) for k, vw in zip(ks, vws)]
    big = _words(r, ks[4] * vws[4] + 8, cuda)
    vals[4] = big[offset:offset + ks[4] * vws[4]]
    tabs = [_words(r, n * vw, cuda) for vw in vws]
    plan = rk.scatter_plan(ks, vws, [
        rk.scatter_alignment(vw, t, None, i, None, None, v)
        for t, i, v, vw in zip(tabs, idxs, vals, vws)])
    assert plan.vec[:4] == (2, 2, 1, 4) and plan.blocks[2] == 0
    assert plan.vec[4] == {0: 2, 1: 1, 2: 2}[offset]
    before_tabs = [t.clone() for t in tabs]
    want = rk.scatter_streams_ref([t.clone() for t in tabs], idxs, vals, vws)
    before = rk.scatter_streams.launches
    got = rk.scatter_streams(tabs, idxs, vals, vws)
    assert rk.scatter_streams.launches == before + 1
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(got[5], before_tabs[5])          # all masked
    assert not torch.equal(got[1], before_tabs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("vw,vec", [(42, 2), (130, 2), (200, 4), (263, 1)])
def test_scatter_streams_rows_longer_than_their_group(cuda, vw, vec):
    """Rows of more units than the 16 threads of their group, which a
    thread loads two at a time: 21, 65, 50 and 263 units, so a thread
    takes one or two of them, or loops over several pairs and a last
    single one."""
    r = np.random.default_rng(vw)
    n, k = 600, 500
    idx = _masked_rows(r, n, k, 0.7, cuda)
    val = _words(r, k * vw, cuda)
    tab = _words(r, n * vw, cuda)
    plan = rk.scatter_plan((k,), (vw,), (rk.scatter_alignment(
        vw, tab, None, idx, None, None, val),))
    assert plan.vec == (vec,) and plan.group == (16,)
    want = rk.scatter_streams_ref((tab.clone(),), (idx,), (val,), (vw,))
    before = tab.clone()
    got = rk.scatter_streams((tab,), (idx,), (val,), (vw,))
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and not torch.equal(got[0], before)

@pytest.mark.cuda
def test_scatter_streams_all_empty_launches_nothing(cuda):
    tab = torch.zeros(40, dtype=torch.int32, device=cuda)
    none = torch.zeros(0, dtype=torch.int32, device=cuda)
    before = rk.scatter_streams.launches
    rk.scatter_streams([tab, tab.clone()], [none, none], [none, none], (4, 1))
    assert rk.scatter_streams.launches == before


@pytest.mark.cuda
def test_scatter_streams_cuda_graph_replay(cuda):
    """One captured call, replayed on fresh inputs copied into the
    captured buffers, equals an eager call bit for bit."""
    r = np.random.default_rng(20)
    n, k, vws = 5000, 2048, (10, 1, 42)
    tabs0 = [_words(r, n * vw, cuda) for vw in vws]

    def fresh():
        return ([_masked_rows(r, n, k, 0.7, cuda) for _ in vws],
                [_words(r, k * vw, cuda) for vw in vws])
    tabs = [t.clone() for t in tabs0]
    idxs, vals = fresh()
    rk.scatter_streams(tabs, idxs, vals, vws)           # build and warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        rk.scatter_streams(tabs, idxs, vals, vws)
    idxs2, vals2 = fresh()
    for dst, src in zip(tabs + idxs + vals, tabs0 + idxs2 + vals2):
        dst.copy_(src)
    graph.replay()
    eager = rk.scatter_streams([t.clone() for t in tabs0], idxs2, vals2, vws)
    want = rk.scatter_streams_ref([t.clone() for t in tabs0], idxs2, vals2,
                                  vws)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(tabs, eager))
    assert all(torch.equal(a, b) for a, b in zip(tabs, want))


def _lv_case(r, cuda, t, n1, m, v, rr, k_arb=td.K_ARB, row_space=300):
    """arb (numpy, a tenth of the rows held at t-1 and a tenth at t-2) and
    lock_validate's other arguments on the card: M lock lanes over
    ``row_space`` rows (a quarter inactive, on the sentinel), V validate
    lanes half of them stale, R read lanes."""
    arb0 = np.zeros(n1, np.uint32)
    pick = r.choice(n1 - 1, 2 * (n1 // 10), replace=False)
    arb0[pick[:n1 // 10]] = np.uint32(((t - 1) << k_arb) | 3)
    arb0[pick[n1 // 10:]] = np.uint32(((t - 2) << k_arb) | 9)
    meta = r.integers(0, 1 << 32, n1, dtype=np.uint64).astype(np.uint32)
    rows = r.integers(0, row_space, m).astype(np.int32)
    act = r.random(m) < 0.75
    rows[~act] = n1 - 1
    vidx = r.integers(0, n1, v).astype(np.int32)
    vv1 = np.where(r.random(v) < 0.5, meta[vidx], meta[vidx] ^ 2)
    args = [u32.from_numpy(meta, cuda), torch.from_numpy(vidx).to(cuda),
            u32.from_numpy(vv1, cuda),
            torch.from_numpy(r.integers(0, n1, rr).astype(np.int32)).to(cuda),
            torch.from_numpy(rows).to(cuda), torch.from_numpy(act).to(cuda)]
    return arb0, args


def _lv_check(cuda, arb0, args, t, k_arb=td.K_ARB):
    """The kernel against the plain version; returns the kernel's outputs."""
    before = rk.lock_validate.launches
    got = rk.lock_validate(u32.from_numpy(arb0, cuda), *args, t, k_arb)
    empty = all(x.numel() == 0 for x in (args[1], args[3], args[4]))
    assert rk.lock_validate.launches == before + (0 if empty else 1)
    want = rk.lock_validate_ref(u32.from_numpy(arb0, cuda), *args, t, k_arb)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    return got


@pytest.mark.cuda
def test_lock_validate_kernel_all_lanes_on_one_row(cuda):
    r = np.random.default_rng(30)
    arb0, args = _lv_case(r, cuda, 7, 1000, 4096, 100, 100, row_space=1)
    arb0[0] = 0                                 # the row is free
    args[5] = torch.ones(4096, dtype=torch.bool, device=cuda)
    args[4] = torch.zeros(4096, dtype=torch.int32, device=cuda)
    got = _lv_check(cuda, arb0, args, 7)
    assert got[1].nonzero().flatten().tolist() == [0]   # the first lane wins


@pytest.mark.cuda
@pytest.mark.parametrize("t", [5, td.REBASE_AT - 1])
def test_lock_validate_kernel_held_rows(cuda, t):
    r = np.random.default_rng(t + 31)
    arb0, args = _lv_case(r, cuda, t, 600, 8000, 5000, 3000, row_space=599)
    held = (arb0[args[4].cpu().numpy()] >> td.K_ARB) == t - 1
    assert held.any()
    got = _lv_check(cuda, arb0, args, t)
    assert not bool(got[1][torch.from_numpy(held).to(cuda)].any())
    assert bool(got[1].any()) and bool(got[2].any())


@pytest.mark.cuda
@pytest.mark.parametrize("v,rr,m", [(0, 700, 900), (700, 0, 900),
                                    (700, 900, 0), (0, 0, 0), (0, 0, 5),
                                    (1, 0, 0)])
def test_lock_validate_kernel_empty_jobs(cuda, v, rr, m):
    r = np.random.default_rng(v + 2 * rr + 3 * m)
    arb0, args = _lv_case(r, cuda, 9, 1000, m, v, rr)
    got = _lv_check(cuda, arb0, args, 9)
    assert [x.numel() for x in got[1:]] == [m, v, rr]


@pytest.mark.cuda
def test_lock_validate_kernel_grid_stride_wraps(cuda):
    """More lanes of each job than the cooperative grid has threads: every
    thread takes several lock lanes (past the four kept in registers) and
    several validate and read lanes."""
    blocks = rk.lock_validate_grid(torch.device("cuda", 0))
    g = blocks * rk.LOCK_VALIDATE_THREADS
    k_arb = 22                      # 4M lock lanes; steps below 2^10
    m, v = 5 * g + 11, 6 * g + 5
    assert m <= 1 << k_arb
    r = np.random.default_rng(32)
    arb0, args = _lv_case(r, cuda, 5, 200_000, m, v, g + 3, k_arb=k_arb,
                          row_space=150_000)
    got = _lv_check(cuda, arb0, args, 5, k_arb)
    assert bool(got[1].any()) and bool(got[2].any())


@pytest.mark.cuda
def test_lock_validate_refused_launch_raises(cuda, monkeypatch):
    """A grid the card cannot hold at once is refused and raises, with no
    retry; the next call runs. Too many lanes for the grid raise first."""
    r = np.random.default_rng(33)
    blocks = rk.lock_validate_grid(torch.device("cuda", 0))
    # validate lanes enough for twice the grid the card holds
    v = 2 * blocks * rk.LOCK_VALIDATE_THREADS \
        * rk.LOCK_VALIDATE_LANES_PER_THREAD
    arb0, args = _lv_case(r, cuda, 5, 1000, 4096, v, 100)
    idx = args[0].device.index
    before = rk.lock_validate.launches
    monkeypatch.setitem(rk._lock_validate_grid, idx, 2 * blocks)
    with pytest.raises(RuntimeError, match="launch failed"):
        rk.lock_validate(u32.from_numpy(arb0, cuda), *args, 5, td.K_ARB)
    # one block: 64 lock lanes a thread, 16,384 in all
    monkeypatch.setitem(rk._lock_validate_grid, idx, 1)
    arb1, args1 = _lv_case(r, cuda, 5, 1000, 64 * 256 + 1, 100, 100)
    with pytest.raises(ValueError, match="exceed"):
        rk.lock_validate(u32.from_numpy(arb1, cuda), *args1, 5, td.K_ARB)
    assert rk.lock_validate.launches == before
    monkeypatch.setitem(rk._lock_validate_grid, idx, blocks)
    _lv_check(cuda, arb0, args, 5)


@pytest.mark.cuda
def test_lock_validate_cuda_graph_replay(cuda):
    """One captured call, replayed on fresh inputs copied into the
    captured buffers, equals an eager call bit for bit."""
    r = np.random.default_rng(34)
    t, n1 = 5, 3000
    arb0, args = _lv_case(r, cuda, t, n1, 4096, 3000, 2000, row_space=900)
    arb = u32.from_numpy(arb0, cuda)
    rk.lock_validate(arb.clone(), *args, t, td.K_ARB)   # build and warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = rk.lock_validate(arb, *args, t, td.K_ARB)
    arb1, args1 = _lv_case(r, cuda, t, n1, 4096, 3000, 2000, row_space=900)
    arb.copy_(u32.from_numpy(arb1, cuda))
    for dst, src in zip(args, args1):
        dst.copy_(src)
    graph.replay()
    eager = rk.lock_validate(u32.from_numpy(arb1, cuda), *args1, t, td.K_ARB)
    want = rk.lock_validate_ref(u32.from_numpy(arb1, cuda), *args1, t,
                                td.K_ARB)
    torch.cuda.synchronize()
    assert out[0] is arb
    assert all(torch.equal(a, b) for a, b in zip(out, eager))
    assert all(torch.equal(a, b) for a, b in zip(out, want))
    assert bool(out[1].any()) and bool(out[2].any())


@pytest.mark.cuda
@pytest.mark.parametrize("vw", [1, 3])
def test_hot_kernels_match_plain(cuda, vw):
    r = np.random.default_rng(vw)
    n, hot, k = 6000, 240, 3000
    tab = _words(r, n * vw, cuda)
    mirror = _words(r, hot * vw, cuda)       # unlike the table on purpose
    idx, midx = _lanes(r, n, k, hot, cuda)
    before = rk.gather_rows_hot.launches
    got = rk.gather_rows_hot(tab, mirror, idx, midx, vw)
    assert rk.gather_rows_hot.launches == before + 1
    assert torch.equal(got, rk.gather_rows_hot_ref(tab, mirror, idx, midx,
                                                   vw))
    rows = torch.from_numpy(r.permutation(n)[:k].astype(np.int32)).to(cuda)
    midx = torch.where(rows < hot, rows, -1)
    mask = torch.from_numpy(r.random(k) < 0.7).to(cuda)
    vals = _words(r, k * vw, cuda)
    want = rk.scatter_rows_hot_ref(tab.clone(), mirror.clone(), rows, midx,
                                   mask, vals, vw)
    before = rk.scatter_rows_hot.launches
    got = rk.scatter_rows_hot(tab, mirror, rows, midx, mask, vals, vw)
    assert rk.scatter_rows_hot.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("lg,vw", [(356, 10), (37, 3), (1, 1)])
def test_scan_rows_kernel_matches_plain(cuda, lg, vw):
    r = np.random.default_rng(lg)
    cap, k = 20_000, 1000
    arrs = [_words(r, n, cuda) for n in (cap, cap, cap, cap * vw)]
    off = r.integers(0, cap - lg + 1, k).astype(np.int32)
    off[0], off[-1] = 0, cap - lg                  # edge windows
    off[1::5] = off[2]                             # duplicate offsets
    off = torch.from_numpy(off).to(cuda)
    before = sk.scan_rows.launches
    got = sk.scan_rows(*arrs, off, lg, vw)
    assert sk.scan_rows.launches == before + 1
    torch.cuda.synchronize()
    for g, w in zip(got, sk.scan_rows_ref(*arrs, off, lg, vw)):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dup", [False, True])
def test_scalar_scatter_kernel_matches_plain(cuda, dup):
    """The probe's shape: a [2,200,064 / 512, 512] table, K = 16,384; with
    duplicates, the last lane of each shared index must win."""
    r = np.random.default_rng(int(dup))
    n, c, k = 2_200_064, 512, 16_384
    tab = _words(r, n, cuda).view(n // c, c)
    idx = r.choice(n, k, replace=False)
    if dup:
        idx[1::2] = idx[r.integers(0, 64, k // 2)]
        idx[-3:] = n - 1
    idx = torch.from_numpy(idx.astype(np.int32).reshape(k, 1)).to(cuda)
    val = _words(r, k, cuda).view(k, 1)
    before = rk.scalar_scatter.launches
    got = rk.scalar_scatter(tab, idx, val)
    assert rk.scalar_scatter.launches == before + 1
    want = rk.scalar_scatter_ref(tab, idx, val)
    torch.cuda.synchronize()
    assert got.shape == tab.shape and torch.equal(got, want)


def _lock_case(r, cuda, t, n1, m, row_space):
    """arb (a tenth of the rows held at t-1, a tenth expiring at t-2) and
    M lock lanes over ``row_space`` rows, a quarter inactive on the
    sentinel."""
    arb0 = np.zeros(n1, np.uint32)
    pick = r.choice(n1 - 1, 2 * (n1 // 10), replace=False)
    arb0[pick[:n1 // 10]] = np.uint32(((t - 1) << td.K_ARB) | 3)
    arb0[pick[n1 // 10:]] = np.uint32(((t - 2) << td.K_ARB) | 9)
    rows = r.integers(0, row_space, m).astype(np.int32)
    act = r.random(m) < 0.75
    rows[~act] = n1 - 1
    return (arb0, torch.from_numpy(rows).to(cuda),
            torch.from_numpy(act).to(cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [0, 1, 255, 16_384, 16_385, 1 << 18])
@pytest.mark.parametrize("t", [5, td.REBASE_AT - 1])
def test_lock_arbitrate_kernel_lane_counts(cuda, m, t):
    """One cooperative launch a call (none for M = 0), equal to the plain
    version from one lane to 2^K_ARB lanes (several lanes a thread)."""
    r = np.random.default_rng(m + t)
    arb0, rows, act = _lock_case(r, cuda, t, 300_000, m, 200_000)
    before = rk.lock_arbitrate.launches
    got = rk.lock_arbitrate(u32.from_numpy(arb0, cuda), rows, act, t,
                            td.K_ARB)
    assert rk.lock_arbitrate.launches == before + (1 if m else 0)
    want = rk.lock_arbitrate_ref(u32.from_numpy(arb0, cuda), rows, act, t,
                                 td.K_ARB)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[1].numel() == m


@pytest.mark.cuda
def test_lock_arbitrate_kernel_all_lanes_on_one_row(cuda):
    arb = torch.zeros(100, dtype=torch.int32, device=cuda)
    rows = torch.zeros(16_384, dtype=torch.int32, device=cuda)
    act = torch.ones(16_384, dtype=torch.bool, device=cuda)
    _, grant = rk.lock_arbitrate(arb, rows, act, 7, td.K_ARB)
    torch.cuda.synchronize()
    assert grant.nonzero().flatten().tolist() == [0]   # the first lane wins
    assert int(arb[0]) == (7 << td.K_ARB) | (16_384 - 1)


@pytest.mark.cuda
def test_lock_arbitrate_cuda_graph_replay(cuda):
    """One captured call, replayed on fresh inputs copied into the
    captured buffers, equals an eager call bit for bit."""
    r = np.random.default_rng(40)
    t, n1, m = 5, 50_000, 16_384
    arb0, rows, act = _lock_case(r, cuda, t, n1, m, 4096)
    arb = u32.from_numpy(arb0, cuda)
    rk.lock_arbitrate(arb.clone(), rows, act, t, td.K_ARB)   # build, warm
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = rk.lock_arbitrate(arb, rows, act, t, td.K_ARB)
    arb1, rows1, act1 = _lock_case(r, cuda, t, n1, m, 4096)
    arb.copy_(u32.from_numpy(arb1, cuda))
    rows.copy_(rows1)
    act.copy_(act1)
    graph.replay()
    eager = rk.lock_arbitrate(u32.from_numpy(arb1, cuda), rows1, act1, t,
                              td.K_ARB)
    want = rk.lock_arbitrate_ref(u32.from_numpy(arb1, cuda), rows1, act1, t,
                                 td.K_ARB)
    torch.cuda.synchronize()
    assert out[0] is arb
    assert all(torch.equal(a, b) for a, b in zip(out, eager))
    assert all(torch.equal(a, b) for a, b in zip(out, want))
    assert bool(out[1].any())


def _scatter_case(r, cuda, n, k, pattern):
    """A table of n random words and K lanes: unique indices, or (pattern
    1 and 2) half the lanes on 64 indices, at odd or even lanes, and the
    last three on the table's last word."""
    tab = _words(r, n, cuda)
    idx = r.choice(n, k, replace=False)
    if pattern and k > 3:
        idx[pattern - 1::2] = idx[r.integers(0, min(64, k), k // 2)]
        idx[-3:] = n - 1
    return (tab, torch.from_numpy(idx.astype(np.int32)).to(cuda),
            _words(r, k, cuda))


@pytest.mark.cuda
def test_scalar_scatter_kernel_calls_in_a_row(cuda):
    """Calls with different duplicate patterns, one after the other on one
    stream and one claim table, each equal to the plain version: each call
    leaves the table clean for the next."""
    r = np.random.default_rng(50)
    n, k = 2_200_064, 16_384
    for pattern in (1, 2, 0, 2, 1):
        tab, idx, val = _scatter_case(r, cuda, n, k, pattern)
        got = rk.scalar_scatter(tab, idx, val)
        torch.cuda.synchronize()
        assert torch.equal(got, rk.scalar_scatter_ref(tab, idx, val))
    stream = torch.cuda.current_stream().cuda_stream
    win = rk._claim_tables[(torch.device("cuda", 0).index, stream)]
    assert bool((win == -1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(4096, 0), (4096, 1), (5, 1), (7, 3),
                                 (1, 1), (0, 0)])
def test_scalar_scatter_kernel_small(cuda, n, k):
    """K = 0 (a plain copy, one launch), K = 1, tables shorter than a
    16-byte word or not a multiple of it, and the empty table (no
    launch)."""
    r = np.random.default_rng(n + k)
    tab = _words(r, n, cuda)
    idx = torch.from_numpy(r.integers(0, max(n, 1), k).astype(np.int32)).to(
        cuda)
    val = _words(r, k, cuda)
    before = rk.scalar_scatter.launches
    got = rk.scalar_scatter(tab, idx, val)
    assert rk.scalar_scatter.launches == before + (1 if n else 0)
    torch.cuda.synchronize()
    assert torch.equal(got, rk.scalar_scatter_ref(tab, idx, val))


@pytest.mark.cuda
def test_scalar_scatter_kernel_all_lanes_on_one_index(cuda):
    r = np.random.default_rng(51)
    n, k = 2_200_064, 16_384
    tab = _words(r, n, cuda)
    idx = torch.full((k,), n - 1, dtype=torch.int32, device=cuda)
    val = _words(r, k, cuda)
    got = rk.scalar_scatter(tab, idx, val)
    torch.cuda.synchronize()
    assert torch.equal(got[:-1], tab[:-1])
    assert int(got[-1]) == int(val[-1])                # the last lane wins


@pytest.mark.cuda
def test_scalar_scatter_cuda_graph_replay(cuda):
    """One captured call, replayed on fresh inputs (another duplicate
    pattern) copied into the captured buffers, equals an eager call bit
    for bit. The warm-up call runs on the capture stream, which makes its
    claim table; the captured graph holds one kernel."""
    r = np.random.default_rng(52)
    n, k = 100_000, 4096
    tab, idx, val = _scatter_case(r, cuda, n, k, 1)
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        rk.scalar_scatter(tab, idx, val)                 # build, warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = rk.scalar_scatter(tab, idx, val)
    assert _graph_kernels(graph) == 1
    for pattern in (2, 0):
        tab1, idx1, val1 = _scatter_case(r, cuda, n, k, pattern)
        for dst, src in ((tab, tab1), (idx, idx1), (val, val1)):
            dst.copy_(src)
        graph.replay()
        eager = rk.scalar_scatter(tab1, idx1, val1)
        want = rk.scalar_scatter_ref(tab1, idx1, val1)
        torch.cuda.synchronize()
        assert torch.equal(out, eager) and torch.equal(out, want)


def _graph_kernels(graph):
    """The kernel nodes of a captured graph: its nodes replayed under
    torch.profiler (`timing.profiled_device_events`)."""
    from dint_tpu_torch.timing import profiled_device_events
    torch.cuda.synchronize()
    ev = profiled_device_events(graph.replay)
    return sum(1 for e in ev if not e.name.startswith(("Memset", "Memcpy")))


@pytest.mark.cuda
def test_scalar_scatter_two_graphs_replayed_out_of_order(cuda):
    """Two graphs captured on one stream, after one eager call there, share
    the stream's claim table: replayed second first, then first, each
    equals the plain version, and the table is left clean."""
    r = np.random.default_rng(54)
    n, k = 100_000, 4096
    stream = torch.cuda.Stream()
    cases = [_scatter_case(r, cuda, n, k, p) for p in (1, 2)]
    with torch.cuda.stream(stream):
        rk.scalar_scatter(*cases[0])                     # makes the table
    torch.cuda.synchronize()
    graphs, outs = [], []
    for case in cases:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=stream):
            outs.append(rk.scalar_scatter(*case))
        graphs.append(g)
    for i in (1, 0, 1):
        graphs[i].replay()
        torch.cuda.synchronize()
        assert torch.equal(outs[i], rk.scalar_scatter_ref(*cases[i]))
    win = rk._claim_tables[(cuda.index or 0, stream.cuda_stream)]
    assert bool((win == -1).all())


@pytest.mark.cuda
def test_scalar_scatter_capture_needs_a_table(cuda):
    """Capturing on a stream that has made no call raises, and puts
    nothing into the graph's stream."""
    r = np.random.default_rng(55)
    tab, idx, val = _scatter_case(r, cuda, 100_000, 4096, 1)
    rk.scalar_scatter(tab, idx, val)                     # build
    stream = torch.cuda.Stream()
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="outside the capture"):
        with torch.cuda.graph(graph, stream=stream):
            rk.scalar_scatter(tab, idx, val)


@pytest.mark.cuda
def test_redesigned_kernels_are_one_launch(cuda):
    """One call of B2 and of B9 each puts one kernel on the stream and no
    memset or copy: in a CUDA graph capture of the call, and under
    torch.profiler whenever its trace holds a device event."""
    r = np.random.default_rng(53)
    arb0, rows, act = _lock_case(r, cuda, 5, 50_000, 16_384, 4096)
    arb = u32.from_numpy(arb0, cuda)
    tab, idx, val = _scatter_case(r, cuda, 2_200_064, 16_384, 1)
    for fn in (lambda: rk.lock_arbitrate(arb, rows, act, 5, td.K_ARB),
               lambda: rk.scalar_scatter(tab, idx, val)):
        assert captured_nodes(fn) == {"kernels": 1, "memsets": 0,
                                      "copies": 0, "other": 0}
        ev = device_events(fn)
        seen = (ev["kernels"], ev["memsets"], ev["copies"])
        assert seen in ((1, 0, 0), (0, 0, 0)), ev


# ------------------------------------------ the gather pass (B1 and B6)


def _gather_streams_case(r, cuda, n_streams, offset):
    """``n_streams`` streams over tables of n rows: vw cycling 1, 10, 1, 3,
    stream 1 empty (when there are two or more), duplicate indices and the
    last row on every 7th lane, K not a multiple of 4; stream 0's indices
    an offset view of ``offset`` words (16-, 4- or 8-byte aligned), and
    for vw > 1 the last stream's table an offset view too."""
    n = 3000
    vws = [(1, 10, 1, 3)[s % 4] for s in range(n_streams)]
    ks = [0 if s == 1 else 1001 + 97 * s for s in range(n_streams)]
    tabs, idxs = [], []
    for s, (vw, k) in enumerate(zip(vws, ks)):
        big = _words(r, n * vw + 8, cuda)
        tabs.append(big[offset * (s == n_streams - 1):][:n * vw])
        i = r.integers(0, n, k + 8).astype(np.int32)
        i[::7] = n - 1
        i[1::5] = i[0]
        i = torch.from_numpy(i).to(cuda)
        idxs.append(i[offset:offset + k] if s == 0 else i[:k])
    return tabs, idxs, vws


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 2])
@pytest.mark.parametrize("n_streams", range(1, 9))
def test_gather_rows_tuple_kernel_matches_plain(cuda, n_streams, offset):
    r = np.random.default_rng(100 + 3 * n_streams + offset)
    tabs, idxs, vws = _gather_streams_case(r, cuda, n_streams, offset)
    before = rk.gather_rows.launches
    got = rk.gather_rows(tabs, idxs, vws)
    assert rk.gather_rows.launches == before + 1
    want = rk.gather_rows_ref(tabs, idxs, vws)
    torch.cuda.synchronize()
    assert len(got) == n_streams
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    if n_streams > 1:
        assert got[1].numel() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 2])
@pytest.mark.parametrize("n_streams", range(1, 9))
def test_gather_rows_hot_tuple_kernel_matches_plain(cuda, n_streams,
                                                    offset):
    """Mirrors unlike their tables (a hot lane must read the mirror), and
    every hot lane's idx out of range: nothing may read it."""
    r = np.random.default_rng(200 + 3 * n_streams + offset)
    tabs, idxs, vws = _gather_streams_case(r, cuda, n_streams, offset)
    hot = 400
    mirrors = [_words(r, hot * vw + 4, cuda)[offset:][:hot * vw]
               for vw in vws]
    midxs, cold_idxs = [], []
    for i in idxs:
        m = torch.where(i < hot, i, -1)
        midxs.append(m)
        cold_idxs.append(torch.where(m >= 0, 10**9, i))
    before = rk.gather_rows_hot.launches
    got = rk.gather_rows_hot(tabs, mirrors, cold_idxs, midxs, vws)
    assert rk.gather_rows_hot.launches == before + 1
    want = rk.gather_rows_hot_ref(tabs, mirrors, cold_idxs, midxs, vws)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert any(bool((m >= 0).any()) for m in midxs)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [0, 1, 2, 3, 4, 5, 255, 1023, 1025])
def test_gather_pass_small_k(cuda, k):
    """K around the lanes a thread and the rows a block, one stream of
    each width; K = 0 launches nothing."""
    r = np.random.default_rng(300 + k)
    n = 500
    for vw in (1, 2, 10, 42):
        tab = _words(r, n * vw, cuda)
        idx = torch.from_numpy(r.integers(0, n, k).astype(np.int32)).to(cuda)
        before = rk.gather_rows.launches
        got = rk.gather_rows(tab, idx, vw)
        assert rk.gather_rows.launches == before + (1 if k else 0)
        assert torch.equal(got, rk.gather_rows_ref(tab, idx, vw))


@pytest.mark.cuda
def test_gather_pass_cuda_graph_replay(cuda):
    """A two-stream gather_rows and gather_rows_hot call captured in one
    graph and replayed on fresh indices copied into the captured buffers
    equal eager calls bit for bit."""
    r = np.random.default_rng(310)
    n, hot, k = 5000, 300, 4096
    tabs = (_words(r, n * 10, cuda), _words(r, n, cuda))
    mirrors = (_words(r, hot * 10, cuda), _words(r, hot, cuda))

    def fresh():
        i = torch.from_numpy(r.integers(0, n, k).astype(np.int32)).to(cuda)
        return i, torch.where(i < hot, i, -1)
    idx, midx = fresh()
    args = (tabs, (idx, idx), (10, 1))
    hargs = (tabs, mirrors, (idx, idx), (midx, midx), (10, 1))
    rk.gather_rows(*args)                               # build and warm up
    rk.gather_rows_hot(*hargs)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        out = rk.gather_rows(*args)
        hout = rk.gather_rows_hot(*hargs)
    idx2, midx2 = fresh()
    idx.copy_(idx2)
    midx.copy_(midx2)
    graph.replay()
    eager = rk.gather_rows(tabs, (idx2, idx2), (10, 1))
    heager = rk.gather_rows_hot(tabs, mirrors, (idx2, idx2), (midx2, midx2),
                                (10, 1))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, eager))
    assert all(torch.equal(a, b) for a, b in zip(hout, heager))
    assert all(torch.equal(a, b) for a, b in zip(
        out, rk.gather_rows_ref(tabs, (idx2, idx2), (10, 1))))
    assert all(torch.equal(a, b) for a, b in zip(
        hout, rk.gather_rows_hot_ref(tabs, mirrors, (idx2, idx2),
                                     (midx2, midx2), (10, 1))))
    assert graph_nodes(graph) == {"kernels": 2, "memsets": 0, "copies": 0,
                                  "other": 0}


@pytest.mark.cuda
def test_gather_pass_is_one_launch(cuda):
    """One tuple call of each form puts one kernel on the stream and no
    memset or copy: in a CUDA graph capture of the call, and under
    torch.profiler whenever its trace holds a device event."""
    r = np.random.default_rng(311)
    n, hot = 100_000, 4000
    tabs = (_words(r, n, cuda), _words(r, n * 10, cuda), _words(r, n, cuda))
    mirrors = tuple(t[:hot * vw] .clone() for t, vw in zip(tabs, (1, 10, 1)))
    idx = torch.from_numpy(r.integers(0, n, 24_576).astype(np.int32)).to(cuda)
    midx = torch.where(idx < hot, idx, -1)
    for fn in (lambda: rk.gather_rows(tabs, (idx,) * 3, (1, 10, 1)),
               lambda: rk.gather_rows_hot(tabs, mirrors, (idx,) * 3,
                                          (midx,) * 3, (1, 10, 1))):
        assert captured_nodes(fn) == {"kernels": 1, "memsets": 0,
                                      "copies": 0, "other": 0}
        ev = device_events(fn)
        seen = (ev["kernels"], ev["memsets"], ev["copies"])
        assert seen in ((1, 0, 0), (0, 0, 0)), ev


# ---------------------------------------- the scatter pass (B3 and B7)


def _hot_install(r, cuda, n, hot, k, vws, frac=0.6, offset=0):
    """One install's streams over tables of n rows with mirrors of their
    hot prefix (mirrors unlike the tables, so a mirror write shows), all
    streams on one set of lanes (one idx, midx and mask tensor, as the
    engines pass): unique rows, ~``frac`` masked in, and every masked-out
    lane's idx and midx 10^9, which nothing may read. ``offset`` words of
    offset on the indices, mask and values (16-, 4- or 8-byte aligned)."""
    rows = r.permutation(n)[:k].astype(np.int32)
    on = r.random(k) < frac
    midx = np.where(on & (rows < hot), rows, -1)
    rows = np.where(on, rows, 10**9)
    midx = np.where(on, midx, 10**9)
    pad = np.zeros(offset, np.int32)
    idx = torch.from_numpy(np.concatenate([pad, rows]).astype(
        np.int32)).to(cuda)[offset:]
    mi = torch.from_numpy(np.concatenate([pad, midx]).astype(
        np.int32)).to(cuda)[offset:]
    mask = torch.from_numpy(np.concatenate([pad.astype(bool), on])).to(
        cuda)[offset:]
    vals = tuple(_words(r, k * vw + offset, cuda)[offset:] for vw in vws)
    tabs = tuple(_words(r, n * vw, cuda) for vw in vws)
    mirrors = tuple(_words(r, hot * vw, cuda) for vw in vws)
    m = len(vws)
    return tabs, mirrors, (idx,) * m, (mi,) * m, (mask,) * m, vals, vws


def _check_install(args, fn=None):
    """One call of the wrapper ``fn`` (scatter_rows_hot) on copies of the
    tables and mirrors equals the plain version bit for bit, in one
    launch. Returns the tables and mirrors it wrote."""
    fn = fn or rk.scatter_rows_hot
    tabs, mirrors, *rest = args
    got = (tuple(t.clone() for t in tabs), tuple(m.clone() for m in mirrors))
    want = (tuple(t.clone() for t in tabs), tuple(m.clone() for m in mirrors))
    before = fn.launches
    fn(*got, *rest)
    assert fn.launches == before + 1
    rk.scatter_rows_hot_ref(*want, *rest)
    torch.cuda.synchronize()
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(g, w)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["tatp", "cache", "smallbank"])
def test_scatter_rows_hot_tuple_kernel_matches_plain(cuda, case):
    """The main paths' calls: TATP hotset's meta + val (K = 16,384), the
    cache tier's and the store's val + ver (K = 4,096), SmallBank's
    balances (K = 24,576, one stream), over tables of 10^6 rows; each
    equals the plain version and the single-stream calls."""
    r = np.random.default_rng({"tatp": 400, "cache": 401,
                               "smallbank": 402}[case])
    n, hot, k, vws = {"tatp": (1_000_000, 40_000, 16_384, (1, 10)),
                      "cache": (1_000_000, 40_000, 4096, (10, 1)),
                      "smallbank": (1_000_000, 40_000, 24_576, (1,))}[case]
    args = _hot_install(r, cuda, n, hot, k, vws)
    plan = rk.scatter_plan([k] * len(vws), vws, [16] * len(vws))
    assert plan.vec == (2,) * len(vws)
    tabs, mirrors = _check_install(args)
    for s in range(len(vws)):
        one = _check_install(tuple((a[s],) for a in args[:6]) + (
            (vws[s],),))
        assert torch.equal(one[0][0], tabs[s])
        assert torch.equal(one[1][0], mirrors[s])
    assert any(not torch.equal(a, b) for a, b in zip(mirrors, args[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("vw", [1, 10])
def test_scatter_rows_hot_masked_out_lanes_read_nothing(cuda, vw):
    """Every lane masked out, each with idx = midx = 10^9: no device
    assert fires and nothing is written; half masked in, the masked-out
    lanes' rows are left as they were."""
    r = np.random.default_rng(410 + vw)
    n, hot, k = 5000, 300, 3001
    for frac in (0.0, 0.5):
        args = _hot_install(r, cuda, n, hot, k, (vw, 1), frac)
        assert bool((args[2][0][~args[4][0]] == 10**9).all())
        assert bool((args[3][0][~args[4][0]] == 10**9).all())
        tabs, mirrors = _check_install(args)
        if frac == 0.0:
            assert all(torch.equal(a, b) for a, b in zip(
                tabs + mirrors, args[0] + args[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_scatter_rows_hot_offset_views(cuda, offset):
    """Indices, mask and values that are offset views: at vw = 1 an odd
    offset takes one lane a thread (vec = 1), and at vw = 10 an odd
    offset of the values 4-byte words; the result is the same."""
    r = np.random.default_rng(420 + offset)
    args = _hot_install(r, cuda, 6000, 400, 2049, (1, 10), offset=offset)
    tabs, mirrors, idxs, midxs, masks, vals, vws = args
    aligns = [rk.scatter_alignment(vw, t, m, i, mi, mk, v) for
              t, m, i, mi, mk, v, vw in zip(*args)]
    want = {1: (1, 1), 2: (2, 2), 3: (1, 1)}[offset]
    assert rk.scatter_plan([2049] * 2, vws, aligns).vec == want
    _check_install(args)
    # a mirror that is an offset view alone lowers the vw = 10 store width
    big = _words(r, 400 * 10 + 1, cuda)
    view = big[1:]
    view.copy_(mirrors[1])
    args2 = (tabs, (mirrors[0], view), idxs, midxs, masks,
             tuple(v.clone() for v in vals), vws)
    assert rk.scatter_alignment(10, tabs[1], view, idxs[1], midxs[1],
                                masks[1], args2[5][1]) == 4
    _check_install(args2)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [0, 1, 2, 3, 4, 5, 255, 1023, 1025])
def test_scatter_pass_small_k(cuda, k):
    """K around the lanes a thread and the rows a block, for B7 and B3 at
    widths 1, 2, 10 and 42; K = 0 launches nothing."""
    r = np.random.default_rng(430 + k)
    n = 2000
    for vw in (1, 2, 10, 42):
        args = _hot_install(r, cuda, n, 300, k, (vw,))
        tabs, mirrors, *rest = args
        t2, m2 = tabs[0].clone(), mirrors[0].clone()
        before = rk.scatter_rows_hot.launches
        rk.scatter_rows_hot(t2, m2, *(a[0] for a in rest[:4]), vw)
        assert rk.scatter_rows_hot.launches == before + (1 if k else 0)
        want = rk.scatter_rows_hot_ref(tabs[0].clone(), mirrors[0].clone(),
                                       *(a[0] for a in rest[:4]), vw)
        idx = _masked_rows(r, n, k, 0.7, cuda)
        val = _words(r, k * vw, cuda)
        t3 = tabs[0].clone()
        before = rk.scatter_streams.launches
        rk.scatter_streams((t3,), (idx,), (val,), (vw,))
        assert rk.scatter_streams.launches == before + (1 if k else 0)
        want3 = rk.scatter_streams_ref((tabs[0].clone(),), (idx,), (val,),
                                       (vw,))
        torch.cuda.synchronize()
        assert torch.equal(t2, want[0]) and torch.equal(m2, want[1])
        assert torch.equal(t3, want3[0])


@pytest.mark.cuda
def test_scatter_pass_cuda_graph_replay(cuda):
    """A two-stream scatter_rows_hot call and a three-stream
    scatter_streams call captured in one graph (two kernels, nothing
    else) and replayed on fresh inputs copied into the captured buffers
    equal eager calls and the plain versions bit for bit."""
    r = np.random.default_rng(440)
    n, hot, k = 5000, 300, 2048
    hargs = _hot_install(r, cuda, n, hot, k, (1, 10))
    htabs0, hmirrors0 = hargs[0], hargs[1]
    svws = (10, 1, 42)
    stabs0 = [_words(r, n * vw, cuda) for vw in svws]

    def fresh():
        h = _hot_install(r, cuda, n, hot, k, (1, 10))
        return (h[2][0], h[3][0], h[4][0], h[5],
                [_masked_rows(r, n, k, 0.7, cuda) for _ in svws],
                [_words(r, k * vw, cuda) for vw in svws])
    htabs = tuple(t.clone() for t in htabs0)
    hmirrors = tuple(m.clone() for m in hmirrors0)
    stabs = [t.clone() for t in stabs0]
    idx, midx, mask, hvals, sidxs, svals = fresh()

    def calls():
        rk.scatter_rows_hot(htabs, hmirrors, (idx, idx), (midx, midx),
                            (mask, mask), hvals, (1, 10))
        rk.scatter_streams(stabs, sidxs, svals, svws)
    calls()                                             # build and warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        calls()
    idx2, midx2, mask2, hvals2, sidxs2, svals2 = fresh()
    for dst, src in zip(
            list(htabs + hmirrors) + stabs + [idx, midx, mask] + list(hvals)
            + sidxs + svals,
            list(htabs0 + hmirrors0) + stabs0 + [idx2, midx2, mask2]
            + list(hvals2) + sidxs2 + svals2):
        dst.copy_(src)
    graph.replay()
    hargs2 = ((idx2, idx2), (midx2, midx2), (mask2, mask2), hvals2, (1, 10))
    eager = rk.scatter_rows_hot(tuple(t.clone() for t in htabs0),
                                tuple(m.clone() for m in hmirrors0), *hargs2)
    want = rk.scatter_rows_hot_ref(tuple(t.clone() for t in htabs0),
                                   tuple(m.clone() for m in hmirrors0),
                                   *hargs2)
    seager = rk.scatter_streams([t.clone() for t in stabs0], sidxs2, svals2,
                                svws)
    swant = rk.scatter_streams_ref([t.clone() for t in stabs0], sidxs2,
                                   svals2, svws)
    torch.cuda.synchronize()
    got = htabs + hmirrors
    assert all(torch.equal(a, b) for a, b in zip(got, eager[0] + eager[1]))
    assert all(torch.equal(a, b) for a, b in zip(got, want[0] + want[1]))
    assert all(torch.equal(a, b) for a, b in zip(stabs, seager))
    assert all(torch.equal(a, b) for a, b in zip(stabs, swant))
    assert graph_nodes(graph) == {"kernels": 2, "memsets": 0, "copies": 0,
                                  "other": 0}


@pytest.mark.cuda
def test_scatter_pass_and_b5_are_one_launch(cuda):
    """One tuple call of B7, of B3 and of B5 each puts one kernel on the
    stream and no memset or copy: in a CUDA graph capture of the call,
    and under torch.profiler whenever its trace holds a device event."""
    r = np.random.default_rng(450)
    n, hot, k = 100_000, 4000, 16_384
    hargs = _hot_install(r, cuda, n, hot, k, (1, 10))
    svws = (10, 1, 42, 10, 1)
    stabs = [_words(r, n * vw, cuda) for vw in svws]
    sidxs = [_masked_rows(r, n, k, 0.6, cuda) for _ in svws]
    svals = [_words(r, k * vw, cuda) for vw in svws]
    gtabs = (_words(r, 1 << 20, cuda), _words(r, 1 << 20, cuda),
             _words(r, n, cuda))
    slot = torch.from_numpy(r.integers(0, 1 << 20, 24_576).astype(
        np.int32)).to(cuda)
    rows = torch.from_numpy(r.integers(0, n, 24_576).astype(
        np.int32)).to(cuda)
    for fn in (lambda: rk.scatter_rows_hot(*hargs),
               lambda: rk.scatter_streams(stabs, sidxs, svals, svws),
               lambda: rk.gather_streams(gtabs, (slot, slot, rows),
                                         (1, 1, 1))):
        assert captured_nodes(fn) == {"kernels": 1, "memsets": 0,
                                      "copies": 0, "other": 0}
        ev = device_events(fn)
        seen = (ev["kernels"], ev["memsets"], ev["copies"])
        assert seen in ((1, 0, 0), (0, 0, 0)), ev
