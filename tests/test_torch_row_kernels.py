"""The port's row kernels (dint_tpu_torch/ops/row_kernels.py) against the
JAX package's Pallas kernels (interpret mode) and XLA chains.

On the CPU the wrappers run their plain PyTorch versions; the CUDA kernels
themselves are held against those plain versions on the card by
tests/test_torch_cuda.py (marker ``cuda``) and by chip_smoke.py.
Tolerance everywhere: exact (all data is integer)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dint_tpu.engines import tatp_dense as jtd
from dint_tpu.ops import pallas_gather as pg
from dint_tpu_torch.engines import tatp_dense as td
from dint_tpu_torch.ops import row_kernels as rk
from dint_tpu_torch.ops import u32

U32 = jnp.uint32


def _table(r, n, vw):
    return r.integers(0, 1 << 32, n * vw, dtype=np.uint64).astype(np.uint32)


# ------------------------------------------------------------ gather_rows


@pytest.mark.parametrize("n,vw,k", [
    (1000, 10, 333),      # val-style wide rows
    (512, 1, 700),        # meta-style single words, K > N
    (37, 10, 5),          # K smaller than the TPU kernel's DMA ring
    (64, 1, 64),
])
def test_gather_rows_ref_matches_pallas_and_take(n, vw, k):
    r = np.random.default_rng(n + k)
    tab = _table(r, n, vw)
    idx = r.integers(0, n, k).astype(np.int32)
    idx[::7] = n - 1                 # sentinel lanes
    idx[1::5] = idx[0]               # duplicates
    want_p = np.asarray(pg.gather_rows(jnp.asarray(tab), jnp.asarray(idx),
                                       vw, True))
    want_t = np.asarray(jnp.take(jnp.asarray(tab).reshape(n, vw),
                                 jnp.asarray(idx), axis=0).reshape(-1))
    assert np.array_equal(want_p, want_t)
    tab_t, idx_t = u32.from_numpy(tab, "cpu"), torch.from_numpy(idx)
    got = rk.gather_rows_ref(tab_t, idx_t, vw)
    assert got.dtype == torch.int32 and got.shape == (k * vw,)
    assert np.array_equal(u32.to_numpy(got), want_p)
    before = rk.gather_rows.launches
    assert np.array_equal(u32.to_numpy(rk.gather_rows(tab_t, idx_t, vw)),
                          want_p)
    assert rk.gather_rows.launches == before     # CPU: no kernel launched


def test_gather_rows_word_offset_pattern():
    """The magic check gathers ONE word at rows*VW + 1: pre-scaled flat
    word indices with vw=1, as the engine passes them."""
    r = np.random.default_rng(3)
    n, vw = 200, 10
    tab = _table(r, n, vw)
    rows = r.integers(0, n, 77).astype(np.int32)
    got = rk.gather_rows(u32.from_numpy(tab, "cpu"),
                         torch.from_numpy(rows * vw + 1), 1)
    want = pg.gather_rows(jnp.asarray(tab), jnp.asarray(rows * vw + 1), 1,
                          True)
    assert np.array_equal(u32.to_numpy(got), np.asarray(want))


def test_gather_rows_rejects_bad_arguments():
    tab = torch.zeros(40, dtype=torch.int32)
    idx = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        rk.gather_rows(tab.to(torch.int64), idx, 1)
    with pytest.raises(TypeError):
        rk.gather_rows(tab, idx.to(torch.int64), 1)
    with pytest.raises(ValueError):
        rk.gather_rows(tab.view(20, 2)[:, 0], idx, 1)    # not contiguous
    with pytest.raises(ValueError):
        rk.gather_rows(tab, idx, 3)                      # 40 % 3 != 0
    with pytest.raises(IndexError):
        rk.gather_rows(tab, torch.tensor([40], dtype=torch.int32), 1)


@pytest.mark.parametrize("case", ["tatp", "smallbank", "mixed", "eight"])
def test_gather_rows_tuple_matches_pallas(case):
    """The tuple form: each stream equals the Pallas kernel (interpret
    mode) on that stream alone, and the plain tuple form; an empty stream
    gives an empty output."""
    r = np.random.default_rng(len(case))
    streams = {
        # the TATP step: meta rows and pre-scaled magic-word offsets
        "tatp": [(300, 1, 96), (300 * 10, 1, 48)],
        # the SmallBank step: x and s stamps by slot, balances by row
        "smallbank": [(64, 1, 90), (64, 1, 90), (201, 1, 90)],
        "mixed": [(100, 10, 33), (50, 1, 0), (37, 3, 41), (20, 18, 7)],
        "eight": [(40 + s, (1, 10, 2, 3)[s % 4], 5 + 11 * s)
                  for s in range(8)],
    }[case]
    tabs = [_table(r, n, vw) for n, vw, _ in streams]
    idxs = []
    for n, _, k in streams:
        i = r.integers(0, n, k).astype(np.int32)
        i[::7] = n - 1                   # sentinel lanes
        i[1::5] = i[0] if k else 0       # duplicates
        idxs.append(i)
    vws = tuple(vw for _, vw, _ in streams)
    tt = tuple(u32.from_numpy(t, "cpu") for t in tabs)
    ti = tuple(torch.from_numpy(i) for i in idxs)
    before = rk.gather_rows.launches
    got = rk.gather_rows(tt, ti, vws)
    assert rk.gather_rows.launches == before     # CPU: no kernel launched
    ref = rk.gather_rows_ref(tt, ti, vws)
    assert isinstance(got, tuple) and len(got) == len(ref) == len(streams)
    for s, (tab, idx, vw) in enumerate(zip(tabs, idxs, vws)):
        assert torch.equal(got[s], ref[s])
        if idx.size == 0:
            assert got[s].numel() == 0
            continue
        want = np.asarray(pg.gather_rows(jnp.asarray(tab), jnp.asarray(idx),
                                         vw, True))
        assert np.array_equal(u32.to_numpy(got[s]), want), s


# --------------------------------------------------------- lock_arbitrate


def _xla_chain(arb, rows, active, t, k_arb=jtd.K_ARB):
    """The exact 3-op chain of the JAX pipe_step's XLA lock path."""
    m = rows.shape[0]
    oob = arb.shape[0]
    old = arb[rows]
    held = (old >> k_arb) == (t - 1)
    packed = (t << k_arb) | (U32(m - 1) - jnp.arange(m, dtype=U32))
    cand = active & ~held
    arb2 = arb.at[jnp.where(cand, rows, oob)].max(packed, mode="drop")
    grant = cand & (arb2[rows] == packed)
    return arb2, grant


def _lock_batch(m, row_space, seed, t):
    """Adversarial batch: a third of the rows pre-stamped (held at t-1,
    expiring at t-2, stale at t-3), heavy duplicates, and inactive lanes
    parked on the sentinel row like the engine's."""
    r = np.random.default_rng(seed)
    n1 = max(row_space + 1, 32)
    sent = n1 - 1
    arb0 = np.zeros(n1, np.uint32)
    for row in r.choice(row_space, max(1, row_space // 3), replace=False):
        step = int(r.choice([t - 1, t - 2, t - 3]))
        arb0[row] = np.uint32((step << jtd.K_ARB) | int(r.integers(0, 100)))
    rows = r.integers(0, row_space, m).astype(np.int32)
    act = r.random(m) < 0.75
    rows[~act] = sent
    return arb0, rows, act


@pytest.mark.parametrize("t", [5, jtd.REBASE_AT - 1])   # high t: stamps >= 2^31
@pytest.mark.parametrize("m,row_space,seed", [
    (64, 8, 0),      # heavy in-batch duplication (8 rows, 64 lanes)
    (64, 1000, 1),   # mostly conflict-free
    (10, 3, 2),      # brutal duplication
    (2, 1, 3),       # single row
    (130, 16, 4),    # several TPU ring wraps
    (256, 40, 5),
])
def test_lock_arbitrate_ref_matches_pallas(m, row_space, seed, t):
    arb0, rows, act = _lock_batch(m, row_space, seed, t)
    tj = jnp.asarray(t, U32)
    a_x, g_x = _xla_chain(jnp.asarray(arb0), jnp.asarray(rows),
                          jnp.asarray(act), tj)
    a_p, g_p = pg.lock_arbitrate(jnp.asarray(arb0), jnp.asarray(rows),
                                 jnp.asarray(act), tj, jtd.K_ARB, True)
    assert np.array_equal(np.asarray(a_x), np.asarray(a_p))
    assert np.array_equal(np.asarray(g_x), np.asarray(g_p) != 0)

    arb_t = u32.from_numpy(arb0, "cpu")
    out, grant = rk.lock_arbitrate_ref(arb_t, torch.from_numpy(rows),
                                       torch.from_numpy(act), t, td.K_ARB)
    assert out is arb_t                                  # updated in place
    assert np.array_equal(u32.to_numpy(out), np.asarray(a_p))
    assert grant.dtype == torch.bool
    assert np.array_equal(grant.numpy(), np.asarray(g_p) != 0)
    # the wrapper on CPU tensors is the plain version, and counts nothing
    before = rk.lock_arbitrate.launches
    out2, grant2 = rk.lock_arbitrate(u32.from_numpy(arb0, "cpu"),
                                     torch.from_numpy(rows),
                                     torch.from_numpy(act), t, td.K_ARB)
    assert torch.equal(out2, out) and torch.equal(grant2, grant)
    assert rk.lock_arbitrate.launches == before


def _edge_batch(case, t):
    """The lock pass at its edges: every lane active on one free row; one
    lane; lanes on the arb array's last row (held at t-1 for half of them
    to see, then free) beside lanes on row 0."""
    n1 = 40
    arb0 = np.zeros(n1, np.uint32)
    if case == "one_row":
        rows = np.zeros(64, np.int32)
        act = np.ones(64, bool)
    elif case == "one_lane":
        rows, act = np.array([3], np.int32), np.array([True])
        arb0[3] = np.uint32(((t - 2) << jtd.K_ARB) | 11)   # expired
    else:                                              # "last_row"
        rows = np.where(np.arange(33) % 2, n1 - 1, 0).astype(np.int32)
        act = np.ones(33, bool)
        arb0[0] = np.uint32(((t - 1) << jtd.K_ARB) | 2)    # held
    return arb0, rows, act


@pytest.mark.parametrize("t", [5, jtd.REBASE_AT - 1])
@pytest.mark.parametrize("case", ["one_row", "one_lane", "last_row"])
def test_lock_arbitrate_ref_matches_pallas_at_edges(case, t):
    arb0, rows, act = _edge_batch(case, t)
    a_p, g_p = pg.lock_arbitrate(jnp.asarray(arb0), jnp.asarray(rows),
                                 jnp.asarray(act), jnp.asarray(t, U32),
                                 jtd.K_ARB, True)
    out, grant = rk.lock_arbitrate(u32.from_numpy(arb0, "cpu"),
                                   torch.from_numpy(rows),
                                   torch.from_numpy(act), t, td.K_ARB)
    assert np.array_equal(u32.to_numpy(out), np.asarray(a_p))
    assert np.array_equal(grant.numpy(), np.asarray(g_p) != 0)
    # the first active lane of a free row wins; a held row grants nobody
    first = {}
    for lane, row in enumerate(rows):
        first.setdefault(int(row), lane)
    held = (arb0 >> td.K_ARB) == t - 1
    want = [lane == first[int(row)] and not held[row]
            for lane, row in enumerate(rows)]
    assert grant.tolist() == want


def test_lock_arbitrate_held_rows_not_restamped():
    """Candidates on a held row never stamp it: its t-1 stamp survives."""
    t = 9
    arb0 = np.zeros(16, np.uint32)
    arb0[2] = np.uint32((8 << td.K_ARB) | 5)
    arb, grant = rk.lock_arbitrate(u32.from_numpy(arb0, "cpu"),
                                   torch.full((8,), 2, dtype=torch.int32),
                                   torch.ones(8, dtype=torch.bool), t,
                                   td.K_ARB)
    assert not grant.any()
    assert u32.to_numpy(arb)[2] == arb0[2]


def test_lock_arbitrate_rejects_bad_arguments():
    arb = torch.zeros(16, dtype=torch.int32)
    rows = torch.zeros(4, dtype=torch.int32)
    act = torch.ones(4, dtype=torch.bool)
    with pytest.raises(TypeError):
        rk.lock_arbitrate(arb, rows, act.to(torch.int32), 5, td.K_ARB)
    with pytest.raises(ValueError):
        rk.lock_arbitrate(arb, rows, act[:3], 5, td.K_ARB)
    with pytest.raises(ValueError):
        rk.lock_arbitrate(arb, rows, act, 1 << (32 - td.K_ARB), td.K_ARB)
    with pytest.raises(ValueError):
        rk.lock_arbitrate(arb, torch.zeros(8, dtype=torch.int32),
                          torch.ones(8, dtype=torch.bool), 5, 2)


# ---------------------------------------------------------- lock_validate


@pytest.mark.parametrize("t", [5, jtd.REBASE_AT - 1])   # high t: stamps >= 2^31
@pytest.mark.parametrize("hot_n", [0, 24])
def test_lock_validate_ref_matches_pallas(hot_n, t):
    """tests/test_fused_ops.py's adversarial batch: duplicate lock rows on
    both sides of JAX's hot_n = 24 arb prefix, duplicate validate indices,
    inactive lanes, half the validate lanes stale. The port takes no hot_n:
    the Pallas kernel's outputs are the same with and without it."""
    n, m, v, r, k_arb = 96, 64, 48, 40, jtd.K_ARB
    rng = np.random.default_rng(7 + hot_n)
    meta = _table(rng, n, 1)
    rows = np.concatenate([rng.integers(0, n, m - 10),
                           [3, 3, 23, 23, 24, 24, 50, 50, 23, 24]])
    rows = rows.astype(np.int32)
    act = rng.integers(0, 2, m).astype(bool)
    vidx = np.concatenate([rng.integers(0, n, v - 4),
                           [5, 5, 9, 9]]).astype(np.int32)
    vv1 = np.where(np.arange(v) % 2 == 0, meta[vidx], meta[vidx] ^ 1)
    vv1 = vv1.astype(np.uint32)
    ridx = rng.integers(0, n, r).astype(np.int32)
    arb0 = np.zeros(n + 1, np.uint32)
    for row in rng.choice(n, n // 3, replace=False):
        step = int(rng.choice([t - 1, t - 2, t - 3]))
        arb0[row] = np.uint32((step << k_arb) | int(rng.integers(0, 100)))
    ja = [jnp.asarray(a) for a in (meta, vidx, vv1, ridx, rows, act)]
    a_p, g_p, vb_p, rm_p = pg.lock_validate(
        jnp.asarray(arb0), *ja, jnp.asarray(t, U32), k_arb, True, hot_n)
    tt = [u32.from_numpy(meta, "cpu"), torch.from_numpy(vidx),
          u32.from_numpy(vv1, "cpu"), torch.from_numpy(ridx),
          torch.from_numpy(rows), torch.from_numpy(act)]
    arb_t = u32.from_numpy(arb0, "cpu")
    out = rk.lock_validate_ref(arb_t, *tt, t, k_arb)
    assert out[0] is arb_t                              # updated in place
    assert np.array_equal(u32.to_numpy(out[0]), np.asarray(a_p))
    assert np.array_equal(out[1].numpy(), np.asarray(g_p) != 0)
    assert np.array_equal(out[2].numpy(), np.asarray(vb_p) != 0)
    assert np.array_equal(u32.to_numpy(out[3]), np.asarray(rm_p))
    assert out[1].any() and out[2].any() and not out[2].all()
    # the wrapper on CPU tensors is the plain version, and counts nothing
    before = rk.lock_validate.launches
    got = rk.lock_validate(u32.from_numpy(arb0, "cpu"), *tt, t, k_arb)
    assert rk.lock_validate.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, out))
    # and equals the unfused pair the default route runs
    a_u, g_u = rk.lock_arbitrate(u32.from_numpy(arb0, "cpu"), tt[4], tt[5],
                                 t, k_arb)
    g = rk.gather_rows(tt[0], torch.cat([tt[1], tt[3]]), 1)
    assert torch.equal(a_u, out[0]) and torch.equal(g_u, out[1])
    assert torch.equal(g[:v] != tt[2], out[2]) and torch.equal(g[v:], out[3])


def test_lock_validate_rejects_bad_arguments():
    arb = torch.zeros(16, dtype=torch.int32)
    meta = torch.zeros(16, dtype=torch.int32)
    idx = torch.zeros(4, dtype=torch.int32)
    act = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError, match="distinct"):
        rk.lock_validate(arb, arb, idx, idx, idx, idx, act, 5, td.K_ARB)
    with pytest.raises(ValueError, match="vv1"):
        rk.lock_validate(arb, meta, idx, idx[:3], idx, idx, act, 5, td.K_ARB)
    with pytest.raises(TypeError):
        rk.lock_validate(arb, meta, idx.long(), idx, idx, idx, act, 5,
                         td.K_ARB)
    with pytest.raises(ValueError, match="step"):
        rk.lock_validate(arb, meta, idx, idx, idx, idx, act,
                         1 << (32 - td.K_ARB), td.K_ARB)
    with pytest.raises(IndexError):
        rk.lock_validate(arb, meta, torch.tensor([16], dtype=torch.int32),
                         torch.zeros(1, dtype=torch.int32), idx, idx, act, 5,
                         td.K_ARB)


# --------------------------------------------------------- gather_streams


def _words(r, n):
    return r.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("n,vws,ks", [
    (64, (1, 4, 3), (40, 24, 8)),       # tests/test_fused_ops.py's case
    (300, (1, 1, 1), (192, 192, 192)),  # the SmallBank fused read: 3 x vw=1
    (50, (18, 2), (256, 5)),            # log-width rows; K below the ring
])
def test_gather_streams_ref_matches_pallas_and_xla(n, vws, ks):
    r = np.random.default_rng(n + sum(ks))
    tabs = [_words(r, n * vw) for vw in vws]
    idxs = [r.integers(0, n, k).astype(np.int32) for k in ks]
    idxs[1][:] = 17                     # an all-duplicate stream
    idxs[0][::5] = n - 1                # sentinel lanes
    jt = tuple(jnp.asarray(t) for t in tabs)
    ji = tuple(jnp.asarray(i) for i in idxs)
    want_p = pg.gather_streams(jt, ji, vws, True)
    want_x = pg._xla_gather_streams(jt, ji, vws)
    tt = [u32.from_numpy(t, "cpu") for t in tabs]
    ti = [torch.from_numpy(i) for i in idxs]
    got = rk.gather_streams_ref(tt, ti, vws)
    before = rk.gather_streams.launches
    got_w = rk.gather_streams(tt, ti, vws)
    assert rk.gather_streams.launches == before    # CPU: no kernel launched
    assert len(got) == len(got_w) == len(vws)
    for s in range(len(vws)):
        assert np.array_equal(np.asarray(want_p[s]), np.asarray(want_x[s]))
        assert np.array_equal(u32.to_numpy(got[s]), np.asarray(want_p[s])), s
        assert torch.equal(got_w[s], got[s])


@pytest.mark.parametrize("case", ["smallbank", "mixed"])
def test_gather_streams_is_gather_rows_tuple_form(case):
    """gather_streams is gather_rows' tuple form, counted on its own
    counter: equal to it and to the Pallas gather_streams (interpret
    mode) stream by stream, an empty stream included."""
    r = np.random.default_rng(len(case) + 300)
    streams = {
        # the SmallBank fused read: x and s stamps by slot, balances by row
        "smallbank": [(64, 1, 90), (64, 1, 90), (201, 1, 90)],
        "mixed": [(100, 10, 33), (50, 1, 0), (37, 3, 41), (20, 18, 7)],
    }[case]
    tabs = [_words(r, n * vw) for n, vw, _ in streams]
    idxs = [r.integers(0, n, k).astype(np.int32) for n, _, k in streams]
    if case == "smallbank":
        idxs[1] = idxs[0]               # x and s share the slot indices
    vws = tuple(vw for _, vw, _ in streams)
    tt = tuple(u32.from_numpy(t, "cpu") for t in tabs)
    ti = tuple(torch.from_numpy(i) for i in idxs)
    before = (rk.gather_streams.launches, rk.gather_rows.launches)
    got = rk.gather_streams(tt, ti, vws)
    assert (rk.gather_streams.launches, rk.gather_rows.launches) == before
    rows = rk.gather_rows(tt, ti, vws)
    assert len(got) == len(rows) == len(streams)
    live = [s for s, i in enumerate(idxs) if i.size]
    want = pg.gather_streams(tuple(jnp.asarray(tabs[s]) for s in live),
                             tuple(jnp.asarray(idxs[s]) for s in live),
                             tuple(vws[s] for s in live), True)
    for s in range(len(streams)):
        assert torch.equal(got[s], rows[s])
        if s in live:
            assert np.array_equal(u32.to_numpy(got[s]),
                                  np.asarray(want[live.index(s)])), s
        else:
            assert got[s].numel() == 0


# -------------------------------------------------------- scatter_streams


def _masked_unique(r, n, k, keep):
    """K lanes, unique rows among the masked-in ones, -1 elsewhere."""
    rows = r.permutation(n)[:k].astype(np.int32)
    return np.where(keep, rows, -1).astype(np.int32)


@pytest.mark.parametrize("n,vws,k", [
    (64, (4, 1, 3), 40),         # tests/test_fused_ops.py's case
    (256, (1, 18, 1), 192),      # the SmallBank install_log: bal, log, mirror
])
def test_scatter_streams_ref_matches_pallas_and_xla(n, vws, k):
    r = np.random.default_rng(n + k)
    tabs = [_words(r, n * vw) for vw in vws]
    lane = np.arange(k)
    perm = r.permutation(n)[:k].astype(np.int32)
    # stream 1 masks IN the rows stream 0 masked OUT (the same row ids in
    # disjoint tables); stream 2 is masked ~30% at random
    idxs = [np.where(lane % 3 == 0, perm, -1).astype(np.int32),
            np.where(lane % 3 != 0, perm, -1).astype(np.int32),
            _masked_unique(r, n, k, r.random(k) < 0.7)]
    vals = [_words(r, k * vw) for vw in vws]
    jt = tuple(jnp.array(t) for t in tabs)
    ji = tuple(jnp.asarray(i) for i in idxs)
    jv = tuple(jnp.asarray(v) for v in vals)
    want_p = pg.scatter_streams(jt, ji, jv, vws, True)
    want_x = pg._xla_scatter_streams(tuple(jnp.asarray(t) for t in tabs),
                                     ji, jv, vws)
    tt = [u32.from_numpy(t, "cpu") for t in tabs]
    out = rk.scatter_streams_ref(tt, [torch.from_numpy(i) for i in idxs],
                                 [u32.from_numpy(v, "cpu") for v in vals],
                                 vws)
    for s in range(len(vws)):
        assert out[s] is tt[s]                          # updated in place
        assert np.array_equal(np.asarray(want_p[s]), np.asarray(want_x[s]))
        assert np.array_equal(u32.to_numpy(out[s]), np.asarray(want_p[s])), s
    before = rk.scatter_streams.launches
    tt2 = [u32.from_numpy(t, "cpu") for t in tabs]
    rk.scatter_streams(tt2, [torch.from_numpy(i) for i in idxs],
                       [u32.from_numpy(v, "cpu") for v in vals], vws)
    assert rk.scatter_streams.launches == before
    assert all(torch.equal(a, b) for a, b in zip(tt2, out))


def test_scatter_streams_all_masked_stream_writes_nothing():
    tab = torch.arange(12, dtype=torch.int32)
    other = torch.zeros(4, dtype=torch.int32)
    rk.scatter_streams([tab, other],
                       [torch.full((3,), -1, dtype=torch.int32),
                        torch.tensor([2, -1, 0], dtype=torch.int32)],
                       [torch.full((6,), 9, dtype=torch.int32),
                        torch.tensor([5, 6, 7], dtype=torch.int32)], (2, 1))
    assert torch.equal(tab, torch.arange(12, dtype=torch.int32))
    assert other.tolist() == [7, 0, 5, 0]


def test_stream_kernels_reject_bad_arguments():
    tab = torch.zeros(16, dtype=torch.int32)
    idx = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="distinct"):
        rk.scatter_streams([tab, tab.view(4, 4)[0]], [idx, idx],
                           [idx, idx], (1, 1))
    with pytest.raises(ValueError, match="values"):
        rk.scatter_streams([tab], [idx], [idx[:3]], (1,))
    with pytest.raises(ValueError, match="streams"):
        rk.gather_streams([tab] * 9, [idx] * 9, (1,) * 9)
    with pytest.raises(ValueError, match="number"):
        rk.gather_streams([tab, tab], [idx], (1, 1))
    with pytest.raises(TypeError):
        rk.gather_streams([tab], [idx.to(torch.int64)], (1,))
    with pytest.raises(ValueError):
        rk.gather_streams([tab], [idx], (3,))          # 16 % 3 != 0


# ------------------------------------------------------- gather_rows_hot


@pytest.mark.parametrize("n,hot,vw,k,coherent", [
    (1000, 40, 10, 250, True),   # tests/test_hotset.py's cases (K <= 256)
    (512, 300, 1, 256, True),
    (37, 5, 4, 5, True),
    (64, 1, 2, 64, True),
    (200, 8, 1, 192, False),     # mirror unlike the table: hot lanes must
    (90, 30, 18, 40, False),     # read the mirror, cold lanes the table
])
def test_gather_rows_hot_ref_matches_pallas_and_xla(n, hot, vw, k,
                                                    coherent):
    r = np.random.default_rng(n + k)
    tab = _words(r, n * vw)
    mirror = tab[:hot * vw].copy() if coherent else _words(r, hot * vw)
    idx = r.integers(0, n, k).astype(np.int32)
    idx[::6] = hot - 1           # lanes on either side of the boundary
    idx[1::6] = hot % n
    midx = np.where(idx < hot, idx, -1).astype(np.int32)
    args = [jnp.asarray(a) for a in (tab, mirror, idx, midx)]
    want_p = np.asarray(pg.gather_rows_hot(*args, vw, True))
    assert np.array_equal(want_p, np.asarray(pg._xla_hot_gather(*args, vw)))
    if coherent:
        assert np.array_equal(want_p, np.asarray(
            pg.gather_rows(args[0], args[2], vw, True)))
    targs = [u32.from_numpy(tab, "cpu"), u32.from_numpy(mirror, "cpu"),
             torch.from_numpy(idx), torch.from_numpy(midx)]
    got = rk.gather_rows_hot_ref(*targs, vw)
    assert got.dtype == torch.int32 and got.shape == (k * vw,)
    assert np.array_equal(u32.to_numpy(got), want_p)
    before = rk.gather_rows_hot.launches
    assert torch.equal(rk.gather_rows_hot(*targs, vw), got)
    assert rk.gather_rows_hot.launches == before


def test_gather_rows_hot_duplicates_straddle_boundary():
    """tests/test_hotset.py's adversarial batch: the two rows on either
    side of hot_n, duplicated and interleaved."""
    n, hot, vw = 100, 50, 3
    r = np.random.default_rng(7)
    tab = _words(r, n * vw)
    mirror = tab[:hot * vw].copy()
    idx = np.tile([hot - 1, hot, hot - 1, hot - 1, hot, hot],
                  32).astype(np.int32)
    midx = np.where(idx < hot, idx, -1).astype(np.int32)
    want = pg.gather_rows_hot(*[jnp.asarray(a) for a in (tab, mirror, idx,
                                                         midx)], vw, True)
    got = rk.gather_rows_hot(u32.from_numpy(tab, "cpu"),
                             u32.from_numpy(mirror, "cpu"),
                             torch.from_numpy(idx), torch.from_numpy(midx),
                             vw)
    assert np.array_equal(u32.to_numpy(got), np.asarray(want))


def test_gather_rows_hot_does_not_read_hot_lanes_idx():
    """A hot lane's idx may be anything, as in the TPU kernel."""
    tab = torch.arange(10, dtype=torch.int32)
    mirror = torch.tensor([70, 71], dtype=torch.int32)
    got = rk.gather_rows_hot(tab, mirror,
                             torch.tensor([10**6, 3], dtype=torch.int32),
                             torch.tensor([1, -1], dtype=torch.int32), 1)
    assert got.tolist() == [71, 3]


@pytest.mark.parametrize("case", ["tatp", "smallbank_exact", "store"])
def test_gather_rows_hot_tuple_matches_pallas(case):
    """The tuple form of the hot gather: each stream equals the Pallas
    kernel (interpret mode) on that stream alone, and the plain tuple
    form. Mirrors unlike their tables, so that a hot lane must read the
    mirror; one hot lane per stream holds an out-of-range idx, which
    nothing may read."""
    r = np.random.default_rng(len(case) + 100)
    streams = {
        # meta rows and magic-word offsets through their prefix mirrors
        "tatp": [(300, 24, 1, 96), (3000, 240, 1, 48)],
        # the exact lock regime: x and s stamps and balances
        "smallbank_exact": [(64, 12, 1, 90), (64, 12, 1, 90),
                            (201, 12, 1, 90)],
        # the store's val (vw = 10) and ver of the same lanes
        "store": [(128, 20, 10, 64), (128, 20, 1, 64)],
    }[case]
    tabs = [_words(r, n * vw) for n, _, vw, _ in streams]
    mirrors = [_words(r, hot * vw) for _, hot, vw, _ in streams]
    idxs, midxs, rows = [], [], []
    for s, (n, hot, vw, k) in enumerate(streams):
        i = r.integers(0, n, k).astype(np.int32)
        if case == "store" and s == 1:
            i = rows[0]                  # the same lanes as val
        rows.append(i)
        m = np.where(i < hot, i, -1).astype(np.int32)
        i = i.copy()
        hot_lanes = np.nonzero(m >= 0)[0]
        assert hot_lanes.size
        i[hot_lanes[0]] = n + 10**6      # never read: the lane is hot
        idxs.append(i)
        midxs.append(m)
    vws = tuple(vw for _, _, vw, _ in streams)
    targs = [tuple(u32.from_numpy(a, "cpu") for a in tabs),
             tuple(u32.from_numpy(a, "cpu") for a in mirrors),
             tuple(torch.from_numpy(a) for a in idxs),
             tuple(torch.from_numpy(a) for a in midxs)]
    before = rk.gather_rows_hot.launches
    got = rk.gather_rows_hot(*targs, vws)
    assert rk.gather_rows_hot.launches == before
    ref = rk.gather_rows_hot_ref(*targs, vws)
    assert isinstance(got, tuple) and len(got) == len(streams)
    for s in range(len(streams)):
        want = np.asarray(pg.gather_rows_hot(
            *[jnp.asarray(a[s]) for a in (tabs, mirrors, idxs, midxs)],
            vws[s], True))
        assert torch.equal(got[s], ref[s])
        assert np.array_equal(u32.to_numpy(got[s]), want), s
        single = rk.gather_rows_hot(*(a[s] for a in targs), vws[s])
        assert torch.equal(single, got[s])


# ------------------------------------------------------ scatter_rows_hot


@pytest.mark.parametrize("n,hot,vw,k", [
    (200, 37, 3, 256),           # tests/test_hotset.py's case (K <= 256)
    (300, 12, 1, 192),           # the SmallBank install: vw = 1
])
def test_scatter_rows_hot_ref_matches_pallas_and_xla(n, hot, vw, k):
    r = np.random.default_rng(n + k)
    tab = _words(r, n * vw)
    mirror = tab[:hot * vw].copy()
    perm = r.permutation(n)[:min(k, n)]
    rows = np.zeros(k, np.int32)
    mask = np.zeros(k, bool)
    rows[:len(perm)] = perm
    mask[:len(perm)] = r.random(len(perm)) < 0.6
    midx = np.where(rows < hot, rows, -1).astype(np.int32)
    vals = _words(r, k * vw)
    jargs = [jnp.asarray(a) for a in (rows, midx, mask, vals)]
    t_p, m_p = pg.scatter_rows_hot(jnp.array(tab), jnp.array(mirror),
                                   *jargs, vw, True)
    t_x, m_x = pg.hot_scatter(jnp.array(tab), jnp.array(mirror), *jargs,
                              vw, use_pallas=False)
    assert np.array_equal(np.asarray(t_p), np.asarray(t_x))
    assert np.array_equal(np.asarray(m_p), np.asarray(m_x))
    targs = [torch.from_numpy(rows), torch.from_numpy(midx),
             torch.from_numpy(mask), u32.from_numpy(vals, "cpu")]
    tab_t, mir_t = u32.from_numpy(tab, "cpu"), u32.from_numpy(mirror, "cpu")
    out_t, out_m = rk.scatter_rows_hot_ref(tab_t, mir_t, *targs, vw)
    assert out_t is tab_t and out_m is mir_t           # updated in place
    assert np.array_equal(u32.to_numpy(out_t), np.asarray(t_p))
    assert np.array_equal(u32.to_numpy(out_m), np.asarray(m_p))
    # write-through coherence: the mirror is the table prefix afterwards
    assert torch.equal(out_t[:hot * vw], out_m)
    before = rk.scatter_rows_hot.launches
    t2, m2 = rk.scatter_rows_hot(u32.from_numpy(tab, "cpu"),
                                 u32.from_numpy(mirror, "cpu"), *targs, vw)
    assert rk.scatter_rows_hot.launches == before
    assert torch.equal(t2, out_t) and torch.equal(m2, out_m)


@pytest.mark.parametrize("case", ["tatp", "store", "mixed"])
def test_scatter_rows_hot_tuple_matches_pallas(case):
    """The tuple form of the write-through install, stream by stream
    against the Pallas kernel (interpret mode), the plain tuple form and
    the single form, bit for bit. "tatp" and "store" pass one idx, midx
    and mask tensor to both streams, as the engines do; "mixed" has an
    all-masked stream and an empty one. Every masked-out lane holds an
    out-of-range idx and midx, which nothing may read."""
    r = np.random.default_rng(len(case) + 200)
    streams = {
        # TATP hotset: meta (vw = 1) and val (vw = 10) on the same lanes
        "tatp": [(300, 24, 1, 96), (300, 24, 10, 96)],
        # the store's and the cache tier's val and ver on the same lanes
        "store": [(128, 20, 10, 64), (128, 20, 1, 64)],
        "mixed": [(100, 10, 3, 40), (64, 64, 1, 50), (80, 8, 18, 0),
                  (200, 30, 2, 33)],
    }[case]
    shared = case != "mixed"
    tabs = [_words(r, n * vw) for n, _, vw, _ in streams]
    mirrors = [_words(r, hot * vw) for _, hot, vw, _ in streams]
    lanes = []
    for s, (n, hot, vw, k) in enumerate(streams):
        if shared and s:
            lanes.append(lanes[0])
            continue
        rows = r.permutation(n)[:k].astype(np.int32)
        on = r.random(k) < (0.0 if case == "mixed" and s == 1 else 0.6)
        midx = np.where(rows < hot, rows, -1).astype(np.int32)
        # a masked-out lane's indices address nothing
        rows = np.where(on, rows, n + 10**6).astype(np.int32)
        midx = np.where(on, midx, hot + 10**6).astype(np.int32)
        lanes.append((rows, midx, on))
    vals = [_words(r, k * vw) for _, _, vw, k in streams]
    vws = tuple(vw for _, _, vw, _ in streams)
    lane_t = [tuple(torch.from_numpy(a) for a in z) for z in lanes]
    if shared:                          # one tensor of each for both streams
        lane_t = [lane_t[0]] * len(streams)
    idxs, midxs, masks = (tuple(z[j] for z in lane_t) for j in range(3))
    tt = tuple(u32.from_numpy(t, "cpu") for t in tabs)
    mt = tuple(u32.from_numpy(m, "cpu") for m in mirrors)
    vt = tuple(u32.from_numpy(v, "cpu") for v in vals)
    before = rk.scatter_rows_hot.launches
    got_t, got_m = rk.scatter_rows_hot(tt, mt, idxs, midxs, masks, vt, vws)
    assert rk.scatter_rows_hot.launches == before   # CPU: no kernel
    assert got_t == tt and got_m == mt              # updated in place
    ref_t = tuple(u32.from_numpy(t, "cpu") for t in tabs)
    ref_m = tuple(u32.from_numpy(m, "cpu") for m in mirrors)
    rk.scatter_rows_hot_ref(ref_t, ref_m, idxs, midxs, masks, vt, vws)
    for s, (rows, midx, on) in enumerate(lanes):
        assert torch.equal(tt[s], ref_t[s]) and torch.equal(mt[s], ref_m[s])
        one_t = u32.from_numpy(tabs[s], "cpu")
        one_m = u32.from_numpy(mirrors[s], "cpu")
        rk.scatter_rows_hot(one_t, one_m, idxs[s], midxs[s], masks[s], vt[s],
                            vws[s])
        assert torch.equal(one_t, tt[s]) and torch.equal(one_m, mt[s])
        if rows.size == 0:
            assert np.array_equal(u32.to_numpy(tt[s]), tabs[s])
            continue
        if not on.any():                # all masked: nothing written
            assert np.array_equal(u32.to_numpy(tt[s]), tabs[s])
            assert np.array_equal(u32.to_numpy(mt[s]), mirrors[s])
        want_t, want_m = pg.scatter_rows_hot(
            jnp.array(tabs[s]), jnp.array(mirrors[s]), jnp.asarray(rows),
            jnp.asarray(midx), jnp.asarray(on), jnp.asarray(vals[s]),
            vws[s], True)
        assert np.array_equal(u32.to_numpy(tt[s]), np.asarray(want_t)), s
        assert np.array_equal(u32.to_numpy(mt[s]), np.asarray(want_m)), s


def test_scatter_rows_hot_rejects_bad_stream_tuples():
    """Aliased tables, a mirror that aliases a table, and streams that
    disagree in number are refused before anything is written."""
    tab, tab2 = torch.zeros(16, dtype=torch.int32), torch.zeros(
        16, dtype=torch.int32)
    mir, mir2 = torch.zeros(4, dtype=torch.int32), torch.zeros(
        4, dtype=torch.int32)
    idx = torch.zeros(4, dtype=torch.int32)
    on = torch.ones(4, dtype=torch.bool)
    two = ((idx, idx), (idx, idx), (on, on), (idx, idx), (1, 1))
    with pytest.raises(ValueError, match="distinct"):
        rk.scatter_rows_hot((tab, tab.view(4, 4)[1]), (mir, mir2), *two)
    with pytest.raises(ValueError, match="distinct"):
        rk.scatter_rows_hot((tab, tab2), (mir, tab2[4:8]), *two)
    with pytest.raises(ValueError, match="distinct"):
        rk.scatter_rows_hot((tab, tab2), (mir, mir), *two)
    with pytest.raises(ValueError, match="distinct"):
        rk.scatter_rows_hot(tab, tab[8:12], idx, idx, on, idx, 1)
    with pytest.raises(ValueError, match="number"):
        rk.scatter_rows_hot((tab, tab2), (mir,), *two)
    with pytest.raises(ValueError, match="number"):
        rk.scatter_rows_hot((tab, tab2), (mir, mir2), (idx, idx), (idx,),
                            (on, on), (idx, idx), (1, 1))
    with pytest.raises(ValueError, match="number"):
        rk.scatter_rows_hot((tab, tab2), (mir, mir2), (idx, idx),
                            (idx, idx), (on,), (idx, idx), (1, 1))
    with pytest.raises(ValueError, match="number"):
        rk.scatter_rows_hot((tab, tab2), (mir, mir2), (idx, idx),
                            (idx, idx), (on, on), (idx,), (1, 1))
    with pytest.raises(ValueError, match="streams"):
        rk.scatter_rows_hot((tab,) * 9, (mir,) * 9, (idx,) * 9, (idx,) * 9,
                            (on,) * 9, (idx,) * 9, (1,) * 9)
    with pytest.raises(ValueError, match="mask flags"):
        rk.scatter_rows_hot((tab, tab2), (mir, mir2), (idx, idx),
                            (idx, idx), (on, on[:3]), (idx, idx), (1, 1))
    assert not tab.any() and not tab2.any() and not mir.any()



@pytest.mark.parametrize("kernel", ["scatter_streams", "scatter_rows_hot"])
def test_scatter_kernels_reject_values_that_alias_a_written_array(kernel):
    """The card's kernel reads values through the read-only path, so values
    that share memory with a table or mirror of the same call are refused
    before anything is written; values shared between streams are fine."""
    tab, tab2 = torch.zeros(16, dtype=torch.int32), torch.zeros(
        16, dtype=torch.int32)
    mir, mir2 = torch.zeros(4, dtype=torch.int32), torch.zeros(
        4, dtype=torch.int32)
    idx = torch.arange(4, dtype=torch.int32)
    on = torch.ones(4, dtype=torch.bool)
    val = torch.arange(1, 5, dtype=torch.int32)

    def call(vals):
        if kernel == "scatter_streams":
            rk.scatter_streams((tab, tab2, mir, mir2), (idx,) * 4, vals,
                               (1,) * 4)
        else:
            rk.scatter_rows_hot((tab, tab2), (mir, mir2), (idx, idx),
                                (idx, idx), (on, on), vals, (1, 1))
    n = 4 if kernel == "scatter_streams" else 2
    for aliased in (tab[12:], tab2.view(4, 4)[1], mir, mir2[:]):
        with pytest.raises(ValueError, match="share memory"):
            call((val,) * (n - 1) + (aliased,))
    assert not tab.any() and not tab2.any() and not mir.any() \
        and not mir2.any()
    call((val,) * n)
    assert tab[:4].tolist() == tab2[:4].tolist() == mir.tolist() \
        == [1, 2, 3, 4]


def test_hot_kernels_reject_bad_arguments():
    tab = torch.zeros(16, dtype=torch.int32)
    mirror = torch.zeros(4, dtype=torch.int32)
    idx = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="midx"):
        rk.gather_rows_hot(tab, mirror, idx, idx[:3], 1)
    with pytest.raises(TypeError):
        rk.scatter_rows_hot(tab, mirror, idx, idx, idx, idx, 1)  # int mask
    with pytest.raises(ValueError):
        rk.scatter_rows_hot(tab, mirror, idx, idx,
                            torch.ones(4, dtype=torch.bool), idx[:2], 1)
    with pytest.raises(ValueError):
        rk.gather_rows_hot(tab, mirror[:3], idx, idx, 2)   # 3 % 2 != 0
