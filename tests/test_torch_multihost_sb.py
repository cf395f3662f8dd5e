"""The port's SmallBank on the 2-D (host, chip) mesh
(dint_tpu_torch.parallel.multihost_sb) against
`dint_tpu.parallel.multihost_sb` on the CPU, the port's own pins (its 2-D
routes against its 1-D `dense_sharded_sb`, the overlap route against its
unoverlapped serve route, recovery from a holder on another host) and the
pieces (`Mesh.all_to_all`'s hierarchical and flat forms against JAX's
`all_to_all` in a `shard_map`, `convert.multihost_sb_*`).

JAX runs each route once a mesh shape (3x2 and 4x2 over the 8 virtual CPU
devices of tests/conftest.py), monitored; the port runs the partitions as
a list on the CPU, where its kernels take their plain versions, on JAX's
replayed draws: partition p = h*C + c's step i draws from ``fold_in(split(
block_key, cpb)[i], p)``. The serve route takes random occupancies and
shed tallies [H, C, cpb]. Every comparison is bit-exact: each block's
summed stats and the drain's, every partition's balances, backups, stamps,
step, log entries and heads, the counters (but for the dispatch pair: JAX
counts ``dispatch_xla``, the port ``dispatch_pallas``) and the event
rings. JAX's overlap route is not held against: its own pin is red (ROADMAP
§C.5); the port's overlap route is held against its own serve route."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from dint_tpu import recovery as jrecovery
from dint_tpu.parallel import multihost_sb as jmh
from dint_tpu_torch import convert, recovery
from dint_tpu_torch.monitor import counters as mon
from dint_tpu_torch.monitor import txnevents as txe
from dint_tpu_torch.monitor import txntrace as tt
from dint_tpu_torch.monitor import waves
from dint_tpu_torch.ops import u32
from dint_tpu_torch.parallel import dense_sharded_sb as dsb
from dint_tpu_torch.parallel import multihost as mhost
from dint_tpu_torch.parallel import multihost_sb as mh
from dint_tpu_torch.tables import log as logring

from test_torch_dense_sharded_sb import (block_draws, block_key, jax_state,
                                         ring_words)
from test_torch_lock_engines import assert_same

SHAPES = [(3, 2), (4, 2)]
N = 512                 # global accounts
W = 32
CPB = 2
BLOCKS = 2
LOG_CAP = 256
DISPATCH = ("dispatch_xla", "dispatch_pallas")


def serve_args(shape, seed=42):
    """Random occupancies (0..W) and shed tallies [H, C, cpb] a block."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, W + 1, shape + (CPB,)).astype(np.int32),
             rng.integers(0, 5, shape + (CPB,)).astype(np.int32))
            for _ in range(BLOCKS)]


def flat_ring(buf, head, p):
    """Partition p's ring of JAX's stacked [H, C, ...] ring leaves."""
    buf, head = np.asarray(buf), np.asarray(head)
    return (buf.reshape((-1,) + buf.shape[2:])[p],
            head.reshape((-1,) + head.shape[2:])[p])


@functools.lru_cache(maxsize=None)
def jax_reference(shape, route: str):
    """JAX's monitored run of ``route`` ("hier", "flat", "serve" = hier
    with `serve_args`, or "trace" = hier with the recorder at rate 1.0)
    over BLOCKS blocks + the drain."""
    mesh = jmh.make_mesh_2d(*shape)
    state = jmh.create_multihost_sb(mesh, N, log_capacity=LOG_CAP)
    start = jax_state(state)
    trace, serve = route == "trace", route == "serve"
    run, init, drain = jmh.build_multihost_sb_runner(
        mesh, N, w=W, cohorts_per_block=CPB, hierarchical=route != "flat",
        monitor=True, trace=trace, trace_rate=1.0 if trace else None,
        serve=serve)
    carry = init(state)
    stats, rings = [], []
    for i in range(BLOCKS):
        args = serve_args(shape)[i] if serve else ()
        carry, s = run(carry, block_key(i), *args)
        stats.append(np.array(s))
        if trace:
            rings.append((np.array(carry[2].buf), np.array(carry[2].head)))
    out = drain(carry)
    ref = {"start": start, "stats": stats, "rings": rings,
           "tail": np.array(out[1]), "end": jax_state(out[0]),
           "counters": np.array(out[-1].buf).view(np.uint32)
           .reshape(-1, mon.N_COUNTERS),
           "cap": init.trace_cfg.cap if trace else None}
    if trace:
        ref["ring_end"] = (np.array(out[2].buf), np.array(out[2].head))
    return ref


@functools.lru_cache(maxsize=None)
def port_reference(shape, route: str):
    """The port's run of ``route`` from JAX's start state on JAX's draws,
    every block's stats (and rings) compared with JAX's on the way.
    Returns (states, summed stats, counters [D, N_COUNTERS], event
    records)."""
    ref = jax_reference(shape, route)
    d = shape[0] * shape[1]
    mesh = mh.make_mesh_2d(*shape, device="cpu")
    states = convert.multihost_sb_from_numpy(ref["start"], "cpu")
    trace, serve = route == "trace", route == "serve"
    run, init, drain = mh.build_multihost_sb_runner(
        mesh, N, w=W, cohorts_per_block=CPB, hierarchical=route != "flat",
        monitor=True, trace=trace, trace_rate=1.0 if trace else None,
        serve=serve)
    carry = init(states)
    total = np.zeros(mh.N_STATS, np.int64)
    records = []

    def same_rings(window, rings, want):
        for p, ring in enumerate(rings):
            got = ring_words(ring.buf, ring.head, ring.cap)
            exp = ring_words(*flat_ring(want[0], want[1], p), ref["cap"])
            assert np.array_equal(got[0], exp[0]) and got[1] == exp[1], \
                (window, p)
            records.append({"type": "txnevents", "window": window,
                            "device": p, "events": txe.decode(
                                ring.buf, ring.head, ring.cap)
                            .astype(np.int64).tolist()})

    for i in range(BLOCKS):
        args = tuple(torch.from_numpy(a) for a in serve_args(shape)[i]) \
            if serve else ()
        carry, s = run.run_draws(carry, *block_draws(block_key(i), n=d),
                                 *args)
        assert np.array_equal(ref["stats"][i], s.numpy()), i
        total += s.numpy().sum(axis=0)
        if trace:
            same_rings(i, carry[2], ref["rings"][i])
    out = drain(carry)
    assert np.array_equal(ref["tail"], out[1].numpy())
    total += out[1].numpy().sum(axis=0)
    if trace:
        same_rings(BLOCKS, out[2], ref["ring_end"])
    cnt = np.stack([u32.to_numpy(c.buf) for c in out[-1]])
    return out[0], total, cnt, records


def closes(total):
    return (total[mh.STAT_COMMITTED] + total[mh.STAT_AB_LOCK]
            + total[mh.STAT_AB_LOGIC] == total[mh.STAT_ATTEMPTED])


# ------------------------------------------------------------ JAX parity


@pytest.mark.parametrize("route", ["hier", "flat", "serve"])
@pytest.mark.parametrize("shape", SHAPES)
def test_route_bit_identical_to_jax(shape, route):
    """Each route's stats, balances, backups, stamps, steps, log entries
    and heads equal JAX's; the flat route's whole state equals the
    hierarchical route's."""
    ref = jax_reference(shape, route)
    states, total, _, _ = port_reference(shape, route)
    got = convert.multihost_sb_to_numpy(states, shape)
    assert_same(ref["end"], got)
    hier = convert.multihost_sb_to_numpy(port_reference(shape, "hier")[0],
                                         shape)
    if route == "flat":
        assert_same(hier, got)
    d = shape[0] * shape[1]
    if route == "serve":
        occ = sum(int(o.sum()) for o, _ in serve_args(shape))
        assert total[mh.STAT_ATTEMPTED] == occ < BLOCKS * CPB * W * d
    else:
        assert total[mh.STAT_ATTEMPTED] == BLOCKS * CPB * W * d
    assert total[mh.STAT_COMMITTED] > 0 and closes(total)
    assert total[mh.STAT_OVERFLOW] == 0


@pytest.mark.parametrize("route", ["hier", "flat", "serve"])
@pytest.mark.parametrize("shape", SHAPES)
def test_monitor_counters_bit_identical_to_jax(shape, route):
    """Each partition's counters equal JAX's row for row but for the
    dispatch pair; the per-axis route split reconciles (route_ici +
    route_dcn == lock_requests + install_writes), the serve trio with the
    occupancies and shed tallies, the sums with the stats."""
    ref = jax_reference(shape, route)
    _, total, pbuf, _ = port_reference(shape, route)
    jbuf = ref["counters"]
    d = shape[0] * shape[1]
    assert jbuf.shape == pbuf.shape == (d, mon.N_COUNTERS)
    idx = mon.COUNTER_INDEX
    same = [i for i in range(mon.N_COUNTERS)
            if i not in (idx[k] for k in DISPATCH)]
    assert np.array_equal(jbuf[:, same], pbuf[:, same])
    steps = np.full(d, BLOCKS * CPB + 1, np.uint32)
    assert np.array_equal(pbuf[:, idx["dispatch_pallas"]], steps)
    assert not pbuf[:, idx["dispatch_xla"]].any()
    snap = mon.snapshot(pbuf)
    assert snap["route_ici_lanes"] + snap["route_dcn_lanes"] \
        == snap["lock_requests"] + snap["install_writes"] > 0
    assert snap["route_ici_lanes"] > 0 and snap["route_dcn_lanes"] > 0
    for name, stat in (("txn_attempted", mh.STAT_ATTEMPTED),
                       ("txn_committed", mh.STAT_COMMITTED),
                       ("ab_lock", mh.STAT_AB_LOCK),
                       ("ab_logic", mh.STAT_AB_LOGIC),
                       ("route_overflow", mh.STAT_OVERFLOW)):
        assert snap[name] == total[stat], name
    assert snap["repl_push_hop1"] == snap["repl_push_hop2"] \
        == snap["install_writes"] == snap["log_appends"] > 0
    if route == "serve":
        args = serve_args(shape)
        assert snap["serve_occupancy_lanes"] == sum(int(o.sum())
                                                    for o, _ in args)
        assert snap["serve_occupancy_lanes"] + snap["serve_padded_lanes"] \
            == BLOCKS * CPB * W * d
        assert snap["serve_shed_lanes"] == sum(int(s.sum())
                                               for _, s in args)
    else:
        assert snap["serve_occupancy_lanes"] == snap["serve_padded_lanes"] \
            == snap["serve_shed_lanes"] == 0
    assert snap["route_prefetch_lanes"] == 0


@pytest.mark.parametrize("shape", SHAPES)
def test_trace_rings_bit_identical_and_span_tree_crosses_hosts(shape):
    """At rate 1.0 every partition's ring words and head equal JAX's in
    every window; the ROUTE events with ROUTE_DCN are the lanes the
    route_dcn counter counts at the lock route, and a committed txn's
    route, owner locks, vote, install, both hops and outcome join into
    one span tree over partitions on different hosts."""
    ref = jax_reference(shape, "trace")
    states, total, pbuf, records = port_reference(shape, "trace")
    assert_same(jax_reference(shape, "hier")["end"],
                convert.multihost_sb_to_numpy(states, shape))
    snap = mon.snapshot(pbuf)
    assert snap["trace_dropped"] == 0 and ref["cap"] > 0
    events = tt.decode_records({"type": "txnmeta",
                                "waves": list(waves.ALL_WAVES)}, records)
    kinds = {}
    for e in events:
        kinds[e["kind_name"]] = kinds.get(e["kind_name"], 0) + 1
    assert kinds["route"] == snap["lock_requests"] == kinds["lock"] > 0
    assert kinds["vote"] == kinds["outcome"] == total[mh.STAT_ATTEMPTED]
    assert kinds["repl"] == snap["repl_push_hop1"] + snap["repl_push_hop2"]
    n_ici = shape[1]
    dcn = [e for e in events
           if e["kind"] == txe.EV_ROUTE and e["aux"] & txe.ROUTE_DCN]
    assert 0 < len(dcn) < kinds["route"]
    for e in dcn[:50]:
        dest = e["aux"] & ~txe.ROUTE_DCN
        assert dest // n_ici != e["shard"] // n_ici
    full = {txe.EV_ROUTE, txe.EV_LOCK, txe.EV_VOTE, txe.EV_INSTALL,
            txe.EV_REPL, txe.EV_OUTCOME}
    groups = tt.by_txn(events)
    cands = [t for t, g in groups.items()
             if {e["kind"] for e in g} >= full
             and any(e["kind"] == txe.EV_ROUTE
                     and e["aux"] & txe.ROUTE_DCN for e in g)
             and len({e["shard"] // n_ici for e in g}) >= 3
             and tt.span_tree(t, g)["outcome"] == "commit"]
    assert cands, "no committed txn whose journey crosses hosts"
    text = tt.format_tree(tt.span_tree(cands[0], groups[cands[0]]))
    for token in ("route", "[dcn]", "granted", "vote", "install",
                  "repl hop=1", "repl hop=2", "commit"):
        assert token in text, (token, text)


# ------------------------------------------------------ the port's own


def _port_blocks(states, run, init, drain, blocks=3, seed=7, serve=None):
    """``blocks`` blocks of torch-drawn cohorts from one generator (serve
    occupancies and shed tallies from ``serve``, one pair a block), then
    the drain: (states, each block's stats, the drain's)."""
    carry = init(states)
    gen = torch.Generator().manual_seed(seed)
    stats = []
    for i in range(blocks):
        args = tuple(torch.from_numpy(a) for a in serve[i]) if serve else ()
        carry, s = run(carry, gen, *args)
        stats.append(s.numpy())
    out = drain(carry)
    return out[0], stats, out[1].numpy()


def _mh_states(mesh):
    return mh.create_multihost_sb(mesh, N, log_capacity=LOG_CAP)


@pytest.mark.parametrize("shape", SHAPES)
def test_2d_routes_equal_the_1d_runner(shape):
    """At D = H*C the hierarchical and flat routes give the 1-D runner's
    stats every block and through the drain, and its primaries; the
    backups sit at hosts h+1 and h+2, the same chip, where the 1-D
    runner's sit at p+1 and p+2."""
    d = shape[0] * shape[1]
    mesh1 = dsb.make_mesh(d, device="cpu")
    r1 = _port_blocks(
        dsb.create_sharded_sb(mesh1, d, N, log_capacity=LOG_CAP),
        *dsb.build_sharded_sb_runner(mesh1, d, N, w=W,
                                     cohorts_per_block=CPB))
    mesh2 = mh.make_mesh_2d(*shape, device="cpu")
    for hier in (True, False):
        st, stats, tail = _port_blocks(
            _mh_states(mesh2), *mh.build_multihost_sb_runner(
                mesh2, N, w=W, cohorts_per_block=CPB, hierarchical=hier))
        assert all(np.array_equal(a, b) for a, b in zip(r1[1], stats))
        assert np.array_equal(r1[2], tail)
        for a, b in zip(r1[0], st):
            for name in ("bal", "x_step", "s_step"):
                assert torch.equal(getattr(a, name), getattr(b, name))
            assert a.step == b.step
        m1 = st[0].bal.shape[0]
        for p in range(d):
            for off in (1, 2):
                q = mesh2.shift(p, mh.DCN_AXIS, off)
                assert mesh2.axis_index(q, mh.ICI_AXIS) \
                    == mesh2.axis_index(p, mh.ICI_AXIS)
                assert torch.equal(st[q].bck_bal[(off - 1) * m1:off * m1],
                                   st[p].bal), (p, off)
        assert mh.total_balance_global(st) == dsb.total_balance_global(r1[0])
    total = sum(s.astype(np.int64).sum(axis=0) for s in r1[1]) \
        + r1[2].astype(np.int64).sum(axis=0)
    assert closes(total) and total[mh.STAT_OVERFLOW] == 0


def test_monitor_reconciles_the_per_axis_route_split():
    """Over 4 hosts ~3/4 of the routed lanes pay the DCN hop; the split
    counts every routed lane once."""
    mesh = mh.make_mesh_2d(4, 2, device="cpu")
    run, init, drain = mh.build_multihost_sb_runner(
        mesh, N, w=W, cohorts_per_block=CPB, hierarchical=True,
        monitor=True)
    carry = init(mh.create_multihost_sb(mesh, N, log_capacity=LOG_CAP))
    gen = torch.Generator().manual_seed(7)
    total = np.zeros(mh.N_STATS, np.int64)
    for _ in range(3):
        carry, s = run(carry, gen)
        total += s.numpy().sum(axis=0)
    _, tail, cnt = drain(carry)
    total += tail.numpy().sum(axis=0)
    snap = mon.snapshot(cnt)
    assert snap["txn_attempted"] == total[mh.STAT_ATTEMPTED]
    assert snap["txn_committed"] == total[mh.STAT_COMMITTED]
    assert snap["route_ici_lanes"] + snap["route_dcn_lanes"] \
        == snap["lock_requests"] + snap["install_writes"]
    assert snap["route_dcn_lanes"] > snap["route_ici_lanes"]


@pytest.mark.parametrize("shape", SHAPES)
def test_serve_full_occupancy_replays_the_closed_loop(shape):
    """serve=True at occ == w: the closed loop's stats every block and
    through the drain, its final state."""
    mesh = mh.make_mesh_2d(*shape, device="cpu")
    full = (np.full(shape + (CPB,), W, np.int32),
            np.zeros(shape + (CPB,), np.int32))
    a = _port_blocks(_mh_states(mesh), *mh.build_multihost_sb_runner(
        mesh, N, w=W, cohorts_per_block=CPB))
    b = _port_blocks(_mh_states(mesh), *mh.build_multihost_sb_runner(
        mesh, N, w=W, cohorts_per_block=CPB, serve=True),
        serve=[full] * 3)
    assert all(np.array_equal(x, y) for x, y in zip(a[1], b[1]))
    assert np.array_equal(a[2], b[2])
    assert_same(convert.multihost_sb_to_numpy(a[0], shape),
                convert.multihost_sb_to_numpy(b[0], shape))


@pytest.mark.parametrize("shape", SHAPES)
def test_overlap_route_equals_the_unoverlapped_serve_route(shape):
    """The double-buffered route reorders the work, not the result: on the
    same draws and random occupancies the run + drain totals, the counters
    but the step count and the prefetch ledger, and the whole final state
    (balances, backups, stamps, steps, log rings) equal the unoverlapped
    serve route's; the overlap drain is two flush steps."""
    mesh = mh.make_mesh_2d(*shape, device="cpu")
    occ = serve_args(shape, seed=5) + serve_args(shape, seed=6)[:1]
    out = {}
    for ov in (False, True):
        run, init, drain = mh.build_multihost_sb_runner(
            mesh, N, w=W, cohorts_per_block=CPB, serve=True, overlap=ov,
            monitor=True)
        carry = init(mh.create_multihost_sb(mesh, N, log_capacity=LOG_CAP))
        gen = torch.Generator().manual_seed(11)
        total = np.zeros(mh.N_STATS, np.int64)
        for o, s in occ:
            carry, st = run(carry, gen, torch.from_numpy(o),
                            torch.from_numpy(s))
            total += st.numpy().sum(axis=0)
        states, tail, cnt = drain(carry)
        assert tail.shape == (2 if ov else 1, mh.N_STATS)
        total += tail.numpy().sum(axis=0)
        out[ov] = (convert.multihost_sb_to_numpy(states, shape), total,
                   mon.snapshot(cnt))
    (a, ta, ca), (b, tb, cb) = out[False], out[True]
    assert_same(a, b)
    assert np.array_equal(ta, tb) and closes(ta)
    d = shape[0] * shape[1]
    assert ta[mh.STAT_ATTEMPTED] == sum(int(o.sum()) for o, _ in occ) \
        < len(occ) * CPB * W * d
    assert ca["route_prefetch_lanes"] == 0
    assert cb["route_prefetch_lanes"] == cb["lock_requests"] > 0
    assert cb["steps"] == ca["steps"] + d
    for k in ca:
        if k not in ("steps", "route_prefetch_lanes", *DISPATCH):
            assert ca[k] == cb[k], k


def test_two_hosts_refused_everywhere():
    mesh = mh.make_mesh_2d(2, 4, device="cpu")
    with pytest.raises(ValueError, match="3 hosts"):
        mh.create_multihost_sb(mesh, N)
    with pytest.raises(ValueError, match="3 hosts"):
        mh.build_multihost_sb_runner(mesh, N, w=W)
    with pytest.raises(ValueError, match="n_hosts=2"):
        mhost.build_multihost_runner(mesh, 8 * 128, w=W, val_words=4)
    with pytest.raises(ValueError, match="3 hosts"):
        jmh.build_multihost_sb_runner(jmh.make_mesh_2d(2, 4), N, w=W)


def test_overlap_and_serve_guards_and_shapes():
    mesh = mh.make_mesh_2d(3, 2, device="cpu")
    with pytest.raises(ValueError, match="serve=True"):
        mh.build_multihost_sb_runner(mesh, N, w=W, overlap=True)
    with pytest.raises(ValueError, match="trace"):
        mh.build_multihost_sb_runner(mesh, N, w=W, serve=True,
                                     overlap=True, trace=True)
    run, init, _ = mh.build_multihost_sb_runner(
        mesh, N, w=W, cohorts_per_block=CPB, serve=True)
    carry = init(mh.create_multihost_sb(mesh, N, log_capacity=LOG_CAP))
    bits, amt = block_draws(block_key(0), n=6)
    with pytest.raises(ValueError, match="takes occ and shed"):
        run.run_draws(carry, bits, amt)
    with pytest.raises(ValueError, match="expected occ"):
        z = torch.zeros((6, CPB), dtype=torch.int32)
        run.run_draws(carry, bits, amt, z, z)
    with pytest.raises(ValueError, match="expected bits"):
        run.run_draws(carry, bits[:, :4], amt[:, :4])


def test_mesh_shape_from_env(monkeypatch):
    monkeypatch.delenv("DINT_BENCH_MESH", raising=False)
    assert mh.mesh_shape_from_env() == (4, 2)
    for spec, want in (("3x2", (3, 2)), ("4*2", (4, 2)), ("8X1", (8, 1))):
        monkeypatch.setenv("DINT_BENCH_MESH", spec)
        assert mh.mesh_shape_from_env() == want
    monkeypatch.setenv("DINT_BENCH_MESH", "banana")
    with pytest.raises(ValueError, match="DINT_BENCH_MESH"):
        mh.mesh_shape_from_env()


# ------------------------------------------------------------- recovery


def test_lost_partition_rebuilds_from_a_holder_on_another_host():
    """Partition (1, 0) of 3x2 rebuilds from its own ring and from host
    2's and host 0's at chip 0 (its backups), through the numpy path with
    the source-tag check, the torch twin and JAX's functions."""
    shape = (3, 2)
    mesh = mh.make_mesh_2d(*shape, device="cpu")
    states = port_reference(shape, "hier")[0]
    dead = mesh.flat((1, 0))
    want = u32.to_numpy(states[dead].bal)
    bal0 = mh.create_multihost_sb(mesh, N, log_capacity=LOG_CAP)[dead].bal
    assert not np.array_equal(u32.to_numpy(bal0), want)
    holders = [dead, mesh.flat((2, 0)), mesh.flat((0, 0))]
    assert holders[1:] == [mesh.shift(dead, mh.DCN_AXIS, o) for o in (1, 2)]
    for holder in holders:
        log = states[holder].log
        ents = logring.replica_entries(log, 0)
        rec = recovery.recover_sb_shard(N, dead, mesh.size, ents, log.head,
                                        ring_owner=holder)
        assert np.array_equal(rec, want), holder
        rep = recovery.replay_sb_shard(bal0, ents, log.head, dead=dead,
                                       n_shards=mesh.size)
        assert np.array_equal(u32.to_numpy(rep), want), holder
        je, jh = u32.to_numpy(ents), u32.to_numpy(log.head)
        assert np.array_equal(jrecovery.recover_sb_shard(
            N, dead, mesh.size, je, jh, ring_owner=holder), want)
    with pytest.raises(ValueError, match="source tags"):
        log = states[holders[1]].log
        recovery.recover_sb_shard(N, dead, mesh.size,
                                  logring.replica_entries(log, 0), log.head,
                                  ring_owner=mesh.flat((2, 1)))


# ------------------------------------------------------------- the pieces


@pytest.mark.parametrize("hierarchical", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_exchanges_against_jax_all_to_all(shape, hierarchical):
    """The runner's exchange of seeded [D*cap, 3] buckets equals JAX's
    (the ici-then-dcn `all_to_all` pair, or the tuple-axis one) inside a
    `shard_map` over the 2-D mesh, and both equal the 1-D exchange."""
    h, c = shape
    d, cap = h * c, 5
    rng = np.random.default_rng(d + hierarchical)
    xs = rng.integers(-(1 << 31), 1 << 31, (d, d * cap, 3),
                      dtype=np.int64).astype(np.int32)

    def jex(x):                        # JAX's _exchange of one field
        if hierarchical:
            x3 = x.reshape(h, c, cap)
            x3 = jax.lax.all_to_all(x3, mh.ICI_AXIS, 1, 1, tiled=False)
            x3 = jax.lax.all_to_all(x3, mh.DCN_AXIS, 0, 0, tiled=False)
            return x3.reshape(d * cap)
        return jax.lax.all_to_all(x.reshape(d, cap),
                                  (mh.DCN_AXIS, mh.ICI_AXIS), 0, 0,
                                  tiled=False).reshape(d * cap)

    jmesh = jmh.make_mesh_2d(h, c)
    grid = JP(mh.DCN_AXIS, mh.ICI_AXIS)
    fn = jax.jit(jax.shard_map(
        lambda x: jax.vmap(jex, in_axes=1, out_axes=1)(x[0, 0])[None, None],
        mesh=jmesh, in_specs=grid, out_specs=grid))
    jout = np.asarray(fn(jnp.asarray(xs.reshape(h, c, d * cap, 3))))
    jout = jout.reshape(d, d * cap, 3)
    mesh = mh.make_mesh_2d(h, c, device="cpu")
    got = mh.exchange(mesh, [torch.from_numpy(x) for x in xs], cap,
                      hierarchical)
    flat = dsb._a2a(dsb.make_mesh(d, device="cpu"),
                    [torch.from_numpy(x) for x in xs])
    for p in range(d):
        assert np.array_equal(jout[p], got[p].numpy()), p
        assert torch.equal(flat[p], got[p]), p


@pytest.mark.parametrize("shape", SHAPES)
def test_create_total_and_convert_against_jax(shape):
    n = N + 5                             # uneven: the last rows are pad
    jst = jmh.create_multihost_sb(jmh.make_mesh_2d(*shape), n,
                                  init_balance=7, log_capacity=LOG_CAP)
    mesh = mh.make_mesh_2d(*shape, device="cpu")
    pst = mh.create_multihost_sb(mesh, n, init_balance=7,
                                 log_capacity=LOG_CAP)
    assert_same(jax_state(jst), convert.multihost_sb_to_numpy(pst, shape))
    assert mh.total_balance_global(pst) == jmh.total_balance_global(jst)
    back = convert.multihost_sb_from_numpy(jax_state(jst), "cpu")
    assert len(back) == mesh.size
    assert_same(jax_state(jst), convert.multihost_sb_to_numpy(back, shape))
    ptrs = {t.untyped_storage().data_ptr() for st in pst
            for t in (st.bal, st.bck_bal, st.x_step, st.s_step)}
    assert len(ptrs) == 4 * mesh.size      # no view shares a storage
    big = mh.create_multihost_sb(mesh, n, init_balance=(1 << 31) - 1,
                                 log_capacity=LOG_CAP)
    jbig = jmh.create_multihost_sb(jmh.make_mesh_2d(*shape), n,
                                   init_balance=(1 << 31) - 1,
                                   log_capacity=LOG_CAP)
    assert mh.total_balance_global(big) == jmh.total_balance_global(jbig)
