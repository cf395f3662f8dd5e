"""The port's sharded dense SmallBank (dint_tpu_torch.parallel.
dense_sharded_sb) against `dint_tpu.parallel.dense_sharded_sb` on the CPU,
its recovery (`recovery.recover_sb_shard`, `replay_sb_shard`) and its
pieces (`_positions`, `_route`, `_a2a`, `Mesh.all_to_all`).

JAX runs its runner over 4 of the 8 virtual CPU devices
(tests/conftest.py) on its XLA route; its fused route does not run on this
jax (the `pallas_call` out shapes need a ``vma`` under ``check_vma``), so
the port's fused routes are held against JAX's XLA route, which JAX's own
tests pin equal to its fused route. The port runs the 4 partitions as a
list on the CPU, where its kernels take their plain versions, on JAX's
replayed draws: partition d's step i draws ``bits(kgen, (w, 5))`` and
``randint(kamt, (w,), -20, 21)`` with ``kgen, kamt = split(fold_in(
split(block_key, cpb)[i], d))``; the drain draws nothing the port needs.
Every comparison is bit-exact: each block's summed stats and the drain's,
every partition's balances, backups, stamps, step, mirrors, log entries
and heads, the counters and the event rings."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from dint_tpu import recovery as jrecovery
from dint_tpu.parallel import dense_sharded_sb as jdsb
from dint_tpu_torch import convert, recovery
from dint_tpu_torch.clients import workloads as wl
from dint_tpu_torch.monitor import counters as mon
from dint_tpu_torch.monitor import txnevents as txe
from dint_tpu_torch.monitor import txntrace as tt
from dint_tpu_torch.monitor import waves
from dint_tpu_torch.ops import u32
from dint_tpu_torch.parallel import dense_sharded_sb as dsb
from dint_tpu_torch.parallel.mesh import Mesh
from dint_tpu_torch.tables import log as logring

from test_torch_lock_engines import assert_same

D = 4
N = 512                 # global accounts
W = 32
CPB = 2
BLOCKS = 2
LOG_CAP = 256
SEED = 3
HOT = ("hot_bal", "hot_x", "hot_s", "hot_loc")


def jax_state(st) -> dict:
    """JAX's stacked SBShard as the dict `convert.sharded_sb_*` carries."""
    out = {"bal": np.array(st.bal), "bck_bal": np.array(st.bck_bal),
           "x_step": np.array(st.x_step), "s_step": np.array(st.s_step),
           "step": np.array(st.step), "log.entries": np.array(st.log.entries),
           "log.head": np.array(st.log.head), "lanes": st.log.lanes,
           "replicas": st.log.replicas}
    if st.hot_bal is not None:
        out.update(hot_bal=np.array(st.hot_bal), hot_x=np.array(st.hot_x),
                   hot_s=np.array(st.hot_s), hot_loc=st.hot_loc)
    return out


def cold(arrays: dict) -> dict:
    return {k: v for k, v in arrays.items() if k not in HOT}


def block_draws(block_key, n=D, w=W, cpb=CPB):
    """JAX's block: partition d's step i draws from fold_in(split(
    block_key, cpb)[i], d), split into (kgen, kamt)."""
    bits, amt = [], []
    for k in jax.random.split(block_key, cpb):
        rb, ra = [], []
        for d in range(n):
            kgen, kamt = jax.random.split(jax.random.fold_in(k, d))
            rb.append(np.asarray(jax.random.bits(kgen, (w, 5), jnp.uint32)))
            ra.append(np.asarray(jax.random.randint(
                kamt, (w,), -20, 21, dtype=jnp.int32)))
        bits.append(rb)
        amt.append(ra)
    return u32.from_numpy(np.array(bits), "cpu"), torch.from_numpy(
        np.array(amt))


def block_key(i, seed=SEED):
    return jax.random.fold_in(jax.random.PRNGKey(seed), i)


def ring_words(buf, head, cap):
    """The recorded u32 words and the head of one partition's ring (a
    port tensor or a JAX array)."""
    buf, head = (np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
                 for x in (buf, head))
    return (buf.reshape(-1)[:cap * txe.WORDS].astype(np.int64) & u32.MASK32,
            int(head.astype(np.int64)) & u32.MASK32)


# adversarial routing: every txn on one hot account, so each partition aims
# all its lanes at one or two owners and their buckets overflow
OVERFLOW = dict(hot_frac=1.0 / N, hot_prob=1.0)


@functools.lru_cache(maxsize=None)
def jax_reference(route: str):
    """JAX's monitored XLA run of ``route`` ("default", "hot", "trace" =
    default with the recorder at rate 1.0, or "overflow") over BLOCKS
    blocks + the drain: its start state, every block's stats and rings,
    the drain's stats, its end state, counters and rings."""
    mesh = jdsb.make_mesh(D)
    state = jdsb.create_sharded_sb(mesh, D, N, log_capacity=LOG_CAP)
    start = jax_state(state)
    trace = route == "trace"
    kw = OVERFLOW if route == "overflow" else {}
    run, init, drain = jdsb.build_sharded_sb_runner(
        mesh, D, N, w=W, cohorts_per_block=CPB, use_pallas=False,
        use_fused=False, use_hotset=route == "hot", monitor=True,
        trace=trace, trace_rate=1.0 if trace else None, **kw)
    carry = init(state)
    stats, rings = [], []
    for i in range(BLOCKS):
        carry, s = run(carry, block_key(i))
        stats.append(np.array(s))
        if trace:
            rings.append((np.array(carry[2].buf), np.array(carry[2].head)))
    out = drain(carry)
    ref = {"start": start, "stats": stats, "rings": rings,
           "tail": np.array(out[1]), "end": jax_state(out[0]),
           "counters": np.array(out[-1].buf).view(np.uint32),
           "cap": init.trace_cfg.cap if trace else None}
    if trace:
        ref["ring_end"] = (np.array(out[2].buf), np.array(out[2].head))
    return ref


def port_run(ref, *, use_hotset=False, use_fused=False, trace=False,
             **kw):
    """The port's monitored run from JAX's start state on JAX's draws;
    every block's stats (and rings) compared with ``ref``'s. Returns the
    end states, the summed stats, the counters [D, N_COUNTERS] and the
    event records of every window (one a partition a window)."""
    mesh = dsb.make_mesh(D, device="cpu")
    states = convert.sharded_sb_from_numpy(ref["start"], "cpu")
    run, init, drain = dsb.build_sharded_sb_runner(
        mesh, D, N, w=W, cohorts_per_block=CPB, use_hotset=use_hotset,
        use_fused=use_fused, monitor=True, trace=trace,
        trace_rate=1.0 if trace else None, **kw)
    carry = init(states)
    total = np.zeros(dsb.N_STATS, np.int64)
    records = []

    def same_rings(window, rings, want):
        for p, ring in enumerate(rings):
            got = ring_words(ring.buf, ring.head, ring.cap)
            exp = ring_words(want[0][p], want[1][p], ref["cap"])
            assert np.array_equal(got[0], exp[0]) and got[1] == exp[1], \
                (window, p)
            records.append({"type": "txnevents", "window": window,
                            "device": p, "events": txe.decode(
                                ring.buf, ring.head, ring.cap)
                            .astype(np.int64).tolist()})

    for i in range(BLOCKS):
        carry, s = run.run_draws(carry, *block_draws(block_key(i)))
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


@functools.lru_cache(maxsize=None)
def port_reference(route: str):
    """`port_run` of each route against its JAX twin ("fused" and
    "fused+hot" against JAX's XLA routes)."""
    jref = {"default": "default", "hot": "hot", "fused": "default",
            "fused+hot": "hot", "trace": "trace",
            "overflow": "overflow"}[route]
    kw = dict(use_hotset="hot" in route, use_fused="fused" in route,
              trace=route == "trace")
    if route == "overflow":
        kw.update(OVERFLOW)
    return jax_reference(jref), port_run(jax_reference(jref), **kw)


def closes(total):
    return (total[dsb.STAT_COMMITTED] + total[dsb.STAT_AB_LOCK]
            + total[dsb.STAT_AB_LOGIC] == total[dsb.STAT_ATTEMPTED])


# ------------------------------------------------------------ JAX parity


@pytest.mark.parametrize("route", ["default", "hot", "fused", "fused+hot"])
def test_route_bit_identical_to_jax(route):
    """Each route's stats, tables, backups, stamps, logs and heads (and
    the hot routes' mirrors) equal JAX's XLA route; the main tables of
    every route equal the default route's."""
    ref, (states, total, _, _) = port_reference(route)
    got = convert.sharded_sb_to_numpy(states)
    assert_same(ref["end"], got)
    assert_same(cold(jax_reference("default")["end"]), cold(got))
    assert ("hot_bal" in got) == ("hot" in route)
    assert total[dsb.STAT_ATTEMPTED] == BLOCKS * CPB * W * D
    assert total[dsb.STAT_COMMITTED] > 0 and closes(total)
    assert total[dsb.STAT_OVERFLOW] == 0


@pytest.mark.parametrize("route", ["default", "hot", "fused+hot"])
def test_monitor_counters_bit_identical_to_jax(route):
    """Each partition's counters equal JAX's [D, N] buffer row for row but
    for the pairs that differ by design: the dispatch pair (JAX's XLA
    route counts ``dispatch_xla``, the port ``dispatch_pallas``), on the
    hot route ``hot_refresh_bytes`` (the port counts what JAX's kernel
    route does), and on the fused route the partition counters and the
    fused dispatch, which JAX's XLA route does not take. The sums
    reconcile with the stats."""
    ref, (_, total, pbuf, _) = port_reference(route)
    jbuf = ref["counters"]
    assert jbuf.shape == pbuf.shape == (D, mon.N_COUNTERS)
    idx = mon.COUNTER_INDEX
    skip = {idx["dispatch_xla"], idx["dispatch_pallas"]}
    if "hot" in route:
        skip.add(idx["hot_refresh_bytes"])
    if "fused" in route:
        skip |= {idx["hot_hits"], idx["hot_cold_rows"],
                 idx["fused_dispatch"]}
    same = [i for i in range(mon.N_COUNTERS) if i not in skip]
    assert np.array_equal(jbuf[:, same], pbuf[:, same])
    steps = np.full(D, BLOCKS * CPB + 1, np.uint32)
    assert np.array_equal(jbuf[:, idx["dispatch_xla"]], steps)
    assert np.array_equal(pbuf[:, idx["dispatch_pallas"]], steps)
    assert not pbuf[:, idx["dispatch_xla"]].any()
    snap = mon.snapshot(pbuf)
    if route == "hot":
        hot_loc = ref["end"]["hot_loc"]
        assert np.array_equal(pbuf[:, idx["hot_refresh_bytes"]],
                              steps * 3 * 2 * hot_loc * 4)
        assert snap["hot_hits"] > 0
    if "fused" in route:
        assert snap["fused_dispatch"] == D * (BLOCKS * CPB + 1)
        assert snap["hot_hits"] == snap["hot_cold_rows"] == 0
    for name, stat in (("txn_attempted", dsb.STAT_ATTEMPTED),
                       ("txn_committed", dsb.STAT_COMMITTED),
                       ("ab_lock", dsb.STAT_AB_LOCK),
                       ("ab_logic", dsb.STAT_AB_LOGIC),
                       ("route_overflow", dsb.STAT_OVERFLOW)):
        assert snap[name] == total[stat], name
    assert snap["repl_push_hop1"] == snap["repl_push_hop2"] \
        == snap["install_writes"] == snap["log_appends"] > 0
    assert snap["lock_requests"] == snap["lock_granted"] \
        + snap["lock_rejected"]


def test_trace_rings_bit_identical_and_join_into_span_trees():
    """At rate 1.0 every partition's ring words and head equal JAX's in
    every window; the events reconcile with the counters, and a committed
    cross-shard transaction's route, owner locks, vote, install, both
    replication hops and outcome join by txn id into one span tree."""
    ref, (states, total, pbuf, records) = port_reference("trace")
    assert_same(jax_reference("default")["end"],
                convert.sharded_sb_to_numpy(states))
    snap = mon.snapshot(pbuf)
    meta = {"type": "txnmeta", "waves": list(waves.ALL_WAVES)}
    events = tt.decode_records(meta, records)
    kinds = {}
    for e in events:
        kinds[e["kind_name"]] = kinds.get(e["kind_name"], 0) + 1
    assert kinds["route"] == snap["lock_requests"] == kinds["lock"] > 0
    assert kinds["vote"] == kinds["outcome"] == snap["txn_attempted"] \
        == total[dsb.STAT_ATTEMPTED]
    assert kinds["install"] == snap["install_writes"] > 0
    assert kinds["repl"] == snap["repl_push_hop1"] + snap["repl_push_hop2"]
    outcomes = {}
    for e in events:
        if e["kind"] == txe.EV_OUTCOME:
            c = txe.CAUSE_NAMES[e["aux"]]
            outcomes[c] = outcomes.get(c, 0) + 1
    assert outcomes.get("commit", 0) == snap["txn_committed"]
    assert outcomes.get("ab_lock", 0) == snap["ab_lock"]
    assert snap["trace_dropped"] == 0
    full = {txe.EV_ROUTE, txe.EV_LOCK, txe.EV_VOTE, txe.EV_INSTALL,
            txe.EV_REPL, txe.EV_OUTCOME}
    groups = tt.by_txn(events)
    cands = [t for t, g in groups.items()
             if {e["kind"] for e in g} >= full
             and {e["aux"] for e in g if e["kind"] == txe.EV_REPL} == {1, 2}
             and len({e["shard"] for e in g}) >= 2
             and tt.span_tree(t, g)["outcome"] == "commit"]
    assert cands, "no committed cross-shard txn with its whole journey"
    tree = tt.span_tree(cands[0], groups[cands[0]])
    route = [s for s in tree["spans"] if s["kind"] == txe.EV_ROUTE]
    # the owner-side work nests under the txn's routes
    assert route and any(c["kind"] == txe.EV_LOCK
                         for r in route for c in r["children"])
    text = tt.format_tree(tree)
    for token in ("route", "granted", "vote", "install", "repl hop=1",
                  "repl hop=2", "commit"):
        assert token in text, (token, text)


def test_route_overflow_bit_identical_and_reconciled():
    """Every txn on one hot account: the owners' buckets overflow; the
    overflowed lanes are lock rejects, accounting and conservation close,
    and STAT_OVERFLOW equals the route_overflow counter, as in JAX."""
    ref, (states, total, pbuf, _) = port_reference("overflow")
    assert_same(ref["end"], convert.sharded_sb_to_numpy(states))
    idx = mon.COUNTER_INDEX
    same = [i for i in range(mon.N_COUNTERS)
            if i not in (idx["dispatch_xla"], idx["dispatch_pallas"])]
    assert np.array_equal(ref["counters"][:, same], pbuf[:, same])
    assert total[dsb.STAT_OVERFLOW] > 0 and closes(total)
    assert mon.snapshot(pbuf)["route_overflow"] == total[dsb.STAT_OVERFLOW]
    base = dsb.total_balance_global(
        convert.sharded_sb_from_numpy(ref["start"], "cpu"))
    assert (dsb.total_balance_global(states) - base) % (1 << 32) \
        == int(total[dsb.STAT_BAL_DELTA]) % (1 << 32)


# ------------------------------------------------------ the port's own


def _port_only(n_accounts, w, blocks, seed=0, **kw):
    """The port's runner alone, on torch-drawn blocks: (states, total
    stats, the global balance at the start)."""
    mesh = dsb.make_mesh(D, device="cpu")
    states = dsb.create_sharded_sb(mesh, D, n_accounts, log_capacity=LOG_CAP)
    base = dsb.total_balance_global(states)
    run, init, drain = dsb.build_sharded_sb_runner(
        mesh, D, n_accounts, w=w, cohorts_per_block=CPB, **kw)
    carry = init(states)
    gen = torch.Generator().manual_seed(seed)
    total = np.zeros(dsb.N_STATS, np.int64)
    for _ in range(blocks):
        carry, s = run(carry, gen)
        total += s.numpy().sum(axis=0)
    states, tail = drain(carry)
    return states, total + tail.numpy().sum(axis=0), base


def test_accounting_closes_and_balance_conserved_globally():
    states, total, base = _port_only(4096, 128, 3)
    assert total[dsb.STAT_ATTEMPTED] == 3 * CPB * 128 * D
    assert total[dsb.STAT_COMMITTED] > 0 and closes(total)
    assert total[dsb.STAT_OVERFLOW] == 0
    assert (dsb.total_balance_global(states) - base) % (1 << 32) \
        == int(total[dsb.STAT_BAL_DELTA]) % (1 << 32)
    assert all(int(st.bal[-1]) == 0 for st in states)
    # no stamp is held after the drain: every lock expired a step ago
    t = states[0].step
    assert all(st.step == t for st in states)
    assert not any(bool((st.x_step == t - 1).any() | (st.s_step == t - 1)
                        .any()) for st in states)


def test_cross_device_transactions_commit():
    """SendPayment only: every txn X-locks two accounts, which 4-way
    round-robin puts on different partitions three times in four; the
    commits move money between partitions and none is lost."""
    mix = np.zeros(6)
    mix[wl.SB_SEND_PAYMENT] = 1.0
    states, total, base = _port_only(1 << 14, 64, 3, mix=mix, hot_prob=0.0)
    assert total[dsb.STAT_COMMITTED] > 0
    assert total[dsb.STAT_BAL_DELTA] == 0
    assert dsb.total_balance_global(states) == base
    per_part = [int(st.bal[:-1].sum()) for st in states]
    assert per_part != [per_part[0]] * D     # money crossed partitions


def test_hot_contention_rejects_across_devices():
    _, total, _ = _port_only(16, 4, 4, seed=2, hot_frac=1.0, hot_prob=1.0)
    assert total[dsb.STAT_AB_LOCK] > 0 and closes(total)


def test_backups_mirror_the_primaries():
    states = port_reference("default")[1][0]
    m1 = states[0].bal.shape[0]
    for p in range(D):
        for off in (1, 2):
            holder = states[(p + off) % D]
            slot = holder.bck_bal[(off - 1) * m1:off * m1]
            assert torch.equal(slot, states[p].bal), (p, off)
    ptrs = {t.untyped_storage().data_ptr() for st in states
            for t in (st.bal, st.bck_bal, st.x_step, st.s_step)}
    assert len(ptrs) == 4 * D


# ------------------------------------------------------------- recovery


@pytest.mark.parametrize("dead", [0, 3])
def test_lost_partition_rebuilds_from_each_ring(dead):
    """Partition ``dead``'s balances rebuild from its own ring and from
    each holder's, through the numpy path and the torch twin, equal to
    JAX's functions on the same rings."""
    states = port_reference("default")[1][0]
    want = u32.to_numpy(states[dead].bal)
    bal0 = dsb.create_sharded_sb(dsb.make_mesh(D, device="cpu"), D, N,
                                 log_capacity=LOG_CAP)[dead].bal
    assert not np.array_equal(u32.to_numpy(bal0), want)
    for holder in (dead, (dead + 1) % D, (dead + 2) % D):
        log = states[holder].log
        ents = logring.replica_entries(log, 0)
        rec = recovery.recover_sb_shard(N, dead, D, ents, log.head,
                                        ring_owner=holder)
        assert rec.dtype == np.uint32 and np.array_equal(rec, want), holder
        rep = recovery.replay_sb_shard(bal0, ents, log.head, dead=dead,
                                       n_shards=D)
        assert np.array_equal(u32.to_numpy(rep), want), holder
        je, jh = u32.to_numpy(ents), u32.to_numpy(log.head)
        assert np.array_equal(jrecovery.recover_sb_shard(
            N, dead, D, je, jh, ring_owner=holder), want)
        assert np.array_equal(np.asarray(jrecovery.replay_sb_shard(
            jnp.asarray(u32.to_numpy(bal0)), jnp.asarray(je),
            jnp.asarray(jh), dead=dead, n_shards=D)), want)


def test_ring_owner_mismatch_raises_as_jax():
    states = port_reference("default")[1][0]
    log = states[1].log
    ents = logring.replica_entries(log, 0)
    for fn, e, h in ((recovery.recover_sb_shard, ents, log.head),
                     (jrecovery.recover_sb_shard, u32.to_numpy(ents),
                      u32.to_numpy(log.head))):
        with pytest.raises(ValueError, match="source tags"):
            fn(N, 1, D, e, h, ring_owner=3)
    with pytest.raises(ValueError, match="ring wrapped"):
        recovery.recover_sb_shard(N, 1, D, ents,
                                  torch.full_like(log.head, LOG_CAP + 1))


# ------------------------------------------------------------- the pieces


@pytest.mark.parametrize("seed", [0, 1])
def test_positions_route_and_a2a_against_jax(seed):
    """Seeded lanes with masked and overflowing ones: `_positions` and
    `_route` equal JAX's, and `_a2a` over the routed buckets equals
    `jax.lax.all_to_all` inside a shard_map over 4 devices."""
    rng = np.random.default_rng(seed)
    n, cap = 96, 20                      # 96 lanes into 4 buckets of 20
    dest = rng.integers(0, D, (D, n)).astype(np.int32)
    dest[0, :40] = 2                     # partition 0 overflows bucket 2
    active = rng.random((D, n)) < 0.8
    fields = rng.integers(-(1 << 31), 1 << 31, (D, 3, n), dtype=np.int64) \
        .astype(np.int32)
    routed, jrouted = [], []
    for p in range(D):
        jpos = np.asarray(jdsb._positions(jnp.asarray(dest[p]),
                                          jnp.asarray(active[p]), D))
        pos = dsb._positions(torch.from_numpy(dest[p]),
                             torch.from_numpy(active[p]), D)
        assert np.array_equal(jpos, pos.numpy())
        valid = active[p] & (jpos < cap)
        assert p != 0 or (~valid & active[p]).any()
        jr = jdsb._route(jnp.asarray(dest[p]), jnp.asarray(jpos),
                         jnp.asarray(valid), cap, D,
                         [jnp.asarray(f) for f in fields[p]])
        r = dsb._route(torch.from_numpy(dest[p]), pos,
                       torch.from_numpy(valid), cap, D,
                       [torch.from_numpy(f) for f in fields[p]])
        assert r.shape == (D * cap, 3)
        for j in range(3):
            assert np.array_equal(np.asarray(jr[j]), r[:, j].numpy())
        routed.append(r)
        jrouted.append(np.stack([np.asarray(x) for x in jr]))
    jmesh = jdsb.make_mesh(D)
    a2a = jax.jit(jax.shard_map(
        lambda x: jax.vmap(lambda f: jdsb._a2a(f, D, cap))(x[0])[None],
        mesh=jmesh, in_specs=JP(jdsb.AXIS), out_specs=JP(jdsb.AXIS)))
    jout = np.asarray(a2a(jnp.asarray(np.stack(jrouted))))   # [D, 3, D*cap]
    out = dsb._a2a(dsb.make_mesh(D, device="cpu"), routed)
    for p in range(D):
        assert np.array_equal(jout[p].T, out[p].numpy()), p


def test_mesh_all_to_all_along_either_axis_of_a_2d_mesh():
    """Along one axis of a (3, 2) mesh, partition (h, c) receives, in slot
    s, bucket h of partition (s, c) (and likewise along the other)."""
    mesh = Mesh((3, 2), ("dcn", "ici"), device="cpu")
    xs = [torch.arange(6 * 2, dtype=torch.int32).reshape(6, 2) + 100 * p
          for p in range(6)]
    for axis, n in (("dcn", 3), ("ici", 2)):
        out = mesh.all_to_all(xs, axis)
        cap = 6 // n
        for p in range(6):
            me = mesh.axis_index(p, axis)
            for s in range(n):
                coords = list(mesh.coords(p))
                coords[mesh.axis_names.index(axis)] = s
                q = mesh.flat(coords)
                assert torch.equal(out[p][s * cap:(s + 1) * cap],
                                   xs[q][me * cap:(me + 1) * cap])
    with pytest.raises(ValueError, match="buckets"):
        mesh.all_to_all([x[:5] for x in xs], "ici")


def test_create_attach_total_and_convert_against_jax():
    n = N + 5                             # uneven: the last rows are pad
    jmesh = jdsb.make_mesh(D)
    jst = jdsb.create_sharded_sb(jmesh, D, n, init_balance=7,
                                 log_capacity=LOG_CAP)
    mesh = dsb.make_mesh(D, device="cpu")
    pst = dsb.create_sharded_sb(mesh, D, n, init_balance=7,
                                log_capacity=LOG_CAP)
    assert_same(jax_state(jst), convert.sharded_sb_to_numpy(pst))
    assert pst[0].bal.shape[0] == dsb.m1_local(n, D) == 2 * 130 + 1
    assert dsb.total_balance_global(pst) == jdsb.total_balance_global(jst)
    # a wrapping global sum
    big = dsb.create_sharded_sb(mesh, D, n, init_balance=(1 << 31) - 1,
                                log_capacity=LOG_CAP)
    jbig = jdsb.create_sharded_sb(jmesh, D, n, init_balance=(1 << 31) - 1,
                                  log_capacity=LOG_CAP)
    assert dsb.total_balance_global(big) == jdsb.total_balance_global(jbig)
    jhot = jdsb.attach_hotset_sb(jmesh, jst, 9)
    phot = dsb.attach_hotset_sb(mesh, pst, 9)
    assert_same(jax_state(jhot), convert.sharded_sb_to_numpy(phot))
    back = convert.sharded_sb_from_numpy(jax_state(jhot), "cpu")
    assert_same(jax_state(jhot), convert.sharded_sb_to_numpy(back))
    assert back[0].hot_loc == 9 and isinstance(back[0].hot_loc, int)
    ptrs = {t.untyped_storage().data_ptr() for st in phot
            for t in (st.bal, st.hot_bal, st.hot_x, st.hot_s)}
    assert len(ptrs) == 4 * D             # mirrors are not views
    clamp = dsb.attach_hotset_sb(mesh, pst, 10 ** 6)
    assert clamp[0].hot_loc == 130


def test_runner_refusals():
    mesh = dsb.make_mesh(D, device="cpu")
    with pytest.raises(ValueError, match="mesh of 4"):
        dsb.create_sharded_sb(mesh, D + 1, N)
    with pytest.raises(ValueError, match="mesh of 4"):
        dsb.build_sharded_sb_runner(mesh, 2, N, w=W)
    run, init, _ = dsb.build_sharded_sb_runner(mesh, D, N, w=W,
                                               cohorts_per_block=CPB)
    carry = init(dsb.create_sharded_sb(mesh, D, N, log_capacity=LOG_CAP))
    with pytest.raises(ValueError, match="expected bits"):
        run.run_draws(carry, torch.zeros((CPB, W, 5), dtype=torch.int32),
                      torch.zeros((CPB, W), dtype=torch.int32))
    with pytest.raises(ValueError, match="states for"):
        init(carry[0][:2])
