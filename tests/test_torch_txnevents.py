"""The port's dinttrace event plane (dint_tpu_torch.monitor.txnevents and
the traced dense runners) against `dint_tpu.monitor.txnevents` and the
JAX runners with ``trace=True`` on the CPU.

The sampling mask, the txn ids and `emit` run the same numpy-seeded ids
(past 2^31 included) through both packages. The traced TATP and SmallBank
runners start from the same tables and replay JAX's draws: each block's
decoded ring, its head and the ring's first ``cap * WORDS`` words (the
port's spill tail past them is scratch) are bit-identical to JAX's, on two
routes of each engine (the routes change where the bytes are served from,
never an event). Then the port's own runs are held to the contract of
tests/test_dinttrace.py: at rate 1.0 the events reconcile with the
counters and the stats, the rate-0.25 events are a subset of the rate-1.0
ones, tracing off changes no output, and a small ring keeps its first
events and counts the rest in ``trace_dropped``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dint_tpu.engines import smallbank_dense as jsd
from dint_tpu.engines import smallbank_pipeline as jsp
from dint_tpu.engines import tatp_dense as jtd
from dint_tpu.monitor import counters as jctr
from dint_tpu.monitor import txnevents as jtxe
from dint_tpu_torch import convert
from dint_tpu_torch.engines import smallbank_dense as sd
from dint_tpu_torch.engines import tatp_dense as td
from dint_tpu_torch.engines.types import ROUTES
from dint_tpu_torch.monitor import counters as ctr
from dint_tpu_torch.monitor import txnevents as txe
from dint_tpu_torch.ops import u32

N_SUB = 300
N_ACC = 400
W = 64
VW = 4
CPB = 2
BLOCKS = 2
ROUTES_CHECKED = ("default", "fused+hotset")


def _ids(rng, n):
    """u32 txn ids with the top bit set on about half of them, and the
    edges."""
    ids = rng.integers(0, 2 ** 32, size=n, dtype=np.uint64)
    ids[:4] = [0, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1]
    return ids.astype(np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("rate", [0.0, 0.25, 0.7, 1.0])
def test_sample_mask_matches_jax(rate):
    ids = _ids(np.random.default_rng(1), 4096)
    thresh = jtxe.TraceCfg(rate=rate, cap=1).thresh
    assert txe.TraceCfg(rate=rate, cap=1).thresh == thresh
    ref = np.asarray(jtxe.sample_mask(jnp.asarray(ids), thresh))
    assert np.array_equal(txe.sample_mask(_t(ids), thresh).numpy(), ref)


@pytest.mark.parametrize("step,w", [(5, 64), (2 ** 26 + 3, 8192),
                                    (2 ** 32 - 1, 256)])
def test_txn_ids_wrap_like_jax(step, w):
    lane = np.arange(w, dtype=np.uint32)
    tu = jnp.asarray(np.uint32(step & 0xFFFFFFFF))
    ref = np.asarray(tu * jnp.uint32(w) + jnp.asarray(lane))
    got = txe.txn_ids(step, w, torch.arange(w, dtype=torch.int32)).numpy()
    assert np.array_equal(got, ref.astype(np.int64))


@pytest.mark.parametrize("cap", [64, 300, 5000])
def test_emit_matches_jax(cap):
    """Three steps of two groups into one ring: decoded events, head, the
    ring's words and trace_dropped equal JAX's, including overflow."""
    rng = np.random.default_rng(cap)
    jring, jc = jtxe.create_ring(cap), jctr.create()
    ring, c = txe.create_ring(cap, "cpu", spill=700), ctr.create("cpu")
    jcfg = jtxe.TraceCfg(rate=0.6, cap=cap)
    cfg = txe.TraceCfg(rate=0.6, cap=cap)
    for step in range(3):
        m1, m2 = rng.random(400) < 0.7, rng.random(300) < 0.5
        t1, t2 = _ids(rng, 400), _ids(rng, 300)
        aux = rng.integers(0, 4, size=400).astype(np.int32)
        lock, val = "dint.tatp_dense.lock", "dint.tatp_dense.meta_gather"
        jgroups = (
            jtxe.ev(jnp.asarray(m1), jnp.asarray(t1), jtxe.EV_LOCK, lock,
                    aux=jnp.asarray(aux), step=jnp.uint32(step + 2)),
            jtxe.ev(jnp.asarray(m2), jnp.asarray(t2), jtxe.EV_OUTCOME, val,
                    aux=jtxe.CAUSE_MISSING, step=jnp.uint32(step + 2)))
        groups = (
            txe.ev(torch.from_numpy(m1), _t(t1), txe.EV_LOCK, lock,
                   aux=torch.from_numpy(aux), step=step + 2),
            txe.ev(torch.from_numpy(m2), _t(t2), txe.EV_OUTCOME, val,
                   aux=txe.CAUSE_MISSING, step=step + 2))
        jring, jc = jtxe.emit(jring, jcfg, jgroups, jc)
        txe.emit(ring, cfg, groups, c)
        assert np.array_equal(txe.decode(ring.buf, ring.head, cap),
                              jtxe.decode(jring.buf, jring.head, cap))
        assert int(u32.to_u64(ring.head)) == int(jring.head)
        assert np.array_equal(u32.to_numpy(ring.buf[:cap * txe.WORDS]),
                              np.asarray(jring.buf))
        assert ctr.snapshot(c)["trace_dropped"] == \
            jctr.snapshot(jc)["trace_dropped"]
    assert (int(jring.head) > cap) == (cap < 5000)   # overflow exercised


def test_emit_refuses_a_short_spill_tail():
    ring = txe.create_ring(8, "cpu", spill=4)
    g = txe.ev(torch.ones(5, dtype=torch.bool), 7, txe.EV_LOCK,
               "dint.tatp_dense.lock")
    with pytest.raises(ValueError, match="spill tail"):
        txe.emit(ring, txe.TraceCfg(rate=1.0, cap=8), (g,))


# ----------------------------------------------- runners against JAX's


def _tatp_block_draws(key):
    bits, pay = [], []
    for k in jax.random.split(key, CPB):
        kg, kv3 = jax.random.split(k)
        bits.append(np.asarray(jax.random.bits(kg, (W, 4), jnp.uint32)))
        pay.append(np.asarray(jax.random.randint(kv3, (W, 2), 0, 1 << 16,
                                                  dtype=jnp.int32)))
    return u32.from_numpy(np.stack(bits), "cpu"), torch.from_numpy(
        np.stack(pay))


def _sb_block_draws(key):
    bits, amt = [], []
    for k in jax.random.split(key, CPB):
        kgen, kamt = jax.random.split(k)
        bits.append(np.asarray(jax.random.bits(kgen, (W, 5), jnp.uint32)))
        amt.append(np.asarray(jax.random.randint(
            kamt, (W,), -jsp.TS_AMT_MAX, jsp.TS_AMT_MAX + 1,
            dtype=jnp.int32)))
    return u32.from_numpy(np.stack(bits), "cpu"), torch.from_numpy(
        np.stack(amt))


def _same_ring(jring, ring, cap, what):
    assert np.array_equal(txe.decode(ring.buf, ring.head, cap),
                          jtxe.decode(jring.buf, jring.head, cap)), what
    assert int(u32.to_u64(ring.head)) == int(jring.head), what
    assert np.array_equal(u32.to_numpy(ring.buf[:cap * txe.WORDS]),
                          np.asarray(jring.buf)), what


def _same_counters(jc, c, what):
    a, b = jctr.snapshot(jc), ctr.snapshot(c)
    for name in ctr.PARITY_NAMES + ("trace_dropped",):
        assert a[name] == b[name], (what, name)


@pytest.mark.parametrize("route", ROUTES_CHECKED)
def test_tatp_dense_rings_match_jax(route):
    jdb = jtd.populate(np.random.default_rng(4), N_SUB, val_words=VW,
                       log_capacity=64)
    pdb = convert.dense_db_from_numpy({
        "val": np.asarray(jdb.val), "meta": np.asarray(jdb.meta),
        "arb": np.asarray(jdb.arb), "step": np.asarray(jdb.step),
        "log.entries": np.asarray(jdb.log.entries),
        "log.head": np.asarray(jdb.log.head), "val_words": VW,
        "lanes": jdb.log.lanes, "replicas": jdb.log.replicas}, "cpu")
    jrun, jinit, jdrain = jtd.build_pipelined_runner(
        N_SUB, w=W, val_words=VW, cohorts_per_block=CPB, use_pallas=False,
        use_fused=False, monitor=True, trace=True, trace_rate=1.0)
    hot, fused = ROUTES[route]
    run, init, drain = td.build_pipelined_runner(
        N_SUB, w=W, val_words=VW, cohorts_per_block=CPB, use_hotset=hot,
        use_fused=fused, monitor=True, trace=True, trace_rate=1.0,
        device="cpu")
    cap = init.trace_cfg.cap
    assert cap == jinit.trace_cfg.cap == W * (td.K + 6) * CPB
    jc, pc = jinit(jdb), init(pdb)
    for i in range(BLOCKS):
        key = jax.random.fold_in(jax.random.PRNGKey(4), i)
        jc, _ = jrun(jc, key)
        pc, _ = run.run_draws(pc, *_tatp_block_draws(key))
        _same_ring(jc[-2], pc[3], cap, (route, i))
    jout = jdrain(jc)
    _, pay = _tatp_block_draws(jax.random.PRNGKey(0))
    pout = drain(pc, payload=torch.stack([pay[0], pay[0]]))
    _same_ring(jout[2], pout[2], cap, (route, "drain"))
    _same_counters(jout[3], pout[3], route)


@pytest.mark.parametrize("route", ROUTES_CHECKED)
def test_smallbank_dense_rings_match_jax(route):
    jdb = jsd.create(N_ACC, log_capacity=64)
    pdb = sd.create(N_ACC, log_capacity=64, device="cpu")
    jrun, jinit, jdrain = jsd.build_pipelined_runner(
        N_ACC, w=W, cohorts_per_block=CPB, use_pallas=False,
        use_hotset=False, use_fused=False, monitor=True, trace=True,
        trace_rate=1.0)
    hot, fused = ROUTES[route]
    run, init, drain = sd.build_pipelined_runner(
        N_ACC, w=W, cohorts_per_block=CPB, use_hotset=hot, use_fused=fused,
        monitor=True, trace=True, trace_rate=1.0, device="cpu")
    cap = init.trace_cfg.cap
    assert cap == jinit.trace_cfg.cap
    jc, pc = jinit(jdb), init(pdb)
    for i in range(BLOCKS):
        key = jax.random.fold_in(jax.random.PRNGKey(6), i)
        jc, _ = jrun(jc, key)
        pc, _ = run.run_draws(pc, *_sb_block_draws(key))
        _same_ring(jc[-2], pc[2], cap, (route, i))
    jout, pout = jdrain(jc), drain(pc)
    _same_ring(jout[2], pout[2], cap, (route, "drain"))
    _same_counters(jout[3], pout[3], route)


# ---------------------------------------- the contract on the port alone


def _drive(runner, state, n_stats, ring_ix, *, trace=True, blocks=3,
           seed=0):
    """``blocks`` blocks and the drain, the ring observed after each.
    Returns (state, stats total, counter snapshot, TxnMonitor)."""
    run, init, drain = runner
    carry = init(state)
    tmon = txe.TxnMonitor(init.trace_cfg) if trace else None
    tot = np.zeros(n_stats, np.int64)
    for i in range(blocks):
        carry, s = run(carry, torch.Generator().manual_seed(seed * 100 + i))
        tot += s.numpy().astype(np.int64).sum(axis=0)
        if tmon is not None:
            tmon.observe(carry[ring_ix])
    out = drain(carry)
    tot += out[1].numpy().astype(np.int64).sum(axis=0)
    if tmon is not None:
        tmon.observe(out[2])
        tmon.close()
    return out[0], tot, ctr.snapshot(out[-1]), tmon


@functools.lru_cache(maxsize=None)
def _sb_runner(trace=True, rate=1.0, cap=None):
    return sd.build_pipelined_runner(
        N_ACC, w=W, cohorts_per_block=CPB, monitor=True, trace=trace,
        trace_rate=rate, trace_cap=cap, device="cpu")


@functools.lru_cache(maxsize=None)
def _sb_full_drive():
    return _drive(_sb_runner(), sd.create(N_ACC, device="cpu"), sd.N_STATS,
                  2, seed=1)


def _kind_counts(tmon):
    kinds, outcomes = {}, {}
    for win in tmon.windows:
        for rec in win:
            for _w0, w1, _w2, _w3 in rec["events"]:
                kind, _wave, _shard, aux = txe.unpack_w1(w1)
                name = txe.KIND_NAMES[kind]
                kinds[name] = kinds.get(name, 0) + 1
                if kind == txe.EV_OUTCOME:
                    cause = txe.CAUSE_NAMES[aux]
                    outcomes[cause] = outcomes.get(cause, 0) + 1
    return kinds, outcomes


def _event_set(tmon):
    return {tuple(e) for win in tmon.windows for rec in win
            for e in rec["events"]}


@pytest.mark.parametrize("route", ("default", "fused"))
def test_tatp_dense_full_rate_reconciles(route):
    hot, fused = ROUTES[route]
    db = td.populate(np.random.default_rng(0), N_SUB, val_words=VW,
                     device="cpu")
    runner = td.build_pipelined_runner(
        N_SUB, w=W, val_words=VW, cohorts_per_block=CPB, use_hotset=hot,
        use_fused=fused, monitor=True, trace=True, device="cpu")
    _, tot, snap, tmon = _drive(runner, db, td.N_STATS, 3)
    kinds, outcomes = _kind_counts(tmon)
    assert kinds["lock"] == snap["lock_requests"] > 0
    assert kinds["validate"] == snap["validate_lanes"] > 0
    assert kinds["install"] == snap["install_writes"] > 0
    assert kinds["outcome"] == snap["txn_attempted"] \
        == tot[td.STAT_ATTEMPTED]
    assert outcomes.get("commit", 0) == snap["txn_committed"]
    assert outcomes.get("ab_lock", 0) == snap["ab_lock"]
    assert outcomes.get("ab_missing", 0) == snap["ab_missing"]
    assert outcomes.get("ab_validate", 0) == snap["ab_validate"]
    assert snap["trace_dropped"] == tmon.summary()["dropped"] == 0


def test_sb_dense_full_rate_reconciles():
    _, tot, snap, tmon = _sb_full_drive()
    kinds, outcomes = _kind_counts(tmon)
    assert kinds["lock"] == snap["lock_requests"] > 0
    assert kinds["install"] == snap["install_writes"] > 0
    assert kinds["outcome"] == snap["txn_attempted"] \
        == tot[sd.STAT_ATTEMPTED]
    assert outcomes.get("commit", 0) == snap["txn_committed"]
    assert outcomes.get("ab_lock", 0) == snap["ab_lock"]
    assert outcomes.get("ab_logic", 0) == snap["ab_logic"]
    assert snap["trace_dropped"] == tmon.summary()["dropped"] == 0


def test_quarter_rate_events_are_subset_of_full_rate():
    _, tot_full, _, tm_full = _sb_full_drive()
    _, tot_q, _, tm_q = _drive(_sb_runner(rate=0.25),
                               sd.create(N_ACC, device="cpu"), sd.N_STATS, 2,
                               seed=1)
    assert tot_full.tolist() == tot_q.tolist()   # sampling never steers
    full, quarter = _event_set(tm_full), _event_set(tm_q)
    assert 0 < len(quarter) < len(full)
    assert quarter <= full
    # the mask is a pure function of the txn id: a txn is in or out whole
    sampled = {e[0] for e in quarter}
    assert {e for e in full if e[0] in sampled} == quarter


def test_trace_off_is_bit_identical():
    db_off, tot_off, snap_off, _ = _drive(
        _sb_runner(trace=False), sd.create(N_ACC, device="cpu"), sd.N_STATS,
        2, trace=False, seed=1)
    db_on, tot_on, snap_on, _ = _sb_full_drive()
    assert tot_off.tolist() == tot_on.tolist()
    assert snap_off == snap_on
    off, on = (convert.dense_bank_to_numpy(d) for d in (db_off, db_on))
    assert off.keys() == on.keys()
    for k in off:
        assert np.array_equal(np.asarray(off[k]), np.asarray(on[k])), k


def test_ring_overflow_keeps_first_and_counts_losses():
    _, _, snap, tmon = _drive(_sb_runner(cap=16),
                              sd.create(N_ACC, device="cpu"), sd.N_STATS, 2,
                              seed=1)
    s = tmon.summary()
    assert s["dropped"] > 0 and s["dropped_windows"]
    assert snap["trace_dropped"] == s["dropped"]
    _, _, _, full = _sb_full_drive()
    for win, fwin in zip(tmon.windows, full.windows):
        for rec, frec in zip(win, fwin):
            assert len(rec["events"]) == min(rec["head"], 16)
            assert rec["dropped"] == max(0, rec["head"] - 16)
            assert rec["events"] == frec["events"][:16]    # keep-first


def test_deferred_drain_equals_the_synchronous_one():
    run, init, drain = _sb_runner()
    sync, deferred = (txe.TxnMonitor(init.trace_cfg) for _ in range(2))
    carry = init(sd.create(N_ACC, device="cpu"))
    for i in range(3):
        carry, _ = run(carry, torch.Generator().manual_seed(i))
        sync.observe(carry[2])
        deferred.observe(carry[2], defer=True)
    deferred.flush()
    assert sync.windows == deferred.windows and len(sync.windows) == 3
    assert sync.summary() == deferred.summary()
