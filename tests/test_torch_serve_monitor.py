"""The port's serve plane (``occupancy``/``shed``) and counter plane
(dint_tpu_torch/monitor/counters.py) against the JAX package, on the CPU.

The serve runners of both dense engines (``serve=True``, with
``monitor=True``) run next to JAX's on JAX's replayed draws, with cohorts
below full occupancy; tables, mirrors, stats and every counter must be
bit-identical. Three counters differ by design, because the JAX reference
takes its XLA route and the port is JAX's kernel (``use_pallas``) route:
the port bumps ``dispatch_pallas`` where JAX bumps ``dispatch_xla``, and
counts ``hot_refresh_bytes`` that JAX's XLA route leaves at 0. Those three
are asserted on their own. At full occupancy the serve runner must equal
the closed loop."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dint_tpu.engines import smallbank_dense as jsd
from dint_tpu.engines import tatp_dense as jtd
from dint_tpu.monitor import counters as jmon
from dint_tpu_torch import convert
from dint_tpu_torch.engines import smallbank_dense as sd
from dint_tpu_torch.engines import tatp_dense as td
from dint_tpu_torch.monitor import counters as mon

import test_torch_smallbank_dense as tsb
import test_torch_tatp_dense as ttd
from test_torch_tatp_routes import _assert_same_db, _jax_arrays

BY_DESIGN = ("dispatch_xla", "dispatch_pallas", "hot_refresh_bytes")
TATP = (2000, 64, 2)          # n_sub, w, cohorts_per_block
SB = tsb.EXACT[:3]            # n_accounts, w, cohorts_per_block (exact locks)
BLOCKS = 2


def _serve_plan(w, cpb):
    """Per block, occupancies below, at and near 0 of the width, and a
    shed tally: i32 [BLOCKS, cpb] each."""
    occ = np.array([[w - 7, w // 3], [0, w]], np.int32)[:BLOCKS, :cpb]
    shed = np.array([[3, 0], [1, 2]], np.int32)[:BLOCKS, :cpb]
    return occ, shed


def _assert_counters(jcnt, pcnt, steps, refresh_per_step):
    js, ps = jmon.snapshot(jcnt), mon.snapshot(pcnt)
    assert js.keys() == ps.keys()
    for k in js:
        if k not in BY_DESIGN:
            assert js[k] == ps[k], k
    assert (js["dispatch_xla"], js["dispatch_pallas"]) == (steps, 0)
    assert (ps["dispatch_xla"], ps["dispatch_pallas"]) == (0, steps)
    assert js["hot_refresh_bytes"] == 0
    assert ps["hot_refresh_bytes"] == steps * refresh_per_step
    return ps


def _reconciles(snap, stats, names):
    """Counters against the stats columns they mirror."""
    total = np.concatenate(stats).astype(np.int64).sum(axis=0)
    return all(snap[name] == int(total[col]) for name, col in names)


# -------------------------------------------------------------------- TATP

TATP_STATS = (("txn_attempted", td.STAT_ATTEMPTED),
              ("txn_committed", td.STAT_COMMITTED),
              ("ab_lock", td.STAT_AB_LOCK), ("ab_missing", td.STAT_AB_MISSING),
              ("ab_validate", td.STAT_AB_VALIDATE),
              ("magic_bad", td.STAT_MAGIC_BAD))


@pytest.mark.parametrize("route", ["default", "hotset", "fused+hotset"])
def test_tatp_serve_and_counters_match_jax(route):
    n_sub, w, cpb = TATP
    use_hotset, use_fused = td.ROUTES[route]
    jdb = jtd.populate(np.random.default_rng(0), n_sub, val_words=ttd.VW,
                       log_capacity=ttd.LOG_CAP)
    pdb = convert.dense_db_from_numpy(_jax_arrays(jdb), "cpu")
    jrun, jinit, jdrain = jtd.build_pipelined_runner(
        n_sub, w=w, val_words=ttd.VW, cohorts_per_block=cpb,
        use_pallas=False, use_hotset=use_hotset, use_fused=use_fused,
        monitor=True, serve=True)
    prun, pinit, pdrain = td.build_pipelined_runner(
        n_sub, w=w, val_words=ttd.VW, cohorts_per_block=cpb,
        use_hotset=use_hotset, use_fused=use_fused, monitor=True,
        serve=True, device="cpu")
    occ, shed = _serve_plan(w, cpb)
    jc, pc = jinit(jdb), pinit(pdb)
    stats = []
    for i in range(BLOCKS):
        bkey = jax.random.fold_in(jax.random.PRNGKey(5), i)
        jc, js = jrun(jc, bkey, jnp.asarray(occ[i]), jnp.asarray(shed[i]))
        pc, ps = prun.run_draws(pc, *ttd._block_draws(bkey, cpb, w),
                                torch.from_numpy(occ[i]),
                                torch.from_numpy(shed[i]))
        assert np.array_equal(np.asarray(js), ps.numpy()), i
        assert np.array_equal(ps[:, td.STAT_ATTEMPTED].numpy(),
                              [0, 0] if i == 0 else occ[i - 1])
        stats.append(ps.numpy())
    jdb, jtail, jcnt = jdrain(jc)
    pdb, ptail, pcnt = pdrain(pc, payload=ttd._drain_payload(w))
    assert np.array_equal(np.asarray(jtail), ptail.numpy())
    stats.append(ptail.numpy())
    _assert_same_db(_jax_arrays(jdb), pdb)

    steps = BLOCKS * cpb + 2
    hn = pdb.hot_n
    refresh = 0
    if use_hotset:
        refresh = hn * ttd.VW * 4 + (0 if use_fused else hn * 4)
    snap = _assert_counters(jcnt, pcnt, steps, refresh)
    assert _reconciles(snap, stats, TATP_STATS)
    assert snap["txn_attempted"] == int(occ.sum())
    assert snap["serve_occupancy_lanes"] == int(occ.sum())
    assert snap["serve_padded_lanes"] == BLOCKS * cpb * w - int(occ.sum())
    assert snap["serve_shed_lanes"] == int(shed.sum())
    assert snap["steps"] == steps
    assert snap["fused_dispatch"] == (steps if use_fused else 0)
    assert snap["lock_requests"] == (snap["lock_granted"]
                                     + snap["lock_rejected"])
    assert snap["lock_rejected"] == (snap["lock_reject_held"]
                                     + snap["lock_reject_arb"])


# --------------------------------------------------------------- SmallBank

SB_STATS = (("txn_attempted", sd.STAT_ATTEMPTED),
            ("txn_committed", sd.STAT_COMMITTED),
            ("ab_lock", sd.STAT_AB_LOCK), ("ab_logic", sd.STAT_AB_LOGIC),
            ("magic_bad", sd.STAT_MAGIC_BAD))


@pytest.mark.parametrize("route", ["default", "hotset", "fused+hotset"])
def test_smallbank_serve_and_counters_match_jax(route):
    n, w, cpb = SB
    use_hotset, use_fused = sd.ROUTES[route]
    jdb = jsd.create(n, log_capacity=tsb.LOG_CAP)
    pdb = convert.dense_bank_from_numpy(tsb._jax_arrays(jdb), "cpu")
    jrun, jinit, jdrain = jsd.build_pipelined_runner(
        n, w=w, cohorts_per_block=cpb, use_pallas=False,
        use_hotset=use_hotset, use_fused=use_fused, monitor=True,
        serve=True)
    prun, pinit, pdrain = sd.build_pipelined_runner(
        n, w=w, cohorts_per_block=cpb, use_hotset=use_hotset,
        use_fused=use_fused, monitor=True, serve=True, device="cpu")
    occ, shed = _serve_plan(w, cpb)
    jc, pc = jinit(jdb), pinit(pdb)
    stats = []
    for i in range(BLOCKS):
        bkey = tsb._block_key(i)
        jc, js = jrun(jc, bkey, jnp.asarray(occ[i]), jnp.asarray(shed[i]))
        pc, ps = prun.run_draws(pc, *tsb._block_draws(bkey, cpb, w),
                                torch.from_numpy(occ[i]),
                                torch.from_numpy(shed[i]))
        assert np.array_equal(np.asarray(js), ps.numpy()), i
        stats.append(ps.numpy())
    jdb, jtail, jcnt = jdrain(jc)
    pdb, ptail, pcnt = pdrain(pc)
    assert np.array_equal(np.asarray(jtail), ptail.numpy())
    stats.append(ptail.numpy())
    tsb._assert_same(tsb._jax_arrays(jdb), pdb)

    steps = BLOCKS * cpb + 1
    # exact lock regime: the hot route partitions the balance read and
    # both stamp reads (3 gathers); the fused route partitions none
    n_g = (0 if use_fused else 3) if use_hotset else 0
    snap = _assert_counters(jcnt, pcnt, steps, n_g * 2 * pdb.hot_n * 4)
    assert _reconciles(snap, stats, SB_STATS)
    assert snap["txn_attempted"] == int(occ.sum())
    assert snap["serve_padded_lanes"] == BLOCKS * cpb * w - int(occ.sum())
    assert snap["serve_shed_lanes"] == int(shed.sum())
    assert snap["lock_rejected"] == (snap["lock_reject_held"]
                                     + snap["lock_reject_arb"])


# ------------------------------------------- full occupancy == closed loop


def _full(cpb, w):
    return (torch.full((cpb,), w, dtype=torch.int32),
            torch.zeros(cpb, dtype=torch.int32))


@pytest.mark.parametrize("route", ["default", "fused+hotset"])
def test_serve_at_full_occupancy_is_the_closed_loop(route):
    """occ == w leaves every output of both engines as the closed loop
    gives it; the counters differ only in the serve plane's."""
    use_hotset, use_fused = td.ROUTES[route]
    n_sub, w, cpb = TATP
    db0 = td.populate(np.random.default_rng(3), n_sub, val_words=ttd.VW,
                      log_capacity=ttd.LOG_CAP, device="cpu")
    ends = []
    for serve in (False, True):
        run, init, drain = td.build_pipelined_runner(
            n_sub, w=w, val_words=ttd.VW, cohorts_per_block=cpb,
            use_hotset=use_hotset, use_fused=use_fused, monitor=True,
            serve=serve, device="cpu")
        carry = init(convert.dense_db_from_numpy(
            convert.dense_db_to_numpy(db0), "cpu"))
        gen = torch.Generator().manual_seed(9)
        stats = []
        for _ in range(BLOCKS):
            carry, s = run(carry, gen, *(_full(cpb, w) if serve else ()))
            stats.append(s)
        db, tail, cnt = drain(carry)
        ends.append((convert.dense_db_to_numpy(db),
                     torch.cat(stats + [tail]).numpy(), mon.snapshot(cnt)))
    (a_db, a_st, a_c), (b_db, b_st, b_c) = ends
    assert np.array_equal(a_st, b_st)
    assert a_db.keys() == b_db.keys()
    for k in a_db:
        assert np.array_equal(np.asarray(a_db[k]), np.asarray(b_db[k])), k
    serve_ctrs = ("serve_occupancy_lanes", "serve_padded_lanes",
                  "serve_shed_lanes")
    assert {k: v for k, v in a_c.items() if k not in serve_ctrs} == \
        {k: v for k, v in b_c.items() if k not in serve_ctrs}
    assert b_c["serve_occupancy_lanes"] == BLOCKS * cpb * w
    assert b_c["serve_padded_lanes"] == 0 and a_c["serve_padded_lanes"] == 0

    n, w, cpb = SB
    ends = []
    for serve in (False, True):
        run, init, drain = sd.build_pipelined_runner(
            n, w=w, cohorts_per_block=cpb, use_hotset=use_hotset,
            use_fused=use_fused, monitor=True, serve=serve, device="cpu")
        carry = init(sd.create(n, log_capacity=tsb.LOG_CAP, device="cpu"))
        gen = torch.Generator().manual_seed(9)
        stats = []
        for _ in range(BLOCKS):
            carry, s = run(carry, gen, *(_full(cpb, w) if serve else ()))
            stats.append(s)
        db, tail, cnt = drain(carry)
        ends.append((convert.dense_bank_to_numpy(db),
                     torch.cat(stats + [tail]).numpy(), mon.snapshot(cnt)))
    (a_db, a_st, a_c), (b_db, b_st, b_c) = ends
    assert np.array_equal(a_st, b_st)
    for k in a_db:
        assert np.array_equal(np.asarray(a_db[k]), np.asarray(b_db[k])), k
    assert {k: v for k, v in a_c.items() if k not in serve_ctrs} == \
        {k: v for k, v in b_c.items() if k not in serve_ctrs}


def test_serve_runner_keeps_no_view_of_the_callers_occupancy():
    """A caller that refills one occupancy buffer in place between blocks
    gets the stats of the occupancies it passed: the cohorts still in
    flight keep their own copy."""
    n_sub, w, cpb = TATP
    occ, shed = _serve_plan(w, cpb)
    out = []
    for reuse in (False, True):
        run, init, drain = td.build_pipelined_runner(
            n_sub, w=w, val_words=ttd.VW, cohorts_per_block=cpb, serve=True,
            device="cpu")
        carry = init(td.populate(np.random.default_rng(0), n_sub,
                                 val_words=ttd.VW, log_capacity=ttd.LOG_CAP,
                                 device="cpu"))
        gen = torch.Generator().manual_seed(1)
        buf = torch.zeros(cpb, dtype=torch.int32)
        stats = []
        for i in range(BLOCKS):
            o = buf if reuse else torch.empty(cpb, dtype=torch.int32)
            o.copy_(torch.from_numpy(occ[i]))
            carry, s = run(carry, gen, o, torch.from_numpy(shed[i]))
            stats.append(s)
        buf.fill_(-1)
        stats.append(drain(carry)[1])
        out.append(torch.cat(stats))
    assert torch.equal(out[0], out[1])
    assert int(out[1][:, td.STAT_ATTEMPTED].sum()) == int(occ.sum())


def test_runner_signatures_follow_serve():
    run, init, _ = td.build_pipelined_runner(20, w=8, val_words=ttd.VW,
                                             cohorts_per_block=2,
                                             device="cpu")
    carry = init(td.populate(np.random.default_rng(0), 20, val_words=ttd.VW,
                             log_capacity=ttd.LOG_CAP, device="cpu"))
    assert len(carry) == 3                   # no counters without monitor
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="serve"):
        run(carry, gen, *_full(2, 8))
    srun, sinit, _ = sd.build_pipelined_runner(20, w=8, cohorts_per_block=2,
                                               serve=True, device="cpu")
    with pytest.raises(ValueError, match="serve"):
        srun(sinit(sd.create(20, log_capacity=8, device="cpu")), gen)


# ---------------------------------------------------------------- counters


def test_registry_matches_jax():
    assert mon.ALL_NAMES == jmon.ALL_NAMES
    assert mon.COUNTER_KINDS == jmon.COUNTER_KINDS
    assert mon.COUNTER_INDEX == jmon.COUNTER_INDEX
    assert mon.PARITY_NAMES == jmon.PARITY_NAMES
    assert (mon.FLOW_NAMES, mon.GAUGE_NAMES) == (jmon.FLOW_NAMES,
                                                 jmon.GAUGE_NAMES)
    ctrs = {k: v for k, v in vars(jmon).items() if k.startswith("CTR_")}
    assert ctrs == {k: v for k, v in vars(mon).items()
                    if k.startswith("CTR_")}


def test_bump_gauge_snapshot_delta_match_jax_across_a_wrap():
    """The same updates through both planes, from a buffer a few counts
    short of 2^32: sums wrap mod 2^32, the gauge takes the unsigned max,
    snapshots agree (flat and stacked), and a window delta across the wrap
    is exact."""
    r = np.random.default_rng(0)
    start = r.integers(0, 1 << 32, mon.N_COUNTERS,
                       dtype=np.uint64).astype(np.uint32)
    start[mon.CTR_STEPS] = 0xFFFFFFFE
    start[mon.CTR_RING_HWM] = 5
    jc = jmon.Counters(buf=jnp.asarray(start))
    pc = convert.counters_from_numpy(start, "cpu")
    prev_j, prev_p = jmon.snapshot(jc), mon.snapshot(pc)
    assert prev_j == prev_p
    for upd in ({mon.CTR_STEPS: 1, mon.CTR_TXN_ATTEMPTED: 7},
                {mon.CTR_STEPS: 3, mon.CTR_LOG_APPENDS: 0xFFFFFFFF,
                 mon.CTR_AB_LOCK: 2}):
        jc = jmon.bump(jc, {k: jnp.asarray(v, jnp.uint32)
                            for k, v in upd.items()})
        mon.bump(pc, {k: torch.tensor(v, dtype=torch.int64)
                      for k, v in upd.items()})
    for hwm in (0x90000000, 3):          # above 2^31: an unsigned max
        jc = jmon.gauge_max(jc, {mon.CTR_RING_HWM: jnp.asarray(hwm,
                                                               jnp.uint32)})
        mon.gauge_max(pc, {mon.CTR_RING_HWM: hwm})
    assert np.array_equal(np.asarray(jc.buf), convert.counters_to_numpy(pc))
    cur_j, cur_p = jmon.snapshot(jc), mon.snapshot(pc)
    assert cur_j == cur_p
    assert cur_p["steps"] == 2 and cur_p["ring_hwm"] == 0x90000000
    assert jmon.delta(cur_j, prev_j) == mon.delta(cur_p, prev_p)
    assert mon.delta(cur_p, prev_p)["steps"] == 4
    assert mon.delta(cur_p, None) == jmon.delta(cur_j, None)
    stacked = np.stack([np.asarray(jc.buf), start])
    assert jmon.snapshot(stacked) == mon.snapshot(torch.from_numpy(
        stacked.view(np.int32)))
    assert mon.zeros_dict() == jmon.zeros_dict()
