"""The port's ServeEngine (dint_tpu_torch.serve.engine) against the JAX
package's `dint_tpu.serve.ServeEngine`, on the CPU, for all three engine
families (tatp_dense, smallbank_dense, store).

Both engines run under a VirtualClock on the same schedule; the port takes
JAX's per-block draws (``fold_in(PRNGKey(seed), block)``, and the drain's)
through its ``draws`` argument. The snapshots must be identical, key for
key: ledgers, histograms, the controller with its journal and service
samples, the plan record, the hot_frac loop and every counter but the
three that differ by design (the port is JAX's kernel route, JAX's engine
its XLA route: ``dispatch_xla``/``dispatch_pallas`` and
``hot_refresh_bytes``), and ``elapsed_s``. After ``close`` the tables are
bit-identical. The cases are tests/test_dintserve.py's: a bursty
straddle, an idle gap, saturation that sheds and recovers, re-entrant
runs, plan "auto"/dict/None and a hot_frac rebuild; and then the port's
own: full occupancy equals the closed loop, warmup leaves the live tables
as they were, and at one width the tables' storage stays put."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dint_tpu import serve as jserve
from dint_tpu.analysis import plan as jplan
from dint_tpu_torch import convert
from dint_tpu_torch import plan as pplan
from dint_tpu_torch import serve
from dint_tpu_torch.clients import workloads as wl
from dint_tpu_torch.engines import tatp_dense as td

import test_torch_smallbank_dense as tsb
import test_torch_tatp_dense as ttd
from test_torch_lock_engines import assert_same, np_tree
from test_torch_tatp_routes import _assert_same_db, _jax_arrays

BY_DESIGN = ("dispatch_xla", "dispatch_pallas", "hot_refresh_bytes")
N_SUB = 300
N_ACC = 400
W = 64
VW = 4
CPB = 2
STORE_KW = dict(use_scan=True, scan_frac=0.5, max_scan_len=6, scan_max=8,
                read_frac=0.5)


# ------------------------------------------------------------------ draws


def _store_block_draws(bkey, w, n_keys, kw):
    """JAX's store cohort draws of one block (store.py:388-407) as the
    port's six [cpb, w] arrays; the scan uniform is zeros when JAX draws
    none."""
    hot_n = max(1, min(int(n_keys * wl.SB_HOT_FRAC), n_keys))
    scan_frac = kw.get("scan_frac", 0.0) if kw.get("use_scan") else 0.0
    max_len = kw.get("max_scan_len", 8)
    cols = [[] for _ in range(6)]
    for k in jax.random.split(bkey, CPB):
        ks = jax.random.split(k, 6)
        row = [jax.random.uniform(ks[0], (w,)) if scan_frac > 0.0
               else jnp.zeros((w,), jnp.float32),
               jax.random.uniform(ks[1], (w,)),
               jax.random.uniform(ks[2], (w,)),
               jax.random.randint(ks[3], (w,), 1, hot_n + 1),
               jax.random.randint(ks[4], (w,), 1, n_keys + 1),
               jax.random.randint(ks[5], (w,), 1, max_len + 1)]
        for c, x in zip(cols, row):
            c.append(np.asarray(x))
    return (tuple(torch.from_numpy(np.stack(c)) for c in cols),)


def jax_draws(engine, seed, size, kw=None):
    """``draws`` for the port's engine: JAX ServeEngine's block i draws
    (fold_in(PRNGKey(seed), i)) and its drain's."""
    base = jax.random.PRNGKey(seed)

    def draws(block_idx, w):
        if block_idx is None:
            return (ttd._drain_payload(w),) if engine == "tatp_dense" else ()
        key = jax.random.fold_in(base, block_idx)
        if engine == "tatp_dense":
            return ttd._block_draws(key, CPB, w)
        if engine == "smallbank_dense":
            return tsb._block_draws(key, CPB, w)
        return _store_block_draws(key, w, size, kw or {})
    return draws


# ---------------------------------------------------------------- engines


def _pair(engine, size, seed=0, **kw):
    """The JAX engine and the port's on the same arguments and draws."""
    common = dict(cohorts_per_block=CPB, monitor=True, seed=seed, **kw)
    if engine != "smallbank_dense":
        common["val_words"] = VW
    j = jserve.ServeEngine(engine, size, clock=jserve.VirtualClock(),
                           **common)
    p = serve.ServeEngine(engine, size, clock=serve.VirtualClock(),
                          draws=jax_draws(engine, seed, size,
                                          kw.get("runner_kw")),
                          device="cpu", **common)
    return j, p


def _strip(snap):
    out = dict(snap)
    out.pop("elapsed_s")
    out["counters"] = {k: v for k, v in snap["counters"].items()
                       if k not in BY_DESIGN}
    return out


def _assert_same_snapshot(js, ps):
    assert js.keys() == ps.keys()
    assert js["counters"].keys() == ps["counters"].keys()
    assert _strip(js) == _strip(ps)
    steps = sum(ps["steps_by_width"].values())
    if steps:      # every serve step dispatched the kernel route
        assert ps["counters"]["dispatch_pallas"] >= steps
        assert ps["counters"]["dispatch_xla"] == 0


def _assert_same_tables(engine, jdb, pdb):
    if engine == "tatp_dense":
        _assert_same_db(_jax_arrays(jdb), pdb)
    elif engine == "smallbank_dense":
        tsb._assert_same(tsb._jax_arrays(jdb), pdb)
    else:
        assert_same(np_tree(jdb), convert.tree_to_numpy(pdb))


def _serve_both(engine, size, schedules, seed=0, close=True, **kw):
    j, p = _pair(engine, size, seed=seed, **kw)
    for s in schedules:
        jr, pr = j.run(s), p.run(s)
        _assert_same_snapshot(jr, pr)
    if close:
        j.close()
        p.close()
        _assert_same_snapshot(j.snapshot(), p.snapshot())
        _assert_same_tables(engine, j._db, p._db)
    return j, p, p.snapshot()


def _lane_ledger(rep):
    """The serve plane's ledger: every arrival admitted or shed, the shed
    tally mirrored on the device, padding the served lanes not admitted."""
    c = rep["counters"]
    assert rep["offered"] == rep["admitted"] + rep["shed"]
    assert c["serve_shed_lanes"] == rep["shed"]
    assert c["serve_occupancy_lanes"] == rep["admitted"]
    served = sum(int(w) * n for w, n in rep["steps_by_width"].items())
    assert c["serve_occupancy_lanes"] + c["serve_padded_lanes"] == served


def test_bursty_straddle_matches_jax_and_fills_every_cohort():
    """Bursts that straddle block boundaries (200, 100 and 84 arrivals into
    128-lane blocks) fill every cohort: 3 blocks, no padding."""
    sched = np.sort(np.concatenate([np.zeros(200), np.full(100, 2e-4),
                                    np.full(84, 4e-4)]))
    _, _, rep = _serve_both("tatp_dense", N_SUB, [sched],
                            cfg=serve.ControllerCfg(widths=(W,)))
    assert rep["blocks"] == 3
    assert rep["offered"] == rep["admitted"] == rep["attempted"] == 384
    assert rep["shed"] == 0 and rep["counters"]["serve_padded_lanes"] == 0
    _lane_ledger(rep)


def test_idle_gap_never_dispatches_empty():
    sched = np.sort(np.concatenate([np.zeros(CPB * W),
                                    np.full(CPB * W, 0.1)]))
    _, _, rep = _serve_both("tatp_dense", N_SUB, [sched],
                            cfg=serve.ControllerCfg(widths=(W,)))
    assert rep["blocks"] == 2
    assert rep["counters"]["serve_padded_lanes"] == 0
    assert rep["admitted"] == rep["attempted"] == 2 * CPB * W
    assert rep["elapsed_s"] >= 0.1


def test_saturation_sheds_then_recovers():
    """The knee width with shedding under overload, then back down: both
    directions in one trajectory, the journal decision for decision."""
    _, p, rep = _serve_both("smallbank_dense", N_ACC,
                            [serve.constant_schedule(800_000.0, 0.01)],
                            cfg=serve.ControllerCfg(widths=(16, W)))
    ctl = rep["controller"]
    switch_widths = [w for _, w in ctl["switches"]]
    assert W in switch_widths and switch_widths[-1] == 16
    assert rep["steps_by_width"][str(W)] > 0 and rep["steps_by_width"]["16"]
    assert ctl["width"] == 16 and not ctl["saturated"]
    assert rep["shed"] > 0 and rep["attempted"] == rep["admitted"]
    kinds = {e["kind"] for e in ctl["journal"]}
    assert {"width", "shed", "hot_frac"} <= kinds
    _lane_ledger(rep)


def test_reentrant_runs_continue_on_the_same_tables():
    scheds, start = [], 0.0
    for r, (rate, win) in enumerate([(50_000.0, 0.01), (900_000.0, 0.004),
                                     (8_000.0, 0.01)]):
        s = serve.poisson_schedule(rate, win, seed=r, start_s=start)
        scheds.append(s)
        start = s[-1] + 1e-3
    _, _, rep = _serve_both("smallbank_dense", N_ACC, scheds, seed=2,
                            cfg=serve.ControllerCfg(widths=(16, W)))
    assert rep["shed"] > 0
    _lane_ledger(rep)


@pytest.mark.parametrize("scan", [True, False])
def test_store_family_matches_jax(scan):
    kw = STORE_KW if scan else dict(use_scan=False)
    _, _, rep = _serve_both("store", N_ACC,
                            [serve.poisson_schedule(80_000.0, 0.02, seed=5)],
                            seed=3, cfg=serve.ControllerCfg(widths=(W,)),
                            runner_kw=kw)
    c = rep["counters"]
    assert rep["admitted"] > 0
    if scan:
        assert 0 < c["scan_requests"] < rep["admitted"]
        assert 0 < c["scan_rows"] <= 8 * c["scan_requests"]
    else:
        assert c["scan_requests"] == 0
        assert rep["committed"] == rep["admitted"]
    _lane_ledger(rep)


def test_plan_auto_dict_and_none():
    sched = serve.constant_schedule(30_000.0, 0.01)
    cfg = serve.ControllerCfg(widths=(16, W))
    # "auto": PLAN.json's smallbank_serve priors (a TPU's calibration):
    # the ServiceModel and the hot_frac prior
    _, p, rep = _serve_both("smallbank_dense", N_ACC, [sched], cfg=cfg)
    assert rep["plan"] is not None and rep["plan"]["overridden"] == []
    assert rep["plan"]["source"].endswith("PLAN.json")
    assert rep["plan"] == jplan.resolve_for("smallbank_serve")[1]
    assert rep["hot_frac"] == {"current": wl.SB_HOT_FRAC, "adaptive": True,
                               "rebuilds": 0}
    prior = pplan.load_plan()["workloads"]["smallbank_serve"]["serve"]
    assert (p.model.base_us, p.model.per_lane_ns) == (
        prior["model"]["base_us"], prior["model"]["per_lane_ns"])
    # a plan dict: the width menu, SLO and model flow from its priors
    doc = copy.deepcopy(pplan.load_plan())
    pri = doc["workloads"]["smallbank_serve"]["serve"]
    pri["widths"] = {"16": pri["widths"]["256"], str(W): pri["widths"]["256"]}
    pri["slo_us"] = 4321.0
    pri["model"] = {"base_us": 149.0, "per_lane_ns": 41.0}
    _, p, rep = _serve_both("smallbank_dense", N_ACC, [sched], plan=doc)
    assert p.cfg.widths == (16, W) and p.cfg.slo_us == 4321.0
    assert (p.model.base_us, p.model.per_lane_ns) == (149.0, 41.0)
    # None: no plan read, recorded as null; no hot_frac loop
    _, _, rep = _serve_both("smallbank_dense", N_ACC, [sched], cfg=cfg,
                            plan=None)
    assert rep["plan"] is None
    assert rep["hot_frac"] == {"current": None, "adaptive": False,
                               "rebuilds": 0}


def test_hot_frac_rebuild_at_width_switch_drain():
    """A pinned recommendation (0.25) applies at the first width choice
    only (the first attach is a switch from no width): one rebuild, and
    the hot route's mirrors are the ones its first init attached at 0.25,
    as JAX's are; the later switches keep them."""
    kw = dict(cfg=serve.ControllerCfg(widths=(16, W)), plan=None,
              runner_kw={"hot_frac": wl.SB_HOT_FRAC, "use_hotset": True},
              adapt_hot_frac=True)
    j, p = _pair("smallbank_dense", N_ACC, **kw)
    j.hot_frac_recommendation = lambda cur: 0.25
    p.hot_frac_recommendation = lambda cur: 0.25
    sched = serve.constant_schedule(800_000.0, 0.01)
    _assert_same_snapshot(j.run(sched), p.run(sched))
    j.close()
    p.close()
    rep = p.snapshot()
    _assert_same_snapshot(j.snapshot(), rep)
    _assert_same_tables("smallbank_dense", j._db, p._db)
    assert len(rep["controller"]["switches"]) >= 2
    assert rep["hot_frac"] == {"current": 0.25, "adaptive": True,
                               "rebuilds": 1}
    assert p.runner_kw["hot_frac"] == 0.25
    assert p._db.hot_n == j._db.hot_n == int(N_ACC * 0.25)


# ----------------------------------------------------- the port's own pins


def _port_engine(engine="tatp_dense", size=N_SUB, **kw):
    return serve.ServeEngine(engine, size, cfg=serve.ControllerCfg(
        widths=(W,)), cohorts_per_block=CPB, val_words=VW,
        clock=serve.VirtualClock(), monitor=True, seed=4, device="cpu", **kw)


def test_full_occupancy_serve_is_the_closed_loop():
    """occ == width on the engine's own draws (generators seeded
    block_seed(seed, i)) replays the closed-loop runner on the same draws:
    the same tables and stats."""
    blocks = 3
    eng = _port_engine()
    rep = eng.run(np.zeros(blocks * CPB * W))
    eng.close()
    rep = eng.snapshot()
    assert rep["blocks"] == blocks and rep["counters"]["serve_padded_lanes"] \
        == 0
    run, init, drain = td.build_pipelined_runner(
        N_SUB, w=W, val_words=VW, cohorts_per_block=CPB, device="cpu")
    carry = init(td.populate(np.random.default_rng(4), N_SUB, val_words=VW,
                             device="cpu"))
    total = np.zeros(td.N_STATS, np.int64)
    for i in range(blocks):
        gen = torch.Generator().manual_seed(serve.block_seed(4, i))
        carry, s = run(carry, gen)
        total += s.numpy().sum(axis=0)
    db, tail = drain(carry)
    total += tail.numpy().sum(axis=0)
    assert rep["attempted"] == int(total[td.STAT_ATTEMPTED]) == blocks \
        * CPB * W
    assert rep["committed"] == int(total[td.STAT_COMMITTED])
    a, b = convert.dense_db_to_numpy(eng._db), convert.dense_db_to_numpy(db)
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


@pytest.mark.parametrize("engine,size,kw", [
    ("tatp_dense", N_SUB, {"runner_kw": {"use_hotset": True}}),
    ("smallbank_dense", N_ACC, {"runner_kw": {"use_hotset": True}}),
    ("store", N_ACC, {"runner_kw": STORE_KW}),
])
def test_warmup_leaves_the_live_tables_untouched(engine, size, kw):
    eng = _port_engine(engine, size, **kw)
    before = convert.tree_to_numpy(eng._db)
    ptrs = {k: v.data_ptr() for k, v in vars(eng._db).items()
            if isinstance(v, torch.Tensor)}
    eng.warmup()
    after = convert.tree_to_numpy(eng._db)
    assert_same(before, after)
    assert ptrs == {k: v.data_ptr() for k, v in vars(eng._db).items()
                    if isinstance(v, torch.Tensor)}
    # no mirror of the warmup's init leaked into the live tables
    assert getattr(eng._db, "hot_n", 0) == 0
    rep = eng.run(serve.constant_schedule(50_000.0, 0.005))
    eng.close()
    _lane_ledger(rep)


def test_table_storage_stays_put_block_over_block():
    """At one width every block updates the carry's tables in place: the
    data pointers of every table and of the counters never move."""
    eng = _port_engine()
    seen = []
    orig = eng._dispatch

    def spy(occ, shed0):
        orig(occ, shed0)
        db = eng._carry[0]
        seen.append((db.val.data_ptr(), db.meta.data_ptr(),
                     db.arb.data_ptr(), db.log.entries.data_ptr(),
                     eng._carry[-1].buf.data_ptr()))
    eng._dispatch = spy
    eng.run(np.zeros(5 * CPB * W))
    eng.close()
    assert len(seen) == 5 and len(set(seen)) == 1


def test_snapshot_keys_and_cached_runner():
    j, p, _ = _serve_both("tatp_dense", N_SUB, [np.zeros(3)],
                          cfg=serve.ControllerCfg(widths=(W,)))
    js, ps = j.snapshot(), p.snapshot()
    assert ps.keys() == js.keys()
    for k in ("queue", "service", "controller", "hot_frac"):
        assert ps[k].keys() == js[k].keys(), k
    a = serve.cached_runner("tatp_dense", N_SUB, val_words=VW, w=W,
                            cohorts_per_block=CPB, monitor=True, serve=True,
                            device="cpu")
    assert a is p._runners[W]
    with pytest.raises(ValueError, match="serve family"):
        serve.cached_runner("dense_sharded_sb", N_SUB, device="cpu")
