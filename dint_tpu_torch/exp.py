"""The experiment sweep of the port (the port of exp.py): each point writes
a JSON metric block to ``<out>/<name>.json`` and the run ends with
``<out>/summary.json``.

    python -m dint_tpu_torch.exp                  # needs one CUDA card
    python -m dint_tpu_torch.exp --quick          # small sizes, 1 s windows
    python -m dint_tpu_torch.exp --only tatp --out DIR --window 5
    python -m dint_tpu_torch.exp --only smallbank_skew --hot-prob 0.9

The legs, in exp.py's order, with its names, sizes and artifact keys:

* ``tatp_*``: `sweep_pipeline` over the dense TATP engine at 7,000,000
  subscribers (``DINT_EXP_SUBSCRIBERS``), VW = 10, 4 cohorts a block: the
  closed-loop width ladder ``tatp_closed_w{8192,256,1024,2048,32768}``,
  open-loop points ``tatp_open_{25,50,75,90,110}pct`` at those fractions
  of the ladder's peak (queueing delay and service time split), then
  ``tatp_latency_w{256,1024,8192}`` (one cohort a call, timed per step);
* ``smallbank_*``: the same over dense SmallBank at 24,000,000 accounts
  (``DINT_EXP_SB_ACCOUNTS``), ``--hot-frac``/``--hot-prob`` setting the
  skew; ``--only smallbank_skew`` is a preset: one width, hot_frac 0.01,
  0.04, 0.16 and 0.5 (``smallbank_skew_h{01,04,16,50}_closed_w8192``);
* ``multihost_sb_{hier,flat}_closed_w8192``: `sweep_multihost_sb`,
  SmallBank over the ``DINT_BENCH_MESH`` (host, chip) mesh, the
  hierarchical and the flat exchange;
* ``serve_tatp_*``, ``serve_smallbank_*``: `sweep_serve`, the serving
  plane's saturation probe ``_sat`` and Poisson rate points ``_r{N}pct``
  at fractions of it; ``serve_mesh_*``: `sweep_serve_mesh`, the same over
  the mesh serving plane (``DINT_SERVE_OVERLAP=1``: the overlap route);
* the points of `sweep_micro` (store, Zipf, scan ladder, lock traces, log,
  wire, colocate, cached store).

Build knobs (the route) come from the pinned plan's (PLAN_H100.json) pins
(`plan.resolve_for`;
``DINT_USE_HOTSET``/``DINT_USE_FUSED`` win only under
``DINT_PLAN_OVERRIDE=1``, ``DINT_BENCH_PLAN=0`` reads no plan); every
artifact carries ``plan``: {source, hash, overridden}, null without a
readable plan. ``DINT_MONITOR=1`` embeds each pipeline point's counter
snapshot in ``counters``, ``DINT_TRACE=1`` each closed point's dinttrace
summary in ``dinttrace`` (explicit nulls otherwise).
``DINT_EXP_TRACE_DIR=dir`` brackets each closed window with a
torch.profiler session in ``dir`` and ``breakdown`` holds
`monitor.attrib.report` of it. ``--skip-done`` skips points whose artifact
is already in ``--out`` (the open points still anchor on the loaded
closed peak).

What differs from exp.py:

* No fault tolerance: a point that raises (an integrity fault, a failed
  profiler session or attribution, any error) ends the run, with no
  retry, no error artifact and no summary. There is no Pallas probe and
  no degrade build: the CUDA kernels are the port's only route, so
  ``use_pallas`` is null where exp.py records it.
* Draws: where exp.py folds the block index into a JAX key, the port
  seeds a `torch.Generator` on the device with
  `serve.engine.block_seed(seed, i)`; the closed window's blocks draw in
  turn from one generator, as `stats.run_window` does. TATP populates
  with `tatp_dense.populate_device` on a generator seeded 0.
* A profiled point's ``breakdown`` is the port's (ROADMAP §C.13): each
  wave also carries ``host_ms``.
* The ``multihost_sb`` and ``serve_mesh`` legs run the
  ``DINT_BENCH_MESH`` mesh (default 4x2) in one process over the visible
  cards (`parallel/mesh.py`'s placement; ``device`` given: all on it), so
  the device count never skips them; they print exp.py's "skipped" line
  only for fewer than 3 hosts, and record the ``cards`` they ran on.
  ``use_hotset`` (None: ``DINT_USE_HOTSET``) is an argument of
  `sweep_micro`, whose point-op rows take no ordered run. A wire bench
  snapshots its pump after stopping it, so the last batch's tally is in
  (occupancy + padded == width * batches).
* ``device`` (None = CUDA) places every table; ``device="cpu"`` runs the
  plain path.
"""
from __future__ import annotations

import argparse
import json
import os
import threading
import time

import numpy as np
import torch

from . import plan as dplan
from . import stats as st
from .clients import micro
from .clients import tatp_client as tc
from .clients import tatp_wire as tw
from .clients import workloads as wl
from .device import resolve_device
from .engines import smallbank_dense as sd
from .engines import store, store_cache, tatp
from .engines import tatp_dense as td
from .engines.types import Op
from .monitor import attrib, profiler_session
from .monitor import counters as mon
from .monitor import txnevents as txe
from .parallel import multihost_sb as mhs
from .serve import ControllerCfg, MeshServeEngine, ServeEngine
from .serve import arrivals as arr
from .serve.engine import block_seed
from .shim import STORE, TATP, EnginePump, ShimClient
from .shim.host_kvs import CachedStore
from .stats import CpuMonitor, LatencyReservoir, MetricBlock, Recorder

WIRE_WARM_TRIES = 8
OPEN_RATES = (0.25, 0.5, 0.75, 0.9, 1.1)
SKEW_FRACS = (0.01, 0.04, 0.16, 0.5)
TATP_VW = 10
# where the dinttrace ring sits in each dense runner's carry: after the
# in-flight cohorts, before the counters (TATP (db, c1, c2, ring[, ctr]),
# SmallBank (db, c1, ring[, ctr]))
TATP_RING = 3
SB_RING = 2

# ---------------------------------------------------------------- helpers


def _percentiles(samples_us):
    lat = LatencyReservoir()
    for s in samples_us:
        lat.add(s)
    p = lat.percentiles()
    p["hist"] = lat.hist.to_dict()
    return p


def _monitor_on() -> bool:
    """DINT_MONITOR=1: the counter plane rides every pipeline point and
    its artifact embeds the end-of-point snapshot (null otherwise)."""
    return os.environ.get("DINT_MONITOR") == "1"


def _trace_on() -> bool:
    """DINT_TRACE=1: the dinttrace ring rides every pipeline point and
    each closed point embeds its summary (null otherwise); DINT_TRACE_RATE
    sets the sampling. The sweep writes no JSONL."""
    return os.environ.get("DINT_TRACE") == "1"


# the knobs DINT_PLAN_OVERRIDE=1 changed, over the whole process: every
# artifact's "plan" record names them
_PLAN_OVERRIDDEN: set = set()


def _plan_doc():
    """The pinned plan, or None without a readable one or under
    DINT_BENCH_PLAN=0."""
    if os.environ.get("DINT_BENCH_PLAN", "1") == "0":
        return None
    try:
        return dplan.load_plan()
    except (OSError, ValueError):
        return None


def _plan_knobs(workload: str) -> dict:
    """The route knobs of ``workload``: the plan's pins (env flags under
    DINT_PLAN_OVERRIDE=1), or the env flags without a readable plan."""
    knobs, meta = dplan.resolve_for(workload, plan=_plan_doc() or {})
    _PLAN_OVERRIDDEN.update(meta["overridden"])
    return knobs


def plan_meta():
    """The artifact's ``plan`` field: {source, hash, overridden} of the
    readable plan, None without one or under ``DINT_BENCH_PLAN=0``."""
    doc = _plan_doc()
    if doc is None:
        return None
    return {"source": str(dplan.plan_path()),
            "hash": doc.get("provenance", {}).get("cost_model_hash"),
            "overridden": sorted(_PLAN_OVERRIDDEN)}


def _gen(dev, seed: int, i: int) -> torch.Generator:
    """The generator of block ``i`` of a point seeded ``seed``."""
    g = torch.Generator(device=dev)
    g.manual_seed(block_seed(seed, i))
    return g


def _drain(drain, carry):
    """Drain a runner built under the current flags. The port's drains
    return (db, stats) + ((ring,) if DINT_TRACE) + ((counters,) if
    DINT_MONITOR): unpacked by the flags, never by length. Returns
    (tail_stats [n, n_stats] i64, counter snapshot or None, ring or
    None)."""
    out = drain(carry)
    rest = list(out[2:])
    if len(rest) != int(_trace_on()) + int(_monitor_on()):
        raise ValueError(f"the drain returned {len(out)} items; DINT_TRACE "
                         f"and DINT_MONITOR account for 2 + "
                         f"{int(_trace_on()) + int(_monitor_on())}")
    ring = rest.pop(0) if _trace_on() else None
    counters = mon.snapshot(rest.pop(0)) if _monitor_on() else None
    return st.fetch_stats(out[1]), counters, ring


def _wrap_trace(run, init, ring_ix: int):
    """DINT_TRACE=1: ``run`` wrapped so each block's event ring (at
    ``carry[ring_ix]``) is drained, deferred, into a per-point
    `TxnMonitor`, which hangs off the wrapper as ``txn_monitor`` for the
    closed window to summarize. The runner zeroes the ring at each block,
    so the drain rides every call."""
    if not _trace_on() or init.trace_cfg is None:
        return run
    tmon = txe.TxnMonitor(init.trace_cfg)

    def traced(carry, gen):
        carry, stats = run(carry, gen)
        ring = carry[ring_ix]
        if not isinstance(ring, txe.TxnRing):
            raise TypeError(f"carry[{ring_ix}] is {type(ring).__name__}, "
                            f"not the event ring")
        tmon.observe(ring, defer=True)
        return carry, stats

    traced.txn_monitor = tmon
    return traced


def pipeline_closed(run, carry, drain, n_stats, *, window_s, cpb, depth,
                    magic_idx, key_seed=0, device=None):
    """Closed-loop window over a pipelined runner: two warm blocks, the
    timed `stats.run_window`, the drain. Latency is cohort-granularity (a
    txn completes ``depth`` steps after its cohort's dispatch). The
    magic-word check covers the warm blocks, the window and the drain.
    ``DINT_EXP_TRACE_DIR`` brackets the window with a profiler session
    there. Returns (totals [n_stats], dt, percentiles, host cores,
    counters or None, dinttrace summary or None)."""
    dev = resolve_device(device)
    s0 = np.zeros(n_stats, np.int64)
    for warm in (999_999, 999_998):
        carry, s = run(carry, _gen(dev, key_seed, warm))
        s0 += st.fetch_stats(s).sum(axis=0)     # the fetch waits
    cpu = CpuMonitor()           # strictly over the timed window
    with profiler_session(os.environ.get("DINT_EXP_TRACE_DIR")):
        carry, total, warm_t, dt, _blocks, block_s = st.run_window(
            run, carry, _gen(dev, key_seed, 0), window_s, n_stats,
            warmup_blocks=0)
    cores = cpu.cores()
    tail, counters, ring = _drain(drain, carry)
    total = total + tail.sum(axis=0)
    if int(s0[magic_idx] + warm_t[magic_idx] + total[magic_idx]) != 0:
        raise RuntimeError("magic-byte integrity violated (incl. warmup)")
    p = st.cohort_latency_percentiles(block_s, cpb, depth)
    trace_sum = None
    tmon = getattr(run, "txn_monitor", None)
    if tmon is not None:
        tmon.flush()
        if ring is not None:     # the drained boundary cohorts' events
            tmon.observe(ring)
        trace_sum = tmon.summary()
    return total, dt, p, cores, counters, trace_sum


def pipeline_open(make_runner, n_stats, *, rate, window_s, w, cpb, depth,
                  key_seed=0, device=None):
    """Open-loop window: block i of cpb cohorts is dispatched at t0 + i *
    cpb * w / rate (or at once when late) and its stats are fetched at
    once, so the fetch marks its completion; a cohort's latency is its
    completion minus its scheduled arrival. ``split`` separates the
    QUEUEING delay (dispatch past the schedule) from the SERVICE time
    (dispatch to completion), each a percentile dict with its histogram.

    make_runner() -> (run, carry, drain): fresh state. Returns (totals,
    dt, percentiles, offered_rate, blocks dispatched, split)."""
    dev = resolve_device(device)
    run, carry, drain = make_runner()
    for warm in (999_999, 999_998):
        carry, s0 = run(carry, _gen(dev, key_seed, warm))
        st.fetch_stats(s0)

    period = cpb * w / rate            # seconds a block
    total = np.zeros(n_stats, np.int64)
    lat_blocks = []
    queue_lat = LatencyReservoir()
    service_lat = LatencyReservoir()
    t0 = time.time()
    i = 0
    while time.time() - t0 < window_s:
        sched = t0 + i * period
        now = time.time()
        if sched > now:
            time.sleep(sched - now)
        t_disp = time.time()
        carry, s = run(carry, _gen(dev, key_seed, i))
        total += st.fetch_stats(s).sum(axis=0)   # the fetch = completion
        done = time.time()
        # the block's cohorts arrive across its schedule slot
        arrive = sched + np.arange(cpb) * (w / rate)
        lat_blocks.append(np.maximum(done - arrive, 0.0) * 1e6)
        queue_lat.add(max(t_disp - sched, 0.0) * 1e6)
        service_lat.add((done - t_disp) * 1e6)
        i += 1
    dt = time.time() - t0
    tail, _, _ = _drain(drain, carry)
    total += tail.sum(axis=0)
    p = _percentiles(lat_blocks)
    offered = i * cpb * w / dt

    def _side(lat):
        d = {f"{k}_us": round(v, 2) for k, v in lat.percentiles().items()}
        d["hist"] = lat.hist.to_dict()
        return d

    split = {"queue": _side(queue_lat), "service": _side(service_lat)}
    return total, dt, p, offered, i, split


# ---------------------------------------------------------------- workloads


def _tatp_runner(n_sub, w, cpb, seed=0, device=None):
    """(run, carry, drain) of dense TATP at ``n_sub`` subscribers on the
    plan's route, the tables populated on the device."""
    dev = resolve_device(device)
    knobs = _plan_knobs("tatp_uniform")
    db = td.populate_device(torch.Generator(device=dev).manual_seed(seed),
                            n_sub, val_words=TATP_VW, device=dev)
    run, init, drain = td.build_pipelined_runner(
        n_sub, w=w, val_words=TATP_VW, cohorts_per_block=cpb,
        use_hotset=bool(knobs.get("use_hotset")),
        use_fused=bool(knobs.get("use_fused")), monitor=_monitor_on(),
        trace=_trace_on(), device=dev)
    run = _wrap_trace(run, init, TATP_RING)
    return run, init(db), drain


def _tatp_extras(total):
    att = int(total[td.STAT_ATTEMPTED])
    com = int(total[td.STAT_COMMITTED])
    if int(total[td.STAT_MAGIC_BAD]) != 0:
        raise RuntimeError("tatp magic-byte integrity violated")
    return att, com, {
        "ab_lock": int(total[td.STAT_AB_LOCK]),
        "ab_missing": int(total[td.STAT_AB_MISSING]),
        "ab_validate": int(total[td.STAT_AB_VALIDATE]),
    }


def _sb_runner(n_acc, w, cpb, hot_frac=None, hot_prob=None, device=None):
    """(run, carry, drain) of dense SmallBank at ``n_acc`` accounts on the
    plan's route."""
    dev = resolve_device(device)
    knobs = _plan_knobs("smallbank_skewed")
    db = sd.create(n_acc, device=dev)
    run, init, drain = sd.build_pipelined_runner(
        n_acc, w=w, cohorts_per_block=cpb, hot_frac=hot_frac,
        hot_prob=hot_prob, use_hotset=bool(knobs.get("use_hotset")),
        use_fused=bool(knobs.get("use_fused")), monitor=_monitor_on(),
        trace=_trace_on(), device=dev)
    run = _wrap_trace(run, init, SB_RING)
    return run, init(db), drain


def _sb_extras(total):
    att = int(total[sd.STAT_ATTEMPTED])
    com = int(total[sd.STAT_COMMITTED])
    if int(total[sd.STAT_MAGIC_BAD]) != 0:
        raise RuntimeError("smallbank magic-byte integrity violated")
    return att, com, {
        "ab_lock": int(total[sd.STAT_AB_LOCK]),
        "ab_logic": int(total[sd.STAT_AB_LOGIC]),
    }


def _sb_skew_extra(hot_frac, hot_prob, default_prob):
    """A SmallBank point's skew record: the skew and the use_hotset that
    actually built (the plan's pin, else the env flag)."""
    env_hot = os.environ.get("DINT_USE_HOTSET", "0") not in ("", "0")
    return {"hot_frac": (wl.SB_HOT_FRAC if hot_frac is None
                         else float(hot_frac)),
            "hot_prob": (default_prob if hot_prob is None
                         else float(hot_prob)),
            "use_hotset": _plan_knobs("smallbank_skewed").get("use_hotset",
                                                               env_hot)}


def run_point(results, name, fn):
    """Run one point and store its artifact; a point already done (under
    ``--skip-done``) is skipped. A raising point raises."""
    if getattr(results, "already_done", lambda n: False)(name):
        print(f"point {name}: skipped (already done)", flush=True)
        return
    out = fn()
    out.setdefault("plan", plan_meta())
    results[name] = out


def _metric_json(att, com, dt, p, extra, breakdown=None):
    """The point's metric block, with exp.py's schema keys: ``schema``,
    ``lat_hist`` beside the percentiles, and ``breakdown`` (an object
    exactly when attribution ran, null otherwise)."""
    d = MetricBlock(
        throughput=att / dt, goodput=com / dt,
        avg_us=p["avg"], p50_us=p["p50"], p99_us=p["p99"],
        p999_us=p["p999"], extra=extra).to_dict()
    d["schema"] = attrib.ARTIFACT_SCHEMA
    d["lat_hist"] = p.get("hist")
    d["breakdown"] = breakdown
    return d


def sweep_pipeline(name, runner_fn, extras_fn, n_stats, *, widths, cpb,
                   depth, magic_idx, window_s, open_rates, results,
                   lat_widths=(), point_extra=None, geom=None, device=None):
    """The closed-loop width ladder, then open-loop points at
    ``open_rates`` fractions of the ladder's peak (read from ``results``,
    so points loaded under ``--skip-done`` anchor it too), at the peak's
    width, then latency points (one cohort a call, each call's stats
    fetched at once: percentiles from measured timestamps).
    ``runner_fn(w, cpb)`` -> (run, carry, drain), fresh state.
    ``point_extra`` is recorded in every point's extras; ``geom`` (k/l/vw)
    feeds the breakdown's bytes formulas under DINT_EXP_TRACE_DIR, whose
    attribution raises when it fails."""
    dev = resolve_device(device)

    def _breakdown(w):
        tdir = os.environ.get("DINT_EXP_TRACE_DIR")
        if not tdir:
            return None
        return attrib.report(tdir, geometry=dict(geom or {}, w=w))

    def closed_point(w):
        def fn():
            run, carry, drain = runner_fn(w, cpb)
            total, dt, p, cores, counters, trace_sum = pipeline_closed(
                run, carry, drain, n_stats, window_s=window_s, cpb=cpb,
                depth=depth, magic_idx=magic_idx, device=dev)
            del run, carry, drain
            att, com, extra = extras_fn(total)
            extra.update(cores)
            extra["mode"] = "closed"
            extra["width"] = w
            extra.update(point_extra or {})
            extra["counters"] = counters
            extra["dinttrace"] = trace_sum
            return _metric_json(att, com, dt, p, extra,
                                breakdown=_breakdown(w))

        return fn

    peak = peak_w = None
    for w in widths:
        nm = f"{name}_closed_w{w}"
        run_point(results, nm, closed_point(w))
        blk = results.get(nm) or {}
        if "throughput" in blk and (peak is None or blk["throughput"] > peak):
            peak, peak_w = blk["throughput"], blk.get("width", w)
    if peak is None:
        return

    def open_point(frac):
        def fn():
            rate = max(peak * frac, 1.0)
            total, dt, p, offered, _, split = pipeline_open(
                lambda: runner_fn(peak_w, cpb), n_stats, rate=rate,
                window_s=window_s, w=peak_w, cpb=cpb, depth=depth,
                device=dev)
            att, com, extra = extras_fn(total)
            extra.update(mode="open", width=peak_w,
                         target_rate=round(rate, 1),
                         offered_rate=round(offered, 1), load_frac=frac,
                         queue=split["queue"], service=split["service"])
            return _metric_json(att, com, dt, p, extra)

        return fn

    for frac in open_rates:
        run_point(results, f"{name}_open_{int(frac * 100)}pct",
                  open_point(frac))

    def latency_point(w):
        def fn():
            run, carry, drain = runner_fn(w, 1)     # one cohort a call
            carry, total, dt, steps, p = st.run_latency_window(
                run, carry, _gen(dev, 7, 0), window_s, n_stats, depth=depth)
            tail, _, _ = _drain(drain, carry)
            total = total + tail.sum(axis=0)
            att, com, extra = extras_fn(total)
            extra.update(mode="latency_measured", width=w, cpb=1,
                         steps=steps, lat_samples=int(p["n"]))
            return _metric_json(att, com, dt, p, extra)

        return fn

    for w in lat_widths:
        run_point(results, f"{name}_latency_w{w}", latency_point(w))


def sweep_skew(n_acc, *, width, cpb, window_s, results, fracs=SKEW_FRACS,
               hot_prob=None, device=None):
    """The skew preset (``--only smallbank_skew``): one closed point a
    hot_frac at one width over the 90%-hot workload, the hot tier's
    decision curve (DINT_PLAN_OVERRIDE=1 DINT_USE_HOTSET=0/1 runs A/B the
    tier at each skew)."""
    dev = resolve_device(device)
    for frac in fracs:
        sweep_pipeline(
            f"smallbank_skew_h{int(frac * 100):02d}",
            lambda w, b, f=frac: _sb_runner(n_acc, w, b, f, hot_prob, dev),
            _sb_extras, sd.N_STATS, widths=[width], cpb=cpb, depth=2,
            magic_idx=sd.STAT_MAGIC_BAD, window_s=window_s, open_rates=(),
            results=results,
            point_extra=_sb_skew_extra(frac, hot_prob, 0.9),
            geom={"l": sd.L, "vw": sd.VW}, device=dev)


def sweep_serve(name, engine, size, *, window_s, open_rates, results,
                quick, cpb=4, depth=2, slo_us=5_000.0, device=None):
    """The serving plane's latency-vs-offered-load curve: point ``_sat``
    offers a block of arrivals all at t = 0 (the controller parks at its
    knee width and sheds past the SLO-feasible backlog; the achieved rate
    is the capacity), then Poisson schedules at ``open_rates`` fractions of
    it. Each artifact: offered vs achieved rate, the queue (the percentile
    block, what the SLO is written against) and service split, shed, the
    controller's trajectory and samples, the serve counters, the SLO
    verdict. One `ServeEngine` a point, closed before the next."""
    dev = resolve_device(device)
    widths = (64, 256) if quick else (256, 1024, 4096, 8192)
    max_arrivals = 50_000 if quick else 2_000_000

    def point(schedule_fn, extra_static):
        def fn():
            eng = ServeEngine(engine, size,
                              cfg=ControllerCfg(widths=widths, slo_us=slo_us),
                              cohorts_per_block=cpb, depth=depth,
                              monitor=True, seed=0, device=dev)
            eng.warmup()          # build the kernels outside the window
            eng.run(schedule_fn())
            eng.close()
            rep = eng.snapshot()
            p = {**eng.queue_hist.percentiles(),
                 "hist": eng.queue_hist.to_dict()}
            service = {**eng.service_hist.percentiles(),
                       "hist": eng.service_hist.to_dict()}
            del eng
            extra = dict(extra_static)
            extra.update(
                mode="serve", engine=engine, widths=list(widths),
                offered=rep["offered"], admitted=rep["admitted"],
                shed=rep["shed"], blocks=rep["blocks"],
                offered_rate=round(rep["offered_rate"], 1),
                achieved_rate=round(rep["achieved_rate"], 1),
                slo_us=slo_us, slo_met=rep["slo_met"], service=service,
                controller=rep["controller"],
                serve_counters={
                    k: rep["counters"].get(k, 0)
                    for k in ("serve_occupancy_lanes", "serve_padded_lanes",
                              "serve_shed_lanes")})
            return _metric_json(rep["attempted"], rep["committed"],
                                rep["elapsed_s"], p, extra)

        return fn

    n_probe = min(widths[-1] * cpb * 32, max_arrivals)
    nm = f"{name}_sat"
    run_point(results, nm, point(lambda: np.zeros(n_probe), {"load": "sat"}))
    peak = (results.get(nm) or {}).get("achieved_rate")
    if not peak:
        return
    for frac in open_rates:
        rate = max(peak * frac, 1.0)
        win = min(window_s, max_arrivals / rate)
        run_point(
            results, f"{name}_r{int(frac * 100)}pct",
            point(lambda r=rate, w=win: arr.poisson_schedule(r, w, seed=11),
                  {"load": frac, "target_rate": round(rate, 1)}))


def _mesh_shape_or_skip(name, dev):
    """``DINT_BENCH_MESH``'s (hosts, chips), or None after exp.py's
    "skipped" line when it names fewer than 3 hosts (the replication's
    fault-domain rule). The mesh runs in one process over the devices
    its placement gives (`parallel.mesh.placement`: the visible cards,
    one a partition where there are enough, else a host's partitions
    sharing one; every partition on ``dev`` when the caller named a
    device), so the device count never skips a leg; the line keeps
    exp.py's wording."""
    n_hosts, n_ici = mhs.mesh_shape_from_env()
    if n_hosts >= 3:
        return n_hosts, n_ici
    have = torch.cuda.device_count() if dev.type == "cuda" else 1
    print(f"{name}: skipped ({n_hosts}x{n_ici} mesh needs "
          f"{n_hosts * n_ici} devices and >= 3 hosts; have "
          f"{have} devices)", flush=True)
    return None


def _mh_sb_runner(n_acc, w, cpb, hierarchical, device=None, extra=None):
    """(run, carry, drain) of SmallBank over the ``DINT_BENCH_MESH`` mesh
    at ``n_acc`` global accounts, the hierarchical or the flat exchange;
    ``device`` None spreads the mesh over the visible cards, whose
    distinct devices go to ``extra["cards"]``."""
    mesh = mhs.make_mesh_2d(*mhs.mesh_shape_from_env(), device)
    if extra is not None:
        extra["cards"] = [str(d) for d in mesh.cards]
    run, init, drain = mhs.build_multihost_sb_runner(
        mesh, n_acc, w=w, cohorts_per_block=cpb, hierarchical=hierarchical,
        monitor=_monitor_on(), trace=_trace_on())
    run = _wrap_trace(run, init, SB_RING)
    return run, init(mhs.create_multihost_sb(mesh, n_acc)), drain


def _mh_sb_extras(total):
    att, com, extra = _sb_extras(total)
    extra["route_overflow"] = int(total[mhs.STAT_OVERFLOW])
    return att, com, extra


def sweep_multihost_sb(n_acc, *, width, cpb, window_s, results,
                       device=None):
    """exp.py's ``multihost_sb`` leg: the hierarchical-vs-flat exchange
    A/B over the ``DINT_BENCH_MESH`` mesh, one closed point each
    (``multihost_sb_{hier,flat}_closed_w{width}``), the same global
    geometry and outputs; the points carry the mesh, ``hierarchical`` and
    the ``cards`` of the mesh their runner built."""
    dev = resolve_device(device)
    shape = _mesh_shape_or_skip("multihost_sb", dev)
    if shape is None:
        return
    n_hosts, n_ici = shape
    mesh_extra = {"n_shards": n_hosts * n_ici,
                  "mesh": {"n_hosts": n_hosts, "n_ici": n_ici,
                           "axes": [mhs.DCN_AXIS, mhs.ICI_AXIS]}}
    for tag, hier in (("hier", True), ("flat", False)):
        extra = dict(mesh_extra, hierarchical=hier)
        sweep_pipeline(
            f"multihost_sb_{tag}",
            lambda w, b, h=hier, e=extra: _mh_sb_runner(n_acc, w, b, h,
                                                        device, e),
            _mh_sb_extras, mhs.N_STATS, widths=[width], cpb=cpb, depth=2,
            magic_idx=mhs.STAT_MAGIC_BAD, window_s=window_s, open_rates=(),
            results=results, point_extra=extra,
            geom={"l": 3, "vw": 2, "d": n_hosts * n_ici}, device=dev)


def sweep_serve_mesh(name, n_acc, *, window_s, open_rates, results,
                     quick, cpb=4, depth=2, slo_us=5_000.0, device=None):
    """The mesh serving plane's latency-vs-offered-load curve: the whole
    ``DINT_BENCH_MESH`` mesh served as one open-loop plane
    (`serve.mesh.MeshServeEngine`), the ladder of `sweep_serve` (a
    saturation probe ``_sat``, then Poisson points at ``open_rates`` of
    it); each artifact also carries the mesh, the per-host admitted/shed
    split, ``route_prefetch_lanes`` and the ``cards`` the partitions sit
    on (``device`` None: the visible cards). ``DINT_SERVE_OVERLAP=1``
    serves through the double-buffered route."""
    dev = resolve_device(device)
    shape = _mesh_shape_or_skip(name, dev)
    if shape is None:
        return
    n_hosts, n_ici = shape
    overlap = os.environ.get("DINT_SERVE_OVERLAP", "0") == "1"
    widths = (64, 256) if quick else (256, 1024, 4096)
    max_arrivals = 50_000 if quick else 2_000_000

    def point(schedule_fn, extra_static):
        def fn():
            eng = MeshServeEngine(
                n_acc, mesh_shape=(n_hosts, n_ici),
                cfg=ControllerCfg(widths=widths, slo_us=slo_us),
                cohorts_per_block=cpb, depth=depth, monitor=True, seed=0,
                overlap=overlap, device=device)
            cards = [str(d) for d in eng.mesh.cards]
            eng.warmup()          # build the kernels outside the window
            eng.run(schedule_fn())
            eng.close()
            rep = eng.snapshot()
            p = {**eng.queue_hist.percentiles(),
                 "hist": eng.queue_hist.to_dict()}
            service = {**eng.service_hist.percentiles(),
                       "hist": eng.service_hist.to_dict()}
            del eng
            extra = dict(extra_static)
            extra.update(
                mode="serve_mesh", engine="multihost_sb",
                widths=list(widths), mesh=rep["mesh"], cards=cards,
                per_host=rep["per_host"],
                offered=rep["offered"], admitted=rep["admitted"],
                shed=rep["shed"], blocks=rep["blocks"],
                offered_rate=round(rep["offered_rate"], 1),
                achieved_rate=round(rep["achieved_rate"], 1),
                slo_us=slo_us, slo_met=rep["slo_met"], service=service,
                controller=rep["controller"],
                serve_counters={
                    k: rep["counters"].get(k, 0)
                    for k in ("serve_occupancy_lanes", "serve_padded_lanes",
                              "serve_shed_lanes", "route_prefetch_lanes")})
            return _metric_json(rep["attempted"], rep["committed"],
                                rep["elapsed_s"], p, extra)

        return fn

    # saturation probe across the whole mesh: every arrival at t = 0
    n_probe = min(widths[-1] * cpb * n_hosts * n_ici * 8, max_arrivals)
    nm = f"{name}_sat"
    run_point(results, nm, point(lambda: np.zeros(n_probe), {"load": "sat"}))
    peak = (results.get(nm) or {}).get("achieved_rate")
    if not peak:
        return
    for frac in open_rates:
        rate = max(peak * frac, 1.0)
        win = min(window_s, max_arrivals / rate)
        run_point(
            results, f"{name}_r{int(frac * 100)}pct",
            point(lambda r=rate, w=win: arr.poisson_schedule(r, w, seed=11),
                  {"load": frac, "target_rate": round(rate, 1)}))


def _timed_client(client, go, window_s):
    go()                             # the warm round
    client.rec.reset()
    t0 = time.time()
    while time.time() - t0 < window_s:
        go()
    return client.rec.block(time.time() - t0).to_dict()


def sweep_micro(window_s, quick, results, want=lambda name: True,
                use_hotset=None, device=None):
    """store / lock_2pl / lock_fasst (+ attribution) / log_server and the
    wire points through their clients. ``want`` gates each point before it
    runs. ``use_hotset`` None reads ``DINT_USE_HOTSET``; ``device`` None is
    the card."""
    dev = resolve_device(device)
    if use_hotset is None:
        use_hotset = os.environ.get("DINT_USE_HOTSET", "0") not in ("", "0")
    rng = np.random.default_rng(0)
    n_keys = 10_000 if quick else 1_000_000
    widths = [1024] if quick else [1024, 4096, 16384]

    def store_client(w, **kw):
        return micro.StoreClient.populated(n_keys, width=w, device=dev,
                                           use_hotset=use_hotset, **kw)

    def timed(name, client, go):
        run_point(results, name,
                  lambda: _timed_client(client, go, window_s))

    for read_frac, tag in ((0.5, "contention"), (1.0, "parallel")):
        for w in widths:
            name = f"store_{tag}_w{w}"
            if not want(name):
                continue

            def store_fn(w=w, read_frac=read_frac):
                c = store_client(w, read_frac=read_frac)
                return _timed_client(c, lambda: c.run_wave(rng),
                                     window_s) | {"width": w, "scan": None}

            run_point(results, name, store_fn)

    # the skewed store: Zipfian keys whose hot head is the hot mirror's
    # prefix when use_hotset is on
    for w in widths:
        name = f"store_zipf_w{w}"
        if not want(name):
            continue

        def zipf_fn(w=w):
            c = store_client(w, read_frac=0.5, key_dist="zipfian")
            return _timed_client(c, lambda: c.run_wave(rng), window_s) | {
                "width": w, "key_dist": "zipfian",
                "zipf_theta": wl.ZIPF_THETA,
                "use_hotset": c.use_hotset, "use_pallas": None,
                "scan": None}

        run_point(results, name, zipf_fn)

    # the scan-share ladder over the ordered run: YCSB-B (0%) to YCSB-E
    # (95% scans) at one width, Zipfian start keys, uniform lengths
    scan_w = 1024 if quick else 4096
    scan_max = 16 if quick else wl.YCSB_E_MAX_SCAN
    for frac in (0.0, 0.05, 0.5, 0.95):
        name = f"store_scan_f{int(frac * 100)}"
        if not want(name):
            continue

        def scan_fn(frac=frac, w=scan_w, scan_max=scan_max):
            c = store_client(w, read_frac=0.5, key_dist="zipfian",
                             use_scan=True, scan_frac=frac,
                             scan_max=scan_max, rebuild_every=1)
            return _timed_client(c, lambda: c.run_wave(rng),
                                 window_s) | {
                "width": w, "key_dist": "zipfian",
                "zipf_theta": wl.ZIPF_THETA,
                "scan": {"use_scan": c.use_scan, "scan_frac": frac,
                         "scan_max": scan_max,
                         "max_scan_len": c.max_scan_len,
                         "delta_cap": c.delta_cap,
                         "rebuild_every": c.rebuild_every,
                         "use_pallas": None}}

        run_point(results, name, scan_fn)

    if any(want(n) for n in ("lock_2pl", "lock_fasst", "lock_fasst_attr")):
        trace = wl.lock_trace(rng, n_txns=200 if quick else 20_000,
                              key_range=4800)
        for cls, name, kw in ((micro.Lock2PLClient, "lock_2pl", {}),
                              (micro.FasstClient, "lock_fasst", {}),
                              (micro.FasstClient, "lock_fasst_attr",
                               {"attribute": True})):
            if not want(name):
                continue
            c = cls(trace, cohort=64 if quick else 512, device=dev, **kw)
            timed(name, c, c.run_round)

    if want("log_server"):
        c = micro.LogClient(width=1024 if quick else 8192, device=dev)
        timed("log_server", c, lambda: c.run_wave(rng))

    if want("store_wire"):
        run_point(results, "store_wire",
                  lambda: _store_wire_bench(window_s, quick, dev))

    if want("tatp_wire"):
        run_point(results, "tatp_wire",
                  lambda: _tatp_wire_bench(window_s, quick, dev))

    if want("tatp_wire_txn"):
        run_point(results, "tatp_wire_txn",
                  lambda: _tatp_wire_txn_bench(window_s, quick, dev))

    # the colocated servers (exp/run_tatp_colocate.sh:27 shares 8 cores):
    # the whole process pinned to n cores, the wire bench again
    for n in (1, 2, 4):
        name = f"tatp_colocate_c{n}"
        if want(name):
            run_point(results, name,
                      lambda n=n: _colocate_bench(n, window_s, quick, dev))

    for tag in ("wb_bloom", "wb_nobloom", "wt"):
        name = f"store_cached_{tag}"
        if want(name):
            run_point(results, name,
                      lambda tag=tag: _store_cached_bench(tag, window_s,
                                                          quick, dev))


def _store_cached_bench(tag, window_s, quick, dev):
    """The two-tier store (device cache + host KVS) on one policy, the
    reference's store-server ablation (store/ebpf/store_kern.c,
    store_wb_kern.c, store_wt_kern.c): a keyspace of ~2x the cache's
    capacity keeps the miss and refill path live; the extras give the hit,
    miss and bloom split."""
    policy = {"wb_bloom": store_cache.WB_BLOOM,
              "wb_nobloom": store_cache.WB_NOBLOOM,
              "wt": store_cache.WT}[tag]
    cache_buckets = 1 << (10 if quick else 16)
    n_keys = cache_buckets * 8           # the cache holds ~half the keys
    width = 1_024 if quick else 4_096

    srv = CachedStore(cache_buckets, val_words=10, policy=policy,
                      width=width, device=dev)
    keys_all = np.arange(1, n_keys + 1, dtype=np.uint64)
    vals = np.zeros((n_keys, 10), np.uint32)
    vals[:, 0] = keys_all.astype(np.uint32)
    vals[:, 1] = micro.STORE_MAGIC
    srv.populate(keys_all, vals)

    rng = np.random.default_rng(0)
    wv = np.zeros((width, 10), np.uint32)
    wv[:, 1] = micro.STORE_MAGIC
    rec = Recorder()

    def wave():
        k = rng.integers(1, int(n_keys * 1.1), width).astype(np.uint64)
        is_read = rng.random(width) < 0.5
        ops = np.where(is_read, Op.GET, Op.SET).astype(np.int32)
        t0 = time.monotonic()
        srv.serve(ops, k, wv)
        rec.record(width, width, np.full(width,
                                         (time.monotonic() - t0) * 1e6))

    wave()     # queues refills for its misses
    wave()     # runs the refill path (pending is non-empty now)
    rec.reset()
    srv.stats = type(srv.stats)()
    t0 = time.time()
    while time.time() - t0 < window_s:
        wave()
    block = rec.block(time.time() - t0)
    st = srv.stats
    block.extra.update(policy=tag, hits=st.hits, misses=st.misses,
                       bloom_negatives=st.bloom_negatives,
                       writebacks=st.writebacks,
                       hit_rate=round(st.hits / max(st.hits + st.misses, 1),
                                      4))
    return block.to_dict()


def _warm_pump(pump, label):
    """One answered single-request exchange, so the window starts past the
    pump's first step; raises when no exchange is answered."""
    with ShimClient("127.0.0.1", pump.port) as c:
        for _ in range(WIRE_WARM_TRIES):
            if c.exchange(np.zeros(1, np.uint8), np.array([1], np.uint64),
                          timeout_ms=20_000)["n"] == 1:
                return
    raise RuntimeError(f"{label}: the pump answered no warm-up exchange in "
                       f"{WIRE_WARM_TRIES} tries")


def _wire_clients(pump, n_clients, window_s, wave_fn):
    """``n_clients`` threads, each with its own ShimClient, calling
    ``wave_fn(i, client, rng, stop_at)`` until the window ends. Returns
    (sent, answered, latency reservoirs, seconds)."""
    stop_at = time.time() + window_s
    sent = np.zeros(n_clients, np.int64)
    answered = np.zeros(n_clients, np.int64)
    lats = [LatencyReservoir(seed=i) for i in range(n_clients)]
    errs = []

    def worker(i):
        try:
            rng = np.random.default_rng(i)
            with ShimClient("127.0.0.1", pump.port) as c:
                wave_fn(i, c, rng, stop_at, sent, answered, lats[i])
        except Exception as e:          # raised after the join
            errs.append(e)

    t0 = time.time()
    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    return sent, answered, lats, time.time() - t0


def _wire_block(sent, answered, lats, dt, extra):
    """The clients' metric block: the reservoirs re-added (approximate past
    their cap), the histograms merged exactly."""
    agg = LatencyReservoir()
    for lr in lats:
        agg.add(lr.samples[:lr.n_kept])
        if lr is not lats[0]:
            lats[0].hist.merge(lr.hist)
    p = agg.percentiles()
    return MetricBlock(
        throughput=float(sent.sum()) / dt,
        goodput=float(answered.sum()) / dt,
        avg_us=p["avg"], p50_us=p["p50"], p99_us=p["p99"],
        p999_us=p["p999"],
        extra={**extra, "lat_hist": lats[0].hist.to_dict()}).to_dict()


def _store_wire_bench(window_s, quick, dev):
    """The store served over the wire: reference-format UDP datagrams
    through the native pump (recvmmsg batch -> store.step -> sendmmsg
    scatter), pkt/s from two loopback clients at 50/50 GET/SET, the
    reference's store server benchmark (store/udp/server.cc:50-98; its pps
    counter, store/ebpf/store_user.c:58-65)."""
    n_keys = 4_096 if quick else 200_000
    width = 1_024 if quick else 4_096
    n_clients = 2
    wave = width // n_clients

    table = micro.make_store_table(n_keys, device=dev)

    def waves(i, c, rng, stop_at, sent, answered, lat):
        while time.time() < stop_at:
            k = rng.integers(1, n_keys + 1, size=wave).astype(np.uint64)
            is_read = rng.random(wave) < 0.5     # the contention mix
            t0 = time.monotonic()
            r = c.exchange(np.where(is_read, 0, 1).astype(np.uint8), k,
                           timeout_ms=10_000)
            dt = time.monotonic() - t0
            sent[i] += wave
            answered[i] += r["n"]
            lat.add(np.full(r["n"], dt * 1e6))

    with EnginePump(STORE, store.step, table, width=width, flush_us=500,
                    device=dev).start() as pump:
        _warm_pump(pump, "store_wire")
        sent, answered, lats, dt = _wire_clients(pump, n_clients, window_s,
                                                 waves)
        pump.stop()       # the last batch's tally lands before the snapshot
        pump_lat = pump.latency_snapshot()
    return _wire_block(sent, answered, lats, dt, {
        "unit": "pkt/s", "clients": n_clients, "wave": wave,
        "transport": "udp_loopback_shim", "pump": pump_lat})


def _tatp_wire_bench(window_s, quick, dev):
    """One TATP shard served over the wire (tatp/udp/server_shard.cc, wire
    codes tatp/ebpf/utils.h:38-73): two loopback clients send 80% kRead
    over the five tables and a kAcquireLock/kAbort slice (each wave aborts
    the last wave's grants, so lock occupancy holds steady); pkt/s like
    the reference's server counter."""
    n_sub = 2_000 if quick else 100_000
    width = 512 if quick else 4_096
    n_clients = 2
    wave = width // n_clients
    n_lock = wave // 10

    shard = tc.populate_shards(np.random.default_rng(0), n_sub, val_words=10,
                               log_capacity=1 << 14 if quick else 1 << 20,
                               device=dev)[0][0]
    grants = np.zeros(n_clients, np.int64)

    def waves(i, c, rng, stop_at, sent, answered, lat):
        # a client's lock keys are its own half of the subscribers, so an
        # abort always releases a row this client locked
        lo = 1 + i * (n_sub // n_clients)
        hi = lo + n_sub // n_clients
        prev_locks = np.zeros(0, np.uint64)
        while time.time() < stop_at:
            n_ab = len(prev_locks)
            n_rd = wave - n_lock - n_ab
            rd_tbl = rng.integers(0, 5, n_rd).astype(np.uint8)
            rd_key = rng.integers(1, n_sub + 1, n_rd)
            rd_key = np.where(rd_tbl >= tatp.ACCESS_INFO,
                              rd_key * 4 + rng.integers(0, 4, n_rd), rd_key)
            rd_key = np.where(
                rd_tbl == tatp.CALL_FORWARDING,
                np.asarray(tatp.cf_key(rng.integers(1, n_sub + 1, n_rd),
                                       rng.integers(1, 5, n_rd),
                                       rng.integers(0, 3, n_rd) * 8)),
                rd_key)
            lk_key = rng.choice(hi - lo, n_lock, replace=False) + lo
            types = np.concatenate([np.zeros(n_rd, np.uint8),
                                    np.ones(n_lock, np.uint8),
                                    np.full(n_ab, 2, np.uint8)])
            tbls = np.concatenate([rd_tbl,
                                   np.zeros(n_lock + n_ab, np.uint8)])
            keys = np.concatenate([rd_key.astype(np.uint64),
                                   lk_key.astype(np.uint64), prev_locks])
            t0 = time.monotonic()
            r = c.exchange(types, keys, tables=tbls, timeout_ms=10_000)
            dt = time.monotonic() - t0
            sent[i] += len(types)
            answered[i] += r["n"]
            lat.add(np.full(r["n"], dt * 1e6))
            granted = r["key"][r["type"] == 7]   # kGrantLock
            grants[i] += len(granted)
            prev_locks = granted.astype(np.uint64)
        # release what is still held, so the run ends clean
        if len(prev_locks):
            c.exchange(np.full(len(prev_locks), 2, np.uint8), prev_locks,
                       timeout_ms=10_000)

    with EnginePump(TATP, tatp.step, shard, width=width, flush_us=500,
                    device=dev).start() as pump:
        _warm_pump(pump, "tatp_wire")
        sent, answered, lats, dt = _wire_clients(pump, n_clients, window_s,
                                                 waves)
        pump.stop()       # the last batch's tally lands before the snapshot
        pump_lat = pump.latency_snapshot()
    return _wire_block(sent, answered, lats, dt, {
        "unit": "pkt/s", "clients": n_clients, "wave": wave,
        "lock_grants": int(grants.sum()), "n_subscribers": n_sub,
        "transport": "udp_loopback_shim", "pump": pump_lat})


def _tatp_wire_txn_bench(window_s, quick, dev):
    """Whole TATP transactions over the wire: three UDP shard servers and
    the wave coordinator fanning each shard's datagrams out, the
    reference's serving topology (3 servers and a Caladan client,
    client_ebpf_shard.cc:636-677); txn/s with the abort taxonomy."""
    n_sub = 2_000 if quick else 100_000
    # w = 2048 puts ~2.7k lanes on a shard in wave 1: ~11 chunks over 8
    # sockets a shard, more than 256 in flight (the reference's uthread
    # re-send loops, client_ebpf_shard.cc:643-677)
    w = 128 if quick else 2048

    lat = LatencyReservoir()
    with tw.serve_shards(n_sub, width=4 * w, flush_us=500,
                         device=dev) as ports:
        with tw.WireCoordinator(ports, n_sub, width=4 * w,
                                n_socks=8) as coord:
            rng = np.random.default_rng(0)
            coord.run_cohort(rng, w)            # the warm cohort
            coord.stats = type(coord.stats)()
            t0 = time.time()
            while time.time() - t0 < window_s:
                c0 = time.monotonic()
                coord.run_cohort(rng, w)
                # closed loop: a txn's latency is its cohort's whole span
                lat.add(np.full(w, (time.monotonic() - c0) * 1e6))
            dt = time.time() - t0
            st = coord.stats

    p = lat.percentiles()
    return MetricBlock(
        throughput=st.attempted / dt, goodput=st.committed / dt,
        avg_us=p["avg"], p50_us=p["p50"], p99_us=p["p99"],
        p999_us=p["p999"],
        extra={"unit": "txn/s", "width": w, "n_subscribers": n_sub,
               "ab_lock": st.aborted_lock, "ab_missing": st.aborted_missing,
               "ab_validate": st.aborted_validate,
               "ab_timeout": st.aborted_timeout,
               "timeout_lanes": st.timeout_lanes,
               "transport": "udp_loopback_3shard"}).to_dict()


def _colocate_bench(n_cores, window_s, quick, dev):
    """The reference's colocated experiment (exp/run_tatp_colocate.sh:27
    pins the servers to 8 shared cores): the whole process, the C++ RX
    thread, torch's threads, the wire parse, the reply scatter and the
    dispatch, pinned to ``n_cores``, and the TATP wire bench again.
    Threads started inside inherit the affinity."""
    all_cpus = os.sched_getaffinity(0)
    cpu = CpuMonitor()
    try:
        # inside the try: a raise after narrowing must not leave the
        # process pinned
        os.sched_setaffinity(0, set(sorted(all_cpus)[:n_cores]))
        out = _tatp_wire_bench(window_s, quick, dev)
    finally:
        os.sched_setaffinity(0, all_cpus)
    out.update(cpu.cores())
    out["host_cores_pinned"] = n_cores
    return out


class _ResultSink(dict):
    """Results that write each point to ``<out>/<name>.json`` as it lands,
    so a run cut short keeps every finished point."""

    def __init__(self, out: str, skip_done: bool = False):
        super().__init__()
        self.out = out
        self.skip_done = skip_done

    def __setitem__(self, name, block):
        super().__setitem__(name, block)
        with open(os.path.join(self.out, f"{name}.json"), "w") as f:
            json.dump(block, f, indent=1)

    def already_done(self, name) -> bool:
        """Under ``--skip-done``: the point's artifact is in ``out`` (an
        error artifact of exp.py's does not count); it is loaded for the
        summary."""
        if not self.skip_done:
            return False
        try:
            with open(os.path.join(self.out, f"{name}.json")) as f:
                block = json.load(f)
        except (OSError, ValueError):
            return False
        if "error" in block:
            return False
        super().__setitem__(name, block)
        return True


def run(out: str, window_s: float = 10.0, quick: bool = False,
        only: str | None = None, skip_done: bool = False,
        hot_frac: float | None = None, hot_prob: float | None = None,
        use_hotset=None, device=None) -> dict:
    """exp.py's `run_all`: the TATP and SmallBank pipeline legs, the mesh
    leg, the skew preset, the serve legs and the mesh serve leg, then
    `sweep_micro`,
    into ``out``; then ``out/summary.json``. ``only`` is a name substring
    filter both ways (``--only tatp`` runs tatp_closed_w256,
    ``--only tatp_closed`` passes the coarse ``tatp`` gate)."""
    dev = resolve_device(device)
    os.makedirs(out, exist_ok=True)
    results = _ResultSink(out, skip_done=skip_done)

    # the reference's scale: 7M subscribers (tatp/caladan/tatp.h:28), 24M
    # accounts (smallbank.h:16); the peak width first, then the latency
    # floor's small widths
    n_sub = 2_000 if quick else int(os.environ.get(
        "DINT_EXP_SUBSCRIBERS", 7_000_000))
    n_acc = 20_000 if quick else int(os.environ.get(
        "DINT_EXP_SB_ACCOUNTS", 24_000_000))
    widths = [256] if quick else [8192, 256, 1024, 2048, 32768]
    lat_widths = [256] if quick else [256, 1024, 8192]
    cpb = 4
    rates = OPEN_RATES[1::2] if quick else OPEN_RATES

    def want(name):
        return only is None or only in name or name in only

    if want("tatp"):
        sweep_pipeline("tatp", lambda w, b: _tatp_runner(n_sub, w, b,
                                                         device=dev),
                       _tatp_extras, td.N_STATS, widths=widths, cpb=cpb,
                       depth=3, magic_idx=td.STAT_MAGIC_BAD,
                       window_s=window_s, open_rates=rates, results=results,
                       lat_widths=lat_widths,
                       geom={"k": td.K, "vw": TATP_VW}, device=dev)
    skew_preset = only is not None and "skew" in only
    if want("smallbank") and not skew_preset:
        sweep_pipeline("smallbank",
                       lambda w, b: _sb_runner(n_acc, w, b, hot_frac,
                                               hot_prob, dev),
                       _sb_extras, sd.N_STATS, widths=widths, cpb=cpb,
                       depth=2, magic_idx=sd.STAT_MAGIC_BAD,
                       window_s=window_s, open_rates=rates, results=results,
                       lat_widths=lat_widths,
                       point_extra=_sb_skew_extra(hot_frac, hot_prob,
                                                  wl.SB_HOT_PROB),
                       geom={"l": sd.L, "vw": sd.VW}, device=dev)
    if want("multihost_sb") and not skew_preset:
        sweep_multihost_sb(n_acc, width=256 if quick else 8192, cpb=cpb,
                           window_s=window_s, results=results, device=dev)
    if skew_preset:
        sweep_skew(n_acc, width=256 if quick else 8192, cpb=cpb,
                   window_s=window_s, results=results, hot_prob=hot_prob,
                   device=dev)
    # --only serve_mesh is a preset: the two-way filter would also fire
    # the single-device serve legs
    mesh_preset = only is not None and "mesh" in only
    if want("serve") and not mesh_preset:
        sweep_serve("serve_tatp", "tatp_dense", n_sub, window_s=window_s,
                    open_rates=rates, results=results, quick=quick, cpb=cpb,
                    device=dev)
        sweep_serve("serve_smallbank", "smallbank_dense", n_acc,
                    window_s=window_s, open_rates=rates, results=results,
                    quick=quick, cpb=cpb, device=dev)
    if want("serve_mesh") and not skew_preset:
        sweep_serve_mesh("serve_mesh", n_acc, window_s=window_s,
                         open_rates=rates, results=results, quick=quick,
                         cpb=cpb, device=dev)

    sweep_micro(window_s, quick, results, want=want, use_hotset=use_hotset,
                device=dev)
    summary = {"configs": sorted(results), "window_s": window_s,
               "quick": quick}
    with open(os.path.join(out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="The experiment sweep of the PyTorch port.")
    ap.add_argument("--out", default="exp_results")
    ap.add_argument("--window", type=float, default=10.0)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--only", default=None)
    ap.add_argument("--skip-done", action="store_true",
                    help="skip points whose artifact already exists")
    ap.add_argument("--hot-frac", type=float, default=None,
                    help="SmallBank hot-set fraction (default: the "
                         "reference's 4%%)")
    ap.add_argument("--hot-prob", type=float, default=None,
                    help="SmallBank hot-set probability (default: the "
                         "reference's 90%%)")
    args = ap.parse_args(argv)
    if args.quick and args.window == 10.0:
        args.window = 1.0
    results = run(args.out, window_s=args.window, quick=args.quick,
                  only=args.only, skip_done=args.skip_done,
                  hot_frac=args.hot_frac, hot_prob=args.hot_prob)
    for name in sorted(results):
        r = results[name]
        print(f"{name}: goodput={r['goodput']:.0f}/s "
              f"abort={r['abort_rate']:.4f} p99={r['p99_us']:.0f}us")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
