"""The port's headline benchmark: TATP committed txn/s at 7M subscribers on
one card, with the SmallBank leg. The port of bench.py's measurement
(`_child_main`, bench.py:113-486).

    python -m dint_tpu_torch.bench          # needs one CUDA card

Writes the measurement to ``artifacts/BENCH_<commit>_<ts>.json`` (a failed
write raises) and prints ONE JSON line on stdout with bench.py's keys: the
TATP mix 35/35/10/2/14/2/2 over NURand subscriber ids, 3 replicated shards
(log x3 + bck x2 + prim commit pipeline), the dense pipelined engine with
cross-cohort concurrency, workload drawn on the device, a timed window of
committed (goodput) txns/s, the abort breakdown, and latency at cohort
granularity (a txn completes 3 pipeline steps after its cohort's
dispatch). Then the SmallBank leg (`clients/bench_smallbank.py`).

What differs from bench.py's line:

* ``route`` (a key of `engines.types.ROUTES`) takes the place of
  ``use_pallas``/``use_hotset``: the port has no XLA path and always runs
  its CUDA kernels.
* ``device`` and ``card``: the torch device's name, and the card's name
  and power limit as `nvidia-smi --query-gpu=name,power.limit
  --format=csv,noheader` gives them (null on the CPU).
* Keys of modules not ported yet are explicit nulls: ``dintlint``,
  ``dintcost``, ``dintdur``.
* ``breakdown`` is `monitor.attrib`'s: device time charged to each wave
  through the kernels' launches, plus each wave's ``host_ms``.
* No parent/child retry, no stale line, no fallback to another path, no
  caught SmallBank leg, serve probe, profiler session or attribution: any
  failure, a magic-word or balance fault of either leg included, raises,
  and the process exits non-zero with no result line.

Knobs, the environment variables bench.py reads:

* ``DINT_BENCH_SUBSCRIBERS`` (7,000,000), ``DINT_BENCH_WIDTH`` (8192),
  ``DINT_BENCH_BLOCK`` (16 cohorts a block), ``DINT_BENCH_WINDOW_S`` (10);
* ``DINT_BENCH_SB_WIDTH`` (one SmallBank width; both 8192 and 16384 when
  unset), ``DINT_BENCH_SB_ACCOUNTS`` (24,000,000), ``DINT_BENCH_HOT_FRAC``
  and ``DINT_BENCH_HOT_PROB`` (the SmallBank skew, 0.04 and 0.9 unset),
  ``DINT_BENCH_SKIP_SB=1`` (no SmallBank leg);
* ``DINT_BENCH_PROFILE=1``: a ``profile`` block with the set-up and warm
  seconds, the steady block times, and each leg's kernel launches;
* ``DINT_MONITOR=1``: the counter plane rides the TATP carry and
  ``counters`` holds its end-of-run snapshot (null otherwise);
  ``DINT_MONITOR_JSONL=path`` adds a `monitor.Monitor` over a
  `monitor.TraceWriter` there, one wave event a block (deferred reads);
* ``DINT_TRACE=1``: the dinttrace ring rides the TATP carry, sampled at
  ``DINT_TRACE_RATE`` (1.0), drained each block (deferred) by a
  `TxnMonitor` that streams to ``DINT_TRACE_JSONL`` when set;
  ``dinttrace`` holds its summary (null otherwise);
* ``DINT_BENCH_TRACE_DIR=dir`` with ``DINT_BENCH_PROFILE=1``: one more
  TATP block after the window under `monitor.profiler_session`, and
  ``breakdown`` holds `monitor.attrib.report` of its trace with geometry
  w, k = K, vw (null otherwise);
* the route: PLAN.json's pinned ``use_hotset``/``use_fused`` for
  ``tatp_uniform`` and ``smallbank_skewed``, which ``DINT_USE_HOTSET`` and
  ``DINT_USE_FUSED`` change only under ``DINT_PLAN_OVERRIDE=1``
  (`plan.resolve_for`); ``plan`` records {source, hash, overridden};
* ``DINT_BENCH_SERVE=1``: ``serve`` holds the serving plane's probe
  (`serve_probe`), an explicit null otherwise.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from . import plan
from . import stats as st
from .clients import bench_smallbank
from .device import resolve_device
from .engines import tatp_dense as td
from .engines.types import ROUTES
from .monitor import Monitor, TraceWriter, attrib, profiler_session
from .monitor import counters as mon
from .monitor import txnevents as txe
from .ops import row_kernels, scan_kernels
from .serve import ControllerCfg, ServeEngine

ASSUMED_BASELINE = 3.0e6   # committed txn/s, tatp/ebpf single-server estimate
VAL_WORDS = 10
DEPTH = 3                  # pipeline steps from a cohort's dispatch to commit
_ROUTE_OF = {flags: name for name, flags in ROUTES.items()}


@dataclasses.dataclass(frozen=True)
class Knobs:
    n_subscribers: int = 7_000_000
    width: int = 8192
    block: int = 16
    window_s: float = 10.0
    sb_widths: tuple = bench_smallbank.WIDTHS
    sb_accounts: int = bench_smallbank.N_ACCOUNTS
    hot_frac: float | None = None
    hot_prob: float | None = None
    profile: bool = False
    skip_sb: bool = False
    monitor: bool = False
    monitor_jsonl: str | None = None
    trace: bool = False
    trace_rate: float = 1.0
    trace_jsonl: str | None = None
    trace_dir: str | None = None
    serve: bool = False

    @classmethod
    def from_env(cls, env) -> "Knobs":
        def opt(name, conv):
            return conv(env[name]) if name in env else None

        k = cls()
        sb_w = opt("DINT_BENCH_SB_WIDTH", int)
        return cls(
            n_subscribers=int(env.get("DINT_BENCH_SUBSCRIBERS",
                                      k.n_subscribers)),
            width=int(env.get("DINT_BENCH_WIDTH", k.width)),
            block=int(env.get("DINT_BENCH_BLOCK", k.block)),
            window_s=float(env.get("DINT_BENCH_WINDOW_S", k.window_s)),
            sb_widths=(sb_w,) if sb_w is not None else k.sb_widths,
            sb_accounts=int(env.get("DINT_BENCH_SB_ACCOUNTS",
                                    k.sb_accounts)),
            hot_frac=opt("DINT_BENCH_HOT_FRAC", float),
            hot_prob=opt("DINT_BENCH_HOT_PROB", float),
            profile=env.get("DINT_BENCH_PROFILE") == "1",
            skip_sb=env.get("DINT_BENCH_SKIP_SB") == "1",
            monitor=env.get("DINT_MONITOR") == "1",
            monitor_jsonl=env.get("DINT_MONITOR_JSONL") or None,
            trace=env.get("DINT_TRACE") == "1",
            trace_rate=float(env.get("DINT_TRACE_RATE", k.trace_rate)),
            trace_jsonl=env.get("DINT_TRACE_JSONL") or None,
            trace_dir=(env.get("DINT_BENCH_TRACE_DIR") or None
                       if env.get("DINT_BENCH_PROFILE") == "1" else None),
            serve=env.get("DINT_BENCH_SERVE") == "1")


def plan_route(workload: str, env) -> tuple[str, dict]:
    """The route PLAN.json pins for ``workload`` as `plan.resolve_for`
    resolves it under ``env``, and the plan record {source, hash,
    overridden}: bench.py's record, since the line's ``route`` already
    says that the port has no ``use_pallas``."""
    knobs, meta = plan.resolve_for(workload, environ=env)
    route = _ROUTE_OF[(bool(knobs["use_hotset"]), bool(knobs["use_fused"]))]
    return route, {k: meta[k] for k in ("source", "hash", "overridden")}


def card_of(dev: torch.device) -> str | None:
    """The card's name and power limit from nvidia-smi (None on the CPU);
    raises when nvidia-smi cannot say."""
    if dev.type != "cuda":
        return None
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", "-i", str(idx), "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


_WRAPPERS = row_kernels.WRAPPERS + scan_kernels.WRAPPERS


def _reset_launches():
    for fn in _WRAPPERS:
        fn.launches = 0


def _launches() -> dict:
    return {fn.__name__: fn.launches for fn in _WRAPPERS}


def _observed(run, k: Knobs, trace_cfg, monitor_ix: int, ring_ix: int):
    """``run`` wrapped with the per-block drains the knobs ask for: the
    counter plane's wave events (DINT_MONITOR_JSONL) and the dinttrace
    ring (DINT_TRACE), both deferred so the host reads block i-1's bytes
    after dispatching block i. Returns (run, monitor or None, txn monitor
    or None)."""
    meta = {"name": "bench_tatp", "width": k.width, "block": k.block,
            "n_subscribers": k.n_subscribers}
    monitor = None
    if k.monitor and k.monitor_jsonl:
        monitor = Monitor(TraceWriter(k.monitor_jsonl, meta=meta))
    tmon = (txe.TxnMonitor(trace_cfg, path=k.trace_jsonl, meta=meta)
            if k.trace else None)
    if monitor is None and tmon is None:
        return run, None, None
    t_prev = [time.time()]

    def observed(carry, gen):
        carry, stats = run(carry, gen)
        if monitor is not None:
            now = time.time()
            monitor.observe(carry[monitor_ix], batch=k.width * k.block,
                            dur_s=now - t_prev[0], defer=True)
            t_prev[0] = now
        if tmon is not None:
            tmon.observe(carry[ring_ix], defer=True)
        return carry, stats

    return observed, monitor, tmon


def _tatp_leg(k: Knobs, route: str, dev) -> dict:
    """The TATP window: populate on the device, two warm blocks, the timed
    window, the profiled block when asked, the drain. Returns the leg's
    totals and timings."""
    use_hotset, use_fused = ROUTES[route]
    _reset_launches()
    t0 = time.time()
    db = td.populate_device(torch.Generator(device=dev).manual_seed(0),
                            k.n_subscribers, val_words=VAL_WORDS, device=dev)
    run, init, drain = td.build_pipelined_runner(
        k.n_subscribers, w=k.width, val_words=VAL_WORDS,
        cohorts_per_block=k.block, use_hotset=use_hotset,
        use_fused=use_fused, monitor=k.monitor, trace=k.trace,
        trace_rate=k.trace_rate, device=dev)
    carry = init(db)
    populate_s = time.time() - t0

    # two blocks before the window, as bench.py's two compile blocks: the
    # first call builds the kernels (nvcc) if they are not built yet
    t0 = time.time()
    warm = np.zeros(td.N_STATS, np.int64)
    for seed in (99, 98):
        carry, s = run(carry, torch.Generator(device=dev).manual_seed(seed))
        warm += st.fetch_stats(s).sum(axis=0)
    compile_s = time.time() - t0
    run, monitor, tmon = _observed(run, k, init.trace_cfg, -1, 3)

    # host core-seconds strictly over the timed window
    cpu = st.CpuMonitor()
    carry, total, warm_w, dt, blocks, block_s = st.run_window(
        run, carry, torch.Generator(device=dev).manual_seed(0), k.window_s,
        td.N_STATS, warmup_blocks=0)
    cores = cpu.cores()
    breakdown = None
    if k.trace_dir:
        # one block after the window under the profiler
        with profiler_session(k.trace_dir) as prof:
            carry, s = run(carry,
                           torch.Generator(device=dev).manual_seed(1234))
            st.fetch_stats(s)
        breakdown = attrib.report(
            prof["trace"], steps=k.block, jsonl=k.monitor_jsonl,
            geometry={"w": k.width, "k": td.K, "vw": VAL_WORDS})
    if monitor is not None:
        monitor.flush()         # the deferred last block
        monitor.writer.close()
    dinttrace = None
    if tmon is not None:
        tmon.flush()
        tmon.close()
        dinttrace = tmon.summary()
    outs = drain(carry)
    # in-flight cohorts at the window's end emit their stats in the drain
    total = total + st.fetch_stats(outs[1]).sum(axis=0)
    counters = mon.snapshot(outs[-1]) if k.monitor else None
    bad = int(total[td.STAT_MAGIC_BAD] + warm_w[td.STAT_MAGIC_BAD]
              + warm[td.STAT_MAGIC_BAD])
    if bad != 0:
        raise RuntimeError(f"magic-byte integrity violated: {bad} "
                           "bad VAL replies (table corruption)")
    return dict(total=total, dt=dt, blocks=blocks, block_s=block_s,
                cores=cores, counters=counters, dinttrace=dinttrace,
                breakdown=breakdown, populate_s=populate_s,
                compile_s=compile_s, launches=_launches())


SERVE_KEYS = ("offered", "admitted", "shed", "blocks", "achieved_rate",
              "slo_us", "slo_met", "queue", "service", "controller", "plan")


def serve_probe(k: Knobs, dev) -> dict:
    """The serving plane's saturation probe (bench.py:335-360): a burst of
    ``width * block * 8`` arrivals at t = 0 through a `ServeEngine` of the
    one bench width, after its warmup; bench.py's eleven keys of the
    snapshot. The closed-loop headline and the probe should agree at full
    occupancy; the gap is the serving plane's ingestion cost."""
    eng = ServeEngine("tatp_dense", k.n_subscribers,
                      cfg=ControllerCfg(widths=(k.width,)),
                      cohorts_per_block=k.block, val_words=VAL_WORDS,
                      monitor=True, device=dev)
    eng.warmup()
    eng.run(np.zeros(k.width * k.block * 8))
    eng.close()
    rep = eng.snapshot()
    return {key: rep[key] for key in SERVE_KEYS}


def measure(env=None, device=None) -> dict:
    """Both legs; returns the bench line. ``env`` (default os.environ)
    holds the knobs; ``device`` None means CUDA."""
    env = os.environ if env is None else env
    dev = resolve_device(device)
    k = Knobs.from_env(env)
    route, plan_meta = plan_route("tatp_uniform", env)
    card = card_of(dev)
    leg = _tatp_leg(k, route, dev)
    total, dt = leg["total"], leg["dt"]
    serve_out = serve_probe(k, dev) if k.serve else None

    committed = int(total[td.STAT_COMMITTED])
    attempted = int(total[td.STAT_ATTEMPTED])
    tps = committed / dt
    p = st.cohort_latency_percentiles(leg["block_s"], k.block, depth=DEPTH)
    out = {
        "schema": attrib.ARTIFACT_SCHEMA,
        "metric": "tatp_committed_txns_per_sec",
        "value": round(tps, 1),
        "unit": "txn/s",
        "vs_baseline": round(tps / ASSUMED_BASELINE, 4),
        "mode": "device_fused_pipelined",
        "throughput": round(attempted / dt, 1),
        "abort_rate": round(1 - committed / max(attempted, 1), 5),
        # lock and validate aborts only: ab_missing is TATP semantics
        # (txns on absent rows fail by design, ~25% of the mix)
        "contention_abort_rate": round(
            float(total[td.STAT_AB_LOCK] + total[td.STAT_AB_VALIDATE])
            / max(attempted, 1), 5),
        "ab_lock": int(total[td.STAT_AB_LOCK]),
        "ab_missing": int(total[td.STAT_AB_MISSING]),
        "ab_validate": int(total[td.STAT_AB_VALIDATE]),
        "avg_us": round(p["avg"], 1),
        "p50_us": round(p["p50"], 1),
        "p99_us": round(p["p99"], 1),
        "p999_us": round(p["p999"], 1),
        "lat_samples": int(p["n"]),
        "lat_hist": p["hist"],
        "n_subscribers": k.n_subscribers,
        "width": k.width,
        # one device, no mesh
        "n_shards": None,
        "mesh": None,
        "route": route,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "card": card,
        "hot_frac": k.hot_frac,
        "hot_prob": k.hot_prob,
        "plan": plan_meta,
        "counters": leg["counters"],
        "dinttrace": leg["dinttrace"],
        "serve": serve_out,
        "dintlint": None,
        "breakdown": leg["breakdown"],
        "blocks": leg["blocks"],
        "window_s": round(dt, 2),
        **leg["cores"],
        "dintcost": None,
        "dintdur": None,
    }
    profile = None
    if k.profile:
        bs = np.asarray(st.steady_blocks(leg["block_s"]))
        profile = {"populate_s": round(leg["populate_s"], 2),
                   "compile_s": round(leg["compile_s"], 2),
                   "launches": {"tatp": leg["launches"]}}
        if len(bs):
            profile.update(
                block_ms_min=round(float(bs.min()) * 1e3, 2),
                block_ms_mean=round(float(bs.mean()) * 1e3, 2),
                block_ms_max=round(float(bs.max()) * 1e3, 2),
                step_ms=round(float(bs.min()) / k.block * 1e3, 3),
                txn_ns=round(float(bs.min()) / (k.block * k.width) * 1e9,
                             1))
        out["profile"] = profile
    print(f"attempted={attempted} blocks={leg['blocks']} "
          f"window_s={dt:.2f}", file=sys.stderr)

    if k.skip_sb:
        out["smallbank_skipped"] = "DINT_BENCH_SKIP_SB=1"
        return out
    sb_route, sb_meta = plan_route("smallbank_skewed", env)
    _reset_launches()
    out.update(bench_smallbank.run(
        window_s=k.window_s, n_accounts=k.sb_accounts, widths=k.sb_widths,
        block=k.block, hot_frac=k.hot_frac, hot_prob=k.hot_prob,
        route=sb_route, device=dev))
    out["smallbank_plan"] = sb_meta
    if profile is not None:
        profile["launches"]["smallbank"] = _launches()
    return out


ARTIFACT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "artifacts")


def _git_head() -> str:
    """The checkout's short commit, "unknown" outside a git work tree."""
    try:
        c = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                           capture_output=True, text=True, timeout=10,
                           cwd=os.path.dirname(os.path.abspath(__file__)))
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return c.stdout.strip() if c.returncode == 0 and c.stdout.strip() \
        else "unknown"


def _persist_artifact(out: dict, artifact_dir: str = ARTIFACT_DIR) -> str:
    """Stamp the measurement with ``commit`` and ``ts`` and write it to
    ``<artifact_dir>/BENCH_<commit>_<ts>.json`` (bench.py's artifact), so
    every number on the card is a timestamped file; returns the path. A
    failed write raises."""
    out["commit"] = _git_head()
    out["ts"] = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    os.makedirs(artifact_dir, exist_ok=True)
    path = os.path.join(artifact_dir,
                        f"BENCH_{out['commit']}_{out['ts']}.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    # stderr: stdout's one line is the result
    print(f"artifact written: {path}", file=sys.stderr)
    return path


def main() -> int:
    out = measure()
    _persist_artifact(out)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
