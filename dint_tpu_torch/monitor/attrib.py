"""dintscope attribution: torch.profiler traces -> per-wave time
breakdowns (the port of `dint_tpu.monitor.attrib`).

It parses a Chrome trace that torch.profiler wrote (`trace.profiler_session`
under the bench's DINT_BENCH_TRACE_DIR, or ``python -m
dint_tpu_torch.profile_step --trace``) plus, optionally, the dintmon JSONL
wave stream, and charges the card's time to the wave names of
`monitor/waves.py`. The breakdown artifact, `diff_breakdowns` (the
regression gate behind ``python -m dint_tpu_torch.dintscope diff``), the
alias fold and the thresholds are the JAX module's.

**How a torch profile carries a wave.** In a JAX trace the XLA ops carry
the ``named_scope`` name stack, so JAX charges every slice whose name or
args hold a wave name. A torch trace names a wave on two kinds of slice
only: the host ``user_annotation`` that `waves.scope`'s
``record_function`` records, and its projection onto the card's stream,
``gpu_user_annotation``. Kernel slices carry no wave name, and JAX's rule
would count the annotations themselves as device time, twice. So
`attribute` charges each device slice (cat ``kernel``, ``gpu_memcpy``,
``gpu_memset``) to the registered wave of the innermost ``dint.*``
``user_annotation`` that encloses its launch on the host thread that
launched it; the launch is the ``cuda_runtime`` / ``cuda_driver`` slice
whose ``correlation`` arg equals the device slice's. Annotation slices are
never device time.

What differs from JAX's breakdown:

* ``total_ms`` is the device time of the trace (kernels, memcpys,
  memsets), not the sum of every complete slice.
* Each wave's record gains ``host_ms``, the summed duration of its
  ``user_annotation`` ranges: on the card a step is many launches, not
  one dispatch, so the host time a wave spends enqueueing is part of its
  cost. This is the only schema addition.
* ``steps``, when neither the caller nor the JSONL stream gives it, is
  the most common number of ranges the waves recorded (a wave runs once a
  step): a wave launches many kernels a step, so JAX's count of slices
  would overstate it.
* A trace that holds no device slice raises: it says nothing about the
  step, and must never read as a step that took no device time.

`synthesize_trace` writes a deterministic torch-profiler-shaped trace
(annotations, launches and kernels joined by correlation ids) covering
every registered wave; the tests generate it.
"""
from __future__ import annotations

import bisect
import collections
import glob
import gzip
import json
import os

from . import waves

# the bench artifact's schema version (the JAX bench's). Version 1 is the
# implicit pre-dintscope era (no "schema" key); 2 adds "schema",
# "breakdown" (object | explicit null) and the "lat_hist" histogram block
# next to the percentile block.
ARTIFACT_SCHEMA = 2
# the breakdown object's own schema version
BREAKDOWN_SCHEMA = 1

# default regression thresholds for diff_breakdowns (percent; a wave/step
# must regress past these to fail the gate) and the floor below which a
# wave is dispatch noise, not signal
DEFAULT_WAVE_PCT = 25.0
DEFAULT_STEP_PCT = 10.0
DEFAULT_RATE_PCT = 10.0
DEFAULT_MIN_MS = 0.05

# Round-12 fused megakernels: each swallows a PAIR of unfused waves, so a
# fused-vs-unfused A/B sees the constituents vanish on one side. Without
# folding, the diff reports them under "missing" and the fused successor
# as an infinite regression — both meaningless. This map sends each
# swallowed constituent to its fused successor; diff_breakdowns folds the
# constituents' time into the successor on BOTH sides whenever either
# side observed the fused wave, so the gate compares like against like
# (the unfused side's lock + meta_gather total vs the fused side's one
# lock_validate dispatch). ``python -m dint_tpu_torch.dintscope diff
# --no-alias`` disables
# the fold for debugging raw per-scope time. Waves that only SHRINK under
# fusion (smallbank's lock scope keeps its XLA scatter-mins; the sharded
# install_route keeps its all_to_all) still alias: their remaining time
# plus the megakernel is exactly what the unfused scope used to cover.
WAVE_ALIASES: dict[str, str] = {
    waves.full_name(e, src): waves.full_name(e, dst)
    for e, src, dst in (
        ("tatp_dense", "lock", "lock_validate"),
        ("tatp_dense", "meta_gather", "lock_validate"),
        ("tatp_dense", "install", "install_log"),
        ("tatp_dense", "log_append", "install_log"),
        ("smallbank_dense", "lock", "lock_validate"),
        ("smallbank_dense", "read", "lock_validate"),
        ("smallbank_dense", "install", "install_log"),
        ("smallbank_dense", "log_append", "install_log"),
        ("dense_sharded_sb", "arbitrate", "lock_validate"),
        ("dense_sharded_sb", "install_route", "install_log"),
        # overlap=True moves the mesh route's exchange one step early
        # under its own scope — an overlap-on vs overlap-off A/B sees
        # `route` vanish on one side; fold it into route_prefetch so the
        # gate compares the route's total time and names a no-longer-
        # hidden DCN wave as a route_prefetch regression
        ("multihost_sb", "route", "route_prefetch"),
    )
}
for _src, _dst in WAVE_ALIASES.items():
    assert _src in waves.WAVE_DOCS and _dst in waves.WAVE_DOCS, (
        f"WAVE_ALIASES references unregistered wave: {_src} -> {_dst}")
del _src, _dst


# ---------------------------------------------------------------- loading


def _read_json(path: str):
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as f:
        return json.load(f)


def find_trace_file(path: str) -> str:
    """Resolve a trace argument to one Chrome-trace JSON file: a file is
    taken as-is; a directory (a `trace.profiler_session` or
    ``profile_step --trace`` target) is searched recursively for the
    NEWEST ``*.trace.json.gz`` / ``*.trace.json`` (each session writes a
    fresh timestamped file, so newest = the session just recorded)."""
    if os.path.isfile(path):
        return path
    if os.path.isdir(path):
        hits = []
        for pat in ("**/*.trace.json.gz", "**/*.trace.json",
                    "**/*.json.gz"):
            hits.extend(glob.glob(os.path.join(path, pat), recursive=True))
        if not hits:
            raise FileNotFoundError(
                f"no profiler trace (*.trace.json[.gz]) under {path!r}")
        return max(hits, key=lambda p: (os.path.getmtime(p), p))
    raise FileNotFoundError(path)


def load_trace_events(path: str) -> tuple[list[dict], str]:
    """Load trace events from a Chrome-trace JSON file / .gz / profiler
    trace dir. Returns (events, resolved file path)."""
    f = find_trace_file(path)
    obj = _read_json(f)
    if isinstance(obj, dict):
        events = obj.get("traceEvents", [])
    elif isinstance(obj, list):
        events = obj
    else:
        raise ValueError(f"{f!r} is not a Chrome trace")
    return [e for e in events if isinstance(e, dict)], f


# ------------------------------------------------------------ attribution

# device slices: what the card ran
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# host slices that launch device work, joined to it by "correlation"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# the host range a `waves.scope` records
ANNOTATION_CAT = "user_annotation"


def _dur_ms(e: dict) -> float:
    try:
        return float(e.get("dur", 0.0)) / 1e3
    except (TypeError, ValueError):
        return 0.0


def _thread(e: dict):
    return e.get("pid"), e.get("tid")


def _complete(events, cat):
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in cat]


def charge(events: list[dict]) -> list[tuple[dict, str | None, bool]]:
    """For each device slice of a torch.profiler trace: (slice, the
    registered wave it is charged to or None, whether its correlation
    reached a launch slice). The wave is that of the innermost registered
    ``dint.*`` annotation on the launching thread whose range holds the
    launch's start."""
    launches = {}
    for e in _complete(events, LAUNCH_CATS):
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None:
            launches[corr] = e
    # per host thread: the registered annotations, sorted by start
    ranges: dict = {}
    for e in _complete(events, (ANNOTATION_CAT,)):
        if e.get("name") in waves.WAVE_DOCS:
            t0 = float(e["ts"])
            ranges.setdefault(_thread(e), []).append(
                (t0, t0 + float(e.get("dur", 0.0)), e["name"]))
    starts = {}
    for key, rs in ranges.items():
        rs.sort()
        starts[key] = [r[0] for r in rs]

    def wave_at(thread, t):
        rs = ranges.get(thread)
        if not rs:
            return None
        # the latest-starting range that holds t is the innermost
        i = bisect.bisect_right(starts[thread], t)
        for t0, t1, name in reversed(rs[:i]):
            if t <= t1:
                return name
        return None

    out = []
    for e in _complete(events, DEVICE_CATS):
        launch = launches.get((e.get("args") or {}).get("correlation"))
        if launch is None:
            out.append((e, None, False))
        else:
            out.append((e, wave_at(_thread(launch), float(launch["ts"])),
                        True))
    return out


def host_ranges(events: list[dict]) -> dict[str, tuple[float, int]]:
    """Each registered wave's host ranges in a torch.profiler trace: {wave:
    (summed ``user_annotation`` ms, number of ranges)} for the waves that
    recorded any."""
    out: dict[str, tuple[float, int]] = {}
    for e in _complete(events, (ANNOTATION_CAT,)):
        name = e.get("name")
        if name in waves.WAVE_DOCS:
            ms, n = out.get(name, (0.0, 0))
            out[name] = (ms + _dur_ms(e), n + 1)
    return out


def _jsonl_summary(jsonl_path: str | None) -> dict | None:
    if not jsonl_path:
        return None
    from . import trace as tr

    meta, wave_events = tr.read_events(jsonl_path)
    return tr.summarize_events(meta, wave_events)


def attribute(events: list[dict], *, steps: int | None = None,
              jsonl: str | None = None,
              geometry: dict | None = None,
              trace_path: str | None = None) -> dict:
    """Attribute the device time of a torch.profiler trace to registered
    wave names (`charge`), and each wave's host range time to it.

    ``steps``: pipeline steps the trace covers. Resolution order:
    explicit arg > the dintmon JSONL stream's `steps` counter total > the
    most common number of ranges the waves recorded.

    ``geometry``: formula variables (w=, k=, l=, vw=, d=) for the
    registry's bytes formulas; effective bandwidth is only reported for
    waves whose formula fully evaluates.

    Raises ValueError on a trace with no device slice."""
    charged = charge(events)
    if not charged:
        raise ValueError(
            f"the trace {trace_path or ''} holds no device event (kernel, "
            "memcpy or memset): it says nothing about the card's time")
    per_wave_ms: dict[str, float] = {n: 0.0 for n in waves.ALL_WAVES}
    per_wave_slices: dict[str, int] = {n: 0 for n in waves.ALL_WAVES}
    host = host_ranges(events)
    total_ms = 0.0
    for e, name, _linked in charged:
        dur_ms = _dur_ms(e)
        total_ms += dur_ms
        if name is not None:
            per_wave_ms[name] += dur_ms
            per_wave_slices[name] += 1

    summary = _jsonl_summary(jsonl)
    if steps is None and summary is not None and summary.get("counters"):
        steps = int(summary["counters"].get("steps", 0)) or None
    if steps is None:
        # the most common range count of the waves seen (the larger on a
        # tie): a wave that also runs once a block (the runner's draw
        # in `gen`) must not count as an extra step
        seen = collections.Counter(n for _, n in host.values())
        steps = max(seen, key=lambda v: (seen[v], v)) if seen else None

    attributed_ms = sum(per_wave_ms.values())
    geometry = geometry or {}
    out_waves = {}
    for name in waves.ALL_WAVES:
        ms = per_wave_ms[name]
        rec = {
            "ms": round(ms, 6),
            "slices": per_wave_slices[name],
            "ms_per_step": round(ms / steps, 6) if steps else None,
            "pct": round(100.0 * ms / attributed_ms, 3)
            if attributed_ms > 0 else 0.0,
            "bytes_per_step": None,
            "gbps": None,
            "host_ms": round(host.get(name, (0.0, 0))[0], 6),
        }
        b = waves.wave_bytes(name, **geometry)
        if b is not None and steps and ms > 0:
            rec["bytes_per_step"] = int(b)
            rec["gbps"] = round(b / (ms / steps * 1e-3) / 1e9, 3)
        out_waves[name] = rec

    out = {
        "schema": BREAKDOWN_SCHEMA,
        "kind": "dintscope_breakdown",
        "trace": trace_path,
        "steps": steps,
        "geometry": {k: v for k, v in geometry.items() if v is not None},
        "total_ms": round(total_ms, 6),
        "attributed_ms": round(attributed_ms, 6),
        "unattributed_ms": round(total_ms - attributed_ms, 6),
        "step_ms": round(attributed_ms / steps, 6) if steps else None,
        "waves": out_waves,
        "missing": [n for n in waves.ALL_WAVES
                    if per_wave_slices[n] == 0],
    }
    if summary is not None:
        out["rates"] = {
            "dur_s": summary.get("dur_s"),
            "txn_attempted_per_s":
                (summary.get("rates_per_s") or {}).get("txn_attempted"),
            "txn_committed_per_s":
                (summary.get("rates_per_s") or {}).get("txn_committed"),
            "abort_rate": summary.get("abort_rate"),
        }
    return out


def report(path: str, *, steps: int | None = None,
           jsonl: str | None = None, geometry: dict | None = None) -> dict:
    """Load a trace (file or profiler dir) and attribute it."""
    events, resolved = load_trace_events(path)
    return attribute(events, steps=steps, jsonl=jsonl, geometry=geometry,
                     trace_path=resolved)


def load_breakdown(path: str) -> dict:
    """Load a diff operand: a breakdown artifact (from ``report -o``) is
    used directly; anything else (raw trace file / profiler dir) is
    attributed on the fly."""
    try:
        obj = _read_json(path) if os.path.isfile(path) else None
    except ValueError:
        obj = None
    if isinstance(obj, dict) and obj.get("kind") == "dintscope_breakdown":
        return obj
    if isinstance(obj, dict) and isinstance(
            obj.get("breakdown"), dict):     # a bench artifact
        return obj["breakdown"]
    return report(path)


# ------------------------------------------------------------------- diff


def _wave_observed(w: dict, name: str) -> bool:
    r = w.get(name) or {}
    return (r.get("slices") or 0) > 0 or (r.get("ms") or 0) > 0


def _fold_aliases(wa: dict, wb: dict) -> tuple[dict, dict, dict]:
    """Fold WAVE_ALIASES constituents into their fused successor on both
    sides of a diff — but ONLY for successors whose observation pattern
    is asymmetric between the sides (one side dispatched the megakernel,
    the other ran the unfused pair). A symmetric diff (unfused vs
    unfused, fused vs fused, or the all-waves synthetic fixture) never
    folds: its per-wave rows are already like-for-like and folding would
    only blur which wave moved. Returns (wa', wb', folded) where folded
    maps each triggered fused wave to the sorted constituents merged
    into it."""
    targets: dict[str, list[str]] = {}
    for src, dst in WAVE_ALIASES.items():
        oa, ob = _wave_observed(wa, dst), _wave_observed(wb, dst)
        asym = oa != ob or (_wave_observed(wa, src)
                            != _wave_observed(wb, src))
        if (oa or ob) and asym:
            targets.setdefault(dst, []).append(src)
    if not targets:
        return wa, wb, {}
    for dst in targets:
        targets[dst].sort()

    def fold(w: dict) -> dict:
        out = {k: dict(v) for k, v in w.items() if isinstance(v, dict)}
        for dst, srcs in targets.items():
            d = out.setdefault(dst, {"ms": 0.0, "slices": 0,
                                     "ms_per_step": None, "pct": 0.0,
                                     "bytes_per_step": None, "gbps": None})
            for src in srcs:
                r = out.pop(src, None)
                if not r:
                    continue
                d["ms"] = round((d.get("ms") or 0.0)
                                + (r.get("ms") or 0.0), 6)
                d["slices"] = (d.get("slices") or 0) + (r.get("slices")
                                                        or 0)
                d["pct"] = round((d.get("pct") or 0.0)
                                 + (r.get("pct") or 0.0), 3)
                ms, mr = d.get("ms_per_step"), r.get("ms_per_step")
                if mr is not None:
                    d["ms_per_step"] = round((ms or 0.0) + mr, 6)
        return out

    return fold(wa), fold(wb), targets


def diff_breakdowns(a: dict, b: dict, *, wave_pct: float = DEFAULT_WAVE_PCT,
                    step_pct: float = DEFAULT_STEP_PCT,
                    rate_pct: float = DEFAULT_RATE_PCT,
                    min_ms: float = DEFAULT_MIN_MS,
                    alias: bool = True) -> dict:
    """Compare breakdown B (candidate) against A (baseline). A regression
    is: a wave's ms_per_step growing past ``wave_pct`` % (ignoring waves
    under ``min_ms`` on both sides — dispatch noise), the attributed step
    time growing past ``step_pct`` %, committed throughput falling past
    ``rate_pct`` % (when both artifacts carry rates). With ``alias``
    (default), WAVE_ALIASES folds the round-12 megakernels' swallowed
    constituents into the fused wave on both sides before comparing, so a
    fused-vs-unfused A/B attributes removed waves to their fused
    successor instead of reporting them missing. Returns a dict with
    ``regressions`` (list of {kind, wave?, a, b, pct} — empty = gate
    passes); ``python -m dint_tpu_torch.dintscope diff`` exits 1 when it
    is non-empty."""
    regressions = []
    rows = []
    wa, wb = a.get("waves", {}), b.get("waves", {})
    folded: dict[str, list[str]] = {}
    if alias:
        wa, wb, folded = _fold_aliases(wa, wb)
    merged_away = {s for srcs in folded.values() for s in srcs}
    for name in waves.ALL_WAVES:
        if name in merged_away:
            continue
        ra, rb = wa.get(name) or {}, wb.get(name) or {}
        ma, mb = ra.get("ms_per_step"), rb.get("ms_per_step")
        row = {"wave": name, "a_ms_per_step": ma, "b_ms_per_step": mb}
        if name in folded:
            row["includes"] = folded[name]
        if ma is not None and mb is not None and max(ma, mb) >= min_ms:
            pct = 100.0 * (mb - ma) / ma if ma > 0 else float("inf")
            row["pct"] = round(pct, 2) if ma > 0 else None
            if (mb > ma * (1 + wave_pct / 100.0)
                    and mb - ma >= min_ms):
                regressions.append({
                    "kind": "wave", "wave": name, "a": ma, "b": mb,
                    "pct": row["pct"]})
        rows.append(row)

    sa, sb = a.get("step_ms"), b.get("step_ms")
    if sa and sb and sb > sa * (1 + step_pct / 100.0):
        regressions.append({
            "kind": "step", "a": sa, "b": sb,
            "pct": round(100.0 * (sb - sa) / sa, 2)})

    ta = ((a.get("rates") or {}).get("txn_committed_per_s"))
    tb = ((b.get("rates") or {}).get("txn_committed_per_s"))
    if ta and tb and tb < ta * (1 - rate_pct / 100.0):
        regressions.append({
            "kind": "throughput", "a": ta, "b": tb,
            "pct": round(100.0 * (tb - ta) / ta, 2)})

    return {
        "schema": BREAKDOWN_SCHEMA,
        "kind": "dintscope_diff",
        "a": a.get("trace"), "b": b.get("trace"),
        "thresholds": {"wave_pct": wave_pct, "step_pct": step_pct,
                       "rate_pct": rate_pct, "min_ms": min_ms},
        "aliased": folded,
        "rows": rows,
        "regressions": regressions,
        "ok": not regressions,
    }

# ---------------------------------------------------------------- fixture


def synthesize_trace(out_path: str, *, steps: int = 4,
                     engines: tuple[str, ...] | None = None,
                     scale: dict[str, float] | None = None) -> int:
    """Write a deterministic torch-profiler-shaped Chrome trace covering
    every registered wave of ``engines`` (default: all). Each step, each
    wave is one host ``user_annotation`` range on the launching thread
    holding one ``cudaLaunchKernel`` slice, whose kernel runs on the card's
    stream under a ``gpu_user_annotation`` of the same name, joined to the
    launch by its ``correlation`` id. The kernel's duration derives from
    the wave's position in its engine's registry (stable across runs),
    times ``scale.get(wave_name, 1.0)``; the range lasts the kernel plus
    20 us. Each step also launches one kernel outside any range (an
    unattributed filler) and one memcpy inside its first wave. Returns the
    number of events written."""
    engines = engines or waves.ENGINES
    scale = scale or {}
    host, card = (100, 100), (0, 7)
    events = [{"name": "process_name", "ph": "M", "pid": host[0],
               "args": {"name": "python (synthetic)"}},
              {"name": "process_name", "ph": "M", "pid": card[0],
               "args": {"name": "CUDA GPU 0 (synthetic)"}}]
    corr = 0

    def x(cat, name, where, ts, dur, **args):
        events.append({"ph": "X", "cat": cat, "name": name,
                       "pid": where[0], "tid": where[1],
                       "ts": round(ts, 3), "dur": round(dur, 3),
                       "args": args})

    def launch(ts, kernel_ts, dur, name, cat="kernel",
               api="cudaLaunchKernel"):
        nonlocal corr
        corr += 1
        x("cuda_runtime", api, host, ts, 5.0, correlation=corr)
        x(cat, name, card, kernel_ts, dur, correlation=corr, stream=7,
          device=0)

    ts = 0.0
    for step in range(steps):
        for eng in engines:
            for i, name in enumerate(waves.WAVES_BY_ENGINE[eng]):
                dur_us = (100.0 + 50.0 * i) * float(scale.get(name, 1.0))
                x("user_annotation", name, host, ts, dur_us + 20.0)
                x("cpu_op", "aten::index_select", host, ts + 1.0, 8.0)
                launch(ts + 2.0, ts + 10.0, dur_us, f"gather_kernel_{i}")
                x("gpu_user_annotation", name, card, ts + 10.0, dur_us)
                if i == 0:
                    launch(ts + 9.0, ts + 10.0 + dur_us, 3.0,
                           "Memcpy DtoH (Device -> Pinned)",
                           cat="gpu_memcpy", api="cudaMemcpyAsync")
                ts += dur_us + 25.0
        # unscoped filler: launched outside any range
        launch(ts, ts + 5.0, 25.0, f"filler_kernel_{step}")
        ts += 35.0
    with open(out_path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f,
                  indent=1)
    return len(events)
