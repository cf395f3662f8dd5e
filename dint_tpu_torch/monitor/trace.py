"""Host-side trace layer: schema-stable JSONL wave events, exports, and
the profiler session (the port of `dint_tpu.monitor.trace`).

At every window boundary the host reads the counter buffer
(monitor/counters.py), computes wrap-safe deltas, and appends one JSONL
*wave event*. The stream is the JAX module's, schema for schema:

    {"type": "meta", "schema": 1, "counters": [<every registered name>],
     "kinds": {...}, ...caller metadata}
    {"type": "wave", "step": i, "t": <s since start>, "dur_s": ..,
     "batch": <txns dispatched this wave>, "counters": {name: delta} | null}

`counters` is an object with EVERY registered name when monitoring is on
and explicitly `null` when off. Gauges carry the current high-water
value, flows the window delta (counters.delta).

`export_chrome_trace` converts a stream to the Chrome trace-event format
(chrome://tracing, Perfetto): one "X" slice per wave plus "C" counter
tracks for the headline rates. `profiler_session` brackets a few blocks
with a torch.profiler trace of the host and the card.

What differs from JAX:

* `Monitor.observe(defer=True)` copies the counter buffer on the device
  and sends it to pinned host memory without blocking (`DeferredCopy`);
  the next observe or flush waits on the copy's CUDA event. A failed
  copy raises.
* `profiler_session` raises when the profiler or the trace's export
  fails: no failure is swallowed into the yielded record.
"""
from __future__ import annotations

import contextlib
import json
import os
import time

import torch

from . import counters as ctr

SCHEMA = 1


class DeferredCopy:
    """Tensors on their way to the host without blocking it: each is
    cloned where it lies (so the caller may overwrite the original), and,
    on the card, copied with ``non_blocking`` into pinned host memory
    behind a CUDA event that `get` waits on. On the CPU the clone is the
    copy."""

    def __init__(self, *tensors: torch.Tensor):
        copies = [t.clone() for t in tensors]
        self.event = None
        if copies and copies[0].is_cuda:
            host = [torch.empty(c.shape, dtype=c.dtype, pin_memory=True)
                    for c in copies]
            for h, c in zip(host, copies):
                h.copy_(c, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
            copies = host
        self.tensors = copies

    def get(self) -> list[torch.Tensor]:
        if self.event is not None:
            self.event.synchronize()
        return self.tensors


class TraceWriter:
    """Append-only JSONL wave-event stream (one file per run)."""

    def __init__(self, path: str, meta: dict | None = None):
        self.path = path
        self._f = open(path, "w")
        rec = {"type": "meta", "schema": SCHEMA,
               "counters": list(ctr.ALL_NAMES),
               "kinds": dict(ctr.COUNTER_KINDS)}
        rec.update(meta or {})
        self._write(rec)

    def _write(self, rec: dict):
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def wave(self, *, step: int, t: float, dur_s: float, batch: int,
             counters: dict[str, int] | None):
        if counters is not None:
            # schema-stable: every registered name, every event
            counters = {n: int(counters.get(n, 0)) for n in ctr.ALL_NAMES}
        self._write({"type": "wave", "step": int(step),
                     "t": round(float(t), 6), "dur_s": round(float(dur_s), 6),
                     "batch": int(batch), "counters": counters})

    def close(self):
        if not self._f.closed:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Monitor:
    """Drives the drain loop: snapshot the device counters at each window
    boundary, delta against the previous snapshot, accumulate int64
    totals, optionally emit a wave event.

    ``defer=True`` double-buffers the read: the buffer goes to the host
    through a `DeferredCopy` and is only processed on the next
    observe/flush call, so block i-1's counters are read after block i
    has been dispatched. Deltas are bit-identical to the synchronous
    path; only WHEN the bytes cross to the host changes."""

    def __init__(self, writer: TraceWriter | None = None):
        self.writer = writer
        self.prev: dict[str, int] | None = None
        self.totals: dict[str, int] = ctr.zeros_dict()
        self._t0 = time.monotonic()
        self._step = 0
        self._pending = None    # (DeferredCopy, batch, dur_s, t)

    def observe(self, counters, *, batch: int = 0, dur_s: float = 0.0,
                defer: bool = False) -> dict[str, int] | None:
        """counters: a `Counters` or its raw buffer (the last element of a
        monitored runner's carry). Returns the completed window's delta
        dict — this window's in synchronous mode, the PREVIOUS window's
        under ``defer`` (None when nothing was pending yet; call
        :meth:`flush` after the loop to land the final window)."""
        out = self.flush()
        t = time.monotonic() - self._t0
        if defer:
            buf = counters.buf if isinstance(counters, ctr.Counters) \
                else counters
            self._pending = (DeferredCopy(buf), batch, dur_s, t)
            return out
        return self._process(counters, batch, dur_s, t)

    def flush(self) -> dict[str, int] | None:
        """Materialize a deferred window, if any (call once after the
        dispatch loop, before draining the runner)."""
        if self._pending is None:
            return None
        (copy, batch, dur_s, t), self._pending = self._pending, None
        return self._process(copy.get()[0], batch, dur_s, t)

    def _process(self, counters, batch, dur_s, t) -> dict[str, int]:
        snap = ctr.snapshot(counters)
        d = ctr.delta(snap, self.prev)
        self.prev = snap
        for name in ctr.ALL_NAMES:
            if ctr.COUNTER_KINDS[name] == ctr.GAUGE:
                self.totals[name] = max(self.totals[name], d[name])
            else:
                self.totals[name] += d[name]
        if self.writer is not None:
            self.writer.wave(step=self._step, t=t, dur_s=dur_s,
                             batch=batch, counters=d)
        self._step += 1
        return d


def read_events(path: str) -> tuple[dict, list[dict]]:
    """Load a JSONL stream -> (meta record, wave events). Tolerates a
    missing meta line (synthesizes one from the current registry)."""
    meta = None
    waves = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if rec.get("type") == "meta" and meta is None:
                meta = rec
            elif rec.get("type") == "wave":
                waves.append(rec)
    if meta is None:
        meta = {"type": "meta", "schema": SCHEMA,
                "counters": list(ctr.ALL_NAMES),
                "kinds": dict(ctr.COUNTER_KINDS)}
    return meta, waves


def summarize_events(meta: dict, waves: list[dict]) -> dict:
    """Aggregate a wave stream: int64 totals per counter (gauges take the
    max), wall/dur sums, and headline rates."""
    kinds = meta.get("kinds", dict(ctr.COUNTER_KINDS))
    totals: dict[str, int] = {}
    monitored = 0
    dur = 0.0
    batch = 0
    for w in waves:
        dur += float(w.get("dur_s") or 0.0)
        batch += int(w.get("batch") or 0)
        c = w.get("counters")
        if c is None:
            continue
        monitored += 1
        for name, v in c.items():
            if kinds.get(name) == ctr.GAUGE:
                totals[name] = max(totals.get(name, 0), int(v))
            else:
                totals[name] = totals.get(name, 0) + int(v)
    out = {"waves": len(waves), "monitored_waves": monitored,
           "dur_s": round(dur, 6), "batch": batch,
           "counters": {n: totals.get(n, 0)
                        for n in meta.get("counters", ctr.ALL_NAMES)}
           if monitored else None}
    if monitored and dur > 0:
        t = out["counters"]
        out["rates_per_s"] = {
            "txn_attempted": round(t.get("txn_attempted", 0) / dur, 1),
            "txn_committed": round(t.get("txn_committed", 0) / dur, 1),
        }
        att = t.get("txn_attempted", 0)
        if att:
            out["abort_rate"] = round(
                1.0 - t.get("txn_committed", 0) / att, 6)
    return out


# ------------------------------------------------------------ chrome trace


def export_chrome_trace(events_path: str, out_path: str,
                        counter_tracks: tuple[str, ...] = (
                            "txn_committed", "ab_lock", "ab_validate",
                            "ring_hwm"),
                        merge_trace: str | None = None,
                        offset_us: float | None = None) -> int:
    """Convert a wave-event stream to the Chrome trace-event JSON format:
    one complete ("X") slice per wave on a single row + "C" counter
    tracks for the headline counters. Returns the number of trace events
    written. Load in chrome://tracing or https://ui.perfetto.dev.

    ``merge_trace``: a torch.profiler Chrome trace (file or trace dir) to
    merge into the same timeline, so the dintmon wave slices and the
    device ops land in ONE Perfetto view. The two clocks are aligned on a
    shared offset: by default the FIRST wave event is pinned to the
    profiler trace's earliest timestamp (both streams start when the
    instrumented region starts); pass ``offset_us`` to override with an
    explicit dintmon->profiler clock offset. The wave stream keeps its
    own pid row so slices never interleave with device ops."""
    meta, waves = read_events(events_path)
    merged = []
    shift_us = 0.0
    if merge_trace is not None:
        from . import attrib

        merged, _src = attrib.load_trace_events(merge_trace)
        ts0 = min((float(e["ts"]) for e in merged
                   if e.get("ph") == "X" and "ts" in e), default=0.0)
        if offset_us is not None:
            shift_us = float(offset_us)
        elif waves:
            shift_us = ts0 - float(waves[0]["t"]) * 1e6
    pid = 1000 if merge_trace is not None else 0
    events = [{"name": "process_name", "ph": "M", "pid": pid,
               "args": {"name": meta.get("name", "dintmon")}}]
    for w in waves:
        ts = float(w["t"]) * 1e6 + shift_us
        dur = max(float(w.get("dur_s") or 0.0) * 1e6, 1.0)
        args = {"batch": w.get("batch", 0)}
        c = w.get("counters")
        if c:
            args.update({k: c[k] for k in counter_tracks if k in c})
        events.append({"name": f"wave {w['step']}", "ph": "X", "pid": pid,
                       "tid": 0, "ts": round(ts, 3), "dur": round(dur, 3),
                       "args": args})
        if c:
            for track in counter_tracks:
                if track in c:
                    events.append({"name": track, "ph": "C", "pid": pid,
                                   "ts": round(ts, 3),
                                   "args": {track: int(c[track])}})
    events.extend(merged)
    with open(out_path, "w") as f:
        json.dump({"traceEvents": events,
                   "displayTimeUnit": "ms"}, f)
    return len(events)



@contextlib.contextmanager
def profiler_session(trace_dir: str | None):
    """Bracket a region with a torch.profiler trace of the host and (when
    a card is present) the card, written on exit as one timestamped
    ``*.pt.trace.json`` under ``trace_dir`` (which `attrib.find_trace_file`
    finds). A no-op when ``trace_dir`` is empty. The yielded record gets
    the file's path under "trace" on exit. A profiler or export failure
    raises."""
    info = {"trace_dir": trace_dir, "trace": None}
    if not trace_dir:
        yield info
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield info
    stamp = time.strftime("%Y%m%d_%H%M%S")
    path = os.path.join(trace_dir, f"dint_{stamp}_{os.getpid()}_"
                        f"{time.monotonic_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    info["trace"] = path
