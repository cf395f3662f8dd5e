"""dintmon CLI: summarize / diff / export the counter plane's artifacts
(the port of tools/dintmon.py).

The counter plane (`monitor.counters`) drains to two artifact kinds: JSONL
wave-event streams (`monitor.TraceWriter`) and bench artifacts whose
"counters" field holds the end-of-run snapshot (explicit null when
monitoring was off). This tool reads both, from either package.

Usage:
    python -m dint_tpu_torch.dintmon summarize RUN.jsonl   # totals + rates
    python -m dint_tpu_torch.dintmon summarize BENCH.json
    python -m dint_tpu_torch.dintmon summarize RUN.jsonl --json
    python -m dint_tpu_torch.dintmon diff A.jsonl B.jsonl  # counter deltas
    python -m dint_tpu_torch.dintmon export-trace RUN.jsonl -o trace.json
    python -m dint_tpu_torch.dintmon export-trace RUN.jsonl \
        -o merged.json --merge trace_dir/   # counters + device ops
    python -m dint_tpu_torch.dintmon check BENCH.json      # the identities
    python -m dint_tpu_torch.dintmon describe              # the registry

`export-trace` writes the Chrome trace-event format — load it in
chrome://tracing or https://ui.perfetto.dev to see the wave timeline with
counter tracks. `check` holds one artifact's counters to the ledger
identities (`IDENTITIES`): exit 1 on a violation, or when monitoring was
off. Exit code 0 on success, 2 on usage/file errors.
"""
from __future__ import annotations

import argparse
import json
import sys

from .monitor import counters as ctr
from .monitor import trace as tr


def _load_summary(path: str) -> dict:
    """Summarize either artifact kind into the same shape:
    {"source", "counters": {...}|None, "dur_s", ...}."""
    with open(path) as f:
        head = f.read(1 << 20)
    try:
        obj = json.loads(head)
        is_single_json = isinstance(obj, dict)
    except ValueError:
        is_single_json = False
    if is_single_json and "traceEvents" not in obj:
        # a bench artifact (or any object with a counters field)
        c = obj.get("counters")
        return {"source": "artifact", "path": path,
                "counters": ({n: int(c.get(n, 0)) for n in ctr.ALL_NAMES}
                             if isinstance(c, dict) else None),
                "dur_s": float(obj.get("window_s") or 0.0),
                "waves": None, "monitored_waves": None,
                "batch": int(obj.get("throughput", 0)
                             * float(obj.get("window_s") or 0.0))}
    meta, waves = tr.read_events(path)
    out = tr.summarize_events(meta, waves)
    out["source"] = "jsonl"
    out["path"] = path
    return out


def _fmt_counters(counters: dict | None, dur_s: float) -> str:
    if counters is None:
        return "  (monitoring was off: counters = null)"
    lines = []
    for name in ctr.ALL_NAMES:
        v = counters.get(name, 0)
        if not v:
            continue
        kind = ctr.COUNTER_KINDS.get(name, ctr.FLOW)
        rate = (f"  ({v / dur_s:,.1f}/s)"
                if kind == ctr.FLOW and dur_s > 0 else "")
        tag = " [gauge]" if kind == ctr.GAUGE else ""
        lines.append(f"  {name:20s} {v:>14,}{rate}{tag}")
    return "\n".join(lines) if lines else "  (all counters zero)"


def cmd_summarize(args) -> int:
    s = _load_summary(args.file)
    if args.json:
        print(json.dumps(s), flush=True)
        return 0
    print(f"{s['path']} ({s['source']})")
    if s.get("waves") is not None:
        print(f"waves: {s['waves']} ({s['monitored_waves']} monitored), "
              f"dur {s['dur_s']:.3f}s, batch {s['batch']:,}")
    c = s.get("counters")
    print(_fmt_counters(c, float(s.get("dur_s") or 0.0)))
    if c:
        att, com = c.get("txn_attempted", 0), c.get("txn_committed", 0)
        if att:
            print(f"abort_rate: {1 - com / att:.5f}")
        req = c.get("lock_requests", 0)
        if req:
            print(f"lock_grant_rate: {c.get('lock_granted', 0) / req:.5f}")
    return 0


def cmd_diff(args) -> int:
    a, b = _load_summary(args.a), _load_summary(args.b)
    ca, cb = a.get("counters"), b.get("counters")
    rows = []
    for name in ctr.ALL_NAMES:
        va = (ca or {}).get(name, 0)
        vb = (cb or {}).get(name, 0)
        if va or vb:
            ratio = (vb / va) if va else None
            rows.append({"counter": name, "a": va, "b": vb,
                         "delta": vb - va, "ratio": ratio})
    out = {"a": a["path"], "b": b["path"],
           "a_monitored": ca is not None, "b_monitored": cb is not None,
           "rows": rows}
    if args.json:
        print(json.dumps(out), flush=True)
        return 0
    print(f"A = {a['path']}\nB = {b['path']}")
    if ca is None or cb is None:
        print("note: one side has counters = null (monitoring off)")
    print(f"{'counter':20s} {'A':>14s} {'B':>14s} {'delta':>12s} {'B/A':>8s}")
    for r in rows:
        ratio = f"{r['ratio']:.3f}" if r["ratio"] is not None else "-"
        print(f"{r['counter']:20s} {r['a']:>14,} {r['b']:>14,} "
              f"{r['delta']:>+12,} {ratio:>8s}")
    return 0


def cmd_export_trace(args) -> int:
    n = tr.export_chrome_trace(args.file, args.out,
                               merge_trace=args.merge,
                               offset_us=args.offset_us)
    out = {"metric": "dintmon_export", "events": n, "out": args.out,
           "merged": args.merge}
    if args.json:
        print(json.dumps(out), flush=True)
    else:
        merged = f" (merged with {args.merge})" if args.merge else ""
        print(f"wrote {n} trace events -> {args.out}{merged} "
              "(open in chrome://tracing or ui.perfetto.dev)")
    return 0


# ledger identities every engine's counter plane must satisfy exactly:
# (name, lhs terms, rhs terms, gate terms or None). A gated identity is
# skipped when every gate counter is zero (the route split on
# single-device paths). The port counts one of the dispatch pair a step:
# dispatch_pallas on the kernel routes, dispatch_xla on the generic
# pipelines.
IDENTITIES = (
    ("lock_requests == lock_granted + lock_rejected",
     ("lock_requests",), ("lock_granted", "lock_rejected"), None),
    ("lock_rejected == lock_reject_held + lock_reject_arb",
     ("lock_rejected",), ("lock_reject_held", "lock_reject_arb"), None),
    ("steps == dispatch_xla + dispatch_pallas",
     ("steps",), ("dispatch_xla", "dispatch_pallas"), None),
    ("route_ici_lanes + route_dcn_lanes == lock_requests + install_writes",
     ("route_ici_lanes", "route_dcn_lanes"),
     ("lock_requests", "install_writes"),
     ("route_ici_lanes", "route_dcn_lanes")),
)


def check_identities(counters: dict) -> tuple[bool, list[dict]]:
    """(ok, rows) of the ledger identities over one counter snapshot
    ({name: value}); a row's status is "ok", "violated" or "skipped"."""
    rows, ok = [], True
    for name, lhs, rhs, gate in IDENTITIES:
        if gate is not None and not any(counters.get(g, 0) for g in gate):
            rows.append({"identity": name, "status": "skipped",
                         "lhs": 0, "rhs": 0})
            continue
        lv = sum(int(counters.get(k, 0)) for k in lhs)
        rv = sum(int(counters.get(k, 0)) for k in rhs)
        good = lv == rv
        ok = ok and good
        rows.append({"identity": name,
                     "status": "ok" if good else "violated",
                     "lhs": lv, "rhs": rv})
    return ok, rows


def cmd_check(args) -> int:
    s = _load_summary(args.file)
    c = s.get("counters")
    if c is None:
        out = {"path": s["path"], "ok": False,
               "error": "counters = null (monitoring was off)"}
        if args.json:
            print(json.dumps(out), flush=True)
        else:
            print(f"{s['path']}: counters = null (monitoring was off) "
                  "-> nothing to check", file=sys.stderr)
        return 1
    ok, rows = check_identities(c)
    out = {"path": s["path"], "ok": ok, "identities": rows}
    if args.json:
        print(json.dumps(out), flush=True)
    else:
        print(f"{s['path']} ({s['source']})")
        for r in rows:
            mark = {"ok": "ok ", "violated": "FAIL",
                    "skipped": "--  "}[r["status"]]
            detail = ("" if r["status"] == "skipped"
                      else f"  ({r['lhs']:,} vs {r['rhs']:,})")
            print(f"  {mark} {r['identity']}{detail}")
        print("dintmon check: " + ("ok" if ok else "FAIL — violated: "
              + "; ".join(r["identity"] for r in rows
                          if r["status"] == "violated")))
    return 0 if ok else 1


def cmd_describe(args) -> int:
    if args.json:
        print(json.dumps({
            "schema": tr.SCHEMA,
            "counters": [{"name": n, "index": ctr.COUNTER_INDEX[n],
                          "kind": ctr.COUNTER_KINDS[n],
                          "doc": ctr.COUNTER_DOCS[n]}
                         for n in ctr.ALL_NAMES],
            "parity": list(ctr.PARITY_NAMES)}), flush=True)
        return 0
    print(f"dintmon counter registry (schema {tr.SCHEMA}, "
          f"{ctr.N_COUNTERS} counters):")
    for n in ctr.ALL_NAMES:
        kind = ctr.COUNTER_KINDS[n]
        par = "*" if n in ctr.PARITY_NAMES else " "
        print(f"  {ctr.COUNTER_INDEX[n]:3d} {par} {n:20s} [{kind:5s}] "
              f"{ctr.COUNTER_DOCS[n]}")
    print("(* = engine-independent parity counter)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="dintmon", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("summarize", help="totals + rates for one artifact")
    p.add_argument("file")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_summarize)

    p = sub.add_parser("diff", help="counter diff between two artifacts")
    p.add_argument("a")
    p.add_argument("b")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_diff)

    p = sub.add_parser("export-trace",
                       help="JSONL stream -> Chrome trace-event JSON")
    p.add_argument("file")
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--merge", default=None, metavar="PROFILER_TRACE",
                   help="torch.profiler Chrome trace (file or trace dir) to "
                        "merge onto the same timeline: the counter wave "
                        "slices and the device ops land in one Perfetto "
                        "view, aligned on a shared clock offset (first "
                        "wave pinned to the trace's earliest device op)")
    p.add_argument("--offset-us", type=float, default=None,
                   help="explicit dintmon->profiler clock offset override")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_export_trace)

    p = sub.add_parser("check",
                       help="the counter ledger identities of one "
                            "artifact; exit 1 on a violation")
    p.add_argument("file")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_check)

    p = sub.add_parser("describe", help="print the counter registry")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_describe)

    args = ap.parse_args(argv)
    # OSError only: a malformed JSONL row surfaces as a traceback
    try:
        return args.fn(args)
    except OSError as e:
        print(f"dintmon: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
