"""dinttrace CLI: per-transaction flight-recorder queries (the port of
tools/dinttrace.py).

dintmon counts; dintscope times; dinttrace narrates. The device half
(`monitor.txnevents`) lands sampled fixed-width txn events in the event
ring a runner's carry holds, drained to JSONL by `TxnMonitor`; the
assembler (`monitor.txntrace`) joins them BY TXN ID across windows. This
tool is the query surface, and reads the JAX package's streams too.

Usage:
    python -m dint_tpu_torch.dinttrace summarize RUN.jsonl
    python -m dint_tpu_torch.dinttrace show RUN.jsonl 4711
    python -m dint_tpu_torch.dinttrace slowest RUN.jsonl [-n 10]
    python -m dint_tpu_torch.dinttrace aborts RUN.jsonl [--by-cause]
    python -m dint_tpu_torch.dinttrace export RUN.jsonl -o spans.json \
        [--merge merged.json]       # Perfetto view, own pid row
    python -m dint_tpu_torch.dinttrace synth -o OUT.jsonl

Every subcommand takes --json for scripting. `export` writes Chrome
trace-event JSON on pid 2000 so it lands beside a ``dintmon export-trace
--merge`` timeline (pid 1000 + device ops) in one Perfetto view.
`summarize` flags windows whose ring overflowed (dropped > 0) — widen
trace_cap or lower the sampling rate when it does.

Exit codes: 0 ok; 1 = txn not found; 2 usage/file errors.
"""
from __future__ import annotations

import argparse
import json
import sys

from .monitor import txntrace as tt


def _groups(path: str):
    meta, records = tt.read_trace(path)
    return meta, records, tt.by_txn(tt.decode_records(meta, records))


def cmd_summarize(args) -> int:
    meta, records = tt.read_trace(args.file)
    s = tt.summarize(meta, records)
    if args.json:
        print(json.dumps(s), flush=True)
        return 0
    print(f"{args.file} (dinttrace schema {s['schema']}, "
          f"rate {s['rate']}, cap {s['cap']})")
    print(f"windows {s['windows']}, devices {s['devices']}, "
          f"events {s['events']:,}, txns {s['txns']:,}")
    for k, v in s["by_kind"].items():
        print(f"  {k:10s} {v:>12,}")
    if s["outcomes"]:
        print("outcomes: " + ", ".join(f"{k}={v:,}"
                                       for k, v in s["outcomes"].items()))
    if s["dropped"]:
        print(f"OVERFLOW: {s['dropped']:,} event(s) dropped in "
              f"window(s) {s['dropped_windows']} — widen trace_cap or "
              "lower DINT_TRACE_RATE")
    return 0


def cmd_show(args) -> int:
    _meta, _records, groups = _groups(args.file)
    txn = int(args.txn, 0)
    if txn not in groups:
        print(f"dinttrace: txn {txn} has no events in {args.file} "
              f"({len(groups)} txns present)", file=sys.stderr)
        return 1
    tree = tt.span_tree(txn, groups[txn])
    if args.json:
        print(json.dumps(tree), flush=True)
    else:
        print(tt.format_tree(tree))
    return 0


def cmd_slowest(args) -> int:
    _meta, _records, groups = _groups(args.file)
    rows = tt.slowest(groups, n=args.n)
    if args.json:
        print(json.dumps({"slowest": rows}), flush=True)
        return 0
    print(f"{'txn':>12s} {'span':>6s} {'steps':>13s} {'events':>7s} "
          "outcome")
    for r in rows:
        print(f"{r['txn']:>12d} {r['span']:>6d} "
              f"{r['first_step']:>6d}..{r['last_step']:<6d} "
              f"{r['events']:>7d} {r['outcome'] or '-'}")
    return 0


def cmd_aborts(args) -> int:
    _meta, _records, groups = _groups(args.file)
    out = tt.aborts(groups, by_cause=args.by_cause)
    if args.json:
        print(json.dumps(out), flush=True)
        return 0
    print(f"aborted txns: {out['aborted']}")
    if args.by_cause:
        for cause, c in sorted(out["by_cause"].items()):
            ex = ", ".join(str(t) for t in c["examples"])
            print(f"  {cause:12s} {c['count']:>8,}  e.g. {ex}")
    else:
        for r in out["txns"]:
            print(f"  txn {r['txn']}  {r['cause']}  step {r['step']}")
    return 0


def cmd_export(args) -> int:
    meta, records = tt.read_trace(args.file)
    n = tt.export_trace_events(meta, records, args.out,
                               merge=args.merge,
                               offset_us=args.offset_us)
    out = {"metric": "dinttrace_export", "events": n, "out": args.out,
           "merged": args.merge}
    if args.json:
        print(json.dumps(out), flush=True)
    else:
        merged = f" (merged with {args.merge})" if args.merge else ""
        print(f"wrote {n} trace events -> {args.out}{merged} "
              "(open in chrome://tracing or ui.perfetto.dev)")
    return 0


def cmd_synth(args) -> int:
    n = tt.synthesize_events(args.out)
    out = {"metric": "dinttrace_synth", "records": n, "out": args.out}
    if args.json:
        print(json.dumps(out), flush=True)
    else:
        print(f"wrote {n} synthetic dinttrace records -> {args.out}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="dinttrace", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("summarize",
                       help="event totals by kind + the overflow report")
    p.add_argument("file")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_summarize)

    p = sub.add_parser("show", help="one txn's joined span tree")
    p.add_argument("file")
    p.add_argument("txn", help="txn id (decimal or 0x…)")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_show)

    p = sub.add_parser("slowest", help="txns ranked by step span")
    p.add_argument("file")
    p.add_argument("-n", type=int, default=10)
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_slowest)

    p = sub.add_parser("aborts", help="aborted txns (+ cause taxonomy)")
    p.add_argument("file")
    p.add_argument("--by-cause", action="store_true")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_aborts)

    p = sub.add_parser("export",
                       help="JSONL stream -> Chrome trace-event JSON "
                            "(pid 2000, mergeable with dintmon's export)")
    p.add_argument("file")
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--merge", default=None, metavar="TRACE",
                   help="an existing Chrome trace (e.g. `dintmon "
                        "export-trace --merge` output) to copy into the "
                        "same file: txn spans + counter waves + device "
                        "ops in ONE Perfetto timeline")
    p.add_argument("--offset-us", type=float, default=None,
                   help="explicit span->merged-trace clock offset")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("synth",
                       help="write the synthetic fixture stream")
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_synth)

    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except OSError as e:
        print(f"dinttrace: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
