"""dintscope CLI: per-wave time attribution and the perf-regression gate
(the port of tools/dintscope.py).

The engines open `monitor.waves.scope` around every wave; this tool turns
a torch.profiler trace into a per-wave breakdown of the card's time
(`monitor.attrib`), and `diff` turns two of them into a gate.

Usage:
    python -m dint_tpu_torch.dintscope report TRACE [--jsonl RUN.jsonl]
        [--geom w=8192 k=4 vw=10] [--steps N] [--json] [-o OUT.json]
    python -m dint_tpu_torch.dintscope diff A B [--wave-pct 25]
        [--step-pct 10] [--rate-pct 10] [--min-ms 0.05] [--no-alias]
        [--json]
    python -m dint_tpu_torch.dintscope describe [--json]
    python -m dint_tpu_torch.dintscope synth -o OUT.json [--steps 4]

TRACE is a Chrome-trace JSON file (.json / .json.gz) that torch.profiler
wrote, or a directory holding some (the bench's DINT_BENCH_TRACE_DIR, or
``python -m dint_tpu_torch.profile_step --trace FILE``; the newest
*.trace.json inside is used). A/B for `diff` are breakdown artifacts
(`report -o`), bench artifacts carrying a "breakdown" object, or raw
traces (attributed on the fly).

Exit codes: 0 ok; 1 = `diff` found a regression (the gate — regressed
waves are named); 2 usage/file errors, a trace with no device event
included.
"""
from __future__ import annotations

import argparse
import json
import sys

from .monitor import attrib, waves


def _parse_geom(pairs: list[str]) -> dict:
    geom = {}
    for p in pairs or []:
        if "=" not in p:
            raise SystemExit(f"--geom takes k=v pairs, got {p!r}")
        k, v = p.split("=", 1)
        geom[k.strip()] = float(v) if "." in v else int(v)
    return geom


def cmd_report(args) -> int:
    bd = attrib.report(args.trace, steps=args.steps, jsonl=args.jsonl,
                       geometry=_parse_geom(args.geom))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(bd, f, indent=1)
    if args.json:
        print(json.dumps(bd), flush=True)
        return 0
    print(f"{bd['trace']}  (steps={bd['steps']}, "
          f"attributed {bd['attributed_ms']:.3f} ms of "
          f"{bd['total_ms']:.3f} ms)")
    if bd["step_ms"] is not None:
        print(f"step: {bd['step_ms']:.3f} ms attributed")
    hdr = (f"{'wave':42s} {'ms/step':>10s} {'%':>7s} "
           f"{'slices':>7s} {'GB/s':>8s} {'host ms':>9s}")
    print(hdr)
    for name, r in bd["waves"].items():
        if r["slices"] == 0 and not r["host_ms"]:
            continue
        msps = f"{r['ms_per_step']:.4f}" if r["ms_per_step"] is not None \
            else "-"
        gbps = f"{r['gbps']:.1f}" if r["gbps"] is not None else "-"
        print(f"{name:42s} {msps:>10s} {r['pct']:>6.1f}% "
              f"{r['slices']:>7d} {gbps:>8s} {r['host_ms']:>9.3f}")
    if bd["missing"]:
        print(f"missing ({len(bd['missing'])} waves with no slices): "
              + ", ".join(bd["missing"]))
    rates = bd.get("rates")
    if rates and rates.get("txn_committed_per_s") is not None:
        print(f"committed/s: {rates['txn_committed_per_s']:,.1f} "
              f"(abort_rate {rates.get('abort_rate')})")
    return 0


def cmd_diff(args) -> int:
    a = attrib.load_breakdown(args.a)
    b = attrib.load_breakdown(args.b)
    d = attrib.diff_breakdowns(a, b, wave_pct=args.wave_pct,
                               step_pct=args.step_pct,
                               rate_pct=args.rate_pct, min_ms=args.min_ms,
                               alias=not args.no_alias)
    if args.json:
        print(json.dumps(d), flush=True)
    else:
        print(f"A = {args.a}\nB = {args.b}")
        for dst, srcs in (d.get("aliased") or {}).items():
            print(f"aliased: {' + '.join(srcs)} -> {dst} "
                  "(fused megakernel; --no-alias for raw scopes)")
        for r in d["rows"]:
            if r.get("a_ms_per_step") is None \
                    and r.get("b_ms_per_step") is None:
                continue
            ma = r.get("a_ms_per_step")
            mb = r.get("b_ms_per_step")
            pct = r.get("pct")
            print(f"{r['wave']:42s} "
                  f"{(f'{ma:.4f}' if ma is not None else '-'):>10s} "
                  f"{(f'{mb:.4f}' if mb is not None else '-'):>10s} "
                  f"{(f'{pct:+.1f}%' if pct is not None else '-'):>9s}")
        if d["ok"]:
            print("ok: no regression past thresholds "
                  f"{d['thresholds']}")
        for reg in d["regressions"]:
            which = reg.get("wave", reg["kind"])
            print(f"REGRESSION [{reg['kind']}] {which}: "
                  f"{reg['a']} -> {reg['b']} ({reg['pct']:+.1f}%)")
    return 0 if d["ok"] else 1


def cmd_describe(args) -> int:
    if args.json:
        print(json.dumps({
            "schema": attrib.BREAKDOWN_SCHEMA,
            "waves": [{"name": n, "doc": waves.WAVE_DOCS[n],
                       "bytes_per_step": waves.WAVE_BYTES[n]}
                      for n in waves.ALL_WAVES],
            "engines": list(waves.ENGINES)}), flush=True)
        return 0
    print(f"dintscope wave registry ({waves.N_WAVES} waves, "
          f"breakdown schema {attrib.BREAKDOWN_SCHEMA}):")
    for n in waves.ALL_WAVES:
        b = waves.WAVE_BYTES[n]
        tag = f"  bytes/step = {b}" if b else "  (compute-only)"
        print(f"  {n:42s}{tag}\n      {waves.WAVE_DOCS[n]}")
    return 0


def cmd_synth(args) -> int:
    n = attrib.synthesize_trace(args.out, steps=args.steps)
    print(f"wrote {n} synthetic trace events covering all "
          f"{waves.N_WAVES} registered waves -> {args.out}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="dintscope", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("report", help="trace -> per-wave breakdown")
    p.add_argument("trace")
    p.add_argument("--jsonl", default=None,
                   help="dintmon JSONL stream (steps + throughput)")
    p.add_argument("--geom", nargs="*", default=[],
                   help="formula vars, e.g. w=8192 k=4 vw=10")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--json", action="store_true")
    p.add_argument("-o", "--out", default=None,
                   help="write the breakdown artifact here")
    p.set_defaults(fn=cmd_report)

    p = sub.add_parser("diff",
                       help="regression gate: candidate B vs baseline A")
    p.add_argument("a")
    p.add_argument("b")
    p.add_argument("--wave-pct", type=float, default=attrib.DEFAULT_WAVE_PCT)
    p.add_argument("--step-pct", type=float, default=attrib.DEFAULT_STEP_PCT)
    p.add_argument("--rate-pct", type=float, default=attrib.DEFAULT_RATE_PCT)
    p.add_argument("--min-ms", type=float, default=attrib.DEFAULT_MIN_MS)
    p.add_argument("--no-alias", action="store_true",
                   help="compare raw per-scope time instead of folding "
                        "the fused megakernels' swallowed waves into "
                        "their successor (attrib.WAVE_ALIASES)")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_diff)

    p = sub.add_parser("describe", help="print the wave registry")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_describe)

    p = sub.add_parser("synth",
                       help="write a synthetic torch-profiler-shaped trace")
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--steps", type=int, default=4)
    p.set_defaults(fn=cmd_synth)

    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except (OSError, ValueError) as e:
        print(f"dintscope: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
