"""dintlint CLI: the port's static-analysis gate over every registered
hot path.

Runs the dint_tpu_torch/analysis pass suite (scatter races, aliasing of
in-place writes, host syncs, u32 word arithmetic, and the protocol
dataflow checks) over the registered engine step functions, traced with
``make_fx`` on small CPU tensors. Each target is traced ONCE per process
and the graph is shared by every pass (analysis/core.TraceCache).

Usage:
    python -m dint_tpu_torch.dintlint --all              # everything
    python -m dint_tpu_torch.dintlint --target tatp_dense/block
    python -m dint_tpu_torch.dintlint --all --pass protocol
    python -m dint_tpu_torch.dintlint --all --json       # one JSON line
    python -m dint_tpu_torch.dintlint --all --sarif out.sarif
    python -m dint_tpu_torch.dintlint --all --time       # wall-time report
    python -m dint_tpu_torch.dintlint --all --allowlist PATH
    python -m dint_tpu_torch.dintlint --prune-allowlist  # drop stale entries
    python -m dint_tpu_torch.dintlint --prune-allowlist --check
    python -m dint_tpu_torch.dintlint --list             # targets + passes

Exit code: 0 when no unsuppressed error-severity finding remains (warnings
and info never fail the gate), 1 otherwise, 2 on usage errors — an unknown
--target/--pass prints the registered names and exits 2. The default
allowlist is dint_tpu_torch/analysis/dintlint_allow.json; every
suppression needs a written reason and stays visible in the report.
``--prune-allowlist`` runs the FULL matrix and rewrites the file dropping
entries that no longer match any finding; with ``--check`` it rewrites
nothing and exits 1 when stale entries exist. ``--json`` lists each
target's host syncs under ``host_syncs`` (purity's findings: what stands
between the step and CUDA-graph capture).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from . import analysis
from .analysis import allowlist as al
from .analysis import cli
from .analysis.passes.purity import HOST_SYNC_CODES

# bumped when keys of the --json payload change shape
JSON_SCHEMA = 2


def _print_timing(timings: dict):
    per_target = timings.get("targets", {})
    pass_totals: dict[str, float] = {}
    print(f"{'target':34s} {'trace_s':>8s} {'passes_s':>9s}")
    for name, t in per_target.items():
        passes_s = sum(t["passes"].values())
        for p, s in t["passes"].items():
            pass_totals[p] = pass_totals.get(p, 0.0) + s
        cached = " (cached)" if t["cached"] else ""
        print(f"{name:34s} {t['trace_s']:8.2f} {passes_s:9.3f}{cached}")
    print("per-pass totals:")
    for p, s in sorted(pass_totals.items()):
        print(f"  {p:32s} {s:8.3f}s")
    print(f"matrix total: {timings.get('total_s', 0.0):.2f}s "
          f"(trace {sum(t['trace_s'] for t in per_target.values()):.2f}s"
          f" + passes {sum(pass_totals.values()):.2f}s)", flush=True)


def host_syncs(findings) -> dict:
    """{target: [{code, site, count, primitive}]} of the purity findings
    that block graph capture (host syncs and per-step host scalars)."""
    out: dict = {}
    for f in findings:
        if f.pass_name == "purity" and (f.code in HOST_SYNC_CODES
                                        or f.code == "host-scalar"):
            out.setdefault(f.target, []).append(
                {"code": f.code, "site": f.site, "count": f.count,
                 "primitive": f.primitive})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="dintlint", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--all", action="store_true",
                    help="lint every registered target")
    ap.add_argument("--target", action="append", default=[],
                    help="target name (repeatable); see --list")
    ap.add_argument("--pass", dest="passes", action="append", default=[],
                    help="pass name (repeatable); default: all passes")
    ap.add_argument("--json", action="store_true",
                    help="emit one machine-parseable JSON line")
    ap.add_argument("--sarif", metavar="PATH", default=None,
                    help="also write the findings as SARIF 2.1.0 to PATH "
                         "('-' for stdout); allowlisted findings become "
                         "suppressions")
    ap.add_argument("--time", action="store_true",
                    help="report per-target/per-pass wall time (and embed "
                         "it under 'timing' with --json)")
    ap.add_argument("--allowlist", default=None,
                    help="allowlist JSON path (default: "
                         "dint_tpu_torch/analysis/dintlint_allow.json)")
    ap.add_argument("--prune-allowlist", action="store_true",
                    help="run the FULL matrix, then rewrite the allowlist "
                         "dropping entries that matched no finding")
    ap.add_argument("--check", action="store_true",
                    help="with --prune-allowlist: dry-run — rewrite "
                         "nothing, exit 1 if stale entries exist")
    ap.add_argument("--list", action="store_true",
                    help="list registered targets and passes, then exit")
    args = ap.parse_args(argv)

    if args.list:
        print("targets:")
        for name, doc in analysis.TARGET_DOCS.items():
            proto = ",".join(analysis.TARGET_PROTOCOL.get(name, ()))
            print(f"  {name:32s} [{proto}] {doc}")
        print("passes:")
        for name, doc in analysis.PASS_DOCS.items():
            print(f"  {name:32s} {doc}")
        return 0

    if args.prune_allowlist and (args.target or args.passes):
        ap.error("--prune-allowlist needs the full matrix: stale-entry "
                 "detection over a subset run would drop entries whose "
                 "findings simply were not traced (drop --target/--pass)")
    if args.check and not args.prune_allowlist:
        ap.error("--check only modifies --prune-allowlist (dry-run)")
    if not args.all and not args.target and not args.prune_allowlist:
        ap.error("pick targets with --target/--all (or --list to see them)")

    err = (cli.check_names("target", args.target, analysis.TARGETS)
           or cli.check_names("pass", args.passes, analysis.PASSES))
    if err:
        ap.error(err)

    allowlist = cli.resolve_allowlist(args.allowlist)

    timings: dict = {}
    stale = False
    if args.prune_allowlist:
        if not allowlist or not os.path.exists(allowlist):
            ap.error("--prune-allowlist: no allowlist file found "
                     f"(looked for {allowlist or analysis.DEFAULT_ALLOWLIST})")
        entries = al.load(allowlist)
        findings = analysis.run(allowlist_entries=entries, timings=timings)
        kept, dropped = al.prune_entries(entries)
        if dropped:
            if args.check:
                stale = True
                print(f"{allowlist}: {len(dropped)} stale entr"
                      f"{'y' if len(dropped) == 1 else 'ies'} "
                      f"({len(kept)} kept) — file NOT rewritten "
                      "(--check); run --prune-allowlist to fix:")
            else:
                al.save(allowlist, kept)
                print(f"pruned {len(dropped)} stale entr"
                      f"{'y' if len(dropped) == 1 else 'ies'} from "
                      f"{allowlist} ({len(kept)} kept):")
            for e in dropped:
                print(f"  - {e['pass']}/{e['code']} "
                      f"(target={e.get('target', '*')})")
        else:
            print(f"{allowlist}: all {len(kept)} entries still match — "
                  "nothing to prune")
        if not args.check:
            findings = [f for f in findings
                        if not (f.pass_name == "allowlist"
                                and f.code == "unused-entry")]
    else:
        try:
            findings = analysis.run(
                targets=None if args.all else args.target,
                passes=args.passes or None,
                allowlist_path=allowlist,
                timings=timings)
        except KeyError as e:       # defense in depth; names pre-checked
            ap.error(str(e))

    failed = analysis.has_errors(findings) or stale
    if args.sarif:
        cli.write_sarif(findings, ap.prog, args.sarif)
    if args.json:
        payload = {
            "metric": "dintlint",
            "schema": JSON_SCHEMA,
            "targets": (sorted(analysis.TARGETS)
                        if args.all or args.prune_allowlist
                        else args.target),
            "passes": args.passes or sorted(analysis.PASSES),
            "allowlist": allowlist,
            "n_findings": len(findings),
            "n_errors": cli.count_errors(findings),
            "n_suppressed": cli.count_suppressed(findings),
            "stale_allowlist": stale,
            "ok": not failed,
            "host_syncs": host_syncs(findings),
            "findings": [f.to_dict() for f in findings],
        }
        if args.time:
            payload["timing"] = timings
        print(json.dumps(payload), flush=True)
    else:
        for f in findings:
            print(f)
        if args.time:
            _print_timing(timings)
        print(f"dintlint: {len(findings)} finding(s), "
              f"{cli.count_errors(findings)} error(s), "
              f"{cli.count_suppressed(findings)} suppressed -> "
              f"{'FAIL' if failed else 'ok'}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
