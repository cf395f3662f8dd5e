"""dintdur CLI: the port's static durability and recoverability gate (the
counterpart of tools/dintdur.py).

Runs ONLY the `durability` pass (analysis/passes/durability.py) over the
registered targets — log-before-visible (wal-order), bounded rings
(unbounded-ring / no-ring-truncation), replay coverage of everything the
engines install (replay-coverage), and TIMEOUT totality in the wire
coordinator (in-doubt-totality), and the replica quorum of the mesh's
replication hops (quorum-fanout, read off the ``dint_mesh::ppermute``
nodes' perms) — proven from the fx traces before any fault is injected.
Traced on small CPU tensors; the trace cache is shared with dintlint and
dintcost (analysis/core.TraceCache).

Usage:
    python -m dint_tpu_torch.dintdur check --all                 # the gate
    python -m dint_tpu_torch.dintdur check --target tatp_dense/block
    python -m dint_tpu_torch.dintdur check --prune-allowlist [--check]
    python -m dint_tpu_torch.dintdur report --all               # no gate
    python -m dint_tpu_torch.dintdur report --all --json
    python -m dint_tpu_torch.dintdur report --all --sarif out.sarif
    python -m dint_tpu_torch.dintdur describe                   # checks

Exit code: 0 when no unsuppressed error-severity finding remains, 1
otherwise, 2 on usage errors (an unknown --target prints the registered
names, never a traceback). `report` always exits 0 or 2. The default
allowlist is the port's analysis/dintlint_allow.json, shared with
dintlint; its durability entries are the documented no-ring-truncation
ones (no engine threads a checkpoint watermark yet).
"""
from __future__ import annotations

import argparse
import json
import sys

from . import analysis
from .analysis import cli
from .analysis.passes import durability as _dur

# bumped when keys of the --json payload change shape (the reference's
# schema 2: the check payload carries stale_allowlist)
JSON_SCHEMA = 2

_CHECKS = {
    "wal-order":
        "every certified commit-visible install has a log append under "
        "the same grant mask (write-ahead, never install-without-log)",
    "quorum-fanout":
        "the replication perms give every source >= 2 distinct non-self "
        "destinations, and on a 2-D mesh every hop rides the dcn axis",
    "unbounded-ring":
        "the appends a trace makes (each append's lanes over the traced "
        "steps) fit the ring's slot count",
    "no-ring-truncation":
        "a trace that appends also reaches a durability-watermark "
        "advance (tables/log.advance_watermark); fires on every engine "
        "until the ROADMAP log-truncation item lands (allowlisted with "
        "that pointer, one entry a durable target)",
    "replay-coverage":
        "the replay twin rebuilds every table class the engine installs, "
        "reads the header words the winner rule needs, and never reads "
        "past the populated entry prefix",
    "in-doubt-totality":
        "the wire coordinator detects Reply.TIMEOUT, folds it into the "
        "alive mask via the in-doubt set, and releases doubted locks "
        "with an Op.ABORT wave (AST check over the client source)",
}


def _durable_targets():
    return sorted(n for n, p in analysis.TARGET_PROTOCOL.items()
                  if _dur.FLAG_DURABLE in p or _dur.FLAG_REPLAY in p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="dintdur", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("mode", choices=["report", "check", "describe"],
                    help="report: print findings; check: gate (exit 1 on "
                         "unsuppressed errors); describe: list the "
                         "checks, flags, and durable targets")
    ap.add_argument("--all", action="store_true",
                    help="run every registered target")
    ap.add_argument("--target", action="append", default=[],
                    help="target name (repeatable)")
    ap.add_argument("--json", action="store_true",
                    help="emit one machine-parseable JSON line")
    ap.add_argument("--sarif", metavar="PATH", default=None,
                    help="also write the findings as SARIF 2.1.0 to PATH "
                         "('-' for stdout); allowlisted findings become "
                         "suppressions")
    ap.add_argument("--allowlist", default=None,
                    help="allowlist JSON path (default: "
                         "dint_tpu_torch/analysis/dintlint_allow.json)")
    ap.add_argument("--prune-allowlist", action="store_true",
                    help="check mode only: run the durability pass over "
                         "the FULL target matrix and rewrite the "
                         "allowlist dropping this gate's stale entries "
                         "(entries for other passes and wildcard-pass "
                         "entries are kept — dintlint prunes those)")
    ap.add_argument("--check", action="store_true",
                    help="with --prune-allowlist: dry-run — report stale "
                         "entries and exit 1 without rewriting the file")
    args = ap.parse_args(argv)

    if args.mode == "describe":
        if args.json:
            print(json.dumps({
                "metric": "dintdur", "schema": JSON_SCHEMA,
                "checks": _CHECKS,
                "flags": {"durable": "engine appends to a replicated "
                                     "ring; wal/ring/replay checks apply",
                          "replay": "target IS a recovery replay twin; "
                                    "its entry-column reads are checked"},
                "durable_targets": _durable_targets(),
            }), flush=True)
            return 0
        print("durability checks (ERROR severity but the INFO one):")
        for code, doc in _CHECKS.items():
            print(f"  {code:24s} {doc}")
        print("protocol flags (analysis/targets.py):")
        print("  durable  engine appends to a replicated ring")
        print("  replay   target is a recovery replay twin")
        print("durable/replay targets:")
        for name in _durable_targets():
            proto = ",".join(analysis.TARGET_PROTOCOL.get(name, ()))
            print(f"  {name:32s} [{proto}]")
        return 0

    if args.check and not args.prune_allowlist:
        ap.error("--check only modifies --prune-allowlist (dry-run)")
    if args.prune_allowlist and args.mode != "check":
        ap.error("--prune-allowlist is a check-mode operation")
    if not args.all and not args.target and not args.prune_allowlist:
        ap.error("pick targets with --target/--all")
    err = cli.check_names("target", args.target, analysis.TARGETS)
    if err:
        ap.error(err)

    allowlist = cli.resolve_allowlist(args.allowlist)

    stale = False
    if args.prune_allowlist:
        # gate-scoped: only durability entries can be judged stale here
        findings, stale = cli.prune_scoped_gate(args, ap, "durability",
                                                allowlist)
    else:
        findings = analysis.run(
            targets=None if args.all else args.target,
            passes=["durability"],
            allowlist_path=allowlist)

    failed = (args.mode == "check"
              and (analysis.has_errors(findings) or stale))
    if args.sarif:
        cli.write_sarif(findings, ap.prog, args.sarif)
    if args.json:
        print(json.dumps(cli.gate_payload(
            "dintdur", JSON_SCHEMA, args.mode,
            sorted(analysis.TARGETS) if args.all else args.target,
            allowlist, findings, stale, failed)), flush=True)
    else:
        cli.print_findings(findings, "dintdur", failed)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
