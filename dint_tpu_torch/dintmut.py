"""dintmut CLI: the port's mutation-coverage gate over its static
analysis matrix (the counterpart of tools/dintmut.py).

The standing gates claim they catch unlocked installs, dropped
replication, unbounded rings and cost regressions; dintmut proves it.
analysis/mutate.py corrupts copies of the traced engines' fx graphs with
a registered operator set (drop-eqn, weaken-scatter, mask-swap,
axis-swap, widen-gather, out-of-place-write, ring-shrink), re-runs every
structural pass on each mutant, attributes the kill to the pass/code
that fired, and pins the verdict matrix as MUTCOV_TORCH.json
(``$DINT_MUTCOV`` overrides the path). passes/mut_check.py is the
standing gate over the pinned artifact; this CLI adds the re-run tiers.

Usage:
    python -m dint_tpu_torch.dintmut run [-o OUT] [--json]   # pin
    python -m dint_tpu_torch.dintmut check          # re-run the matrix
    python -m dint_tpu_torch.dintmut check --quick  # the pinned sample
    python -m dint_tpu_torch.dintmut check --prune-allowlist [--check]
    python -m dint_tpu_torch.dintmut check --sarif out.sarif [--json]
    python -m dint_tpu_torch.dintmut report [--json]   # no tracing
    python -m dint_tpu_torch.dintmut describe          # the catalogue

Exit codes: 0 gate passed; 1 mutants drifted or the policy failed; 2
usage or artifact errors.
"""
from __future__ import annotations

import argparse
import json

from . import analysis
from .analysis import cli
from .analysis import mutate as M
from .analysis.core import Finding, SEV_ERROR
from .analysis.passes import mut_check as MC

PROG = "dintmut"
JSON_SCHEMA = 1


def _progress(verbose: bool):
    if not verbose:
        return None
    return lambda m: print(f"{PROG}: mutating {m.cell_id} ({m.note})",
                           flush=True)


def _cmd_run(args, ap) -> int:
    doc = M.run_matrix(progress=_progress(not args.json))
    path = M.save_mutcov(doc, args.out)
    s = doc["summary"]
    if args.json:
        print(json.dumps(doc, indent=1, sort_keys=True))
        return 0
    for c in doc["cells"]:
        tick = {"killed": "killed  ", "survived": "SURVIVED",
                "crashed": "CRASHED "}.get(c["verdict"], c["verdict"])
        by = f" by {c['killer']}" if c["killer"] else ""
        print(f"  {tick} {c['id']}{by}")
    print(f"{PROG}: {s['n_killed']}/{s['n_cells']} mutants killed "
          f"({s['kill_rate']:.1%}); pinned {path}")
    for c in doc["cells"]:
        if c["verdict"] == "survived":
            print(f"{PROG}: survivor {c['id']} needs a triage entry "
                  "(mut_check/survivor) or a new pass")
    return 0


def drift_findings(pinned: dict, fresh_cells: list[dict], target: str,
                   mode: str) -> list[Finding]:
    """The re-run cells against the pinned rows, field for field (the
    re-run tier the static mut_check cannot do)."""
    out: list[Finding] = []
    by_id = {c["id"]: c for c in pinned.get("cells", [])}
    regen = f"regenerate with `python -m dint_tpu_torch.{PROG} run`"
    for cell in fresh_cells:
        cid = cell.get("id")
        want = by_id.get(cid)
        if cell.get("verdict") == "missing-cell" or want is None:
            out.append(Finding(
                "mut_check", "cell-drift", SEV_ERROR, target,
                f"pinned cell {cid} is no longer discoverable from the "
                "current tree: the engine or the operator registry "
                "changed under the artifact", site=str(cid),
                suggestion=regen))
            continue
        diffs = [k for k in ("verdict", "killer", "new_errors", "site",
                             "note", "suppressed")
                 if cell.get(k) != want.get(k)]
        if diffs:
            detail = "; ".join(
                f"{k} {want.get(k)!r} -> {cell.get(k)!r}" for k in diffs)
            out.append(Finding(
                "mut_check", "cell-drift", SEV_ERROR, target,
                f"re-run cell {cid} disagrees with the pinned row "
                f"({detail}): the kill evidence is stale", site=str(cid),
                suggestion=regen + " and review the diff"))
    if mode == "full":
        pinned_ids = {c["id"] for c in pinned.get("cells", [])}
        new = [c["id"] for c in fresh_cells if c["id"] not in pinned_ids]
        if new:
            out.append(Finding(
                "mut_check", "cell-drift", SEV_ERROR, target,
                f"{len(new)} mutant(s) discovered that the pinned matrix "
                f"never recorded ({', '.join(new[:4])}"
                f"{', ...' if len(new) > 4 else ''}): the matrix grew "
                "without re-pinning", site="cells", suggestion=regen))
    return out


def _cmd_check(args, ap) -> int:
    allowlist = cli.resolve_allowlist(args.allowlist)
    if args.check and not args.prune_allowlist:
        ap.error("--check only modifies --prune-allowlist (dry-run)")
    stale = False
    anchor = MC._anchor()
    if args.prune_allowlist:
        findings, stale = cli.prune_scoped_gate(args, ap, "mut_check",
                                                allowlist,
                                                targets=[anchor])
        findings = [f for f in findings if f.pass_name == "mut_check"]
        mode = "prune"
    else:
        findings = analysis.run(targets=[anchor], passes=["mut_check"],
                                allowlist_path=allowlist)
        mode = "quick" if args.quick else "full"
        doc, _ = MC.load_mutcov_findings(anchor)
        if doc is not None and not any(
                f.code in ("stale-provenance", "malformed-mutcov")
                and not f.suppressed for f in findings):
            if args.quick:
                fresh = M.run_cells(doc.get("quick", {}).get("cells", []))
            else:
                fresh = M.run_matrix(
                    progress=_progress(not args.json))["cells"]
            findings += drift_findings(doc, fresh, anchor, mode)
        findings.sort(key=lambda f: f.sort_key())
    failed = analysis.has_errors(findings) or stale
    if args.sarif:
        cli.write_sarif(findings, PROG, args.sarif)
    if args.json:
        from .analysis import targets as T
        print(json.dumps(cli.gate_payload(
            "mutation-coverage", JSON_SCHEMA, mode, sorted(T.MUT_TARGETS),
            allowlist, findings, stale, failed,
            mutcov=str(M.mutcov_path())), indent=1, sort_keys=True))
    else:
        cli.print_findings(findings, PROG, failed)
    return 1 if failed else 0


def _cmd_report(args, ap) -> int:
    doc = M.load_mutcov()            # guard() maps errors to exit 2
    s = doc["summary"]
    if args.json:
        print(json.dumps(cli.gate_payload(
            "mutation-coverage", JSON_SCHEMA, "report", None, None, [],
            False, False, mutcov=str(M.mutcov_path()), summary=s,
            quick=doc.get("quick"), provenance=doc.get("provenance")),
            indent=1, sort_keys=True))
        return 0
    print(f"{PROG}: pinned matrix {M.mutcov_path()}")
    print(f"  {s['n_killed']}/{s['n_cells']} killed "
          f"({s['kill_rate']:.1%}, floor "
          f"{doc.get('kill_rate_floor', M.KILL_RATE_FLOOR):.0%})")
    for op, rec in sorted(s["by_operator"].items()):
        print(f"  {op:20s} {rec['killed']}/{rec['cells']}")
    print("  killer passes: " + ", ".join(
        f"{k} x{v}" for k, v in sorted(s["killer_passes"].items())))
    for c in doc["cells"]:
        if c["verdict"] != "killed":
            print(f"  {c['verdict']} {c['id']}: {c['note']}")
    print(f"  quick sample (seed {doc['quick']['seed']}): "
          + ", ".join(doc["quick"]["cells"]))
    return 0


_CHECKS = {
    "missing-mutcov": "no MUTCOV_TORCH.json at the resolved path",
    "malformed-mutcov": "unparseable / wrong schema / missing sections",
    "stale-provenance": "registry, target matrix or cell rows changed "
                        "after pinning",
    "summary-drift": "the recorded summary or quick sample is not what "
                     "the cells recompute to",
    "kill-rate-floor": f"kill rate below {M.KILL_RATE_FLOOR:.0%}",
    "survivor": "a mutant no gate sees (triage reason required)",
    "mutant-crashed": "a mutant crashed the analysis (never a kill)",
    "operator-dormant": "a registered operator found zero sites",
    "attribution-gap": "a required gate family killed nothing",
    "ring-triage-drift": "ring cells out of step with the standing "
                         "no-ring-truncation entries",
    "cell-drift": "(check only) a re-run mutant disagrees with its "
                  "pinned row",
}


def _cmd_describe(args, ap) -> int:
    print("mutation operators (analysis/mutate.py OPERATORS):")
    for name, op in sorted(M.OPERATORS.items()):
        twin = f" (the reference's {op.stands_for})" if op.stands_for \
            else ""
        print(f"  {name:20s} {op.doc}{twin}")
        print(f"  {'':20s} expects: {', '.join(op.expect)}")
    print("mut_check codes:")
    for code, doc in _CHECKS.items():
        print(f"  {code:18s} {doc}")
    print(f"matrix: {len(M.mut_passes())} passes x MUT_TARGETS "
          "(analysis/targets.py)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog=PROG, description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="run the whole mutation matrix and pin "
                                   "MUTCOV_TORCH.json")
    p.add_argument("-o", "--out", help="write the artifact here instead "
                                       "of the resolved path")
    p.add_argument("--json", action="store_true",
                   help="print the whole document as JSON")
    p.set_defaults(fn=_cmd_run)

    p = sub.add_parser("check", help="re-run mutants against the pinned "
                                     "matrix + the policy gate")
    p.add_argument("--quick", action="store_true",
                   help="re-run only the pinned sample (the dintgate "
                        "tier)")
    p.add_argument("--allowlist", help="allowlist JSON (default: the "
                                       "port's analysis/"
                                       "dintlint_allow.json)")
    p.add_argument("--prune-allowlist", action="store_true",
                   help="drop mut_check allowlist entries whose findings "
                        "no longer occur")
    p.add_argument("--check", action="store_true",
                   help="with --prune-allowlist: report stale entries "
                        "without rewriting (exit 1 if any)")
    p.add_argument("--json", action="store_true",
                   help="machine-readable findings payload")
    p.add_argument("--sarif", metavar="PATH",
                   help="write SARIF 2.1.0 ('-' for stdout)")
    p.set_defaults(fn=_cmd_check)

    p = sub.add_parser("report", help="the pinned summary (no tracing)")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=_cmd_report)

    p = sub.add_parser("describe", help="operator + check catalogue")
    p.set_defaults(fn=_cmd_describe)

    args = ap.parse_args(argv)
    return cli.guard(PROG, args.fn, args, ap)


if __name__ == "__main__":
    raise SystemExit(main())
