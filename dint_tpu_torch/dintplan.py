"""dintplan CLI: the port's static configuration planner and its gate (the
counterpart of tools/dintplan.py).

`plan` enumerates the feasible (engine x geometry x skew x mesh) candidate
lattice from the knob registry (analysis/plan.KNOBS), prices every
candidate through the port's dintcost CostModel and the ServiceModel
capacity priors (CALIB_H100.json), prunes statically dominated points and
pins the result as PLAN_H100.json with provenance hashes. `check` is the
standing gate: the pinned plan must agree with the knob registry, the
calibration ledger and the priced frontier, and ambient DINT_* flags may
not contradict it without DINT_PLAN_OVERRIDE=1 (passes/plan_check.py).

Usage:
    python -m dint_tpu_torch.dintplan plan [-o PLAN_H100.json] [--json]
        [--calib CALIB_H100.json]                 # re-pin from evidence
    python -m dint_tpu_torch.dintplan check              # the gate (full)
        [--static] [--plan PATH] [--allowlist PATH] [--json]
    python -m dint_tpu_torch.dintplan check --sarif out.sarif
    python -m dint_tpu_torch.dintplan check --prune-allowlist [--check]
    python -m dint_tpu_torch.dintplan describe [--json]  # knob registry

`check` runs ONLY the plan_check pass of the dintlint suite (same
allowlist, same exit discipline); ``python -m dint_tpu_torch.dintlint
--all`` runs it too, in STATIC form. `check` here is the FULL gate: it
re-derives every frontier price fresh (the 25 candidates traced on the
CPU at the lint geometry, ~2 min). ``--static`` skips that derivation:
the provenance hashes still pin the calibration ledger and the recorded
prices bit for bit. `plan` traces the same lattice.

Exit codes: 0 ok; 1 = gate failure (offenders are named); 2 usage.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from . import analysis
from .analysis import cli
from .analysis import plan as P

# bumped when keys of the --json payload change shape
JSON_SCHEMA = 1


def cmd_plan(args, ap) -> int:
    if args.calib:
        # price the serve priors with this calibration: serve_priors
        # resolves its ServiceModel through monitor/calib, which honours
        # DINT_CALIB_PATH (the dintcal `propose` -> `plan --calib` loop)
        os.environ["DINT_CALIB_PATH"] = args.calib
    plan = P.build_plan()
    out = args.out or P.plan_path()
    path = P.save_plan(plan, out)
    if args.json:
        print(json.dumps({
            "metric": "dintplan", "schema": JSON_SCHEMA, "mode": "plan",
            "out": str(path), "provenance": plan["provenance"],
            "workloads": {w: {"target": e["target"],
                              "predicted_target": e["predicted_target"],
                              "overrides": [o["knob"]
                                            for o in e["overrides"]]}
                          for w, e in plan["workloads"].items()},
            "n_frontier": len(plan["frontier"])}), flush=True)
        return 0
    print(f"wrote {path} (schema {plan['schema']}, "
          f"{len(plan['frontier'])} priced candidates, "
          f"{len(plan['workloads'])} workloads)")
    for wname, e in sorted(plan["workloads"].items()):
        mark = "" if e["target"] == e["predicted_target"] else \
            "  [overridden: " + ", ".join(o["knob"]
                                          for o in e["overrides"]) + "]"
        print(f"  {wname:20s} pinned {e['target']:40s} "
              f"predicted {e['predicted_target']}{mark}")
    print("provenance: " + " ".join(f"{k}={v}" for k, v in
                                    sorted(plan["provenance"].items())))
    return 0


def cmd_check(args, ap) -> int:
    if args.check and not args.prune_allowlist:
        ap.error("--check only modifies --prune-allowlist (dry-run)")
    if args.plan:
        os.environ[P.ENV_PLAN_PATH] = args.plan
    # the embedded pass defaults to static (cheap); this is the FULL gate
    # unless --static asked for the cheap one
    os.environ[P.ENV_PLAN_STATIC] = "1" if args.static else "0"
    allowlist = cli.resolve_allowlist(args.allowlist)
    anchor = os.environ.get(P.ENV_PLAN_ANCHOR, P.DEFAULT_ANCHOR)
    stale = False
    if args.prune_allowlist:
        findings, stale = cli.prune_scoped_gate(args, ap, "plan_check",
                                                allowlist,
                                                targets=[anchor])
    else:
        findings = analysis.run(targets=[anchor], passes=["plan_check"],
                                allowlist_path=allowlist)
    failed = analysis.has_errors(findings) or stale
    if args.sarif:
        cli.write_sarif(findings, ap.prog, args.sarif)
    if args.json:
        print(json.dumps({
            "metric": "dintplan", "schema": JSON_SCHEMA, "mode": "check",
            "plan": str(P.plan_path()), "static": bool(args.static),
            "anchor": anchor, "allowlist": allowlist,
            "n_findings": len(findings),
            "n_errors": cli.count_errors(findings),
            "n_suppressed": cli.count_suppressed(findings),
            "stale_allowlist": stale,
            "ok": not failed,
            "findings": [f.to_dict() for f in findings]}), flush=True)
    else:
        for f in findings:
            print(f)
        mode = "static" if args.static else "full"
        print(f"dintplan ({mode}): {len(findings)} finding(s), "
              f"{cli.count_errors(findings)} error(s) -> "
              f"{'FAIL' if failed else 'ok'}", flush=True)
    return 1 if failed else 0


def cmd_describe(args, ap) -> int:
    if args.json:
        print(json.dumps({
            "metric": "dintplan", "schema": JSON_SCHEMA,
            "mode": "describe",
            "decision_rule": P.DECISION_RULE,
            "plan_path": str(P.plan_path()),
            "knobs": {k.name: k.to_dict() for k in P.KNOBS.values()},
            "workloads": {w.name: w.to_dict() for w in P.WORKLOADS}},
            ), flush=True)
        return 0
    print(f"dintplan knob registry ({len(P.KNOBS)} knobs, "
          f"{len(P.WORKLOADS)} workloads)")
    print(f"decision rule: {P.DECISION_RULE}")
    print(f"pinned plan:   {P.plan_path()}\n")
    for k in P.KNOBS.values():
        tok = (f"=> @{k.token} when {k.token_when!r}" if k.token
               else "(no target variant)")
        bits = []
        if k.planned:
            bits.append("planned")
        if k.build_identity:
            bits.append("build identity")
        tag = f" [{', '.join(bits)}]" if bits else ""
        print(f"  {k.name:16s} env={k.env or '-':22s} "
              f"default={k.default!r:6} {tok}{tag}")
        print(f"  {'':16s} engines: {', '.join(k.engines)}")
        print(f"  {'':16s} {k.doc}")
    print("\nworkloads (engine x geometry x skew x mesh; mesh = the "
          "geometry the targets are traced at):")
    for w in P.WORKLOADS:
        mesh = w.mesh or "single-device"
        print(f"  {w.name:20s} {w.engine}/{w.base:8s} mesh={mesh:8s} "
              f"skew={w.skew:10s} knobs: "
              + (", ".join(w.knobs) or "(none)"))
    print("\nnot registered: use_pallas, pallas_interpret, trace_cap (the "
          "port has one route per knob and no interpret mode)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="dintplan", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("plan",
                       help="enumerate, price, prune and pin the plan")
    p.add_argument("-o", "--out", default=None,
                   help="output path (default: $DINT_PLAN_PATH, else "
                        "PLAN_H100.json at the repository's root)")
    p.add_argument("--calib", metavar="CALIB.json", default=None,
                   help="price serve priors with this calibration (sets "
                        "DINT_CALIB_PATH for the build)")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_plan)

    p = sub.add_parser("check",
                       help="the gate: run the plan_check pass with the "
                            "port's allowlist")
    p.add_argument("--static", action="store_true",
                   help="skip the fresh dintcost derivation (registry + "
                        "provenance + ordering checks only; no tracing)")
    p.add_argument("--plan", default=None,
                   help="check this plan file instead of the pinned one")
    p.add_argument("--allowlist", default=None,
                   help="allowlist JSON path (default: the port's "
                        "analysis/dintlint_allow.json)")
    p.add_argument("--sarif", metavar="PATH", default=None,
                   help="also write the findings as SARIF 2.1.0 "
                        "('-' for stdout)")
    p.add_argument("--prune-allowlist", action="store_true",
                   help="drop plan_check allowlist entries that match "
                        "nothing")
    p.add_argument("--check", action="store_true",
                   help="with --prune-allowlist: rewrite nothing, exit 1 "
                        "on a stale entry")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_check)

    p = sub.add_parser("describe",
                       help="print the knob registry with each knob's "
                            "target mapping and the workload lattice")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_describe)

    args = ap.parse_args(argv)
    return cli.guard("dintplan", args.fn, args, ap)


if __name__ == "__main__":
    sys.exit(main())
