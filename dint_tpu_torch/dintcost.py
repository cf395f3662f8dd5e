"""dintcost CLI: the port's static per-wave cost model and its CPU gate
(the counterpart of tools/dintcost.py).

dintlint proves the hot paths safe, dintscope measures them on the card,
dintcost DERIVES their cost from the traced fx graph — logical bytes per
wave, memory-op dispatches per step, persistent footprint — and gates
all three against the waves.py ledger and the budgets of
analysis/targets.TARGET_COST. No card: an extra dispatch, a doubled
gather or a table copied where it should be written in place fails on
the CPU.

Usage:
    python -m dint_tpu_torch.dintcost report TARGET [TARGET ...] [--json] [-o OUT]
    python -m dint_tpu_torch.dintcost report --all
    python -m dint_tpu_torch.dintcost check --all                # the gate
    python -m dint_tpu_torch.dintcost check --target tatp_dense/block@fused
        [--allowlist PATH] [--json]
    python -m dint_tpu_torch.dintcost check --all --sarif out.sarif
    python -m dint_tpu_torch.dintcost check --prune-allowlist [--check]
    python -m dint_tpu_torch.dintcost diff A.json B.json [--bytes-pct 10] [--json]
    python -m dint_tpu_torch.dintcost describe [--json]          # the ledger

`check` runs ONLY the cost_budget pass of the dintlint suite (same
allowlist, same exit discipline); `python -m dint_tpu_torch.dintlint
--all` runs it too. `diff` compares two `report -o` artifacts (e.g.
across a PR) and fails on any dispatch or footprint growth, or a wave's
bytes growing past the threshold, naming the wave and target.

Exit codes: 0 ok; 1 = gate or diff failure (offenders named); 2 usage.
"""
from __future__ import annotations

import argparse
import json
import sys

from . import analysis
from .analysis import cli, cost
from .analysis import targets as T

# bumped when keys of the --json payload change shape (the reference's
# schema: per-axis link bytes at top level and per wave; the check
# payload carries stale_allowlist)
JSON_SCHEMA = 3

DEFAULT_BYTES_PCT = 10.0


def _target_names(args, ap) -> list[str]:
    names = list(getattr(args, "targets", []) or []) \
        + list(getattr(args, "target", []) or [])
    if args.all:
        return sorted(T.TARGETS)
    if not names:
        ap.error("pick targets (positional or --target) or use --all")
    err = cli.check_names("target", names, T.TARGETS)
    if err:
        ap.error(err)
    return names


def _entry(name: str) -> dict | None:
    """One target's derived model, reconciliation and budget status, or
    None when the target is skipped."""
    try:
        trace = T.get_trace(name)
    except T.SkipTarget:
        return None
    meta = T.TARGET_COST.get(name, {})
    model = cost.model_for(name, trace)
    d = model.to_dict()
    checks = cost.reconcile_for(name, model)
    ledger = cost.ledger_bytes(model, meta.get("wave_expect"))
    bud = dict(meta.get("budget") or {})
    d["reconcile"] = [{
        "wave": c.wave, "members": list(c.members),
        "derived": round(c.derived, 2), "declared": round(c.declared, 2),
        "ratio": round(c.ratio, 4), "tol": c.tol, "ok": c.ok,
        "expect": None if c.expect is None else str(c.expect),
    } for c in checks]
    d["ledger_bytes"] = round(ledger, 2)
    d["budget"] = {
        "dispatches": bud.get("dispatches"),
        "bytes_formula": bud.get("bytes"),
        "bytes": cost.eval_budget_bytes(bud.get("bytes"), model.geom,
                                        ledger),
        "footprint": bud.get("footprint"),
    }
    twin = cost.fused_twin(name)
    d["fused_twin"] = twin if twin in T.TARGETS else None
    return d


def _report_payload(names: list[str]) -> dict:
    entries, skipped = {}, []
    for n in names:
        e = _entry(n)
        if e is None:
            skipped.append(n)
        else:
            entries[n] = e
    return {"metric": "dintcost", "schema": JSON_SCHEMA,
            "targets": entries, "skipped": skipped}


def cmd_report(args, ap) -> int:
    payload = _report_payload(_target_names(args, ap))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=1)
    if args.json:
        print(json.dumps(payload), flush=True)
        return 0
    for name, e in payload["targets"].items():
        bud = e["budget"]
        print(f"{name}  (steps/trace={e['steps']:g})")
        print(f"  dispatches/step {e['dispatches_per_step']:g}"
              + (f"  (budget {bud['dispatches']:g})"
                 if bud["dispatches"] is not None else ""))
        print(f"  bytes/step      {e['bytes_per_step']:g}"
              + (f"  (budget {bud['bytes']:g} = {bud['bytes_formula']!r},"
                 f" ledger {e['ledger_bytes']:g})"
                 if bud["bytes"] is not None else ""))
        print(f"  footprint       {e['footprint_bytes']} B "
              f"(inputs {e['input_bytes']}, written in place "
              f"{e['donated_bytes']})"
              + (f"  (budget {bud['footprint']})"
                 if bud["footprint"] is not None else ""))
        if e["unpriced_waves"]:
            print("  unpriced (collective) waves: "
                  + ", ".join(e["unpriced_waves"]))
        for w, r in e["waves"].items():
            print(f"    {w:44s} {r['bytes_per_step']:>10g} B "
                  f"{r['dispatches_per_step']:>6g} disp")
        for c in e["reconcile"]:
            mark = "ok " if c["ok"] else "FAIL"
            exp = f" expect={c['expect']}" if c["expect"] else ""
            print(f"    [{mark}] {c['wave']}: derived {c['derived']:g} "
                  f"vs declared {c['declared']:g} "
                  f"(r={c['ratio']:.2f} tol={c['tol']:g}){exp}")
    if payload["skipped"]:
        print("skipped: " + ", ".join(payload["skipped"]))
    return 0


def cmd_check(args, ap) -> int:
    if args.check and not args.prune_allowlist:
        ap.error("--check only modifies --prune-allowlist (dry-run)")
    allowlist = cli.resolve_allowlist(args.allowlist)
    stale = False
    if args.prune_allowlist:
        # gate-scoped: only cost_budget entries can be judged stale here
        names = sorted(T.TARGETS)
        findings, stale = cli.prune_scoped_gate(args, ap, "cost_budget",
                                                allowlist)
    else:
        names = _target_names(args, ap)
        findings = analysis.run(targets=None if args.all else names,
                                passes=["cost_budget"],
                                allowlist_path=allowlist)
    failed = analysis.has_errors(findings) or stale
    if args.sarif:
        cli.write_sarif(findings, ap.prog, args.sarif)
    if args.json:
        print(json.dumps(cli.gate_payload(
            "dintcost", JSON_SCHEMA, "check", names, allowlist,
            findings, stale, failed)), flush=True)
    else:
        cli.print_findings(findings, "dintcost", failed,
                           show_suppressed=False)
    return 1 if failed else 0


def _load_artifact(path: str) -> dict:
    with open(path) as f:
        data = json.load(f)
    # accept a bench artifact carrying a "dintcost" object
    if "targets" not in data and isinstance(data.get("dintcost"), dict):
        data = data["dintcost"]
    if not isinstance(data.get("targets"), dict):
        raise ValueError(f"{path}: not a dintcost report artifact "
                         "(expected a 'targets' object — produce one "
                         "with `dintcost report -o`)")
    return data


def diff_artifacts(a: dict, b: dict, bytes_pct: float):
    """(common targets, rows, regressions) of two report artifacts."""
    regs, rows = [], []
    common = sorted(set(a["targets"]) & set(b["targets"]))
    for name in common:
        ea, eb = a["targets"][name], b["targets"][name]
        rows.append((name, ea, eb))
        if eb["dispatches_per_step"] > ea["dispatches_per_step"] + 1e-9:
            regs.append({"kind": "dispatches", "target": name,
                         "a": ea["dispatches_per_step"],
                         "b": eb["dispatches_per_step"]})
        if eb["footprint_bytes"] > ea["footprint_bytes"]:
            regs.append({"kind": "footprint", "target": name,
                         "a": ea["footprint_bytes"],
                         "b": eb["footprint_bytes"]})
        waves_a, waves_b = ea.get("waves", {}), eb.get("waves", {})
        for w in sorted(set(waves_a) | set(waves_b)):
            ba = waves_a.get(w, {}).get("bytes_per_step", 0.0)
            bb = waves_b.get(w, {}).get("bytes_per_step", 0.0)
            if bb > ba * (1 + bytes_pct / 100.0) + 1e-6:
                regs.append({"kind": "wave-bytes", "target": name,
                             "wave": w, "a": ba, "b": bb})
    return common, rows, regs


def cmd_diff(args, ap) -> int:
    a = _load_artifact(args.a)
    b = _load_artifact(args.b)
    common, rows, regs = diff_artifacts(a, b, args.bytes_pct)
    ok = not regs
    if args.json:
        print(json.dumps({
            "metric": "dintcost", "schema": JSON_SCHEMA, "mode": "diff",
            "a": args.a, "b": args.b, "common_targets": common,
            "thresholds": {"bytes_pct": args.bytes_pct},
            "ok": ok, "regressions": regs}), flush=True)
    else:
        print(f"A = {args.a}\nB = {args.b}")
        for name, ea, eb in rows:
            print(f"{name:40s} d {ea['dispatches_per_step']:g}->"
                  f"{eb['dispatches_per_step']:g}  B "
                  f"{ea['bytes_per_step']:g}->{eb['bytes_per_step']:g}  "
                  f"fp {ea['footprint_bytes']}->{eb['footprint_bytes']}")
        if ok:
            print(f"ok: no static regression past bytes_pct="
                  f"{args.bytes_pct:g} across {len(common)} target(s)")
        for r in regs:
            which = r.get("wave", r["target"])
            print(f"REGRESSION [{r['kind']}] {r['target']} {which}: "
                  f"{r['a']} -> {r['b']}")
    return 0 if ok else 1


def cmd_describe(args, ap) -> int:
    if args.json:
        print(json.dumps({
            "metric": "dintcost", "schema": JSON_SCHEMA,
            "mode": "describe",
            "default_tol": cost.DEFAULT_TOL,
            "targets": {n: T.TARGET_COST[n]
                        for n in sorted(T.TARGET_COST)}}), flush=True)
        return 0
    print(f"dintcost budget ledger ({len(T.TARGET_COST)} targets, "
          f"reconcile tol {cost.DEFAULT_TOL}):")
    for n in sorted(T.TARGET_COST):
        m = T.TARGET_COST[n]
        bud = m.get("budget", {})
        geom = ",".join(f"{k}={v}" for k, v in m.get("geom", {}).items())
        print(f"  {n:40s} steps={m.get('steps'):g} "
              f"disp<={bud.get('dispatches')} "
              f"bytes<={bud.get('bytes')!r} fp<={bud.get('footprint')} "
              f"[{geom}]")
        for w, e in sorted((m.get("wave_expect") or {}).items()):
            print(f"      expect {w} = {e!r}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="dintcost", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("report",
                       help="derive per-target cost models (waves, "
                            "dispatches, footprint, reconciliation)")
    p.add_argument("targets", nargs="*", help="target names; see describe")
    p.add_argument("--target", action="append", default=[])
    p.add_argument("--all", action="store_true")
    p.add_argument("--json", action="store_true")
    p.add_argument("-o", "--out", default=None,
                   help="write the report artifact here (diff input)")
    p.set_defaults(fn=cmd_report)

    p = sub.add_parser("check",
                       help="the gate: run the cost_budget pass with the "
                            "port's allowlist")
    p.add_argument("--target", action="append", default=[])
    p.add_argument("--all", action="store_true")
    p.add_argument("--allowlist", default=None,
                   help="allowlist JSON path (default: "
                        "dint_tpu_torch/analysis/dintlint_allow.json)")
    p.add_argument("--sarif", metavar="PATH", default=None,
                   help="also write the findings as SARIF 2.1.0 "
                        "('-' for stdout), dintlint's exporter")
    p.add_argument("--prune-allowlist", action="store_true",
                   help="run this gate's full matrix, then rewrite the "
                        "allowlist dropping cost_budget entries that "
                        "matched no finding (other gates' entries and "
                        "wildcard-pass entries are kept)")
    p.add_argument("--check", action="store_true",
                   help="with --prune-allowlist: dry-run — rewrite "
                        "nothing, exit 1 if stale entries exist")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_check)

    p = sub.add_parser("diff",
                       help="regression gate between two report artifacts")
    p.add_argument("a")
    p.add_argument("b")
    p.add_argument("--bytes-pct", type=float, default=DEFAULT_BYTES_PCT,
                   help="per-wave derived-bytes growth threshold "
                        f"(default {DEFAULT_BYTES_PCT:g}%%)")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_diff)

    p = sub.add_parser("describe", help="print the budget ledger")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_describe)

    args = ap.parse_args(argv)
    return cli.guard("dintcost", args.fn, args, ap)


if __name__ == "__main__":
    sys.exit(main())
