"""dintcal CLI: the calibration and prediction-audit plane and its gate
(the port of tools/dintcal.py, over `dint_tpu_torch.monitor.calib`).

`gather` normalizes bench/exp artifacts (dintscope breakdowns, counter
snapshots, serve controller samples) into one evidence document, `fit`
pins ServiceModel coefficients from it as a schema-versioned calibration,
`check` is the standing drift gate (the static calib_check pass plus the
tolerance-banded reconciliation with the evidence), `audit` replays a
controller decision journal through the policy functions, verifying every
recorded width/shed/hot_frac decision bit for bit, and `propose` fits a
recalibration from the pinned calibration's evidence (or ``--evidence``)
that ``python -m dint_tpu_torch.dintplan plan --calib`` re-pins the plan
from.

Usage:
    python -m dint_tpu_torch.dintcal gather ART [ART...] -o evidence.json
    python -m dint_tpu_torch.dintcal fit EVIDENCE [-o CALIB.json] [--json]
    python -m dint_tpu_torch.dintcal check                 # the gate
        [--calib PATH] [--evidence PATH] [--allowlist PATH]
        [--sarif out.sarif] [--json]
    python -m dint_tpu_torch.dintcal audit JOURNAL [--json]
    python -m dint_tpu_torch.dintcal propose [--calib PATH]
        [--evidence PATH] [-o CALIB.proposed.json] [--json]
    python -m dint_tpu_torch.dintcal describe [--json]
    python -m dint_tpu_torch.dintcal synth --out-evidence PATH
        --out-journal PATH [--json]

The pinned calibration is ``$DINT_CALIB_PATH``, else ``CALIB_H100.json``
at the repository's root (`calib.calib_path`); the plan it is checked
against is the port's (``PLAN_H100.json``). `check` exits 1 naming the
drifted wave or coefficient; `audit` exits 1 naming the entry (index and
block) whose recorded decision the replay does not reproduce. Exit codes:
0 ok; 1 gate or audit failure; 2 usage or file errors.

What differs from tools/dintcal.py: ``synth`` writes only where
``--out-evidence`` and ``--out-journal`` say, since the default paths are
the JAX package's fixtures.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

from .monitor import calib as CAL

# bumped when keys of the --json payload change shape
JSON_SCHEMA = 1


def _load_json(path):
    with open(path) as fh:
        return json.load(fh)


def _write_json(path, doc) -> None:
    Path(path).write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")


def cmd_gather(args) -> int:
    docs = [_load_json(p) for p in args.artifacts]
    ev = CAL.gather_evidence(docs, sources=args.artifacts)
    _write_json(args.out, ev)
    summary = {"metric": "dintcal", "schema": JSON_SCHEMA,
               "mode": "gather", "out": args.out,
               "n_sources": len(args.artifacts),
               "n_samples": len(ev["samples"]),
               "n_waves": len(ev["waves"]),
               "counters": ev["counters"]}
    if args.json:
        print(json.dumps(summary), flush=True)
    else:
        print(f"wrote {args.out}: {summary['n_samples']} service "
              f"samples, {summary['n_waves']} wave rows from "
              f"{len(args.artifacts)} artifact(s)")
    return 0


def cmd_fit(args) -> int:
    ev = CAL.load_evidence(args.evidence)
    calib = CAL.fit_calib(ev, source=args.source or args.evidence)
    out = Path(args.out) if args.out else CAL.calib_path()
    CAL.save_calib(calib, out)
    if args.json:
        print(json.dumps({
            "metric": "dintcal", "schema": JSON_SCHEMA, "mode": "fit",
            "out": str(out), "model": calib["model"],
            "prior": calib["prior"], "fit": calib["fit"],
            "n_waves": len(calib["waves"]),
            "provenance": calib["provenance"]}), flush=True)
        return 0
    m, p = calib["model"], calib["prior"]
    print(f"wrote {out} (schema {calib['schema']}, "
          f"{calib['fit']['n']} samples at widths "
          f"{calib['fit']['widths']}, {len(calib['waves'])} waves)")
    print(f"  base_us     {m['base_us']:>12.6f}  (prior {p['base_us']})")
    print(f"  per_lane_ns {m['per_lane_ns']:>12.6f}  "
          f"(prior {p['per_lane_ns']})")
    print(f"  rms_us {calib['fit']['rms_us']}  "
          f"max_abs_us {calib['fit']['max_abs_us']}")
    print("provenance: " + " ".join(
        f"{k}={v}" for k, v in sorted(calib["provenance"].items())))
    return 0


def _resolve_evidence(args, calib, cpath):
    """--evidence wins; else the calibration's recorded source, resolved
    relative to the calibration file."""
    if args.evidence:
        return CAL.load_evidence(args.evidence), args.evidence
    src = (calib or {}).get("source")
    if not src:
        return None, None
    spath = Path(src)
    if not spath.is_absolute():
        spath = Path(cpath).parent / spath
    try:
        return CAL.load_evidence(spath), str(spath)
    except (OSError, ValueError):
        return None, str(spath)


def cmd_check(args) -> int:
    from . import analysis
    from .analysis import allowlist as AL
    from .analysis import cli
    from .analysis import plan as P
    from .analysis.core import Finding, SEV_ERROR

    cpath = Path(args.calib) if args.calib else CAL.calib_path()
    if args.calib:
        os.environ[CAL.ENV_CALIB_PATH] = args.calib
    anchor = os.environ.get(P.ENV_PLAN_ANCHOR, P.DEFAULT_ANCHOR)
    allowlist = cli.resolve_allowlist(args.allowlist)

    # half 1: the static calib_check pass (provenance, refit equality,
    # wave registry, plan model attribution) under the allowlist
    findings = analysis.run(targets=[anchor], passes=["calib_check"],
                            allowlist_path=allowlist)

    # half 2: tolerance-banded drift of the pinned fit against evidence
    drift: list[dict] = []
    evidence_path = None
    try:
        calib = CAL.load_calib(cpath)
    except FileNotFoundError:
        calib = None
        findings.append(Finding(
            "calib_check", "missing-calib", SEV_ERROR, anchor,
            f"no calibration at {cpath}: nothing pins the ServiceModel "
            "coefficients to evidence",
            site=str(cpath),
            suggestion="fit one with `python -m dint_tpu_torch.dintcal "
                       "fit <evidence> -o CALIB_H100.json`"))
    except (OSError, ValueError):
        calib = None            # malformed-calib already landed via pass
    if calib is not None:
        ev, evidence_path = _resolve_evidence(args, calib, cpath)
        if ev is not None:
            drift = CAL.check_calib(calib, ev)
            for d in drift:
                findings.append(Finding(
                    "calib_check", "evidence-drift", SEV_ERROR, anchor,
                    d["message"], site=f"{d['what']}:{d['name']}",
                    suggestion="recalibrate with `python -m dint_tpu_torch."
                               "dintcal propose` and re-pin via `python -m "
                               "dint_tpu_torch.dintplan plan --calib`"))
    if allowlist and drift:
        # drift findings come after analysis.run applied the allowlist:
        # give them the same suppression chance
        AL.apply(findings[-len(drift):], AL.load(allowlist),
                 check_unused=False)

    failed = analysis.has_errors(findings)
    if args.sarif:
        cli.write_sarif(findings, "dintcal", args.sarif)
    if args.json:
        print(json.dumps({
            "metric": "dintcal", "schema": JSON_SCHEMA, "mode": "check",
            "calib": str(cpath), "evidence": evidence_path,
            "anchor": anchor, "allowlist": allowlist,
            "n_findings": len(findings),
            "n_errors": cli.count_errors(findings),
            "n_drift": len(drift), "ok": not failed,
            "findings": [f.to_dict() for f in findings]}), flush=True)
    else:
        for f in findings:
            print(f)
        print(f"dintcal check: {len(findings)} finding(s), "
              f"{cli.count_errors(findings)} error(s), "
              f"{len(drift)} drift(s) -> "
              f"{'FAIL' if failed else 'ok'}", flush=True)
    return 1 if failed else 0


def cmd_audit(args) -> int:
    doc = CAL.load_journal(args.journal)
    violations = CAL.audit_journal(doc)
    n = len(doc.get("entries", []))
    if args.json:
        print(json.dumps({
            "metric": "dintcal", "schema": JSON_SCHEMA, "mode": "audit",
            "journal": args.journal, "n_entries": n,
            "n_violations": len(violations),
            "ok": not violations, "violations": violations}), flush=True)
    else:
        for v in violations:
            print(f"dintcal audit: {v['message']}")
        print(f"dintcal audit: {n} entries replayed, "
              f"{len(violations)} violation(s) -> "
              f"{'FAIL' if violations else 'ok'}", flush=True)
    return 1 if violations else 0


def cmd_propose(args) -> int:
    cpath = Path(args.calib) if args.calib else CAL.calib_path()
    try:
        calib = CAL.load_calib(cpath)
    except (OSError, ValueError):
        calib = None
    ev, evidence_path = _resolve_evidence(args, calib, cpath)
    if ev is None:
        print("dintcal propose: no evidence (pass --evidence, or pin a "
              "calibration whose source is readable)", file=sys.stderr)
        return 2
    proposed = CAL.fit_calib(ev, source=evidence_path)
    out = args.out or "CALIB.proposed.json"
    CAL.save_calib(proposed, out)
    delta = None
    if calib is not None:
        delta = {c: {"pinned": calib["model"][c],
                     "proposed": proposed["model"][c]}
                 for c in ("base_us", "per_lane_ns")}
    if args.json:
        print(json.dumps({
            "metric": "dintcal", "schema": JSON_SCHEMA,
            "mode": "propose", "out": str(out),
            "evidence": evidence_path, "model": proposed["model"],
            "delta": delta, "provenance": proposed["provenance"],
            "repin": "python -m dint_tpu_torch.dintplan plan --calib "
                     f"{out}"}), flush=True)
        return 0
    print(f"wrote {out} from {evidence_path}")
    for c in ("base_us", "per_lane_ns"):
        was = f" (pinned {calib['model'][c]})" if calib else ""
        print(f"  {c:12s} {proposed['model'][c]}{was}")
    print(f"re-pin the plan with: python -m dint_tpu_torch.dintplan plan "
          f"--calib {out}")
    return 0


def cmd_describe(args) -> int:
    model, meta = CAL.resolve_service_model()
    if args.json:
        print(json.dumps({
            "metric": "dintcal", "schema": JSON_SCHEMA,
            "mode": "describe",
            "calib_path": str(CAL.calib_path()),
            "evidence_schema": CAL.EVIDENCE_SCHEMA,
            "calib_schema": CAL.CALIB_SCHEMA,
            "tolerance": CAL.DEFAULT_TOLERANCE,
            "resolved_model": {"base_us": model.base_us,
                               "per_lane_ns": model.per_lane_ns,
                               **meta}}), flush=True)
        return 0
    print(f"dintcal: evidence schema {CAL.EVIDENCE_SCHEMA}, calib "
          f"schema {CAL.CALIB_SCHEMA}")
    print(f"pinned calib:  {CAL.calib_path()} "
          f"(override ${CAL.ENV_CALIB_PATH})")
    print(f"tolerance:     {CAL.DEFAULT_TOLERANCE}")
    print(f"resolved ServiceModel: base_us={model.base_us} "
          f"per_lane_ns={model.per_lane_ns} source={meta['source'].upper()}"
          + (f" hash={meta['hash']}" if meta["hash"] else ""))
    return 0


def cmd_synth(args) -> int:
    ev = CAL.synthesize_evidence()
    jn = CAL.synthesize_journal()
    _write_json(args.out_evidence, ev)
    CAL.dump_journal_jsonl(jn, args.out_journal)
    if args.json:
        print(json.dumps({
            "metric": "dintcal", "schema": JSON_SCHEMA, "mode": "synth",
            "evidence": args.out_evidence, "journal": args.out_journal,
            "n_samples": len(ev["samples"]),
            "n_entries": len(jn["entries"])}), flush=True)
    else:
        print(f"wrote {args.out_evidence} ({len(ev['samples'])} samples, "
              f"{len(ev['waves'])} waves) and {args.out_journal} "
              f"({len(jn['entries'])} entries)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="dintcal", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("gather", help="normalize bench/exp artifacts "
                                      "into one evidence document")
    p.add_argument("artifacts", nargs="+")
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_gather)

    p = sub.add_parser("fit", help="fit ServiceModel coefficients from "
                                   "evidence and pin a calibration")
    p.add_argument("evidence")
    p.add_argument("-o", "--out", default=None,
                   help="output path (default: $DINT_CALIB_PATH, else "
                        "CALIB_H100.json at the repository's root)")
    p.add_argument("--source", default=None,
                   help="source string to record (default: the "
                        "evidence path as given)")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_fit)

    p = sub.add_parser("check",
                       help="the gate: calib_check pass + tolerance-"
                            "banded evidence drift (names the drifted "
                            "wave or coefficient)")
    p.add_argument("--calib", default=None,
                   help="check this calib file instead of the pinned one")
    p.add_argument("--evidence", default=None,
                   help="reconcile against this evidence (default: the "
                        "calib's recorded source)")
    p.add_argument("--allowlist", default=None,
                   help="allowlist JSON path (default: the port's "
                        "analysis/dintlint_allow.json)")
    p.add_argument("--sarif", metavar="PATH", default=None,
                   help="also write the findings as SARIF 2.1.0 "
                        "('-' for stdout)")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_check)

    p = sub.add_parser("audit",
                       help="replay a decision journal through the policy "
                            "functions; every recorded decision must "
                            "reproduce bit for bit")
    p.add_argument("journal")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_audit)

    p = sub.add_parser("propose",
                       help="fit a recalibration from evidence")
    p.add_argument("--calib", default=None)
    p.add_argument("--evidence", default=None)
    p.add_argument("-o", "--out", default=None,
                   help="proposed calib path "
                        "(default: CALIB.proposed.json)")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_propose)

    p = sub.add_parser("describe", help="schemas, paths, tolerance and "
                                        "the resolved ServiceModel")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_describe)

    p = sub.add_parser("synth",
                       help="write the deterministic evidence and journal "
                            "(the JAX package's fixtures) where told")
    p.add_argument("--out-evidence", required=True)
    p.add_argument("--out-journal", required=True)
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_synth)

    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except (OSError, ValueError) as e:
        print(f"dintcal: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
