"""dintcal CLI: the calibration and prediction-audit plane (the port of
tools/dintcal.py, over `dint_tpu_torch.monitor.calib`).

`gather` normalizes bench/exp artifacts (dintscope breakdowns, counter
snapshots, serve controller samples) into one evidence document, `fit`
pins ServiceModel coefficients from it as a schema-versioned calibration,
`audit` replays a controller decision journal through the policy
functions, verifying every recorded width/shed/hot_frac decision bit for
bit, and `propose` fits a recalibration from the pinned calibration's
evidence (or ``--evidence``).

Usage:
    python -m dint_tpu_torch.dintcal gather ART [ART...] -o evidence.json
    python -m dint_tpu_torch.dintcal fit EVIDENCE [-o CALIB.json] [--json]
    python -m dint_tpu_torch.dintcal audit JOURNAL [--json]
    python -m dint_tpu_torch.dintcal propose [--calib PATH]
        [--evidence PATH] [-o CALIB.proposed.json] [--json]
    python -m dint_tpu_torch.dintcal describe [--json]
    python -m dint_tpu_torch.dintcal synth --out-evidence PATH
        --out-journal PATH [--json]

The pinned calibration is ``$DINT_CALIB_PATH``, else ``CALIB_H100.json``
at the repository's root (`calib.calib_path`). `audit` exits 1 naming the
entry (index and block) whose recorded decision the replay does not
reproduce. Exit codes: 0 ok; 1 audit failure; 2 usage or file errors.

What differs from tools/dintcal.py: no ``check`` (it runs the static
analysis plane's ``calib_check`` pass, which is not ported); ``synth``
writes only where ``--out-evidence`` and ``--out-journal`` say, since the
default paths are the JAX package's fixtures; ``propose``'s ``repin`` is
null, since the port has no planner to re-pin PLAN.json's serve priors.
"""
from __future__ import annotations

import argparse
import json
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
            "repin": None}), flush=True)
        return 0
    print(f"wrote {out} from {evidence_path}")
    for c in ("base_us", "per_lane_ns"):
        was = f" (pinned {calib['model'][c]})" if calib else ""
        print(f"  {c:12s} {proposed['model'][c]}{was}")
    print("the port has no planner: PLAN.json's serve priors stay as they "
          "are")
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
