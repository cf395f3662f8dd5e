"""Shared scaffolding of the port's gate CLIs (dint_tpu_torch/dintlint.py,
dintcost.py and dintdur.py).

Every gate CLI repeats one harness: default the allowlist to the port's
analysis/dintlint_allow.json, validate --target/--pass names into an
exit-2 usage error that lists the registry (never a traceback), export
findings as SARIF 2.1.0 through the one serializer, run the gate-scoped
--prune-allowlist [--check] flow with one wording, emit the same --json
payload keys, and map outcomes onto the 0/1/2 exit discipline:

    0  gate passed (no unsuppressed error-severity finding, no stale
       allowlist entry under --prune-allowlist --check)
    1  gate failed (offenders named on stdout)
    2  usage / artifact errors (argparse, OSError, ValueError)
"""
from __future__ import annotations

import json
import os

from . import DEFAULT_ALLOWLIST, to_sarif


def resolve_allowlist(explicit: str | None) -> str | None:
    """An explicit --allowlist path wins; otherwise the port's
    analysis/dintlint_allow.json when it exists, else None."""
    if explicit is None and os.path.exists(DEFAULT_ALLOWLIST):
        return DEFAULT_ALLOWLIST
    return explicit


def check_names(kind: str, names, registry) -> str | None:
    """Unknown --target/--pass = usage error (exit 2) listing what IS
    registered, never a traceback. Returns the ap.error message or None."""
    bad = [n for n in names if n not in registry]
    if not bad:
        return None
    lines = [f"unknown {kind} {n!r}" for n in bad]
    lines.append(f"registered {kind}s:")
    lines += [f"  {n}" for n in sorted(registry)]
    return "\n".join(lines)


def count_errors(findings) -> int:
    return sum(f.severity == "error" and not f.suppressed for f in findings)


def count_suppressed(findings) -> int:
    return sum(f.suppressed for f in findings)


def write_sarif(findings, prog: str, path: str) -> None:
    """Serialize findings via the SARIF 2.1.0 exporter; '-' prints to
    stdout, anything else is written with a trailing newline."""
    sarif = json.dumps(to_sarif(findings, prog), indent=1)
    if path == "-":
        print(sarif, flush=True)
    else:
        with open(path, "w") as fh:
            fh.write(sarif + "\n")


def gate_payload(metric: str, schema: int, mode: str, targets,
                 allowlist, findings, stale: bool, failed: bool,
                 **extra) -> dict:
    """The check/report --json payload keys of the single-pass gates
    (dintcost schema 3, dintdur schema 2); gate keys ride in **extra."""
    payload = {
        "metric": metric, "schema": schema, "mode": mode,
        "targets": targets, "allowlist": allowlist,
        "n_findings": len(findings),
        "n_errors": count_errors(findings),
        "n_suppressed": count_suppressed(findings),
        "stale_allowlist": stale,
        "ok": not failed,
    }
    payload.update(extra)
    payload["findings"] = [f.to_dict() for f in findings]
    return payload


def print_findings(findings, prog: str, failed: bool,
                   show_suppressed: bool = True) -> None:
    """The human report: one line a finding and the summary line."""
    for f in findings:
        print(f)
    n_err = count_errors(findings)
    if show_suppressed:
        print(f"{prog}: {len(findings)} finding(s), {n_err} error(s), "
              f"{count_suppressed(findings)} suppressed -> "
              f"{'FAIL' if failed else 'ok'}", flush=True)
    else:
        print(f"{prog}: {len(findings)} finding(s), {n_err} error(s) "
              f"-> {'FAIL' if failed else 'ok'}", flush=True)


def prune_scoped_gate(args, ap, pass_name: str, allowlist: str | None):
    """The --prune-allowlist [--check] flow of a single-pass gate: run the
    gate's FULL target matrix under ONLY its pass and judge stale only the
    entries pinned to that pass (another gate's entries, and wildcard-pass
    ones, belong to dintlint --prune-allowlist); rewrite the file, or
    under --check rewrite nothing and report. Returns (findings, stale)."""
    from . import run
    from . import allowlist as al
    if getattr(args, "target", None):
        ap.error("--prune-allowlist needs the gate's full matrix: "
                 "stale-entry detection over a subset run would drop "
                 "entries whose findings simply were not traced "
                 "(drop --target)")
    if not allowlist or not os.path.exists(allowlist):
        ap.error("--prune-allowlist: no allowlist file found "
                 f"(looked for {allowlist or DEFAULT_ALLOWLIST})")
    entries = al.load(allowlist)
    findings = run(passes=[pass_name], allowlist_entries=entries)
    kept, dropped = al.prune_scoped(entries, pass_name)
    stale = False
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
        n_scoped = sum(e["pass"] == pass_name for e in entries)
        print(f"{allowlist}: all {n_scoped} {pass_name} entr"
              f"{'y' if n_scoped == 1 else 'ies'} still match — "
              "nothing to prune")
    return findings, stale


def guard(prog: str, fn, *fn_args, exc=(OSError, ValueError)) -> int:
    """A main() tail: run the subcommand, and map artifact and file errors
    onto exit 2 with a `prog: message` line instead of a traceback
    (argparse already owns flag errors)."""
    import sys
    try:
        return fn(*fn_args)
    except exc as e:
        print(f"{prog}: {e}", file=sys.stderr)
        return 2
