"""Shared scaffolding of the port's gate CLIs (dint_tpu_torch/dintlint.py
now; the model-level gates of ROADMAP §A.8 will share it).

Every gate CLI repeats one harness: default the allowlist to the port's
analysis/dintlint_allow.json, validate --target/--pass names into an
exit-2 usage error that lists the registry (never a traceback), export
findings as SARIF 2.1.0 through the one serializer, and map outcomes onto
the 0/1/2 exit discipline:

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
