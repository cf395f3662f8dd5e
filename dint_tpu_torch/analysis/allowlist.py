"""dintlint allowlist: structured suppression of known-benign findings.

A lint gate is only usable if a *reviewed* exception can be recorded
without weakening the pass for everyone else. The allowlist is a JSON file
(default: dint_tpu_torch/analysis/dintlint_allow.json) holding a list of
entries:

    [{"pass": "purity",                # required: pass name
      "code": "nonzero",               # required: finding code ("*" = any)
      "target": "tatp_dense/block",    # optional: target name ("*" = any)
      "site": "engines/tatp_dense.py", # optional: substring of the site
      "reason": "the default route's install filters its lanes"},
     ...]

`reason` is mandatory — an unexplained suppression is itself a lint error
(`allowlist/missing-reason`). Matching is conjunctive over the given
fields; matched findings stay in the report flagged `allowed` (and exempt
from the exit code), so a suppression never silently disappears. Unused
entries are reported (`allowlist/unused-entry`, warning) so the file
cannot accrete stale exceptions.
"""
from __future__ import annotations

import json

from .core import Finding, SEV_ERROR, SEV_WARNING


class AllowlistError(ValueError):
    pass


def load(path: str) -> list[dict]:
    """Parse + validate an allowlist file; raises AllowlistError with the
    offending entry on malformed input."""
    with open(path) as f:
        entries = json.load(f)
    if not isinstance(entries, list):
        raise AllowlistError(f"{path}: top level must be a JSON list")
    for i, e in enumerate(entries):
        if not isinstance(e, dict):
            raise AllowlistError(f"{path}: entry {i} is not an object")
        for req in ("pass", "code"):
            if req not in e:
                raise AllowlistError(f"{path}: entry {i} missing '{req}'")
        if not str(e.get("reason", "")).strip():
            raise AllowlistError(
                f"{path}: entry {i} ({e.get('pass')}/{e.get('code')}) has "
                "no 'reason' — unexplained suppressions are not accepted")
        e.setdefault("_used", False)
    return entries


def _matches(entry: dict, f: Finding) -> bool:
    if entry["pass"] not in ("*", f.pass_name):
        return False
    if entry["code"] not in ("*", f.code):
        return False
    tgt = entry.get("target", "*")
    if tgt not in ("*", f.target):
        return False
    site = entry.get("site")
    if site and site not in f.site:
        return False
    return True


def prune_entries(entries: list[dict]) -> tuple[list[dict], list[dict]]:
    """Split entries into (kept, dropped) by the `_used` flag `apply` set:
    an entry that matched no finding on a FULL run is stale and gets
    dropped. Callers must have run apply() over the complete matrix first
    — pruning against a subset run would drop entries whose findings
    simply were not traced."""
    kept = [e for e in entries if e.get("_used")]
    dropped = [e for e in entries if not e.get("_used")]
    return kept, dropped


def prune_scoped(entries: list[dict], pass_name: str
                 ) -> tuple[list[dict], list[dict]]:
    """Gate-scoped prune (dintcost/dintdur/dintplan --prune-allowlist):
    split (kept, dropped) considering ONLY entries pinned to
    ``pass_name``. Callers must have run apply() over that gate's FULL
    target matrix first. Entries for other passes — and wildcard-pass
    ("*") entries, whose findings may live in gates this run never
    traced — are always kept; dropping them is dintlint
    --prune-allowlist's job (the full-suite run)."""
    dropped = [e for e in entries
               if e["pass"] == pass_name and not e.get("_used")]
    drop_ids = {id(e) for e in dropped}
    kept = [e for e in entries if id(e) not in drop_ids]
    return kept, dropped


def save(path: str, entries: list[dict]) -> None:
    """Rewrite an allowlist file (private `_`-prefixed bookkeeping keys
    stripped), one entry per line like the hand-maintained original."""
    clean = [{k: v for k, v in e.items() if not k.startswith("_")}
             for e in entries]
    with open(path, "w") as f:
        if not clean:
            f.write("[]\n")
            return
        f.write("[\n")
        for i, e in enumerate(clean):
            sep = "," if i + 1 < len(clean) else ""
            f.write("  " + json.dumps(e) + sep + "\n")
        f.write("]\n")


def apply(findings: list[Finding], entries: list[dict],
          check_unused: bool = True) -> list[Finding]:
    """Mark findings matched by an entry as allowed (in place) and append
    hygiene findings for unused entries (skipped when the run covered only
    a subset of targets — an entry for an untraced target is not stale).
    Returns the combined list."""
    for f in findings:
        for e in entries:
            if _matches(e, f):
                f.allowed_by = str(e["reason"])
                e["_used"] = True
                break
    extra = []
    for e in entries:
        if check_unused and not e.get("_used"):
            extra.append(Finding(
                "allowlist", "unused-entry", SEV_WARNING, "(allowlist)",
                f"allowlist entry {e['pass']}/{e['code']} "
                f"(target={e.get('target', '*')}) matched nothing — stale "
                "suppressions must be deleted",
                suggestion="remove the entry; if the finding moved, update "
                           "its target/site fields"))
    return findings + extra
