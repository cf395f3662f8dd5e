"""dintmut gate: the pinned MUTCOV_TORCH.json must stay true and
sufficient (the port of `dint_tpu.analysis.passes.mut_check`).

analysis/mutate.py corrupts the traced engines with registered operators
and records which pass killed each mutant; this pass fails closed when
that pinned evidence goes missing, stale, or stops clearing the policy
bar:

  missing-mutcov      no artifact at the resolved path (``$DINT_MUTCOV``,
                      else MUTCOV_TORCH.json at the repo root; the
                      reference's MUTCOV.json is never read)
  malformed-mutcov    unparseable / wrong schema / missing sections, or a
                      cell with an unknown verdict
  stale-provenance    the recorded registry/matrix/cells hashes no
                      longer match this tree
  summary-drift       the recorded summary (or the pinned quick sample)
                      is not what the recorded cells recompute to
  kill-rate-floor     kill rate over the matrix below
                      mutate.KILL_RATE_FLOOR (never lowered)
  survivor            one ERROR per surviving mutant: a corruption no
                      gate sees. Triage = an allowlist entry pinned to
                      the cell id ({"pass": "mut_check", "code":
                      "survivor", "site": "<cell id>", "reason": ...});
                      the written reason is the documentation
  mutant-crashed      a mutant crashed a pass (or its own edit): the
                      analyzer, not a gate, stopped it — never a kill
  operator-dormant    an operator assigned in the matrix produced no
                      cell: its finder found no site anywhere
  attribution-gap     no kill attributed to one of the required families
                      (protocol, durability, cost_budget, and a core
                      structural pass)
  ring-triage-drift   a ring-shrink cell no longer records a standing
                      ``durability/no-ring-truncation`` suppression, or
                      the allowlist lost those entries while cells cite
                      them

The whole-artifact checks anchor to ONE target (DEFAULT_ANCHOR, override
``$DINT_MUT_ANCHOR``) and return [] everywhere else, so ``dintlint
--all`` and ``dintmut check`` land them once. Inside dintlint the pass is
static: hashes and recorded cells, no mutant re-run (``python -m
dint_tpu_torch.dintmut check [--quick]`` re-runs them).
"""
from __future__ import annotations

import json
import os

from .. import mutate as M
from ..core import Finding, SEV_ERROR, TargetTrace, register_pass

DEFAULT_ANCHOR = "tatp_dense/block"
ENV_MUT_ANCHOR = "DINT_MUT_ANCHOR"

# the port's allowlist (analysis/dintlint_allow.json)
_ALLOWLIST = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "dintlint_allow.json")

# the ring-family operators whose cells must cite the standing
# durability/no-ring-truncation suppressions
_RING_OPS = ("ring-shrink",)
_RING_ENTRY = "durability/no-ring-truncation"

# the acceptance bar: one kill attributed to each family; "core" is any
# structural pass outside the protocol/durability/cost planes
_CORE_PASSES = frozenset({"scatter_race", "aliasing", "purity",
                          "u64_overflow", "shard_consistency"})
_REQUIRED_FAMILIES = (("protocol", ("protocol",)),
                      ("durability", ("durability",)),
                      ("cost_budget", ("cost_budget",)),
                      ("core dintlint", tuple(sorted(_CORE_PASSES))))

_SUGGEST_REGEN = ("regenerate with `python -m dint_tpu_torch.dintmut run` "
                  "and review the MUTCOV_TORCH.json diff like any gate "
                  "change")

_CELL_KEYS = ("id", "target", "operator", "site", "note", "verdict",
              "killer", "new_errors", "suppressed")
_VERDICTS = ("killed", "survived", "crashed")


def _err(code: str, target: str, message: str, site: str = "",
         suggestion: str = _SUGGEST_REGEN) -> Finding:
    return Finding("mut_check", code, SEV_ERROR, target, message,
                   site=site, suggestion=suggestion)


def load_mutcov_findings(target: str, path=None
                         ) -> tuple[dict | None, list[Finding]]:
    """(doc, findings) for the pinned artifact: missing-mutcov /
    malformed-mutcov on failure, else the parsed document."""
    path = path or M.mutcov_path()
    try:
        return M.load_mutcov(path), []
    except FileNotFoundError:
        return None, [_err(
            "missing-mutcov", target,
            f"no mutation-coverage artifact at {path}: the gates' kill "
            "claims are backed by nothing machine-checked",
            site=str(path),
            suggestion="generate it with `python -m dint_tpu_torch.dintmut "
                       "run` (or point DINT_MUTCOV at the pinned copy)")]
    except (OSError, ValueError, json.JSONDecodeError) as e:
        return None, [_err(
            "malformed-mutcov", target,
            f"unreadable MUTCOV at {path}: {e}", site=str(path))]


def _structure_findings(doc: dict, target: str) -> list[Finding]:
    out: list[Finding] = []
    for key in ("provenance", "cells", "summary", "quick", "operators",
                "targets"):
        if key not in doc:
            out.append(_err("malformed-mutcov", target,
                            f"MUTCOV is missing its {key!r} section",
                            site=key))
    cells = doc.get("cells")
    for c in cells if isinstance(cells, list) else []:
        missing = [k for k in _CELL_KEYS
                   if not isinstance(c, dict) or k not in c]
        if missing:
            cid = c.get("id", "?") if isinstance(c, dict) else "?"
            out.append(_err(
                "malformed-mutcov", target,
                f"cell {cid!r} is missing {missing}", site=str(cid)))
    return out


def _provenance_findings(doc: dict, target: str) -> list[Finding]:
    out: list[Finding] = []
    prov = doc.get("provenance", {})
    for key, fresh, what in (
            ("registry", M.registry_hash(),
             "operator registry / pass matrix / policy knobs"),
            ("matrix", M.matrix_hash(),
             "MUT_TARGETS matrix (targets, protocols, operator sets)"),
            ("cells", M._digest(doc.get("cells", [])),
             "recorded cell rows")):
        got = prov.get(key)
        if got != fresh:
            out.append(_err(
                "stale-provenance", target,
                f"recorded {key} hash {got!r} != current {fresh!r}: the "
                f"{what} changed after MUTCOV was pinned", site=key))
    return out


def _summary_findings(doc: dict, target: str) -> list[Finding]:
    out: list[Finding] = []
    cells = doc.get("cells", [])
    fresh = M._summary(cells)
    if doc.get("summary") != fresh:
        rec = doc.get("summary") or {}
        diffs = [f"{k}: {rec.get(k)!r} -> {fresh[k]!r}"
                 for k in fresh if rec.get(k) != fresh[k]]
        out.append(_err(
            "summary-drift", target,
            "recorded summary is not what the recorded cells recompute "
            f"to ({'; '.join(diffs)})", site="summary"))
    quick = doc.get("quick", {})
    want = M.quick_sample(cells, quick.get("seed", M.QUICK_SEED))
    if quick.get("cells") != want:
        out.append(_err(
            "summary-drift", target,
            f"pinned quick sample {quick.get('cells')!r} is not what "
            f"seed {quick.get('seed')!r} draws from the recorded cells "
            f"({want!r})", site="quick"))
    return out


def _policy_findings(doc: dict, target: str) -> list[Finding]:
    out: list[Finding] = []
    cells = doc.get("cells", [])
    summary = M._summary(cells)
    floor = doc.get("kill_rate_floor", M.KILL_RATE_FLOOR)
    floor = max(floor, M.KILL_RATE_FLOOR)
    if summary["kill_rate"] < floor:
        out.append(_err(
            "kill-rate-floor", target,
            f"kill rate {summary['kill_rate']:.2%} over "
            f"{summary['n_cells']} mutants fell below the {floor:.0%} "
            "floor: the gates stopped catching what they claim",
            site="kill_rate",
            suggestion="strengthen the losing pass (see the surviving "
                       "cells' operators) — do not lower the floor"))
    for c in cells:
        verdict = c.get("verdict")
        if verdict == "survived":
            out.append(_err(
                "survivor", target,
                f"mutant {c.get('id')} ({c.get('operator')}: "
                f"{c.get('note')}) survived every gate — a corruption "
                "the static plane cannot see", site=str(c.get("id")),
                suggestion="either write the pass that kills it, or "
                           "triage it as a documented non-goal with an "
                           "allowlist entry pinned to this cell id "
                           "(reason required) — never silence"))
        elif verdict == "crashed":
            out.append(_err(
                "mutant-crashed", target,
                f"mutant {c.get('id')} ({c.get('operator')}: "
                f"{c.get('note')}) crashed the analysis "
                f"({', '.join(c.get('new_errors') or [])}): a crash is "
                "not a kill", site=str(c.get("id")),
                suggestion="keep the mutant walkable (placeholders with a "
                           "meta value) or fix the pass that crashed"))
        elif verdict not in _VERDICTS:
            out.append(_err(
                "malformed-mutcov", target,
                f"cell {c.get('id')!r} has unknown verdict {verdict!r}",
                site=str(c.get("id"))))
    assigned = {op for t in doc.get("targets", {}).values()
                for op in t.get("operators", [])}
    live = {c.get("operator") for c in cells}
    for op in sorted(assigned - live):
        out.append(_err(
            "operator-dormant", target,
            f"operator {op!r} is assigned in the target matrix but "
            "produced no cells: its finder located no sites anywhere, "
            "so that corruption class is no longer exercised", site=op))
    killers = set(summary["killer_passes"])
    for fam, passes in _REQUIRED_FAMILIES:
        if not killers & set(passes):
            out.append(_err(
                "attribution-gap", target,
                f"no kill is attributed to the {fam} family "
                f"({'/'.join(passes)}): the matrix no longer proves that "
                "plane bites", site=fam))
    return out


def _ring_findings(doc: dict, target: str, allow_path=None
                   ) -> list[Finding]:
    """The ring cells must record a standing durability/no-ring-truncation
    suppression, and those entries must exist while cells cite them."""
    out: list[Finding] = []
    ring_cells = [c for c in doc.get("cells", [])
                  if c.get("operator") in _RING_OPS]
    for c in ring_cells:
        if _RING_ENTRY not in (c.get("suppressed") or []):
            out.append(_err(
                "ring-triage-drift", target,
                f"ring cell {c.get('id')} no longer records the standing "
                f"{_RING_ENTRY} suppression: either log truncation landed "
                "(retire the allowlist entries and re-pin) or the "
                "truncation facts broke", site=str(c.get("id"))))
    if not ring_cells:
        return out
    path = allow_path or _ALLOWLIST
    try:
        with open(path) as fh:
            entries = json.load(fh)
    except (OSError, ValueError):
        return out                  # allowlist health is dintlint's job
    standing = any(isinstance(e, dict) and e.get("pass") == "durability"
                   and e.get("code") == "no-ring-truncation"
                   for e in entries)
    if not standing:
        out.append(_err(
            "ring-triage-drift", target,
            f"MUTCOV ring cells still cite {_RING_ENTRY} but no such "
            f"entry is left in {os.path.basename(path)}: re-run the "
            "matrix so the cells reflect the retired suppression",
            site=_RING_ENTRY))
    return out


def check_mutcov(doc: dict, target: str, *, allow_path=None
                 ) -> list[Finding]:
    """Every mut_check finding for a parsed document (the fixture tests
    feed mutated documents straight in here)."""
    out = _structure_findings(doc, target)
    if out:
        return out
    out += _provenance_findings(doc, target)
    out += _summary_findings(doc, target)
    out += _policy_findings(doc, target)
    out += _ring_findings(doc, target, allow_path)
    return out


def _anchor() -> str:
    return os.environ.get(ENV_MUT_ANCHOR, DEFAULT_ANCHOR)


@register_pass("mut_check")
def mut_check(trace: TargetTrace) -> list[Finding]:
    """Verifies the pinned MUTCOV_TORCH.json against the operator
    registry, the target matrix and the kill-rate/triage policy
    (whole-artifact checks anchored to one target; static)."""
    if trace.name != _anchor():
        return []
    doc, findings = load_mutcov_findings(trace.name)
    if doc is None:
        return findings
    return findings + check_mutcov(doc, trace.name)
