"""dintplan gate: the pinned PLAN_H100.json must agree with the cost model
(the port of `dint_tpu.analysis.passes.plan_check`).

The planner (analysis/plan.py) enumerates the knob lattice, prices it with
dintcost and pins the result as PLAN_H100.json; this pass fails closed
when that pinned artifact drifts from the model that justified it:

  missing-plan        no plan at the resolved path: the consumers (bench,
                      exp, serve) would silently fall back to env flags
  malformed-plan      unparseable / wrong schema / missing sections
  stale-provenance    the recorded knobs/calibration/frontier hashes no
                      longer match this tree: the registry, the
                      calibration ledger (targets.TARGET_COST) or the
                      frontier rows changed after the plan was pinned
  unknown-workload    a plan workload the planner does not declare
  unregistered-target a plan entry references a target absent from
                      analysis/targets.py
  unregistered-knob   a pinned/predicted knob absent from plan.KNOBS, or
                      holding a value outside its registered range
  flipped-ordering    re-ranking the recorded frontier prices under the
                      decision rule disagrees with the recorded ranks
                      (and, unless static mode, the same check against
                      FRESHLY derived prices)
  dominated-pin       the pinned config is statically dominated
  unjustified-pin     pinned != predicted with no written override reason
  priced-drift        (full mode only) a frontier row's recorded price,
                      its unpriced collective waves included, disagrees
                      with a fresh dintcost derivation
  env-override        an ambient DINT_* flag is SET and contradicts a
                      workload's pinned knob without DINT_PLAN_OVERRIDE=1

The whole-plan checks are global, so they anchor to ONE registered target
(plan.DEFAULT_ANCHOR, override DINT_PLAN_ANCHOR) and return [] everywhere
else: ``dintlint --all`` and ``dintplan check`` both land the findings
exactly once. DINT_PLAN_STATIC is tri-state: unset, the pass runs STATIC
(no fresh-derivation tracing; the provenance hashes still pin the
calibration ledger and the recorded prices bit for bit), which is what
every dintlint invocation gets; ``dintplan check`` exports "0" to force
the FULL fresh derivation (its default; --static exports "1").
"""
from __future__ import annotations

import os

from .. import plan as P
from ..core import Finding, SEV_ERROR, TargetTrace, register_pass

_SUGGEST_REGEN = ("regenerate with `python -m dint_tpu_torch.dintplan plan` "
                  "and review the PLAN_H100.json diff like any calibration "
                  "change")


def _err(code: str, target: str, message: str, site: str = "",
         suggestion: str = _SUGGEST_REGEN) -> Finding:
    return Finding("plan_check", code, SEV_ERROR, target, message,
                   site=site, suggestion=suggestion)


def load_plan_findings(target: str, path=None
                       ) -> tuple[dict | None, list[Finding]]:
    """(plan, findings) for the pinned plan file: missing-plan /
    malformed-plan on failure, else the parsed document."""
    path = path or P.plan_path()
    try:
        return P.load_plan(path), []
    except FileNotFoundError:
        return None, [_err(
            "missing-plan", target,
            f"no plan at {path}: bench/exp/serve knob defaults are "
            "unpinned and env-flag drift is invisible",
            site=str(path),
            suggestion="generate it with `python -m "
                       "dint_tpu_torch.dintplan plan` (or point "
                       "DINT_PLAN_PATH at the pinned copy)")]
    except (OSError, ValueError) as e:
        return None, [_err(
            "malformed-plan", target,
            f"unreadable plan at {path}: {e}", site=str(path))]


def _structure_findings(plan: dict, target: str) -> list[Finding]:
    out: list[Finding] = []
    for key in ("provenance", "workloads", "frontier", "decision_rule"):
        if key not in plan:
            out.append(_err("malformed-plan", target,
                            f"plan is missing its {key!r} section",
                            site=key))
    return out


def _provenance_findings(plan: dict, target: str) -> list[Finding]:
    out: list[Finding] = []
    prov = plan.get("provenance", {})
    for key, fresh in (("knobs_hash", P.knobs_hash()),
                       ("calibration_hash", P.calibration_hash())):
        got = prov.get(key)
        if got != fresh:
            out.append(_err(
                "stale-provenance", target,
                f"recorded {key} {got!r} != current {fresh!r}: the "
                + ("knob registry / workload lattice / decision rule"
                   if key == "knobs_hash" else
                   "calibration ledger (targets.TARGET_COST)")
                + " changed after the plan was pinned", site=key))
    rows = plan.get("frontier", [])
    if isinstance(rows, list) and rows:
        fresh = P.frontier_hash(rows)
        if prov.get("cost_model_hash") != fresh:
            out.append(_err(
                "stale-provenance", target,
                f"recorded cost_model_hash {prov.get('cost_model_hash')!r}"
                f" is not the digest of the recorded frontier ({fresh!r})"
                ": rows were edited without re-pinning provenance",
                site="cost_model_hash"))
    return out


def _registry_findings(plan: dict, target: str) -> list[Finding]:
    from .. import targets as T
    out: list[Finding] = []
    declared = {w.name for w in P.WORKLOADS}
    for wname, entry in sorted(plan.get("workloads", {}).items()):
        if wname not in declared:
            out.append(_err(
                "unknown-workload", target,
                f"plan workload {wname!r} is not declared in "
                "plan.WORKLOADS", site=wname))
            continue
        for key in ("target", "predicted_target"):
            t = entry.get(key)
            if t not in T.TARGETS:
                out.append(_err(
                    "unregistered-target", target,
                    f"workload {wname}: {key} {t!r} is not a registered "
                    "analysis target", site=f"{wname}.{key}"))
        for field in ("pinned", "predicted"):
            for kname, val in sorted((entry.get(field) or {}).items()):
                knob = P.KNOBS.get(kname)
                if knob is None:
                    out.append(_err(
                        "unregistered-knob", target,
                        f"workload {wname}: {field} references unknown "
                        f"knob {kname!r}", site=f"{wname}.{field}.{kname}"))
                elif knob.kind in ("flag01", "flag1", "bool") \
                        and val not in knob.values:
                    out.append(_err(
                        "unregistered-knob", target,
                        f"workload {wname}: {field} pins {kname}={val!r}, "
                        f"outside its registered values {knob.values}",
                        site=f"{wname}.{field}.{kname}"))
    for row in plan.get("frontier", []):
        t = row.get("target")
        if t not in T.TARGETS:
            out.append(_err(
                "unregistered-target", target,
                f"frontier row {row.get('workload')}/{t!r} is not a "
                "registered analysis target", site=str(t)))
    return out


_PRICE_KEYS = ("dispatches_per_step", "bytes_per_step", "footprint_bytes",
               "ici_bytes_per_step", "dcn_bytes_per_step")
# compared by priced-drift besides the numbers (the port's one schema
# addition: the collective waves a mesh row's model leaves unpriced)
_DRIFT_KEYS = _PRICE_KEYS + ("unpriced_waves",)


def _rerank_findings(plan: dict, target: str,
                     prices: dict[str, dict] | None = None,
                     label: str = "recorded") -> list[Finding]:
    """Re-run dominance + the decision rule over the frontier under
    `prices` (target -> price dict; default: the rows' own recorded
    prices) and diff against what the plan pinned."""
    out: list[Finding] = []
    by_wl: dict[str, list[dict]] = {}
    for row in plan.get("frontier", []):
        fresh = dict(row)
        if prices is not None:
            if row.get("target") not in prices:
                continue
            fresh.update(prices[row["target"]])
        by_wl.setdefault(row.get("workload", "?"), []).append(fresh)
    for wname, rows in sorted(by_wl.items()):
        if any(k not in r for r in rows for k in _PRICE_KEYS):
            continue                    # malformed rows reported elsewhere
        P.rank_rows(rows)
        entry = plan.get("workloads", {}).get(wname, {})
        for row in rows:
            orig = next(r for r in plan["frontier"]
                        if r.get("workload") == wname
                        and r.get("target") == row["target"])
            if (orig.get("rank"), bool(orig.get("dominated"))) \
                    != (row["rank"], row["dominated"]):
                out.append(_err(
                    "flipped-ordering", target,
                    f"workload {wname}: {row['target']} ranks "
                    f"{row['rank']} (dominated={row['dominated']}) under "
                    f"the decision rule on {label} prices, but the plan "
                    f"records rank {orig.get('rank')} "
                    f"(dominated={bool(orig.get('dominated'))}) — the "
                    "priced ordering flipped", site=row["target"]))
        pinned_t = entry.get("target")
        pin = next((r for r in rows if r["target"] == pinned_t), None)
        if pin is not None and pin["dominated"]:
            out.append(_err(
                "dominated-pin", target,
                f"workload {wname}: pinned config {pinned_t} is "
                f"statically dominated by {pin['dominated_by']} "
                f"(strictly worse on bytes AND dispatches AND footprint "
                f"under {label} prices)", site=pinned_t,
                suggestion="pin the dominating config (or justify the "
                           "regression in targets.TARGET_COST and "
                           "regenerate)"))
        want = min((r for r in rows if not r["dominated"]),
                   key=lambda r: (P.decision_key(r), r["target"]),
                   default=None)
        pred_t = entry.get("predicted_target")
        if want is not None and pred_t is not None \
                and want["target"] != pred_t:
            out.append(_err(
                "flipped-ordering", target,
                f"workload {wname}: decision rule on {label} prices "
                f"picks {want['target']}, plan records predicted "
                f"{pred_t} — the pick no longer follows from the model",
                site=str(pred_t)))
    return out


def _pin_findings(plan: dict, target: str) -> list[Finding]:
    out: list[Finding] = []
    for wname, entry in sorted(plan.get("workloads", {}).items()):
        pinned = entry.get("pinned") or {}
        predicted = entry.get("predicted") or {}
        reasons = {o.get("knob"): o.get("reason")
                   for o in entry.get("overrides", [])}
        for kname in sorted(set(pinned) & set(predicted)):
            if pinned[kname] == predicted[kname]:
                continue
            if not (reasons.get(kname) or "").strip():
                out.append(_err(
                    "unjustified-pin", target,
                    f"workload {wname}: pins {kname}={pinned[kname]!r} "
                    f"against the predicted {predicted[kname]!r} with no "
                    "written override reason",
                    site=f"{wname}.{kname}",
                    suggestion="add the measured justification to "
                               "plan.MEASURED_OVERRIDES and regenerate"))
    return out


def drift_findings(plan: dict, target: str, pricer=None) -> list[Finding]:
    """Full mode: a fresh derivation per frontier row (``pricer(target)``,
    default the memoized CPU trace), priced-drift on any mismatch, then
    re-rank under the fresh prices."""
    pricer = pricer or P._price_target
    out: list[Finding] = []
    prices: dict[str, dict] = {}
    for row in plan.get("frontier", []):
        t = row.get("target")
        try:
            fresh = pricer(t)
        except Exception as e:      # noqa: BLE001 — untraceable here
            out.append(_err(
                "priced-drift", target,
                f"frontier row {row.get('workload')}/{t}: fresh cost "
                f"derivation failed: {e}", site=str(t)))
            continue
        prices[t] = fresh
        diffs = [f"{k} {row.get(k)!r} -> {fresh[k]!r}"
                 for k in _DRIFT_KEYS if row.get(k) != fresh[k]]
        if diffs:
            out.append(_err(
                "priced-drift", target,
                f"frontier row {row.get('workload')}/{t}: recorded price "
                f"drifted from the fresh derivation ({'; '.join(diffs)})",
                site=str(t)))
    out += _rerank_findings(plan, target, prices=prices, label="fresh")
    return out


def _env_findings(plan: dict, target: str, environ=None) -> list[Finding]:
    env = os.environ if environ is None else environ
    if P.override_active(env):
        return []
    out = []
    for wname, kname, pinned, got in P.contradictions(plan, env):
        knob = P.KNOBS[kname]
        out.append(_err(
            "env-override", target,
            f"{knob.env}={env.get(knob.env)!r} resolves {kname}={got!r} "
            f"but workload {wname} pins {pinned!r}: ambient flags no "
            "longer override the plan silently",
            site=f"{wname}.{kname}",
            suggestion="run with DINT_PLAN_OVERRIDE=1 to acknowledge the "
                       "override (artifacts will record it), or drop "
                       f"the {knob.env} flag"))
    return out


def check_plan(plan: dict, target: str, *, static: bool = False,
               environ=None, pricer=None) -> list[Finding]:
    """Every plan_check finding for a parsed plan document (the fixture
    tests feed mutated documents straight in here)."""
    out = _structure_findings(plan, target)
    if out:
        return out
    out += _provenance_findings(plan, target)
    out += _registry_findings(plan, target)
    out += _rerank_findings(plan, target)
    out += _pin_findings(plan, target)
    out += _env_findings(plan, target, environ)
    if not static and not any(f.code == "unregistered-target"
                              for f in out):
        out += drift_findings(plan, target, pricer)
    return out


def _anchor() -> str:
    return os.environ.get(P.ENV_PLAN_ANCHOR, P.DEFAULT_ANCHOR)


@register_pass("plan_check")
def plan_check(trace: TargetTrace) -> list[Finding]:
    """Verifies the pinned PLAN_H100.json against the knob registry, the
    calibration ledger and the dintcost-derived frontier (whole-plan
    checks, anchored to one target)."""
    if trace.name != _anchor():
        return []
    plan, findings = load_plan_findings(trace.name)
    if plan is None:
        return findings
    # embedded in the dintlint suite the pass runs STATIC by default;
    # `dintplan check`, the full gate, exports DINT_PLAN_STATIC=0
    static = os.environ.get(P.ENV_PLAN_STATIC, "1") != "0"
    return findings + check_plan(plan, trace.name, static=static)
