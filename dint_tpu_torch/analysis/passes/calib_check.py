"""dintcal gate: the pinned CALIB_H100.json must agree with its own evidence
(the port of `dint_tpu.analysis.passes.calib_check`).

The calibration plane (monitor/calib.py) fits ServiceModel coefficients
from measured evidence and pins them as CALIB_H100.json; PLAN_H100.json's
serve rows then price capacity with those coefficients. This pass fails
closed when the pinned calibration drifts from the evidence that
justified it, or when the plan and the calibration disagree about which
model priced the serve rows:

  malformed-calib     unparseable / wrong schema / missing sections /
                      non-finite coefficients
  stale-provenance    the recorded calib_hash is not the digest of the
                      pinned content (rows edited without re-pinning), or
                      the recorded evidence_hash no longer matches the
                      named source evidence file
  unfit-model         refitting the EMBEDDED samples does not reproduce
                      the pinned coefficients bit for bit (the fit is
                      closed-form and deterministic, so any inequality
                      means the coefficients were hand-edited)
  unregistered-wave   a pinned wave row names a wave with no bytes
                      formula in the port's monitor/waves.WAVE_BYTES, or
                      its pinned implied GB/s disagrees with its own
                      (ms_per_step, bytes_per_step) row
  plan-model-drift    the plan's serve rows were priced with a model
                      other than the resolver would pick now: source
                      "calib" with a different hash than the pinned
                      calibration, or source "defaults" while a valid
                      calibration exists
  missing-calib       the plan's serve rows record source "calib" but no
                      readable calibration is present

Anchored like plan_check: whole-artifact checks land on ONE registered
target (plan.DEFAULT_ANCHOR / DINT_PLAN_ANCHOR) and return [] elsewhere.
When NEITHER a calibration nor a calib-sourced plan row exists the pass
returns []: calibration is opt-in, and the gate bites once one is pinned.
The files are the port's: `calib.calib_path()` (CALIB_H100.json) and
`plan.plan_path()` (PLAN_H100.json).
"""
from __future__ import annotations

import math
import os
from pathlib import Path

from ...monitor import calib as CAL
from .. import plan as P
from ..core import Finding, SEV_ERROR, TargetTrace, register_pass

_SUGGEST_REFIT = ("refit with `python -m dint_tpu_torch.dintcal fit "
                  "<evidence> -o CALIB_H100.json` and re-pin the plan with "
                  "`python -m dint_tpu_torch.dintplan plan --calib "
                  "CALIB_H100.json`")


def _err(code: str, target: str, message: str, site: str = "",
         suggestion: str = _SUGGEST_REFIT) -> Finding:
    return Finding("calib_check", code, SEV_ERROR, target, message,
                   site=site, suggestion=suggestion)


def load_calib_findings(target: str, path=None
                        ) -> tuple[dict | None, list[Finding]]:
    """(calib, findings): None + [] when absent (calibration is opt-in),
    None + malformed-calib when present but unreadable."""
    path = path or CAL.calib_path()
    try:
        return CAL.load_calib(path), []
    except FileNotFoundError:
        return None, []
    except (OSError, ValueError) as e:
        return None, [_err("malformed-calib", target,
                           f"unreadable calibration at {path}: {e}",
                           site=str(path))]


def _structure_findings(calib: dict, target: str) -> list[Finding]:
    out: list[Finding] = []
    for key in ("model", "fit", "samples", "waves", "tolerance",
                "provenance"):
        if key not in calib:
            out.append(_err("malformed-calib", target,
                            f"calibration is missing its {key!r} "
                            "section", site=key))
    if out:
        return out
    for coeff in ("base_us", "per_lane_ns"):
        v = calib["model"].get(coeff)
        if not isinstance(v, (int, float)) or not math.isfinite(v):
            out.append(_err("malformed-calib", target,
                            f"model.{coeff} is {v!r}, not a finite "
                            "coefficient", site=f"model.{coeff}"))
    return out


def _provenance_findings(calib: dict, target: str,
                         source_dir=None) -> list[Finding]:
    out: list[Finding] = []
    prov = calib.get("provenance", {})
    fresh = CAL.calib_hash(calib)
    if prov.get("calib_hash") != fresh:
        out.append(_err(
            "stale-provenance", target,
            f"recorded calib_hash {prov.get('calib_hash')!r} is not the "
            f"digest of the pinned content ({fresh!r}): model/fit/"
            "samples/waves were edited without re-pinning",
            site="calib_hash"))
    src = calib.get("source")
    if src:
        spath = Path(src)
        if not spath.is_absolute() and source_dir is not None:
            spath = Path(source_dir) / spath
        try:
            ev = CAL.load_evidence(spath)
        except (OSError, ValueError):
            ev = None           # archived evidence may be off-tree: skip
        if ev is not None \
                and prov.get("evidence_hash") != CAL._digest(ev):
            out.append(_err(
                "stale-provenance", target,
                f"recorded evidence_hash {prov.get('evidence_hash')!r} "
                f"no longer matches the source evidence {src}: the "
                "evidence changed after the fit was pinned",
                site="evidence_hash"))
    return out


def _fit_findings(calib: dict, target: str) -> list[Finding]:
    try:
        refit = CAL.fit_service_model(calib.get("samples", []))
    except ValueError as e:
        return [_err("unfit-model", target,
                     f"embedded samples are unfittable: {e}",
                     site="samples")]
    out: list[Finding] = []
    for coeff in ("base_us", "per_lane_ns"):
        if refit[coeff] != calib["model"].get(coeff):
            out.append(_err(
                "unfit-model", target,
                f"refitting the embedded samples gives {coeff}="
                f"{refit[coeff]!r}, pinned {calib['model'].get(coeff)!r}"
                " — the deterministic closed-form fit does not reproduce"
                " the pinned coefficient", site=f"model.{coeff}"))
    return out


def _wave_findings(calib: dict, target: str) -> list[Finding]:
    from ...monitor import waves as W
    out: list[Finding] = []
    for name, row in sorted((calib.get("waves") or {}).items()):
        if name not in W.WAVE_BYTES:
            out.append(_err(
                "unregistered-wave", target,
                f"pinned wave {name!r} has no bytes formula in "
                "monitor/waves.WAVE_BYTES: nothing predicts its bytes, "
                "so its implied GB/s reconciles nothing", site=name))
            continue
        ms, by, gbps = (row.get("ms_per_step"), row.get("bytes_per_step"),
                        row.get("gbps"))
        if not ms or not by or gbps is None:
            out.append(_err(
                "unregistered-wave", target,
                f"pinned wave {name!r} row is incomplete "
                f"(ms_per_step={ms!r}, bytes_per_step={by!r}, "
                f"gbps={gbps!r})", site=name))
            continue
        want = round(CAL.implied_gbps(ms, by), 6)
        if want != gbps:
            out.append(_err(
                "unregistered-wave", target,
                f"pinned wave {name!r} records {gbps} GB/s but its own "
                f"(ms_per_step, bytes_per_step) implies {want} GB/s",
                site=name))
    return out


def _plan_model_findings(calib: dict | None, target: str,
                         plan: dict | None) -> list[Finding]:
    """Cross-artifact: every serve row in the plan must have been priced
    with the model the resolver picks NOW."""
    if plan is None:
        return []
    pinned_hash = (calib or {}).get("provenance", {}).get("calib_hash")
    out: list[Finding] = []
    for wname, entry in sorted(plan.get("workloads", {}).items()):
        serve = entry.get("serve")
        if not isinstance(serve, dict):
            continue
        m = serve.get("model") or {}
        src, h = m.get("source"), m.get("hash")
        site = f"{wname}.serve.model"
        if src == "calib":
            if calib is None:
                out.append(_err(
                    "missing-calib", target,
                    f"plan workload {wname}: serve priors were priced "
                    f"with calib {h!r} but no readable calibration is "
                    "present — the plan's capacity claims are "
                    "unattributable",
                    site=site,
                    suggestion="restore the CALIB_H100.json the plan was "
                               "pinned against, or re-pin with `python "
                               "-m dint_tpu_torch.dintplan plan`"))
            elif h != pinned_hash:
                out.append(_err(
                    "plan-model-drift", target,
                    f"plan workload {wname}: serve priors were priced "
                    f"with calib {h!r} but the pinned calibration is "
                    f"{pinned_hash!r} — the calibration moved after the "
                    "plan was pinned", site=site))
        elif src == "defaults":
            if calib is not None:
                out.append(_err(
                    "plan-model-drift", target,
                    f"plan workload {wname}: serve priors were priced "
                    "with the ServiceModel DEFAULTS while a pinned "
                    f"calibration ({pinned_hash!r}) exists — the plan "
                    "ignores the calibration", site=site))
        elif src is not None:
            out.append(_err(
                "plan-model-drift", target,
                f"plan workload {wname}: serve model source {src!r} is "
                "neither 'calib' nor 'defaults'", site=site))
    return out


def check_calib_doc(calib: dict | None, target: str, *,
                    plan: dict | None = None,
                    source_dir=None) -> list[Finding]:
    """Every calib_check finding for parsed documents (the fixture tests
    feed mutated documents straight in here). `calib=None` checks only
    the cross-artifact plan side."""
    out: list[Finding] = []
    if calib is not None:
        out += _structure_findings(calib, target)
        if out:
            return out
        out += _provenance_findings(calib, target, source_dir=source_dir)
        out += _fit_findings(calib, target)
        out += _wave_findings(calib, target)
    out += _plan_model_findings(calib, target, plan)
    return out


def _anchor() -> str:
    return os.environ.get(P.ENV_PLAN_ANCHOR, P.DEFAULT_ANCHOR)


@register_pass("calib_check")
def calib_check(trace: TargetTrace) -> list[Finding]:
    """Verifies the pinned CALIB_H100.json against its embedded evidence
    and the plan's recorded model provenance (whole-artifact checks,
    anchored to one target; [] when calibration is not in use)."""
    if trace.name != _anchor():
        return []
    cpath = CAL.calib_path()
    calib, findings = load_calib_findings(trace.name, cpath)
    try:
        plan = P.load_plan(P.plan_path())
    except (OSError, ValueError):
        plan = None             # plan health is plan_check's job
    if calib is None and not findings \
            and not _plan_model_findings(None, trace.name, plan):
        return []
    return findings + check_calib_doc(
        calib, trace.name, plan=plan, source_dir=cpath.parent)
