"""dintcost gate: the derived cost model against the ledger, the budgets
and the fused twins (the port of `dint_tpu.analysis.passes.cost_budget`).

dintlint proves the hot paths are safe; this pass proves they are not
QUIETLY GETTING SLOWER. analysis/cost.py derives per-target bytes/step,
dispatches/step and persistent footprint from the traced fx graph; this
pass fails closed on:

  formula-mismatch        a wave's derived bytes left the tolerance band
                          around its waves.py formula (after the target's
                          registered wave_expect): the hand ledger and
                          the code disagree, one of them rotted
  over-dispatch-budget    more memory-op dispatches per step than the
                          target's budget: an extra unfused gather or
                          scatter slipped into the chain
  over-bytes-budget       derived bytes/step above the budget formula
                          (typically "1.25*ledger"): doubled traffic
  over-footprint-budget   the persistent footprint grew past budget: a
                          step allocates where it wrote in place (a
                          cloned table)
  fused-dispatch-dominance  an @fused target no longer strictly beats its
                          unfused twin on dispatches/step
  fused-bytes-dominance   an @fused target moves >5% more bytes than its
                          twin
  overlap-footprint       the overlap serve route's carry grew past its
                          twin's footprint plus the priced prefetch buffer
                          (targets.OVERLAP_FOOTPRINT)
  scan-bytes-dominance    an @scan store target's scan slab no longer
                          derives strictly fewer bytes per reply row than
                          its point twin pays per probe reply
                          (targets.TARGET_SCAN_TWIN)
  no-budget               (warning) a registered target has no
                          TARGET_COST row
  derivation-failed       the trace or the derivation failed

Not checked yet: the reference's ``hier-dcn-dominance`` and
``overlap-dcn-parity`` compare the link bytes a 2-D mesh target
schedules on its slow axis, and the port's in-process mesh re-indexes a
Python list (parallel/mesh.py), so no collective and no link byte shows
in a trace. Until the collectives are visible (ROADMAP §A.8.5) each
target of targets.TARGET_FLAT_TWIN or TARGET_OVERLAP_TWIN gets one INFO
``link-bytes-unchecked``, and a target whose trace runs waves whose
formula prices collectives (cost.COLLECTIVE_WAVES) one INFO
``collective-waves-unpriced`` naming them.

Every finding names the offending wave or twin in `site` and can be
silenced through the port's allowlist with a reviewed reason. Budgets
live in targets.TARGET_COST; recalibrating a number is a reviewed diff of
that table, never an edit to this pass.
"""
from __future__ import annotations

from .. import cost
from ..core import (Finding, SEV_ERROR, SEV_INFO, SEV_WARNING, TargetTrace,
                    register_pass)

# fused targets may exceed their twin's bytes by this much (the monitored
# variants' counter bumps), which buys the dispatch win
DOM_BYTES_EPS = 0.05

_REPORT = "python -m dint_tpu_torch.dintcost report"


def _budget_findings(trace: TargetTrace, meta: dict,
                     model: cost.CostModel) -> list[Finding]:
    out: list[Finding] = []
    bud = meta.get("budget") or {}
    disp = model.dispatches_per_step
    nbytes = model.bytes_per_step

    b_disp = bud.get("dispatches")
    if b_disp is not None and disp > float(b_disp) + 1e-9:
        out.append(Finding(
            "cost_budget", "over-dispatch-budget", SEV_ERROR, trace.name,
            f"{disp:g} memory-op dispatches/step, budget {b_disp:g}: an "
            "extra unfused gather/scatter entered the chain",
            site="(per-step)",
            suggestion="fuse the new op into an existing wave or "
                       "recalibrate the budget in targets.TARGET_COST "
                       "with the regression justified in the PR"))

    ledger = cost.ledger_bytes(model, meta.get("wave_expect"))
    b_bytes = cost.eval_budget_bytes(bud.get("bytes"), model.geom, ledger)
    if b_bytes is not None and nbytes > b_bytes + 1e-6:
        out.append(Finding(
            "cost_budget", "over-bytes-budget", SEV_ERROR, trace.name,
            f"{nbytes:g} derived bytes/step, budget {b_bytes:g} "
            f"(formula {bud.get('bytes')!r}, ledger {ledger:g}): row "
            "traffic grew past the declared ledger band",
            site="(per-step)",
            suggestion=f"find the widened gather/scatter with `{_REPORT} "
                       f"{trace.name}`"))

    b_fp = bud.get("footprint")
    if b_fp is not None and model.footprint_bytes > int(b_fp):
        out.append(Finding(
            "cost_budget", "over-footprint-budget", SEV_ERROR, trace.name,
            f"{model.footprint_bytes} B persistent footprint, budget "
            f"{b_fp} B: an output no longer reuses its input's storage "
            "(a table copied where the step should write in place?)",
            site="(footprint)",
            suggestion="write the table in place again, or recalibrate "
                       "with the new allocation justified"))
    return out


def _reconcile_findings(trace: TargetTrace, meta: dict,
                        model: cost.CostModel) -> list[Finding]:
    out: list[Finding] = []
    for c in cost.reconcile(model, wave_expect=meta.get("wave_expect"),
                            tol_overrides=meta.get("tol")):
        if c.ok:
            continue
        exp = f" (wave_expect {c.expect!r} applied)" if c.expect else ""
        mem = "" if c.members == (c.wave,) else \
            f" [folded: {', '.join(c.members)}]"
        out.append(Finding(
            "cost_budget", "formula-mismatch", SEV_ERROR, trace.name,
            f"derived {c.derived:g} B/step vs declared "
            f"{c.declared:g} B/step{exp} (ratio {c.ratio:.2f}, tolerance "
            f"{c.tol:g}){mem}: the waves.py formula and the traced code "
            "disagree — one of them rotted",
            site=c.wave,
            suggestion="fix the formula in monitor/waves.py if the code "
                       "is right, or the code if the ledger is; document "
                       "a real layout deviation as wave_expect in "
                       "targets.TARGET_COST"))
    return out


def _twin_model(twin: str | None) -> cost.CostModel | None:
    from .. import targets as T
    if not twin or twin not in T.TARGETS:
        return None
    model = cost.model_for(twin)
    return None if model.error else model


def _dominance_findings(trace: TargetTrace,
                        model: cost.CostModel) -> list[Finding]:
    twin = cost.fused_twin(trace.name)
    twin_model = _twin_model(twin)
    if twin_model is None:
        return []
    out: list[Finding] = []
    d, dt = model.dispatches_per_step, twin_model.dispatches_per_step
    if d >= dt:
        out.append(Finding(
            "cost_budget", "fused-dispatch-dominance", SEV_ERROR,
            trace.name,
            f"{d:g} dispatches/step vs unfused twin {twin} at {dt:g}: "
            "the megakernels no longer shrink the dispatch chain",
            site=twin,
            suggestion="a wave fell out of the fused kernels — diff "
                       f"`{_REPORT} {trace.name}` against the twin"))
    b, bt = model.bytes_per_step, twin_model.bytes_per_step
    if b > bt * (1.0 + DOM_BYTES_EPS):
        out.append(Finding(
            "cost_budget", "fused-bytes-dominance", SEV_ERROR, trace.name,
            f"{b:g} B/step vs unfused twin {twin} at {bt:g}: the fused "
            f"path moves >{DOM_BYTES_EPS:.0%} more bytes than the chain "
            "it replaces",
            site=twin,
            suggestion="the fused kernels should move the SAME logical "
                       "rows — look for a widened stream operand"))
    return out


def _link_findings(trace: TargetTrace,
                   model: cost.CostModel) -> list[Finding]:
    from .. import targets as T
    out: list[Finding] = []
    twins = [t for t in (T.TARGET_FLAT_TWIN.get(trace.name),
                         T.TARGET_OVERLAP_TWIN.get(trace.name)) if t]
    if twins:
        out.append(Finding(
            "cost_budget", "link-bytes-unchecked", SEV_INFO, trace.name,
            "hier-dcn-dominance / overlap-dcn-parity not checked: the "
            "in-process mesh's collectives re-index a Python list, so the "
            "trace shows no link byte to compare with "
            + " and ".join(twins),
            site=twins[0],
            suggestion="make the mesh's moves visible to the trace "
                       "(ROADMAP §A.8.5)"))
    if model.unpriced_waves:
        out.append(Finding(
            "cost_budget", "collective-waves-unpriced", SEV_INFO,
            trace.name,
            "waves whose waves.py formula prices collective bytes are "
            "left out of reconciliation and of the ledger (no collective "
            "shows in a trace): " + ", ".join(model.unpriced_waves),
            site=model.unpriced_waves[0],
            suggestion="make the mesh's moves visible to the trace "
                       "(ROADMAP §A.8.5)"))
    return out


def _overlap_findings(trace: TargetTrace,
                      model: cost.CostModel) -> list[Finding]:
    from .. import targets as T
    twin = T.TARGET_OVERLAP_TWIN.get(trace.name)
    twin_model = _twin_model(twin)
    if twin_model is None:
        return []
    allowance = cost.eval_budget_bytes(T.OVERLAP_FOOTPRINT, model.geom,
                                       0.0) or 0.0
    fp, fp_t = model.footprint_bytes, twin_model.footprint_bytes
    if fp > fp_t + allowance:
        return [Finding(
            "cost_budget", "overlap-footprint", SEV_ERROR, trace.name,
            f"{fp} B persistent footprint vs twin {twin} at {fp_t} B + "
            f"{allowance:g} B priced prefetch buffer "
            "(targets.OVERLAP_FOOTPRINT): the overlap carry holds more "
            "than the one in-flight cohort it is allowed",
            site=twin,
            suggestion="the prefetch holds the next cohort's draws, its "
                       "occupancy and the two exchanged fields and "
                       f"nothing else — find the extra leaf with "
                       f"`{_REPORT} {trace.name} {twin}`")]
    return []


def _scan_dominance_findings(trace: TargetTrace,
                             model: cost.CostModel) -> list[Finding]:
    from .. import targets as T
    twin = T.TARGET_SCAN_TWIN.get(trace.name)
    twin_model = _twin_model(twin)
    if twin_model is None:
        return []
    geom = model.geom or {}
    w, sl = float(geom.get("w", 0)), float(geom.get("sl", 0))
    if w <= 0 or sl <= 0:
        return []
    scan_b = model.wave_bytes_per_step().get("dint.store.scan", 0.0)
    probe_b = twin_model.wave_bytes_per_step().get("dint.store.probe",
                                                   0.0)
    per_row, per_probe = scan_b / (w * sl), probe_b / w
    if scan_b <= 0.0 or per_row >= per_probe:
        return [Finding(
            "cost_budget", "scan-bytes-dominance", SEV_ERROR, trace.name,
            f"{per_row:g} bytes per reply row (dint.store.scan "
            f"{scan_b:g} B/step over w*sl={w * sl:g} rows) vs the point "
            f"twin {twin} at {per_probe:g} bytes per probe reply "
            f"(dint.store.probe {probe_b:g} B/step over w={w:g} lanes): "
            "sequential rows must arrive STRICTLY cheaper than point "
            "probes",
            site=twin,
            suggestion="the slab widened (check the sl+dc window and "
                       "row stride) or the scan wave lost its scope — "
                       f"diff `{_REPORT} {trace.name} {twin} --json`")]
    return []


@register_pass("cost_budget")
def cost_budget(trace: TargetTrace) -> list[Finding]:
    """Derives the target's static cost model and enforces ledger
    reconciliation, registered budgets and fused dominance."""
    from .. import targets as T
    meta = T.TARGET_COST.get(trace.name)
    if meta is None:
        return [Finding(
            "cost_budget", "no-budget", SEV_WARNING, trace.name,
            "registered target has no TARGET_COST entry: its cost is "
            "unbudgeted and regressions are invisible to CI",
            suggestion=f"calibrate with `{_REPORT} {trace.name}` and add "
                       "a _cost(...) row to the ledger in "
                       "analysis/targets.py")]
    model = cost.model_for(trace.name, trace)
    if model.error:
        return [Finding(
            "cost_budget", "derivation-failed", SEV_ERROR, trace.name,
            f"cost derivation failed: {model.error}")]
    out = _reconcile_findings(trace, meta, model)
    out += _budget_findings(trace, meta, model)
    out += _dominance_findings(trace, model)
    out += _overlap_findings(trace, model)
    out += _scan_dominance_findings(trace, model)
    out += _link_findings(trace, model)
    return out
