"""The port's calibration gate (passes/calib_check.py and ``python -m
dint_tpu_torch.dintcal check``) against the reference's on the CPU.

Each code fires on a mutated copy of the port's CALIB_H100.json (or its
plan); `check_calib_doc` gives the reference's (code, site) set on the
same documents: both calibrations (CALIB.json, a TPU's, and
CALIB_H100.json) against both plans (PLAN.json and PLAN_H100.json). The
port's wave registry (monitor/waves.WAVE_BYTES) holds every wave either
calibration pins, so no difference comes from the registries.
"""
import contextlib
import copy
import io
import json
import os
import shutil
from pathlib import Path

import pytest

from dint_tpu.analysis.passes import calib_check as jcc
from dint_tpu.monitor import waves as jwaves
from dint_tpu_torch import analysis
from dint_tpu_torch import dintcal
from dint_tpu_torch.analysis import allowlist as al
from dint_tpu_torch.analysis import plan as P
from dint_tpu_torch.analysis.passes import calib_check as cc
from dint_tpu_torch.monitor import calib as CAL
from dint_tpu_torch.monitor import waves

REPO = Path(__file__).resolve().parents[1]
ANCHOR = P.DEFAULT_ANCHOR
ENV_VARS = ("DINT_PLAN_PATH", "DINT_CALIB_PATH", "DINT_PLAN_ANCHOR")


@pytest.fixture(autouse=True)
def _clean_env():
    """Unset the gate's variables for the test and put back what was
    there after it (dintcal check --calib sets DINT_CALIB_PATH)."""
    saved = {k: os.environ.pop(k, None) for k in ENV_VARS}
    yield
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def _load(name):
    return json.loads((REPO / name).read_text())


def _keys(fs):
    return sorted((f.code, f.site) for f in fs)


def broken_calib_findings():
    """calib_check's canonical broken fixture: CALIB_H100.json with a
    hand-edited coefficient, checked against the pinned plan."""
    calib = _load("CALIB_H100.json")
    calib["model"]["base_us"] += 1.0
    return cc.check_calib_doc(calib, ANCHOR, plan=_load("PLAN_H100.json"),
                              source_dir=REPO)


def test_the_pinned_pair_is_clean():
    calib, plan = _load("CALIB_H100.json"), _load("PLAN_H100.json")
    assert cc.check_calib_doc(calib, ANCHOR, plan=plan,
                              source_dir=REPO) == []
    assert CAL.calib_path() == REPO / "CALIB_H100.json"
    # the pinned calibration reproduces its fit from its evidence
    ev = CAL.load_evidence(REPO / "CALIB_H100.evidence.json")
    assert CAL.fit_calib(ev, source=calib["source"])["model"] == \
        calib["model"]
    assert calib["provenance"]["evidence_hash"] == CAL._digest(ev)


def _mutated(code, tmp_path):
    calib, plan = _load("CALIB_H100.json"), _load("PLAN_H100.json")
    if code == "malformed-calib":
        del calib["fit"]
    elif code == "stale-provenance":
        calib["provenance"]["calib_hash"] = "0" * 16
    elif code == "unfit-model":
        calib["model"]["per_lane_ns"] *= 1.5
        calib["provenance"]["calib_hash"] = CAL.calib_hash(calib)
    elif code == "unregistered-wave":
        calib["waves"]["dint.tatp_dense.no_such_wave"] = {
            "ms_per_step": 1.0, "bytes_per_step": 1e6, "gbps": 1.0}
        calib["provenance"]["calib_hash"] = CAL.calib_hash(calib)
    elif code == "plan-model-drift":
        plan["workloads"]["tatp_serve"]["serve"]["model"]["hash"] = "x"
    elif code == "missing-calib":
        return cc.check_calib_doc(None, ANCHOR, plan=plan)
    return cc.check_calib_doc(calib, ANCHOR, plan=plan, source_dir=REPO)


CODES = ("malformed-calib", "stale-provenance", "unfit-model",
         "unregistered-wave", "plan-model-drift", "missing-calib")


@pytest.mark.parametrize("code", CODES)
def test_each_code_fires_and_is_allowlist_silenceable(code, tmp_path):
    fs = _mutated(code, tmp_path)
    hits = [f for f in fs if f.code == code]
    assert hits and all(f.pass_name == "calib_check" and f.target == ANCHOR
                        and f.severity == "error" for f in hits), fs
    out = al.apply(hits, [{"pass": "calib_check", "code": code,
                           "target": ANCHOR, "reason": "test"}],
                   check_unused=False)
    assert all(f.suppressed for f in out) and not analysis.has_errors(out)


def test_stale_evidence_and_a_missing_calibration_through_the_pass(
        tmp_path):
    cal = tmp_path / "CALIB_H100.json"
    shutil.copy(REPO / "CALIB_H100.json", cal)
    ev = _load("CALIB_H100.evidence.json")
    ev["samples"] = ev["samples"][:-1]
    (tmp_path / "CALIB_H100.evidence.json").write_text(json.dumps(ev))
    fs = cc.check_calib_doc(CAL.load_calib(cal), ANCHOR,
                            source_dir=tmp_path)
    assert _keys(fs) == [("stale-provenance", "evidence_hash")]
    # through the registered pass: no calibration where the plan's serve
    # rows say "calib" lands missing-calib on the anchor only
    os.environ["DINT_CALIB_PATH"] = str(tmp_path / "none.json")
    fs = analysis.run(targets=[ANCHOR], passes=["calib_check"])
    assert {f.code for f in fs} == {"missing-calib"}
    assert all(f.target == ANCHOR for f in fs) and len(fs) == 3


def test_the_port_registers_every_wave_either_calibration_pins():
    for name in ("CALIB.json", "CALIB_H100.json"):
        for w in _load(name)["waves"]:
            assert w in waves.WAVE_BYTES and w in jwaves.WAVE_BYTES


@pytest.mark.parametrize("calib_name", ["CALIB.json", "CALIB_H100.json"])
@pytest.mark.parametrize("plan_name", ["PLAN.json", "PLAN_H100.json"])
def test_check_calib_doc_equals_the_reference(calib_name, plan_name):
    calib, plan = _load(calib_name), _load(plan_name)
    mine = cc.check_calib_doc(calib, ANCHOR, plan=plan, source_dir=REPO)
    theirs = jcc.check_calib_doc(calib, ANCHOR, plan=plan, source_dir=REPO)
    assert _keys(mine) == _keys(theirs)
    # each calibration against the plan priced from it is clean, and
    # against the other plan it is plan-model-drift on the serve rows
    serve = sorted(f"{w}.serve.model" for w in ("tatp_serve",
                                                 "smallbank_serve",
                                                 "multihost_serve"))
    paired = {"CALIB.json": "PLAN.json", "CALIB_H100.json": "PLAN_H100.json"}
    if paired[calib_name] == plan_name:
        assert mine == []
    else:
        assert _keys(mine) == [("plan-model-drift", s) for s in serve]


def _cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = dintcal.main(argv)
    return rc, buf.getvalue()


def test_dintcal_check_passes_on_the_pinned_files_and_names_a_drift(
        tmp_path):
    rc, out = _cli(["check", "--json"])
    rec = json.loads(out.strip().splitlines()[-1])
    assert rc == 0 and rec["ok"] and rec["n_findings"] == 0
    assert rec["calib"] == str(REPO / "CALIB_H100.json")
    assert rec["evidence"] == str(REPO / "CALIB_H100.evidence.json")
    sarif = tmp_path / "c.sarif"
    rc, _ = _cli(["check", "--sarif", str(sarif)])
    assert rc == 0 and json.loads(sarif.read_text())["version"] == "2.1.0"
    # evidence from another machine: the refit drifts past the band, named
    ev = copy.deepcopy(_load("CALIB_H100.evidence.json"))
    ev["samples"] = [[w, us * 2] for w, us in ev["samples"]]
    evp = tmp_path / "ev.json"
    evp.write_text(json.dumps(ev))
    rc, out = _cli(["check", "--evidence", str(evp)])
    assert rc == 1 and "evidence-drift" in out
    assert "coefficient:base_us" in out and "FAIL" in out
    # a hand-edited copy: the offender is named
    cal = json.loads((REPO / "CALIB_H100.json").read_text())
    cal["model"]["base_us"] = 1.0
    bad = tmp_path / "CALIB_H100.json"
    bad.write_text(json.dumps(cal))
    shutil.copy(REPO / "CALIB_H100.evidence.json",
                tmp_path / "CALIB_H100.evidence.json")
    rc, out = _cli(["check", "--calib", str(bad), "--json"])
    rec = json.loads(out.strip().splitlines()[-1])
    assert rc == 1 and not rec["ok"]
    assert ("unfit-model", "model.base_us") in {
        (f["code"], f["site"]) for f in rec["findings"]}
    assert ("stale-provenance", "calib_hash") in {
        (f["code"], f["site"]) for f in rec["findings"]}
