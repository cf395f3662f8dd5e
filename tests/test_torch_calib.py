"""The port's calibration plane (dint_tpu_torch.monitor.calib) against
dint_tpu.monitor.calib on the CPU.

The fit is the reference's bit for bit: the port's fit of the JAX
package's evidence fixture reproduces CALIB.json's model, fit, samples,
waves and provenance (which shows the two fits are one function; it does
not make CALIB.json, a TPU's calibration, the port's). The synthesized
evidence and journal, the gathered evidence of the same artifacts (a port
breakdown with ``host_ms`` among them), the drift records on shifted
evidence and the audits are equal across the packages, and each package
audits the other's journals. The port never reads CALIB.json: its
calibration is $DINT_CALIB_PATH or CALIB_H100.json, and the committed
CALIB_H100.json is reproduced bit for bit from CALIB_H100.evidence.json."""
import builtins
import copy
import json
from pathlib import Path

import numpy as np
import pytest

from dint_tpu.monitor import attrib as jattrib
from dint_tpu.monitor import calib as JC
from dint_tpu_torch.monitor import attrib
from dint_tpu_torch.monitor import calib as PC
from dint_tpu_torch.serve import ControllerCfg, ServeEngine, VirtualClock
from dint_tpu_torch.serve import arrivals
from dint_tpu_torch.serve import controller as pctl

REPO = Path(__file__).resolve().parents[1]
EVIDENCE_FIXTURE = REPO / "tests" / "fixtures" / "dintcal_evidence.json"
JOURNAL_FIXTURE = REPO / "tests" / "fixtures" / "dintcal_journal.jsonl"
H100_CALIB = REPO / "CALIB_H100.json"
H100_EVIDENCE = REPO / "CALIB_H100.evidence.json"


@pytest.fixture(autouse=True)
def _no_calib_env(monkeypatch):
    monkeypatch.delenv("DINT_CALIB_PATH", raising=False)


def test_port_fit_of_the_fixture_is_jax_fit_bit_for_bit():
    ev = PC.load_evidence(EVIDENCE_FIXTURE)
    pinned = json.loads((REPO / "CALIB.json").read_text())
    doc = PC.fit_calib(ev, source=pinned["source"])
    for key in ("model", "fit", "samples", "waves", "tolerance", "prior",
                "provenance"):
        assert doc[key] == pinned[key], key
    assert PC.calib_hash(doc) == JC.calib_hash(doc) \
        == pinned["provenance"]["calib_hash"]
    assert PC._digest(ev) == JC._digest(ev)


@pytest.mark.parametrize("samples", [
    [[256, 170.0], [1024, 200.5], [4096, 318.25], [8192, 470.0]],
    [[16, 1.0], [16, 2.0], [64, 3.5], [128, 0.25], [4096, 1e6]],
    [[w, 3000.0 + 0.1 * w + (i % 3) * 17.0]
     for i, w in enumerate([256, 1024, 4096, 8192] * 50)],
])
def test_fit_service_model_equals_jax(samples):
    assert PC.fit_service_model(samples) == JC.fit_service_model(samples)


def test_fit_refuses_one_width():
    with pytest.raises(ValueError, match="2 distinct widths"):
        PC.fit_service_model([[256, 1.0], [256, 2.0]])


def test_synthesized_evidence_and_journal_equal_jax():
    assert PC.synthesize_evidence() == JC.synthesize_evidence()
    assert PC.synthesize_journal() == JC.synthesize_journal()
    # and both equal the JAX package's fixtures
    assert PC.synthesize_evidence() == json.loads(EVIDENCE_FIXTURE.read_text())
    assert PC.synthesize_journal() == PC.load_journal(JOURNAL_FIXTURE)


def _port_serve_engine():
    """A port ServeEngine driven into saturation under a VirtualClock."""
    eng = ServeEngine("tatp_dense", 500, cfg=ControllerCfg(widths=(16, 64)),
                      cohorts_per_block=2, clock=VirtualClock(), monitor=True,
                      seed=0, device="cpu")
    eng.run(arrivals.constant_schedule(4_000_000.0, 0.004))
    eng.close()
    return eng


def test_gather_evidence_equals_jax_with_a_port_breakdown(tmp_path):
    trace = tmp_path / "port.pt.trace.json"
    attrib.synthesize_trace(str(trace))
    port_bd = attrib.report(str(trace),
                            geometry={"w": 1024, "k": 4, "vw": 10})
    assert any(r["host_ms"] for r in port_bd["waves"].values())
    jtrace = tmp_path / "jax_trace.json"
    jattrib.synthesize_trace(str(jtrace))
    jax_bd = jattrib.report(str(jtrace),
                            geometry={"w": 1024, "k": 4, "vw": 10})
    snap = json.loads(json.dumps(_port_serve_engine().snapshot()))
    docs = [
        {"metric": "tatp", "breakdown": port_bd,
         "counters": {"serve_shed_lanes": 5, "txn_attempted": 9}},
        [{"serve": snap}, {"breakdown": jax_bd}],
        json.loads(EVIDENCE_FIXTURE.read_text()),
        {"serve_counters": snap["counters"]},
    ]
    src = ["a.json", "b.json", "c.json", "d.json"]
    ev = PC.gather_evidence(copy.deepcopy(docs), sources=src)
    assert ev == JC.gather_evidence(copy.deepcopy(docs), sources=src)
    assert ev["samples"][:len(snap["controller"]["service_samples"]
                              ["samples"])] == \
        snap["controller"]["service_samples"]["samples"]
    assert all(set(r) <= {"ms_per_step", "bytes_per_step", "gbps"}
               for r in ev["waves"].values())
    assert PC._digest(ev) == JC._digest(ev)
    # through files, as `dintcal gather` reads them
    paths = []
    for i, d in enumerate(docs):
        p = tmp_path / f"art{i}.json"
        p.write_text(json.dumps(d))
        paths.append(p)
    assert PC.load_evidence(paths[0]) == JC.load_evidence(paths[0])


def test_check_calib_drift_records_equal_jax():
    calib = json.loads((REPO / "CALIB.json").read_text())
    ev = PC.load_evidence(EVIDENCE_FIXTURE)
    assert PC.check_calib(calib, ev) == JC.check_calib(calib, ev) == []
    shifted = copy.deepcopy(ev)
    shifted["samples"] = [[w, us * 1.2 + 3.0] for w, us in ev["samples"]]
    for i, name in enumerate(sorted(shifted["waves"])):
        shifted["waves"][name]["ms_per_step"] *= 1.0 + 0.2 * i
    drift = PC.check_calib(calib, shifted)
    assert drift == JC.check_calib(calib, shifted)
    assert {d["name"] for d in drift} >= {"base_us", "per_lane_ns"}
    assert any(d["what"] == "wave" for d in drift)
    one = copy.deepcopy(ev)
    one["samples"] = [[256, 1.0]]
    assert PC.check_calib(calib, one) == JC.check_calib(calib, one)
    assert PC.check_calib(calib, one)[0]["name"] == "(fit)"


def test_each_package_audits_the_others_journal():
    jdoc = JC.load_journal(JOURNAL_FIXTURE)
    assert PC.audit_journal(jdoc) == JC.audit_journal(jdoc) == []
    edoc = json.loads(json.dumps(_port_serve_engine().ctl.journal_doc()))
    assert {e["kind"] for e in edoc["entries"]} >= {"width", "shed"}
    assert JC.audit_journal(edoc) == PC.audit_journal(edoc) == []
    # a journal of the port's WidthController over a rate ramp
    cfg, model = pctl.ControllerCfg(), pctl.ServiceModel()
    ctl = pctl.WidthController(cfg, model)
    for r in (2e4, 3e5, 5e6, 5e6, 1e5):
        for _ in range(cfg.hysteresis_blocks):
            w = ctl.width()
            ctl.observe_rate(r)
            ctl.observe_service(w, model.service_us(w) * 1.3)
            if int(r * 0.01) > ctl.max_backlog():
                ctl.journal_shed(int(r * 0.01),
                                 int(r * 0.01) - ctl.max_backlog())
    ctl.journal_hot_frac(0.04, 500, 20,
                         pctl.recommend_hot_frac(0.04, 500, 20))
    doc = json.loads(json.dumps(ctl.journal_doc()))
    kinds = {e["kind"] for e in doc["entries"]}
    assert kinds == {"width", "shed", "hot_frac"}
    assert JC.audit_journal(doc) == PC.audit_journal(doc) == []
    for idx, field, bad in ((0, "width", 99_999), (None, "shed", None),
                            (-1, "hot_frac", 0.5)):
        t = copy.deepcopy(doc)
        if field == "shed":
            idx = next(i for i, e in enumerate(t["entries"])
                       if e["kind"] == "shed")
            t["entries"][idx]["decision"]["shed"] += 1
        else:
            t["entries"][idx]["decision"][field] = bad
        v = PC.audit_journal(t)
        assert v == JC.audit_journal(t) and len(v) == 1
        assert v[0]["kind"] == field


def test_journal_jsonl_equals_jax(tmp_path):
    doc = PC.synthesize_journal()
    a, b = tmp_path / "port.jsonl", tmp_path / "jax.jsonl"
    PC.dump_journal_jsonl(doc, a)
    JC.dump_journal_jsonl(doc, b)
    assert a.read_bytes() == b.read_bytes()
    assert PC.load_journal(a) == JC.load_journal(a) == doc


def test_the_port_never_reads_calib_json(monkeypatch):
    seen = []
    real_open = builtins.open

    def spy(file, *a, **kw):
        seen.append(str(file))
        return real_open(file, *a, **kw)

    monkeypatch.setattr(builtins, "open", spy)
    real_read = Path.read_text
    monkeypatch.setattr(Path, "read_text",
                        lambda self, *a, **kw: (seen.append(str(self)),
                                                real_read(self, *a, **kw))[1])
    assert PC.calib_path() == H100_CALIB
    model, meta = PC.resolve_service_model()
    PC.load_calib()
    assert not any(Path(p).name == "CALIB.json" for p in seen), seen
    assert meta["source"] == "calib" and meta["path"] == str(H100_CALIB)
    assert (model.base_us, model.per_lane_ns) == tuple(
        json.loads(H100_CALIB.read_text())["model"][k]
        for k in ("base_us", "per_lane_ns"))


def test_without_a_calibration_the_defaults_say_so(monkeypatch, tmp_path):
    monkeypatch.setenv("DINT_CALIB_PATH", str(tmp_path / "missing.json"))
    model, meta = PC.resolve_service_model()
    assert meta == {"source": "defaults", "path": None, "hash": None}
    assert (model.base_us, model.per_lane_ns) == (150.0, 40.0)
    assert PC.resolve_service_model() == (model, meta)
    # the reference resolves the same file the same way
    jmodel, jmeta = JC.resolve_service_model(tmp_path / "missing.json")
    assert jmeta == meta and jmodel.base_us == model.base_us


def test_committed_h100_calibration_reproduced_from_its_evidence():
    ev = PC.load_evidence(H100_EVIDENCE)
    doc = PC.fit_calib(ev, source=H100_EVIDENCE.name)
    text = json.dumps(doc, indent=1, sort_keys=True) + "\n"
    assert text == H100_CALIB.read_text()
    pinned = PC.load_calib(H100_CALIB)
    refit = PC.fit_service_model(pinned["samples"])
    assert (refit["base_us"], refit["per_lane_ns"]) == (
        pinned["model"]["base_us"], pinned["model"]["per_lane_ns"])
    assert PC.calib_hash(pinned) == pinned["provenance"]["calib_hash"]
    assert JC.fit_calib(ev, source=H100_EVIDENCE.name) == doc
    # fitted on the card: four widths, sources naming the phase and card
    assert pinned["fit"]["widths"] == [256, 1024, 4096, 8192]
    # re-pinned from phase 22 (c): the serving plane's defaults (depth 2,
    # 2 cohorts a block)
    assert all(s.startswith("chip_smoke phase 22 (c), NVIDIA H100")
               and ": depth 2 w" in s for s in ev["sources"])
    assert len(ev["sources"]) == 4 and np.isfinite(
        [pinned["model"]["base_us"], pinned["model"]["per_lane_ns"]]).all()
    assert pinned["source"] == "CALIB_H100.evidence.json"
