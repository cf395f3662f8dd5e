"""The port's CLIs `python -m dint_tpu_torch.dintcal`, `dintserve` and
`drive` against tools/dintcal.py and tools/dintserve.py on the CPU.

Each subcommand runs in-process on both sides with the same arguments:
the same exit codes, the same ``--json`` keys, and the same values where
the inputs are the same (the written evidence, calibration and synthesized
fixtures byte for byte; a virtual-clock serve run's offered, admitted,
shed and width trajectory; a simulated trajectory under explicit model
flags). Paths differ only where the port's calibration is its own
(CALIB_H100.json, never CALIB.json). Then `drive --cpu` passes every check
at its sizes, exits 1 on a failed check, and without a card and without
``--cpu`` raises."""
import contextlib
import importlib.util
import io
import json
import sys
from pathlib import Path

import pytest
import torch

from dint_tpu_torch import dintcal, dintserve, drive

REPO = Path(__file__).resolve().parents[1]
EVIDENCE_FIXTURE = str(REPO / "tests" / "fixtures" / "dintcal_evidence.json")
JOURNAL_FIXTURE = str(REPO / "tests" / "fixtures" / "dintcal_journal.jsonl")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_cli_ref", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jcal():
    return _load("dintcal")


@pytest.fixture(scope="module")
def jserve():
    return _load("dintserve")


@pytest.fixture(autouse=True)
def _no_calib_env(monkeypatch):
    monkeypatch.delenv("DINT_CALIB_PATH", raising=False)


def _run(main, argv, monkeypatch=None):
    """(exit code, stdout) of an in-process CLI call; a main that reads
    sys.argv gets ``argv`` there."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if monkeypatch is not None:
            monkeypatch.setattr(sys, "argv", ["prog"] + argv)
            rc = main()
        else:
            rc = main(argv)
    return rc, buf.getvalue()


def _json(out):
    return json.loads(out.strip().splitlines()[-1])


def _both(jcal, argv_of):
    """Run dintcal on both sides; argv_of(side) -> argv."""
    return (_run(dintcal.main, argv_of("port")),
            _run(jcal.main, argv_of("jax")))


def _snapshot_file(tmp_path):
    from dint_tpu_torch.serve import ControllerCfg, ServeEngine, VirtualClock
    from dint_tpu_torch.serve import arrivals
    eng = ServeEngine("tatp_dense", 500, cfg=ControllerCfg(widths=(16, 64)),
                      cohorts_per_block=2, clock=VirtualClock(),
                      monitor=True, device="cpu")
    eng.run(arrivals.constant_schedule(800_000.0, 0.004))
    eng.close()
    p = tmp_path / "snap.json"
    p.write_text(json.dumps(eng.snapshot()))
    return str(p)


def test_gather_and_fit_equal_jax(jcal, tmp_path):
    arts = [EVIDENCE_FIXTURE, _snapshot_file(tmp_path)]
    (rc, out), (jrc, jout) = _both(jcal, lambda s: [
        "gather", *arts, "-o", str(tmp_path / f"{s}_ev.json"), "--json"])
    assert rc == jrc == 0
    p, j = _json(out), _json(jout)
    assert set(p) == set(j) and p.pop("out") != j.pop("out") and p == j
    assert (tmp_path / "port_ev.json").read_bytes() == \
        (tmp_path / "jax_ev.json").read_bytes()
    ev = str(tmp_path / "port_ev.json")
    (rc, out), (jrc, jout) = _both(jcal, lambda s: [
        "fit", ev, "-o", str(tmp_path / f"{s}_calib.json"), "--json"])
    assert rc == jrc == 0
    p, j = _json(out), _json(jout)
    assert set(p) == set(j) and p.pop("out") != j.pop("out") and p == j
    assert (tmp_path / "port_calib.json").read_bytes() == \
        (tmp_path / "jax_calib.json").read_bytes()
    # the text form
    rc, out = _run(dintcal.main, ["fit", ev, "-o",
                                  str(tmp_path / "t.json")])
    assert rc == 0 and "base_us" in out and "provenance:" in out


def test_audit_exit_codes_equal_jax(jcal, tmp_path):
    (rc, out), (jrc, jout) = _both(jcal, lambda s: [
        "audit", JOURNAL_FIXTURE, "--json"])
    assert rc == jrc == 0 and _json(out) == _json(jout)
    assert _json(out)["n_violations"] == 0
    lines = Path(JOURNAL_FIXTURE).read_text().splitlines()
    entry = json.loads(lines[3])
    entry["decision"][next(iter(entry["decision"]))] = 12345
    lines[3] = json.dumps(entry)
    bad = tmp_path / "bad.jsonl"
    bad.write_text("\n".join(lines) + "\n")
    (rc, out), (jrc, jout) = _both(jcal, lambda s: [
        "audit", str(bad), "--json"])
    assert rc == jrc == 1 and _json(out) == _json(jout)
    assert _json(out)["violations"][0]["index"] == 2
    (rc, out), (jrc, jout) = _both(jcal, lambda s: ["audit", str(bad)])
    assert rc == jrc == 1 and out == jout


def test_propose_equals_jax_but_repins_nothing(jcal, tmp_path):
    (rc, out), (jrc, jout) = _both(jcal, lambda s: [
        "propose", "--evidence", EVIDENCE_FIXTURE, "--calib",
        str(tmp_path / "none.json"), "-o", str(tmp_path / f"{s}.json"),
        "--json"])
    assert rc == jrc == 0
    p, j = _json(out), _json(jout)
    assert set(p) == set(j)
    for k in ("model", "provenance", "delta", "evidence"):
        assert p[k] == j[k], k
    assert p["repin"] == ("python -m dint_tpu_torch.dintplan plan --calib "
                          f"{tmp_path / 'port.json'}")
    assert j["repin"].startswith("python tools/")
    # no evidence anywhere: exit 2 on both sides
    (rc, _), (jrc, _) = _both(jcal, lambda s: [
        "propose", "--calib", str(tmp_path / "none.json")])
    assert rc == jrc == 2


def test_propose_resolves_the_committed_calibrations_evidence(tmp_path):
    rc, out = _run(dintcal.main, ["propose", "-o", str(tmp_path / "p.json"),
                                  "--json"])
    p = _json(out)
    assert rc == 0 and p["evidence"] == str(REPO / "CALIB_H100.evidence.json")
    pinned = json.loads((REPO / "CALIB_H100.json").read_text())
    assert p["model"] == pinned["model"]
    assert p["delta"] == {c: {"pinned": pinned["model"][c],
                              "proposed": pinned["model"][c]}
                          for c in ("base_us", "per_lane_ns")}


def test_describe_keys_equal_jax_paths_are_the_ports(jcal):
    (rc, out), (jrc, jout) = _both(jcal, lambda s: ["describe", "--json"])
    assert rc == jrc == 0
    p, j = _json(out), _json(jout)
    assert set(p) == set(j)
    assert set(p["resolved_model"]) == set(j["resolved_model"])
    assert Path(p["calib_path"]).name == "CALIB_H100.json"
    assert Path(j["calib_path"]).name == "CALIB.json"
    for k in ("evidence_schema", "calib_schema", "tolerance"):
        assert p[k] == j[k]
    rc, out = _run(dintcal.main, ["describe"])
    assert rc == 0 and "CALIB_H100.json" in out and "source=CALIB" in out


def test_synth_writes_jax_fixtures_where_told(jcal, tmp_path):
    (rc, out), (jrc, jout) = _both(jcal, lambda s: [
        "synth", "--out-evidence", str(tmp_path / f"{s}_ev.json"),
        "--out-journal", str(tmp_path / f"{s}_j.jsonl"), "--json"])
    assert rc == jrc == 0
    p, j = _json(out), _json(jout)
    assert set(p) == set(j) and p["n_samples"] == j["n_samples"]
    for a, b in (("port_ev.json", "jax_ev.json"),
                 ("port_j.jsonl", "jax_j.jsonl")):
        assert (tmp_path / a).read_bytes() == (tmp_path / b).read_bytes()
    assert (tmp_path / "port_ev.json").read_text() == \
        Path(EVIDENCE_FIXTURE).read_text()
    # the port's synth names its outputs: no default onto the fixtures
    with pytest.raises(SystemExit) as e, \
            contextlib.redirect_stderr(io.StringIO()):
        dintcal.main(["synth"])
    assert e.value.code == 2


def test_file_errors_exit_2(jcal, tmp_path):
    (rc, _), (jrc, _) = _both(jcal, lambda s: [
        "fit", str(tmp_path / "missing.json")])
    assert rc == jrc == 2


SIM = ["simulate", "--rate", "2000000", "--window", "0.01", "--json",
       "--model-base-us", "200", "--model-per-lane-ns", "30"]


def test_simulate_equals_jax(jserve, monkeypatch):
    rc, out = _run(dintserve.main, SIM)
    jrc, jout = _run(jserve.main, SIM, monkeypatch)
    assert rc == jrc == 0 and _json(out) == _json(jout)
    # resolved from the port's own calibration, never CALIB.json
    argv = SIM[:6]
    rc, out = _run(dintserve.main, argv)
    jrc, jout = _run(jserve.main, argv, monkeypatch)
    p, j = _json(out), _json(jout)
    assert rc == jrc == 0 and set(p) == set(j)
    assert p["model"]["source"] == "calib"
    assert Path(p["model"]["path"]).name == "CALIB_H100.json"
    rc, text = _run(dintserve.main, ["simulate", "--rate", "200000",
                                     "--window", "0.01"])
    assert rc == 0 and "trajectory:" in text and "source=CALIB" in text


RUN = ["run", "--engine", "tatp_dense", "--size", "2000", "--rate", "30000",
       "--window", "0.02", "--widths", "64,256", "--cpb", "4", "--virtual"]


def test_virtual_run_equals_jax(jserve, monkeypatch, tmp_path):
    # the same plan file to both (JAX's "auto" is PLAN.json, the port's
    # PLAN_H100.json)
    argv = RUN + ["--plan", str(REPO / "PLAN.json"), "--json", "--journal",
                  str(tmp_path / "j.jsonl")]
    rc, out = _run(dintserve.main, argv + ["--device", "cpu"])
    jrc, jout = _run(jserve.main, argv[:-2] + ["--journal",
                                               str(tmp_path / "jj.jsonl")],
                     monkeypatch)
    p, j = _json(out), _json(jout)
    assert rc == jrc and set(p) == set(j)
    # under the virtual clock the serving loop is a function of the
    # schedule and the model: the same decisions on both sides
    for k in ("offered", "admitted", "shed", "blocks", "steps_by_width",
              "slo_met", "widths"):
        assert p[k] == j[k], k
    # a plan document handed in: each package names its default file
    assert {k: v for k, v in p["plan"].items() if k != "source"} == \
        {k: v for k, v in j["plan"].items() if k != "source"}
    assert p["controller"]["switches"] == j["controller"]["switches"]
    assert (tmp_path / "j.jsonl").read_bytes() == \
        (tmp_path / "jj.jsonl").read_bytes()
    rc, out = _run(dintcal.main, ["audit", str(tmp_path / "j.jsonl")])
    assert rc == 0
    # the exit gate: an SLO no run can meet
    tight = RUN + ["--plan", str(REPO / "PLAN.json"), "--slo-us", "1",
                   "--device", "cpu"]
    rc, text = _run(dintserve.main, tight)
    jrc, _ = _run(jserve.main, tight[:-2], monkeypatch)
    assert rc == jrc == 1 and "MISSED" in text
    rc, _ = _run(dintserve.main, tight + ["--no-gate"])
    assert rc == 0


def test_describe_marks_the_targets_not_ported(jserve, monkeypatch):
    """describe's lines equal the reference's but for the serve targets,
    which the port lists from its own registry with their budgets."""
    rc, out = _run(dintserve.main, ["describe"])
    jrc, jout = _run(jserve.main, ["describe"], monkeypatch)
    assert rc == jrc == 0
    assert "not ported" not in out
    from dint_tpu_torch.analysis import targets as tg
    serve = sorted(n for n in tg.TARGETS if "/serve" in n)
    assert serve and all(f"  {n} " in out for n in serve)
    for line in jout.splitlines():
        if "targets" not in line and "/serve" not in line \
                and not line.startswith("  dint_tpu"):
            if not line.startswith("  ") or "serve_" in line \
                    or "dint." in line:
                assert line in out.splitlines(), line


def test_drive_cpu_passes_every_check(capsys):
    assert drive.main(["--cpu"]) == 0
    out = capsys.readouterr().out
    assert "FAIL" not in out and out.count("PASS") == 21
    assert "scan replies bit-identical: plain vs post-rebuild" in out
    assert out.strip().splitlines()[-1] == "ALL CHECKS PASSED on cpu"


def test_drive_exits_1_on_a_failed_check(monkeypatch, capsys):
    monkeypatch.setattr(drive, "drive_locks",
                        lambda dev, rng: drive.check("a forced check", False))
    monkeypatch.setattr(drive, "drive_store", lambda dev, rng: None)
    assert drive.main(["--cpu"]) == 1
    assert "FAIL  a forced check" in capsys.readouterr().out


def test_drive_needs_a_card_without_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        drive.main([])
