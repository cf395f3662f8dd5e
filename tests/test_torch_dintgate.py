"""``python -m dint_tpu_torch.dintgate``: the eight gates in the order of
tools/dintgate.sh, every gate run whatever an earlier one did, the exit
code naming each failed gate, the SARIF merge and the timings line, with
fast stub gates; the real run is the slow tier."""
import json
import re
import sys
from pathlib import Path

import pytest

from dint_tpu_torch import dintgate

REPO = Path(__file__).resolve().parents[1]


def _shell_order():
    """The gate names of tools/dintgate.sh's run_gate lines, in order."""
    text = (REPO / "tools" / "dintgate.sh").read_text()
    return re.findall(r"^run_gate (\S+)", text, flags=re.M)


def test_the_gates_follow_the_shell_entry_point(tmp_path):
    names = [g[0] for g in dintgate.gates(False, str(tmp_path))]
    assert names == _shell_order() == [
        "dintlint", "dintcost", "dintdur", "dintplan", "dintmon",
        "dintcal", "dintcal-audit", "dintmut"]
    argv = {g[0]: g[1] for g in dintgate.gates(False, str(tmp_path))}
    for name in ("dintlint", "dintcost", "dintdur"):
        assert argv[name][-4:-2] == ["--prune-allowlist", "--check"]
    assert argv["dintmut"][3:6] == ["check", "--quick", "--sarif"]
    assert "--static" not in argv["dintplan"]
    quick = {g[0]: g[1] for g in dintgate.gates(True, str(tmp_path))}
    assert "--static" in quick["dintplan"]
    # every module is the port's, run by this interpreter
    assert all(a[0] == sys.executable and a[1] == "-m"
               and a[2].startswith("dint_tpu_torch.") for a in argv.values())
    # the fixtures the identity gates read are in the checkout
    assert (REPO / dintgate.DINTMON_FIXTURE).is_file()
    assert (REPO / dintgate.DINTCAL_JOURNAL).is_file()


def _stub(tmp_path, name, rc, sarif=True):
    """A gate that records that it ran, writes a one-run SARIF log and
    exits ``rc``."""
    log = tmp_path / f"{name}.sarif" if sarif else None
    mark = tmp_path / f"{name}.ran"
    body = f"open({str(mark)!r}, 'w').write('x')\n"
    if log is not None:
        doc = {"version": "2.1.0", "runs": [
            {"tool": {"driver": {"name": name}}, "results": []}]}
        body += f"open({str(log)!r}, 'w').write({json.dumps(doc)!r})\n"
    body += f"raise SystemExit({rc})\n"
    return (name, [sys.executable, "-c", body],
            str(log) if log is not None else str(tmp_path / "none.sarif"))


def _run(capsys, args, gate_list):
    rc = dintgate.main(args, gate_list=gate_list)
    return rc, capsys.readouterr().out


def test_all_ok_exits_zero_and_merges_sarif(tmp_path, capsys):
    gates = [_stub(tmp_path, n, 0) for n in ("a", "b", "c")]
    out_sarif = tmp_path / "merged.sarif"
    timings = tmp_path / "t.json"
    rc, out = _run(capsys, ["--sarif", str(out_sarif), "--timings",
                            str(timings)], gates)
    assert rc == 0 and "all 3 gates ok" in out
    doc = json.loads(out_sarif.read_text())
    assert doc["version"] == "2.1.0"
    assert [r["tool"]["driver"]["name"] for r in doc["runs"]] == \
        ["a", "b", "c"]
    line = json.loads(timings.read_text())
    assert line["metric"] == "dintgate" and line["quick"] is False
    assert [s["gate"] for s in line["stages"]] == ["a", "b", "c"]
    assert all(s["ok"] and s["wall_s"] >= 0 for s in line["stages"])


def test_every_gate_runs_and_each_failure_is_named(tmp_path, capsys):
    gates = [_stub(tmp_path, "first", 1), _stub(tmp_path, "second", 0),
             _stub(tmp_path, "third", 2, sarif=False),
             _stub(tmp_path, "fourth", 0)]
    out_sarif = tmp_path / "merged.sarif"
    rc, out = _run(capsys, ["--sarif", str(out_sarif)], gates)
    assert rc == 1
    assert all((tmp_path / f"{n}.ran").exists()
               for n in ("first", "second", "third", "fourth"))
    assert "FAIL — first third" in out
    assert "--- first: FAIL (exit 1" in out and "--- second: ok" in out
    # a gate that died before writing its log is skipped in the merge
    runs = json.loads(out_sarif.read_text())["runs"]
    assert [r["tool"]["driver"]["name"] for r in runs] == \
        ["first", "second", "fourth"]
    line = json.loads([ln for ln in out.splitlines()
                       if ln.startswith('{"metric"')][0])
    assert [s["rc"] for s in line["stages"]] == [1, 0, 2, 0]


def test_usage_errors_exit_2(capsys):
    with pytest.raises(SystemExit) as e:
        dintgate.main(["--bogus"], gate_list=[])
    assert e.value.code == 2


@pytest.mark.slow
def test_the_real_gates_pass_on_this_tree(tmp_path, capsys):
    out_sarif = tmp_path / "gate.sarif"
    rc = dintgate.main(["--quick", "--sarif", str(out_sarif)])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert len(json.loads(out_sarif.read_text())["runs"]) == 6
