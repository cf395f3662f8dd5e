"""The consumers of the static gates: the bench's three gate fields
(`bench.gate_snapshots`: dintlint, dintcost and dintdur in CPU
subprocesses, as bench.py fills them) and `dintserve describe`'s serve
targets with their dintcost budgets."""
import contextlib
import io

import pytest

from dint_tpu_torch import bench, dintserve
from dint_tpu_torch.analysis import targets as T

TARGET = "tatp_dense/serve"
# the three gates on one cheap target: the CLIs' real JSON lines
QUICK = (
    ("dintlint", ("dint_tpu_torch.dintlint", "--target", TARGET, "--json"),
     False),
    ("dintcost", ("dint_tpu_torch.dintcost", "report", TARGET, "--json"),
     True),
    ("dintdur", ("dint_tpu_torch.dintdur", "check", "--target", TARGET,
                 "--json"), False),
)


def test_the_gates_are_the_references_three():
    assert [g[0] for g in bench.GATES] == ["dintlint", "dintcost",
                                           "dintdur"]
    assert bench.GATES[0][1] == ("dint_tpu_torch.dintlint", "--all",
                                 "--json")
    assert bench.GATES[1][1][1:] == ("report", "--all", "--json")
    assert bench.GATES[2][1][1:] == ("check", "--all", "--json")


def test_opt_out_is_recorded():
    out = bench.gate_snapshots({"DINT_BENCH_LINT": "0"})
    assert out == {k: {"disabled": "DINT_BENCH_LINT=0"}
                   for k in ("dintlint", "dintcost", "dintdur")}


def test_snapshots_parse_each_clis_last_json_line(monkeypatch):
    monkeypatch.setattr(bench, "GATES", QUICK)
    out = bench.gate_snapshots({})
    lint, cost, dur = out["dintlint"], out["dintcost"], out["dintdur"]
    assert lint["ok"] is True and "findings" not in lint
    assert lint["targets"] == [TARGET]
    assert dur["metric"] == "dintdur" and "findings" not in dur
    assert dur["n_errors"] == 0
    # dintcost's report keeps its targets, as bench.py keeps them
    assert set(cost["targets"]) == {TARGET}
    assert cost["targets"][TARGET]["dispatches_per_step"] == \
        T.TARGET_COST[TARGET]["budget"]["dispatches"]


def test_a_red_gate_is_recorded_and_a_crash_raises(monkeypatch, tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("{}")
    red = (("dintlint", ("dint_tpu_torch.dintplan", "check", "--static",
                         "--plan", str(bad), "--json"), False),)
    monkeypatch.setattr(bench, "GATES", red)
    out = bench.gate_snapshots({})
    assert out["dintlint"]["ok"] is False and out["dintlint"]["n_errors"]
    # exit 2 (a usage error), no JSON line, or a module that is not there
    for argv in (("dint_tpu_torch.dintlint", "--target", "no/such",
                  "--json"),
                 ("dint_tpu_torch.dintlint", "--list"),
                 ("dint_tpu_torch.no_such_gate",)):
        monkeypatch.setattr(bench, "GATES", (("dintlint", argv, False),))
        with pytest.raises(RuntimeError, match="dintlint: exit"):
            bench.gate_snapshots({})


def test_a_gate_past_its_time_raises(monkeypatch):
    monkeypatch.setattr(bench, "GATES", QUICK[:1])
    with pytest.raises(RuntimeError, match="no verdict within"):
        bench.gate_snapshots({"DINT_BENCH_LINT_TIMEOUT": "0.01"})


def test_dintserve_describe_lists_the_serve_targets_and_budgets():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert dintserve.main(["describe"]) == 0
    out = buf.getvalue()
    assert "not ported" not in out
    serve = sorted(n for n in T.TARGETS if "/serve" in n)
    assert len(serve) == 11
    for n in serve:
        line = next(ln for ln in out.splitlines()
                    if ln.startswith(f"  {n} "))
        disp = T.TARGET_COST[n]["budget"]["dispatches"]
        assert f"{disp:g} dispatches/step" in line, line
        assert str(T.TARGET_COST[n]["budget"]["bytes"]) in line
