"""The result line and the modules a run loads: each cell's path run
end to end at its tiny size on the CPU in a process of its own (the
sharded cell spawns its server ranks over gloo), its last line holding
exactly the contract's keys, and nothing named jax, jaxlib, flax or
dint_tpu loaded (compared by the whole top-level name, so dint_tpu_torch
passes)."""
from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from dintbench import run as bench_run
from dintbench.registry import HERE, ROOT
from dintbench.tests.tiny import make_root, with_later

SCRIPT = """
import sys
from pathlib import Path
from dintbench import run
rc = run.main(sys.argv[2:], root=Path(sys.argv[1]))
print("MODULES", sorted({m.split(".")[0] for m in sys.modules}),
      file=sys.stderr)
sys.exit(rc)
"""

CELLS = ["tatp-7m.closed-w128k", "smallbank-24m.closed-w64k",
         "tatp-7m-3srv.closed-w32k"]


def run_cell(root: Path, cell: str, trace: int):
    args = ["--workload", cell, "--seed", str(2**33 + 11), "--seconds",
            "0.5", "--trace", str(trace), "--device", "cpu"]
    p = subprocess.run([sys.executable, "-c", SCRIPT, str(root), *args],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    return p


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_last_line_and_no_jax(tmp_path, cell, trace):
    p = run_cell(make_root(tmp_path), cell, trace)
    line = json.loads(p.stdout.strip().splitlines()[-1])
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown"] if trace else []
    assert sorted(line) == sorted(keys + ["checks"])
    assert list(line)[-1] == "checks"
    assert line["correct"] is True
    assert line["attempted"] > 0 and line["failed"] == 0
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    assert ("busy_s" in dev and "window_s" in dev) == bool(trace)
    bench = with_later(json.loads((ROOT / "BENCHMARK.json").read_text()))
    want = bench["per_layer" if trace else "end_to_end"]
    names = {m["name"] for m in want
             if "workloads" not in m or cell in m["workloads"]}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    # the checks are the last lines of standard error too
    err = [x for x in p.stderr.splitlines() if not x.startswith("MODULES")]
    tail = err[-len(line["checks"]):]
    for (name, (num, lim)), text in zip(line["checks"].items(), tail):
        assert text == f"check {name} {num} limit {lim}"
    mods = [x for x in p.stderr.splitlines() if x.startswith("MODULES")][0]
    loaded = ast.literal_eval(mods.split(" ", 1)[1])
    assert "dint_tpu_torch" in loaded
    assert not {"jax", "jaxlib", "flax", "dint_tpu"} & set(loaded)


def test_a_loaded_jax_package_refuses_the_result(tmp_path, monkeypatch,
                                                 capsys):
    monkeypatch.setitem(sys.modules, "dint_tpu.fake", object())
    rc = bench_run.main(["--workload", CELLS[0], "--seed", "5", "--seconds",
                         "0.2", "--trace", "0", "--device", "cpu"],
                        root=make_root(tmp_path))
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "dint_tpu.fake" in out.err


def test_no_card_no_result(tmp_path):
    # without --device cpu the run looks for the cards the cell asks for
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal needs a machine "
                    "without one")
    p = subprocess.run([sys.executable, "-m", "dintbench.run", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1", "--trace",
                        "0"], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and p.stdout == ""


def test_the_reference_imports_nothing_of_the_port():
    for path in sorted((HERE / "reference").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in (
                    "dint_tpu_torch", "dint_tpu", "jax", "jaxlib"), (path, n)


def test_failed_counts_the_unanswered_and_not_the_aborts():
    # two blocks of two cohorts, stats rows (attempted, committed, lock
    # aborts, missing, validation aborts), lag 2: the last two cohorts'
    # rows never came
    import numpy as np
    from dintbench import cell, window
    rec = window.Record(cpb=2, lag=2)
    row = [4, 1, 2, 1, 0]
    rec.add_block(0)
    rec.add_block(10)
    rec.add_stats(np.array([[0] * 5, [0] * 5], np.int64), 20)
    rec.add_stats(np.array([row, row], np.int64), 30)
    run_ = {"warm": 0, "window_blocks": 2, "rec": rec, "t0": 0,
            "t_end": 10 ** 9}
    cfg = {"system": "tatp_dense"}
    mix = {"cohorts_per_block": 2, "width": 4}
    vals, attempted, failed, extra = cell.e2e(cfg, mix, run_, 1.0)
    assert attempted == 16
    assert failed == 2 * 4
    assert extra["conflict_aborts"] == 2 * 2
    assert vals["committed_txn_per_s"] == 2.0
