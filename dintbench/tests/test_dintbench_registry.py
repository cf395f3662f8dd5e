"""The harness finds a configuration, a traffic mix and a metric reader
by the names in BENCHMARK.json, and a new mix, configuration or metric is
new files and entries: nothing else is edited for it. BENCHMARK.json
keeps to the contract's shape."""
from __future__ import annotations

import json
import re

from dintbench import registry
from dintbench.registry import HERE, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_resolves_by_name():
    bench = registry.load()
    for w in bench["workloads"]:
        c = registry.cell(bench, w["name"])
        assert c["cfg"]["name"] == w["config"]
        assert c["mix"]["width"] > 0 and c["mix"]["cohorts_per_block"] > 0
        assert {m["name"] for m in c["end_to_end"]} >= {
            "committed_txn_per_s", "setup_s"}
        for m in c["per_layer"]:
            assert callable(registry.reader(m["name"]))


def test_a_new_mix_and_metric_are_files_and_entries(tmp_path):
    from dintbench.tests.tiny import make_root
    root = make_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    mix = json.loads((root / "dintbench/traffic/closed-w128k.json")
                     .read_text())
    mix["width"] = 16
    (root / "dintbench/traffic/closed-w16.json").write_text(json.dumps(mix))
    bench["workloads"].append({"name": "tatp-7m.closed-w16",
                               "config": "tatp-7m", "traffic": "closed-w16",
                               "chips": 1, "why": "a narrower cohort"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    c = registry.cell(registry.load(root), "tatp-7m.closed-w16", root)
    assert c["mix"]["width"] == 16
    # a metric's reader is its own file, found by the metric's name
    path = HERE / "metrics" / "zz_test_only.metric.py"
    path.write_text("def read(views, ctx):\n    return 42.0\n")
    try:
        assert registry.reader("zz_test_only.metric")([], {}) == 42.0
    finally:
        path.unlink()


def test_benchmark_json_keeps_the_contract_shape():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("dintbench/")
        assert (ROOT / c["file"]).exists()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (HERE / "traffic" / f"{w['traffic']}.json").exists()
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert (HERE / "metrics" / f"{m['name']}.py").exists()
    assert len(json.dumps(bench)) < 64 * 1024
