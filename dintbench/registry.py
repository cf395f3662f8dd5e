"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of
the checkout names the cells, metrics and configurations; a cell's
configuration is the JSON file its entry names (under ``configs/``), its
traffic mix ``traffic/<traffic>.json``, and each per-layer metric's
reader ``metrics/<metric>.py``. A later cell, mix or metric is new files
and entries; nothing here changes for it."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _for_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(bench: dict, name: str, root: Path = ROOT) -> dict:
    """Everything one cell runs on: its entry, its configuration's entry
    and file, its traffic mix, and the metrics it reports."""
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"({', '.join(sorted(work))})")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(root / conf["file"]) as f:
        cfg = json.load(f)
    with open(root / HERE.name / "traffic" / f"{w['traffic']}.json") as f:
        mix = json.load(f)
    return {"workload": w, "config": conf, "cfg": cfg, "mix": mix,
            "end_to_end": [m for m in bench["end_to_end"]
                           if _for_cell(m, name)],
            "per_layer": [m for m in bench["per_layer"]
                          if _for_cell(m, name)]}


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "dintbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
