"""The mesh serving plane's entry points across processes on the CPU:
``dintserve run --mesh`` and exp's ``serve_mesh`` leg under
``python -m torch.distributed.run --standalone`` (3 gloo ranks, one a
host of a 3x2 mesh; ``--standalone`` takes a free port of its own), held
against the same entry points in one process. Rank 0 prints and writes;
the other ranks print nothing."""
import json
import os
import subprocess
import sys

import pytest

from dint_tpu_torch import dintserve
from dint_tpu_torch import exp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_FIELDS = ("processes", "backend", "rank_cards")
RUN = ["run", "--mesh", "3x2", "--size", "256", "--rate", "200000",
       "--window", "0.01", "--widths", "8,16", "--cpb", "2", "--virtual",
       "--device", "cpu", "--json", "--model-base-us", "150",
       "--model-per-lane-ns", "40"]


def torchrun(*args, extra_env=None, timeout=180):
    """``python -m torch.distributed.run --standalone`` over 3 ranks of
    ``args``, with none of the parent's rank or plane flags but
    ``extra_env``'s; returns its standard output."""
    env = dict(os.environ)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "DINT_MONITOR",
              "DINT_TRACE"):
        env.pop(k, None)
    env.update(extra_env or {})
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "3", *args], env=env, capture_output=True,
        text=True, timeout=timeout, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_dintserve_run_mesh_under_torchrun(tmp_path, capsys):
    """``dintserve run --mesh 3x2 --virtual --json`` on 3 ranks prints the
    one-process CLI's report (one line, rank 0's), with the processes,
    the backend and each rank's cards added, and rank 0 writes the
    controller's journal, line for line the one process's."""
    rc = dintserve.main(RUN + ["--journal", str(tmp_path / "one.jsonl")])
    assert rc == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    out = torchrun("-m", "dint_tpu_torch.dintserve", *RUN, "--journal",
                   str(tmp_path / "ranks.jsonl"))
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    assert len(lines) == 1                    # rank 0 prints
    got = json.loads(lines[0])
    assert got["processes"] == 3 and got["backend"] == "gloo"
    assert got["rank_cards"] == [["cpu"]] * 3
    assert {k: v for k, v in got.items() if k not in GROUP_FIELDS} == want
    assert want["offered"] == want["admitted"] + want["shed"] > 0
    with open(tmp_path / "one.jsonl") as a, \
            open(tmp_path / "ranks.jsonl") as b:
        assert a.read() == b.read()


def test_dintserve_across_processes_serves_run_mesh_only(monkeypatch):
    """Under a group of several ranks (torchrun's WORLD_SIZE) simulate,
    describe and run without --mesh refuse before they join anything."""
    monkeypatch.setenv("WORLD_SIZE", "3")
    for argv in (["simulate", "--rate", "1000"], ["describe"],
                 ["run", "--device", "cpu", "--virtual"]):
        with pytest.raises(SystemExit, match="only `run --mesh"):
            dintserve.main(argv)


def _ledger(art: dict):
    c = art["serve_counters"]
    assert art["offered"] == art["admitted"] + art["shed"] > 0
    assert c["serve_occupancy_lanes"] == art["admitted"]
    assert c["serve_shed_lanes"] == art["shed"]
    assert sum(h["admitted"] for h in art["per_host"]) == art["admitted"]
    assert sum(h["shed"] for h in art["per_host"]) == art["shed"]
    assert art["mesh"]["n_hosts"] == 3 and art["mesh"]["n_ici"] == 2


def test_exp_serve_mesh_leg_under_torchrun(tmp_path, monkeypatch):
    """``exp --quick --only serve_mesh`` on 3 ranks: rank 0 writes the
    one-process leg's points with its keys (and the processes, the
    backend and each rank's cards), each point's ledger closing as the
    one process's does: offered == admitted + shed, the device counters
    equal the host's tallies, the per-host split sums to the totals."""
    monkeypatch.setenv("DINT_BENCH_MESH", "3x2")
    monkeypatch.delenv("DINT_MONITOR", raising=False)
    one = exp.run(str(tmp_path / "one"), window_s=0.3, quick=True,
                  only="serve_mesh", device="cpu")
    assert sorted(one) == ["serve_mesh_r50pct", "serve_mesh_r90pct",
                           "serve_mesh_sat"]
    torchrun("-m", "dint_tpu_torch.exp", "--only", "serve_mesh", "--quick",
             "--window", "0.3", "--device", "cpu", "--out",
             str(tmp_path / "ranks"))
    with open(tmp_path / "ranks" / "summary.json") as f:
        summary = json.load(f)
    assert summary["processes"] == 3 and summary["configs"] == sorted(one)
    for name, ref in one.items():
        with open(tmp_path / "ranks" / f"{name}.json") as f:
            art = json.load(f)
        assert set(art) == set(ref) | set(GROUP_FIELDS), name
        assert art["processes"] == 3 and art["backend"] == "gloo"
        assert art["rank_cards"] == [["cpu"]] * 3 and art["cards"] == ["cpu"]
        assert art["load"] == ref["load"] and art["widths"] == ref["widths"]
        _ledger(ref)
        _ledger(art)


def test_exp_multihost_sb_leg_monitored_under_torchrun(tmp_path):
    """``DINT_MONITOR=1 exp --only multihost_sb`` on 3 ranks: each closed
    point's counters are the mesh's, summed over the ranks (exp's drain,
    `counters.sum_over`): at least the window's attempted transactions
    (throughput x the window, which the timed window outlasts), where one
    rank's own partitions hold about a third, and the routing ledger
    closes."""
    torchrun("-m", "dint_tpu_torch.exp", "--only", "multihost_sb",
             "--quick", "--window", "0.3", "--device", "cpu", "--out",
             str(tmp_path), extra_env={"DINT_BENCH_MESH": "3x2",
                                       "DINT_MONITOR": "1"})
    for tag in ("hier", "flat"):
        with open(tmp_path / f"multihost_sb_{tag}_closed_w256.json") as f:
            art = json.load(f)
        c = art["counters"]
        assert c["txn_attempted"] >= art["throughput"] * 0.3 - 1 > 0
        assert c["route_ici_lanes"] + c["route_dcn_lanes"] == \
            c["lock_requests"] + c["install_writes"]
