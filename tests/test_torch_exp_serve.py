"""The port's serve sweep (dint_tpu_torch.exp `sweep_serve`) against
exp.py's on the CPU.

The quick ladder (tatp_dense at 2,000 subscribers, widths 64 and 256, the
saturation probe and a Poisson point at half its capacity, 0.05 s windows)
on both packages: each port artifact carries the keys of its JAX twin,
nested blocks included (the controller's service samples and journal),
and the same ``plan``; every point accounts exactly (offered == admitted
+ shed, the serve counters == the host tallies). Each point's engine and
its tables are gone when the next point starts. ``run(only="serve")``
runs both engines' legs and, as exp.py's run_all does, the mesh serve
leg and log_server, which the two-way filter matches too."""
import gc
import json
import weakref

import pytest

import exp as jexp
from dint_tpu_torch import exp

WINDOW = 0.05
N_SUB = 2000
POINTS = ["serve_tatp_sat", "serve_tatp_r50pct"]


def _shape(x):
    if isinstance(x, dict):
        return {k: None if k == "buckets" else _shape(v)
                for k, v in x.items()}
    return None


@pytest.fixture(scope="module")
def sweeps():
    port, ref = {}, {}
    exp.sweep_serve("serve_tatp", "tatp_dense", N_SUB, window_s=WINDOW,
                    open_rates=(0.5,), results=port, quick=True,
                    device="cpu")
    jexp.sweep_serve("serve_tatp", "tatp_dense", N_SUB, window_s=WINDOW,
                     open_rates=(0.5,), results=ref, quick=True)
    return json.loads(json.dumps(port)), json.loads(json.dumps(ref))


@pytest.mark.parametrize("name", POINTS)
def test_serve_points_carry_jax_keys(sweeps, name):
    port, ref = sweeps
    assert sorted(port) == sorted(ref) == sorted(POINTS)
    p, r = port[name], ref[name]
    assert _shape(p) == _shape(r)
    assert p["plan"] == r["plan"]
    assert p["widths"] == r["widths"] == [64, 256]
    assert p["load"] == r["load"] and p["mode"] == "serve"
    ss = p["controller"]["service_samples"]
    assert ss["n"] == len(ss["samples"]) > 0
    assert all(w in (64, 256) for w, _ in ss["samples"])


@pytest.mark.parametrize("name", POINTS)
def test_serve_points_account_exactly(sweeps, name):
    p = sweeps[0][name]
    sc = p["serve_counters"]
    assert p["offered"] == p["admitted"] + p["shed"] > 0
    assert sc["serve_occupancy_lanes"] == p["admitted"]
    assert sc["serve_shed_lanes"] == p["shed"]
    assert p["achieved_rate"] > 0 and p["slo_us"] == 5_000.0
    if name.endswith("_sat"):
        assert p["offered"] == 256 * 4 * 32      # widths[-1] * cpb * 32
        assert p["shed"] > 0


def test_rate_point_anchors_on_the_probe(sweeps):
    port = sweeps[0]
    peak = port["serve_tatp_sat"]["achieved_rate"]
    assert port["serve_tatp_r50pct"]["target_rate"] == round(peak * 0.5, 1)


def test_each_point_frees_its_engine(monkeypatch):
    refs = []

    class Tracked(exp.ServeEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            refs.append(weakref.ref(self))
            # the previous point's engine (and its tables) is gone
            assert all(r() is None for r in refs[:-1])

    monkeypatch.setattr(exp, "ServeEngine", Tracked)
    res = {}
    exp.sweep_serve("serve_tatp", "tatp_dense", N_SUB, window_s=WINDOW,
                    open_rates=(0.5, 0.9), results=res, quick=True,
                    device="cpu")
    assert len(refs) == 3 and sorted(res) == sorted(
        ["serve_tatp_sat", "serve_tatp_r50pct", "serve_tatp_r90pct"])
    gc.collect()
    assert all(r() is None for r in refs)


def test_run_only_serve_runs_both_legs(tmp_path, capsys):
    res = exp.run(str(tmp_path), window_s=WINDOW, quick=True, only="serve",
                  device="cpu")
    want = [f"serve_{e}_{p}" for e in ("tatp", "smallbank", "mesh")
            for p in ("sat", "r50pct", "r90pct")]
    # exp.py's two-way substring filter: "serve" is in "log_server" and
    # "serve_mesh" too
    assert sorted(res) == sorted(want + ["log_server"])
    for name in want:
        blk = res[name]
        assert blk["offered"] == blk["admitted"] + blk["shed"]
        assert blk["engine"] == {"tatp": "tatp_dense",
                                 "smallbank": "smallbank_dense",
                                 "mesh": "multihost_sb"}[name.split("_")[1]]
        if "mesh" in name:              # DINT_BENCH_MESH's default 4x2
            assert blk["mesh"]["n_hosts"] == 4 and len(blk["per_host"]) == 4
    assert "skipped" not in capsys.readouterr().out
