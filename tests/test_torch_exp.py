"""The port's microbenchmark sweep (dint_tpu_torch.exp) against exp.py's
`sweep_micro` on the CPU.

Every quick point runs on the port, and one point of each artifact shape
on JAX (store point, Zipf, scan ladder, lock trace, attributed lock, log,
the two wire benches, the wire transactions, colocate, cached store): each
port artifact carries the keys of its JAX twin, nested blocks included,
and the same ``plan``. Both sides take a 2^12-entry log ring where exp.py's
quick points take 2^20 (a gigabyte a ring on the CPU), and JAX's shim
binding loads the library the port builds from native/shim.cc, so nothing
under native/ is built or written. Then the port's own rules: a point that
raises ends the run with no retry, no error artifact and no summary; the
result sink writes each point as it lands; ``--skip-done`` skips a point
whose artifact is there; the entry point needs a card."""
import functools
import json
from pathlib import Path

import pytest

import exp as jexp
from dint_tpu.clients import micro as jmicro
from dint_tpu.clients import tatp_wire as jtw
from dint_tpu.shim import native as jnative
from dint_tpu_torch import exp
from dint_tpu_torch.clients import micro, tatp_wire as tw
from dint_tpu_torch.shim import native

WINDOW = 0.05
LOG_CAP = 1 << 12
# one JAX point of each artifact shape, and the port points that share it
SHAPE_OF = {
    "store_contention_w1024": ("store_contention_w1024",
                               "store_parallel_w1024"),
    "store_zipf_w1024": ("store_zipf_w1024",),
    "store_scan_f5": tuple(f"store_scan_f{f}" for f in (0, 5, 50, 95)),
    "lock_2pl": ("lock_2pl", "lock_fasst"),
    "lock_fasst_attr": ("lock_fasst_attr",),
    "log_server": ("log_server",),
    "store_wire": ("store_wire",),
    "tatp_wire": ("tatp_wire",),
    "tatp_wire_txn": ("tatp_wire_txn",),
    "tatp_colocate_c1": tuple(f"tatp_colocate_c{n}" for n in (1, 2, 4)),
    "store_cached_wb_bloom": tuple(f"store_cached_{t}" for t in
                                   ("wb_bloom", "wb_nobloom", "wt")),
}


def _small_logs(mp, micro_mod, wire_mod):
    mp.setattr(micro_mod, "LogClient",
               functools.partial(micro_mod.LogClient, capacity=LOG_CAP))
    mp.setattr(wire_mod, "serve_shards",
               functools.partial(wire_mod.serve_shards,
                                 log_capacity=LOG_CAP))


@pytest.fixture(scope="module")
def sweeps():
    # the one plan file both read (the reference's default is PLAN.json,
    # the port's PLAN_H100.json)
    plan = str(Path(__file__).resolve().parent.parent / "PLAN_H100.json")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DINT_PLAN_PATH", plan)
        _small_logs(mp, micro, tw)
        port = {}
        exp.sweep_micro(WINDOW, True, port, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DINT_PLAN_PATH", plan)
        # exp.py keeps the first plan it read in a process
        mp.setattr(jexp, "_PLAN_DOC", None)
        _small_logs(mp, jmicro, jtw)
        mp.setattr(jnative, "_SO", str(native.build()))
        mp.setattr(jnative, "_lib", None)
        ref = {}
        jexp.sweep_micro(WINDOW, True, ref, want=lambda n: n in SHAPE_OF)
    return port, ref


def _shape(x):
    """Nested keys of an artifact; a histogram's bucket indices are data."""
    if isinstance(x, dict):
        return {k: None if k == "buckets" else _shape(v)
                for k, v in x.items()}
    return None


def test_every_quick_point_runs():
    names = [n for group in SHAPE_OF.values() for n in group]
    assert len(names) == len(set(names)) == 20


@pytest.mark.parametrize("ref_name", sorted(SHAPE_OF))
def test_quick_points_carry_jax_keys(sweeps, ref_name):
    port, ref = sweeps
    assert "error" not in ref[ref_name]
    for name in SHAPE_OF[ref_name]:
        p = port[name]
        assert _shape(p) == _shape(ref[ref_name]), name
        assert p["plan"] == ref[ref_name]["plan"], name
        assert p["throughput"] > 0 and p["goodput"] > 0, name
        if "scan" in p and p["scan"] is not None:
            assert p["scan"]["use_pallas"] is None
    if ref_name == "tatp_wire_txn":
        p = port[ref_name]
        assert p["ab_timeout"] == p["timeout_lanes"] == 0
    if ref_name in ("store_wire", "tatp_wire"):
        snap = port[ref_name]["pump"]
        assert snap["occupancy_lanes"] + snap["padded_lanes"] \
            == snap["width"] * snap["batches"] > 0


def test_store_zipf_takes_use_hotset(monkeypatch):
    monkeypatch.setenv("DINT_USE_HOTSET", "1")
    out = {}
    exp.sweep_micro(WINDOW, True, out, want=lambda n: n == "store_zipf_w1024",
                    device="cpu")
    assert out["store_zipf_w1024"]["use_hotset"] is True
    exp.sweep_micro(WINDOW, True, out, want=lambda n: n == "store_zipf_w1024",
                    use_hotset=False, device="cpu")
    assert out["store_zipf_w1024"]["use_hotset"] is False


def test_raising_point_ends_the_run(monkeypatch, tmp_path):
    calls = []

    def boom(*a):
        calls.append(a)
        raise RuntimeError("boom")

    monkeypatch.setattr(exp, "_store_wire_bench", boom)
    with pytest.raises(RuntimeError, match="boom"):
        exp.run(str(tmp_path), window_s=WINDOW, quick=True,
                only="store_wire", device="cpu")
    assert len(calls) == 1
    assert list(tmp_path.iterdir()) == []


def test_result_sink_writes_each_point_and_skip_done(monkeypatch, tmp_path):
    res = exp.run(str(tmp_path), window_s=WINDOW, quick=True,
                  only="lock_fasst", device="cpu")
    assert sorted(res) == ["lock_fasst", "lock_fasst_attr"]
    for name in res:
        with open(tmp_path / f"{name}.json") as f:
            assert json.load(f) == json.loads(json.dumps(res[name]))
    with open(tmp_path / "summary.json") as f:
        summary = json.load(f)
    assert summary == {"configs": sorted(res), "window_s": WINDOW,
                       "quick": True}

    def refuse(*a, **k):
        raise AssertionError("a done point ran again")

    monkeypatch.setattr(exp, "_timed_client", refuse)
    again = exp.run(str(tmp_path), window_s=WINDOW, quick=True,
                    only="lock_fasst", skip_done=True, device="cpu")
    assert again == json.loads(json.dumps(res))
    with pytest.raises(AssertionError, match="ran again"):
        exp.run(str(tmp_path), window_s=WINDOW, quick=True,
                only="lock_fasst", device="cpu")


def test_main_needs_a_card(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        exp.main(["--quick", "--only", "lock_2pl", "--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        exp.sweep_micro(WINDOW, True, {}, want=lambda n: False)
