"""The port's pipeline sweep (dint_tpu_torch.exp `sweep_pipeline`) against
exp.py's on the CPU.

One quick closed, open and latency point per engine (TATP at 2,000
subscribers, SmallBank at 20,000 accounts, w = 256, 4 cohorts a block,
0.05 s windows) on both packages: each port artifact carries the keys of
its JAX twin, nested blocks included, and the same ``plan``; with
DINT_TRACE=1 and DINT_MONITOR=1 the closed point's ``counters`` and
``dinttrace`` blocks carry JAX's keys too. `_metric_json` and
`_percentiles` on the same inputs give equal dicts. Then the port's own
rules: every (trace, monitor) pairing of both engines drains by the flags
and reconciles with the stats of every block; ``--skip-done`` anchors the
open rates on a loaded closed point; ``--only smallbank_skew`` runs only
the preset; the mesh legs print exp.py's skip line below 3 hosts and run
with exp.py's keys at 3x1; a point whose warm block reads a bad magic
word, or whose attribution fails, raises."""
import json
from pathlib import Path

import numpy as np
import pytest

import exp as jexp
from dint_tpu.engines import smallbank_dense as jsd
from dint_tpu.engines import tatp_dense as jtd
from dint_tpu_torch import exp
from dint_tpu_torch.engines import smallbank_dense as sd
from dint_tpu_torch.engines import tatp_dense as td

WINDOW = 0.05
N_SUB, N_ACC, W, CPB = 2000, 20_000, 256, 4
NAMES = [f"{e}_{p}" for e in ("tatp", "smallbank")
         for p in (f"closed_w{W}", "open_50pct", f"latency_w{W}")]
FLAGS = ("DINT_TRACE", "DINT_MONITOR", "DINT_EXP_TRACE_DIR",
         "DINT_PLAN_OVERRIDE", "DINT_USE_HOTSET", "DINT_USE_FUSED")
# the one plan file both packages read where their artifacts are compared
# (the reference reads PLAN.json by default, the port PLAN_H100.json)
PLAN_H100 = str(Path(__file__).resolve().parent.parent / "PLAN_H100.json")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in FLAGS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(exp, "_PLAN_OVERRIDDEN", set())


def _engines(pkg):
    """(name, runner_fn, extras, n_stats, depth, magic, geom) of each
    engine in ``pkg`` (the port or JAX)."""
    if pkg is exp:
        return (
            ("tatp", lambda w, b: exp._tatp_runner(N_SUB, w, b,
                                                   device="cpu"),
             exp._tatp_extras, td.N_STATS, 3, td.STAT_MAGIC_BAD,
             {"k": td.K, "vw": 10}),
            ("smallbank", lambda w, b: exp._sb_runner(N_ACC, w, b,
                                                      device="cpu"),
             exp._sb_extras, sd.N_STATS, 2, sd.STAT_MAGIC_BAD,
             {"l": sd.L, "vw": sd.VW}))
    return (
        ("tatp", lambda w, b: jexp._tatp_runner(N_SUB, w, b),
         jexp._tatp_extras, jtd.N_STATS, 3, jtd.STAT_MAGIC_BAD,
         {"k": jtd.K, "vw": 10}),
        ("smallbank", lambda w, b: jexp._sb_runner(N_ACC, w, b),
         jexp._sb_extras, jsd.N_STATS, 2, jsd.STAT_MAGIC_BAD,
         {"l": jsd.L, "vw": jsd.VW}))


def _sweep(pkg, results, open_rates=(0.5,), lat_widths=(W,), only=None,
           wrap=None):
    for name, fn, extras, n_stats, depth, magic, geom in _engines(pkg):
        if only is not None and name != only:
            continue
        kw = {"device": "cpu"} if pkg is exp else {}
        pkg.sweep_pipeline(name, wrap(fn) if wrap else fn, extras, n_stats,
                           widths=[W], cpb=CPB, depth=depth,
                           magic_idx=magic, window_s=WINDOW,
                           open_rates=open_rates, results=results,
                           lat_widths=lat_widths, geom=geom, **kw)
    return json.loads(json.dumps(results))


def _shape(x):
    """Nested keys of an artifact; a histogram's bucket indices are data."""
    if isinstance(x, dict):
        return {k: None if k == "buckets" else _shape(v)
                for k, v in x.items()}
    return None


@pytest.fixture(scope="module")
def sweeps():
    with pytest.MonkeyPatch.context() as mp:
        for k in FLAGS:
            mp.delenv(k, raising=False)
        mp.setenv("DINT_PLAN_PATH", PLAN_H100)
        # exp.py keeps the first plan it read in a process
        mp.setattr(jexp, "_PLAN_DOC", None)
        port = _sweep(exp, {})
        ref = _sweep(jexp, {})
        mp.setenv("DINT_TRACE", "1")
        mp.setenv("DINT_MONITOR", "1")
        port_on = _sweep(exp, {}, open_rates=(), lat_widths=(), only="tatp")
        ref_on = _sweep(jexp, {}, open_rates=(), lat_widths=(),
                        only="tatp")
    return port, ref, port_on, ref_on


@pytest.mark.parametrize("name", NAMES)
def test_points_carry_jax_keys(sweeps, name):
    port, ref = sweeps[:2]
    assert sorted(port) == sorted(ref) == sorted(NAMES)
    p, r = port[name], ref[name]
    assert _shape(p) == _shape(r)
    assert p["plan"] == r["plan"] and p["plan"]["overridden"] == []
    assert p["mode"] == r["mode"] and p["width"] == r["width"] == W
    assert p["schema"] == r["schema"] and p["breakdown"] is None
    assert p["throughput"] > 0 and p["goodput"] > 0
    if name.endswith(f"closed_w{W}"):
        assert p["counters"] is None and p["dinttrace"] is None
    if "open" in name:
        assert p["load_frac"] == 0.5 and p["offered_rate"] > 0
        assert set(p["queue"]) == set(r["queue"]) and \
            set(p["service"]) == set(r["service"])


def test_traced_monitored_point_carries_jax_keys(sweeps):
    port_on, ref_on = sweeps[2:]
    name = f"tatp_closed_w{W}"
    p, r = port_on[name], ref_on[name]
    assert _shape(p) == _shape(r)
    assert set(p["counters"]) == set(r["counters"])
    assert p["dinttrace"]["dropped"] == 0 and p["dinttrace"]["events"] > 0


def test_metric_json_and_percentiles_equal_jax():
    rng = np.random.default_rng(3)
    blocks = [rng.exponential(500.0, 4) for _ in range(37)]
    p, rp = exp._percentiles(blocks), jexp._percentiles(blocks)
    assert p == rp
    extra = {"ab_lock": 3, "mode": "closed", "width": 256, "counters": None}
    bd = {"kind": "dintscope_breakdown", "waves": {}}
    for breakdown in (None, bd):
        assert exp._metric_json(9_001, 7_777, 1.25, p, dict(extra),
                                breakdown=breakdown) == \
            jexp._metric_json(9_001, 7_777, 1.25, rp, dict(extra),
                              breakdown=breakdown)


def _counting(rec):
    """A runner_fn wrapper that keeps every block's and drain's stats and
    hands on the traced runner's monitor."""
    def wrap(fn):
        def runner(w, b):
            run, carry, drain = fn(w, b)

            def counted(carry, gen):
                carry, s = run(carry, gen)
                rec.append(s)
                return carry, s

            def drained(carry):
                out = drain(carry)
                rec.append(out[1])
                return out

            counted.txn_monitor = getattr(run, "txn_monitor", None)
            return counted, carry, drained
        return runner
    return wrap


@pytest.mark.parametrize("engine", ["tatp", "smallbank"])
@pytest.mark.parametrize("trace,monitor", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_every_flag_pairing_drains_by_the_flags(monkeypatch, engine, trace,
                                                monitor):
    if trace:
        monkeypatch.setenv("DINT_TRACE", "1")
    if monitor:
        monkeypatch.setenv("DINT_MONITOR", "1")
    rec = []
    res = _sweep(exp, {}, open_rates=(), lat_widths=(), only=engine,
                 wrap=_counting(rec))
    blk = res[f"{engine}_closed_w{W}"]
    stat = td if engine == "tatp" else sd
    total = sum(s.numpy().astype(np.int64).sum(axis=0) for s in rec)
    if monitor:
        c = blk["counters"]
        assert c["txn_attempted"] == int(total[stat.STAT_ATTEMPTED]) > 0
        assert c["txn_committed"] == int(total[stat.STAT_COMMITTED])
    else:
        assert blk["counters"] is None
    if trace:
        d = blk["dinttrace"]
        # every block observed, warm blocks and the drain included
        assert d["windows"] == len(rec) and d["dropped"] == 0
        assert d["events"] > 0
    else:
        assert blk["dinttrace"] is None
    # the open and latency points drain under the same flags
    res = _sweep(exp, {}, open_rates=(0.5,), lat_widths=(W,), only=engine)
    assert res[f"{engine}_open_50pct"]["goodput"] > 0
    assert res[f"{engine}_latency_w{W}"]["steps"] > 0


def test_drain_refuses_a_runner_built_under_other_flags(monkeypatch):
    monkeypatch.setenv("DINT_TRACE", "1")
    run, carry, drain = exp._tatp_runner(N_SUB, W, CPB, device="cpu")
    assert hasattr(run, "txn_monitor")
    monkeypatch.delenv("DINT_TRACE")
    with pytest.raises(ValueError, match="the drain returned 3 items"):
        exp._drain(drain, carry)


def test_skip_done_anchors_open_rates_on_a_loaded_closed_point(tmp_path):
    name = f"tatp_closed_w{W}"
    with open(tmp_path / f"{name}.json", "w") as f:
        json.dump({"throughput": 123_456.0, "width": W, "goodput": 1.0},
                  f)
    res = exp._ResultSink(str(tmp_path), skip_done=True)
    calls = []

    def runner(w, b):
        calls.append((w, b))
        return exp._tatp_runner(N_SUB, w, b, device="cpu")

    exp.sweep_pipeline("tatp", runner, exp._tatp_extras, td.N_STATS,
                       widths=[W], cpb=CPB, depth=3,
                       magic_idx=td.STAT_MAGIC_BAD, window_s=WINDOW,
                       open_rates=(0.5,), results=res, device="cpu")
    assert calls == [(W, CPB)]        # the open point's runner alone
    op = res["tatp_open_50pct"]
    assert op["target_rate"] == round(123_456.0 * 0.5, 1)
    assert op["width"] == W
    with open(tmp_path / "tatp_open_50pct.json") as f:
        assert json.load(f) == json.loads(json.dumps(op))


def test_only_smallbank_skew_runs_only_the_preset(tmp_path):
    res = exp.run(str(tmp_path), window_s=WINDOW, quick=True,
                  only="smallbank_skew", device="cpu")
    want = [f"smallbank_skew_h{int(f * 100):02d}_closed_w256"
            for f in exp.SKEW_FRACS]
    assert sorted(res) == sorted(want)
    for f, name in zip(exp.SKEW_FRACS, want):
        assert res[name]["hot_frac"] == f and res[name]["hot_prob"] == 0.9
        assert res[name]["use_hotset"] is False     # PLAN_H100.json's pin
    with open(tmp_path / "summary.json") as f:
        assert json.load(f)["configs"] == sorted(want)


@pytest.mark.parametrize("only", ["serve_mesh", "multihost_sb"])
def test_mesh_legs_print_the_skip_line(tmp_path, capsys, monkeypatch, only):
    """Fewer than 3 hosts: exp.py's skip line and no point."""
    monkeypatch.setenv("DINT_BENCH_MESH", "2x4")
    res = exp.run(str(tmp_path), window_s=WINDOW, quick=True, only=only,
                  device="cpu")
    assert res == {}
    out = capsys.readouterr().out
    assert f"{only}: skipped (2x4 mesh needs 8 devices and >= 3 hosts; " \
           f"have 1 devices)" in out


def test_mesh_leg_runs_at_quick_size_with_jax_keys(tmp_path, monkeypatch):
    """At DINT_BENCH_MESH=3x1 the multihost_sb leg runs on the one device:
    its hier and flat points carry the keys of exp.py's leg (run by hand
    as exp.py's run_all does, over 3 of the virtual devices), the mesh
    and ``hierarchical``; both routes commit the same work."""
    monkeypatch.setenv("DINT_BENCH_MESH", "3x1")
    monkeypatch.setenv("DINT_PLAN_PATH", PLAN_H100)
    monkeypatch.setattr(jexp, "_PLAN_DOC", None)
    res = exp.run(str(tmp_path), window_s=WINDOW, quick=True,
                  only="multihost_sb", device="cpu")
    names = [f"multihost_sb_{t}_closed_w{W}" for t in ("hier", "flat")]
    assert sorted(res) == sorted(names)
    from dint_tpu.engines import smallbank_pipeline as jsp
    from dint_tpu.parallel import dense_sharded_sb as jdsb
    ref = {}
    extra = {"n_shards": 3,
             "mesh": {"n_hosts": 3, "n_ici": 1, "axes": ["dcn", "ici"]}}
    for tag, hier in (("hier", True), ("flat", False)):
        jexp.sweep_pipeline(
            f"multihost_sb_{tag}",
            lambda w, b, h=hier: jexp._mh_sb_runner(N_ACC, w, b, h),
            jexp._mh_sb_extras, jdsb.N_STATS, widths=[W], cpb=CPB, depth=2,
            magic_idx=jsp.STAT_MAGIC_BAD, window_s=WINDOW, open_rates=(),
            results=ref, point_extra=dict(extra, hierarchical=hier),
            geom={"l": 3, "vw": 2, "d": 3})
    ref = json.loads(json.dumps(ref))
    for name in names:
        p, r = res[name], ref[name]
        assert _shape(p) == _shape(r), name
        assert {k: p[k] for k in ("n_shards", "mesh", "hierarchical",
                                  "mode", "width", "plan")} == \
            {k: r[k] for k in ("n_shards", "mesh", "hierarchical", "mode",
                               "width", "plan")}
        assert p["goodput"] > 0 and p["route_overflow"] == 0


def test_bad_magic_in_a_warm_block_raises():
    def tampered(w, b):
        run, carry, drain = exp._tatp_runner(N_SUB, w, b, device="cpu")
        calls = []

        def bad(carry, gen):
            carry, s = run(carry, gen)
            if not calls:
                s = s.clone()
                s[0, td.STAT_MAGIC_BAD] = 1
            calls.append(1)
            return carry, s

        return bad, carry, drain

    with pytest.raises(RuntimeError, match="magic-byte integrity"):
        exp.sweep_pipeline("tatp", tampered, exp._tatp_extras, td.N_STATS,
                           widths=[W], cpb=CPB, depth=3,
                           magic_idx=td.STAT_MAGIC_BAD, window_s=WINDOW,
                           open_rates=(), results={}, device="cpu")


def test_a_failed_attribution_raises(monkeypatch, tmp_path):
    # a CPU profile holds no device slice, so the attribution raises and
    # the point with it: no artifact, no null breakdown
    monkeypatch.setenv("DINT_EXP_TRACE_DIR", str(tmp_path / "trace"))
    res = {}
    with pytest.raises(ValueError, match="device"):
        exp.sweep_pipeline("tatp",
                           lambda w, b: exp._tatp_runner(N_SUB, w, b,
                                                         device="cpu"),
                           exp._tatp_extras, td.N_STATS, widths=[W],
                           cpb=CPB, depth=3, magic_idx=td.STAT_MAGIC_BAD,
                           window_s=WINDOW, open_rates=(0.5,), results=res,
                           geom={"k": td.K, "vw": 10}, device="cpu")
    assert res == {}
    assert list((tmp_path / "trace").glob("*.trace.json"))


def test_plan_override_is_recorded(monkeypatch):
    monkeypatch.setenv("DINT_PLAN_OVERRIDE", "1")
    monkeypatch.setenv("DINT_USE_FUSED", "1")
    res = _sweep(exp, {}, open_rates=(), lat_widths=(), only="tatp")
    assert res[f"tatp_closed_w{W}"]["plan"]["overridden"] == ["use_fused"]
