"""The port's bench entry (dint_tpu_torch.bench, clients/bench_smallbank,
the stats window and entry()) against bench.py's measurement,
`dint_tpu.stats` and `__graft_entry__` on the CPU.

The stats helpers run the same seeded block times, and the two window
loops the same fake runner on a fake clock, in both packages: every
output is equal. The bench itself runs at a tiny geometry on the CPU
(where its timings say nothing of the card): its line must hold bench.py's
keys, and a corrupted magic word or SmallBank balance must make it raise.
`entry()`'s step is bit-identical to `__graft_entry__.entry()`'s on JAX's
draws of ``PRNGKey(0)``."""
import ast
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dint_tpu import stats as jst
from dint_tpu.analysis import plan as dplan
from dint_tpu_torch import bench, convert, entry
from dint_tpu_torch import plan as pplan
from dint_tpu_torch import stats as pst
from dint_tpu_torch.engines import smallbank_dense as sd
from dint_tpu_torch.engines import tatp_dense as td
from dint_tpu_torch.engines.types import ROUTES
from dint_tpu_torch.ops import u32

REPO = Path(__file__).resolve().parent.parent
TINY = {"DINT_BENCH_SUBSCRIBERS": "2000", "DINT_BENCH_WIDTH": "256",
        "DINT_BENCH_BLOCK": "4", "DINT_BENCH_WINDOW_S": "0.2",
        "DINT_BENCH_SB_WIDTH": "256", "DINT_BENCH_SB_ACCOUNTS": "300"}

# bench.py's line (bench.py:362-453, 466-485) with the SmallBank leg
# (dint_tpu/clients/bench_smallbank.py:49-58, bench.py:614), less
# use_pallas/use_hotset, plus the port's route, device and card
LINE_KEYS = {
    "schema", "metric", "value", "unit", "vs_baseline", "mode",
    "throughput", "abort_rate", "contention_abort_rate", "ab_lock",
    "ab_missing", "ab_validate", "avg_us", "p50_us", "p99_us", "p999_us",
    "lat_samples", "lat_hist", "n_subscribers", "width", "n_shards", "mesh",
    "route", "device", "card", "hot_frac", "hot_prob", "plan", "counters",
    "dinttrace", "serve", "dintlint", "breakdown", "blocks", "window_s",
    "host_ucores", "host_kcores", "proc_ucores", "proc_kcores", "dintcost",
    "dintdur", "smallbank_committed_txns_per_sec", "smallbank_abort_rate",
    "smallbank_width", "smallbank_points", "smallbank_route",
    "smallbank_use_hotset", "smallbank_hot_frac", "smallbank_hot_prob",
    "smallbank_balance_conserved", "smallbank_plan"}


class FakeClock:
    def __init__(self):
        self.t = 1_000.0

    def __call__(self):
        return self.t


# ------------------------------------------------------------ stats helpers


def _block_times(seed, n=40):
    return list(np.random.default_rng(seed).uniform(0.01, 0.05, n))


@pytest.mark.parametrize("n", [0, 1, 2, 3, 40])
def test_steady_blocks_and_cohort_latency_match_jax(n):
    bs = _block_times(n, n)
    assert pst.steady_blocks(bs) == jst.steady_blocks(bs)
    for cpb, depth in ((16, 3), (4, 3), (1, 1), (2, 5)):
        assert (pst.cohort_latency_percentiles(bs, cpb, depth)
                == jst.cohort_latency_percentiles(bs, cpb, depth))


def test_histogram_merge_and_from_dict_match_jax():
    rng = np.random.default_rng(7)
    a, b = rng.lognormal(3, 2, 5000), rng.lognormal(1, 3, 3000)
    b[:5] = [np.nan, np.inf, -1.0, 0.0, 1e12]
    hists = []
    for mod in (jst, pst):
        ha, hb = mod.LatencyHistogram(), mod.LatencyHistogram()
        ha.add(a)
        hb.add(b)
        merged = ha.merge(hb)
        assert merged is ha
        back = mod.LatencyHistogram.from_dict(merged.to_dict())
        assert back.to_dict() == merged.to_dict()
        assert back._edge(17) == jst.LatencyHistogram()._edge(17)
        with pytest.raises(ValueError, match="geometry"):
            mod.LatencyHistogram.from_dict({"per_octave": 4})
        hists.append((merged.to_dict(), merged.percentiles(),
                      merged.counts.copy()))
    assert hists[0][:2] == hists[1][:2]
    assert np.array_equal(hists[0][2], hists[1][2])


def test_stat_clock_and_window_match_jax(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(time, "monotonic", clock)
    assert pst.Window().total_s == jst.Window().total_s == 15.0
    cj = jst.StatClock(jst.Window(0.5, 1.0))
    cp = pst.StatClock(pst.Window(0.5, 1.0))
    rng = np.random.default_rng(0)
    phases = set()
    for _ in range(40):
        clock.t += rng.uniform(0, 0.1)
        pj, pp = cj.tick(), cp.tick()
        assert (pj, cj.measuring, cj.measured_s) == \
            (pp, cp.measuring, cp.measured_s)
        phases.add(pj)
    assert phases == {"warmup", "measure", "done"}


def test_cpu_monitor_reports_the_same_block():
    j, p = jst.CpuMonitor(), pst.CpuMonitor()
    sum(range(200_000))
    cj, cp = j.cores(), p.cores()
    assert cj.keys() == cp.keys()
    assert all(v >= 0 for v in cp.values())


def _fake_runner(clock, to_tensor, cpb=2, n_stats=3):
    """A runner whose block takes 13-17 ms of the fake clock and whose
    stats are a function of the block index alone."""
    def runner(state, _key_or_gen):
        clock.t += 0.013 + 0.001 * (state % 5)
        s = (np.arange(n_stats)[None, :] + 10 * state
             + np.arange(cpb)[:, None]).astype(np.int32)
        return state + 1, to_tensor(s)
    return runner


@pytest.mark.parametrize("warmup", [0, 1, 3])
def test_run_window_matches_jax_on_a_fake_runner(monkeypatch, warmup):
    clock = FakeClock()
    monkeypatch.setattr(time, "time", clock)
    j = jst.run_window(_fake_runner(clock, np.asarray), 0,
                       jax.random.PRNGKey(0), 0.3, 3, warmup_blocks=warmup)
    p = pst.run_window(_fake_runner(clock, torch.from_numpy), 0,
                       torch.Generator(), 0.3, 3, warmup_blocks=warmup)
    state, total, warm, dt, blocks, block_s = p
    assert state == j[0] and blocks == j[4] > 10
    assert np.array_equal(total, j[1]) and np.array_equal(warm, j[2])
    assert dt == j[3] and block_s == j[5]


def test_run_latency_window_matches_jax_on_a_fake_runner(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(time, "time", clock)
    j = jst.run_latency_window(_fake_runner(clock, np.asarray, cpb=1), 0,
                               jax.random.PRNGKey(0), 0.3, 3, depth=3)
    p = pst.run_latency_window(_fake_runner(clock, torch.from_numpy, cpb=1),
                               0, torch.Generator(), 0.3, 3, depth=3)
    assert p[0] == j[0] and np.array_equal(p[1], j[1])
    assert p[2:4] == j[2:4] and p[3] > 10
    assert p[4] == j[4] and p[4]["n"] == p[3] - 2


# ------------------------------------------------------------------- bench


@pytest.fixture(scope="module")
def tiny_line():
    return bench.measure(env=TINY, device="cpu")


def _literal_keys(path, func, var=None):
    """Constant keys of the dict literal assigned to ``var`` (or returned,
    when ``var`` is None) in ``func`` of the file at ``path``."""
    tree = ast.parse(path.read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == func)
    for n in ast.walk(fn):
        if var is None and isinstance(n, ast.Return) and \
                isinstance(n.value, ast.Dict):
            node = n.value
        elif var is not None and isinstance(n, ast.Assign) and \
                isinstance(n.value, ast.Dict) and \
                getattr(n.targets[0], "id", None) == var:
            node = n.value
        else:
            continue
        return {k.value for k in node.keys if isinstance(k, ast.Constant)}
    raise AssertionError(f"no dict literal in {func}")


def test_tiny_bench_line_has_bench_py_keys(tiny_line):
    line = tiny_line
    assert set(line) == LINE_KEYS
    ref = (_literal_keys(REPO / "bench.py", "_child_main", "out")
           | _literal_keys(REPO / "dint_tpu/clients/bench_smallbank.py",
                           "run"))
    assert ref - {"use_pallas", "use_hotset"} <= set(line)
    assert json.loads(json.dumps(line)) == line
    assert line["schema"] == 2 and line["value"] > 0
    assert line["metric"] == "tatp_committed_txns_per_sec"
    assert line["route"] == "default" and line["smallbank_route"] == "default"
    assert line["device"] == "cpu" and line["card"] is None
    assert line["n_subscribers"] == 2000 and line["width"] == 256
    assert line["blocks"] > 0 and line["lat_samples"] > 0
    assert line["smallbank_balance_conserved"] is True
    assert line["smallbank_committed_txns_per_sec"] > 0
    assert [p["width"] for p in line["smallbank_points"]] == [256]
    for k in ("counters", "dinttrace", "serve", "dintlint", "breakdown",
              "dintcost", "dintdur", "n_shards", "mesh"):
        assert line[k] is None, k
    assert pst.LatencyHistogram.from_dict(line["lat_hist"]).n == \
        line["lat_samples"]


def test_bench_profile_monitor_and_skip_sb():
    line = bench.measure(env=dict(TINY, DINT_BENCH_PROFILE="1",
                                  DINT_MONITOR="1", DINT_BENCH_SKIP_SB="1"),
                         device="cpu")
    assert line["smallbank_skipped"] and "smallbank_points" not in line
    assert line["counters"]["txn_committed"] > 0
    prof = line["profile"]
    assert set(prof["launches"]) == {"tatp"}
    assert prof["step_ms"] > 0 and prof["populate_s"] >= 0


def test_bench_raises_on_a_bad_magic_word(monkeypatch):
    real = td.populate_device

    def corrupted(*a, **kw):
        db = real(*a, **kw)
        db.val[1::db.val_words] = 0
        return db

    monkeypatch.setattr(td, "populate_device", corrupted)
    with pytest.raises(RuntimeError, match="magic"):
        bench.measure(env=dict(TINY, DINT_BENCH_SKIP_SB="1"), device="cpu")


def test_bench_raises_when_a_balance_is_not_conserved(monkeypatch):
    real = sd.build_pipelined_runner

    def corrupted(*a, **kw):
        run, init, drain = real(*a, **kw)

        def bad_drain(carry):
            db, tail = drain(carry)
            db.bal[0] += 1
            return db, tail
        return run, init, bad_drain

    monkeypatch.setattr(sd, "build_pipelined_runner", corrupted)
    with pytest.raises(RuntimeError, match="conservation"):
        bench.measure(env=TINY, device="cpu")


@pytest.mark.parametrize("env", [
    {},
    {"DINT_USE_FUSED": "1"},                       # no override: ignored
    {"DINT_PLAN_OVERRIDE": "1", "DINT_USE_FUSED": "1"},
    {"DINT_PLAN_OVERRIDE": "1", "DINT_USE_HOTSET": "1",
     "DINT_USE_FUSED": "0"},
    {"DINT_PLAN_OVERRIDE": "1", "DINT_USE_HOTSET": "1",
     "DINT_USE_FUSED": "1"},
])
def test_route_is_plan_json_pins_as_plan_resolves_them(env):
    """The route is the port's pinned plan's (PLAN_H100.json), resolved as
    the reference's resolve_for resolves the same document."""
    doc = pplan.load_plan()
    for wl in ("tatp_uniform", "smallbank_skewed"):
        knobs, meta = dplan.resolve_for(wl, environ=env, plan=doc)
        route, pmeta = bench.plan_route(wl, env)
        assert ROUTES[route] == (knobs["use_hotset"], knobs["use_fused"])
        assert pmeta["source"] == str(REPO / "PLAN_H100.json")
        assert {k: v for k, v in pmeta.items() if k != "source"} == \
            {k: v for k, v in meta.items() if k != "source"}
    if not env:
        pinned = json.loads((REPO / "PLAN_H100.json").read_text())[
            "workloads"]
        assert all(not pinned[w]["pinned"][k]
                   for w in ("tatp_uniform", "smallbank_skewed")
                   for k in ("use_hotset", "use_fused"))
        assert bench.plan_route("tatp_uniform", env)[0] == "default"


def _old_plan_route(workload, env):
    """The bench's route rule before it read the plan through
    `dint_tpu_torch.plan`, kept here to hold the new one to it (on the
    port's plan file, PLAN_H100.json)."""
    plan = json.loads((REPO / "PLAN_H100.json").read_text())
    knobs = {k: bool(v) for k, v in plan["workloads"][workload]["pinned"]
             .items() if k in ("use_hotset", "use_fused")}
    overridden = []
    if env.get("DINT_PLAN_OVERRIDE", "0") == "1":
        for name in knobs:
            raw = env.get("DINT_" + name.upper())
            if raw is not None and (raw not in ("", "0")) != knobs[name]:
                knobs[name] = not knobs[name]
                overridden.append(name)
    route = {v: k for k, v in ROUTES.items()}[(knobs["use_hotset"],
                                               knobs["use_fused"])]
    return route, {"source": str(REPO / "PLAN_H100.json"),
                   "hash": plan.get("provenance", {}).get("cost_model_hash"),
                   "overridden": overridden}


@pytest.mark.parametrize("override", ["0", "1"])
def test_plan_route_is_unchanged_for_every_workload_it_reads(override):
    """The bench's plan record and route through `dint_tpu_torch.plan` are
    what they were, for each plan workload the bench reads, under
    every combination of the two route flags."""
    for hot in (None, "", "0", "1"):
        for fused in (None, "0", "1", "true"):
            env = {"DINT_PLAN_OVERRIDE": override}
            if hot is not None:
                env["DINT_USE_HOTSET"] = hot
            if fused is not None:
                env["DINT_USE_FUSED"] = fused
            for wl in ("tatp_uniform", "smallbank_skewed"):
                assert bench.plan_route(wl, env) == _old_plan_route(wl, env)


def _reference_serve_keys():
    """The keys bench.py's serve probe copies from the snapshot
    (bench.py:353-356): the tuple the comprehension iterates."""
    tree = ast.parse((REPO / "bench.py").read_text())
    for n in ast.walk(tree):
        if isinstance(n, ast.DictComp) and \
                isinstance(n.generators[0].iter, ast.Tuple):
            keys = tuple(e.value for e in n.generators[0].iter.elts)
            if "achieved_rate" in keys:
                return keys
    raise AssertionError("no serve probe keys in bench.py")


def test_bench_serve_probe_fills_the_reference_keys():
    """DINT_BENCH_SERVE=1: ``serve`` holds the eleven keys bench.py's probe
    keeps, from a ServeEngine of the bench width on the bench's own path
    (8 blocks' worth of arrivals at t = 0, after the warmup)."""
    keys = _reference_serve_keys()
    assert len(keys) == 11 and bench.SERVE_KEYS == keys
    line = bench.measure(env=dict(TINY, DINT_BENCH_SERVE="1",
                                  DINT_BENCH_SKIP_SB="1"), device="cpu")
    s = line["serve"]
    assert tuple(s) == keys
    assert s["offered"] == s["admitted"] + s["shed"] == 256 * 4 * 8
    assert s["blocks"] > 0 and s["achieved_rate"] > 0
    assert s["controller"]["width"] == 256
    assert s["plan"] == pplan.resolve_for("tatp_serve", environ={})[1]
    assert s["plan"]["source"] == str(REPO / "PLAN_H100.json")
    assert s["slo_us"] == 5000.0 and isinstance(s["slo_met"], bool)
    assert set(s["queue"]) == {"avg", "p50", "p99", "p999", "hist"}
    assert s["service"]["hist"]["n"] == s["blocks"]
    assert s["queue"]["hist"]["n"] == s["admitted"]
    assert json.loads(json.dumps(line))["serve"]["offered"] == 256 * 4 * 8


def test_bench_needs_a_card(monkeypatch):
    """Without a card the module exits non-zero and prints no line; the
    entry points raise."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO),
               **TINY)
    out = subprocess.run([sys.executable, "-m", "dint_tpu_torch.bench"],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "no CUDA device" in out.stderr
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: bench.measure(env=TINY), entry.entry):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# ------------------------------------------------------------------- entry


def _graft_entry():
    spec = importlib.util.spec_from_file_location(
        "_graft_entry", REPO / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.entry()


def _ctx_equal(jc, pc):
    for name in vars(pc):
        a, b = np.asarray(getattr(jc, name)), getattr(pc, name)
        b = u32.to_numpy(b) if a.dtype == np.uint32 else b.numpy()
        assert np.array_equal(a, b), name


def test_entry_step_is_bit_identical_to_the_graft_entry():
    jfn, jargs = _graft_entry()
    pfn, pargs = entry.entry(device="cpu")
    # the same populate draws
    jdb = jargs[0]
    pdb = convert.dense_db_to_numpy(pargs[0])
    for k in ("val", "meta", "arb", "log.entries", "log.head"):
        leaf = jdb.log.entries if k == "log.entries" else \
            jdb.log.head if k == "log.head" else getattr(jdb, k)
        assert np.array_equal(np.asarray(leaf), pdb[k]), k
    # JAX's draws of PRNGKey(0), replayed into the port
    kg, kv = jax.random.split(jargs[3])
    bits = u32.from_numpy(np.asarray(jax.random.bits(kg, (64, 4),
                                                     jnp.uint32)), "cpu")
    payload = torch.from_numpy(np.array(jax.random.randint(
        kv, (64, 2), 0, 1 << 16, dtype=jnp.int32)))
    jout = jfn(*jargs)
    pout = pfn(*pargs[:3], bits, payload)
    jdb1, pdb1 = jout[0], convert.dense_db_to_numpy(pout[0])
    for k in ("val", "meta", "arb"):
        assert np.array_equal(np.asarray(getattr(jdb1, k)), pdb1[k]), k
    assert np.array_equal(np.asarray(jdb1.log.entries), pdb1["log.entries"])
    assert np.array_equal(np.asarray(jdb1.log.head), pdb1["log.head"])
    assert int(np.asarray(jdb1.step)) == pout[0].step
    _ctx_equal(jout[1], pout[1])
    _ctx_equal(jout[2], pout[2])
    assert np.array_equal(np.asarray(jout[3]), pout[3].numpy())
    assert int(pout[1].attempted) == 64


def test_entry_runs_on_its_own_draws():
    fn, args = entry.entry(device="cpu")
    assert tuple(args[3].shape) == (64, 4) and tuple(args[4].shape) == (64, 2)
    db, new, c1, stats = fn(*args)
    assert int(new.attempted) == 64 and stats.shape == (td.N_STATS,)
    assert db.step == 3


# -------------------------------------------------------------- artifact


def test_persist_artifact_writes_bench_py_file(tmp_path, monkeypatch):
    """bench.py's artifact: ``commit`` and ``ts`` stamped into the line,
    the line written to BENCH_<commit>_<ts>.json (the commit is "unknown"
    outside a git work tree); a failed write raises."""
    import bench as jbench
    out = {"metric": "tatp_committed_txns_per_sec", "value": 1.0}
    path = bench._persist_artifact(out, str(tmp_path / "artifacts"))
    assert set(out) == {"metric", "value", "commit", "ts"}
    assert os.path.basename(path) == f"BENCH_{out['commit']}_{out['ts']}.json"
    with open(path) as f:
        assert json.load(f) == out
    assert time.strptime(out["ts"], "%Y%m%dT%H%M%SZ")
    assert out["commit"] == jbench._git_head()
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: (_ for _ in ())
                        .throw(FileNotFoundError("git")))
    assert bench._git_head() == "unknown"
    blocker = tmp_path / "file"
    blocker.write_text("")
    with pytest.raises(OSError):
        bench._persist_artifact({}, str(blocker / "artifacts"))
