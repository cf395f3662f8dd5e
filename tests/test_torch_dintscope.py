"""The port's dintscope timing plane (dint_tpu_torch.monitor.waves and
.attrib, python -m dint_tpu_torch.dintscope) against
`dint_tpu.monitor.waves` and `.attrib` on the CPU.

The wave registry is JAX's, ordinals included (a wave's ordinal is packed
into every dinttrace record). `scope` is a torch.profiler range under a
profiler and a null context without one. Attribution is translated, not
copied: on the port's synthetic torch-profiler trace every registered
wave is charged, each kernel through its launch's correlation id, the
annotation slices are never device time, and a trace with no device slice
raises. A CPU profile of traced steps shows each wave's host ranges, never
nested. The breakdown's diff gate and loader return JAX's results on
JAX's own breakdown of tests/fixtures/dintscope_trace.json (read, never
written)."""
import contextlib
import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dint_tpu.monitor import attrib as jattrib
from dint_tpu.monitor import waves as jwaves
from dint_tpu_torch import dintscope
from dint_tpu_torch.engines import smallbank_dense as sd
from dint_tpu_torch.engines import tatp_dense as td
from dint_tpu_torch.engines.types import ROUTES
from dint_tpu_torch.monitor import attrib, waves

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "fixtures" / "dintscope_trace.json"
GEOM = {"w": 8192, "k": 4, "l": 3, "vw": 10, "d": 8, "lg": 13, "sl": 8,
        "dc": 64}
STEPS = 3


def test_registry_equals_jax_ordinals_included():
    assert waves.ALL_WAVES == jwaves.ALL_WAVES
    assert {n: i for i, n in enumerate(waves.ALL_WAVES)} == \
        {n: i for i, n in enumerate(jwaves.ALL_WAVES)}
    assert waves.WAVE_DOCS == jwaves.WAVE_DOCS
    assert waves.WAVE_BYTES == jwaves.WAVE_BYTES
    assert waves.ENGINES == jwaves.ENGINES
    assert waves.WAVES_BY_ENGINE == jwaves.WAVES_BY_ENGINE
    for name in waves.ALL_WAVES:
        assert waves.wave_bytes(name, **GEOM) == \
            jwaves.wave_bytes(name, **GEOM)
    assert attrib.WAVE_ALIASES == jattrib.WAVE_ALIASES
    assert (attrib.ARTIFACT_SCHEMA, attrib.BREAKDOWN_SCHEMA) == \
        (jattrib.ARTIFACT_SCHEMA, jattrib.BREAKDOWN_SCHEMA)


def test_scope_rejects_an_unregistered_wave():
    with pytest.raises(KeyError, match="registry"):
        waves.scope("tatp_dense", "no_such_wave")


def test_scope_is_a_null_context_without_a_profiler(monkeypatch):
    assert not waves.profiler_running()
    assert isinstance(waves.scope("tatp_dense", "gen"),
                      contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ctx = waves.scope("tatp_dense", "gen")
        assert isinstance(ctx, torch.profiler.record_function)
        with ctx:
            torch.ones(2).add_(1)
        monkeypatch.setenv("DINT_SCOPE", "0")
        assert isinstance(waves.scope("tatp_dense", "gen"),
                          contextlib.nullcontext)
    assert "dint.tatp_dense.gen" in {e.name for e in prof.events()}


# ---------------------------------------------- the synthetic torch trace


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    path = tmp_path_factory.mktemp("scope") / "synth.pt.trace.json"
    attrib.synthesize_trace(str(path), steps=STEPS)
    events, _ = attrib.load_trace_events(str(path))
    return str(path), events


def _position(name):
    """The wave's index in its engine's registry rows: the synthetic
    kernel lasts 100 + 50 i us, and wave 0 also runs a 3 us memcpy."""
    return waves.WAVES_BY_ENGINE[name.split(".")[1]].index(name)


def test_attribution_covers_every_wave_through_correlation(synth):
    path, events = synth
    bd = attrib.report(path, geometry=GEOM)
    assert bd["kind"] == "dintscope_breakdown" and bd["missing"] == []
    assert bd["steps"] == STEPS
    for name in waves.ALL_WAVES:
        i, rec = _position(name), bd["waves"][name]
        kernel_us = 100.0 + 50.0 * i
        assert rec["ms"] == pytest.approx(
            STEPS * (kernel_us + (3.0 if i == 0 else 0.0)) / 1e3), name
        assert rec["slices"] == STEPS * (2 if i == 0 else 1), name
        assert rec["host_ms"] == pytest.approx(
            STEPS * (kernel_us + 20.0) / 1e3), name
        assert rec["ms_per_step"] == pytest.approx(rec["ms"] / STEPS)
    # every device slice is linked; only the fillers fall outside a wave
    charged = attrib.charge(events)
    assert all(linked for _, _, linked in charged)
    assert sorted(e["name"] for e, w, _ in charged if w is None) == \
        [f"filler_kernel_{s}" for s in range(STEPS)]
    assert bd["unattributed_ms"] == pytest.approx(STEPS * 0.025)


def test_annotation_slices_are_never_device_time(synth):
    _, events = synth
    device = sum(e["dur"] for e in events if e.get("cat") in
                 attrib.DEVICE_CATS) / 1e3
    bd = attrib.attribute(events)
    assert bd["total_ms"] == pytest.approx(device, abs=1e-6)
    assert any(e.get("cat") == "gpu_user_annotation" for e in events)
    # the gpu_user_annotation projections alone are no device time
    annotations = [e for e in events if e.get("cat") in
                   ("gpu_user_annotation", "user_annotation")]
    with pytest.raises(ValueError, match="no device event"):
        attrib.attribute(annotations)


def test_a_kernel_is_charged_through_its_own_launch(synth):
    _, events = synth
    events = copy.deepcopy(events)
    name = "dint.tatp_dense.lock"
    wave_kernel = next(
        e for e in events if e.get("cat") == "kernel"
        and attrib.charge([e] + [x for x in events
                                 if x.get("cat") != "kernel"])[0][1] == name)
    # re-point its correlation to no launch: it is unlinked, and charged
    # to nothing, although its stream's gpu_user_annotation covers it
    wave_kernel["args"]["correlation"] = 10 ** 9
    charged = attrib.charge(events)
    (hit,) = [c for c in charged if c[0] is wave_kernel]
    assert hit[1:] == (None, False)
    bd = attrib.attribute(events)
    assert bd["waves"][name]["slices"] == STEPS - 1


def test_a_trace_with_no_device_event_raises(synth, tmp_path):
    _, events = synth
    host_only = [e for e in events if e.get("cat") not in attrib.DEVICE_CATS]
    path = tmp_path / "host_only.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": host_only}))
    with pytest.raises(ValueError, match="no device event"):
        attrib.report(str(path))
    assert dintscope.main(["report", str(path)]) == 2


# ------------------------------------------- CPU profiles of traced steps

# the waves one step runs, per route (one block of one step, drawn
# outside the runner so `gen` is the cohort's alone)
TATP_WAVES = {
    "default": {"install", "log_append", "gen", "meta_gather",
                "magic_gather", "lock", "trace"},
    "hotset": {"install", "log_append", "gen", "meta_gather",
               "magic_gather", "lock", "trace"},
    "fused": {"install_log", "gen", "lock_validate", "magic_gather",
              "trace"},
    "fused+hotset": {"install_log", "gen", "lock_validate", "magic_gather",
                     "trace"},
}
SB_WAVES = {
    "default": {"gen", "read", "lock", "compute", "install", "log_append",
                "trace"},
    "hotset": {"gen", "read", "lock", "compute", "install", "log_append",
               "trace"},
    "fused": {"gen", "lock_validate", "lock", "compute", "install_log",
              "trace"},
    "fused+hotset": {"gen", "lock_validate", "lock", "compute",
                     "install_log", "trace"},
}


def _profiled_step(engine, route, tmp_path):
    hot, fused = ROUTES[route]
    gen = torch.Generator().manual_seed(0)
    if engine == "tatp_dense":
        run, init, _ = td.build_pipelined_runner(
            300, w=32, val_words=4, cohorts_per_block=1, use_hotset=hot,
            use_fused=fused, trace=True, device="cpu")
        carry = init(td.populate(np.random.default_rng(0), 300,
                                 val_words=4, device="cpu"))
        draws = (td.draw_bits(gen, (1, 32, 4), "cpu"),
                 torch.randint(0, 1 << 16, (1, 32, 2), dtype=torch.int32,
                               generator=gen))
    else:
        run, init, _ = sd.build_pipelined_runner(
            400, w=32, cohorts_per_block=1, use_hotset=hot, use_fused=fused,
            trace=True, device="cpu")
        carry = init(sd.create(400, device="cpu"))
        draws = sd.draw_step(gen, (1, 32), "cpu")
    carry, _ = run.run_draws(carry, *draws)     # warm
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run.run_draws(carry, *draws)
    path = tmp_path / f"{engine}_{route}.pt.trace.json"
    prof.export_chrome_trace(str(path))
    events, _ = attrib.load_trace_events(str(path))
    return events


@pytest.mark.parametrize("engine", ["tatp_dense", "smallbank_dense"])
def test_cpu_profile_gives_host_ms_for_each_wave_of_a_step(engine,
                                                           tmp_path):
    expect = TATP_WAVES if engine == "tatp_dense" else SB_WAVES
    for route in ROUTES:
        events = _profiled_step(engine, route, tmp_path)
        host = attrib.host_ranges(events)
        assert set(host) == {waves.full_name(engine, w)
                             for w in expect[route]}, route
        assert all(n == 1 and ms > 0 for ms, n in host.values()), route
        # the engines never nest one wave in another, so the innermost
        # enclosing wave of any launch is also the outermost
        spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                       if e.get("cat") == "user_annotation"
                       and e["name"] in waves.WAVE_DOCS)
        for (a0, a1), (b0, b1) in zip(spans, spans[1:]):
            assert a1 <= b0, (route, a0, a1, b0, b1)


# ------------------------------------------- the gate on JAX's breakdowns


@pytest.fixture(scope="module")
def jax_breakdowns(tmp_path_factory):
    """JAX's breakdown of the checked-in fixture, and of a fresh JAX
    synthetic trace with one wave slowed and one fused wave removed."""
    base = jattrib.report(str(FIXTURE), geometry=GEOM)
    d = tmp_path_factory.mktemp("jax_bd")
    slow = d / "slow.json"
    jattrib.synthesize_trace(str(slow), scale={
        "dint.tatp_dense.lock": 2.0, "dint.smallbank_dense.read": 1.02})
    cand = jattrib.report(str(slow), geometry=GEOM)
    fused = copy.deepcopy(base)
    for name in ("dint.tatp_dense.lock", "dint.tatp_dense.meta_gather"):
        fused["waves"][name].update(ms=0.0, slices=0, ms_per_step=None)
    paths = {}
    for key, bd in (("base", base), ("cand", cand), ("fused", fused)):
        paths[key] = d / f"{key}.json"
        paths[key].write_text(json.dumps(bd))
    return base, cand, fused, paths


def test_load_breakdown_returns_jax_results(jax_breakdowns, tmp_path):
    base, _, _, paths = jax_breakdowns
    assert attrib.load_breakdown(str(paths["base"])) == \
        jattrib.load_breakdown(str(paths["base"])) == base
    art = tmp_path / "bench.json"
    art.write_text(json.dumps({"metric": "x", "breakdown": base}))
    assert attrib.load_breakdown(str(art)) == base


@pytest.mark.parametrize("pair", [("base", "base"), ("base", "cand"),
                                  ("base", "fused"), ("fused", "base")])
@pytest.mark.parametrize("alias", [True, False])
def test_diff_breakdowns_returns_jax_results(jax_breakdowns, pair, alias):
    bds = dict(zip(("base", "cand", "fused"), jax_breakdowns[:3]))
    a, b = bds[pair[0]], bds[pair[1]]
    got = attrib.diff_breakdowns(a, b, alias=alias)
    assert got == jattrib.diff_breakdowns(a, b, alias=alias)
    if pair == ("base", "cand"):
        assert [r["wave"] for r in got["regressions"]
                if r["kind"] == "wave"] == ["dint.tatp_dense.lock"]


# ------------------------------------------------------------------ CLI


def test_dintscope_cli(synth, jax_breakdowns, tmp_path, capsys):
    path, _ = synth
    out = tmp_path / "bd.json"
    assert dintscope.main(["report", path, "--geom", "w=8192", "k=4",
                           "vw=10", "--json", "-o", str(out)]) == 0
    line = json.loads(capsys.readouterr().out)
    assert line == json.loads(out.read_text())
    assert line["missing"] == [] and line["steps"] == STEPS
    assert dintscope.main(["report", path]) == 0
    assert "host ms" in capsys.readouterr().out
    paths = jax_breakdowns[3]
    assert dintscope.main(["diff", str(out), str(out)]) == 0
    assert dintscope.main(["diff", str(paths["base"]),
                           str(paths["cand"])]) == 1
    assert "REGRESSION [wave] dint.tatp_dense.lock" in \
        capsys.readouterr().out
    assert dintscope.main(["describe", "--json"]) == 0
    desc = json.loads(capsys.readouterr().out)
    assert [w["name"] for w in desc["waves"]] == list(jwaves.ALL_WAVES)
    fresh = tmp_path / "fresh.json"
    assert dintscope.main(["synth", "-o", str(fresh), "--steps",
                           str(STEPS)]) == 0
    assert fresh.read_text() == Path(path).read_text()
