"""The port's serving-plane policy (dint_tpu_torch.serve.arrivals and
controller, numpy only) and its plan reader (dint_tpu_torch.plan) against
`dint_tpu.serve` and `dint_tpu.analysis.plan` on the same inputs: every
schedule kind, the ArrivalStream cursor, choose_width (at the knee too),
max_backlog, recommend_hot_frac, the WidthController's decisions, journal
and snapshot, simulate_widths, and the serve workloads' resolution. All
are identical."""
import copy
import dataclasses

import numpy as np
import pytest

from dint_tpu import serve as jserve
from dint_tpu.analysis import plan as jplan
from dint_tpu_torch import plan as pplan
from dint_tpu_torch import serve

# ------------------------------------------------------------- schedules

SCHEDULES = [
    ("constant", 1000.0, 0.01, 0, {}),
    ("constant", 1000.0, 0.0, 0, {}),
    ("constant", 333.3, 0.05, 0, {"start_s": 2.5}),
    ("poisson", 50_000.0, 0.01, 7, {}),
    ("poisson", 50_000.0, 0.01, 8, {"start_s": 0.3}),
    ("poisson", 0.0, 0.01, 1, {}),
    ("poisson", 2e6, 0.004, 3, {}),
    ("burst", 100_000.0, 0.01, 0, {"burst_lanes": 128,
                                   "burst_every_s": 0.002}),
    ("burst", 1_000.0, 0.02, 4, {"burst_lanes": 16, "burst_every_s": 0.005,
                                 "start_s": 1.0}),
    ("burst", 1_000.0, 0.0, 4, {"burst_lanes": 16, "burst_every_s": 0.005}),
]


@pytest.mark.parametrize("kind,rate,window,seed,kw", SCHEDULES)
def test_schedules_identical(kind, rate, window, seed, kw):
    a = jserve.make_schedule(kind, rate, window, seed=seed, **kw)
    b = serve.make_schedule(kind, rate, window, seed=seed, **kw)
    assert a.dtype == b.dtype == np.float64 and np.array_equal(a, b)
    direct = {"constant": serve.constant_schedule,
              "poisson": serve.poisson_schedule,
              "burst": serve.burst_schedule}[kind]
    extra = {} if kind == "constant" else {"seed": seed}
    assert np.array_equal(direct(rate, window, **extra, **kw), b)
    with pytest.raises(ValueError):
        serve.make_schedule("uniform", 1.0, 1.0)


def test_arrival_stream_identical():
    times = np.sort(np.concatenate([np.zeros(5), np.full(3, 0.2),
                                    serve.poisson_schedule(1e4, 0.01)]))
    a, b = jserve.ArrivalStream(times), serve.ArrivalStream(times)
    for t in (-1.0, 0.0, 0.001, 0.2, 0.2, 0.005, 1.0, 2.0):
        assert len(a) == len(b) and a.peek() == b.peek()
        assert a.exhausted == b.exhausted
        assert np.array_equal(a.take_until(t), b.take_until(t))
    assert b.exhausted and b.peek() is None
    with pytest.raises(AssertionError):
        serve.ArrivalStream(np.array([0.2, 0.1]))


# ------------------------------------------------------------ the policy


def _pair_cfg(**kw):
    return jserve.ControllerCfg(**kw), serve.ControllerCfg(**kw)


def test_dataclasses_identical():
    for kw in ({}, {"widths": (16, 64)}, {"slo_us": 500.0, "headroom": 2.0}):
        j, p = _pair_cfg(**kw)
        assert dataclasses.asdict(j) == dataclasses.asdict(p)
    assert dataclasses.asdict(jserve.ServiceModel()) == \
        dataclasses.asdict(serve.ServiceModel())
    for w in (1, 16, 256, 8192):
        assert jserve.ServiceModel(161.97914, 38.003079).service_us(w) == \
            serve.ServiceModel(161.97914, 38.003079).service_us(w)
    with pytest.raises(AssertionError):
        serve.ControllerCfg(widths=(64, 16))


@pytest.mark.parametrize("slo_us", [5_000.0, 500.0, 200.0])
def test_choose_width_and_max_backlog_identical(slo_us):
    jc, pc = _pair_cfg(slo_us=slo_us)
    for base, lane in ((150.0, 40.0), (161.97914, 38.003079), (10.0, 500.0)):
        m = serve.ServiceModel(base, lane)
        svc = {w: m.service_us(w) for w in pc.widths}
        knee = max(pc.widths, key=lambda w: w / svc[w])
        cap = knee / (svc[knee] * 1e-6)
        # rates around every width's capacity, and at the knee
        rates = [0.0, 1e3, 2e6, 100e6, cap / pc.headroom,
                 cap / pc.headroom * (1 + 1e-9), cap, cap * (1 + 1e-9)]
        rates += [w / (svc[w] * 1e-6) / pc.headroom for w in pc.widths]
        for r in rates:
            assert jserve.choose_width(r, svc, jc) == \
                serve.choose_width(r, svc, pc)
        for w in pc.widths + (64,):
            for s in (svc.get(w, 100.0), 1e9, 1.0):
                assert jserve.max_backlog(w, s, jc) == \
                    serve.max_backlog(w, s, pc)
    # at the knee: exactly its capacity fits, a hair more saturates
    cfg = serve.ControllerCfg(headroom=1.0)
    m = serve.ServiceModel()
    svc = {w: m.service_us(w) for w in cfg.widths}
    cap = 8192 / (svc[8192] * 1e-6)
    assert serve.choose_width(cap, svc, cfg) == (8192, False)
    assert serve.choose_width(cap * (1 + 1e-9), svc, cfg) == (8192, True)


def test_recommend_hot_frac_identical():
    cases = [(0.1, 0, 0), (0.1, 50, 50), (0.4, 0, 100), (0.25, 1000, 1),
             (1 / 64, 1000, 0), (0.2, 95, 5), (0.1, 90, 10), (0.1, 995, 5),
             (0.2, 100, 0), (0.5, 1, 99), (1 / 64, 100, 0)]
    for cur, hits, cold in cases:
        assert jserve.recommend_hot_frac(cur, hits, cold) == \
            serve.recommend_hot_frac(cur, hits, cold)
    assert serve.recommend_hot_frac(0.1, 50, 50, target_hit_rate=0.4,
                                    lo=0.01, hi=0.3) == \
        jserve.recommend_hot_frac(0.1, 50, 50, target_hit_rate=0.4,
                                  lo=0.01, hi=0.3)


def _drive(ctl, rng, steps):
    """One random sequence of observations and queries; returns what the
    controller answered."""
    out = []
    for _ in range(steps):
        r = rng.random()
        if r < 0.35:
            ctl.observe_rate(float(rng.choice([0.0, 1e3, 2e6, 5e7])
                                   * rng.random()))
        elif r < 0.7:
            w = ctl.width()
            ctl.observe_service(w, float(100 + 400 * rng.random()))
        elif r < 0.85:
            out.append((ctl.width(), ctl.max_backlog(), ctl.saturated))
        elif r < 0.95:
            ctl.journal_shed(int(rng.integers(0, 1 << 16)),
                             int(rng.integers(0, 1000)),
                             scale=int(rng.integers(1, 3)),
                             host=None if r < 0.9 else 1)
        else:
            ctl.journal_hot_frac(0.04, int(rng.integers(0, 100)),
                                 int(rng.integers(0, 100)), 0.08)
    return out


@pytest.mark.parametrize("lanes_scale", [1, 8])
def test_width_controller_journal_and_snapshot_identical(lanes_scale):
    for cfg_kw in ({}, {"widths": (16, 64), "hysteresis_blocks": 2}):
        jc, pc = _pair_cfg(**cfg_kw)
        m = (jserve.ServiceModel(161.97914, 38.003079),
             serve.ServiceModel(161.97914, 38.003079))
        j = jserve.WidthController(jc, m[0], lanes_scale=lanes_scale)
        p = serve.WidthController(pc, m[1], lanes_scale=lanes_scale)
        assert _drive(j, np.random.default_rng(1), 700) == \
            _drive(p, np.random.default_rng(1), 700)
        assert j.snapshot() == p.snapshot()
        assert j.journal_doc() == p.journal_doc()
        assert p.switches and len(p.samples) <= 512
        kinds = {e["kind"] for e in p.journal}
        assert kinds == {"width", "shed", "hot_frac"}


def test_width_controller_moves_both_directions():
    cfg, m = serve.ControllerCfg(), serve.ServiceModel()
    ctl = serve.WidthController(cfg, m)
    assert ctl.width() == 256
    ctl.observe_service(256, m.service_us(256))
    ctl.observe_rate(50e6)
    assert ctl.width() == 256             # hysteresis holds the switch
    for _ in range(cfg.hysteresis_blocks - 1):
        ctl.observe_service(256, m.service_us(256))
    assert ctl.width() == 8192 and ctl.saturated
    for _ in range(cfg.hysteresis_blocks):
        ctl.observe_service(8192, m.service_us(8192))
    for _ in range(40):
        ctl.observe_rate(0.0)
    assert ctl.width() == 256 and not ctl.saturated
    assert [w for _, w in ctl.switches] == [8192, 256]


@pytest.mark.parametrize("rate,window,cpb,scale", [
    (1_000.0, 0.05, 2, 1), (20e6, 0.004, 2, 1), (5e6, 0.01, 16, 1),
    (20e6, 0.004, 2, 8)])
def test_simulate_widths_identical(rate, window, cpb, scale):
    for kind in ("constant", "poisson"):
        s = serve.make_schedule(kind, rate, window, seed=2)
        for mk in ((), (161.97914, 38.003079)):
            jc, pc = _pair_cfg()
            a = jserve.simulate_widths(s, jc, jserve.ServiceModel(*mk),
                                       cohorts_per_block=cpb,
                                       lanes_scale=scale)
            b = serve.simulate_widths(s, pc, serve.ServiceModel(*mk),
                                      cohorts_per_block=cpb,
                                      lanes_scale=scale)
            assert a == b and (len(b) > 0) == (len(s) > 0)


# --------------------------------------------------------------- the plan


ENVS = [
    {},
    {"DINT_USE_FUSED": "1"},                       # no override: ignored
    {"DINT_PLAN_OVERRIDE": "1", "DINT_USE_FUSED": "1"},
    {"DINT_PLAN_OVERRIDE": "1", "DINT_USE_HOTSET": "1",
     "DINT_USE_FUSED": "0"},
    {"DINT_PLAN_OVERRIDE": "1", "DINT_USE_HOTSET": "yes",
     "DINT_USE_FUSED": ""},
]


@pytest.mark.parametrize("env", ENVS)
def test_resolve_for_matches_the_reference(env):
    doc = pplan.load_plan()
    assert doc == jplan.load_plan()
    for wname in ("tatp_uniform", "smallbank_skewed", "tatp_serve",
                  "smallbank_serve", "multihost_4x2", "multihost_3x2",
                  "multihost_serve"):
        jk, jm = jplan.resolve_for(wname, environ=env)
        pk, pm = pplan.resolve_for(wname, environ=env)
        # the port has no use_pallas: dropped, and recorded as dropped
        assert pk == {k: v for k, v in jk.items() if k in pplan.KNOBS}
        pinned = doc["workloads"][wname]["pinned"]
        dropped = sorted(k for k in pinned if k not in pplan.KNOBS)
        assert pm.pop("dropped", []) == dropped
        assert pm == jm
        assert pk.keys() == set(pplan.WORKLOAD_KNOBS[wname])
    for engine, wname in pplan.SERVE_WORKLOADS.items():
        assert jplan.SERVE_WORKLOADS[engine] == wname
    assert set(jplan.SERVE_WORKLOADS) == set(pplan.SERVE_WORKLOADS)


@pytest.mark.parametrize("env", ENVS[:3])
def test_resolve_for_without_a_plan_reads_the_environment(env, tmp_path,
                                                          monkeypatch):
    bad = tmp_path / "PLAN.json"
    bad.write_text('{"schema": 99}')
    for mod in (jplan, pplan):
        monkeypatch.setenv(mod.ENV_PLAN_PATH, str(bad))
    with pytest.raises(ValueError):
        pplan.load_plan()
    for wname in ("tatp_uniform", "smallbank_serve", "multihost_serve"):
        jk, jm = jplan.resolve_for(wname, environ=env)
        pk, pm = pplan.resolve_for(wname, environ=env)
        assert pm == jm == {"source": None, "hash": None, "overridden": []}
        assert pk == {k: v for k, v in jk.items() if k in pplan.KNOBS}
    # a plan handed in is read as it is
    doc = copy.deepcopy(jplan.load_plan(jplan.Path(jplan.__file__)
                                        .resolve().parents[2] / "PLAN.json"))
    doc["workloads"]["tatp_uniform"]["pinned"]["use_fused"] = True
    assert pplan.resolve_for("tatp_uniform", environ={}, plan=doc)[0] == \
        {"use_hotset": False, "use_fused": True}
