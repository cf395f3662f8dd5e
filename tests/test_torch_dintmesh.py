"""The port's mesh serving plane (dint_tpu_torch.serve.mesh.MeshServeEngine
over the serve routes of dint_tpu_torch.parallel.multihost_sb) on the CPU:
twins of tests/test_dintmesh.py's tier-1 tests and of
test_dintmon.py::test_mesh_serve_counters_reconcile_and_prefetch_ledger,
run on the port, and the port held against JAX's MeshServeEngine.

Under a VirtualClock the ServiceModel is the device, so a run is a function
of (schedule, draws): the port's engine, fed JAX's block draws
(``fold_in(PRNGKey(seed), block)``, partition p's step i from
``fold_in(split(key, cpb)[i], p)``), must give JAX's snapshot field for
field (but ``elapsed_s`` and the dispatch pair, which differ by design)
and JAX's tables after ``close``. The overlap route is held against the
port's own unoverlapped route (JAX's is red, ROADMAP §C.5)."""
import json

import jax
import numpy as np
import pytest
import torch

from dint_tpu import serve as jserve
from dint_tpu_torch import convert
from dint_tpu_torch import dintserve
from dint_tpu_torch import plan as pplan
from dint_tpu_torch import serve
from dint_tpu_torch.monitor import counters as mon
from dint_tpu_torch.parallel import multihost_sb as mh
from dint_tpu_torch.serve import (ControllerCfg, MeshServeEngine,
                                  ServiceModel, VirtualClock,
                                  constant_schedule, poisson_schedule)

from test_torch_dense_sharded_sb import block_draws, jax_state
from test_torch_lock_engines import assert_same

H, C = 4, 2
D = H * C
N = 256
W, CPB = 16, 2
DISPATCH = ("dispatch_xla", "dispatch_pallas")


def _engine(overlap=False, widths=(8, W), mesh_shape=(H, C), seed=0,
            **kw):
    return MeshServeEngine(N, mesh_shape=mesh_shape,
                           cfg=ControllerCfg(widths=widths),
                           model=ServiceModel(), cohorts_per_block=CPB,
                           clock=VirtualClock(), monitor=True, seed=seed,
                           overlap=overlap, device="cpu", **kw)


def _identities(rep, d=D):
    assert rep["offered"] == rep["admitted"] + rep["shed"]
    c = rep["counters"]
    assert c["serve_occupancy_lanes"] == rep["admitted"] == rep["attempted"]
    assert c["serve_shed_lanes"] == rep["shed"]
    served = sum(int(w) * n for w, n in rep["steps_by_width"].items())
    # the mesh identity: D cohorts of width w serve on every step
    assert c["serve_occupancy_lanes"] + c["serve_padded_lanes"] \
        == served * d
    assert sum(h["admitted"] for h in rep["per_host"]) == rep["admitted"]
    assert sum(h["shed"] for h in rep["per_host"]) == rep["shed"]
    assert c["route_ici_lanes"] + c["route_dcn_lanes"] == \
        c["lock_requests"] + c["install_writes"]


def test_mesh_engine_deterministic_and_ledger_closes():
    """Two runs of one schedule give the same snapshot, field for field,
    and the mesh-wide lane ledger closes."""
    reps = []
    for _ in range(2):
        eng = _engine()
        eng.run(poisson_schedule(300_000.0, 0.005, seed=3))
        eng.close()
        rep = eng.snapshot()
        rep.pop("elapsed_s")
        reps.append(rep)
    assert reps[0] == reps[1]
    rep = reps[0]
    assert rep["mesh"] == {"n_hosts": H, "n_ici": C, "hierarchical": True,
                           "overlap": False}
    assert rep["offered"] > 0 and rep["committed"] > 0
    _identities(rep)
    assert all(h["admitted"] > 0 for h in rep["per_host"])


def test_mesh_engine_width_switch_drains_every_partition():
    """A saturating burst drives the one controller to the knee: each
    switch drains every partition (the tables come back, every partition
    at one step, no stamp of the previous step held) before the next
    width attaches; the ledger closes over the whole run, sheds
    included, and every host shed."""
    eng = _engine()
    seen = []
    attach = eng._attach

    def checked_attach(w):
        assert eng._carry is None and len(eng._db) == D
        t = eng._db[0].step
        held = int(np.uint32(t - 1).view(np.int32))
        assert all(st.step == t for st in eng._db)
        assert not any(bool(((st.x_step == held) | (st.s_step == held))
                            .any()) for st in eng._db)
        seen.append(w)
        attach(w)

    eng._attach = checked_attach
    eng.run(constant_schedule(6_000_000.0, 0.004))
    eng.close()
    rep = eng.snapshot()
    ctl = rep["controller"]
    assert ctl["lanes_scale"] == D
    assert [w for _, w in ctl["switches"]].count(W) >= 1
    assert len(seen) == len(ctl["switches"]) >= 2   # the first attach too
    assert rep["steps_by_width"][str(W)] > 0 and rep["shed"] > 0
    _identities(rep)
    assert all(h["shed"] > 0 for h in rep["per_host"])


def test_mesh_engine_overlap_serves_identically():
    """The double-buffered plane changes the schedule, never the service:
    same arrivals, same admitted/shed/committed/width trajectory and lock
    and install ledger, every prefetched lane counted; after close the
    tables are the same."""
    reps, dbs = {}, {}
    for overlap in (False, True):
        eng = _engine(overlap=overlap)
        eng.run(poisson_schedule(400_000.0, 0.004, seed=7))
        eng.close()
        reps[overlap] = eng.snapshot()
        dbs[overlap] = convert.multihost_sb_to_numpy(eng._db, (H, C))
    a, b = reps[False], reps[True]
    for k in ("offered", "admitted", "shed", "attempted", "committed",
              "blocks", "steps_by_width", "controller", "per_host"):
        assert a[k] == b[k], k
    assert a["mesh"]["overlap"] is False and b["mesh"]["overlap"] is True
    ca, cb = a["counters"], b["counters"]
    assert ca["route_prefetch_lanes"] == 0
    assert cb["route_prefetch_lanes"] == cb["lock_requests"] > 0
    for k in ("lock_requests", "install_writes", "txn_committed",
              "serve_occupancy_lanes", "serve_shed_lanes"):
        assert ca[k] == cb[k], k
    _identities(b)
    assert_same(dbs[False], dbs[True])


def test_mesh_serve_tables_stay_in_place():
    """At one width every block of the overlapped route runs on the same
    carry: each partition's balances, stamps, backups and log keep their
    storage block over block (the port's twin of JAX's donation census)."""
    eng = _engine(overlap=True, widths=(W,))
    seen = []
    launch = eng._launch

    def spy(occ, shed):
        launch(occ, shed)
        seen.append(tuple(t.data_ptr() for st in eng._carry[0]
                          for t in (st.bal, st.x_step, st.s_step,
                                    st.bck_bal, st.log.entries)))

    eng._launch = spy
    eng.run(np.zeros(6 * CPB * W * D))
    eng.close()
    assert len(seen) >= 6 and len(set(seen)) == 1


def test_mesh_serve_counters_reconcile_and_prefetch_ledger():
    """On the serve runner the occupancy identity holds across the mesh,
    the per-host shed mirror reconciles, and the overlap route counts
    every prefetched lane (route_prefetch_lanes == lock_requests; 0 when
    off), the per-axis split intact in both modes."""
    mesh = mh.make_mesh_2d(H, C, device="cpu")
    rng = np.random.default_rng(3)
    occs = [rng.integers(0, W + 1, size=(H, C, CPB)).astype(np.int32)
            for _ in range(CPB)]
    sheds = [rng.integers(0, 4, size=(H, C, CPB)).astype(np.int32)
             for _ in range(CPB)]
    snaps = {}
    for overlap in (False, True):
        run, init, drain = mh.build_multihost_sb_runner(
            mesh, N, w=W, cohorts_per_block=CPB, monitor=True, serve=True,
            overlap=overlap)
        carry = init(mh.create_multihost_sb(mesh, N))
        gen = torch.Generator().manual_seed(5)
        for o, sh in zip(occs, sheds):
            carry, _ = run(carry, gen, torch.from_numpy(o),
                           torch.from_numpy(sh))
        _, _, cnt = drain(carry)
        snaps[overlap] = mon.snapshot(cnt)
    n_occ = sum(int(o.sum()) for o in occs)
    steps = len(occs) * CPB
    for overlap, snap in snaps.items():
        assert snap["serve_occupancy_lanes"] == n_occ == \
            snap["txn_attempted"], overlap
        assert snap["serve_occupancy_lanes"] + snap["serve_padded_lanes"] \
            == steps * W * D, overlap
        assert snap["serve_shed_lanes"] == sum(int(s.sum()) for s in sheds)
        assert snap["route_ici_lanes"] + snap["route_dcn_lanes"] == \
            snap["lock_requests"] + snap["install_writes"], overlap
    assert snaps[False]["route_prefetch_lanes"] == 0
    assert snaps[True]["route_prefetch_lanes"] == \
        snaps[True]["lock_requests"] > 0
    for k in ("lock_requests", "txn_committed", "install_writes"):
        assert snaps[False][k] == snaps[True][k], k


def test_warmup_leaves_the_live_tables():
    eng = _engine(overlap=True)
    before = convert.multihost_sb_to_numpy(eng._db, (H, C))
    eng.warmup()
    assert_same(before, convert.multihost_sb_to_numpy(eng._db, (H, C)))
    assert all(st.step == 2 for st in eng._db)


# ------------------------------------------------------ against JAX's


def _jax_draws(seed=0):
    base = jax.random.PRNGKey(seed)

    def draws(block_idx, w):
        if block_idx is None:
            return ()
        return block_draws(jax.random.fold_in(base, block_idx), n=D, w=w,
                           cpb=CPB)
    return draws


def _strip(snap):
    out = dict(snap)
    out.pop("elapsed_s")
    out["counters"] = {k: v for k, v in snap["counters"].items()
                       if k not in DISPATCH}
    return out


@pytest.mark.parametrize("sched", ["poisson", "saturate"])
def test_mesh_engine_equals_jax_under_virtual_clock(sched):
    """JAX's MeshServeEngine and the port's on one schedule and JAX's
    draws: the same snapshot field for field (controller, journal, per
    host, counters but the dispatch pair), the same tables after close."""
    schedule = (poisson_schedule(300_000.0, 0.004, seed=3)
                if sched == "poisson"
                else constant_schedule(6_000_000.0, 0.003))
    common = dict(mesh_shape=(H, C), cfg=ControllerCfg(widths=(8, W)),
                  model=ServiceModel(), cohorts_per_block=CPB, monitor=True,
                  seed=0, overlap=False)
    j = jserve.MeshServeEngine(N, clock=jserve.VirtualClock(), **common)
    p = MeshServeEngine(N, clock=VirtualClock(), draws=_jax_draws(0),
                        device="cpu", **common)
    jr, pr = j.run(schedule), p.run(schedule)
    assert jr.keys() == pr.keys()
    assert _strip(jr) == _strip(pr)
    j.close()
    p.close()
    js, ps = j.snapshot(), p.snapshot()
    assert _strip(js) == _strip(ps)
    assert ps["counters"]["dispatch_pallas"] >= D * sum(
        ps["steps_by_width"].values())
    if sched == "saturate":
        assert ps["shed"] > 0 and len(ps["controller"]["switches"]) >= 1
    assert_same(jax_state(j._db), convert.multihost_sb_to_numpy(p._db,
                                                                (H, C)))


# -------------------------------------------------------- plan and CLI


def test_mesh_engine_resolves_geometry_knobs_from_plan():
    """hierarchical/overlap left unset come from PLAN.json's
    multihost_serve (ON / OFF); an explicit plan dict wins, no plan gives
    the defaults, an explicit argument beats the plan."""
    eng = _engine(overlap=None)
    eng.run(constant_schedule(100_000.0, 0.004))
    eng.close()
    rep = eng.snapshot()
    assert rep["mesh"] == {"n_hosts": H, "n_ici": C, "hierarchical": True,
                           "overlap": False}
    assert rep["plan"]["source"].endswith("PLAN.json")
    assert rep["plan"]["overridden"] == []
    doc = pplan.load_plan()
    doc["workloads"]["multihost_serve"]["pinned"] = {"hierarchical": False,
                                                     "overlap": True}
    flipped = _engine(overlap=None, plan=doc)
    assert (flipped.hierarchical, flipped.overlap) == (False, True)
    assert _engine(overlap=False, plan=doc).overlap is False
    none = _engine(overlap=None, plan=None)
    assert (none.hierarchical, none.overlap) == (True, False)
    assert none.plan_meta is None
    knobs, _ = pplan.resolve_for("multihost_serve", environ={}, plan={})
    assert knobs == {"hierarchical": True, "overlap": False}


def test_cached_runner_shares_the_mesh_family():
    eng = _engine()
    a = serve.cached_runner("multihost_sb", N, mesh=eng.mesh, w=W,
                            cohorts_per_block=CPB, monitor=True,
                            hierarchical=True, serve=True, overlap=False)
    assert a is eng._runners[W]
    assert serve.cached_runner("multihost_sb", N, mesh=eng.mesh, w=W,
                               cohorts_per_block=CPB, monitor=True,
                               hierarchical=True, serve=True, overlap=False,
                               device="cpu") is a


def test_mesh_engine_refuses_two_hosts():
    with pytest.raises(ValueError, match="3 hosts"):
        _engine(mesh_shape=(2, 4))


def _cli(capsys, *args):
    rc = dintserve.main(list(args))
    return rc, capsys.readouterr().out


def test_dintserve_cli_mesh_simulate_and_describe(capsys):
    """simulate --mesh rehearses per-partition rates (H*C partitions
    absorb H*C x the rate before the controller moves) and describe
    names the mesh serving plane's waves."""
    rc, out = _cli(capsys, "simulate", "--rate", "20000000", "--window",
                   "0.004", "--mesh", "4x2", "--json")
    assert rc == 0
    mesh = json.loads(out)
    assert mesh["mesh"] == [4, 2]
    rc, out = _cli(capsys, "simulate", "--rate", "20000000", "--window",
                   "0.004", "--json")
    ref = json.loads(out)
    assert ref["mesh"] is None
    assert mesh["final_width"] <= ref["final_width"]
    rc, out = _cli(capsys, "describe")
    assert rc == 0
    for want in ("dint.multihost_sb.route_prefetch",
                 "dint.multihost_sb.serve", "not ported"):
        assert want in out, want
    with pytest.raises(SystemExit, match="HxC"):
        dintserve.main(["simulate", "--mesh", "four"])


def test_dintserve_cli_mesh_virtual_run(capsys):
    rc, out = _cli(capsys, "run", "--mesh", "3x2", "--size", str(N),
                   "--rate", "200000", "--window", "0.01", "--widths",
                   f"8,{W}", "--cpb", str(CPB), "--virtual", "--device",
                   "cpu", "--json")
    assert rc == 0                          # the SLO gate: met
    rep = json.loads(out.strip().splitlines()[-1])
    assert rep["mesh"]["n_hosts"] == 3 and rep["mesh"]["n_ici"] == 2
    assert rep["offered"] == rep["admitted"] + rep["shed"] > 0
    assert rep["slo_met"] is True
    _identities(rep, d=6)
    rc, out = _cli(capsys, "run", "--mesh", "3x2", "--size", str(N),
                   "--rate", "200000", "--window", "0.004", "--widths",
                   f"8,{W}", "--cpb", str(CPB), "--virtual", "--device",
                   "cpu", "--overlap")
    assert rc == 0
    assert "mesh     3x2 hierarchical=True overlap=True" in out
    assert "host 2: admitted=" in out
    with pytest.raises(SystemExit, match="needs --mesh"):
        dintserve.main(["run", "--overlap", "--device", "cpu",
                        "--virtual"])
