"""The port's mesh serving plane across processes
(dint_tpu_torch.serve.mesh.MeshServeEngine over a process group, 3 gloo
ranks, one a host of a 3x2 mesh) on the CPU, against the one-process
engine and JAX's MeshServeEngine.

The ranks are spawned once for the serving runs (`testing.procs.launch`,
the ``serve_mesh`` job, every engine spec in turn) and the parent holds
each run against the same spec in one process (`procs.serve_mesh_run`,
no group). Under a VirtualClock a run is a function of (schedule, draws),
so every rank's report (rank 0's, broadcast: offered, admitted, shed,
per host, steps by width, the controller with its journal, the
histograms, the counters) and the report after ``close``, every rank's
own summed stats, the counters summed over the ranks and every
partition's tables, logs and heads must equal the one process's bit for
bit. JAX's engine runs here on its virtual CPU devices; the ranks replay
its draws (``fold_in(PRNGKey(seed), block)``, partition p's step i from
``fold_in(split(key, cpb)[i], p)``). JAX's overlap route is red
(ROADMAP §C.5), so JAX is held against the unoverlapped route only.
"""
import json
import time

import jax
import numpy as np
import pytest
import torch

from dint_tpu import serve as jserve
from dint_tpu.analysis import plan as jplan
from dint_tpu_torch.monitor import counters as mon
from dint_tpu_torch.serve import (ControllerCfg, ServiceModel,
                                  constant_schedule, poisson_schedule)
from dint_tpu_torch.testing import procs

from test_torch_dense_sharded_sb import block_draws, jax_state
from test_torch_lock_engines import assert_same
from test_torch_mesh_procs_jax import gathered

H, C = 3, 2
D = H * C
RANKS = 3
N = 256
W, CPB = 16, 2
GROUP_FIELDS = ("processes", "backend", "rank_cards")
DISPATCH = ("dispatch_xla", "dispatch_pallas")

BASE = dict(n=N, shape=[H, C], widths=[8, W], model=[150.0, 40.0],
            cpb=CPB, depth=2, seed=0, clock="virtual", plan="auto",
            device="cpu", overlap=False)


def schedules() -> dict:
    # a saturating schedule: the controller sheds and switches width (a
    # drain on every partition); a sparse Poisson one, whose gaps outlast
    # a block, so the leader idles and sends heartbeats between arrivals
    return {"sat": constant_schedule(6_000_000.0, 0.003),
            "poisson": poisson_schedule(2_000.0, 0.05, seed=3)}


def _jax_engine():
    return jserve.MeshServeEngine(
        N, mesh_shape=(H, C), cfg=ControllerCfg(widths=(8, W)),
        model=ServiceModel(), cohorts_per_block=CPB, monitor=True, seed=0,
        overlap=False, plan=jplan.load_plan(),
        clock=jserve.VirtualClock())


class _JaxDraws:
    """JAX's block draws, made once per (block, width) the port asks for;
    ``arrays`` holds them as the ranks' inputs."""

    def __init__(self, seed=0):
        self.base = jax.random.PRNGKey(seed)
        self.arrays = {}

    def __call__(self, block_idx, w):
        if block_idx is None:
            return ()
        key = f"{block_idx}.{w}"
        if f"bits{key}" not in self.arrays:
            bits, amt = block_draws(jax.random.fold_in(self.base, block_idx),
                                    n=D, w=w, cpb=CPB)
            self.arrays[f"bits{key}"] = bits.numpy()
            self.arrays[f"amt{key}"] = amt.numpy()
        return (torch.from_numpy(self.arrays[f"bits{key}"]),
                torch.from_numpy(self.arrays[f"amt{key}"]))


@pytest.fixture(scope="module")
def served():
    """JAX's engine on the saturating schedule, then one launch of the
    ranks over three engine specs: overlap off and on, and the
    unoverlapped engine on JAX's draws and plan with its tables as
    arrays. Returns (specs, inputs, the ranks' outputs, JAX's reports
    and tables)."""
    inputs = schedules()
    j = _jax_engine()
    jrep = j.run(inputs["sat"])
    j.close()
    jclosed = j.snapshot()
    # the port in one process on JAX's draws asks for exactly the draws
    # the ranks will replay
    draws = _JaxDraws()
    ref = procs.serve_engine(dict(BASE, schedule="sat"), inputs)
    ref.draws = draws
    ref.run(inputs["sat"])
    ref.close()
    inputs.update(draws.arrays)
    specs = [dict(BASE, schedule="sat"),
             dict(BASE, schedule="sat", overlap=True),
             dict(BASE, schedule="poisson", idle_poll_us=100.0),
             dict(BASE, schedule="sat", draws="inputs",
                  plan=jplan.load_plan(), outputs="arrays")]
    outs = procs.launch("serve_mesh", {"engines": specs}, RANKS,
                        inputs=inputs, device="cpu")
    jax_out = {"report": jrep, "closed": jclosed, "state": jax_state(j._db)}
    return specs, inputs, outs, jax_out


def _rank_report(rep: dict) -> dict:
    """A rank's report without the fields a group adds."""
    return {k: v for k, v in rep.items() if k not in GROUP_FIELDS}


def _identities(rep):
    c = rep["counters"]
    served = sum(int(w) * n for w, n in rep["steps_by_width"].items())
    assert rep["offered"] == rep["admitted"] + rep["shed"]
    assert c["serve_occupancy_lanes"] == rep["admitted"] == rep["attempted"]
    assert c["serve_occupancy_lanes"] + c["serve_padded_lanes"] == served * D
    assert c["serve_shed_lanes"] == rep["shed"]
    assert sum(h["shed"] for h in rep["per_host"]) == rep["shed"]


@pytest.mark.parametrize("case", [0, 1, 2], ids=["sat", "sat-overlap",
                                                 "poisson"])
def test_ranks_equal_the_one_process_engine(served, case):
    """Every rank returns rank 0's report, which is the one-process
    engine's field for field (elapsed virtual time included), before and
    after close; every rank's own stats and summed counters equal it;
    each partition's tables, backups, stamps, log rings and heads equal
    the one process's (digests)."""
    specs, inputs, outs, _ = served
    spec = specs[case]
    ref_arrays, ref = procs.serve_mesh_run(spec, inputs)
    got = {}
    for arrays, rec in outs:
        run = rec["runs"][case]
        for key in ("report", "closed"):
            rep = run[key]
            assert rep["processes"] == RANKS and rep["backend"] == "gloo"
            assert rep["rank_cards"] == [["cpu"]] * RANKS
            assert _rank_report(rep) == ref[key], (rec["rank"], key)
        assert run["counters"] == ref["counters"]
        assert np.array_equal(arrays[f"{case}/stats"], ref_arrays["stats"])
        assert run["local"] == [C * rec["rank"] + c for c in range(C)]
        got.update({k.split("/", 1)[1]: v for k, v in arrays.items()
                    if k.startswith(f"{case}/p")})
    ref_digests = {k: v for k, v in ref_arrays.items() if k != "stats"}
    assert got.keys() == ref_digests.keys() and len(got) == D
    for k, v in ref_digests.items():
        assert np.array_equal(got[k], v), k
    _identities(ref["closed"])
    if spec["schedule"] == "sat":
        assert ref["closed"]["shed"] > 0
        assert len(ref["closed"]["controller"]["switches"]) >= 2
    assert ref["closed"]["committed"] > 0
    assert ref["closed"]["mesh"]["overlap"] is spec["overlap"]


def _strip(rep: dict) -> dict:
    out = json.loads(json.dumps(_rank_report(rep)))
    out.pop("elapsed_s")
    out["counters"] = {k: v for k, v in out["counters"].items()
                       if k not in DISPATCH}
    if out.get("plan"):
        # each package names its own default plan file as the source
        out["plan"] = {k: v for k, v in out["plan"].items()
                       if k != "source"}
    return out


def test_ranks_equal_jax_under_virtual_clock(served):
    """JAX's MeshServeEngine and the ranks on one schedule, JAX's draws
    and JAX's plan document: the same report field for field (the
    controller and its journal, per host, the counters but the dispatch
    pair) on every rank, before and after close, and every partition's
    tables, backups, stamps, logs and heads equal JAX's after close."""
    specs, _, outs, jax_out = served
    case = 3
    for arrays, rec in outs:
        run = rec["runs"][case]
        assert _strip(run["report"]) == _strip(jax_out["report"])
        assert _strip(run["closed"]) == _strip(jax_out["closed"])
    got, _ = gathered([({k.split("/", 1)[1]: v for k, v in a.items()
                         if k.startswith(f"{case}/p")}, None)
                       for a, _ in outs], D, (H, C))
    assert_same(jax_out["state"], got)
    assert jax_out["closed"]["shed"] > 0


def test_counters_summed_over_the_ranks_equal_the_one_process_mesh():
    """The counter repair: a rank's snapshot of its per-partition list
    (another rank's entries None) covers its partitions, and
    `counters.sum_over` over the group gives every rank the one-process
    mesh's snapshot of the monitored multihost_sb runner, flow counters
    summed and gauges maxed."""
    spec = dict(engine="multihost_sb", shape=[H, C], n=512, w=32, cpb=2,
                log_cap=256, blocks=2, draw_seed=7, device="cpu",
                route={"hierarchical": True, "monitor": True})
    outs = procs.launch("run", spec, RANKS, device="cpu")
    mesh = procs.make_mesh("multihost_sb", spec["shape"], device="cpu")
    _, stats, cnts, _, _ = procs.drive("multihost_sb", mesh, spec, {})
    want = mon.snapshot(cnts)
    assert want["lock_requests"] > 0 and want["ring_hwm"] > 0
    for arrays, rec in outs:
        assert rec["counters"] == want
        assert np.array_equal(arrays["stats"], stats)
    # one rank's list: its partitions only, the others' None
    part = [c if p in (2, 3) else None for p, c in enumerate(cnts)]
    assert mon.snapshot(part) == mon.snapshot(cnts[2:4])
    assert mon.sum_over(None, want) is want


def test_a_follower_lost_mid_run_makes_rank_0_raise():
    """Rank 2 exits once it has launched two blocks: rank 0, the leader,
    raises in its next command or collective, as does rank 1, well
    inside the group's timeout; nothing hangs to the launch's
    deadline."""
    inputs = schedules()
    spec = dict(BASE, schedule="sat", die=[2, 2])
    t0 = time.monotonic()
    with pytest.raises(procs.RankFailed) as err:
        procs.launch("serve_mesh", {"engines": [spec]}, RANKS,
                     inputs=inputs, device="cpu", timeout_s=20,
                     deadline_s=90)
    assert set(err.value.errors) == {0, 1}
    assert all("killed" not in e for e in err.value.errors.values())
    assert "Traceback" in err.value.errors[0]
    assert time.monotonic() - t0 < 60
