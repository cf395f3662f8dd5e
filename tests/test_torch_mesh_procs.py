"""The port's mesh across processes (dint_tpu_torch.parallel.dist, one
process a host) against the one-process mesh, on the CPU.

Each test spawns its ranks (`testing.procs.launch`: gloo over a
``file://`` store in a temporary directory, so no TCP port is shared
between test workers; torchrun's test takes a free port with
``--standalone``), joins them with a deadline and kills what overruns,
so a rank that hangs fails its test instead of the run. The ranks make
their inputs and draws with numpy from a seed, as the parent does for
the one-process mesh it holds them against; every comparison is bit for
bit. The runners' multi-rank steps run under the partition audit
(`testing.partitions.PartitionAudit(local=...)`) on every rank.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from dint_tpu_torch.parallel import dist
from dint_tpu_torch.parallel import multihost as mh
from dint_tpu_torch.parallel.mesh import Mesh, rank_blocks
from dint_tpu_torch.testing import procs

CPU = torch.device("cpu")


def merged(outs) -> dict:
    """Every rank's arrays in one dict (the keys name their partition)."""
    got = {}
    for arrays, _ in outs:
        got.update(arrays)
    return got


def assert_arrays_equal(ref: dict, got: dict):
    assert ref.keys() == got.keys()
    for k, v in ref.items():
        assert v.dtype == got[k].dtype and np.array_equal(v, got[k]), k


# ------------------------------------------------------ the collectives


@pytest.mark.parametrize("shape,world", [((3, 2), 3), ((4, 2), 2)])
def test_collectives_equal_the_one_process_mesh(shape, world):
    """ppermute along each axis by 1 and 2, all_to_all along each axis
    and the tuple, psum of int32 values that wrap: on 3x2 over 3 ranks every "dcn" hop crosses ranks;
    on 4x2 over 2 ranks a rank holds two hosts, so a hop is partly a copy
    and partly a message."""
    axes = [mh.DCN_AXIS, mh.ICI_AXIS]
    outs = procs.launch("collectives", {"shape": list(shape), "axes": axes,
                                        "seed": 5, "device": "cpu"},
                        world, device="cpu")
    ins = procs.collective_inputs(shape, 5)
    mesh = Mesh(shape, axes, device="cpu")
    ref = procs.case_arrays(procs.collective_cases(mesh, ins, CPU),
                            mesh.local)
    assert_arrays_equal(ref, merged(outs))
    # the int32 sum wraps as JAX's, on every rank
    exact = sum(ins[f"ps{p}"].astype(np.int64) for p in range(mesh.size))
    assert (exact > 2**31 - 1).all()
    wrapped = ((exact + 2**31) % 2**32 - 2**31).astype(np.int32)
    for arrays, _ in outs:
        assert np.array_equal(arrays["psum"], wrapped)
    per = shape[0] // world
    assert [rec["local"] for _, rec in outs] == [
        list(range(r * per * shape[1], (r + 1) * per * shape[1]))
        for r in range(world)]
    assert {rec["backend"] for _, rec in outs} == {"gloo"}


def test_rank_blocks_are_whole_hosts():
    assert rank_blocks((3, 2), 3) == [0, 0, 1, 1, 2, 2]
    assert rank_blocks((4, 2), 2) == [0, 0, 0, 0, 1, 1, 1, 1]
    assert rank_blocks((6,), 3) == [0, 0, 1, 1, 2, 2]
    assert rank_blocks((3, 2), 1) == [0] * 6


def _group(rank, size):
    return dist.Group(pg=None, rank=rank, size=size, backend="gloo",
                      cards=(CPU,))


def test_mesh_over_a_group_holds_its_block():
    """A rank's mesh: its partitions' devices, None for the others', the
    home device its first partition's; another rank's entry is never
    read."""
    mesh = mh.make_mesh_2d(4, 2, device="cpu", group=_group(1, 2))
    assert mesh.local == (4, 5, 6, 7)
    assert mesh.devices == (None,) * 4 + (CPU,) * 4
    assert mesh.device == CPU and mesh.rank_of(0) == 0
    assert [mesh.rank_of(p) for p in range(8)] == [0] * 4 + [1] * 4
    assert mesh.map_local(lambda p: p) == [None] * 4 + [4, 5, 6, 7]
    assert mesh.per_partition(lambda d: "c") == [None] * 4 + ["c"] * 4


def test_world_size_that_does_not_divide_the_hosts_raises():
    with pytest.raises(ValueError, match="do not divide"):
        mh.make_mesh_2d(3, 2, device="cpu", group=_group(0, 2))
    with pytest.raises(ValueError, match="do not divide"):
        Mesh((4,), ("shard",), device="cpu", group=_group(0, 3))


def test_backend_that_cannot_serve_the_placement_raises():
    with pytest.raises(ValueError, match="needs CUDA"):
        dist.choose_backend("cpu", False, "nccl")
    with pytest.raises(ValueError, match="share a card"):
        dist.choose_backend("cuda", True, "nccl")
    with pytest.raises(ValueError, match="gloo or nccl"):
        dist.choose_backend("cpu", False, "mpi")
    assert dist.choose_backend("cpu", False) == "gloo"
    assert dist.choose_backend("cuda", True) == "gloo"
    assert dist.choose_backend("cuda", False) == "nccl"
    assert dist.choose_backend("cuda", False, "gloo") == "gloo"
    # initialize refuses before it joins anything
    with pytest.raises(ValueError, match="needs CUDA"):
        dist.initialize("file:///nonexistent/store", 1, 0, backend="nccl",
                        device="cpu")
    assert not torch.distributed.is_initialized()


def test_rank_cards_map_ranks_to_cards():
    assert dist.rank_cards(0, 3, 1) == ((0,), True)
    assert dist.rank_cards(2, 3, 1) == ((0,), True)
    assert [dist.rank_cards(r, 3, 4) for r in range(3)] == [
        ((0,), False), ((1,), False), ((2,), False)]
    assert dist.rank_cards(3, 4, 2) == ((1,), True)
    with pytest.raises(ValueError, match="local rank"):
        dist.rank_cards(3, 3, 4)


def test_a_rank_that_dies_makes_the_others_raise():
    """Rank 2 exits after joining, before its first collective: ranks 0
    and 1 raise in their collectives well inside the group timeout, and
    the launch reports them."""
    t0 = time.monotonic()
    with pytest.raises(procs.RankFailed) as err:
        procs.launch("collectives", {"shape": [3, 2],
                                     "axes": [mh.DCN_AXIS, mh.ICI_AXIS],
                                     "seed": 1, "device": "cpu", "die": 2},
                     3, device="cpu", timeout_s=20, deadline_s=90)
    assert set(err.value.errors) == {0, 1}
    assert all("killed" not in e for e in err.value.errors.values())
    assert time.monotonic() - t0 < 90


# ------------------------------------------- the runners across processes

TATP = dict(n=3 * 200, w=32, cpb=2, vw=4, log_cap=128, blocks=2, seed=4,
            draw_seed=9, device="cpu")
SB = dict(n=512, w=32, cpb=2, log_cap=256, blocks=2, draw_seed=7,
          device="cpu")


def one_process(engine, spec):
    """The spec's run on the one-process mesh: (stats, {p/key: array})."""
    mesh = procs.make_mesh(engine, spec["shape"], device="cpu")
    states, stats, cnts, _, _ = procs.drive(engine, mesh, spec, {})
    out = {}
    if engine in ("dense_sharded_sb", "multihost_sb"):
        from dint_tpu_torch.parallel import dense_sharded_sb as dsb
        out["total_balance"] = np.array(dsb.total_balance_global(states))
    for p in mesh.local:
        for k, v in procs.state_arrays(engine, states[p]).items():
            out[f"p{p}/{k}"] = np.asarray(v)
        if cnts is not None:
            out[f"p{p}/counters"] = cnts[p].buf.numpy().view(np.uint32)
    return stats, out


@pytest.mark.parametrize("engine,route", [
    ("dense_sharded", {}), ("dense_sharded", {"use_fused": True}),
    ("dense_sharded_sb", {"monitor": True}),
    ("dense_sharded_sb", {"use_fused": True, "monitor": True})])
def test_runner_across_three_ranks_equals_one_process(engine, route):
    """3 partitions, one a rank: every step's stats, each partition's
    tables, backups, stamps, log entries and heads (and counters) equal
    the one-process mesh's on the same draws; the audit saw collectives
    and no operator take two partitions' tensors."""
    spec = dict(TATP if engine == "dense_sharded" else SB, engine=engine,
                shape=[3], route=route, audit=True)
    outs = procs.launch("run", spec, 3, device="cpu")
    stats, ref = one_process(engine, spec)
    got = merged(outs)
    for arrays, rec in outs:
        assert np.array_equal(arrays["stats"], stats)
        assert rec["audit_collectives"] > 0 and rec["audit_ops"] > 0
        if "total_balance" in ref:       # a psum over the group
            assert arrays["total_balance"] == ref["total_balance"]
    got.pop("stats")
    assert_arrays_equal(ref, got)
    assert stats[:, 1].sum() > 0          # something committed


def test_generic_sharded_step_across_ranks_equals_one_process():
    """The generic engines' replicated step, 3 shards on 3 ranks: each
    rank routes the whole request draw and keeps its shards' buckets;
    replies, the psummed vote and every shard's tensors equal the
    one-process step's."""
    spec = dict(shards=3, n=64, w=16, vw=4, log_cap=1 << 12, seed=11,
                waves=[96, 160, 200], device="cpu")
    outs = procs.launch("sharded_step", spec, 3, device="cpu")
    from dint_tpu_torch.parallel import sharded
    ref = procs.sharded_step_arrays(sharded.make_mesh(3, device="cpu"),
                                    spec)
    got = merged(outs)
    assert_arrays_equal(ref, got)
    assert any(int(v.sum()) for k, v in ref.items()
               if k.endswith("committed"))


class _Ranks:
    """A stand-in for `dist.Window`: records its calls; the window passes
    at the ``at``-th block boundary whatever the clock says."""

    def __init__(self, at):
        self.at, self.calls, self.asked = at, [], 0

    def start(self):
        self.calls.append("start")

    def passed(self, flag):
        self.calls.append("passed")
        self.asked += 1
        return self.asked > self.at

    def end(self):
        self.calls.append("end")


def test_run_window_across_ranks_closes_on_the_agreement():
    """`stats.run_window(ranks=)`: the window starts with ``start``, asks
    ``passed`` at each block boundary (the ranks' agreement decides, not
    this rank's clock, so every rank runs the same blocks) and ends with
    ``end`` after the last block's stats are in."""
    from dint_tpu_torch import stats as st

    def runner(state, gen):
        return state + 1, torch.full((2, 3), state, dtype=torch.int32)

    ranks = _Ranks(at=3)
    state, total, warm, _, blocks, block_s = st.run_window(
        runner, 0, None, 1e9, 3, warmup_blocks=1, ranks=ranks)
    assert blocks == 3 and state == 4 and len(block_s) == 3
    assert warm.tolist() == [0, 0, 0]
    assert total.tolist() == [2 * (1 + 2 + 3)] * 3
    assert ranks.calls == ["start"] + ["passed"] * 4 + ["end"]


def test_exp_across_processes_refuses_what_a_rank_cannot_run(monkeypatch,
                                                             tmp_path):
    """Across ranks exp runs one mesh leg (multihost_sb or serve_mesh),
    without --skip-done (the ranks must run the same points) and without
    the planes a rank sees only its part of (the counters of DINT_MONITOR
    are summed over the ranks, so they run); it raises before it builds
    anything."""
    from dint_tpu_torch import exp
    g = _group(0, 3)
    for kw in ({"only": None}, {"only": "tatp"},
               {"only": "multihost_sb", "skip_done": True}):
        with pytest.raises(ValueError, match="multihost_sb leg only"):
            exp.run(str(tmp_path), quick=True, device="cpu", group=g, **kw)
    for flag, value in (("DINT_TRACE", "1"),
                        ("DINT_EXP_TRACE_DIR", str(tmp_path))):
        with monkeypatch.context() as m:
            m.setenv(flag, value)
            with pytest.raises(ValueError, match="runs without"):
                exp.sweep_multihost_sb(20_000, width=32, cpb=2,
                                       window_s=0.1, results={},
                                       device="cpu", group=g)
    monkeypatch.setenv("DINT_BENCH_MESH", "2x2")
    with pytest.raises(ValueError, match=">= 3 hosts"):
        exp.sweep_multihost_sb(20_000, width=32, cpb=2, window_s=0.1,
                               results={}, device="cpu", group=g)


def test_exp_multihost_sb_leg_under_torchrun(tmp_path):
    """``python -m torch.distributed.run --standalone --nproc-per-node 3
    -m dint_tpu_torch.exp --only multihost_sb`` (a rendezvous on a free
    port of its own, never the fixed default): one rank a host of 3x2,
    rank 0 writes both points with the processes, the backend and each
    rank's cards."""
    env = dict(os.environ, DINT_BENCH_MESH="3x2")
    for k in ("DINT_MONITOR", "DINT_TRACE", "RANK", "WORLD_SIZE"):
        env.pop(k, None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "3", "-m", "dint_tpu_torch.exp", "--only", "multihost_sb",
         "--quick", "--window", "0.3", "--device", "cpu", "--out",
         str(tmp_path)], env=env, capture_output=True, text=True,
        timeout=240, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert proc.returncode == 0, proc.stderr[-2000:]
    import json
    for tag in ("hier", "flat"):
        with open(tmp_path / f"multihost_sb_{tag}_closed_w256.json") as f:
            art = json.load(f)
        assert art["processes"] == 3 and art["backend"] == "gloo"
        assert art["rank_cards"] == [["cpu"]] * 3
        assert art["mesh"]["n_hosts"] == 3 and art["throughput"] > 0
        assert art["hierarchical"] == (tag == "hier")
    with open(tmp_path / "summary.json") as f:
        assert json.load(f)["processes"] == 3
