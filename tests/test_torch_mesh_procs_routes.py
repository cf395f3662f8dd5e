"""The mesh's routes across processes that no other test runs across
ranks (dint_tpu_torch.testing.procs, 3 gloo ranks on the CPU), each held
against the one-process mesh bit for bit, and the rank harness's own
contract.

One launch of the ``runs`` job (one spawn) holds every run:
sharded SmallBank on its hotset and fused+hotset routes with the
counters on (the routes `test_torch_mesh_procs.py` leaves out), TATP's
multihost runner from tables populated on the device and SmallBank's
hierarchical runner, each with host 1 lost and rebuilt on its rank from
host 2's ring and reported as digests (the form the card's full-size run
uses), TATP's sharded fused route from clones of the multihost run's
state (one create across the ranks, shared), and the generic sharded
step reported as digests with the CF table at `tatp.create`'s own size.
The draws are made from numpy seeds on every rank and in the parent
alike.
"""
import json

import numpy as np
import pytest
import torch

from dint_tpu_torch.monitor import counters as mon
from dint_tpu_torch.parallel import dist
from dint_tpu_torch.parallel import sharded
from dint_tpu_torch.testing import procs

from test_torch_mesh_procs import assert_arrays_equal, one_process

RANKS = 3
SB = dict(engine="dense_sharded_sb", shape=[3], n=512, w=32, cpb=2,
          log_cap=256, blocks=2, draw_seed=7, device="cpu", audit=True)
ROUTES = {"hotset": {"use_hotset": True, "monitor": True},
          "fused+hotset": {"use_hotset": True, "use_fused": True,
                           "monitor": True}}
RECOVER = {
    "tatp multihost": dict(engine="multihost", shape=[3, 1], n=3 * 200,
                           w=32, cpb=2, vw=4, log_cap=128, blocks=2,
                           seed=4, draw_seed=9, state="device"),
    "smallbank 3x2 hier": dict(engine="multihost_sb", shape=[3, 2],
                               n=512, w=32, cpb=2, log_cap=256, blocks=2,
                               draw_seed=8,
                               route={"hierarchical": True})}
# sharded TATP from the multihost 3x1 run's create (the same partitions
# and backups), run right after it
SHARED = dict(RECOVER["tatp multihost"], engine="dense_sharded", shape=[3],
              draw_seed=10, route={"use_fused": True}, share="tatp",
              device="cpu", outputs="digest")
STEP = dict(job="sharded_step", shards=3, n=64, w=16, vw=4,
            log_cap=1 << 12, seed=12, waves=[96, 160], outputs="digest",
            device="cpu")


def _specs() -> list:
    rec = [dict(s, device="cpu", outputs="digest", recover=[1])
           for s in RECOVER.values()]
    rec[0]["share"] = "tatp"
    return ([dict(SB, route=r) for r in ROUTES.values()]
            + rec[:1] + [SHARED] + rec[1:] + [STEP])


def _index(spec) -> int:
    return next(i for i, s in enumerate(_specs())
                if s.get("engine") == spec.get("engine")
                and s.get("route") == spec.get("route")
                and s.get("job") == spec.get("job"))


@pytest.fixture(scope="module")
def ranks():
    """Every run of `_specs` on 3 ranks, in one launch."""
    return procs.launch("runs", {"runs": _specs()}, RANKS, device="cpu")


def _run_arrays(outs, i) -> dict:
    """Run i's arrays of every rank, the ``<i>/`` prefix dropped (the keys
    name their partition)."""
    got = {}
    for arrays, _ in outs:
        got.update({k.split("/", 1)[1]: v for k, v in arrays.items()
                    if k.startswith(f"{i}/")})
    return got


@pytest.mark.parametrize("route", list(ROUTES))
def test_sharded_sb_route_across_ranks_equals_one_process(ranks, route):
    """Sharded SmallBank over 3 partitions, one a rank, on the hot routes
    with the counters on: every rank's stats of every step, each
    partition's tables, hot mirrors, stamps, backups, log rings and heads
    and counters, the counters summed over the ranks and the global
    balance equal the one-process mesh's; the audit saw collectives and
    no operator take two partitions' tensors."""
    i = list(ROUTES).index(route)
    spec = _specs()[i]
    stats, ref = one_process("dense_sharded_sb", spec)
    summed = json.loads(json.dumps(mon.snapshot(np.stack(
        [ref[f"p{p}/counters"] for p in range(3)]))))
    for arrays, rec in ranks:
        r = rec["runs"][i]
        assert np.array_equal(arrays[f"{i}/stats"], stats)
        assert arrays[f"{i}/total_balance"] == ref["total_balance"]
        assert r["counters"] == summed
        assert r["audit_collectives"] > 0 and r["audit_ops"] > 0
    got = _run_arrays(ranks, i)
    got.pop("stats")
    assert_arrays_equal(ref, got)
    assert "p0/hot_bal" in got and stats[:, 1].sum() > 0
    # the fused+hotset route reads through gather_streams, not the mirror
    assert (summed["hot_hits"] > 0) == (route == "hotset")


@pytest.mark.parametrize("label", list(RECOVER))
def test_lost_host_rebuilt_on_its_rank_as_digests(ranks, label):
    """Host 1's partitions, lost, rebuilt on their rank from host 2's ring
    (one ppermute along dcn across ranks): the rebuild equals the live
    tables it replaces (TATP's from the same populate the run started
    from, here `populate_device`) and, as digests, the one-process mesh's
    rebuild; the run's own digests and stats equal the one process's."""
    i = _index(RECOVER[label])
    spec = _specs()[i]
    engine = spec["engine"]
    mesh = procs.make_mesh(engine, spec["shape"], device="cpu")
    states, stats, _, _, _ = procs.drive(engine, mesh, spec, {})
    ref = procs.recover(engine, mesh, spec, states, 1)
    got = _run_arrays(ranks, i)
    dead = [mesh.flat((1, c)) for c in range(mesh.shape[1])]
    assert sorted(k for k in got if k.startswith("rec")) == sorted(ref)
    assert len(ref) == 2 * len(dead)
    for p in dead:
        assert bool(ref[f"rec{p}/same"]) and bool(got[f"rec{p}/same"])
        assert np.array_equal(got[f"rec{p}/digest"], ref[f"rec{p}/digest"])
    for p in range(mesh.size):
        assert list(got[f"p{p}/digest"]) == procs.state_digests(states[p])
    assert np.array_equal(got["stats"], stats) and stats[:, 1].sum() > 0


def test_generic_step_in_a_runs_launch_as_digests(ranks):
    """The generic sharded step as one entry of a ``runs`` launch, its
    shards as digests at `tatp.create`'s own CF size: every wave's replies,
    the summed vote and each shard's digests equal the one-process step's;
    no kernel counted."""
    i = _index(STEP)
    ref = procs.sharded_step_arrays(sharded.make_mesh(3, device="cpu"),
                                    STEP)
    assert_arrays_equal(ref, _run_arrays(ranks, i))
    assert sorted(k for k in ref if k.startswith("s/")) == [
        f"s/{p}/digest" for p in range(3)]
    for _, rec in ranks:
        assert not any(rec["runs"][i]["launches"].values())
        assert rec["runs"][i]["cards"] == ["cpu"]


def test_a_shared_create_across_ranks_equals_its_own(ranks):
    """Sharded TATP (fused) across 3 ranks from clones of the multihost
    3x1 run's state (that run's create, its backups moved between the
    ranks, tagged alike): the stats and each partition's digests equal
    the one-process mesh's run from its own create."""
    i = _index(SHARED)
    mesh = procs.make_mesh("dense_sharded", [3], device="cpu")
    states, stats, _, _, _ = procs.drive("dense_sharded", mesh, SHARED, {})
    got = _run_arrays(ranks, i)
    assert np.array_equal(got["stats"], stats) and stats[:, 1].sum() > 0
    for p in range(3):
        assert list(got[f"p{p}/digest"]) == procs.state_digests(states[p])
    for _, rec in ranks:
        assert set(rec["runs"][i - 1]["seconds"]) >= {"create"}
        assert set(rec["runs"][i]["seconds"]) >= {"clone"}


def test_a_share_tag_refuses_another_state():
    """A run tagged like an earlier run of another state raises before it
    starts, instead of running from the wrong tables."""
    with pytest.raises(ValueError, match="shares 'tatp' with a run of"):
        procs._run_job(_one_rank("cpu"), dict(SHARED, n=3 * 100), {},
                       made={"tatp": (procs._share_key(
                           "dense_sharded", SHARED), [])})


@pytest.mark.parametrize("engine,shape", [("dense_sharded", [3]),
                                          ("multihost", [3, 2])])
def test_create_backups_are_the_predecessors_tables(engine, shape):
    """TATP's states from `populate_device` tables: backup slot ``off - 1``
    of each partition is the tables of the partition ``off`` behind it
    along the backup axis (`_with_backups`' ppermute) without their
    sentinel row, then a zero row."""
    from dint_tpu_torch.parallel import dense_sharded as ds
    from dint_tpu_torch.parallel import multihost as mh
    spec = dict(n=6 * 50, vw=4, log_cap=64, seed=3, state="device")
    mesh = procs.make_mesh(engine, shape, device="cpu")
    axis = mh.DCN_AXIS if engine == "multihost" else ds.SHARD_AXIS
    states = procs.create(engine, mesh, spec, {})
    for p, st in enumerate(states):
        db = procs.populate_partition(mesh, spec, p)
        assert torch.equal(st.db.val, db.val)
        n_val, n_meta = db.val.numel(), db.meta.numel()
        for slot in (0, 1):
            src = procs.populate_partition(
                mesh, spec, mesh.shift(p, axis, -1 - slot))
            val = st.bck_val[slot * n_val:(slot + 1) * n_val]
            meta = st.bck_meta[slot * n_meta:(slot + 1) * n_meta]
            assert torch.equal(val[:-4], src.val[:-4])
            assert torch.equal(meta[:-1], src.meta[:-1])
            assert not val[-4:].any() and not meta[-1:].any()
            assert meta[:-1].any()


TINY = dict(n=512, w=32, cpb=2, vw=4, log_cap=128)


@pytest.mark.parametrize("engine,key", [
    ("multihost", "use_fused"), ("multihost", "monitor"),
    ("multihost_sb", "use_fused"), ("multihost_sb", "use_hotset"),
    ("multihost_sb", "overlap"), ("dense_sharded", "use_hotset"),
    ("dense_sharded_sb", "hierarchical")])
def test_build_raises_on_a_route_key_its_engine_does_not_take(engine, key):
    """A spec's route key that the harness does not drive for the engine
    raises (it would run the default route unawares; multihost_sb's
    ``overlap`` needs the serve carry, which `serve_engine` drives); the
    keys it drives build."""
    shape = [3, 1] if engine in ("multihost", "multihost_sb") else [3]
    mesh = procs.make_mesh(engine, shape, device="cpu")
    with pytest.raises(ValueError,
                       match=f"drives no route key \\['{key}'\\]"):
        procs.build(engine, mesh, dict(TINY, route={key: True}))
    run, init, drain = procs.build(engine, mesh, dict(
        TINY, route=dict.fromkeys(procs.ROUTE_KEYS[engine], True)))
    assert callable(run) and callable(init) and callable(drain)


def _one_rank(device) -> dist.Group:
    return dist.Group(pg=None, rank=0, size=1, backend="gloo",
                      cards=(torch.device("cpu") if device == "cpu"
                             else torch.device("cuda", 0),))


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="shows the missing card; here there is one")
@pytest.mark.parametrize("job,spec", [
    ("collectives", dict(shape=[3, 2], axes=["dcn", "ici"], seed=5)),
    ("sharded_step", dict(shards=3, n=64, w=16, vw=4, log_cap=1 << 12,
                          seed=11, waves=[96]))])
def test_a_job_takes_a_missing_device_as_the_card(job, spec):
    """The collectives and the generic step run on the card unless the
    spec asks for the CPU, as every other job: on a machine without CUDA a
    spec without ``device`` raises for want of a card (it never runs on
    the CPU unasked), and ``device="cpu"`` runs there."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        procs.JOBS[job](_one_rank(None), spec, {})
    arrays, rec = procs.JOBS[job](_one_rank("cpu"), dict(spec, device="cpu"),
                                  {})
    assert arrays and rec["local"] == list(range(
        int(np.prod(spec.get("shape", [spec.get("shards")])))))
