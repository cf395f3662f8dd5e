"""The port's (host, chip) mesh runner (dint_tpu_torch.parallel.multihost)
against `dint_tpu.parallel.multihost` on the CPU, its fault domains and
refusals, and the port's `entry.dryrun_multichip`.

JAX runs the reference topology, 3 hosts x 2 chips, on 6 of the 8 virtual
CPU devices (tests/conftest.py); the port runs the 6 partitions as a list
in flat order h * C + c, on JAX's replayed draws (partition p draws from
``fold_in(step_key, p)``). Every comparison is bit-exact."""
import jax
import numpy as np
import pytest
import torch

from dint_tpu.parallel import multihost as jmh
from dint_tpu_torch import convert, entry
from dint_tpu_torch.engines import tatp_dense as td
from dint_tpu_torch.ops import u32
from dint_tpu_torch.parallel import dense_sharded as ds
from dint_tpu_torch.parallel import multihost as mh

from test_torch_dense_sharded import (CPB, LOG_CAP, VW, W, closes,
                                      run_both)

H, C = 3, 2
P = H * C
N_SUB = P * 128
BLOCKS = 2


@pytest.fixture(scope="module")
def both_runs():
    """JAX's and the port's 3x2 runs from one populate, compared block by
    block; returns the port's final states and totals."""
    jmesh = jmh.make_mesh_2d(H, C)
    jstate = jmh.create_multihost(jmesh, N_SUB, val_words=VW, seed=3,
                                  log_capacity=LOG_CAP)
    jr = jmh.build_multihost_runner(jmesh, N_SUB, w=W, val_words=VW,
                                    cohorts_per_block=CPB)
    mesh = mh.make_mesh_2d(H, C, device="cpu")
    pstates = mh.create_multihost(mesh, N_SUB, val_words=VW, seed=3,
                                  log_capacity=LOG_CAP)
    pr = mh.build_multihost_runner(mesh, N_SUB, w=W, val_words=VW,
                                   cohorts_per_block=CPB)
    states, total, _, _ = run_both(*jr, jstate, *pr, pstates, (H, C),
                                   BLOCKS, seed=3)
    return states, total


def test_3x2_bit_identical_to_jax(both_runs):
    states, total = both_runs
    assert total[td.STAT_ATTEMPTED] == BLOCKS * CPB * W * P
    assert total[td.STAT_COMMITTED] > 0 and closes(total)
    assert total[td.STAT_MAGIC_BAD] == 0
    assert not any(st.db.locked.any() for st in states)


def test_replicas_live_on_three_hosts(both_runs):
    """Partition (h, c)'s written rows are mirrored at hosts h+1 and h+2,
    the same chip: the three copies of any row sit on three hosts."""
    states = both_runs[0]
    mesh = mh.make_mesh_2d(H, C, device="cpu")
    n1 = td.n_rows(mh.n_sub_local(N_SUB, P)) + 1
    for p in range(P):
        h, c = mesh.coords(p)
        meta = u32.to_numpy(states[p].db.meta)
        val = u32.to_numpy(states[p].db.val).reshape(n1, VW)
        rows = np.nonzero((meta >> 1) > 1)[0]
        assert len(rows) > 0
        hosts = {h}
        for off, slot in ((1, 0), (2, 1)):
            q = mesh.flat(((h + off) % H, c))
            hosts.add(mesh.coords(q)[0])
            bm = u32.to_numpy(states[q].bck_meta)[slot * n1:(slot + 1) * n1]
            bv = u32.to_numpy(states[q].bck_val)[
                slot * n1 * VW:(slot + 1) * n1 * VW].reshape(n1, VW)
            assert np.array_equal(bm[rows], meta[rows]), (h, c, off)
            assert np.array_equal(bv[rows], val[rows]), (h, c, off)
        assert len(hosts) == 3


def test_host_failure_recovers_from_a_surviving_host(both_runs):
    from dint_tpu_torch import recovery
    from dint_tpu_torch.tables import log as logring
    states = both_runs[0]
    mesh = mh.make_mesh_2d(H, C, device="cpu")
    dead_h = 1
    for c in range(C):
        dead = mesh.flat((dead_h, c))
        snap = td.populate(np.random.default_rng(3 + dead),
                           mh.n_sub_local(N_SUB, P), val_words=VW,
                           log_replicas=1, log_capacity=LOG_CAP,
                           device="cpu")
        for off in (1, 2):
            log = states[mesh.flat(((dead_h + off) % H, c))].db.log
            rec = recovery.recover_tatp_dense(
                snap, logring.replica_entries(log, 0), log.head,
                key_hi_filter=dead + 1)
            assert torch.equal(rec.val, states[dead].db.val), (c, off)
            assert torch.equal(rec.meta, states[dead].db.meta), (c, off)


def test_fewer_than_three_hosts_refused():
    mesh = mh.make_mesh_2d(2, 2, device="cpu")
    with pytest.raises(ValueError, match="3 hosts"):
        mh.create_multihost(mesh, 64, val_words=VW)
    with pytest.raises(ValueError, match="3 hosts"):
        mh.build_multihost_runner(mesh, 64, w=W)
    with pytest.raises(ValueError, match="dcn"):
        mh.create_multihost(ds.make_mesh(6, device="cpu"), 64)


def test_2d_totals_equal_the_1d_runner_at_6_partitions():
    """The 2-D mesh partitions the same keyspace into the same 6 ranges
    with the same draws as the 1-D runner over 6 shards: every block's
    totals match (only the backup placement differs)."""
    n_sub = P * 64
    totals = []
    for mesh, make in (
            (mh.make_mesh_2d(H, C, device="cpu"), mh.create_multihost),
            (ds.make_mesh(P, device="cpu"), None)):
        if make is None:
            states = ds.create_sharded(mesh, P, n_sub, val_words=VW,
                                       log_capacity=LOG_CAP)
            run, init, drain = ds.build_sharded_pipelined_runner(
                mesh, P, n_sub, w=W, val_words=VW, cohorts_per_block=CPB)
        else:
            states = make(mesh, n_sub, val_words=VW, log_capacity=LOG_CAP)
            run, init, drain = mh.build_multihost_runner(
                mesh, n_sub, w=W, val_words=VW, cohorts_per_block=CPB)
        carry = init(states)
        per_block = []
        for i in range(2):
            carry, s = run(carry, torch.Generator().manual_seed(20 + i))
            per_block.append(s)
        per_block.append(drain(carry)[1])
        totals.append(torch.cat(per_block))
    assert torch.equal(totals[0], totals[1])


def test_mesh_shape_from_env(monkeypatch):
    monkeypatch.setenv("DINT_BENCH_MESH", "3*2")
    assert mh.mesh_shape_from_env() == jmh.mesh_shape_from_env() == (3, 2)
    monkeypatch.delenv("DINT_BENCH_MESH")
    assert mh.mesh_shape_from_env() == (4, 2)
    monkeypatch.setenv("DINT_BENCH_MESH", "three")
    with pytest.raises(ValueError, match="HxC"):
        mh.mesh_shape_from_env()


def test_create_multihost_bit_identical():
    import test_torch_dense_sharded as tds
    jstate = jmh.create_multihost(jmh.make_mesh_2d(H, C), N_SUB + 1,
                                  val_words=VW, seed=5, log_capacity=LOG_CAP)
    pstates = mh.create_multihost(mh.make_mesh_2d(H, C, device="cpu"),
                                  N_SUB + 1, val_words=VW, seed=5,
                                  log_capacity=LOG_CAP)
    want = tds.jax_state(jstate)
    assert want["bck_meta"].shape[:2] == (H, C)
    tds.assert_same(want, convert.sharded_state_to_numpy(pstates, (H, C)))
    back = convert.sharded_state_from_numpy(want, "cpu")
    tds.assert_same(want, convert.sharded_state_to_numpy(back, (H, C)))


def test_dryrun_multichip_prints_its_line(capsys):
    entry.dryrun_multichip(4, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip ok: devices=4 ")
    fields = dict(kv.split("=") for kv in line.split(": ", 1)[1].split())
    assert fields["tatp_committed"] == fields["smallbank_committed"] == "16"
    assert fields["tatp_local_rows"] == "51"
    assert int(fields["dense_tatp_attempted"]) == 2 * 2 * 32 * 4
    assert 0 < int(fields["dense_tatp_committed"]) <= 512
    # the reference's whole line, in its order, the SmallBank fields too
    assert list(fields) == [
        "devices", "tatp_local_rows", "tatp_committed",
        "smallbank_committed", "dense_tatp_attempted",
        "dense_tatp_committed", "dense_tatp_ab_lock", "dense_tatp_ab_missing",
        "dense_tatp_ab_validate", "dense_sb_committed", "conservation_ok",
        "wall_s"]
    assert 0 < int(fields["dense_sb_committed"]) <= 2 * 2 * 16 * 4
    assert fields["conservation_ok"] == "True"
