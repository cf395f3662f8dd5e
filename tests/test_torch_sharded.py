"""The port's sharded generic engines (dint_tpu_torch.parallel.sharded and
parallel.mesh) against `dint_tpu.parallel.sharded` on the CPU.

JAX runs `build_sharded_step` over the 8 virtual CPU devices
(tests/conftest.py); the port runs 8 shards as a list. Both take the same
waves from their own `route_batches` (each package's make_batch over one
numpy draw) and start from the same empty shards. Every comparison is
bit-exact: each shard's tables, lock words, CF table, log ring, the
replies and the psummed vote."""
import jax
import numpy as np
import pytest
import torch

from dint_tpu.engines import tatp as jtatp
from dint_tpu.parallel import sharded as jsh
from dint_tpu_torch import convert
from dint_tpu_torch.engines import smallbank, tatp
from dint_tpu_torch.engines.types import Op, Reply
from dint_tpu_torch.ops import u32
from dint_tpu_torch.parallel import mesh as pmesh
from dint_tpu_torch.parallel import sharded

from test_torch_lock_engines import (assert_same, assert_same_replies,
                                     batches, np_tree)

N = 8
WIDTH = 16
VW = 4
TATP_OPS = np.array([Op.OCC_READ, Op.OCC_LOCK, Op.COMMIT_PRIM,
                     Op.INSERT_PRIM, Op.DELETE_PRIM, Op.ABORT, Op.COMMIT_LOG,
                     Op.DELETE_LOG], np.int32)
SB_OPS = np.array([Op.ACQ_S_READ, Op.ACQ_X_READ, Op.COMMIT_PRIM, Op.REL_S,
                   Op.REL_X, Op.COMMIT_LOG], np.int32)


@pytest.fixture(scope="module")
def jax_mesh():
    assert len(jax.devices()) >= N
    return jsh.make_mesh(N)


def _wave_pairs(ops, tbls, keys, vals, vers, val_words, n=N, width=WIDTH):
    """Each package's routed waves of one request draw, side by side."""
    jw, jo = jsh.route_batches(ops, tbls, keys, vals, vers, n, width,
                               val_words)
    pw, po = sharded.route_batches(ops, tbls, keys, vals, vers, n, width,
                                   val_words, device="cpu")
    assert np.array_equal(jo, po) and len(jw) == len(pw)
    return list(zip(jw, pw))


def _assert_same_wave(jb, pbs):
    assert len(pbs) == np.asarray(jb.op).shape[0]
    for d, pb in enumerate(pbs):
        for f in ("op", "table", "key_hi", "key_lo", "val", "ver"):
            want = np.asarray(getattr(jb, f))[d]
            assert np.array_equal(want.view(np.uint32)
                                  if want.dtype == np.int32 else want,
                                  u32.to_numpy(getattr(pb, f))), (d, f)


def _step_both(jstep, pstep, jstate, pstate, pairs):
    """Every wave through both steps; state, replies and vote compared."""
    for jb, pbs in pairs:
        _assert_same_wave(jb, pbs)
        jstate, jrep, jc = jstep(jstate, jb)
        pstate, prep, pc = pstep(pstate, pbs)
        assert np.array_equal(np.asarray(jc), pc.numpy())
        for d in range(N):
            assert_same_replies(jax.tree.map(lambda x: x[d], jrep), prep[d])
        assert_same(np_tree(jstate), convert.stacked_to_numpy(pstate))
    return jstate, pstate


def _tatp_draw(rng, m, n_sub):
    tbls = rng.integers(0, 5, m).astype(np.int32)
    s_id = rng.integers(1, n_sub + 1, m)
    sub_t = rng.integers(0, 4, m)
    keys = np.where(tbls < 2, s_id, s_id * 4 + sub_t)
    keys = np.where(tbls == tatp.CALL_FORWARDING,
                    tatp.cf_key(s_id, sub_t + 1, 8 * rng.integers(0, 3, m)),
                    keys).astype(np.int64)
    ops = rng.choice(TATP_OPS, m)
    vals = rng.integers(0, 1 << 32, (m, VW), dtype=np.uint64).astype(
        np.uint32)
    vers = rng.integers(0, 5, m).astype(np.uint32)
    return ops, tbls, keys, vals, vers


def test_tatp_replicated_step_8_shards_bit_identical(jax_mesh):
    """Random TATP waves over all five tables (reads, locks, prim
    commits, inserts, deletes, aborts, log appends), some of them skewed
    past the width, through JAX's shard_map step and the port's list."""
    kw = dict(val_words=VW, cf_buckets=256, cf_lock_slots=256,
              log_capacity=1 << 12)
    jstate = jsh.create_sharded_state(jax_mesh, N, 64, **kw)
    mesh = sharded.make_mesh(N, device="cpu")
    pstate = sharded.create_sharded_state(mesh, N, 64, **kw)
    assert_same(np_tree(jstate), convert.stacked_to_numpy(pstate))
    assert len({s.sub.val.data_ptr() for s in pstate}) == N
    back = convert.tatp_sharded_from_numpy(np_tree(jstate), "cpu")
    assert_same(np_tree(jstate), convert.stacked_to_numpy(back))
    jstep = jsh.build_sharded_step(jax_mesh, N)
    pstep = sharded.build_sharded_step(mesh, N)
    rng = np.random.default_rng(11)
    for m in (96, 160, 200):
        pairs = _wave_pairs(*_tatp_draw(rng, m, 64), VW)
        jstate, pstate = _step_both(jstep, pstep, jstate, pstate, pairs)
    assert any(int(s.log.head.sum()) > 0 for s in pstate)


def test_tatp_prim_commits_land_on_both_backups(jax_mesh):
    """tests/test_sharded.py's lock-then-commit pin on the port: every
    routed lock granted, the vote == the commits, and the primary and both
    backup roles hold the value at ver 1."""
    mesh = sharded.make_mesh(N, device="cpu")
    state = sharded.create_sharded_state(mesh, N, 64, val_words=VW,
                                         cf_buckets=256, cf_lock_slots=256,
                                         log_capacity=1 << 12)
    step = sharded.build_sharded_step(mesh, N)
    rng = np.random.default_rng(0)
    keys = rng.choice(np.arange(1, 65), size=32, replace=False).astype(
        np.int64)
    tbls = np.full(32, tatp.SUBSCRIBER, np.int32)
    (wave,), owner = sharded.route_batches(
        np.full(32, Op.OCC_LOCK, np.int32), tbls, keys, None, None, N,
        WIDTH, VW, device="cpu")
    state, rep, committed = step(state, wave)
    for d in range(N):
        cnt = int((owner == d).sum())
        assert (rep[d].rtype[:cnt] == Reply.GRANT).all()
    assert committed.tolist() == [0] * N
    vals = np.zeros((32, VW), np.uint32)
    vals[:, 0] = 1234
    (wave,), _ = sharded.route_batches(
        np.full(32, Op.COMMIT_PRIM, np.int32), tbls, keys, vals, None, N,
        WIDTH, VW, device="cpu")
    state, _, committed = step(state, wave)
    assert committed.tolist() == [32] * N
    for k in keys:
        for role in range(3):
            s = state[(int(k) % N + role) % N]
            row = int(sharded.local_dense_key(int(k), N, role))
            assert int(s.sub.val.view(-1, VW)[row, 0]) == 1234
            assert int(s.sub.ver[row]) == 1
    assert not any(s.sub_lock.any() for s in state)


def test_smallbank_replicated_step_8_shards_bit_identical(jax_mesh):
    jstate = jsh.create_sharded_smallbank(jax_mesh, N, 64, val_words=2,
                                          log_capacity=1 << 12)
    mesh = sharded.make_mesh(N, device="cpu")
    pstate = sharded.create_sharded_smallbank(mesh, N, 64, val_words=2,
                                              log_capacity=1 << 12)
    assert_same(np_tree(jstate), convert.stacked_to_numpy(pstate))
    back = convert.smallbank_sharded_from_numpy(np_tree(jstate), "cpu")
    assert_same(np_tree(jstate), convert.stacked_to_numpy(back))
    jstep = jsh.build_sharded_step(jax_mesh, N, engine="smallbank")
    pstep = sharded.build_sharded_step(mesh, N, engine="smallbank")
    rng = np.random.default_rng(12)
    for m in (96, 140, 96):
        accts = rng.integers(0, 64, m).astype(np.int64)
        tbls = rng.integers(0, 2, m).astype(np.int32)
        ops = rng.choice(SB_OPS, m)
        vals = rng.integers(0, 1000, (m, 2)).astype(np.uint32)
        vers = rng.integers(0, 4, m).astype(np.uint32)
        pairs = _wave_pairs(ops, tbls, accts, vals, vers, 2)
        jstate, pstate = _step_both(jstep, pstep, jstate, pstate, pairs)
    assert any(int(s.sav_ex.sum() + s.chk_sh.sum()) > 0 for s in pstate)


@pytest.mark.parametrize("n,width,keys", [
    (3, 8, [0, 1, 2, 9, 10]),                      # padding
    (3, 8, list(range(0, 72, 3))),                 # skew: 3 waves
    (4, 5, [7, 7, 7, 1, 2, 3, 4, 5, 6, 11, 15, 19, 23, 27]),
])
def test_route_batches_waves_equal_jax(n, width, keys):
    keys = np.array(keys, np.int64)
    m = len(keys)
    ops = np.full(m, Op.OCC_READ, np.int32)
    tbls = (keys % 2).astype(np.int32)
    vals = np.arange(m * VW, dtype=np.uint32).reshape(m, VW)
    pairs = _wave_pairs(ops, tbls, keys, vals, np.arange(m, dtype=np.uint32),
                        VW, n=n, width=width)
    assert len(pairs) == max(1, max(-(-int((keys % n == d).sum()) // width)
                                    for d in range(n)))
    for jb, pbs in pairs:
        _assert_same_wave(jb, pbs)
    total = sum(int((pb.op == Op.OCC_READ).sum()) for _, pbs in pairs
                for pb in pbs)
    assert total == m


def test_local_rows_and_keys_and_the_remap_equal_jax():
    for n_global, n in ((65, 8), (64, 8), (7, 3), (1, 4)):
        assert sharded.local_rows(n_global, n) == jsh.local_rows(n_global, n)
    ks = np.array([0, 1, 5, 63, 64, 1000], np.int64)
    for role in range(3):
        want = np.asarray(jsh.local_dense_key(ks, 8, role))
        assert np.array_equal(sharded.local_dense_key(ks, 8, role), want)
        assert np.array_equal(
            sharded.local_dense_key(torch.from_numpy(ks), 8, role).numpy(),
            want)
    # pad lanes (PAD_KEY), a key past 2^31 and non-dense tables
    keys = np.array([3, 17, 0x80000005, 40], np.uint64)
    tables = np.array([0, 3, 1, jtatp.CALL_FORWARDING], np.int32)
    jb, pb = batches(np.full(4, Op.OCC_READ, np.int32), keys, tables=tables,
                     width=7, val_words=VW)
    for role in range(3):
        jr = jsh._remap_dense_keys(jb, 8, role, jtatp.N_DENSE)
        pr = sharded._remap_dense_keys(pb, 8, role, tatp.N_DENSE)
        assert np.array_equal(np.asarray(jr.key_lo), u32.to_numpy(pr.key_lo))
    op = torch.tensor([Op.COMMIT_PRIM, Op.INSERT_PRIM, Op.DELETE_PRIM,
                       Op.OCC_READ, Op.COMMIT_LOG], dtype=torch.int32)
    assert np.array_equal(np.asarray(jsh._as_backup_ops(op.numpy())),
                          sharded._as_backup_ops(op).numpy())


def test_mesh_collectives():
    m2 = pmesh.Mesh((3, 2), ("dcn", "ici"), device="cpu")
    assert m2.size == 6 and [m2.coords(p) for p in range(6)] == [
        (0, 0), (0, 1), (1, 0), (1, 1), (2, 0), (2, 1)]
    assert all(m2.flat(m2.coords(p)) == p for p in range(6))
    assert [m2.axis_index(p, "ici") for p in range(6)] == [0, 1] * 3
    # JAX's perm [(i, (i + off) % n)]: p receives from p - off on the axis
    assert m2.ppermute(list(range(6)), "dcn", 1) == [4, 5, 0, 1, 2, 3]
    assert m2.ppermute(list(range(6)), "dcn", 2) == [2, 3, 4, 5, 0, 1]
    assert m2.ppermute(list(range(6)), "ici", 1) == [1, 0, 3, 2, 5, 4]
    m1 = sharded.make_mesh(4, device="cpu")
    assert m1.ppermute(["a", "b", "c", "d"], sharded.SHARD_AXIS, 1) == \
        ["d", "a", "b", "c"]
    xs = [torch.tensor([2 ** 31 - 1, 5], dtype=torch.int32)] * 4
    s = m1.psum(xs)
    assert s.dtype == torch.int32 and s.tolist() == [-4, 20]  # wraps
    with pytest.raises(ValueError):
        m1.ppermute([1, 2], sharded.SHARD_AXIS, 1)
    with pytest.raises(ValueError):
        pmesh.Mesh((2,), ("a", "b"), device="cpu")
    with pytest.raises(ValueError, match="n_shards"):
        sharded.build_sharded_step(m1, 8)
    step = sharded.build_sharded_step(m1, 4, engine="smallbank")
    with pytest.raises(ValueError, match="expected 4"):
        step([smallbank.create(8, device="cpu")], [])
