"""The port's generic TATP engine (dint_tpu_torch.engines.tatp, the generic
half of tatp_pipeline, clients.tatp_client.populate_shards) against
`dint_tpu` on the CPU.

Both sides start from the same numpy-drawn populate and consume the same
random draws: the JAX runners make them with `jax.random` inside a block,
and the test replays them into the port's ``run.run_draws``/``drain``.
Every comparison is bit-identical: the three replicas' dense tables, lock
bits, CF table, CF lock words (and owners), log rings, replies, per-step
stats and counters."""
import jax
import numpy as np
import pytest
from dint_tpu.clients import tatp_client as jtc
from dint_tpu.engines import tatp as jtatp
from dint_tpu.engines import tatp_pipeline as jtp
from dint_tpu_torch import convert
from dint_tpu_torch.clients import tatp_client as ptc
from dint_tpu_torch.engines import tatp, tatp_pipeline as tp
from dint_tpu_torch.engines.types import Op, Reply

import test_torch_tatp_dense as ttd
from test_torch_lock_engines import (assert_same, assert_same_replies,
                                     batches, np_tree)

VW = 4
LOG_CAP = 1 << 12
CONTENTION_MIX = ttd.CONTENTION_MIX
# (n_sub, w, cohorts_per_block, mix): the default mix, and the US/IC-heavy
# contention mix over a tiny keyspace of tests/test_tatp_pipelined.py
DEFAULT = (2000, 64, 2, None)
CONTENTION = (32, 256, 2, CONTENTION_MIX)
BLOCKS = 3


def _populate(n_sub, seed=0, **kw):
    """JAX's stacked replicas and the port's, from one numpy seed."""
    js, jcf = jtc.populate_shards(np.random.default_rng(seed), n_sub,
                                  val_words=VW, log_capacity=LOG_CAP, **kw)
    ps, pcf = ptc.populate_shards(np.random.default_rng(seed), n_sub,
                                  val_words=VW, log_capacity=LOG_CAP,
                                  device="cpu", **kw)
    assert np.array_equal(jcf, pcf)
    return jtp.stack_shards(js), ps


def _assert_same_stacked(jstacked, pshards):
    assert_same(np_tree(jstacked), convert.stacked_to_numpy(pshards))


def _assert_replicas_identical(pshards):
    d = [convert.tree_to_numpy(s) for s in pshards]
    for other in d[1:]:
        assert_same(d[0], other)


def _closes(total):
    return (total[tp.STAT_COMMITTED] + total[tp.STAT_AB_LOCK]
            + total[tp.STAT_AB_MISSING] + total[tp.STAT_AB_VALIDATE]
            == total[tp.STAT_ATTEMPTED])


def _no_lock_held(shards):
    for s in shards:
        for _, lock in s.dense_tables():
            assert not lock.any()
        assert not s.cf_lock.locked.any()


@pytest.mark.parametrize("attr", [False, True])
def test_populate_shards_bit_identical(attr):
    jstacked, ps = _populate(300, seed=1, attr_locks=attr)
    _assert_same_stacked(jstacked, ps)
    _assert_replicas_identical(ps)
    # independent storage per replica, and the stacked dict round-trips
    ptrs = {id(s.cf.val.untyped_storage()) for s in ps}
    assert len({s.cf.val.data_ptr() for s in ps}) == 3 and ptrs
    assert tp.stack_shards(ps) == ps
    with pytest.raises(ValueError):
        tp.stack_shards([ps[0], ps[0], ps[1]])
    _assert_same_stacked(jstacked, convert.tatp_stacked_from_numpy(
        np_tree(jstacked), "cpu"))
    assert isinstance(ps[0].cf_lock, tatp.locks.OCCAttrTable) == attr


# ------------------------------------------------------------ tatp.step

_OPS = [Op.OCC_READ, Op.OCC_READ, Op.OCC_LOCK, Op.OCC_LOCK, Op.COMMIT_PRIM,
        Op.COMMIT_BCK, Op.ABORT, Op.INSERT_PRIM, Op.INSERT_BCK,
        Op.DELETE_PRIM, Op.DELETE_BCK, Op.COMMIT_LOG, Op.DELETE_LOG, Op.NOP]


def _random_batch(rng, n, n_sub):
    """n lanes of random ops over all five tables of an n_sub shard, keys
    drawn from a small range so that lanes collide."""
    p1 = n_sub + 1
    tbl = rng.integers(0, 5, n)
    ops = np.asarray(_OPS)[rng.integers(0, len(_OPS), n)]
    sid = rng.integers(1, p1, n)
    typ = rng.integers(1, 5, n)
    keys = np.where(tbl <= tatp.SEC_SUBSCRIBER, sid, sid * 4 + typ - 1)
    cf_sid = rng.integers(1, min(p1, 4), n)     # 36 CF keys at most
    keys = np.where(tbl == tatp.CALL_FORWARDING,
                    tatp.cf_key(cf_sid, typ, 8 * rng.integers(0, 3, n)),
                    keys)
    vals = rng.integers(0, 1 << 32, (n, VW), dtype=np.uint64)
    vers = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    return ops, keys.astype(np.uint64), vals, vers, tbl


@pytest.mark.parametrize("attr", [False, True])
def test_tatp_step_contended_batches_bit_identical(attr):
    n_sub, n = 40, 160     # batches of width 168
    # 16 CF lock slots for 36 CF keys: slots are shared
    jstacked, _ = _populate(n_sub, seed=2, attr_locks=attr,
                            cf_lock_slots=16)
    jshard = jax.tree.map(lambda x: x[0], jstacked)
    pshard = convert.tatp_shard_from_numpy(np_tree(jshard), "cpu")
    jstep = jax.jit(jtatp.step)
    rng = np.random.default_rng(3)
    seen = set()
    for _ in range(8):
        ops, keys, vals, vers, tbl = _random_batch(rng, n, n_sub)
        jb, pb = batches(ops, keys, vals, vers=vers, tables=tbl,
                         width=n + 8, val_words=VW)
        jshard, jrep = jstep(jshard, jb)
        pshard, prep = tatp.step(pshard, pb)
        assert_same_replies(jrep, prep)
        assert_same(np_tree(jshard), convert.tree_to_numpy(pshard))
        seen |= set(prep.rtype.tolist())
    assert {Reply.VAL, Reply.NOT_EXIST, Reply.GRANT, Reply.REJECT,
            Reply.ACK} <= seen
    if attr:
        assert Reply.REJECT_SAME_KEY in seen


def test_tatp_dense_rows_clamp_like_jax():
    """A dense lane's row is its low key word as int32 clamped to [0, n-1]
    (JAX's jnp.clip): a read past the table reads the last row, a key of
    2^31 or more reads row 0, and a commit to the clamped row lands there
    (the last row of SUBSCRIBER, written by a lane whose key is past it)."""
    n_sub = 40        # the contended test's geometry and width: one jit
    jstacked, _ = _populate(n_sub, seed=4, cf_lock_slots=16)
    jshard = jax.tree.map(lambda x: x[0], jstacked)
    pshard = convert.tatp_shard_from_numpy(np_tree(jshard), "cpu")
    ops = [Op.OCC_READ, Op.OCC_READ, Op.OCC_READ, Op.OCC_READ]
    keys = np.array([n_sub + 5, 0xFFFFFFF0, n_sub, 3], np.uint64)
    jstep = jax.jit(jtatp.step)
    for step_ops in (ops, [Op.COMMIT_BCK] + ops[1:], ops):
        jb, pb = batches(step_ops, keys, np.full((4, VW), 77, np.uint32),
                         tables=[tatp.SUBSCRIBER] * 4, width=168,
                         val_words=VW)
        jshard, jrep = jstep(jshard, jb)
        pshard, prep = tatp.step(pshard, pb)
        assert_same_replies(jrep, prep)
        assert_same(np_tree(jshard), convert.tree_to_numpy(pshard))
    rt = prep.rtype.tolist()
    assert rt[0] == rt[2] == Reply.VAL and rt[1] == Reply.NOT_EXIST
    assert prep.val[0].tolist() == [77] * VW       # the clamped commit


# ------------------------------------------------------- the serial runner


@pytest.mark.parametrize("validate", [True, False])
def test_serial_runner_bit_identical(validate):
    n_sub, w, cpb, _ = DEFAULT
    jstacked, ps = _populate(n_sub, seed=6)
    jrun = jtp.build_runner(n_sub, w=w, val_words=VW, cohorts_per_block=cpb,
                            validate=validate)
    prun = tp.build_runner(n_sub, w=w, val_words=VW, cohorts_per_block=cpb,
                           validate=validate, device="cpu")
    key = jax.random.PRNGKey(6)
    total = np.zeros(tp.N_STATS, np.int64)
    for i in range(2):
        bkey = jax.random.fold_in(key, i)
        jstacked, js = jrun(jstacked, bkey)
        ps, pstats = prun.run_draws(ps, *ttd._block_draws(bkey, cpb, w))
        assert np.array_equal(np.asarray(js), pstats.numpy()), i
        total += pstats.numpy().sum(0)
    _assert_same_stacked(jstacked, ps)
    _no_lock_held(ps)
    assert _closes(total) and total[tp.STAT_AB_VALIDATE] == 0
    assert total[tp.STAT_COMMITTED] > 0
