"""The port's generic SmallBank engine (dint_tpu_torch.engines.smallbank and
the generic half of smallbank_pipeline) against `dint_tpu` on the CPU.

Both sides take the same numpy-made batches, or the same random draws:
the JAX runner makes them with `jax.random` inside its block, and the
test replays them into the port's ``run.run_draws``. Every comparison is
bit-identical: the three replicas' balances, versions, lock counts and
log rings, replies, per-step stats and counters."""
import functools

import jax
import numpy as np
import pytest
import torch

from dint_tpu.engines import smallbank as jsb
from dint_tpu.engines import smallbank_pipeline as jsp
from dint_tpu.monitor import counters as jmon
from dint_tpu_torch import convert
from dint_tpu_torch.engines import smallbank, smallbank_pipeline as sp
from dint_tpu_torch.engines.types import Op, Reply
from dint_tpu_torch.monitor import counters as mon
from dint_tpu_torch.ops import u32

import test_torch_smallbank_dense as tsd
from test_torch_lock_engines import (assert_same, assert_same_replies,
                                     batches, np_tree)

LOG_CAP = 1 << 12
BLOCKS = 3
# (n_accounts, w, cohorts_per_block): the workload's skew over 4,000
# accounts (a 160-account hot set), and tests/test_smallbank_pipeline.py's
# contention geometry (64 accounts, a 2-account hot set)
DEFAULT = (4000, 128, 2)
CONTENTION = (64, 128, 2)


@pytest.fixture
def small_log(monkeypatch):
    """JAX's `create_stacked` takes no log size: a 2^12-entry ring for the
    JAX shards it builds in this test."""
    monkeypatch.setattr(jsb, "create", functools.partial(
        jsb.create, log_capacity=LOG_CAP))


def _assert_same_stacked(jstacked, pshards):
    assert_same(np_tree(jstacked), convert.stacked_to_numpy(pshards))


def _assert_replicas_identical(pshards):
    d = [convert.tree_to_numpy(s) for s in pshards]
    for other in d[1:]:
        assert_same(d[0], other)


# ----------------------------------------------------------- smallbank.step

_OPS = [Op.ACQ_S_READ, Op.ACQ_X_READ, Op.ACQ_X_READ, Op.REL_S, Op.REL_X,
        Op.COMMIT_PRIM, Op.COMMIT_BCK, Op.COMMIT_LOG, Op.NOP]


def _one_shard(n, val_words=2):
    """A populated JAX shard (balances, magic, versions near 2^31) and the
    port's copy."""
    rng = np.random.default_rng(n)
    js = jsb.create(n, val_words=val_words, log_lanes=4, log_capacity=64)
    val = rng.integers(0, 1 << 32, (n * val_words,), dtype=np.uint64)
    ver = ((1 << 31) - 4 + rng.integers(0, 8, n)).astype(np.uint32)
    js = js.replace(sav=js.sav.replace(val=jax.numpy.asarray(
        val.astype(np.uint32)), ver=jax.numpy.asarray(ver)))
    return js, convert.smallbank_shard_from_numpy(np_tree(js), "cpu")


def test_smallbank_step_contended_batches_bit_identical():
    n, r = 24, 96
    js, ps = _one_shard(n)
    jstep = jax.jit(jsb.step)
    rng = np.random.default_rng(2)
    seen = set()
    for _ in range(10):
        ops = np.asarray(_OPS)[rng.integers(0, len(_OPS), r)]
        keys = rng.integers(0, n, r).astype(np.uint64)
        vals = rng.integers(0, 1 << 32, (r, 2), dtype=np.uint64)
        # versions on both sides of 2^31: the install compares them signed
        vers = ((1 << 31) - 6 + rng.integers(0, 12, r)).astype(np.uint64)
        jb, pb = batches(ops, keys, vals, vers=vers,
                         tables=rng.integers(0, 2, r), width=r + 9)
        js, jrep = jstep(js, jb)
        ps, prep = smallbank.step(ps, pb)
        assert_same_replies(jrep, prep)
        assert_same(np_tree(js), convert.tree_to_numpy(ps))
        seen |= set(prep.rtype.tolist())
    assert {Reply.GRANT, Reply.REJECT, Reply.ACK, Reply.NONE} <= seen


def test_smallbank_install_compares_versions_signed():
    """The newest version wins the install, compared as int32: a commit
    carrying 2^31 + 1 loses to the row's version 5, one carrying 7 wins,
    and between two commits of one account 6 beats 2^31 + 1 (the
    reference's ver.astype(I32))."""
    js, ps = _one_shard(4)
    big = (1 << 31) + 1
    base = np.array([5, 5, 5, 5], np.uint32)
    js = js.replace(chk=js.chk.replace(ver=jax.numpy.asarray(base)))
    ps.chk.ver.copy_(u32.from_numpy(base, "cpu"))
    ops = [Op.COMMIT_PRIM, Op.COMMIT_BCK, Op.COMMIT_PRIM, Op.COMMIT_PRIM,
           Op.ACQ_S_READ, Op.ACQ_S_READ, Op.ACQ_S_READ]
    keys = np.array([0, 1, 1, 2, 0, 1, 2], np.uint64)
    vers = np.array([big, big, 6, 7, 0, 0, 0], np.uint64)
    vals = np.arange(14, dtype=np.uint32).reshape(7, 2) + 100
    jb, pb = batches(ops, keys, vals, vers=vers,
                     tables=[smallbank.CHECKING] * 7)
    js, jrep = jsb.step(js, jb)
    ps, prep = smallbank.step(ps, pb)
    assert_same_replies(jrep, prep)
    assert_same(np_tree(js), convert.tree_to_numpy(ps))
    got = convert.tree_to_numpy(ps)["chk.ver"]
    assert got[:3].tolist() == [5, 6, 7]
    assert prep.ver[4:].tolist() == [5, 6, 7]
    assert prep.val[5].tolist() == [104, 105]      # the ver-6 lane's value


def test_smallbank_pad_lanes_read_the_last_row():
    """Pad lanes (key 0xFFFFFFFF, int32 -1) read the last row, as JAX's
    wrapped gather does, and write nothing."""
    js, ps = _one_shard(8)
    jb, pb = batches([Op.ACQ_X_READ], np.array([7], np.uint64), width=6)
    js, jrep = jsb.step(js, jb)
    ps, prep = smallbank.step(ps, pb)
    assert_same_replies(jrep, prep)
    assert_same(np_tree(js), convert.tree_to_numpy(ps))


# ------------------------------------------------------------ the runner


def test_create_stacked_bit_identical(small_log):
    jst = jsp.create_stacked(300)
    pst = sp.create_stacked(300, log_capacity=LOG_CAP, device="cpu")
    _assert_same_stacked(jst, pst)
    assert len({s.sav.val.data_ptr() for s in pst}) == 3
    assert int(sp.total_balance(pst)) == int(jsp.total_balance(jst))
    _assert_same_stacked(jst, convert.smallbank_stacked_from_numpy(
        np_tree(jst), "cpu"))


@pytest.mark.parametrize("cfg,monitor", [(DEFAULT, False),
                                         (CONTENTION, True)],
                         ids=["default", "contention-monitor"])
def test_runner_bit_identical(small_log, cfg, monitor):
    n, w, cpb = cfg
    jst = jsp.create_stacked(n)
    pst = sp.create_stacked(n, log_capacity=LOG_CAP, device="cpu")
    base = int(sp.total_balance(pst))
    jrun = jsp.build_runner(n, w=w, cohorts_per_block=cpb, monitor=monitor)
    prun = sp.build_runner(n, w=w, cohorts_per_block=cpb, monitor=monitor,
                           device="cpu")
    jc = (jst, jmon.create()) if monitor else jst
    pc = (pst, mon.create("cpu")) if monitor else pst
    total = np.zeros(sp.N_STATS, np.int64)
    for i in range(BLOCKS):
        bkey = jax.random.fold_in(jax.random.PRNGKey(3), i)
        jc, js = jrun(jc, bkey)
        pc, pstats = prun.run_draws(pc, *tsd._block_draws(bkey, cpb, w))
        assert np.array_equal(np.asarray(js), pstats.numpy()), i
        total += pstats.numpy().sum(0)
    pst = pc[0] if monitor else pc
    _assert_same_stacked(jc[0] if monitor else jc, pst)
    _assert_replicas_identical(pst)
    for s in pst:
        for lk in (s.sav_sh, s.sav_ex, s.chk_sh, s.chk_ex):
            assert not lk.any()
    assert (total[sp.STAT_COMMITTED] + total[sp.STAT_AB_LOCK]
            + total[sp.STAT_AB_LOGIC] == total[sp.STAT_ATTEMPTED]
            == BLOCKS * cpb * w)
    assert total[sp.STAT_MAGIC_BAD] == 0 and total[sp.STAT_AB_LOCK] > 0
    delta = (int(sp.total_balance(pst)) - base) % (1 << 32)
    assert delta == total[sp.STAT_BAL_DELTA] % (1 << 32)
    if monitor:
        # bit-identical but for the reject split, which JAX's generic
        # engine leaves at 0 and the port's fills (held + arb == rejected)
        split = [mon.CTR_LOCK_REJECT_HELD, mon.CTR_LOCK_REJECT_ARB]
        jbuf = np.asarray(jc[1].buf)
        pbuf = convert.counters_to_numpy(pc[1])
        assert np.array_equal(np.delete(jbuf, split),
                              np.delete(pbuf, split))
        assert not jbuf[split].any()
        snap = mon.snapshot(pc[1])
        assert snap["lock_rejected"] == (snap["lock_reject_held"]
                                         + snap["lock_reject_arb"]) > 0
        assert snap["ab_logic"] == total[sp.STAT_AB_LOGIC]


def test_runner_draws_its_own_and_checks_shapes():
    n, w = 500, 32
    run = sp.build_runner(n, w=w, cohorts_per_block=2, device="cpu")
    pst = sp.create_stacked(n, log_capacity=LOG_CAP, device="cpu")
    base = int(sp.total_balance(pst))
    pst, stats = run(pst, torch.Generator().manual_seed(1))
    total = stats.numpy().sum(0)
    assert total[sp.STAT_COMMITTED] > 0
    assert (int(sp.total_balance(pst)) - base) % (1 << 32) == \
        total[sp.STAT_BAL_DELTA] % (1 << 32)
    with pytest.raises(ValueError):
        run.run_draws(pst, stats, stats)
