"""The port's host coordinators (dint_tpu_torch.clients.tatp_client and
smallbank_client: `Stats`, `Coordinator`, `init_shards`, `total_balance`)
and SmallBank's cohort draws (workloads.sb_sample_accounts, sb_make_txns)
against `dint_tpu.clients` on the CPU.

Both coordinators draw their cohorts from one numpy seed each and drive
three replicas wave by wave; the JAX side runs the jitted shard steps, the
port the in-place ones. After every cohort the `Stats` agree field for
field, and at the end every replica's tables, lock words, CF table and
log ring are bit-identical, and SmallBank's `total_balance` too. The
reference's own invariants hold on the port's side: accounting closes, no
lock is held after a cohort, the replicas agree (all but an attributed CF
lock word's owner, which only the primary sets) and their log heads are
equal (tests/test_tatp.py:78-116, test_smallbank.py:75-110)."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from dint_tpu.clients import smallbank_client as jsbc
from dint_tpu.clients import tatp_client as jtc
from dint_tpu.clients import workloads as jwl
from dint_tpu.engines import smallbank as jsb
from dint_tpu_torch import convert
from dint_tpu_torch.clients import smallbank_client as sbc
from dint_tpu_torch.clients import tatp_client as tc
from dint_tpu_torch.clients import workloads as wl
from dint_tpu_torch.ops import u32
from dint_tpu_torch.tables import locks

from test_torch_lock_engines import assert_same, np_tree

VW = 4
LOG_CAP = 1 << 12


# ------------------------------------------------------------------ draws


@pytest.mark.parametrize("kw", [
    {},
    {"hot_frac": 0.25, "hot_prob": 0.5},
    {"hot_frac": 1e-6, "hot_prob": 1.0},       # a hot set of one account
])
def test_sb_draws_identical(kw):
    for n, n_acc in ((1, 7), (1000, 4000), (4096, 24_000_000)):
        a = jwl.sb_sample_accounts(np.random.default_rng(3), n, n_acc, **kw)
        b = wl.sb_sample_accounts(np.random.default_rng(3), n, n_acc, **kw)
        assert a.dtype == b.dtype == np.int64 and np.array_equal(a, b)
        mix = np.array([0.3, 0.2, 0.0, 0.5, 0.0, 0.0])
        for m in (wl.SB_MIX, mix):
            ja = jwl.sb_make_txns(np.random.default_rng(4), n, n_acc, mix=m,
                                  **kw)
            pa = wl.sb_make_txns(np.random.default_rng(4), n, n_acc, mix=m,
                                 **kw)
            for x, y in zip(ja, pa):
                assert x.dtype == y.dtype and np.array_equal(x, y)
            assert not (pa[1] == pa[2]).any() or n_acc == 1


# ------------------------------------------------------------------- TATP


def _tatp_pair(n_sub, **kw):
    js, _ = jtc.populate_shards(np.random.default_rng(0), n_sub,
                                val_words=VW, log_capacity=LOG_CAP, **kw)
    ps, _ = tc.populate_shards(np.random.default_rng(0), n_sub,
                               val_words=VW, log_capacity=LOG_CAP,
                               device="cpu", **kw)
    return js, ps


def _assert_shards_equal(jshards, pshards):
    for j, p in zip(jshards, pshards):
        assert_same(np_tree(j), convert.tree_to_numpy(p))


# an attr CF lock word keeps its last holder's key, and only the primary
# locks: the owners are the one per-replica state
OWNERS = ("cf_lock.owner_hi", "cf_lock.owner_lo")


def _replicas_identical(pshards):
    d = [{k: v for k, v in convert.tree_to_numpy(s).items()
          if k not in OWNERS} for s in pshards]
    for other in d[1:]:
        assert_same(d[0], other)


def _heads(shards):
    return [int(u32.to_u64(s.log.head).sum()) for s in shards]


def _tatp_closes(st):
    return (st.committed + st.aborted_lock + st.aborted_validate
            + st.aborted_missing + st.aborted_timeout == st.attempted)


# (n_sub, width, cohort, cohorts, populate kw): the default mix over 200
# subscribers, and tests/test_lock_attr.py's attributed shards (24
# subscribers, a 16-slot CF lock table: same-key and hash-sharing rejects)
TATP_CASES = {
    "plain": (200, 256, 64, 4, {"cf_buckets": 1 << 10,
                                "cf_lock_slots": 1 << 10}),
    "attr": (24, 1024, 256, 4, {"cf_lock_slots": 16, "attr_locks": True}),
}


@pytest.mark.parametrize("case", sorted(TATP_CASES))
def test_tatp_coordinator_matches_jax(case):
    n_sub, width, cohort, cohorts, kw = TATP_CASES[case]
    js, ps = _tatp_pair(n_sub, **kw)
    jco = jtc.Coordinator(js, n_sub, width=width, val_words=VW)
    pco = tc.Coordinator(ps, n_sub, width=width, val_words=VW, device="cpu")
    assert pco.attr == (case == "attr")
    assert isinstance(pco.shards[0].cf_lock, locks.OCCAttrTable) == pco.attr
    jr, pr = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(cohorts):
        before = dataclasses.asdict(pco.stats)
        jco.run_cohort(jr, cohort)
        pco.run_cohort(pr, cohort)
        assert dataclasses.asdict(jco.stats) == dataclasses.asdict(pco.stats)
        st = pco.stats
        assert _tatp_closes(st) and st.attempted - before["attempted"] \
            == cohort
        # no lock held after a cohort; the replicas agree
        for s in pco.shards:
            assert not any(bool(lk.any()) for _, lk in s.dense_tables())
            assert not bool(s.cf_lock.locked.any())
        _replicas_identical(pco.shards)
        h = _heads(pco.shards)
        assert h[0] == h[1] == h[2]
    _assert_shards_equal(jco.shards, pco.shards)
    st = pco.stats
    assert st.committed > 0 and _heads(pco.shards)[0] > 0
    if case == "attr":
        assert st.lock_cnt > 0 and st.reject_same_key_cnt > 0 \
            and st.reject_sharing_cnt > 0
        assert st.reject_same_key_cnt + st.reject_sharing_cnt <= st.lock_cnt
    else:
        assert st.lock_cnt == st.reject_sharing_cnt \
            == st.reject_same_key_cnt == 0


def test_tatp_wave_keeps_the_width_assertion():
    """A wave that routes more than ``width`` lanes to one shard is refused,
    as the reference refuses it."""
    _, ps = _tatp_pair(30, cf_buckets=1 << 8, cf_lock_slots=1 << 8)
    co = tc.Coordinator(ps, 30, width=8, val_words=VW, device="cpu")
    keys = np.full(9, 3, np.int64)
    with pytest.raises(AssertionError):
        co._run_wave(np.full(9, 16, np.int32), np.zeros(9, np.int32), keys)
    rt, rv, rver = co._run_wave(np.full(8, 16, np.int32),
                                np.zeros(8, np.int32), keys[:8])
    assert rv.dtype == rver.dtype == np.uint32 and rt.dtype == np.int32
    assert (rv[:, 1] == tc.MAGIC).all() and (rver == 1).all()


# -------------------------------------------------------------- SmallBank


@pytest.fixture
def small_log(monkeypatch):
    """JAX's `init_shards` takes no log size: a 2^12-entry ring for the JAX
    shards it builds in this test."""
    monkeypatch.setattr(jsb, "create", functools.partial(
        jsb.create, log_capacity=LOG_CAP))


def _sb_locks_free(shards):
    return all(int(x.abs().sum()) == 0 for s in shards
               for x in (s.sav_sh, s.sav_ex, s.chk_sh, s.chk_ex))


@pytest.mark.parametrize("n_accounts", [512, 40_000])
def test_smallbank_coordinator_matches_jax(small_log, n_accounts):
    width = 256
    jshards = jsbc.init_shards(n_accounts, init_balance=1000)
    pshards = sbc.init_shards(n_accounts, init_balance=1000,
                              log_capacity=LOG_CAP, device="cpu")
    _assert_shards_equal(jshards, pshards)
    jco = jsbc.Coordinator(jshards, width=width)
    pco = sbc.Coordinator(pshards, width=width, device="cpu")
    base = sbc.total_balance(pco.shards)
    assert base == jsbc.total_balance(jco.shards) == 2 * 1000 * n_accounts
    conserving = np.array([0.3, 0.2, 0.0, 0.5, 0.0, 0.0])
    # the workload's 90/4 skew, a conserving mix, and a skewed wave whose
    # one-account hot set sends every txn's first account to one shard:
    # 300 txns, each with at least one lock there, spill past the width
    # over several batches
    cohorts = [({}, 200, None), ({}, 200, conserving),
               ({"hot_frac": 1e-9, "hot_prob": 1.0}, 300, None),
               ({}, 256, None)]
    jr, pr = np.random.default_rng(11), np.random.default_rng(11)
    spilled = False
    for skew, n, mix in cohorts:
        m = wl.SB_MIX if mix is None else mix
        jt = jwl.sb_make_txns(jr, n, n_accounts, mix=m, **skew)
        pt = wl.sb_make_txns(pr, n, n_accounts, mix=m, **skew)
        for x, y in zip(jt, pt):
            assert np.array_equal(x, y)
        # every txn locks its first account at least once
        spilled |= bool(np.bincount(pt[1] % 3).max() > width)
        before = sbc.total_balance(pco.shards)
        jco.run_cohort(*jt)
        pco.run_cohort(*pt)
        assert dataclasses.asdict(jco.stats) == dataclasses.asdict(pco.stats)
        assert sbc.total_balance(pco.shards) == \
            jsbc.total_balance(jco.shards)
        if mix is not None:
            assert sbc.total_balance(pco.shards) == before
        assert _sb_locks_free(pco.shards)
        _replicas_identical(pco.shards)
        h = _heads(pco.shards)
        assert h[0] == h[1] == h[2]
    assert spilled
    _assert_shards_equal(jco.shards, pco.shards)
    st = pco.stats
    assert st.attempted == sum(n for _, n, _ in cohorts)
    assert st.committed > 0 and st.aborted_lock > 0
    assert st.committed + st.aborted_lock + st.aborted_logic <= st.attempted
    assert _heads(pco.shards)[0] > 0


def test_init_shards_owns_its_storage():
    shards = sbc.init_shards(64, device="cpu", log_capacity=16)
    tensors = [t for s in shards for t in (s.sav.val, s.sav.ver, s.chk.val,
                                           s.chk.ver)]
    ptrs = {t.untyped_storage().data_ptr() for t in tensors}
    assert len(ptrs) == len(tensors)
    assert all(int(t.ne(1).sum()) == 0 for t in tensors[1::2])
    v = shards[0].sav.val.view(-1, sbc.VW)
    assert (v[:, 0] == 1000).all() and (v[:, 1] == wl.SB_MAGIC).all()
    # a write to one replica's checking leaves everything else as it was
    shards[1].chk.val[0] = 7
    assert int(shards[0].chk.val[0]) == int(shards[1].sav.val[0]) == 1000
    assert sbc.total_balance(shards) == 2 * 1000 * 64
    assert isinstance(sbc.total_balance(shards), int)
    assert torch.is_tensor(shards[2].log.head)
