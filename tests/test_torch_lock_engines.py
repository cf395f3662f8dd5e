"""The port's generic lock engines and their tables (dint_tpu_torch:
lock2pl, fasst, logsrv, tables.locks, tables.log.LogRing, tables.dense,
segments.first_rank_where) and the three microbenchmark clients against
their `dint_tpu` counterparts on the CPU.

Both sides take the same numpy-made batches (each package's make_batch);
state crosses with dint_tpu_torch.convert. Every comparison is
bit-identical: replies, lock counters, lock bits, versions, owners, ring
entries and heads, client stats and counters."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from dint_tpu.clients import micro as jmicro
from dint_tpu.clients import workloads as jwl
from dint_tpu.engines import fasst as jfasst
from dint_tpu.engines import lock2pl as jlock2pl
from dint_tpu.engines import logsrv as jlogsrv
from dint_tpu.engines import types as jtypes
from dint_tpu.ops import hashing as jhashing
from dint_tpu.ops import segments as jseg
from dint_tpu.tables import dense as jdense
from dint_tpu.tables import locks as jlocks
from dint_tpu.tables import log as jlog
from dint_tpu_torch import convert
from dint_tpu_torch.clients import micro as pmicro
from dint_tpu_torch.clients import workloads as pwl
from dint_tpu_torch.engines import fasst, lock2pl, logsrv
from dint_tpu_torch.engines import types as ptypes
from dint_tpu_torch.engines.types import Op, Reply
from dint_tpu_torch.ops import segments, u32
from dint_tpu_torch.tables import dense, locks
from dint_tpu_torch.tables import log as plog

NL = 1 << 6   # tiny slot space: heavy conflicts and hash collisions
VW = 2


# ----------------------------------------------------------------- helpers


def np_tree(obj) -> dict:
    """A JAX dataclass tree -> the flat dict `convert.tree_to_numpy` makes
    of the port's (dotted paths, numpy arrays, static ints)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, jax.Array):
            out[f.name] = np.asarray(v)
        elif dataclasses.is_dataclass(v):
            out.update({f"{f.name}.{k}": x for k, x in np_tree(v).items()})
        else:
            out[f.name] = v
    return out


def bits_of(a):
    """An array's 32-bit words as uint32 (bool stays bool)."""
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.int32 else a


def assert_same(jdict: dict, pdict: dict):
    assert jdict.keys() == pdict.keys()
    for k, v in jdict.items():
        if isinstance(v, np.ndarray):
            assert np.array_equal(bits_of(v), bits_of(pdict[k])), k
        else:
            assert v == pdict[k], k


def assert_same_replies(jrep, prep):
    assert prep.rtype.dtype == prep.val.dtype == prep.ver.dtype \
        == torch.int32
    assert np.array_equal(np.asarray(jrep.rtype), prep.rtype.numpy())
    assert np.array_equal(np.asarray(jrep.val), u32.to_numpy(prep.val))
    assert np.array_equal(np.asarray(jrep.ver), u32.to_numpy(prep.ver))


def batches(ops, keys, vals=None, vers=None, tables=None, width=None,
            val_words=VW):
    """The same batch for both packages."""
    kw = dict(vers=vers, tables=tables, width=width, val_words=val_words)
    return (jtypes.make_batch(ops, keys, vals, **kw),
            ptypes.make_batch(ops, keys, vals, device="cpu", **kw))


# one representative key per slot of an NL-slot table
_K = np.arange(100_000, dtype=np.uint64)
_S = jhashing.bucket_np(_K, NL)
SLOT_KEY = np.array([_K[_S == s][0] for s in range(NL)], np.uint64)


def _run_steps(jstep, pstep, jstate, pstate, make_ops, rng, rounds, n):
    """Rounds of random batches through both steps; each round's ops come
    from ``make_ops(rng, n, held)`` and may release what was granted."""
    held: list[int] = []
    for _ in range(rounds):
        ops, slots = make_ops(rng, n, held)
        jb, pb = batches(ops, SLOT_KEY[slots], width=n + 7)
        jstate, jrep = jstep(jstate, jb)
        pstate, prep = pstep(pstate, pb)
        assert_same_replies(jrep, prep)
        assert_same(np_tree(jstate), convert.tree_to_numpy(pstate))
        rt = prep.rtype.numpy()[:n]
        held += [int(s) for s, t in zip(slots, rt) if t == Reply.GRANT]
    return jstate, pstate


# ---------------------------------------------------------- segments, tables


def test_first_rank_where_matches_jax():
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 60, 200).astype(np.uint32)
    pred = rng.random(200) < 0.2
    jsb = jseg.sort_batch(np.zeros(200, np.uint32), keys)
    psb = segments.sort_batch(torch.zeros(200, dtype=torch.int32),
                              torch.from_numpy(keys.astype(np.int32)))
    jr = np.asarray(jseg.first_rank_where(jsb, np.asarray(pred)[np.asarray(
        jsb.perm)]))
    pr = segments.first_rank_where(psb, torch.from_numpy(pred)[psb.perm])
    assert np.array_equal(jr, pr.numpy())
    assert (pr.numpy() == segments.NO_RANK).any()


def test_scatter_rows_takes_bool_tables():
    table = torch.zeros(8, dtype=torch.bool)
    segments.scatter_rows(table, torch.tensor([1, 3, 5]),
                          torch.tensor([True, True, True]),
                          torch.tensor([True, False, True]))
    assert table.tolist() == [False, True, False, False, False, True,
                              False, False]


def test_lock_tables_create_like_jax():
    for jt, pt in ((jlocks.create_sx(NL), locks.create_sx(NL, "cpu")),
                   (jlocks.create_occ(NL), locks.create_occ(NL, "cpu")),
                   (jlocks.create_occ_attr(NL),
                    locks.create_occ_attr(NL, "cpu"))):
        assert_same(np_tree(jt), convert.tree_to_numpy(pt))
        assert pt.n_slots == NL
    for bad in (0, 3, 48):
        with pytest.raises(ValueError):
            locks.create_occ(bad, "cpu")
    keys = SLOT_KEY[np.arange(NL)]
    hi, lo = (x.astype(np.int32) for x in (keys >> 32, keys & 0xFFFFFFFF))
    assert (locks.lock_slot(torch.from_numpy(hi), torch.from_numpy(lo),
                            NL).numpy() == np.arange(NL)).all()


def test_dense_table_like_jax():
    rng = np.random.default_rng(5)
    n, vw = 37, 3
    vals = rng.integers(0, 1 << 32, (n, vw), dtype=np.uint64).astype(
        np.uint32)
    vers = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    jt = jdense.populate(jdense.create(n, vw), vals, vers)
    pt = dense.populate(dense.create(n, vw, "cpu"), vals, vers)
    assert_same(np_tree(jt), convert.tree_to_numpy(pt))
    assert_same(np_tree(jt), convert.tree_to_numpy(
        convert.dense_table_from_numpy(np_tree(jt), "cpu")))
    idx = rng.integers(0, n, 50).astype(np.int32)
    assert np.array_equal(np.asarray(jdense.gather_rows(jt, idx)),
                          u32.to_numpy(dense.gather_rows(
                              pt, torch.from_numpy(idx))))
    rows = rng.permutation(n)[:20].astype(np.int32)
    new = rng.integers(0, 1 << 32, (20, vw), dtype=np.uint64).astype(
        np.uint32)
    mask = rng.random(20) < 0.5
    jval = jdense.scatter_rows_val(jt, rows, new, mask)
    pval = dense.scatter_rows_val(pt, torch.from_numpy(rows),
                                  u32.from_numpy(new, "cpu"),
                                  torch.from_numpy(mask))
    assert np.array_equal(np.asarray(jval), u32.to_numpy(pval))
    with pytest.raises(AssertionError):
        dense.create(1 << 28, 8, "cpu")


# ------------------------------------------------------------------ lock2pl


def _sx_ops(rng, n, held):
    ops = np.zeros(n, np.int32)
    slots = rng.integers(0, NL, n)
    for i in range(n):
        c = rng.random()
        if c < 0.35:
            ops[i] = Op.ACQ_S
        elif c < 0.6:
            ops[i] = Op.ACQ_X
        elif c < 0.9 and held:
            ops[i] = Op.REL_S if rng.random() < 0.5 else Op.REL_X
            slots[i] = held.pop(int(rng.integers(len(held))))
    return ops, slots


def test_lock2pl_contended_batches_bit_identical():
    _run_steps(jax.jit(jlock2pl.step), lock2pl.step, jlocks.create_sx(NL),
               locks.create_sx(NL, "cpu"), _sx_ops,
               np.random.default_rng(6), rounds=12, n=96)


@pytest.mark.parametrize("ops", [
    [Op.ACQ_S] * 5 + [Op.ACQ_X] * 3,          # all lanes on one slot, S first
    [Op.ACQ_X, Op.ACQ_S, Op.ACQ_X, Op.ACQ_S],  # X first: one X, the rest out
    [Op.REL_X, Op.ACQ_X, Op.ACQ_S, Op.REL_S],  # releases apply first
    [Op.NOP, Op.ACQ_S, Op.NOP, Op.REL_S],
])
def test_lock2pl_one_slot(ops):
    jt, pt = jlocks.create_sx(NL), locks.create_sx(NL, "cpu")
    # hold one X and two S on other slots to start from a used table
    pre = [Op.ACQ_X, Op.ACQ_S, Op.ACQ_S]
    jb, pb = batches(pre, SLOT_KEY[[1, 2, 2]])
    jt, _ = jlock2pl.step(jt, jb)
    pt, _ = lock2pl.step(pt, pb)
    for keys in (SLOT_KEY[[5] * len(ops)], SLOT_KEY[[1] * len(ops)],
                 SLOT_KEY[[2] * len(ops)]):
        jb, pb = batches(ops, keys)
        jt, jrep = jlock2pl.step(jt, jb)
        pt, prep = lock2pl.step(pt, pb)
        assert_same_replies(jrep, prep)
        assert_same(np_tree(jt), convert.tree_to_numpy(pt))


# -------------------------------------------------------------------- fasst


def _occ_ops(rng, n, held):
    ops = np.zeros(n, np.int32)
    slots = rng.integers(0, NL, n)
    for i in range(n):
        c = rng.random()
        if c < 0.4:
            ops[i] = Op.READ_VER
        elif c < 0.7:
            ops[i] = Op.LOCK
        elif held:
            ops[i] = Op.COMMIT_VER if c < 0.85 else Op.ABORT
            slots[i] = held.pop(int(rng.integers(len(held))))
    return ops, slots


def _occ_near_wrap(jt, start):
    """The JAX table with every version at ``start`` (near 2^32)."""
    return jt.replace(ver=jax.numpy.full_like(jt.ver, np.uint32(start)))


@pytest.mark.parametrize("attr", [False, True])
def test_fasst_contended_batches_wrap_bit_identical(attr):
    start = (1 << 32) - 3          # versions wrap past 2^32 in the run
    jt = _occ_near_wrap(jlocks.create_occ_attr(NL) if attr
                        else jlocks.create_occ(NL), start)
    pt = convert.occ_table_from_numpy(np_tree(jt), "cpu")
    jstep = jax.jit(jfasst.step_attr if attr else jfasst.step)
    pstep = fasst.step_attr if attr else fasst.step
    jt, pt = _run_steps(jstep, pstep, jt, pt, _occ_ops,
                        np.random.default_rng(7), rounds=14, n=96)
    ver = u32.to_numpy(pt.ver)
    assert (ver < 10).any() and (ver == start).any()   # some wrapped


def test_fasst_attr_same_key_against_sharing():
    """Two keys of one slot: a LOCK that loses to the holder's own key is
    REJECT_SAME_KEY, one that loses to the other key plain REJECT, both
    for a lock held from before and one granted in the same batch."""
    slot = 9
    k_a, k_b = _K[_S == slot][:2]
    jt, pt = jlocks.create_occ_attr(NL), locks.create_occ_attr(NL, "cpu")
    cases = [
        ([Op.LOCK, Op.LOCK, Op.LOCK], [k_a, k_a, k_b]),    # granted now
        ([Op.LOCK, Op.LOCK, Op.READ_VER], [k_b, k_a, k_a]),  # held by k_a
        ([Op.COMMIT_VER, Op.LOCK, Op.LOCK], [k_a, k_b, k_b]),
        ([Op.ABORT, Op.READ_VER], [k_b, k_a]),
    ]
    seen = set()
    for ops, keys in cases:
        jb, pb = batches(ops, np.array(keys, np.uint64))
        jt, jrep = jfasst.step_attr(jt, jb)
        pt, prep = fasst.step_attr(pt, pb)
        assert_same_replies(jrep, prep)
        assert_same(np_tree(jt), convert.tree_to_numpy(pt))
        seen |= set(prep.rtype.tolist())
    assert {Reply.REJECT, Reply.REJECT_SAME_KEY, Reply.GRANT} <= seen


# ------------------------------------------------------------------- logsrv


@pytest.mark.parametrize("head0", [0, (1 << 32) - 5])
def test_logsrv_ring_wraps_bit_identical(head0):
    """Capacity 8 over 4 lanes, batches with NOP lanes between appends,
    heads that wrap the ring and (second case) 2^32."""
    rng = np.random.default_rng(8)
    jr = jlog.create(lanes=4, capacity=8, val_words=VW)
    jr = jr.replace(head=jax.numpy.full_like(jr.head, np.uint32(head0)))
    pr = convert.log_ring_from_numpy(np_tree(jr), "cpu")
    jstep = jax.jit(jlogsrv.step)
    total = 0
    for i in range(5):
        n = 13 + i
        ops = np.where(rng.random(n) < 0.7, Op.LOG_APPEND, Op.NOP)
        keys = rng.integers(0, 1000, n).astype(np.uint64)
        vals = rng.integers(0, 1 << 32, (n, VW), dtype=np.uint64)
        vers = rng.integers(0, 1 << 32, n, dtype=np.uint64)
        jb, pb = batches(ops, keys, vals, vers=vers,
                         tables=rng.integers(0, 5, n), width=n + 3)
        jr, jrep = jstep(jr, jb)
        pr, prep = logsrv.step(pr, pb)
        assert_same_replies(jrep, prep)
        assert_same(np_tree(jr), convert.tree_to_numpy(pr))
        total += int((ops == Op.LOG_APPEND).sum())
    heads = u32.to_numpy(pr.head).astype(np.int64)
    assert (heads - head0) % (1 << 32) @ np.ones(4, np.int64) == total


def test_log_append_returns_jax_lanes_and_slots():
    rng = np.random.default_rng(9)
    jr = jlog.create(lanes=3, capacity=4, val_words=1)
    pr = plog.create(3, 4, 1, "cpu")
    do = rng.random(11) < 0.6
    args = [rng.integers(0, 5, 11).astype(np.int32),
            rng.integers(0, 2, 11).astype(np.int32)] + [
        rng.integers(0, 1 << 32, 11, dtype=np.uint64).astype(np.uint32)
        for _ in range(3)] + [
        rng.integers(0, 1 << 32, (11, 1), dtype=np.uint64).astype(np.uint32)]
    jr, jlane, jslot = jlog.append(jr, do, *args)
    pr, plane, pslot = plog.append(pr, torch.from_numpy(do), *(
        u32.from_numpy(a, "cpu") for a in args))
    assert np.array_equal(np.asarray(jlane), plane.numpy())
    assert np.array_equal(np.asarray(jslot), pslot.numpy())
    assert_same(np_tree(jr), convert.tree_to_numpy(pr))


# ---------------------------------------------------------- micro clients


def _trace():
    return jwl.lock_trace(np.random.default_rng(3), n_txns=120,
                          key_range=300)


def test_lock_trace_and_nurand_match_jax():
    a = jwl.lock_trace(np.random.default_rng(3), n_txns=50)
    b = pwl.lock_trace(np.random.default_rng(3), n_txns=50)
    assert all(np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])
               for x, y in zip(a, b)) and len(a) == len(b)
    assert np.array_equal(jwl.nurand(np.random.default_rng(1), 255, 97, 64),
                          pwl.nurand(np.random.default_rng(1), 255, 97, 64))


def _same_recorder(jc, pc):
    assert (jc.rec.attempted, jc.rec.committed) == \
        (pc.rec.attempted, pc.rec.committed)
    assert jc.rec.extra == pc.rec.extra


@pytest.mark.parametrize("kind", ["lock2pl", "fasst", "fasst_attr"])
def test_trace_clients_bit_identical(kind):
    trace = _trace()
    kw = dict(n_slots=256, cohort=24, width=256)
    if kind == "lock2pl":
        jc = jmicro.Lock2PLClient(trace, **kw)
        pc = pmicro.Lock2PLClient(trace, device="cpu", **kw)
    else:
        attr = kind == "fasst_attr"
        jc = jmicro.FasstClient(trace, attribute=attr, **kw)
        pc = pmicro.FasstClient(trace, attribute=attr, device="cpu", **kw)
    for _ in range(6):
        assert jc.run_round() == pc.run_round()
        _same_recorder(jc, pc)
        assert_same(np_tree(jc.state), convert.tree_to_numpy(pc.state))
    assert 0 < pc.rec.committed < pc.rec.attempted     # contended
    if kind == "lock2pl":
        assert (pc.state.num_sh == 0).all() and (pc.state.num_ex == 0).all()
    else:
        assert not pc.state.locked.any()
    if kind == "fasst_attr":
        x = pc.rec.extra
        assert x["reject_sharing_cnt"] > 0 and x["reject_same_key_cnt"] > 0


def test_trace_clients_at_sweep_micro_settings():
    """exp.py sweep_micro's trace and cohort (20,000 txns of 5-10 keys
    among 4,800, cohort 512, width 8192) over the clients' 2^16 slots: the
    port commits what the reference commits, round for round. FaSST's
    commits a round fall towards 0: aborted txns retry on the same keys in
    the same lanes, and two whose reads meet each other's write locks
    abort each other every round (the reference's own behaviour)."""
    trace = jwl.lock_trace(np.random.default_rng(0), n_txns=20_000,
                           key_range=4800)
    commits = {}
    for kind, jcls, pcls in (("lock2pl", jmicro.Lock2PLClient,
                              pmicro.Lock2PLClient),
                             ("fasst", jmicro.FasstClient,
                              pmicro.FasstClient)):
        jc = jcls(trace, cohort=512)
        pc = pcls(trace, cohort=512, device="cpu")
        commits[kind] = [pc.run_round() for _ in range(6)]
        assert [jc.run_round() for _ in range(6)] == commits[kind]
        _same_recorder(jc, pc)
        assert_same(np_tree(jc.state), convert.tree_to_numpy(pc.state))
    f = commits["fasst"]
    assert f[-1] < f[0] / 10 and all(a >= b for a, b in zip(f, f[1:]))
    assert min(commits["lock2pl"]) > 100


def test_log_client_bit_identical():
    jc = jmicro.LogClient(width=64, val_words=VW, lanes=4, capacity=16)
    pc = pmicro.LogClient(width=64, val_words=VW, lanes=4, capacity=16,
                          device="cpu")
    for i in range(4):
        n = 40 + i
        assert jc.run_wave(np.random.default_rng(i), n) == \
            pc.run_wave(np.random.default_rng(i), n)
        _same_recorder(jc, pc)
        assert_same(np_tree(jc.state), convert.tree_to_numpy(pc.state))


def test_generic_entry_points_without_device_raise_without_cuda(monkeypatch):
    from dint_tpu_torch.clients import tatp_client
    from dint_tpu_torch.engines import smallbank, smallbank_pipeline, tatp
    from dint_tpu_torch.engines import tatp_pipeline
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(0)
    calls = [lambda: locks.create_sx(4), lambda: locks.create_occ(4),
             lambda: locks.create_occ_attr(4), lambda: plog.create(2, 4),
             lambda: dense.create(4, 2), lambda: smallbank.create(4),
             lambda: tatp.create(4),
             lambda: tatp_client.populate_shards(rng, 4),
             lambda: smallbank_pipeline.create_stacked(4),
             lambda: smallbank_pipeline.build_runner(4, w=8),
             lambda: tatp_pipeline.build_pipelined_runner(4, w=8),
             lambda: tatp_pipeline.build_runner(4, w=8),
             lambda: pmicro.LogClient(width=8, capacity=4),
             lambda: pmicro.Lock2PLClient(_trace()[:2], n_slots=4),
             lambda: pmicro.FasstClient(_trace()[:2], n_slots=4),
             lambda: convert.sx_lock_table_from_numpy({}),
             lambda: convert.tatp_stacked_from_numpy({"sub.ver": [0]}),
             lambda: convert.smallbank_stacked_from_numpy({"sav.ver": [0]})]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
