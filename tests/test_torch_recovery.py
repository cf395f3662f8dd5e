"""The port's log recovery, `advance_watermark` and the sequential oracles
(dint_tpu_torch) against `dint_tpu.recovery`, `dint_tpu.tables.log` and
`dint_tpu.testing.oracle` on the CPU.

The rings come from the port's own runners at tests/test_recovery.py's
sizes (the runners are held bit for bit against JAX's by
tests/test_torch_tatp_dense.py and tests/test_torch_smallbank_dense.py),
and from rings made by hand with versions and heads of 2^31 and above.
Both packages rebuild from the same base snapshot (`populate` shares its
numpy draws; `create` is deterministic) and the same ring words; every
comparison is bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dint_tpu import recovery as jrec
from dint_tpu.engines import smallbank_dense as jsd
from dint_tpu.engines import tatp_dense as jtd
from dint_tpu.engines import types as jtypes
from dint_tpu.tables import log as jlog
from dint_tpu.testing import oracle as joracle
from dint_tpu_torch import recovery as prec
from dint_tpu_torch.engines import smallbank_dense as sd
from dint_tpu_torch.engines import tatp_dense as td
from dint_tpu_torch.engines import types as ptypes
from dint_tpu_torch.ops import u32
from dint_tpu_torch.tables import log as plog
from dint_tpu_torch.testing import oracle as poracle

VW = 4
CAP = 256           # log slots a lane: the runs below stay inside it
N_SUB = 64
N_ACC = 256


def _tatp_db0(n_sub=N_SUB):
    rng = lambda: np.random.default_rng(0)  # noqa: E731
    return (jtd.populate(rng(), n_sub, val_words=VW, log_capacity=CAP),
            td.populate(rng(), n_sub, val_words=VW, log_capacity=CAP,
                        device="cpu"))


def _tensors(db) -> dict:
    out = {k: v for k, v in vars(db).items() if isinstance(v, torch.Tensor)}
    out.update({"log.entries": db.log.entries, "log.head": db.log.head})
    return out


def _snapshot(db) -> dict:
    return {k: v.clone() for k, v in _tensors(db).items()}


def _assert_untouched(db, snap):
    now = _tensors(db)
    for k, v in snap.items():
        assert torch.equal(now[k], v), k


def _assert_fresh(rec, db0):
    """No tensor of the rebuilt DB shares storage with db0's."""
    ptrs = {v.data_ptr() for v in _tensors(db0).values()}
    assert not ptrs & {v.data_ptr() for v in _tensors(rec).values()}


@pytest.fixture(scope="module")
def tatp_run():
    """The port's TATP runner at tests/test_recovery.py's sizes (n_sub=64,
    w=128, 4 blocks of 2 cohorts), from populate's tables."""
    _, db = _tatp_db0()
    run, init, drain = td.build_pipelined_runner(
        N_SUB, w=128, val_words=VW, cohorts_per_block=2, device="cpu")
    carry = init(db)
    gen = torch.Generator().manual_seed(0)
    for _ in range(4):
        carry, _ = run(carry, gen)
    db, _ = drain(carry)
    assert int(u32.to_u64(db.log.head).max()) <= CAP
    return db


@pytest.fixture(scope="module")
def bank_run():
    """The port's SmallBank runner at tests/test_recovery.py's sizes."""
    db = sd.create(N_ACC, log_capacity=CAP, device="cpu")
    run, init, drain = sd.build_pipelined_runner(
        N_ACC, w=128, cohorts_per_block=2, device="cpu")
    carry = init(db)
    gen = torch.Generator().manual_seed(1)
    for _ in range(4):
        carry, _ = run(carry, gen)
    db, _ = drain(carry)
    assert int(u32.to_u64(db.log.head).max()) <= CAP
    return db


def _assert_tatp_equal(jdb, pdb):
    assert np.array_equal(np.asarray(jdb.val), u32.to_numpy(pdb.val))
    assert np.array_equal(np.asarray(jdb.meta), u32.to_numpy(pdb.meta))
    assert np.array_equal(np.asarray(jdb.arb), u32.to_numpy(pdb.arb))


@pytest.mark.parametrize("replica", [0, 1, 2])
def test_tatp_recover_and_replay_match_jax_and_the_live_tables(tatp_run,
                                                               replica):
    live = tatp_run
    jdb0, pdb0 = _tatp_db0()
    snap = _snapshot(pdb0)
    ring = plog.replica_entries(live.log, replica)
    ring_np, heads_np = u32.to_numpy(ring), u32.to_numpy(live.log.head)

    j_rec = jrec.recover_tatp_dense(jdb0, ring_np, heads_np)
    p_rec = prec.recover_tatp_dense(pdb0, ring, live.log.head)
    _assert_tatp_equal(j_rec, p_rec)
    j_rep = jrec.replay_tatp_dense(jdb0, jnp.asarray(ring_np),
                                   jnp.asarray(heads_np))
    p_rep = prec.replay_tatp_dense(pdb0, ring, live.log.head)
    _assert_tatp_equal(j_rep, p_rep)

    for rec in (p_rec, p_rep):
        assert torch.equal(rec.val, live.val)
        assert torch.equal(rec.ver, live.ver)
        assert torch.equal(rec.exists, live.exists)
        assert not rec.locked.any()
        assert rec.hot_meta is None and rec.step == pdb0.step
        _assert_fresh(rec, pdb0)
    _assert_untouched(pdb0, snap)
    # the run changed versions, so the rebuild was not trivial
    assert not torch.equal(pdb0.ver, live.ver)


@pytest.mark.parametrize("replica", [0, 1, 2])
def test_smallbank_recover_and_replay_match_jax(bank_run, replica):
    live = bank_run
    jdb0 = jsd.create(N_ACC, log_capacity=CAP)
    pdb0 = sd.create(N_ACC, log_capacity=CAP, device="cpu")
    snap = _snapshot(pdb0)
    ring = plog.replica_entries(live.log, replica)
    ring_np, heads_np = u32.to_numpy(ring), u32.to_numpy(live.log.head)

    j_rec = jrec.recover_smallbank_dense(jdb0, ring_np, heads_np)
    p_rec = prec.recover_smallbank_dense(pdb0, ring_np, heads_np)
    j_rep = jrec.replay_smallbank_dense(jdb0, jnp.asarray(ring_np),
                                        jnp.asarray(heads_np))
    p_rep = prec.replay_smallbank_dense(pdb0, ring, live.log.head)
    for j, p in ((j_rec, p_rec), (j_rep, p_rep)):
        assert np.array_equal(np.asarray(j.bal), u32.to_numpy(p.bal))
        assert int(np.asarray(j.step)) == p.step
        assert not p.x_step.any() and not p.s_step.any()
        assert torch.equal(p.bal, live.bal)
        assert int(sd.total_balance(p)) == int(sd.total_balance(live))
        assert p.step >= live.step - 1
        _assert_fresh(p, pdb0)
    _assert_untouched(pdb0, snap)


def _tatp_ring(rng, lanes, cap, n_sub, vers):
    """A hand-made TATP ring [lanes, cap, HDR+VW] u32: keys in range,
    a few rows written many times (version ties included), deletes."""
    p1 = n_sub + 1
    sizes = np.array([p1, p1, 4 * p1, 4 * p1, 12 * p1])
    n = lanes * cap
    table = rng.integers(0, 5, n)
    key = rng.integers(0, 3, n) % sizes[table]       # few distinct rows
    flags = (table.astype(np.uint32) << 8) | (rng.random(n) < 0.2)
    e = np.zeros((n, jlog.HDR_WORDS + VW), np.uint32)
    e[:, 0] = flags
    e[:, 1] = rng.integers(0, 3, n)                  # source tags
    e[:, 2] = key
    e[:, 3] = rng.choice(vers, n)
    e[:, 4:] = rng.integers(0, 1 << 32, (n, VW), dtype=np.uint64)
    return e.reshape(lanes, cap, -1)


HIGH_VERS = np.array([1, 7, 7, 0x7FFFFFFF, 0x80000000, 0x80000000,
                      0xC0000001, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tatp_high_versions_ties_and_source_filter(seed):
    rng = np.random.default_rng(seed)
    ring = _tatp_ring(rng, 4, 8, 8, HIGH_VERS)
    heads = np.array([8, 5, 0, 7], np.uint32)
    jdb0, pdb0 = _tatp_db0(8)
    # the port's numpy path takes the ring as u32 arrays or int32 tensors
    as_tensors = (u32.from_numpy(ring, "cpu"), u32.from_numpy(heads, "cpu"))
    for tag in (None, 1):
        want = jrec.recover_tatp_dense(jdb0, ring, heads, key_hi_filter=tag)
        for args in ((ring, heads), as_tensors):
            _assert_tatp_equal(want, prec.recover_tatp_dense(
                pdb0, *args, key_hi_filter=tag))
    _assert_tatp_equal(
        jrec.replay_tatp_dense(jdb0, jnp.asarray(ring), jnp.asarray(heads)),
        prec.replay_tatp_dense(pdb0, u32.from_numpy(ring, "cpu"),
                               u32.from_numpy(heads, "cpu")))


def test_tatp_heads_past_2_31_refuse_recovery_and_clamp_replay():
    rng = np.random.default_rng(3)
    ring = _tatp_ring(rng, 4, 8, 8, HIGH_VERS)
    heads = np.array([0x80000000, 3, 0xFFFFFFFF, 9], np.uint32)
    jdb0, pdb0 = _tatp_db0(8)
    for fn, db0, args in (
            (jrec.recover_tatp_dense, jdb0, (ring, heads)),
            (prec.recover_tatp_dense, pdb0, (ring, heads)),
            (prec.recover_tatp_dense, pdb0, (u32.from_numpy(ring, "cpu"),
                                             u32.from_numpy(heads, "cpu")))):
        with pytest.raises(ValueError, match="wrapped"):
            fn(db0, *args)
    _assert_tatp_equal(
        jrec.replay_tatp_dense(jdb0, jnp.asarray(ring), jnp.asarray(heads)),
        prec.replay_tatp_dense(pdb0, u32.from_numpy(ring, "cpu"),
                               u32.from_numpy(heads, "cpu")))


@pytest.mark.parametrize("heads", [[8, 2, 8, 0],
                                   [8, 0x80000001, 0xFFFFFFF0, 1]])
def test_smallbank_hand_made_ring_with_high_versions(heads):
    rng = np.random.default_rng(4)
    lanes, cap, n = 4, 8, 16
    e = np.zeros((lanes * cap, jlog.HDR_WORDS + 2), np.uint32)
    e[:, 0] = rng.integers(0, 2, lanes * cap).astype(np.uint32) << 8
    e[:, 2] = rng.integers(0, 3, lanes * cap)
    e[:, 3] = rng.choice(HIGH_VERS[:-2], lanes * cap)
    e[:, 4] = rng.integers(0, 1 << 32, lanes * cap, dtype=np.uint64)
    ring = e.reshape(lanes, cap, -1)
    heads = np.array(heads, np.uint32)
    jdb0, pdb0 = jsd.create(n), sd.create(n, device="cpu")
    if heads.max() <= cap:
        j = jrec.recover_smallbank_dense(jdb0, ring, heads)
        for args in ((ring, heads), (u32.from_numpy(ring, "cpu"),
                                     u32.from_numpy(heads, "cpu"))):
            p = prec.recover_smallbank_dense(pdb0, *args)
            assert np.array_equal(np.asarray(j.bal), u32.to_numpy(p.bal))
            assert int(np.asarray(j.step)) == p.step > 1 << 31
    j = jrec.replay_smallbank_dense(jdb0, jnp.asarray(ring),
                                    jnp.asarray(heads))
    p = prec.replay_smallbank_dense(pdb0, u32.from_numpy(ring, "cpu"),
                                    u32.from_numpy(heads, "cpu"))
    assert np.array_equal(np.asarray(j.bal), u32.to_numpy(p.bal))
    assert int(np.asarray(j.step)) == p.step


def test_wrapped_ring_refuses_recovery():
    """tests/test_recovery.py's case on the port's runner: a 16-slot ring
    under uniform SmallBank traffic wraps, and both packages refuse it."""
    n = 512
    db = sd.create(n, log_capacity=16, device="cpu")
    run, init, drain = sd.build_pipelined_runner(
        n, w=128, cohorts_per_block=2, hot_frac=1.0, device="cpu")
    carry = init(db)
    gen = torch.Generator().manual_seed(2)
    for _ in range(6):
        carry, _ = run(carry, gen)
    db, _ = drain(carry)
    heads = u32.to_numpy(db.log.head)
    assert (heads > 16).any()
    ring = u32.to_numpy(plog.replica_entries(db.log, 0))
    for fn, db0 in ((jrec.recover_smallbank_dense, jsd.create(n)),
                    (prec.recover_smallbank_dense,
                     sd.create(n, device="cpu"))):
        with pytest.raises(ValueError, match="wrapped"):
            fn(db0, ring, heads)


def test_geometry_mismatch_refuses_recovery(tatp_run):
    ring = u32.to_numpy(plog.replica_entries(tatp_run.log, 0))
    heads = u32.to_numpy(tatp_run.log.head)
    jdb0, pdb0 = _tatp_db0(4)
    for fn, db0 in ((jrec.recover_tatp_dense, jdb0),
                    (prec.recover_tatp_dense, pdb0)):
        with pytest.raises(ValueError, match="geometry"):
            fn(db0, ring, heads)
    ring_sb = np.zeros((2, 4, jlog.HDR_WORDS + 2), np.uint32)
    ring_sb[0, 0, 2] = 40                      # account 40 of a 16-account db
    heads_sb = np.array([1, 0], np.uint32)
    for fn, db0 in ((jrec.recover_smallbank_dense, jsd.create(16)),
                    (prec.recover_smallbank_dense,
                     sd.create(16, device="cpu"))):
        with pytest.raises(ValueError, match="geometry"):
            fn(db0, ring_sb, heads_sb)


def test_replay_ignores_a_key_past_2_31():
    """JAX's replay wraps the negative int32 row of such a key; the port
    reads the key as u32, so the entry is outside its table (the numpy
    path refuses it)."""
    ring = np.zeros((1, 2, jlog.HDR_WORDS + 2), np.uint32)
    ring[0, 0, 2:4] = [0x80000005, 9]
    ring[0, 1, 2:5] = [3, 4, 77]
    heads = np.array([2], np.uint32)
    p = prec.replay_smallbank_dense(sd.create(16, device="cpu"),
                                    u32.from_numpy(ring, "cpu"),
                                    u32.from_numpy(heads, "cpu"))
    want = np.full(33, 1000, np.uint32)
    want[-1], want[3] = 0, 77
    assert np.array_equal(u32.to_numpy(p.bal), want) and p.step == 6


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_advance_watermark_matches_jax_on_wrapping_u32(seed):
    rng = np.random.default_rng(seed)
    lanes = 16
    draw = lambda: rng.integers(0, 1 << 32, lanes,  # noqa: E731
                                dtype=np.uint64).astype(np.uint32)
    head = draw()
    head[:4] = [0, 5, 0xFFFFFFFF, 0x80000000]
    wm = np.where(rng.random(lanes) < 0.5, head - np.uint32(3), draw())
    wm[:4] = [0xFFFFFFFE, 3, 0xFFFFFFF0, 0x7FFFFFFF]
    consumed = draw() >> np.uint32(rng.integers(0, 32))
    consumed[:4] = [4, 1, 0x20, 2]
    jring = jlog.create_rep(lanes, 8, 2).replace(head=jnp.asarray(head))
    want = np.asarray(jlog.advance_watermark(jring, jnp.asarray(wm),
                                             jnp.asarray(consumed)))
    pring = plog.create_rep(lanes, 8, 2, device="cpu")
    pring.head = u32.from_numpy(head, "cpu")
    got = plog.advance_watermark(pring, u32.from_numpy(wm, "cpu"),
                                 u32.from_numpy(consumed, "cpu"))
    assert np.array_equal(want, u32.to_numpy(got))


def test_port_op_codes_are_jax_op_codes():
    for name, v in vars(ptypes.Op).items():
        if not name.startswith("_"):
            assert getattr(jtypes.Op, name) == v, name
    for name, v in vars(ptypes.Reply).items():
        if not name.startswith("_"):
            assert getattr(jtypes.Reply, name) == v, name


def test_store_oracle_matches_jax_on_one_op_stream():
    rng = np.random.default_rng(5)
    Op = jtypes.Op
    jo, po = joracle.StoreOracle(), poracle.StoreOracle()
    choices = [Op.GET, Op.SET, Op.INSERT, Op.DELETE, Op.SCAN, Op.NOP]
    for _ in range(12):
        ops = rng.choice(choices, 16)
        keys = rng.integers(1, 24, 16)
        vals = rng.integers(0, 1 << 32, (16, 3), dtype=np.uint64).astype(
            np.uint32)
        lens = rng.integers(0, 8, 16)
        j = jo.step(ops, keys, vals, scan_lens=lens, scan_max=5)
        p = po.step(ops, keys, vals, scan_lens=lens, scan_max=5)
        for a, b in zip(j[:3], p[:3]):
            assert np.array_equal(a, b)
        assert j[3] == p[3]
        plain = (jo.step(ops[:4], keys[:4], vals[:4]),
                 po.step(ops[:4], keys[:4], vals[:4]))
        for a, b in zip(*plain):
            assert np.array_equal(a, b)
    assert jo.data == po.data and jo.scan(0, 30) == po.scan(0, 30)


def test_lock_and_occ_oracles_match_jax_on_one_op_stream():
    rng = np.random.default_rng(6)
    Op = jtypes.Op
    js, ps = joracle.SXLockOracle(8), poracle.SXLockOracle(8)
    jc, pc = joracle.OCCOracle(8), poracle.OCCOracle(8)
    for _ in range(20):
        slots = rng.integers(0, 8, 24)
        ops = rng.choice([Op.ACQ_S, Op.ACQ_X, Op.REL_S, Op.REL_X, Op.NOP],
                         24)
        assert np.array_equal(js.step(ops, slots), ps.step(ops, slots))
        ops = rng.choice([Op.LOCK, Op.COMMIT_VER, Op.ABORT, Op.READ_VER,
                          Op.NOP], 24)
        for a, b in zip(jc.step(ops, slots), pc.step(ops, slots)):
            assert np.array_equal(a, b)
    assert np.array_equal(js.num_sh, ps.num_sh)
    assert np.array_equal(js.num_ex, ps.num_ex)
    assert np.array_equal(jc.ver, pc.ver)
    assert np.array_equal(jc.locked, pc.locked)
