"""The port's sharded dense TATP (dint_tpu_torch.parallel.dense_sharded)
against `dint_tpu.parallel.dense_sharded` on the CPU, and the install
record of the single-chip step (`tatp_dense.Installs`).

JAX runs its runner over 4 of the 8 virtual CPU devices
(tests/conftest.py) on its XLA route; the port runs the same 4 shards as a
list on the CPU, where its kernels take their plain versions. Both start
from the same numpy populate (`create_sharded`), and the test replays
JAX's draws: device d's step i draws from ``fold_in(split(block_key,
cpb)[i], d)``, its drain from ``fold_in(PRNGKey(0), d)`` and
``fold_in(fold_in(PRNGKey(0), 1), d)``. Every comparison is bit-exact:
each block's summed stats, every shard's tables, arb stamps, step, both
backup arrays, log entries and heads, and the counters."""
import jax
import numpy as np
import pytest
import torch

from dint_tpu.engines import tatp_dense as jtd
from dint_tpu.parallel import dense_sharded as jds
from dint_tpu_torch import convert, recovery
from dint_tpu_torch.engines import tatp_dense as td
from dint_tpu_torch.monitor import counters as mon
from dint_tpu_torch.ops import u32
from dint_tpu_torch.parallel import dense_sharded as ds
from dint_tpu_torch.tables import log as logring

import test_torch_tatp_dense as ttd
from test_torch_lock_engines import assert_same

VW = 4
D = 4
N_SUB = D * 200          # global subscribers
W = 32
CPB = 2
LOG_CAP = 128
BLOCKS = 2


def jax_state(state) -> dict:
    """JAX's stacked ShardState as the dict `convert.sharded_state_*`
    carries."""
    db = state.db
    return {"db.val": np.asarray(db.val), "db.meta": np.asarray(db.meta),
            "db.arb": np.asarray(db.arb), "db.step": np.asarray(db.step),
            "db.log.entries": np.asarray(db.log.entries),
            "db.log.head": np.asarray(db.log.head),
            "db.val_words": db.val_words, "db.lanes": db.log.lanes,
            "db.replicas": db.log.replicas,
            "bck_val": np.asarray(state.bck_val),
            "bck_meta": np.asarray(state.bck_meta)}


def mesh_block_draws(block_key, cpb, n, w):
    """JAX's block over n partitions: partition d's step i draws from
    fold_in(split(block_key, cpb)[i], d)."""
    draws = [[ttd._step_draws(jax.random.fold_in(k, d), w) for d in range(n)]
             for k in jax.random.split(block_key, cpb)]
    bits = np.stack([[b for b, _ in row] for row in draws])
    pay = np.stack([[p for _, p in row] for row in draws])
    return u32.from_numpy(bits, "cpu"), torch.from_numpy(pay)


def mesh_drain_payload(n, w):
    """JAX's drain: partition d's two steps draw from fold_in(PRNGKey(0), d)
    and fold_in(fold_in(PRNGKey(0), 1), d)."""
    k0 = jax.random.PRNGKey(0)
    keys = (k0, jax.random.fold_in(k0, 1))
    return torch.from_numpy(np.stack([
        [ttd._step_draws(jax.random.fold_in(k, d), w)[1] for d in range(n)]
        for k in keys]))


def run_both(jrun, jinit, jdrain, jstate, prun, pinit, pdrain, pstates,
             mesh_shape, blocks, seed):
    """Both runners from equal states on JAX's draws; every block's stats
    and the drain's compared. Returns the port's final states, its total
    stats, JAX's final state dict and (monitored runs) both counters."""
    n = int(np.prod(mesh_shape))
    assert_same(jax_state(jstate),
                convert.sharded_state_to_numpy(pstates, mesh_shape))
    jc, pc = jinit(jstate), pinit(pstates)
    total = np.zeros(td.N_STATS, np.int64)
    key = jax.random.PRNGKey(seed)
    for i in range(blocks):
        bkey = jax.random.fold_in(key, i)
        jc, js = jrun(jc, bkey)
        pc, ps = prun.run_draws(pc, *mesh_block_draws(bkey, CPB, n, W))
        assert np.array_equal(np.asarray(js), ps.numpy()), i
        total += ps.numpy().sum(axis=0)
    jout = jdrain(jc)
    pout = pdrain(pc, payload=mesh_drain_payload(n, W))
    assert np.array_equal(np.asarray(jout[1]), pout[1].numpy())
    total += pout[1].numpy().sum(axis=0)
    jdict = jax_state(jout[0])
    assert_same(jdict, convert.sharded_state_to_numpy(pout[0], mesh_shape))
    counters = None
    if len(jout) == 3:
        counters = (np.asarray(jout[2].buf).view(np.uint32),
                    np.stack([u32.to_numpy(c.buf) for c in pout[2]]))
    return pout[0], total, jdict, counters


@pytest.fixture(scope="module")
def jax_runners():
    """JAX's runner, plain and monitored, built once for the file."""
    mesh = jds.make_mesh(D)
    kw = dict(w=W, val_words=VW, cohorts_per_block=CPB, use_pallas=False,
              use_fused=False)
    return mesh, {m: jds.build_sharded_pipelined_runner(
        mesh, D, N_SUB, monitor=m, **kw) for m in (False, True)}


def _run(jax_runners, *, use_fused=False, monitor=False, seed=0,
         step0=None):
    jmesh, jr = jax_runners
    jstate = jds.create_sharded(jmesh, D, N_SUB, val_words=VW, seed=seed,
                                log_capacity=LOG_CAP)
    mesh = ds.make_mesh(D, device="cpu")
    pstates = ds.create_sharded(mesh, D, N_SUB, val_words=VW, seed=seed,
                                log_capacity=LOG_CAP)
    if step0 is not None:
        jstate = jstate.replace(db=jstate.db.replace(
            step=jax.numpy.full((D,), step0, jax.numpy.uint32)))
        for st in pstates:
            st.db.step = step0
    prun, pinit, pdrain = ds.build_sharded_pipelined_runner(
        mesh, D, N_SUB, w=W, val_words=VW, cohorts_per_block=CPB,
        use_fused=use_fused, monitor=monitor)
    return run_both(*jr[monitor], jstate, prun, pinit, pdrain, pstates,
                    (D,), BLOCKS, seed)


@pytest.fixture(scope="module")
def default_run(jax_runners):
    return _run(jax_runners)


def closes(total):
    return (total[td.STAT_COMMITTED] + total[td.STAT_AB_LOCK]
            + total[td.STAT_AB_MISSING] + total[td.STAT_AB_VALIDATE]
            == total[td.STAT_ATTEMPTED])


# ------------------------------------------------------------ JAX parity


def test_default_route_bit_identical(default_run):
    states, total, _, _ = default_run
    assert total[td.STAT_ATTEMPTED] == BLOCKS * CPB * W * D
    assert total[td.STAT_COMMITTED] > 0 and closes(total)
    assert total[td.STAT_MAGIC_BAD] == 0
    assert not any(st.db.locked.any() for st in states)


def test_fused_route_bit_identical(jax_runners, default_run):
    """The fused route (lock_validate + install_log over the
    ``log_replicas=1`` stream) against JAX's XLA route; it ends where the
    default route ends."""
    states, total, jdict, _ = _run(jax_runners, use_fused=True)
    assert np.array_equal(total, default_run[1])
    assert_same(jdict, convert.sharded_state_to_numpy(default_run[0], (D,)))


def test_monitor_counters_bit_identical(jax_runners):
    """Each shard's counters equal JAX's [D, N] buffer row for row, but
    for the dispatch pair, which differs by design (JAX's XLA route counts
    ``dispatch_xla``, the port's kernel route ``dispatch_pallas``); the
    replication hops are counted at the receivers and match the writes."""
    states, total, _, (jbuf, pbuf) = _run(jax_runners, monitor=True,
                                          seed=1)
    assert jbuf.shape == pbuf.shape == (D, mon.N_COUNTERS)
    xla, pallas = mon.CTR_DISPATCH_XLA, mon.CTR_DISPATCH_PALLAS
    same = [i for i in range(mon.N_COUNTERS) if i not in (xla, pallas)]
    assert np.array_equal(jbuf[:, same], pbuf[:, same])
    steps = (BLOCKS * CPB + 2) * np.ones(D, np.uint32)
    assert np.array_equal(jbuf[:, xla], steps) and not jbuf[:, pallas].any()
    assert np.array_equal(pbuf[:, pallas], steps) and not pbuf[:, xla].any()
    snap = mon.snapshot(pbuf)
    assert snap["repl_push_hop1"] == snap["repl_push_hop2"] \
        == snap["install_writes"] > 0
    assert snap["txn_attempted"] == total[td.STAT_ATTEMPTED]
    assert snap["txn_committed"] == total[td.STAT_COMMITTED]


def test_bit_identical_across_stamp_rebase(jax_runners):
    """From a step counter one short of REBASE_AT: block 0 runs unrebased,
    block 1 starts with every shard's rebase."""
    states, total, _, _ = _run(jax_runners, seed=2, step0=td.REBASE_AT - 1)
    assert all(st.db.step == 3 + CPB + 2 for st in states)
    assert closes(total)


# ------------------------------------------------------ the port's own


def test_backups_mirror_the_primaries_written_rows(default_run):
    states = default_run[0]
    n1 = td.n_rows(ds.n_sub_local(N_SUB, D)) + 1
    wrote_any = False
    for d in range(D):
        meta = u32.to_numpy(states[d].db.meta)
        val = u32.to_numpy(states[d].db.val).reshape(n1, VW)
        rows = np.nonzero((meta >> 1) > 1)[0]
        wrote_any |= len(rows) > 0
        for off, slot in ((1, 0), (2, 1)):
            holder = states[(d + off) % D]
            bm = u32.to_numpy(holder.bck_meta)[slot * n1:(slot + 1) * n1]
            bv = u32.to_numpy(holder.bck_val)[
                slot * n1 * VW:(slot + 1) * n1 * VW].reshape(n1, VW)
            assert np.array_equal(bm[rows], meta[rows]), (d, off)
            assert np.array_equal(bv[rows], val[rows]), (d, off)
    assert wrote_any
    # the backups are storage of their own
    ptrs = {t.untyped_storage().data_ptr() for st in states
            for t in (st.db.val, st.db.meta, st.bck_val, st.bck_meta)}
    assert len(ptrs) == 4 * D


def test_log_heads_are_three_times_the_version_bumps(default_run):
    states = default_run[0]
    n_loc = ds.n_sub_local(N_SUB, D)
    bumps = 0
    for d in range(D):
        db0 = td.populate(np.random.default_rng(d), n_loc, val_words=VW,
                          log_replicas=1, device="cpu")
        bumps += int((u32.to_numpy(states[d].db.meta).astype(np.int64)
                      >> 1).sum()
                     - (u32.to_numpy(db0.meta).astype(np.int64) >> 1).sum())
    heads = sum(int(u32.to_numpy(st.db.log.head).astype(np.int64).sum())
                for st in states)
    assert bumps > 0 and heads == 3 * bumps


@pytest.mark.parametrize("dead", [0, 3])
def test_lost_shard_rebuilds_from_each_log_stream(default_run, dead):
    """Shard ``dead`` rebuilds from its populate and any ring that carries
    its stream: its own (tag 0) or a backup holder's (tag dead + 1)."""
    states = default_run[0]
    n_loc = ds.n_sub_local(N_SUB, D)
    snap = td.populate(np.random.default_rng(dead), n_loc, val_words=VW,
                       log_replicas=1, log_capacity=LOG_CAP, device="cpu")
    for holder, tag in ((dead, 0), ((dead + 1) % D, dead + 1),
                        ((dead + 2) % D, dead + 1)):
        log = states[holder].db.log
        rec = recovery.recover_tatp_dense(
            snap, logring.replica_entries(log, 0), log.head,
            key_hi_filter=tag)
        assert torch.equal(rec.val, states[dead].db.val), (holder, tag)
        assert torch.equal(rec.meta, states[dead].db.meta), (holder, tag)


def test_uneven_partition_rounds_up():
    n_sub = D * 100 + 3
    mesh = ds.make_mesh(D, device="cpu")
    states = ds.create_sharded(mesh, D, n_sub, val_words=VW,
                               log_capacity=LOG_CAP)
    n1 = td.n_rows(ds.n_sub_local(n_sub, D)) + 1
    assert all(st.db.meta.shape[0] == n1 and st.bck_meta.shape[0] == 2 * n1
               for st in states)
    run, init, drain = ds.build_sharded_pipelined_runner(
        mesh, D, n_sub, w=W, val_words=VW, cohorts_per_block=CPB)
    carry, stats = run(init(states), torch.Generator().manual_seed(3))
    carry, s2 = run(carry, torch.Generator().manual_seed(4))
    _, tail = drain(carry)
    total = (stats.sum(0) + s2.sum(0) + tail.sum(0)).numpy()
    assert total[td.STAT_ATTEMPTED] == 2 * CPB * W * D and closes(total)


def test_create_sharded_bit_identical_and_checks_its_mesh():
    jstate = jds.create_sharded(jds.make_mesh(D), D, N_SUB + 5,
                                val_words=VW, seed=7, log_capacity=LOG_CAP)
    mesh = ds.make_mesh(D, device="cpu")
    pstates = ds.create_sharded(mesh, D, N_SUB + 5, val_words=VW, seed=7,
                                log_capacity=LOG_CAP)
    assert_same(jax_state(jstate),
                convert.sharded_state_to_numpy(pstates, (D,)))
    back = convert.sharded_state_from_numpy(jax_state(jstate), "cpu")
    assert_same(jax_state(jstate), convert.sharded_state_to_numpy(back, (D,)))
    with pytest.raises(ValueError, match="mesh of 4"):
        ds.create_sharded(mesh, D + 1, N_SUB)
    with pytest.raises(ValueError, match="mesh of 4"):
        ds.build_sharded_pipelined_runner(mesh, 2, N_SUB, w=W)
    run, init, _ = ds.build_sharded_pipelined_runner(
        mesh, D, N_SUB + 5, w=W, val_words=VW, cohorts_per_block=CPB)
    with pytest.raises(ValueError, match="expected bits"):
        run.run_draws(init(pstates),
                      torch.zeros((CPB, W, 4), dtype=torch.int32),
                      torch.zeros((CPB, W, 2), dtype=torch.int32))


# ------------------------------------------- the single-chip install record


INST_FIELDS = ("wmask", "rows", "meta", "val", "tbl", "key", "is_del", "ver")


@pytest.fixture(scope="module")
def jax_installs():
    """JAX's single-chip pipe_step (XLA route, emit_installs=True) over
    five steps of the contention mix: each step's Installs and stats."""
    import functools
    n_sub, w, mix = ttd.CONTENTION[0], ttd.CONTENTION[1], ttd.CONTENTION[3]
    db = jtd.populate(np.random.default_rng(9), n_sub, val_words=VW,
                      log_capacity=ttd.LOG_CAP)
    step = jax.jit(functools.partial(jtd.pipe_step, w=w, n_sub=n_sub,
                                     val_words=VW, mix=mix,
                                     emit_installs=True))
    c1 = c2 = jtd.empty_ctx(w)
    keys = jax.random.split(jax.random.PRNGKey(9), 5)
    out = []
    arrays = ttd._jax_arrays(db)
    for k in keys:
        db, new_ctx, c1n, stats, inst = step(db, c1, c2, k)
        c1, c2 = new_ctx, c1n
        out.append((k, {f: np.asarray(getattr(inst, f)) for f in INST_FIELDS},
                    np.asarray(stats)))
    return arrays, out


@pytest.mark.parametrize("route", list(td.ROUTES))
def test_pipe_step_installs_bit_identical(jax_installs, route):
    arrays, steps = jax_installs
    n_sub, w, mix = ttd.CONTENTION[0], ttd.CONTENTION[1], ttd.CONTENTION[3]
    hot, fused = td.ROUTES[route]
    db = convert.dense_db_from_numpy(arrays, "cpu")
    if hot:
        db = td.attach_hotset(db, 40)
    c1 = c2 = td.empty_ctx(w, "cpu")
    writes = 0
    for i, (key, jinst, jstats) in enumerate(steps):
        bits, payload = ttd._step_draws(key, w)
        out = td.pipe_step(db, c1, c2, u32.from_numpy(bits, "cpu"),
                           torch.tensor(payload), w=w, n_sub=n_sub,
                           val_words=VW, mix=mix, use_hotset=hot,
                           use_fused=fused, emit_installs=True,
                           counters=mon.create("cpu"))
        assert len(out) == 6 and isinstance(out[5], mon.Counters)
        db, c1, c2, stats, inst = out[0], out[1], out[2], out[3], out[4]
        assert np.array_equal(jstats, stats.numpy()), i
        for f in INST_FIELDS:
            got = getattr(inst, f)
            got = got.numpy() if got.dtype == torch.bool else \
                u32.to_numpy(got)
            want = jinst[f]
            want = want if want.dtype == np.bool_ else want.view(np.uint32)
            assert np.array_equal(want, got), (i, f)
        writes += int(jinst["wmask"].sum())
    assert writes > 0
