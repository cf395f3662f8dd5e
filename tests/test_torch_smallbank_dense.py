"""The port's dense SmallBank pipeline (dint_tpu_torch) against
`dint_tpu.engines.smallbank_dense` on the CPU.

Both engines start from the same tables (carried across with
dint_tpu_torch.convert) and consume the same random draws: the JAX runner
makes them with `jax.random` inside its block, and the test replays those
exact draws into the port's ``run.run_draws``. The port's drain draws
nothing; JAX's draws amounts that no lane consumes. Every comparison is
bit-exact: balances, stamps, step, log entries and heads, the per-step
stats, and the hot mirrors. The JAX reference takes its XLA route, which
tests/test_hotset.py and tests/test_fused_ops.py pin bit-identical to the
Pallas routes the port's kernel routes mirror."""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dint_tpu.engines import smallbank_dense as jsd
from dint_tpu.engines import smallbank_pipeline as jsp
from dint_tpu_torch import convert
from dint_tpu_torch.engines import smallbank_dense as sd
from dint_tpu_torch.engines import smallbank_pipeline as sp
from dint_tpu_torch.ops import u32
from dint_tpu_torch.tables import log as plog

LOG_CAP = 64          # small ring: the runs below wrap it
BLOCKS = 3

# (n_accounts, w, cohorts_per_block, max_lock_slots): the exact lock regime
# with stamp mirrors at the workload's 4% hot set; the contention
# configuration of tests/test_smallbank_dense.py; the hashed lock regime of
# tests/test_hotset.py (128 slots for 401 rows)
EXACT = (300, 64, 2, None)
CONTENTION = (64, 512, 2, None)
HASHED = (200, 64, 2, 128)
CONFIGS = {"exact": EXACT, "contention": CONTENTION, "hashed": HASHED}


@contextlib.contextmanager
def _patched(cfg):
    """Sets MAX_LOCK_SLOTS on both engines for ``cfg`` (monkeypatch)."""
    with pytest.MonkeyPatch.context() as mp:
        if cfg[3] is not None:
            mp.setattr(jsd, "MAX_LOCK_SLOTS", cfg[3])
            mp.setattr(sd, "MAX_LOCK_SLOTS", cfg[3])
        yield


def _jax_arrays(db) -> dict:
    out = {"bal": np.asarray(db.bal), "x_step": np.asarray(db.x_step),
           "s_step": np.asarray(db.s_step), "step": np.asarray(db.step),
           "log.entries": np.asarray(db.log.entries),
           "log.head": np.asarray(db.log.head), "lanes": db.log.lanes,
           "replicas": db.log.replicas, "hot_n": db.hot_n}
    for k in convert.HOT_LEAVES:
        if getattr(db, k) is not None:
            out[k] = np.asarray(getattr(db, k))
    return out


def _assert_same(jarrays: dict, pdb):
    parrays = convert.dense_bank_to_numpy(pdb)
    assert parrays.keys() == jarrays.keys()
    for k, v in jarrays.items():
        assert np.array_equal(np.asarray(v), np.asarray(parrays[k])), k


def _block_draws(block_key, cpb, w):
    """The JAX runner's block: step keys = split(block_key, cpb); each step
    splits (kgen, kamt) and draws bits [w, 5] and ts_amt [w]
    (smallbank_dense.py:308,325, smallbank_pipeline.py:117)."""
    bits, amt = [], []
    for k in jax.random.split(block_key, cpb):
        kgen, kamt = jax.random.split(k)
        bits.append(np.asarray(jax.random.bits(kgen, (w, 5), jnp.uint32)))
        amt.append(np.asarray(jax.random.randint(
            kamt, (w,), -jsp.TS_AMT_MAX, jsp.TS_AMT_MAX + 1,
            dtype=jnp.int32)))
    return (u32.from_numpy(np.stack(bits), "cpu"),
            torch.from_numpy(np.stack(amt)))


def _block_key(i):
    return jax.random.fold_in(jax.random.PRNGKey(3), i)


def _jax_reference(name: str, use_hotset: bool):
    """The JAX XLA route (or its hot route) over BLOCKS blocks + drain from
    `create`: (start arrays, per-block stats, end arrays)."""
    n, w, cpb, _ = CONFIGS[name]
    with _patched(CONFIGS[name]):
        jdb = jsd.create(n, log_capacity=LOG_CAP)
    start = _jax_arrays(jdb)
    run, init, drain = jsd.build_pipelined_runner(
        n, w=w, cohorts_per_block=cpb, use_pallas=False,
        use_hotset=use_hotset, use_fused=False)
    carry = init(jdb)
    stats = []
    for i in range(BLOCKS):
        carry, s = run(carry, _block_key(i))
        stats.append(np.asarray(s))
    jdb, tail = drain(carry)
    stats.append(np.asarray(tail))
    return start, stats, _jax_arrays(jdb)


@pytest.fixture(scope="module")
def jax_ref():
    """`_jax_reference` of each (configuration, hot route), run once for
    the file."""
    cache = {}

    def get(name, use_hotset=False):
        if (name, use_hotset) not in cache:
            cache[name, use_hotset] = _jax_reference(name, use_hotset)
        return cache[name, use_hotset]
    return get


def _run_port(name, use_hotset, use_fused, start):
    n, w, cpb, _ = CONFIGS[name]
    run, init, drain = sd.build_pipelined_runner(
        n, w=w, cohorts_per_block=cpb, use_hotset=use_hotset,
        use_fused=use_fused, device="cpu")
    db0 = convert.dense_bank_from_numpy(start, "cpu")
    base = int(sd.total_balance(db0))
    carry = init(db0)
    stats = []
    for i in range(BLOCKS):
        carry, s = run.run_draws(carry, *_block_draws(_block_key(i), cpb, w))
        stats.append(s.numpy())
    db, tail = drain(carry)
    stats.append(tail.numpy())
    return db, stats, base


@pytest.mark.parametrize("route", list(sd.ROUTES))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_slice_bit_identical(jax_ref, name, route):
    """Each of the port's four routes against the JAX XLA route: per-step
    stats, balances, stamps, step, log entries and heads, bit for bit;
    then the SmallBank invariants on the port's result."""
    start, jstats, jend = jax_ref(name)
    use_hotset, use_fused = sd.ROUTES[route]
    with _patched(CONFIGS[name]):
        assert sd.lock_slots_for(2 * CONFIGS[name][0] + 1) \
            == start["x_step"].shape[0]
        _assert_same(start, sd.create(CONFIGS[name][0], log_capacity=LOG_CAP,
                                      device="cpu"))
    pdb, pstats, base = _run_port(name, use_hotset, use_fused, start)
    assert len(pstats) == len(jstats) == BLOCKS + 1
    for i, (a, b) in enumerate(zip(jstats, pstats)):
        assert np.array_equal(a, b), i
    pend = convert.dense_bank_to_numpy(pdb)
    for k in ("bal", "x_step", "s_step", "step", "log.entries", "log.head"):
        assert np.array_equal(np.asarray(jend[k]), np.asarray(pend[k])), k
    assert (pdb.hot_bal is not None) == use_hotset

    total = np.concatenate(pstats).astype(np.int64).sum(axis=0)
    n, w, cpb, _ = CONFIGS[name]
    assert total[sd.STAT_ATTEMPTED] == BLOCKS * cpb * w
    assert (total[sd.STAT_COMMITTED] + total[sd.STAT_AB_LOCK]
            + total[sd.STAT_AB_LOGIC] == total[sd.STAT_ATTEMPTED])
    assert total[sd.STAT_COMMITTED] > 0 and total[sd.STAT_MAGIC_BAD] == 0
    # conservation: the table delta is the sum of committed deltas mod 2^32
    final = int(sd.total_balance(pdb))
    assert (final - base) % (1 << 32) == int(total[sd.STAT_BAL_DELTA]) \
        % (1 << 32)
    r0 = plog.replica_entries(pdb.log, 0)
    assert all(torch.equal(r0, plog.replica_entries(pdb.log, r))
               for r in (1, 2))
    assert int(pdb.bal[-1]) == 0
    if name == "contention":
        assert total[sd.STAT_AB_LOCK] > 0.2 * total[sd.STAT_ATTEMPTED]


@pytest.mark.parametrize("name", ["exact", "hashed"])
def test_hot_mirrors_match_jax_hot_route(jax_ref, name):
    """The port's mirrors after the hot routes equal the JAX hot route's
    (use_hotset=True, XLA partition), the mirror is the table prefix, and
    stamp mirrors exist only in the exact lock regime."""
    start, jstats, jend = jax_ref(name, True)
    _, plain_stats, _ = jax_ref(name)
    for a, b in zip(jstats, plain_stats):      # the hot tier moves nothing
        assert np.array_equal(a, b)
    exact = name == "exact"
    assert ("hot_x" in jend) == exact and "hot_bal" in jend
    for use_fused in (False, True):
        pdb, pstats, _ = _run_port(name, True, use_fused, start)
        _assert_same(jend, pdb)
        n, hn = pdb.n_accounts, pdb.hot_n
        assert hn == max(1, int(n * 0.04))
        idx = torch.cat([torch.arange(hn), n + torch.arange(hn)])
        assert torch.equal(pdb.bal[idx], pdb.hot_bal)
        if exact:
            assert torch.equal(pdb.x_step[idx], pdb.hot_x)
            assert torch.equal(pdb.s_step[idx], pdb.hot_s)
        else:
            assert pdb.hot_x is None and pdb.hot_s is None


def test_drain_draws_nothing(jax_ref):
    """The drain step generates no cohort, so its transact_saving amounts
    reach no output: JAX's flush step gives the same state and stats under
    two keys, equal to the port's drain, which takes no draw."""
    n, w, cpb, _ = EXACT
    start, _, _ = jax_ref("exact")
    jrun, jinit, _ = jsd.build_pipelined_runner(
        n, w=w, cohorts_per_block=cpb, use_pallas=False, use_hotset=False,
        use_fused=False)
    jcarry = jrun(jinit(jsd.create(n, log_capacity=LOG_CAP)),
                  _block_key(0))[0]
    flush = jax.jit(functools.partial(jsd.pipe_step, w=w, n_accounts=n,
                                      gen_new=False))
    outs = [flush(*jcarry, jax.random.PRNGKey(k)) for k in (0, 123)]
    for a, b in zip(jax.tree.leaves(outs[0]), jax.tree.leaves(outs[1])):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    prun, pinit, pdrain = sd.build_pipelined_runner(
        n, w=w, cohorts_per_block=cpb, device="cpu")
    pcarry = prun.run_draws(
        pinit(convert.dense_bank_from_numpy(start, "cpu")),
        *_block_draws(_block_key(0), cpb, w))[0]
    pdb, ptail = pdrain(pcarry)
    jdb, _, jstats = outs[0]
    assert np.array_equal(np.asarray(jstats)[None], ptail.numpy())
    _assert_same(_jax_arrays(jdb), pdb)


# ------------------------------------------------------ module-level parity


@pytest.mark.parametrize("n,skew", [
    (1000, {}),                                        # 90/4 default
    (5000, {"hot_frac": 0.5, "hot_prob": 0.3,
            "mix": np.array([0, 0, 0, 1, 0, 0], np.float64)}),
    (2, {"hot_frac": 1.0, "hot_prob": 1.0}),           # a1 == a2 often
    (24_000_000, {}),                                  # full-width keyspace
])
def test_gen_cohort_from_bits_matches_jax(n, skew):
    w = 512
    kg = jax.random.PRNGKey(n)
    want = jsp.gen_cohort(kg, w, n, **skew)
    bits = u32.from_numpy(np.asarray(jax.random.bits(kg, (w, 5), jnp.uint32)),
                          "cpu")
    got = sp.gen_cohort_from_bits(bits, w, n, **skew)
    for a, b in zip(want, got):
        assert b.dtype == torch.int32
        assert np.array_equal(np.asarray(a), b.numpy())


def test_lock_slots_matches_jax():
    r = np.random.default_rng(1)
    w = 600
    ttype = r.integers(0, 6, w).astype(np.int32)
    a1 = r.integers(0, 1000, w).astype(np.int32)
    a2 = r.integers(0, 1000, w).astype(np.int32)
    want = jsp._lock_slots(*map(jnp.asarray, (ttype, a1, a2)))
    got = sp._lock_slots(*map(torch.from_numpy, (ttype, a1, a2)))
    for a, b in zip(want, got):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_compute_phase_matches_jax():
    """Balances that hit send_payment's insufficient-funds abort,
    transact_saving's negative-balance abort and write_check's overdraw
    penalty, plus sums that wrap the i32 range."""
    r = np.random.default_rng(2)
    w = 720
    ttype = np.tile(np.arange(6, dtype=np.int32), w // 6)
    bal = r.integers(-30, 40, (w, sp.L)).astype(np.int32)
    big = (1 << 31) - 3
    bal[::7] = [big, big, 8]                     # i32 sums wrap
    bal[1::11] = [-big, -9, big]
    alive = r.random(w) < 0.85
    ts_amt = r.integers(-sp.TS_AMT_MAX, sp.TS_AMT_MAX + 1, w).astype(np.int32)
    want = jsp.compute_phase(*map(jnp.asarray, (ttype, bal, alive, ts_amt)))
    got = sp.compute_phase(*map(torch.from_numpy, (ttype, bal, alive,
                                                   ts_amt)))
    for a, b in zip(want, got):
        assert np.array_equal(np.asarray(a), b.numpy())
    _, _, logic_abort, _, _ = got
    sp_ins = (ttype == 3) & alive & (bal[:, 0] < sp.AMT)
    ts_neg = (ttype == 4) & alive & (bal[:, 0] + ts_amt < 0)
    assert sp_ins.any() and ts_neg.any()         # both abort branches hit
    assert np.array_equal(logic_abort.numpy(), sp_ins | ts_neg)
    wc_over = (ttype == 5) & alive & (bal[:, 0] + bal[:, 1] < sp.AMT)
    assert wc_over.any() and (~wc_over & (ttype == 5) & alive).any()


@pytest.mark.parametrize("name", ["exact", "hashed"])
def test_create_and_attach_hotset_match_jax(name):
    n = CONFIGS[name][0]
    with _patched(CONFIGS[name]):
        jdb = jsd.create(n, init_balance=(1 << 32) - 7, log_capacity=LOG_CAP)
        pdb = sd.create(n, init_balance=(1 << 32) - 7, log_capacity=LOG_CAP,
                        device="cpu")
    assert (pdb.lock_slots >= 2 * n + 1) == (name == "exact")
    _assert_same(_jax_arrays(jdb), pdb)
    # stamp some slots so the mirror copies more than zeros
    x = np.asarray(jdb.x_step).copy()
    x[::3] = 5
    jdb = jdb.replace(x_step=jnp.asarray(x))
    pdb.x_step = u32.from_numpy(x, "cpu")
    for hot_n in (12, 0, 10 * n):             # default, clamped up, clamped
        _assert_same(_jax_arrays(jsd.attach_hotset(jdb, hot_n)),
                     sd.attach_hotset(pdb, hot_n))


def test_slot_of_matches_jax_at_full_width():
    """The multiply-shift hash of 24M accounts' rows onto 2^25 slots (the
    product wraps mod 2^32 before the shift), and the identity when
    exact."""
    m1 = 2 * 24_000_000 + 1
    h = sd.lock_slots_for(m1)
    assert h == 1 << 25
    r = np.random.default_rng(3)
    rows = np.concatenate([r.integers(0, m1, 4000), [0, 1, m1 - 1,
                                                     (1 << 31) - 1]])
    rows = rows.astype(np.int32)
    for mm, hh in ((m1, h), (300, 512)):
        want = jsd._slot_of(jnp.asarray(rows), mm, hh)
        got = sd._slot_of(torch.from_numpy(rows), mm, hh)
        assert np.array_equal(np.asarray(want), got.numpy())


def test_total_balance_wraps_like_jax():
    jdb = jsd.create(50, log_capacity=LOG_CAP)
    bal = np.full(101, (1 << 31) - 1, np.uint32)
    bal[::3] = 0xFFFFFFF0
    bal[-1] = 0
    jdb = jdb.replace(bal=jnp.asarray(bal))
    pdb = convert.dense_bank_from_numpy(_jax_arrays(jdb), "cpu")
    got = sd.total_balance(pdb)
    assert got.dtype == torch.int32
    assert int(got) == int(np.asarray(jsd.total_balance(jdb)))


# ------------------------------------------------------------ device rules


def test_entry_points_without_device_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [lambda: sd.create(4),
             lambda: sd.build_pipelined_runner(4, w=8),
             lambda: convert.dense_bank_from_numpy({}),
             lambda: plog.create_rep(4, 8, 2)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
