"""The kernel calls each step of the port makes, on the CPU: which kernel
wrappers a step calls, how often, and with how many streams a call.

Every wrapper launches one kernel a call on the card (none on the CPU, so
the launch counters cannot be read here). The engine modules' imported
wrappers are wrapped with call counters (monkeypatch), then one block of
steps runs on each route of both dense engines, one hot store step and one
hot cache step, and one refill of the cache's hot tier. Where a step
gathers or installs several tables at one point, they are the streams of
one call: TATP's meta and magic gathers and its hot meta and val installs,
SmallBank's held-stamp and balance reads, the store's and the cache's val
and ver reads and installs. The engines' parity tests (tests/test_torch_tatp_*.py,
test_torch_smallbank_dense.py, test_torch_store*.py) hold the results
against the JAX package bit for bit."""
import numpy as np
import pytest
import torch

from dint_tpu_torch.engines import smallbank_dense as sd
from dint_tpu_torch.engines import store, store_cache
from dint_tpu_torch.engines import tatp_dense as td
from dint_tpu_torch.engines.types import Op, make_batch
from dint_tpu_torch.tables import kv

WRAPPERS = ("gather_rows", "gather_rows_hot", "gather_streams",
            "lock_arbitrate", "lock_validate", "scatter_streams",
            "scatter_rows_hot", "scan_slab")
CPB = 2
VW = 10


def _count_calls(monkeypatch, module):
    """Wrap each kernel wrapper ``module`` imports with a counter; returns
    {name: [streams of each call]}."""
    calls = {}
    for name in WRAPPERS:
        fn = getattr(module, name, None)
        if fn is None:
            continue

        def counted(*a, _fn=fn, _name=name, **kw):
            first = a[0]
            calls.setdefault(_name, []).append(
                1 if isinstance(first, torch.Tensor) else len(first))
            return _fn(*a, **kw)
        monkeypatch.setattr(module, name, counted)
    return calls


def _per_step(calls, steps):
    """{name: (calls a step, streams of each call)}."""
    out = {}
    for name, streams in calls.items():
        assert len(streams) % steps == 0, (name, streams)
        assert len(set(streams)) == 1, (name, streams)
        out[name] = (len(streams) // steps, streams[0])
    return out


TATP_STEP = {
    "default": {"gather_rows": (1, 2), "lock_arbitrate": (1, 1)},
    "hotset": {"gather_rows_hot": (1, 2), "lock_arbitrate": (1, 1),
               "scatter_rows_hot": (1, 2)},
    "fused": {"lock_validate": (1, 1), "gather_rows": (1, 1),
              "scatter_streams": (1, 3)},
    "fused+hotset": {"lock_validate": (1, 1), "gather_rows_hot": (1, 1),
                     "scatter_streams": (1, 5)},
}


@pytest.mark.parametrize("route", list(TATP_STEP))
def test_tatp_step_calls(monkeypatch, route):
    """TATP default: the meta and magic gathers are one two-stream
    `gather_rows` call a step (hotset: `gather_rows_hot`, and the meta
    and val installs one two-stream `scatter_rows_hot` call); the fused
    routes gather only the magic words, one stream."""
    use_hotset, use_fused = td.ROUTES[route]
    db = td.populate(np.random.default_rng(0), 200, val_words=VW,
                     log_capacity=64, device="cpu")
    run, init, _ = td.build_pipelined_runner(
        200, w=32, val_words=VW, cohorts_per_block=CPB,
        use_hotset=use_hotset, use_fused=use_fused, device="cpu")
    carry = init(db)
    calls = _count_calls(monkeypatch, td)
    run(carry, torch.Generator().manual_seed(1))
    assert _per_step(calls, CPB) == TATP_STEP[route]


def test_tatp_step_without_the_magic_check(monkeypatch):
    """check_magic=False: the meta gather alone, one stream."""
    db = td.populate(np.random.default_rng(0), 200, val_words=VW,
                     log_capacity=64, device="cpu")
    run, init, _ = td.build_pipelined_runner(
        200, w=32, val_words=VW, cohorts_per_block=CPB, check_magic=False,
        device="cpu")
    carry = init(db)
    calls = _count_calls(monkeypatch, td)
    run(carry, torch.Generator().manual_seed(1))
    assert _per_step(calls, CPB) == {"gather_rows": (1, 1),
                                     "lock_arbitrate": (1, 1)}


SB_STEP = {
    ("default", "exact"): {"gather_rows": (1, 3)},
    ("default", "hashed"): {"gather_rows": (1, 3)},
    # exact regime: stamps through their mirrors and balances, one call
    ("hotset", "exact"): {"gather_rows_hot": (1, 3),
                          "scatter_rows_hot": (1, 1)},
    # hashed (24M accounts): no stamp mirrors; stamps plain, bal hot
    ("hotset", "hashed"): {"gather_rows": (1, 2), "gather_rows_hot": (1, 1),
                           "scatter_rows_hot": (1, 1)},
    ("fused", "exact"): {"gather_streams": (1, 3),
                         "scatter_streams": (1, 2)},
    ("fused+hotset", "exact"): {"gather_streams": (1, 3),
                                "scatter_streams": (1, 3)},
    ("fused+hotset", "hashed"): {"gather_streams": (1, 3),
                                 "scatter_streams": (1, 3)},
}


@pytest.mark.parametrize("route,regime", list(SB_STEP))
def test_smallbank_step_calls(monkeypatch, route, regime):
    """SmallBank default: x, s and bal in one three-stream `gather_rows`
    call a step; hotset in the exact regime one three-stream
    `gather_rows_hot` call, in the hashed regime x + s in one
    `gather_rows` call and bal in one `gather_rows_hot` call."""
    if regime == "hashed":
        monkeypatch.setattr(sd, "MAX_LOCK_SLOTS", 128)
    use_hotset, use_fused = sd.ROUTES[route]
    n = 200
    db = sd.create(n, log_capacity=64, device="cpu")
    assert (db.lock_slots < 2 * n + 1) == (regime == "hashed")
    run, init, _ = sd.build_pipelined_runner(
        n, w=32, cohorts_per_block=CPB, use_hotset=use_hotset,
        use_fused=use_fused, device="cpu")
    carry = init(db)
    if use_hotset:
        assert (carry[0].hot_x is None) == (regime == "hashed")
    calls = _count_calls(monkeypatch, sd)
    run(carry, torch.Generator().manual_seed(1))
    assert _per_step(calls, CPB) == SB_STEP[route, regime]


def _batch(r, n, keys):
    ops = r.choice([Op.GET, Op.SET, Op.INSERT, Op.DELETE], n).astype(np.int32)
    vals = r.integers(0, 1 << 32, (n, VW), dtype=np.uint64).astype(np.uint32)
    return make_batch(ops, r.choice(keys, n).astype(np.uint64), vals,
                      width=n, val_words=VW, device="cpu")


def test_store_hot_step_calls(monkeypatch):
    """The store's hot route: val and ver in one two-stream
    `gather_rows_hot` call, and written through in one two-stream
    `scatter_rows_hot` call."""
    r = np.random.default_rng(4)
    keys = r.choice(80, 50, replace=False).astype(np.uint64)
    vals = r.integers(0, 1 << 32, (50, VW), dtype=np.uint64).astype(
        np.uint32)
    table = kv.populate(kv.create(1 << 5, 4, VW, device="cpu"), keys, vals)
    hot = store.attach_hot(table, 32)
    calls = _count_calls(monkeypatch, store)
    store.step(table, _batch(r, 40, np.arange(80)), hot=hot)
    assert _per_step(calls, 1) == {"gather_rows_hot": (1, 2),
                                   "scatter_rows_hot": (1, 2)}


def test_cache_hot_step_calls(monkeypatch):
    """The cache tier's hot step: val and ver in one two-stream
    `gather_rows_hot` call; the write-backs write val and ver through in
    one two-stream `scatter_rows_hot` call."""
    r = np.random.default_rng(5)
    cache = store_cache.create(16, val_words=VW, hot_keys=300, device="cpu")
    calls = _count_calls(monkeypatch, store_cache)
    store_cache.cache_step(cache, _batch(r, 64, np.arange(1, 400)),
                           policy=store_cache.WB_BLOOM)
    assert _per_step(calls, 1) == {"gather_rows_hot": (1, 2),
                                   "scatter_rows_hot": (1, 2)}


def test_cache_hot_refill_calls(monkeypatch):
    """The cache tier's hot refill installs val and ver through the
    mirror in one two-stream `scatter_rows_hot` call."""
    r = np.random.default_rng(6)
    cache = store_cache.create(16, val_words=VW, hot_keys=300, device="cpu")
    n = 48
    keys = r.choice(np.arange(1, 400), n, replace=False).astype(np.uint64)
    vals = r.integers(0, 1 << 32, (n, VW), dtype=np.uint64).astype(np.uint32)
    b = make_batch(np.full(n, Op.GET, np.int32), keys, vals, width=n,
                   val_words=VW, device="cpu")
    mask = torch.from_numpy(r.random(n) < 0.8)
    ver = torch.from_numpy(r.integers(0, 3, n).astype(np.int32))
    bloom = torch.zeros(n, dtype=torch.int32)
    calls = _count_calls(monkeypatch, store_cache)
    store_cache.refill(cache, b.key_hi, b.key_lo, b.val, ver, bloom, bloom,
                       mask)
    assert _per_step(calls, 1) == {"scatter_rows_hot": (1, 2)}
