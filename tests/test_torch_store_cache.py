"""The port's cache tier (dint_tpu_torch/engines/store_cache.py and
dint_tpu_torch/shim/host_kvs.py) against `dint_tpu.engines.store_cache`
and `dint_tpu.shim.host_kvs` on the CPU.

* `cache_step` and `refill` from one state carried by `convert`, on all
  three policies with and without the hot mirror: replies, the miss vector
  and every cache leaf bit-identical after each call; the flush and
  evicted records compared on their masked lanes only (the host applies
  only those; tests/test_hotset.py:413-416 states the contract).
* `HostKVS` against JAX's on tests/test_host_kvs.py's differential and
  last-wins cases: every reply and every internal array.
* `CachedStore` against JAX's `CachedStore` and `StoreOracle`, reply for
  reply, on the cases of tests/test_store_cache.py (policies, evictions,
  bloom negatives, the write-through invalidate, the scan mix), with the
  stats, the caches and the backing stores equal at the end.

Tolerance: exact (integer data)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dint_tpu.engines import store_cache as jsc
from dint_tpu.engines.types import make_batch as jmake_batch
from dint_tpu.shim import host_kvs as jhk
from dint_tpu.testing.oracle import StoreOracle
from dint_tpu_torch import convert
from dint_tpu_torch.engines import store_cache as sc
from dint_tpu_torch.engines.types import Op, Reply, make_batch
from dint_tpu_torch.ops.u32 import from_numpy, to_numpy
from dint_tpu_torch.shim import host_kvs as hk

from test_torch_store_ops import _jax_table

VW = 4


@functools.lru_cache(maxsize=None)
def _jstep(policy):
    return jax.jit(functools.partial(jsc.cache_step, policy=policy))


_jrefill = jax.jit(jsc.refill)


def _jax_cache(c) -> dict:
    d = {**_jax_table(c.kv), "dirty": np.asarray(c.dirty),
         "clock": np.asarray(c.clock)}
    if c.hot_ver is not None:
        d.update(hot_val=np.asarray(c.hot_val), hot_ver=np.asarray(c.hot_ver))
    return d


def _assert_same_cache(jc, pc):
    want, got = _jax_cache(jc), convert.cache_table_to_numpy(pc)
    assert sorted(want) == sorted(got)
    for k in want:
        assert np.array_equal(np.asarray(want[k]), np.asarray(got[k])), k


def _u32(r, shape, hi=1 << 32):
    return r.integers(0, hi, shape, dtype=np.uint64).astype(np.uint32)


def _same_masked(jrec, prec, what):
    """Equal masks, and equal records on the masked lanes."""
    m = np.asarray(jrec["mask"])
    assert np.array_equal(m, prec["mask"].numpy()), f"{what} mask"
    for f in ("key_hi", "key_lo", "val", "ver"):
        assert np.array_equal(np.asarray(jrec[f])[m],
                              to_numpy(prec[f])[m]), f"{what} {f}"
    return bool(m.any())


# ---------------------------------------------------- cache_step / refill


@pytest.mark.parametrize("hot_keys", [0, 300])
@pytest.mark.parametrize("policy", sc.POLICIES)
def test_cache_step_and_refill_match_jax(policy, hot_keys):
    """Ten rounds over 16 buckets x 4 slots and keys 1..400: every op, a
    refill of each round's miss keys with bloom-only lanes, masked-out
    lanes, same-bucket duplicates and keys with a high word, so that
    buckets fill, the rotor evicts and dirty records are flushed."""
    r = np.random.default_rng(11)
    jc = jsc.create(16, val_words=VW, hot_keys=hot_keys)
    pc = convert.cache_table_from_numpy(_jax_cache(jc), "cpu")
    assert pc.hot_n == hot_keys
    n, pad = 128, 64
    saw = {"flush": False, "evict": False, "miss": False, "hit": False}
    for _ in range(10):
        keys = r.integers(1, 400, n).astype(np.uint64)
        ops = r.choice([Op.GET, Op.GET, Op.SET, Op.SET, Op.INSERT,
                        Op.DELETE, Op.NOP, Op.SCAN], n).astype(np.int32)
        vals = _u32(r, (n, VW))
        jc, jrep, jmiss, jflush = _jstep(policy)(
            jc, jmake_batch(ops, keys, vals, width=n, val_words=VW))
        pc, prep, pmiss, pflush = sc.cache_step(
            pc, make_batch(ops, keys, vals, width=n, val_words=VW,
                           device="cpu"), policy=policy)
        for f in ("rtype", "val", "ver"):
            assert np.array_equal(np.asarray(getattr(jrep, f)),
                                  to_numpy(getattr(prep, f))
                                  .view(np.asarray(getattr(jrep, f)).dtype)), f
        m = np.asarray(jmiss)
        assert np.array_equal(m, pmiss.numpy())
        saw["miss"] |= bool(m.any())
        saw["hit"] |= bool((~m & (ops != Op.NOP)).any())
        saw["flush"] |= _same_masked(jflush, pflush, "flush")
        _assert_same_cache(jc, pc)

        rk = keys[m][:pad - 4]
        rk = np.r_[rk, rk[:2], np.uint64(1 << 33) + rk[:2]]   # dups, high
        kh, kl = (rk >> np.uint64(32)).astype(np.uint32), rk.astype(np.uint32)
        k = len(rk)
        key_hi, key_lo = np.zeros(pad, np.uint32), np.zeros(pad, np.uint32)
        key_hi[:k], key_lo[:k] = kh, kl
        rv = _u32(r, (pad, VW))
        rver = np.where(r.random(pad) < 0.2, 0,
                        r.integers(1, 50, pad)).astype(np.uint32)
        b_hi, b_lo = _u32(r, pad), _u32(r, pad)
        mask = np.zeros(pad, bool)
        mask[:k] = r.random(k) < 0.9
        args = (key_hi, key_lo, rv, rver, b_hi, b_lo)
        jc, jev = _jrefill(jc, *map(jnp.asarray, args), jnp.asarray(mask))
        pc, pev = sc.refill(pc, *(from_numpy(a, "cpu") for a in args),
                            torch.from_numpy(mask))
        saw["evict"] |= _same_masked(jev, pev, "evicted")
        _assert_same_cache(jc, pc)
    assert saw["miss"] and saw["hit"]
    if policy != sc.WT:
        assert saw["flush"] and saw["evict"], saw


def test_cache_create_and_round_trip():
    c = sc.create(16, slots=4, val_words=VW, hot_keys=8, device="cpu")
    assert c.kv.n_buckets == 16 and c.hot_n == 8 and c.clock == 0
    assert c.hot_val.numel() == 8 * VW and not c.dirty.any()
    c.clock = 0xFFFFFFFF
    back = convert.cache_table_from_numpy(convert.cache_table_to_numpy(c),
                                          "cpu")
    assert back.clock == 0xFFFFFFFF
    assert back.hot_val.untyped_storage().data_ptr() != \
        c.hot_val.untyped_storage().data_ptr()
    for a, b in zip(convert.cache_table_to_numpy(c).values(),
                    convert.cache_table_to_numpy(back).values()):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_refill_rotor_wraps_like_jax():
    """Three slots a bucket, so (clock + lane) % S depends on the u32 wrap
    of clock + lane; the clock starts two below 2^32."""
    r = np.random.default_rng(5)
    jc = jsc.create(4, slots=3, val_words=VW)
    jc = jc.replace(clock=jnp.uint32(0xFFFFFFFE))
    pc = convert.cache_table_from_numpy(_jax_cache(jc), "cpu")
    assert pc.clock == 0xFFFFFFFE
    for _ in range(8):
        keys = r.choice(np.arange(1, 60, dtype=np.uint32), 6, replace=False)
        args = (np.zeros(6, np.uint32), keys, _u32(r, (6, VW)),
                r.integers(1, 9, 6).astype(np.uint32), _u32(r, 6),
                _u32(r, 6))
        jc, jev = _jrefill(jc, *map(jnp.asarray, args),
                           jnp.ones(6, bool))
        pc, pev = sc.refill(pc, *(from_numpy(a, "cpu") for a in args),
                            torch.ones(6, dtype=torch.bool))
        _assert_same_cache(jc, pc)
    assert pc.clock == 6 and bool(pc.kv.valid.all())


# ----------------------------------------------------------------- HostKVS


def _assert_same_kvs(jk, pk):
    assert (jk.nb, jk.n_live, jk.cache_nb, jk.vw) == \
        (pk.nb, pk.n_live, pk.cache_nb, pk.vw)
    for f in ("_keys", "_used", "_vals", "_vers", "_bloom_cnt"):
        assert np.array_equal(getattr(jk, f), getattr(pk, f)), f
    assert sorted(jk._spill) == sorted(pk._spill)
    for k, (v, ver) in jk._spill.items():
        assert np.array_equal(v, pk._spill[k][0]) and ver == pk._spill[k][1]


def test_host_kvs_differential_matches_jax():
    """tests/test_host_kvs.py's differential case (capacity 64 forces
    grows and spills), plus scans, through both packages."""
    r = np.random.default_rng(0)
    jk, pk = jhk.HostKVS(256, VW, capacity=64), hk.HostKVS(256, VW,
                                                         capacity=64)
    keys0 = r.choice(np.arange(1, 2000, dtype=np.uint64), 300, replace=False)
    vals0 = r.integers(0, 1 << 16, (300, VW)).astype(np.uint32)
    jk.populate(keys0, vals0)
    pk.populate(keys0, vals0)
    _assert_same_kvs(jk, pk)
    for _ in range(20):
        m = int(r.integers(1, 200))
        ops = r.choice([Op.GET, Op.SET, Op.INSERT, Op.DELETE, Op.SCAN], m,
                       p=[0.35, 0.3, 0.15, 0.15, 0.05]).astype(np.int32)
        keys = r.integers(1, 400, m).astype(np.uint64)
        vals = r.integers(0, 1 << 16, (m, VW)).astype(np.uint32)
        lens = r.integers(0, 7, m)
        want = jk.resolve_batch(ops, keys, vals, scan_lens=lens, scan_max=5)
        got = pk.resolve_batch(ops, keys, vals, scan_lens=lens, scan_max=5)
        for w, g in zip(want[:3], got[:3]):
            assert w.dtype == g.dtype and np.array_equal(w, g)
        assert want[3] == got[3]
        _assert_same_kvs(jk, pk)
    probe = np.arange(1, 2001, dtype=np.uint64)
    for w, g in zip(jk.lookup(probe), pk.lookup(probe)):
        assert np.array_equal(w, g)
    assert np.array_equal(jk.bloom_words(np.arange(256)),
                          pk.bloom_words(np.arange(256)))


def test_host_kvs_last_wins_matches_jax():
    jk, pk = jhk.HostKVS(256, VW, capacity=64), hk.HostKVS(256, VW,
                                                         capacity=64)
    keys = np.array([5, 5, 9, 5], np.uint64)
    vals = np.arange(4 * VW, dtype=np.uint32).reshape(4, VW)
    for k in (jk, pk):
        k.upsert_batch(keys, vals, np.ones(4, np.uint32))
    _assert_same_kvs(jk, pk)
    assert pk.n_live == 2
    assert np.array_equal(pk.lookup(np.array([5], np.uint64))[1][0], vals[3])
    gone = [k.delete_batch(np.array([5, 5], np.uint64)) for k in (jk, pk)]
    assert np.array_equal(*gone) and gone[1].sum() == 1
    _assert_same_kvs(jk, pk)


def test_cached_store_populate_reserves_the_backing_table(monkeypatch):
    """Above one chunk, `CachedStore.populate` grows the backing table once
    for all its keys, to the size HostKVS would take for them up front,
    and answers every lookup and bloom word as JAX's one-batch load."""
    monkeypatch.setattr(hk, "POPULATE_CHUNK", 4096)
    r = np.random.default_rng(5)
    keys = r.permutation(np.arange(1, 60_001, dtype=np.uint64))
    vals = r.integers(0, 1 << 16, (len(keys), VW)).astype(np.uint32)
    j = jhk.CachedStore(16, val_words=VW, width=32)
    p = hk.CachedStore(16, val_words=VW, width=32, device="cpu")
    j.populate(keys, vals)
    p.populate(keys, vals)
    assert p.kvs.nb == hk.HostKVS(16, VW, capacity=len(keys)).nb \
        > hk.HostKVS(16, VW).nb
    assert p.kvs.n_live == j.kvs.n_live == len(keys)
    assert np.array_equal(p.kvs._bloom_cnt, j.kvs._bloom_cnt)
    probe = np.arange(1, 66_001, dtype=np.uint64)
    for w, g in zip(j.kvs.lookup(probe), p.kvs.lookup(probe)):
        assert np.array_equal(w, g)
    assert np.array_equal(np.asarray(j.cache.kv.bloom_hi),
                          to_numpy(p.cache.kv.bloom_hi))
    assert np.array_equal(np.asarray(j.cache.kv.bloom_lo),
                          to_numpy(p.cache.kv.bloom_lo))


# ------------------------------------------------------------- CachedStore


class Trio:
    """JAX's CachedStore, the port's and the oracle, from one populate;
    `serve` runs a round through all three and compares the replies."""

    def __init__(self, cache_buckets, policy, width, keys0, vals0,
                 hot_keys=0):
        self.j = jhk.CachedStore(cache_buckets, val_words=VW, policy=policy,
                                 width=width, hot_keys=hot_keys)
        # one compile a policy: JAX builds a fresh jit per instance
        self.j._step = _jstep(policy)
        self.j._refill = _jrefill
        self.p = hk.CachedStore(cache_buckets, val_words=VW, policy=policy,
                                width=width, hot_keys=hot_keys, device="cpu")
        self.o = StoreOracle()
        self.j.populate(keys0, vals0)
        self.p.populate(keys0, vals0)
        self.o.step(np.full(len(keys0), Op.INSERT, np.int32), keys0, vals0)

    def serve(self, ops, keys, vals=None, **kw):
        want = self.j.serve(ops, keys, vals, **kw)
        got = self.p.serve(ops, keys, vals, **kw)
        assert len(want) == len(got)
        for w, g in zip(want[:3], got[:3]):
            assert w.dtype == g.dtype and np.array_equal(w, g)
        if len(want) == 4:
            assert want[3] == got[3]
        if vals is not None:
            o = self.o.step(ops, keys, vals, **kw)
            assert np.array_equal(got[0], o[0]) and np.array_equal(got[2],
                                                                   o[2])
            isval = (o[0] == Reply.VAL) & (ops != Op.SCAN)
            assert np.array_equal(got[1][isval], o[1][isval])
            if len(o) == 4:
                assert got[3] == o[3]
        return got

    def check_end(self):
        assert dataclasses.asdict(self.j.stats) == \
            dataclasses.asdict(self.p.stats)
        _assert_same_cache(self.j.cache, self.p.cache)
        _assert_same_kvs(self.j.kvs, self.p.kvs)
        assert self.j._pending == self.p._pending


def _diff(policy, r, rounds=12, n=96, keyspace=60, cache_buckets=8,
          hot_keys=0):
    keys0 = np.arange(1, keyspace // 2, dtype=np.uint64)
    trio = Trio(cache_buckets, policy, 128, keys0,
                r.integers(1, 99, (len(keys0), VW)).astype(np.uint32),
                hot_keys=hot_keys)
    for _ in range(rounds):
        ops = r.choice([Op.GET, Op.GET, Op.GET, Op.SET, Op.SET, Op.INSERT,
                        Op.DELETE], size=n).astype(np.int32)
        trio.serve(ops, r.integers(1, keyspace, n).astype(np.uint64),
                   r.integers(1, 99, (n, VW)).astype(np.uint32))
    trio.check_end()
    return trio.p


@pytest.mark.parametrize("policy,hot_keys", [(sc.WB_BLOOM, 0),
                                             (sc.WB_NOBLOOM, 0), (sc.WT, 0),
                                             (sc.WB_BLOOM, 40)])
def test_cached_store_policy_matches_jax_and_oracle(policy, hot_keys):
    st = _diff(policy, np.random.default_rng(0), hot_keys=hot_keys).stats
    assert st.misses > 0 and st.hits > 0


def test_cached_store_evictions_flush_dirty():
    srv = _diff(sc.WB_BLOOM, np.random.default_rng(1), rounds=20,
                keyspace=120, cache_buckets=4)
    assert srv.stats.writebacks > 0


def test_cached_store_bloom_negatives():
    """WB_BLOOM answers absent keys' GETs on the device; WB_NOBLOOM pays a
    miss for each."""
    misses = {}
    for policy in (sc.WB_BLOOM, sc.WB_NOBLOOM):
        trio = Trio(8, policy, 64, np.array([1, 2], np.uint64),
                    np.ones((2, VW), np.uint32))
        rt = trio.serve(np.full(32, Op.GET, np.int32),
                        np.arange(100, 132, dtype=np.uint64))[0]
        assert (rt == Reply.NOT_EXIST).all()
        trio.check_end()
        misses[policy] = trio.p.stats.misses
    assert misses == {sc.WB_BLOOM: 0, sc.WB_NOBLOOM: 32}


def test_cached_store_write_through_invalidates():
    trio = Trio(8, sc.WT, 64, np.array([5], np.uint64),
                np.full((1, VW), 7, np.uint32))
    get = np.array([Op.GET], np.int32)
    key = np.array([5], np.uint64)
    trio.serve(get, key)
    m0 = trio.p.stats.misses
    trio.serve(get, key)
    assert trio.p.stats.misses == m0           # refilled: a hit
    trio.serve(np.array([Op.SET], np.int32), key,
               np.full((1, VW), 9, np.uint32))
    assert trio.p.stats.misses == m0 + 1       # invalidated and deferred
    rt, rv, rr = trio.serve(get, key)
    assert rt[0] == Reply.VAL and rv[0, 0] == 9 and rr[0] == 2
    assert trio.p.stats.misses == m0 + 1
    trio.check_end()


@pytest.mark.parametrize("policy", sc.POLICIES)
def test_cached_store_scan_mix_matches_jax_and_oracle(policy):
    """Scans resolve on the host after the dirty-record barrier."""
    r = np.random.default_rng(2)
    keys0 = np.arange(1, 30, dtype=np.uint64)
    trio = Trio(8, policy, 128, keys0,
                r.integers(1, 99, (len(keys0), VW)).astype(np.uint32))
    saw_barrier = False
    for _ in range(12):
        n = 96
        ops = r.choice([Op.GET, Op.GET, Op.SET, Op.SET, Op.INSERT,
                        Op.DELETE, Op.SCAN, Op.SCAN], n).astype(np.int32)
        lens = np.where(ops == Op.SCAN, r.integers(0, 7, n),
                        0).astype(np.uint32)
        saw_barrier |= bool(trio.p.cache.dirty.any()
                            and (ops == Op.SCAN).any())
        trio.serve(ops, r.integers(1, 60, n).astype(np.uint64),
                   r.integers(1, 99, (n, VW)).astype(np.uint32),
                   scan_lens=lens, scan_max=6)
    trio.check_end()
    assert saw_barrier == (policy != sc.WT)


def test_cached_store_late_refill_bloom_matches_jax():
    """The reference's fault (ROADMAP §C), which the port follows: under
    WB_BLOOM a key that a deferred SET created answers NOT_EXIST while its
    refill waits behind more than ``width`` pending ones. Both packages
    give the same replies and state; the oracle would say VAL."""
    from dint_tpu_torch.ops import hashing
    keys = np.arange(1, 200_000, dtype=np.uint64)
    b = hashing.bucket_np(keys, 1024)
    same, present = keys[b == 0][:16], keys[b > 2][:15]
    k = keys[b == 3][-1] + np.uint64(10 ** 7)
    assert hashing.bucket_np(np.array([k]), 1024)[0] != 0
    pop = np.r_[same, present]
    out = []
    for cls, kw in ((jhk.CachedStore, {}), (hk.CachedStore,
                                           {"device": "cpu"})):
        s = cls(1024, val_words=VW, width=16, **kw)
        s.populate(pop, np.ones((len(pop), VW), np.uint32))
        s.serve(np.full(16, Op.GET, np.int32), same)
        s.serve(np.r_[np.full(15, Op.GET), [Op.SET]].astype(np.int32),
                np.r_[present, [k]], np.full((16, VW), 5, np.uint32))
        out.append((s.serve(np.array([Op.GET], np.int32), np.array([k])),
                    int(k) in s._pending))
    (want, jpend), (got, ppend) = out
    assert all(np.array_equal(w, g) for w, g in zip(want, got))
    assert got[0][0] == Reply.NOT_EXIST and jpend and ppend
