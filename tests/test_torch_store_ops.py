"""The store engine's building blocks in the port (dint_tpu_torch/ops/u64,
ops/hashing, ops/segments, tables/kv) against the JAX package on the CPU.

The same inputs, made with numpy from a seed, go through both; every
comparison is bit-exact (all data is integer)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dint_tpu.clients import micro as jmicro
from dint_tpu.ops import hashing as jh
from dint_tpu.ops import segments as jseg
from dint_tpu.ops import u64 as ju64
from dint_tpu.tables import kv as jkv
from dint_tpu_torch import convert
from dint_tpu_torch.clients import micro
from dint_tpu_torch.ops import hashing, segments, u64
from dint_tpu_torch.ops.u32 import from_numpy, to_numpy
from dint_tpu_torch.tables import kv

VW = 4
EDGE_KEYS = np.array([0, 1, 2**32 - 1, 2**32, 2**63, 2**64 - 2, 2**64 - 1],
                     np.uint64)


def _t(a):
    return from_numpy(np.asarray(a), "cpu")


def _keys(seed, n=500):
    r = np.random.default_rng(seed)
    return np.concatenate([r.integers(0, 1 << 64, n, dtype=np.uint64),
                           EDGE_KEYS])


def _assert_pair(got, want):
    for g, w in zip(got, want):
        assert np.array_equal(to_numpy(g), np.asarray(w))


# -------------------------------------------------------------------- u64


@pytest.mark.parametrize("op", ["add", "xor", "mul", "mul32x32", "lt"])
def test_u64_binary_ops_match_jax_and_numpy(op):
    r = np.random.default_rng(1)
    a, b = _keys(2), r.permutation(_keys(3))
    (ah, al), (bh, bl) = u64.split(a), u64.split(b)
    if op == "mul32x32":
        got = u64.mul32x32(_t(al), _t(bl))
        want = ju64.mul32x32(jnp.asarray(al), jnp.asarray(bl))
        _assert_pair(got, want)
        prod = al.astype(object) * bl.astype(object)
        assert [int(x) for x in u64.join(*map(to_numpy, got))] == list(prod)
        return
    args_t = (_t(ah), _t(al), _t(bh), _t(bl))
    args_j = tuple(map(jnp.asarray, (ah, al, bh, bl)))
    got, want = getattr(u64, op)(*args_t), getattr(ju64, op)(*args_j)
    if op == "lt":
        assert np.array_equal(got.numpy(), np.asarray(want))
        assert np.array_equal(got.numpy(), a < b)
        return
    _assert_pair(got, want)
    with np.errstate(over="ignore"):
        ref = {"add": a + b, "xor": a ^ b, "mul": a * b}[op]
    assert np.array_equal(u64.join(*map(to_numpy, got)), ref)


@pytest.mark.parametrize("n", [1, 23, 31, 32, 33, 47, 63])
def test_u64_shifts_and_const_match_jax(n):
    a = _keys(n)
    hi, lo = u64.split(a)
    for name, ref in (("shr", a >> np.uint64(n)), ("shl", a << np.uint64(n))):
        got = getattr(u64, name)(_t(hi), _t(lo), n)
        _assert_pair(got, getattr(ju64, name)(jnp.asarray(hi),
                                              jnp.asarray(lo), n))
        assert np.array_equal(u64.join(*map(to_numpy, got)), ref)
    c = 0x2127599BF4325C37
    assert [x & 0xFFFFFFFF for x in u64.const(c)] == \
        [int(x) for x in ju64.const(c)]


def test_sort_key_orders_unsigned():
    a = _keys(4)
    key = u64.sort_key(*map(_t, u64.split(a)))
    assert np.array_equal(np.argsort(key.numpy(), kind="stable"),
                          np.argsort(a, kind="stable"))
    assert int(key[np.flatnonzero(a == 2**64 - 1)[0]]) == \
        torch.iinfo(torch.int64).max


# ---------------------------------------------------------------- hashing


def test_hash64_matches_host_and_jax():
    keys = _keys(5, 2000)
    hi, lo = u64.split(keys)
    got = hashing.hash64(_t(hi), _t(lo))
    _assert_pair(got, jh.hash64(jnp.asarray(hi), jnp.asarray(lo)))
    assert np.array_equal(u64.join(*map(to_numpy, got)), jh.hash64_np(keys))
    assert np.array_equal(hashing.hash64_np(keys), jh.hash64_np(keys))


@pytest.mark.parametrize("nb", [1, 2, 1 << 10, 1 << 26])
def test_bucket_and_bloom_maps_match_jax(nb):
    keys = _keys(6)
    hi, lo = u64.split(keys)
    th, tl, jhi, jlo = _t(hi), _t(lo), jnp.asarray(hi), jnp.asarray(lo)
    _assert_pair(hashing.bucket_pair(th, tl, nb),
                 jh.bucket_pair(jhi, jlo, nb))
    for a, b in zip(hashing.bucket_pair_np(keys, nb),
                    jh.bucket_pair_np(keys, nb)):
        assert np.array_equal(a, b)
    assert np.array_equal(hashing.bucket(th, tl, nb).numpy(),
                          np.asarray(jh.bucket(jhi, jlo, nb)))
    assert np.array_equal(hashing.bucket_np(keys, nb), jh.bucket_np(keys, nb))
    assert np.array_equal(hashing.bloom_bit(th, tl).numpy(),
                          np.asarray(jh.bloom_bit(jhi, jlo)))
    assert np.array_equal(hashing.bloom_bit_np(keys), jh.bloom_bit_np(keys))


# --------------------------------------------------------------- segments


def test_segments_match_jax_on_duplicate_keys():
    r = np.random.default_rng(7)
    n = 300
    keys = r.choice(np.concatenate([r.integers(0, 1 << 64, 20,
                                               dtype=np.uint64),
                                    EDGE_KEYS]), n)
    hi, lo = u64.split(keys)
    x = r.integers(-50, 50, n).astype(np.int32)
    pred = r.random(n) < 0.4
    sb = segments.sort_batch(_t(hi), _t(lo))
    jsb = jseg.sort_batch(jnp.asarray(hi), jnp.asarray(lo))
    for f in ("key_hi", "key_lo", "perm", "head", "last", "head_pos",
              "seg_id", "rank"):
        got = getattr(sb, f)
        got = to_numpy(got) if got.dtype == torch.int32 else got.numpy()
        assert np.array_equal(got.astype(np.int64) if f in ("perm", "seg_id")
                              else got, np.asarray(getattr(jsb, f))), f
    xt, pt = torch.from_numpy(x), torch.from_numpy(pred)
    xs, ps = xt[sb.perm], pt[sb.perm]
    jxs, jps = jnp.asarray(x)[jsb.perm], jnp.asarray(pred)[jsb.perm]
    pairs = [
        (segments.at_head(sb, xs), jseg.at_head(jsb, jxs)),
        (segments.seg_sum(sb, xs), jseg.seg_sum(jsb, jxs)),
        (segments.seg_cumsum_excl(sb, xs), jseg.seg_cumsum_excl(jsb, jxs)),
        (segments.seg_min_where(sb, ps, xs, 99),
         jseg.seg_min_where(jsb, jps, jxs, jnp.int32(99))),
        (segments.seg_max_where(sb, ps, sb.rank, -1),
         jseg.seg_max_where(jsb, jps, jsb.rank, jnp.int32(-1))),
        (segments.seg_any(sb, ps), jseg.seg_any(jsb, jps)),
        (segments.unsort(sb, xs), jseg.unsort(jsb, jxs)),
    ]
    for i, (g, w) in enumerate(pairs):
        assert np.array_equal(g.numpy(), np.asarray(w)), i
    assert bool(segments.seg_any(sb, ps).any())
    tab = r.integers(0, 1000, 40).astype(np.int32)
    rows = r.permutation(40)[:25].astype(np.int32)
    vals, mask = r.integers(0, 1000, 25).astype(np.int32), r.random(25) < 0.5
    got = segments.scatter_rows(torch.from_numpy(tab.copy()),
                                torch.from_numpy(rows), torch.from_numpy(vals),
                                torch.from_numpy(mask))
    want = jseg.scatter_rows(jnp.asarray(tab), jnp.asarray(rows),
                             jnp.asarray(vals), jnp.asarray(mask))
    assert np.array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------- kv


def _populated(seed, n_keys=400, nb=1 << 7, slots=4):
    r = np.random.default_rng(seed)
    keys = r.choice(1 << 40, n_keys, replace=False).astype(np.uint64)
    vals = r.integers(0, 1 << 32, (n_keys, VW), dtype=np.uint64) \
        .astype(np.uint32)
    vers = r.integers(1, 1 << 32, n_keys, dtype=np.uint64).astype(np.uint32)
    jt = jkv.populate(jkv.create(nb, slots=slots, val_words=VW), keys, vals,
                      vers)
    pt = kv.populate(kv.create(nb, slots=slots, val_words=VW, device="cpu"),
                     keys, vals, vers)
    return keys, jt, pt


def _jax_table(jt) -> dict:
    return {**{k: np.asarray(getattr(jt, k)) for k in convert.KV_LEAVES},
            "slots": jt.slots, "val_words": jt.val_words}


def _assert_same_table(jt, pt):
    want, got = _jax_table(jt), convert.kv_table_to_numpy(pt)
    for k in convert.KV_LEAVES:
        assert np.array_equal(want[k], got[k]), k


@pytest.mark.parametrize("seed,n_keys,nb", [(0, 400, 1 << 7),
                                            (1, 450, 1 << 7),   # load 0.88
                                            (2, 3000, 1 << 11)])
def test_populate_bit_identical_to_jax(seed, n_keys, nb):
    keys, jt, pt = _populated(seed, n_keys, nb)
    _assert_same_table(jt, pt)
    assert kv.to_dict(pt) == jkv.to_dict(jt)
    assert len(kv.to_dict(pt)) == n_keys
    back = convert.kv_table_from_numpy(convert.kv_table_to_numpy(pt), "cpu")
    _assert_same_table(jt, back)


def test_placement_ranks_match_numpy_lexsort():
    r = np.random.default_rng(3)
    bkt = r.integers(0, 50, 2000)
    prio = r.random(2000)
    prio[::7] = prio[0]                      # ties: lexsort's stable order
    cpu = torch.device("cpu")
    assert np.array_equal(kv._within_bucket_rank(bkt, prio, cpu),
                          jkv._within_bucket_rank(bkt, prio))
    assert np.array_equal(kv._within_bucket_rank(bkt, None, cpu),
                          jkv._within_bucket_rank(bkt))
    keys = r.choice(1 << 40, 800, replace=False).astype(np.uint64)
    for a, b in zip(kv.assign_two_choice(keys, 256, 4, device="cpu"),
                    jkv.assign_two_choice(keys, 256, 4)):   # load 0.78
        assert np.array_equal(a, b)


def test_make_store_table_matches_jax():
    pt = micro.make_store_table(3000, val_words=VW, device="cpu")
    jt = jmicro.make_store_table(3000, val_words=VW)
    assert pt.n_buckets == jt.n_buckets == 2048
    _assert_same_table(jt, pt)
    assert micro.STORE_MAGIC == jmicro.STORE_MAGIC


def test_populate_rejects_duplicates():
    with pytest.raises(ValueError, match="duplicate"):
        kv.populate(kv.create(16, val_words=VW, device="cpu"),
                    np.array([5, 5], np.uint64), np.zeros((2, VW), np.uint32))


def test_probe_and_bloom_match_jax():
    keys, jt, pt = _populated(4)
    r = np.random.default_rng(4)
    q = np.concatenate([r.choice(keys, 200), r.integers(0, 1 << 40, 100,
                                                         dtype=np.uint64),
                        EDGE_KEYS])
    hi, lo = u64.split(q)
    th, tl, jhi, jlo = _t(hi), _t(lo), jnp.asarray(hi), jnp.asarray(lo)
    b1, b2 = hashing.bucket_pair(th, tl, pt.n_buckets)
    jb1, jb2 = jh.bucket_pair(jhi, jlo, jt.n_buckets)
    got = kv.probe(pt, th, tl, b1, b2)
    want = jkv.probe(jt, jhi, jlo, jb1, jb2)
    for g, w in zip(got, want):
        assert np.array_equal(to_numpy(g).view(np.asarray(w).dtype)
                              if g.dtype == torch.int32 else g.numpy(),
                              np.asarray(w))
    assert bool(got[0][:200].all()) and not bool(got[0][200:300].any())
    for g, w in zip(kv.probe_loc(pt, th, tl, b1, b2),
                    jkv.probe_loc(jt, jhi, jlo, jb1, jb2)):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert np.array_equal(kv.bloom_maybe(pt, th, tl, b1, b2).numpy(),
                          np.asarray(jkv.bloom_maybe(jt, jhi, jlo, jb1, jb2)))
    rows = np.arange(12, dtype=np.int32)
    assert np.array_equal(kv.val_word_idx(pt, torch.from_numpy(rows)).numpy(),
                          np.asarray(jkv.val_word_idx(jt, jnp.asarray(rows))))
    assert np.array_equal(to_numpy(kv.entry_val(pt, torch.from_numpy(rows))),
                          np.asarray(jkv.entry_val(jt, jnp.asarray(rows))))


def test_nth_free_slot_matches_jax_with_several_matches():
    r = np.random.default_rng(5)
    valid = r.random((200, 8)) < 0.5
    valid[0] = True                              # no free slot at all
    valid[1] = False                             # every slot free
    rank = r.integers(0, 6, 200).astype(np.int32)
    got = kv.nth_free_slot(torch.from_numpy(valid), torch.from_numpy(rank))
    want = jkv.nth_free_slot(jnp.asarray(valid), jnp.asarray(rank))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert not bool(got[0][0]) and int(got[1][0]) == 0
    assert bool(got[0][1]) and int(got[1][1]) == rank[1]


def test_recompute_bloom_matches_jax_after_deletes():
    keys, jt, pt = _populated(6)
    r = np.random.default_rng(6)
    gone = r.choice(len(keys), 150, replace=False)
    e = np.flatnonzero(np.isin(u64.join(np.asarray(jt.key_hi),
                                        np.asarray(jt.key_lo)), keys[gone])
                       & np.asarray(jt.valid))
    jt = jt.replace(valid=jt.valid.at[e].set(False))
    pt.valid[torch.from_numpy(e)] = False
    bkt = np.unique(e // jt.slots).astype(np.int32)
    mask = r.random(len(bkt)) < 0.8
    jt = jkv.recompute_bloom(jt, jnp.asarray(bkt), jnp.asarray(mask))
    kv.recompute_bloom(pt, torch.from_numpy(bkt), torch.from_numpy(mask))
    _assert_same_table(jt, pt)
