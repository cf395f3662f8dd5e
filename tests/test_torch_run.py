"""The port's ordered run (dint_tpu_torch/tables/run.py) and its scan window
gather (dint_tpu_torch/ops/scan_kernels.py) against the JAX package on the
CPU.

Every run function goes through both packages on the same tables and
writes, made with numpy from a seed, and every leaf must be bit-identical.
`scan_rows_ref` is held against the Pallas `scan_rows` in interpret mode and
the XLA slab gather; the CUDA kernel itself is held against `scan_rows_ref`
on the card (tests/test_torch_cuda.py, chip_smoke.py). Tolerance: exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dint_tpu.ops import pallas_gather as pg
from dint_tpu.tables import kv as jkv
from dint_tpu.tables import run as jrun
from dint_tpu_torch import convert
from dint_tpu_torch.ops import scan_kernels as sk
from dint_tpu_torch.ops import u64
from dint_tpu_torch.ops.u32 import from_numpy, to_numpy
from dint_tpu_torch.tables import kv
from dint_tpu_torch.tables import run as run_mod

VW = 4
U32 = jnp.uint32


def _tables(seed, n_keys=200, nb=1 << 7, hi_keys=False):
    r = np.random.default_rng(seed)
    keys = r.choice(10_000, n_keys, replace=False).astype(np.uint64)
    if hi_keys:      # keys above 2^32 and near the top of the u64 range
        keys[::3] += np.uint64(1 << 32)
        keys[1::7] = np.uint64(2**64 - 2) - keys[1::7]
    vals = r.integers(0, 1 << 32, (n_keys, VW), dtype=np.uint64) \
        .astype(np.uint32)
    jt = jkv.populate(jkv.create(nb, slots=8, val_words=VW), keys, vals)
    pt = kv.populate(kv.create(nb, slots=8, val_words=VW, device="cpu"),
                     keys, vals)
    return keys, jt, pt


def _jax_run(jr) -> dict:
    return {**{k: np.asarray(getattr(jr, k)) for k in convert.RUN_LEAVES},
            "delta_cap": jr.delta_cap, "val_words": jr.val_words}


def _assert_same_run(jr, pr):
    want, got = _jax_run(jr), convert.ordered_run_to_numpy(pr)
    assert (want["delta_cap"], want["val_words"]) == \
        (got["delta_cap"], got["val_words"])
    for k in convert.RUN_LEAVES:
        assert np.array_equal(want[k], got[k]), k


def _writes(seed, keys, n, tomb_frac=0.3):
    """n distinct-key writes, half on existing keys, some tombstones, some
    masked out: (hi, lo, ver, val flat, tomb, mask) numpy."""
    r = np.random.default_rng(seed)
    wk = np.unique(np.concatenate([r.choice(keys, n // 2),
                                   r.integers(0, 12_000, n, dtype=np.uint64)]))
    wk = r.permutation(wk)[:n]
    hi, lo = u64.split(wk)
    ver = r.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    val = r.integers(0, 1 << 32, n * VW, dtype=np.uint64).astype(np.uint32)
    return hi, lo, ver, val, r.random(n) < tomb_frac, r.random(n) < 0.85


def _append_both(jr, pr, w):
    hi, lo, ver, val, tomb, mask = w
    jr = jrun.delta_append(jr, jnp.asarray(hi), jnp.asarray(lo),
                           jnp.asarray(ver), jnp.asarray(val),
                           jnp.asarray(tomb), jnp.asarray(mask))
    t = [from_numpy(a, "cpu") for a in (hi, lo, ver, val)]
    pr = run_mod.delta_append(pr, *t, torch.from_numpy(tomb),
                              torch.from_numpy(mask))
    return jr, pr


@pytest.mark.parametrize("hi_keys", [False, True])
def test_from_table_and_create_match_jax(hi_keys):
    keys, jt, pt = _tables(0, hi_keys=hi_keys)
    jr, pr = jrun.from_table(jt, delta_cap=16), run_mod.from_table(pt, 16)
    _assert_same_run(jr, pr)
    assert int(pr.n) == len(keys) and pr.cap == jr.cap
    assert run_mod.to_items(pr) == jrun.to_items(jr) == kv.to_dict(pt)
    _assert_same_run(jrun.create(50, 8, VW), run_mod.create(50, 8, VW, device="cpu"))


@pytest.mark.parametrize("hi_keys", [False, True])
def test_delta_append_rebuild_and_refresh_match_jax(hi_keys):
    """Three batches of writes through the overlay (latest wins across
    batches, tombstones, masked lanes), then both refresh branches."""
    keys, jt, pt = _tables(1, hi_keys=hi_keys)
    jr, pr = jrun.from_table(jt, delta_cap=40), run_mod.from_table(pt, 40)
    for i in range(3):
        w = _writes(10 + i, keys, 12)
        if i == 2:          # the same keys again: the latest write wins
            w = _writes(10, keys, 12, tomb_frac=0.6)
        jr, pr = _append_both(jr, pr, w)
        _assert_same_run(jr, pr)
    assert 0 < int(pr.d_n) <= 40 and not bool(pr.stale)
    assert bool(pr.d_tomb.any())
    assert run_mod.to_items(pr) == jrun.to_items(jr)
    _assert_same_run(jrun.rebuild_run(jr), run_mod.rebuild_run(pr))
    _assert_same_run(jrun.refresh(jt, jr), run_mod.refresh(pt, pr))
    assert run_mod.to_items(run_mod.rebuild_run(pr)) == jrun.to_items(jr)


def test_overflow_goes_stale_and_refresh_resnapshots():
    keys, jt, pt = _tables(2)
    jr, pr = jrun.from_table(jt, delta_cap=4), run_mod.from_table(pt, 4)
    w = _writes(3, keys, 10, tomb_frac=0.0)
    jr, pr = _append_both(jr, pr, w)
    _assert_same_run(jr, pr)
    assert bool(pr.stale) and int(pr.d_n) == 4
    jr, pr = _append_both(jr, pr, _writes(4, keys, 3))     # stays stale
    _assert_same_run(jr, pr)
    fresh_j, fresh_p = jrun.refresh(jt, jr), run_mod.refresh(pt, pr)
    _assert_same_run(fresh_j, fresh_p)
    _assert_same_run(jrun.from_table(jt, 4), fresh_p)
    assert not bool(fresh_p.stale)


@pytest.mark.parametrize("hi_keys", [False, True])
def test_locate_matches_jax_lower_bound(hi_keys):
    keys, jt, pt = _tables(5, hi_keys=hi_keys)
    jr, pr = jrun.from_table(jt, 8), run_mod.from_table(pt, 8)
    r = np.random.default_rng(5)
    q = np.concatenate([r.choice(keys, 50), r.integers(0, 2**64 - 1, 50,
                                                       dtype=np.uint64),
                        np.array([0, 2**64 - 1, keys.min(), keys.max()],
                                 np.uint64)])
    hi, lo = u64.split(q)
    got = run_mod.locate(pr, from_numpy(hi, "cpu"), from_numpy(lo, "cpu"))
    assert np.array_equal(got.numpy(), np.asarray(
        jrun.locate(jr, jnp.asarray(hi), jnp.asarray(lo))))
    srt = np.sort(keys)
    assert np.array_equal(got.numpy(), np.searchsorted(srt, q, side="left"))
    assert run_mod.locate_bits(pr.cap) == jrun.locate_bits(jr.cap)


@pytest.mark.parametrize("hi_keys", [False, True])
def test_merge_scan_matches_jax(hi_keys):
    """locate -> clamped window -> merge_scan over a run with a live
    overlay (upserts, tombstones, new keys), lanes of every length."""
    scan_max, dcap = 6, 8
    keys, jt, pt = _tables(6, n_keys=60, nb=1 << 4, hi_keys=hi_keys)
    jr, pr = jrun.from_table(jt, dcap), run_mod.from_table(pt, dcap)
    jr, pr = _append_both(jr, pr, _writes(7, keys, 6))
    _assert_same_run(jr, pr)
    r = np.random.default_rng(6)
    n = 24
    starts = np.concatenate([r.choice(keys, n - 4),
                             np.array([0, 2**64 - 1, keys.max(), 5000],
                                      np.uint64)])
    slen = r.integers(0, scan_max + 3, n).astype(np.int32)
    lg = scan_max + dcap
    hi, lo = u64.split(starts)
    jhi, jlo = jnp.asarray(hi), jnp.asarray(lo)
    thi, tlo = from_numpy(hi, "cpu"), from_numpy(lo, "cpu")
    joff = jnp.clip(jrun.locate(jr, jhi, jlo), 0, jr.cap - lg)
    toff = torch.clamp(run_mod.locate(pr, thi, tlo), 0, pr.cap - lg)
    jslab = pg.scan_slab(jr.key_hi, jr.key_lo, jr.ver, jr.val, joff, lg, VW)
    tslab = sk.scan_slab(pr.key_hi, pr.key_lo, pr.ver, pr.val, toff, lg, VW)
    for a, b in zip(jslab, tslab):
        assert np.array_equal(np.asarray(a), to_numpy(b))
    want = jrun.merge_scan(jr, *jslab, joff, jhi, jlo,
                           jnp.asarray(np.minimum(slen, scan_max)), scan_max)
    got = run_mod.merge_scan(pr, *tslab, toff, thi, tlo,
                             torch.from_numpy(np.minimum(slen, scan_max)),
                             scan_max)
    for i, (a, b) in enumerate(zip(want, got)):
        assert np.array_equal(np.asarray(a), to_numpy(b).view(
            np.asarray(a).dtype)), i
    assert int(got[5].sum()) > 0 and int(got[0].sum()) > 0
    items = run_mod.to_items(pr)
    for i in range(n):          # the merged view's first keys >= start
        rows = sorted(k for k in items if k >= int(starts[i]))
        c = int(got[0][i])
        assert c == min(int(min(slen[i], scan_max)), len(rows))
        ks = u64.join(to_numpy(got[1][i]), to_numpy(got[2][i]))[:c]
        assert [int(k) for k in ks] == rows[:c]


def test_ge_matches_jax():
    r = np.random.default_rng(8)
    a = r.integers(0, 2**64 - 1, (5, 7), dtype=np.uint64)
    q = np.concatenate([a[:3, 2], np.array([0, 2**64 - 1], np.uint64)])
    (ah, al), (qh, ql) = u64.split(a), u64.split(q)
    got = run_mod._ge(from_numpy(ah, "cpu"), from_numpy(al, "cpu"),
                      from_numpy(qh, "cpu"), from_numpy(ql, "cpu"))
    want = jrun._ge(jnp.asarray(ah), jnp.asarray(al), jnp.asarray(qh),
                    jnp.asarray(ql))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy(), a >= q[:, None])


# ------------------------------------------------------------ scan window


@pytest.mark.parametrize("cap,lg,vw,k", [(300, 12, 4, 40), (64, 64, 10, 5),
                                         (1000, 1, 1, 33)])
def test_scan_rows_ref_matches_pallas_and_xla(cap, lg, vw, k):
    r = np.random.default_rng(cap + lg)
    arrs = [r.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
            for n in (cap, cap, cap, cap * vw)]
    off = r.integers(0, cap - lg + 1, k).astype(np.int32)
    off[0], off[-1] = 0, cap - lg                  # edge windows
    off[1::4] = off[2]                             # duplicate offsets
    jarr = [jnp.asarray(a) for a in arrs]
    joff = jnp.asarray(off)
    want_p = pg.scan_rows(*jarr, joff, jnp.argsort(joff), lg, vw, True)
    want_x = pg._xla_scan_slab(*jarr, joff, lg, vw)
    tarr = [from_numpy(a, "cpu") for a in arrs]
    toff = torch.from_numpy(off)
    got = sk.scan_rows_ref(*tarr, toff, lg, vw)
    before = sk.scan_rows.launches
    via_wrapper = sk.scan_rows(*tarr, toff, lg, vw)
    assert sk.scan_rows.launches == before          # CPU: no kernel launch
    for g, p, x, v in zip(got, want_p, want_x, via_wrapper):
        assert np.array_equal(to_numpy(g), np.asarray(p))
        assert np.array_equal(to_numpy(g), np.asarray(x).reshape(-1))
        assert torch.equal(g, v)


def test_scan_rows_refuses_bad_windows():
    z = torch.zeros(20, dtype=torch.int32)
    with pytest.raises(IndexError):
        sk.scan_rows(z, z, z, z, torch.tensor([0, 16], dtype=torch.int32), 5,
                     1)
    with pytest.raises(IndexError):
        sk.scan_rows(z, z, z, z, torch.tensor([-1], dtype=torch.int32), 5, 1)
    with pytest.raises(ValueError, match="disagree"):
        sk.scan_rows(z, z, z, z, torch.tensor([0], dtype=torch.int32), 5, 2)
    with pytest.raises(TypeError):
        sk.scan_rows(z, z, z, z, torch.tensor([0]), 5, 1)
