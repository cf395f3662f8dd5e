"""The port's store engine (dint_tpu_torch/engines/store.py) against
`dint_tpu.engines.store` on the CPU.

`step` runs the cases of tests/test_store.py through both packages on the
same tables and batches: every reply, scan reply, table leaf, run leaf and
mirror must be bit-identical. The hot route must also equal the plain
route. The serve runner runs next to JAX's `build_serve_runner` on JAX's
replayed draws, with the scan path off and on, at occupancy below the
width, with the counters on; the counters must equal JAX's snapshot except
``dispatch_xla``/``dispatch_pallas``, which differ by design (JAX's XLA
route against the port's kernel route). Tolerance: exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dint_tpu.clients import micro as jmicro
from dint_tpu.engines import store as jst
from dint_tpu.engines.types import make_batch as jmake_batch
from dint_tpu.monitor import counters as jmon
from dint_tpu.ops import hashing as jh
from dint_tpu.tables import kv as jkv
from dint_tpu.tables import run as jrun
from dint_tpu_torch import convert
from dint_tpu_torch.clients import micro
from dint_tpu_torch.engines import store, store_cache
from dint_tpu_torch.engines.types import Op, Reply, make_batch
from dint_tpu_torch.monitor import counters as mon
from dint_tpu_torch.ops import scan_kernels as sk
from dint_tpu_torch.ops.u32 import to_numpy
from dint_tpu_torch.shim.host_kvs import CachedStore
from dint_tpu_torch.tables import kv
from dint_tpu_torch.tables import run as run_mod

from test_torch_run import _assert_same_run
from test_torch_store_ops import _assert_same_table

VW = 4
_jstep = jax.jit(jst.step, static_argnames=("maintain_bloom", "use_pallas",
                                            "scan_max"))


def _vals(r, n):
    return r.integers(0, 1 << 32, (n, VW), dtype=np.uint64).astype(np.uint32)


def _same(a, b, what):
    a = np.asarray(a)
    assert np.array_equal(a, to_numpy(b).view(a.dtype)
                          if b.dtype == torch.int32 else b.numpy()), what


class Pair:
    """A JAX table and the port's, from the same populate; `step` runs one
    batch through both and checks every output."""

    def __init__(self, nb, slots, keys=None, vals=None, dcap=None,
                 hot_n=None):
        self.jt = jkv.create(nb, slots=slots, val_words=VW)
        self.pt = kv.create(nb, slots=slots, val_words=VW, device="cpu")
        if keys is not None:
            self.jt = jkv.populate(self.jt, keys, vals)
            self.pt = kv.populate(self.pt, keys, vals)
        self.jr = self.pr = self.jh = self.ph = None
        if dcap is not None:
            self.jr = jrun.from_table(self.jt, delta_cap=dcap)
            self.pr = run_mod.from_table(self.pt, delta_cap=dcap)
        if hot_n is not None:
            self.jh = jst.attach_hot(self.jt, hot_n)
            self.ph = store.attach_hot(self.pt, hot_n)

    def step(self, ops, keys, vals, lens=None, scan_max=8, bloom=False):
        n = len(ops)
        kw = dict(vals=vals, vers=lens, width=n, val_words=VW)
        jb = jmake_batch(ops, keys, **kw)
        pb = make_batch(ops, keys, device="cpu", **kw)
        jout = _jstep(self.jt, jb, maintain_bloom=bloom, hot=self.jh,
                      run=self.jr, scan_max=scan_max)
        pout = store.step(self.pt, pb, maintain_bloom=bloom, hot=self.ph,
                          run=self.pr, scan_max=scan_max)
        assert len(jout) == len(pout)
        (self.jt, jrep), (self.pt, prep) = jout[:2], pout[:2]
        for f in ("rtype", "val", "ver"):
            _same(getattr(jrep, f), getattr(prep, f), f)
        _assert_same_table(self.jt, self.pt)
        rest_j, rest_p = list(jout[2:]), list(pout[2:])
        if self.jh is not None:
            self.jh, self.ph = rest_j.pop(0), rest_p.pop(0)
            _same(self.jh.val, self.ph.val, "hot val")
            _same(self.jh.ver, self.ph.ver, "hot ver")
        srep = None
        if self.jr is not None:
            (self.jr, jsrep), (self.pr, srep) = rest_j, rest_p
            _assert_same_run(self.jr, self.pr)
            for f in ("key_hi", "key_lo", "ver", "val", "count",
                      "delta_hits"):
                _same(getattr(jsrep, f), getattr(srep, f), f)
        return prep.rtype.numpy(), prep.ver.numpy(), srep

    def rebuild(self):
        self.jr = jst.rebuild_run(self.jt, self.jr)
        self.pr = store.rebuild_run(self.pt, self.pr)
        _assert_same_run(self.jr, self.pr)


def _scan_keys(srep, lane):
    c = int(srep.count[lane])
    return [int(x) for x in to_numpy(srep.key_lo[lane])[:c]]


# ------------------------------------------------------------- point ops


def test_get_set_conflicts_and_insert_after_delete():
    r = np.random.default_rng(0)
    p = Pair(1 << 10, 4)
    rt, rver, _ = p.step([Op.SET, Op.SET, Op.GET], [7, 9, 7], _vals(r, 3))
    assert list(rt) == [Reply.ACK, Reply.ACK, Reply.NOT_EXIST]
    rt, _, _ = p.step([Op.GET] * 3, [7, 9, 1234], _vals(r, 3))
    assert list(rt) == [Reply.VAL, Reply.VAL, Reply.NOT_EXIST]
    rt, rver, _ = p.step([Op.SET] * 4, [42] * 4, _vals(r, 4))
    assert list(rver) == [1, 2, 3, 4]
    p.step([Op.DELETE, Op.INSERT, Op.GET], [7, 7, 7], _vals(r, 3))
    assert 7 in kv.to_dict(p.pt)


def test_delete_and_bloom_maintained():
    r = np.random.default_rng(1)
    keys = np.arange(200, dtype=np.uint64)
    p = Pair(1 << 6, 8, keys, _vals(r, 200))
    rt, _, _ = p.step([Op.DELETE] * 100, keys[:100], _vals(r, 100),
                      bloom=True)
    assert (rt == Reply.ACK).all()
    rt, _, _ = p.step([Op.DELETE, Op.DELETE, Op.INSERT, Op.SET],
                      [160, 160, 5, 300], _vals(r, 4), bloom=True)
    assert list(rt[:2]) == [Reply.ACK, Reply.NOT_EXIST]


def test_spill_and_alternate_bucket():
    r = np.random.default_rng(2)
    p = Pair(1, 2)
    rt, _, _ = p.step([Op.INSERT] * 3, [1, 2, 3], _vals(r, 3))
    assert sorted(rt) == sorted([Reply.ACK, Reply.ACK, Reply.SPILL])
    rt, rver, _ = p.step([Op.SET, Op.SET, Op.INSERT, Op.DELETE, Op.GET],
                         [9, 9, 8, 8, 9], _vals(r, 5))
    assert list(rt) == [Reply.SPILL, Reply.SPILL, Reply.ACK, Reply.ACK,
                        Reply.NOT_EXIST]
    ks = np.arange(1, 4000, dtype=np.uint64)
    b1, b2 = jh.bucket_pair_np(ks, 2)
    cands = ks[(b1 == 0) & (b2 == 1)]
    p = Pair(2, 1)
    rt, _, _ = p.step([Op.INSERT, Op.INSERT], cands[:2], _vals(r, 2))
    assert list(rt) == [Reply.ACK, Reply.ACK]    # the loser took its alt
    rt, _, _ = p.step([Op.INSERT], cands[2:3], _vals(r, 1))
    assert list(rt) == [Reply.SPILL]


@pytest.mark.parametrize("hot_n", [None, 24])
def test_random_batches_match_jax(hot_n):
    """Mixed batches over a small keyspace (heavy same-key chains), the
    hot route threading a mirror of keys [0, 24)."""
    r = np.random.default_rng(3)
    keys = r.choice(60, 30, replace=False).astype(np.uint64)
    p = Pair(1 << 4, 4, keys, _vals(r, 30), hot_n=hot_n)
    for _ in range(6):
        n = 48
        ops = r.choice([Op.GET, Op.SET, Op.INSERT, Op.DELETE, Op.NOP], n,
                       p=[0.35, 0.25, 0.1, 0.2, 0.1]).astype(np.int32)
        p.step(ops, r.integers(0, 60, n).astype(np.uint64), _vals(r, n),
               bloom=True)


def test_hot_route_equals_plain_route():
    r = np.random.default_rng(4)
    keys = r.choice(80, 50, replace=False).astype(np.uint64)
    vals = _vals(r, 50)
    plain = kv.populate(kv.create(1 << 5, 4, VW, device="cpu"), keys, vals)
    hot_t = kv.populate(kv.create(1 << 5, 4, VW, device="cpu"), keys, vals)
    hot = store.attach_hot(hot_t, 32)
    assert hot.val.untyped_storage().data_ptr() != \
        hot_t.val.untyped_storage().data_ptr()
    for _ in range(5):
        n = 40
        ops = r.choice([Op.GET, Op.SET, Op.INSERT, Op.DELETE], n).astype(
            np.int32)
        ks = r.integers(0, 80, n).astype(np.uint64)
        b = make_batch(ops, ks, _vals(r, n), width=n, val_words=VW,
                       device="cpu")
        plain, rep_a = store.step(plain, b)
        hot_t, rep_b, hot = store.step(hot_t, b, hot=hot)
        for f in ("rtype", "val", "ver"):
            assert torch.equal(getattr(rep_a, f), getattr(rep_b, f))
    for a, b in zip(convert.kv_table_to_numpy(plain).values(),
                    convert.kv_table_to_numpy(hot_t).values()):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    # mirror == table for every present key (absent keys' rows are stale
    # by design)
    fresh = store.attach_hot(hot_t, 32)
    live = torch.tensor(sorted(k for k in kv.to_dict(hot_t) if k < 32))
    assert len(live) > 0
    assert torch.equal(fresh.val.view(32, VW)[live], hot.val.view(32, VW)[live])
    assert torch.equal(fresh.ver[live], hot.ver[live])


# ------------------------------------------------------------------ scans


def test_scan_sees_pre_batch_state_then_the_overlay():
    r = np.random.default_rng(5)
    p = Pair(1 << 6, 8, np.array([10, 20, 30], np.uint64), _vals(r, 3),
             dcap=8)
    rt, rver, srep = p.step([Op.SET, Op.SCAN], [15, 10], _vals(r, 2), [0, 3])
    assert rt[1] == Reply.VAL and rver[1] == 3
    assert _scan_keys(srep, 1) == [10, 20, 30]
    _, _, srep = p.step([Op.SCAN], [10], _vals(r, 1), [4])
    assert _scan_keys(srep, 0) == [10, 15, 20, 30]
    assert int(srep.delta_hits[0]) == 1
    p.rebuild()
    _, _, srep = p.step([Op.SCAN], [10], _vals(r, 1), [4])
    assert _scan_keys(srep, 0) == [10, 15, 20, 30]
    assert int(srep.delta_hits[0]) == 0


def test_scan_mixed_batches_match_jax():
    r = np.random.default_rng(6)
    p = Pair(1 << 6, 8, dcap=8)
    for it in range(8):
        n = 24
        ops = r.choice([Op.GET, Op.SET, Op.INSERT, Op.DELETE, Op.SCAN,
                        Op.NOP], n, p=[0.2, 0.2, 0.05, 0.15, 0.3, 0.1]) \
            .astype(np.int32)
        lens = np.where(ops == Op.SCAN, r.integers(0, 10, n), 0)
        p.step(ops, r.integers(0, 40, n).astype(np.uint64), _vals(r, n),
               lens)
        if it % 2:
            p.rebuild()


def test_spilled_insert_never_scanned():
    r = np.random.default_rng(7)
    ks = np.arange(1, 4000, dtype=np.uint64)
    b1, b2 = jh.bucket_pair_np(ks, 4)
    k1, k2, k3 = ks[(b1 == 0) & (b2 == 1)][:3]
    p = Pair(4, 1, dcap=2)
    rt, _, srep = p.step([Op.INSERT] * 3 + [Op.SCAN], [k1, k2, k3, 0],
                         _vals(r, 4), [0, 0, 0, 2], scan_max=2)
    assert list(rt[:3]) == [Reply.ACK, Reply.ACK, Reply.SPILL]
    assert _scan_keys(srep, 3) == []
    _, _, srep = p.step([Op.SCAN], [0], _vals(r, 1), [2], scan_max=2)
    assert _scan_keys(srep, 0) == sorted(int(k) for k in (k1, k2))


def test_stale_overlay_retries_until_rebuild():
    r = np.random.default_rng(8)
    p = Pair(1 << 6, 8, np.arange(1, 9, dtype=np.uint64), _vals(r, 8),
             dcap=2)
    p.step([Op.SET] * 4, [1, 2, 3, 4], _vals(r, 4), [0] * 4, scan_max=2)
    assert bool(p.pr.stale)
    rt, _, srep = p.step([Op.SCAN, Op.GET], [1, 2], _vals(r, 2), [2, 0],
                         scan_max=2)
    assert rt[0] == Reply.RETRY and int(srep.count[0]) == 0
    p.rebuild()
    assert not bool(p.pr.stale)
    rt, _, srep = p.step([Op.SCAN], [1], _vals(r, 1), [2], scan_max=2)
    assert rt[0] == Reply.VAL and _scan_keys(srep, 0) == [1, 2]


# ----------------------------------------------------------- serve runner

N_KEYS, W, CPB, SMAX, MAX_LEN = 300, 64, 2, 8, 10


def _block_draws(bkey, scan_frac, n_keys=N_KEYS):
    """JAX's cohort draws of one block (store.py:390-408, 458-459), as the
    port's six [cpb, w] arrays; the scan uniform is zeros when JAX draws
    none."""
    hot_n = max(1, min(int(n_keys * 0.04), n_keys))
    cols = [[] for _ in range(6)]
    for k in jax.random.split(bkey, CPB):
        ks = jax.random.split(k, 6)
        row = [jax.random.uniform(ks[0], (W,)) if scan_frac > 0.0
               else jnp.zeros((W,), jnp.float32),
               jax.random.uniform(ks[1], (W,)),
               jax.random.uniform(ks[2], (W,)),
               jax.random.randint(ks[3], (W,), 1, hot_n + 1),
               jax.random.randint(ks[4], (W,), 1, n_keys + 1),
               jax.random.randint(ks[5], (W,), 1, MAX_LEN + 1)]
        for c, x in zip(cols, row):
            c.append(np.asarray(x))
    return tuple(torch.from_numpy(np.stack(c)) for c in cols)


@pytest.mark.parametrize("use_scan,dcap,serve", [(False, None, False),
                                                 (True, 32, False),
                                                 (True, 8, True)])
def test_serve_runner_matches_jax(use_scan, dcap, serve):
    """Two blocks + drain; dcap 8 overflows the overlay (RETRY scans)."""
    kw = dict(w=W, cohorts_per_block=CPB, val_words=VW, read_frac=0.5,
              scan_frac=0.6, max_scan_len=MAX_LEN, scan_max=SMAX,
              delta_cap=dcap, use_scan=use_scan, monitor=True, serve=serve)
    jrun_, jinit, jdrain = jst.build_serve_runner(N_KEYS, use_pallas=False,
                                                  **kw)
    prun, pinit, pdrain = store.build_serve_runner(N_KEYS, device="cpu",
                                                   **kw)
    jc = jinit(jmicro.make_store_table(N_KEYS, val_words=VW))
    pc = pinit(micro.make_store_table(N_KEYS, val_words=VW, device="cpu"))
    occ = np.array([[W, W - 9], [W // 3, 0]], np.int32)
    shed = np.array([[0, 2], [5, 1]], np.int32)
    scan_frac = 0.6 if use_scan else 0.0
    stats = []
    before = sk.scan_rows.launches
    for i in range(2):
        bkey = jax.random.fold_in(jax.random.PRNGKey(11), i)
        sargs = (occ[i], shed[i]) if serve else ()
        jc, js = jrun_(jc, bkey, *map(jnp.asarray, sargs))
        pc, ps = prun.run_draws(pc, _block_draws(bkey, scan_frac),
                                *map(torch.from_numpy, sargs))
        assert np.array_equal(np.asarray(js), ps.numpy()), i
        _assert_same_table(jc[0], pc[0])
        if use_scan:
            _assert_same_run(jc[1], pc[1])
        stats.append(ps.numpy())
    assert sk.scan_rows.launches == before       # CPU: the plain version
    jt, jz, jcnt = jdrain(jc)
    pt, pz, pcnt = pdrain(pc)
    assert np.array_equal(np.asarray(jz), pz.numpy())
    _assert_same_table(jt, pt)
    js, ps = jmon.snapshot(jcnt), mon.snapshot(pcnt)
    steps = 2 * CPB
    assert (js["dispatch_xla"], js["dispatch_pallas"]) == (steps, 0)
    assert (ps["dispatch_xla"], ps["dispatch_pallas"]) == (0, steps)
    assert {k: v for k, v in js.items() if not k.startswith("dispatch")} \
        == {k: v for k, v in ps.items() if not k.startswith("dispatch")}
    st = np.concatenate(stats).astype(np.int64)
    assert ps["serve_occupancy_lanes"] == int(st[:, 0].sum())
    assert ps["serve_padded_lanes"] == steps * W - int(st[:, 0].sum())
    if serve:
        assert ps["serve_shed_lanes"] == int(shed.sum())
    if use_scan:
        assert ps["scan_requests"] > 0 and ps["scan_rows"] > 0
        assert ps["scan_delta_hits"] <= ps["scan_rows"]
    if use_scan and dcap == 32:
        assert (st[:, 1] == st[:, 0]).all()     # every lane committed
    if dcap == 8:
        assert (st[:, 1] < st[:, 0]).any()      # stale scans: RETRY


def test_runner_signatures():
    run, init, drain = store.build_serve_runner(40, w=8, cohorts_per_block=2,
                                                val_words=VW, device="cpu")
    carry = init(micro.make_store_table(40, val_words=VW, device="cpu"))
    assert len(carry) == 1
    gen = torch.Generator().manual_seed(0)
    carry, s = run(carry, gen)
    assert tuple(s.shape) == (2, 2) and (s[:, 0] == 8).all()
    with pytest.raises(ValueError, match="serve"):
        run(carry, gen, torch.full((2,), 8, dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32))
    assert len(drain(carry)) == 2


def test_attach_hot_matches_jax_and_round_trips():
    r = np.random.default_rng(9)
    keys = r.choice(100, 60, replace=False).astype(np.uint64)
    p = Pair(1 << 5, 4, keys, _vals(r, 60), hot_n=40)
    _same(p.jh.val, p.ph.val, "val")
    _same(p.jh.ver, p.ph.ver, "ver")
    back = convert.hot_kv_from_numpy(
        {"val": np.asarray(p.jh.val), "ver": np.asarray(p.jh.ver)}, "cpu")
    assert back.hot_n == 40
    assert torch.equal(back.val, p.ph.val) and torch.equal(back.ver, p.ph.ver)
    assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(
        convert.hot_kv_to_numpy(back).values(), (p.jh.val, p.jh.ver)))


def test_store_entry_points_default_to_cuda(monkeypatch):
    """device=None means CUDA: without a card every entry point raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [lambda: kv.create(16),
             lambda: run_mod.create(16),
             lambda: kv.assign_two_choice(np.arange(1, 9, dtype=np.uint64),
                                          16, 4),
             lambda: micro.make_store_table(10),
             lambda: make_batch([Op.GET], [1]),
             lambda: store.build_serve_runner(10, w=8),
             lambda: convert.kv_table_from_numpy({}),
             lambda: store_cache.create(16),
             lambda: CachedStore(16),
             lambda: micro.StoreClient.populated(10, width=8),
             lambda: convert.cache_table_from_numpy({})]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
