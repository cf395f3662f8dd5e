"""The port's store client and stat contract (dint_tpu_torch/clients/micro.py,
dint_tpu_torch/stats.py, the Zipfian draws of clients/workloads.py) against
`dint_tpu.clients.micro`, `dint_tpu.stats` and `dint_tpu.clients.workloads`
on the CPU.

`StoreClient.run_wave` runs in both packages from numpy generators of one
seed (the cases of tests/test_micro_clients.py:8-55: the parallel and
contention mixes, the scan mix, a stale overlay's RETRY -> rebuild ->
resend, plus the Zipfian keys and the hot tier): each wave's committed
count, the table, the mirror and the run after each wave, the recorder's
counts, and the generators' states must be equal. JAX's routes are given
explicitly (its environment knobs stay unread); the port's are arguments.
Tolerance: exact, except the recorder's latencies (wall times of two
different programs), which are only checked for their count."""
import numpy as np
import pytest

from dint_tpu import stats as jstats
from dint_tpu.clients import micro as jmicro
from dint_tpu.clients import workloads as jwl
from dint_tpu_torch import convert, stats
from dint_tpu_torch.clients import micro
from dint_tpu_torch.clients import workloads as wl

from test_torch_run import _assert_same_run
from test_torch_store_ops import _assert_same_table


def _jparts(j):
    """JAX's client state as the port's (table, hot, run), None where
    absent."""
    if not (j.use_hotset or j.use_scan):
        return j.state, None, None
    rest = list(j.state[1:])
    return (j.state[0], rest.pop(0) if j.use_hotset else None,
            rest.pop(0) if j.use_scan else None)


def _pair(n_keys, **kw):
    j = jmicro.StoreClient.populated(
        n_keys, use_hotset=kw.get("use_hotset", False),
        use_scan=kw.get("use_scan", False), use_pallas=False, **{
            k: v for k, v in kw.items() if k not in ("use_hotset",
                                                     "use_scan")})
    p = micro.StoreClient.populated(n_keys, device="cpu", **kw)
    return j, p


def _assert_same_state(j, p):
    jt, jh, jr = _jparts(j)
    pt, ph, pr = p.state
    _assert_same_table(jt, pt)
    assert (jh is None) == (ph is None) and (jr is None) == (pr is None)
    if jh is not None:
        assert np.array_equal(np.asarray(jh.val),
                              convert.hot_kv_to_numpy(ph)["val"])
        assert np.array_equal(np.asarray(jh.ver),
                              convert.hot_kv_to_numpy(ph)["ver"])
    if jr is not None:
        _assert_same_run(jr, pr)


def _run(j, p, waves, n, seed=0):
    rj, rp = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(waves):
        assert j.run_wave(rj, n) == p.run_wave(rp, n)
        _assert_same_state(j, p)
    assert rj.random() == rp.random()
    assert (j.rec.attempted, j.rec.committed) == (p.rec.attempted,
                                                  p.rec.committed)
    assert j.rec.lat.n_seen == p.rec.lat.n_seen


@pytest.mark.parametrize("frac", [1.0, 0.5])
def test_store_client_mixes_match_jax(frac):
    j, p = _pair(1000, width=512, read_frac=frac)
    assert not p.use_hotset and not p.use_scan and p.scan_frac == 0.0
    _run(j, p, 3, 512)
    blk = p.rec.block(elapsed_s=1.0)
    assert blk.throughput == blk.goodput == 3 * 512
    assert blk.p99_us >= blk.p50_us > 0


def test_store_client_zipfian_hot_tier_matches_jax():
    j, p = _pair(600, width=256, read_frac=0.5, key_dist="zipfian",
                 use_hotset=True, hot_frac=0.1)
    assert p.state[1].hot_n == 61
    _run(j, p, 3, 256, seed=1)


def test_store_client_scan_mix_matches_jax():
    j, p = _pair(500, width=256, read_frac=0.5, key_dist="zipfian",
                 use_scan=True, scan_frac=0.3, scan_max=8, rebuild_every=2)
    assert p.use_scan and p.scan_frac == 0.3
    _run(j, p, 4, 256, seed=2)
    assert p.rec.committed == 4 * 256


def test_store_client_scan_stale_retry_matches_jax():
    """A tiny overlay under a write-heavy mix goes stale: the scans answer
    RETRY, the client rebuilds mid-wave and re-sends those lanes."""
    j, p = _pair(300, width=128, read_frac=0.0, use_scan=True, scan_frac=0.5,
                 scan_max=4, delta_cap=4, rebuild_every=10_000)
    rebuilds = []
    orig = p._rebuild
    p._rebuild = lambda: (rebuilds.append(1), orig())[1]
    _run(j, p, 3, 128, seed=3)
    assert rebuilds, "the stale overlay never took the retry path"


def test_store_client_refuses_scan_lanes_without_the_run():
    p = micro.StoreClient.populated(50, width=16, device="cpu")
    p.scan_frac = 1.0
    with pytest.raises(AssertionError, match="use_scan"):
        p.run_wave(np.random.default_rng(0), 16)


def test_cache_stream_draws():
    """The cache tier's traffic: a GET sweep of the hot prefix, each key
    once, then 50/50 GET/SET rounds of the width, keys mostly from the
    prefix and the rest up to 1.1x the keyspace, SET values carrying the
    magic word; one seed, one stream."""
    n_keys, w, vw = 10_000, 64, 4
    hot_n = int(n_keys * wl.SB_HOT_FRAC)
    a = micro.cache_stream(np.random.default_rng(3), n_keys, w, 5, vw)
    b = micro.cache_stream(np.random.default_rng(3), n_keys, w, 5, vw)
    n_sweep = -(-hot_n // w)
    assert len(a) == n_sweep + 5
    sweep = a[:n_sweep]
    assert all(v is None and (o == micro.Op.GET).all() for o, _, v in sweep)
    assert np.array_equal(np.concatenate([k for _, k, _ in sweep]),
                          np.arange(1, hot_n + 1, dtype=np.uint64))
    keys = np.concatenate([k for _, k, _ in a[n_sweep:]])
    assert keys.dtype == np.uint64 and keys.min() >= 1
    assert keys.max() < int(n_keys * 1.1) and (keys > n_keys).any()
    assert 0.8 < (keys <= hot_n).mean() < 0.97
    for (o, k, v), (o2, k2, v2) in zip(a[n_sweep:], b[n_sweep:]):
        assert o.shape == k.shape == (w,) and v.shape == (w, vw)
        assert set(np.unique(o)) <= {micro.Op.GET, micro.Op.SET}
        assert (v[:, 1] == micro.STORE_MAGIC).all()
        assert (np.array_equal(o, o2) and np.array_equal(k, k2)
                and np.array_equal(v, v2))


def test_zipf_keys_match_jax():
    for n_keys, theta in ((1000, wl.ZIPF_THETA), (37, 0.5)):
        a = jwl.zipf_keys(np.random.default_rng(4), 5000, n_keys, theta)
        b = wl.zipf_keys(np.random.default_rng(4), 5000, n_keys, theta)
        assert a.dtype == b.dtype and np.array_equal(a, b)
        assert np.array_equal(jwl.zipf_cdf(n_keys, theta),
                              wl.zipf_cdf(n_keys, theta))
    assert wl.ZIPF_THETA == jwl.ZIPF_THETA


def test_stats_match_jax():
    """Reservoir downsampling, percentiles, the histogram block and the
    metric block, on the same samples."""
    lat = np.r_[np.linspace(10, 1000, 300), [np.nan, np.inf, 0.0, -1.0]]
    rs = []
    for mod in (jstats, stats):
        r = mod.LatencyReservoir(cap=100, seed=0)
        r.add(np.full(50, 10.0))
        r.add(lat)
        rs.append(r)
    assert np.array_equal(rs[0].samples, rs[1].samples)
    assert rs[0].percentiles() == rs[1].percentiles()
    assert rs[0].hist.to_dict() == rs[1].hist.to_dict()
    assert (rs[1].n_kept, rs[1].n_seen) == (100, 354)
    assert stats.LatencyReservoir().percentiles() == \
        jstats.LatencyReservoir().percentiles()
    blocks = []
    for mod in (jstats, stats):
        rec = mod.Recorder()
        rec.record(100, 90, lat, device_s=0.5)
        rec.extra["k"] = 1
        blocks.append(rec.block(elapsed_s=2.0))
    assert blocks[0].to_dict() == blocks[1].to_dict()
    assert blocks[0].format() == blocks[1].format()
    assert blocks[0].json() == blocks[1].json()
    assert abs(blocks[1].abort_rate - 0.1) < 1e-12
    assert stats.TxnStats(10, 7).abort_rate == jstats.TxnStats(10,
                                                               7).abort_rate
    assert stats.TxnStats().abort_rate == 0.0
