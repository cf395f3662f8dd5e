"""The port's YCSB-E helpers (dint_tpu_torch.clients.workloads
`zipf_scan_starts`, `ycsb_e_ops`): twins of tests/test_workloads.py's pins,
and equal to the JAX package's helpers on the same generator seeds (the
store's A/B replays them, so they must reproduce bit for bit)."""
import numpy as np

from dint_tpu.clients import workloads as jwl
from dint_tpu_torch.clients import workloads as wl


def test_zipf_scan_starts_matches_zipf_keys():
    a = wl.zipf_scan_starts(np.random.default_rng(3), 5_000, 1_000)
    b = wl.zipf_keys(np.random.default_rng(3), 5_000, 1_000)
    assert np.array_equal(a, b)
    assert a.min() >= 1 and a.max() <= 1_000
    assert (a == 1).sum() > (a == 500).sum()          # the hot head
    j = jwl.zipf_scan_starts(np.random.default_rng(3), 5_000, 1_000)
    assert a.dtype == j.dtype and np.array_equal(a, j)


def test_ycsb_e_ops_deterministic_shape():
    s1, k1, l1 = wl.ycsb_e_ops(np.random.default_rng(11), 8_000, 10_000)
    s2, k2, l2 = wl.ycsb_e_ops(np.random.default_rng(11), 8_000, 10_000)
    assert np.array_equal(s1, s2) and np.array_equal(k1, k2) \
        and np.array_equal(l1, l2)
    assert s1.dtype == bool and l1.dtype == np.uint32
    assert 0.93 < s1.mean() < 0.97                    # 95% scans
    assert (l1[~s1] == 0).all()
    assert l1[s1].min() >= 1 and l1[s1].max() <= wl.YCSB_E_MAX_SCAN
    assert k1.min() >= 1 and k1.max() <= 10_000
    js, jk, jl = jwl.ycsb_e_ops(np.random.default_rng(11), 8_000, 10_000)
    for a, b in ((s1, js), (k1, jk), (l1, jl)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_ycsb_e_ops_scan_frac_knob():
    s, k, lens = wl.ycsb_e_ops(np.random.default_rng(5), 4_000, 1_000,
                               scan_frac=0.05, max_len=8)
    assert 0.03 < s.mean() < 0.08
    assert lens[s].max() <= 8
    js, jk, jl = jwl.ycsb_e_ops(np.random.default_rng(5), 4_000, 1_000,
                                scan_frac=0.05, max_len=8)
    assert np.array_equal(s, js) and np.array_equal(k, jk) \
        and np.array_equal(lens, jl)
    s0, _, l0 = wl.ycsb_e_ops(np.random.default_rng(5), 1_000, 1_000,
                              scan_frac=0.0)
    assert not s0.any() and (l0 == 0).all()
