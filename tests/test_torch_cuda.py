"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes (chip_smoke.py covers the main-path shapes). Skips without
a CUDA device. This file imports neither JAX nor the JAX package, so it
runs on a machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: exact (integer data)."""
import numpy as np
import pytest
import torch

from dint_tpu_torch.engines import tatp_dense as td
from dint_tpu_torch.ops import row_kernels as rk
from dint_tpu_torch.ops import scan_kernels as sk
from dint_tpu_torch.ops import u32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("vw", [1, 10])
def test_gather_rows_kernel_matches_plain(cuda, vw):
    r = np.random.default_rng(vw)
    n = 5000
    tab = u32.from_numpy(r.integers(0, 1 << 32, n * vw, dtype=np.uint64)
                         .astype(np.uint32), cuda)
    idx = r.integers(0, n, 3001).astype(np.int32)
    idx[::7] = n - 1
    idx = torch.from_numpy(idx).to(cuda)
    before = rk.gather_rows.launches
    got = rk.gather_rows(tab, idx, vw)
    assert rk.gather_rows.launches == before + 1
    assert torch.equal(got, rk.gather_rows_ref(tab, idx, vw))


@pytest.mark.cuda
@pytest.mark.parametrize("t", [5, td.REBASE_AT - 1])
def test_lock_arbitrate_kernel_matches_plain(cuda, t):
    r = np.random.default_rng(t)
    n1, m = 1000, 4096
    arb0 = np.zeros(n1, np.uint32)
    for row in r.choice(n1 - 1, 100, replace=False):
        arb0[row] = np.uint32((int(r.choice([t - 1, t - 2])) << td.K_ARB) | 3)
    rows = r.integers(0, 300, m).astype(np.int32)      # heavy duplicates
    act = r.random(m) < 0.75
    rows[~act] = n1 - 1
    rows, act = torch.from_numpy(rows).to(cuda), torch.from_numpy(act).to(cuda)
    before = rk.lock_arbitrate.launches
    a_k, g_k = rk.lock_arbitrate(u32.from_numpy(arb0, cuda), rows, act, t,
                                 td.K_ARB)
    assert rk.lock_arbitrate.launches == before + 1
    a_r, g_r = rk.lock_arbitrate_ref(u32.from_numpy(arb0, cuda), rows, act,
                                     t, td.K_ARB)
    torch.cuda.synchronize()
    assert torch.equal(a_k, a_r) and torch.equal(g_k, g_r)
    assert bool(g_k.any())


@pytest.mark.cuda
@pytest.mark.parametrize("t", [5, td.REBASE_AT - 1])
def test_lock_validate_kernel_matches_plain(cuda, t):
    r = np.random.default_rng(t + 1)
    n1, m, v, k = 1000, 4096, 3000, 2500
    arb0 = np.zeros(n1, np.uint32)
    for row in r.choice(n1 - 1, 100, replace=False):
        arb0[row] = np.uint32((int(r.choice([t - 1, t - 2])) << td.K_ARB) | 3)
    meta = r.integers(0, 1 << 32, n1, dtype=np.uint64).astype(np.uint32)
    rows = r.integers(0, 300, m).astype(np.int32)      # heavy duplicates
    act = r.random(m) < 0.75
    rows[~act] = n1 - 1
    vidx = r.integers(0, n1, v).astype(np.int32)
    vv1 = np.where(r.random(v) < 0.5, meta[vidx], meta[vidx] ^ 2)
    args = [u32.from_numpy(meta, cuda),
            torch.from_numpy(vidx).to(cuda), u32.from_numpy(vv1, cuda),
            torch.from_numpy(r.integers(0, n1, k).astype(np.int32)).to(cuda),
            torch.from_numpy(rows).to(cuda), torch.from_numpy(act).to(cuda)]
    before = rk.lock_validate.launches
    got = rk.lock_validate(u32.from_numpy(arb0, cuda), *args, t, td.K_ARB)
    assert rk.lock_validate.launches == before + 1
    want = rk.lock_validate_ref(u32.from_numpy(arb0, cuda), *args, t,
                                td.K_ARB)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert bool(got[1].any()) and bool(got[2].any())


def _lanes(r, n, k, hot, cuda):
    """K lanes over n rows, ~90% of them in the hot prefix [0, hot)."""
    rows = np.where(r.random(k) < 0.9, r.integers(0, hot, k),
                    r.integers(0, n, k)).astype(np.int32)
    midx = np.where(rows < hot, rows, -1).astype(np.int32)
    return (torch.from_numpy(rows).to(cuda), torch.from_numpy(midx).to(cuda))


def _words(r, n, cuda):
    return u32.from_numpy(r.integers(0, 1 << 32, n, dtype=np.uint64)
                          .astype(np.uint32), cuda)


@pytest.mark.cuda
def test_gather_streams_kernel_matches_plain(cuda):
    r = np.random.default_rng(1)
    vws = (1, 18, 1)
    tabs = [_words(r, 4000 * vw, cuda) for vw in vws]
    idxs = [torch.from_numpy(r.integers(0, 4000, k).astype(np.int32)).to(cuda)
            for k in (3000, 700, 1)]
    before = rk.gather_streams.launches
    got = rk.gather_streams(tabs, idxs, vws)
    assert rk.gather_streams.launches == before + 1
    for g, w in zip(got, rk.gather_streams_ref(tabs, idxs, vws)):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_scatter_streams_kernel_matches_plain(cuda):
    r = np.random.default_rng(2)
    vws = (1, 18)
    n, k = 5000, 3000
    idxs = [torch.from_numpy(np.where(r.random(k) < 0.7,
                                      r.permutation(n)[:k], -1)
                             .astype(np.int32)).to(cuda) for _ in vws]
    vals = [_words(r, k * vw, cuda) for vw in vws]
    tabs = [_words(r, n * vw, cuda) for vw in vws]
    want = rk.scatter_streams_ref([t.clone() for t in tabs], idxs, vals, vws)
    before = rk.scatter_streams.launches
    got = rk.scatter_streams(tabs, idxs, vals, vws)
    assert rk.scatter_streams.launches == before + 1
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("vw", [1, 3])
def test_hot_kernels_match_plain(cuda, vw):
    r = np.random.default_rng(vw)
    n, hot, k = 6000, 240, 3000
    tab = _words(r, n * vw, cuda)
    mirror = _words(r, hot * vw, cuda)       # unlike the table on purpose
    idx, midx = _lanes(r, n, k, hot, cuda)
    before = rk.gather_rows_hot.launches
    got = rk.gather_rows_hot(tab, mirror, idx, midx, vw)
    assert rk.gather_rows_hot.launches == before + 1
    assert torch.equal(got, rk.gather_rows_hot_ref(tab, mirror, idx, midx,
                                                   vw))
    rows = torch.from_numpy(r.permutation(n)[:k].astype(np.int32)).to(cuda)
    midx = torch.where(rows < hot, rows, -1)
    mask = torch.from_numpy(r.random(k) < 0.7).to(cuda)
    vals = _words(r, k * vw, cuda)
    want = rk.scatter_rows_hot_ref(tab.clone(), mirror.clone(), rows, midx,
                                   mask, vals, vw)
    before = rk.scatter_rows_hot.launches
    got = rk.scatter_rows_hot(tab, mirror, rows, midx, mask, vals, vw)
    assert rk.scatter_rows_hot.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("lg,vw", [(356, 10), (37, 3), (1, 1)])
def test_scan_rows_kernel_matches_plain(cuda, lg, vw):
    r = np.random.default_rng(lg)
    cap, k = 20_000, 1000
    arrs = [_words(r, n, cuda) for n in (cap, cap, cap, cap * vw)]
    off = r.integers(0, cap - lg + 1, k).astype(np.int32)
    off[0], off[-1] = 0, cap - lg                  # edge windows
    off[1::5] = off[2]                             # duplicate offsets
    off = torch.from_numpy(off).to(cuda)
    before = sk.scan_rows.launches
    got = sk.scan_rows(*arrs, off, lg, vw)
    assert sk.scan_rows.launches == before + 1
    torch.cuda.synchronize()
    for g, w in zip(got, sk.scan_rows_ref(*arrs, off, lg, vw)):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dup", [False, True])
def test_scalar_scatter_kernel_matches_plain(cuda, dup):
    """The probe's shape: a [2,200,064 / 512, 512] table, K = 16,384; with
    duplicates, the last lane of each shared index must win."""
    r = np.random.default_rng(int(dup))
    n, c, k = 2_200_064, 512, 16_384
    tab = _words(r, n, cuda).view(n // c, c)
    idx = r.choice(n, k, replace=False)
    if dup:
        idx[1::2] = idx[r.integers(0, 64, k // 2)]
        idx[-3:] = n - 1
    idx = torch.from_numpy(idx.astype(np.int32).reshape(k, 1)).to(cuda)
    val = _words(r, k, cuda).view(k, 1)
    before = rk.scalar_scatter.launches
    got = rk.scalar_scatter(tab, idx, val)
    assert rk.scalar_scatter.launches == before + 1
    want = rk.scalar_scatter_ref(tab, idx, val)
    torch.cuda.synchronize()
    assert got.shape == tab.shape and torch.equal(got, want)
