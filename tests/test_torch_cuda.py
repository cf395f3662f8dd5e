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
