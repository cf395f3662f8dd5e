"""The port's row kernels (dint_tpu_torch/ops/row_kernels.py) against the
JAX package's Pallas kernels (interpret mode) and XLA chains.

On the CPU the wrappers run their plain PyTorch versions; the CUDA kernels
themselves are held against those plain versions on the card by
tests/test_torch_cuda.py (marker ``cuda``) and by chip_smoke.py.
Tolerance everywhere: exact (all data is integer)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dint_tpu.engines import tatp_dense as jtd
from dint_tpu.ops import pallas_gather as pg
from dint_tpu_torch.engines import tatp_dense as td
from dint_tpu_torch.ops import row_kernels as rk
from dint_tpu_torch.ops import u32

U32 = jnp.uint32


def _table(r, n, vw):
    return r.integers(0, 1 << 32, n * vw, dtype=np.uint64).astype(np.uint32)


# ------------------------------------------------------------ gather_rows


@pytest.mark.parametrize("n,vw,k", [
    (1000, 10, 333),      # val-style wide rows
    (512, 1, 700),        # meta-style single words, K > N
    (37, 10, 5),          # K smaller than the TPU kernel's DMA ring
    (64, 1, 64),
])
def test_gather_rows_ref_matches_pallas_and_take(n, vw, k):
    r = np.random.default_rng(n + k)
    tab = _table(r, n, vw)
    idx = r.integers(0, n, k).astype(np.int32)
    idx[::7] = n - 1                 # sentinel lanes
    idx[1::5] = idx[0]               # duplicates
    want_p = np.asarray(pg.gather_rows(jnp.asarray(tab), jnp.asarray(idx),
                                       vw, True))
    want_t = np.asarray(jnp.take(jnp.asarray(tab).reshape(n, vw),
                                 jnp.asarray(idx), axis=0).reshape(-1))
    assert np.array_equal(want_p, want_t)
    tab_t, idx_t = u32.from_numpy(tab, "cpu"), torch.from_numpy(idx)
    got = rk.gather_rows_ref(tab_t, idx_t, vw)
    assert got.dtype == torch.int32 and got.shape == (k * vw,)
    assert np.array_equal(u32.to_numpy(got), want_p)
    before = rk.gather_rows.launches
    assert np.array_equal(u32.to_numpy(rk.gather_rows(tab_t, idx_t, vw)),
                          want_p)
    assert rk.gather_rows.launches == before     # CPU: no kernel launched


def test_gather_rows_word_offset_pattern():
    """The magic check gathers ONE word at rows*VW + 1: pre-scaled flat
    word indices with vw=1, as the engine passes them."""
    r = np.random.default_rng(3)
    n, vw = 200, 10
    tab = _table(r, n, vw)
    rows = r.integers(0, n, 77).astype(np.int32)
    got = rk.gather_rows(u32.from_numpy(tab, "cpu"),
                         torch.from_numpy(rows * vw + 1), 1)
    want = pg.gather_rows(jnp.asarray(tab), jnp.asarray(rows * vw + 1), 1,
                          True)
    assert np.array_equal(u32.to_numpy(got), np.asarray(want))


def test_gather_rows_rejects_bad_arguments():
    tab = torch.zeros(40, dtype=torch.int32)
    idx = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        rk.gather_rows(tab.to(torch.int64), idx, 1)
    with pytest.raises(TypeError):
        rk.gather_rows(tab, idx.to(torch.int64), 1)
    with pytest.raises(ValueError):
        rk.gather_rows(tab.view(20, 2)[:, 0], idx, 1)    # not contiguous
    with pytest.raises(ValueError):
        rk.gather_rows(tab, idx, 3)                      # 40 % 3 != 0
    with pytest.raises(IndexError):
        rk.gather_rows(tab, torch.tensor([40], dtype=torch.int32), 1)


# --------------------------------------------------------- lock_arbitrate


def _xla_chain(arb, rows, active, t, k_arb=jtd.K_ARB):
    """The exact 3-op chain of the JAX pipe_step's XLA lock path."""
    m = rows.shape[0]
    oob = arb.shape[0]
    old = arb[rows]
    held = (old >> k_arb) == (t - 1)
    packed = (t << k_arb) | (U32(m - 1) - jnp.arange(m, dtype=U32))
    cand = active & ~held
    arb2 = arb.at[jnp.where(cand, rows, oob)].max(packed, mode="drop")
    grant = cand & (arb2[rows] == packed)
    return arb2, grant


def _lock_batch(m, row_space, seed, t):
    """Adversarial batch: a third of the rows pre-stamped (held at t-1,
    expiring at t-2, stale at t-3), heavy duplicates, and inactive lanes
    parked on the sentinel row like the engine's."""
    r = np.random.default_rng(seed)
    n1 = max(row_space + 1, 32)
    sent = n1 - 1
    arb0 = np.zeros(n1, np.uint32)
    for row in r.choice(row_space, max(1, row_space // 3), replace=False):
        step = int(r.choice([t - 1, t - 2, t - 3]))
        arb0[row] = np.uint32((step << jtd.K_ARB) | int(r.integers(0, 100)))
    rows = r.integers(0, row_space, m).astype(np.int32)
    act = r.random(m) < 0.75
    rows[~act] = sent
    return arb0, rows, act


@pytest.mark.parametrize("t", [5, jtd.REBASE_AT - 1])   # high t: stamps >= 2^31
@pytest.mark.parametrize("m,row_space,seed", [
    (64, 8, 0),      # heavy in-batch duplication (8 rows, 64 lanes)
    (64, 1000, 1),   # mostly conflict-free
    (10, 3, 2),      # brutal duplication
    (2, 1, 3),       # single row
    (130, 16, 4),    # several TPU ring wraps
    (256, 40, 5),
])
def test_lock_arbitrate_ref_matches_pallas(m, row_space, seed, t):
    arb0, rows, act = _lock_batch(m, row_space, seed, t)
    tj = jnp.asarray(t, U32)
    a_x, g_x = _xla_chain(jnp.asarray(arb0), jnp.asarray(rows),
                          jnp.asarray(act), tj)
    a_p, g_p = pg.lock_arbitrate(jnp.asarray(arb0), jnp.asarray(rows),
                                 jnp.asarray(act), tj, jtd.K_ARB, True)
    assert np.array_equal(np.asarray(a_x), np.asarray(a_p))
    assert np.array_equal(np.asarray(g_x), np.asarray(g_p) != 0)

    arb_t = u32.from_numpy(arb0, "cpu")
    out, grant = rk.lock_arbitrate_ref(arb_t, torch.from_numpy(rows),
                                       torch.from_numpy(act), t, td.K_ARB)
    assert out is arb_t                                  # updated in place
    assert np.array_equal(u32.to_numpy(out), np.asarray(a_p))
    assert grant.dtype == torch.bool
    assert np.array_equal(grant.numpy(), np.asarray(g_p) != 0)
    # the wrapper on CPU tensors is the plain version, and counts nothing
    before = rk.lock_arbitrate.launches
    out2, grant2 = rk.lock_arbitrate(u32.from_numpy(arb0, "cpu"),
                                     torch.from_numpy(rows),
                                     torch.from_numpy(act), t, td.K_ARB)
    assert torch.equal(out2, out) and torch.equal(grant2, grant)
    assert rk.lock_arbitrate.launches == before


def test_lock_arbitrate_held_rows_not_restamped():
    """Candidates on a held row never stamp it: its t-1 stamp survives."""
    t = 9
    arb0 = np.zeros(16, np.uint32)
    arb0[2] = np.uint32((8 << td.K_ARB) | 5)
    arb, grant = rk.lock_arbitrate(u32.from_numpy(arb0, "cpu"),
                                   torch.full((8,), 2, dtype=torch.int32),
                                   torch.ones(8, dtype=torch.bool), t,
                                   td.K_ARB)
    assert not grant.any()
    assert u32.to_numpy(arb)[2] == arb0[2]


def test_lock_arbitrate_rejects_bad_arguments():
    arb = torch.zeros(16, dtype=torch.int32)
    rows = torch.zeros(4, dtype=torch.int32)
    act = torch.ones(4, dtype=torch.bool)
    with pytest.raises(TypeError):
        rk.lock_arbitrate(arb, rows, act.to(torch.int32), 5, td.K_ARB)
    with pytest.raises(ValueError):
        rk.lock_arbitrate(arb, rows, act[:3], 5, td.K_ARB)
    with pytest.raises(ValueError):
        rk.lock_arbitrate(arb, rows, act, 1 << (32 - td.K_ARB), td.K_ARB)
    with pytest.raises(ValueError):
        rk.lock_arbitrate(arb, torch.zeros(8, dtype=torch.int32),
                          torch.ones(8, dtype=torch.bool), 5, 2)
