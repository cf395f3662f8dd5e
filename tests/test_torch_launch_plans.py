"""The host-side launch plans of the port's one-launch kernels, on the CPU:
`row_kernels.lock_pass_plan` (csrc/lock_arbitrate.cu and
csrc/lock_validate.cu, one cooperative launch each) and
`row_kernels.scalar_scatter_plan` with the claim table ``win`` the
wrapper keeps per device and stream (csrc/scalar_scatter.cu).

`_lock_lanes` mirrors how a thread of the lock pass finds its lanes, and
`_claims` replays the scalar scatter's claim, store and reset steps in
numpy, so these tests hold the kernels' coverage and the claim table's
life without a card (the kernels themselves are held against their plain
versions by tests/test_torch_cuda.py and chip_smoke.py). Exact checks
throughout."""
import numpy as np
import pytest
import torch

from dint_tpu_torch.engines import tatp_dense as td
from dint_tpu_torch.ops import row_kernels as rk

LANES = [0, 1, 255, 16_384, 16_385, 1 << 18]


def _per_thread(plan, lanes):
    """The most lane positions of a ``lanes``-lane job one thread takes."""
    return -(-lanes // (plan.blocks * plan.threads))


def _lock_lanes(plan, lanes):
    """How many times each lane is taken when thread tid of the plan's
    grid takes lanes tid, tid + G, ... (G threads), and the most lanes one
    thread takes."""
    g = plan.blocks * plan.threads
    seen = np.zeros(lanes, np.int64)
    most = 0
    for tid in range(min(g, lanes)):
        own = np.arange(tid, lanes, g)
        seen[own] += 1
        most = max(most, own.size)
    return seen, most


@pytest.mark.parametrize("cap", [64, 396, 1056])
@pytest.mark.parametrize("m", LANES)
def test_lock_pass_plan_shape(m, cap):
    plan = rk.lock_pass_plan(m, m, td.K_ARB, cap)
    assert plan.threads == rk.LOCK_VALIDATE_THREADS == 256
    if m == 0:
        assert plan.blocks == 0
        return
    # the blocks the lanes need at one lane a thread, at most the cap
    assert plan.blocks == min(cap, -(-m // 256))
    seen, most = _lock_lanes(plan, m)
    assert (seen == 1).all()
    assert most == _per_thread(plan, m) <= rk.LOCK_VALIDATE_MAX_LOCK_LANES


@pytest.mark.parametrize("m,blocks,per_thread", [
    (1, 1, 1), (255, 1, 1), (256, 1, 1), (257, 2, 1), (16_384, 64, 1),
    (16_385, 65, 1), (1 << 18, 396, 3)])
def test_lock_pass_plan_at_the_h100_cap(m, blocks, per_thread):
    """TATP's M = 16,384 takes 64 blocks, one lane a thread; 2^18 lanes
    stride over a 396-block cap (B4's occupancy on the H100, PERF.md)."""
    plan = rk.lock_pass_plan(m, m, td.K_ARB, 396)
    assert (plan.blocks, _per_thread(plan, m)) == (blocks, per_thread)


def test_lock_pass_plan_refusals():
    with pytest.raises(ValueError, match="18-bit slot field"):
        rk.lock_pass_plan((1 << 18) + 1, (1 << 18) + 1, td.K_ARB, 10_000)
    with pytest.raises(ValueError, match="2-bit slot field"):
        rk.lock_pass_plan(5, 5, 2, 10)
    # more lock lanes than 64 a thread: a one-block cap holds 16,384
    assert _per_thread(rk.lock_pass_plan(16_384, 16_384, td.K_ARB, 1),
                       16_384) == 64
    with pytest.raises(ValueError, match="exceed the 16384"):
        rk.lock_pass_plan(16_385, 16_385, td.K_ARB, 1)


@pytest.mark.parametrize("v,r,m", [(32_768, 32_768, 16_384), (0, 700, 900),
                                   (700, 0, 0), (0, 0, 0)])
def test_lock_pass_plan_lock_validate_jobs(v, r, m):
    """B4 sizes its grid to its widest job; the lock lanes are checked
    against the lanes a thread may own."""
    plan = rk.lock_pass_plan(max(v, r, m), m, td.K_ARB, 396, "lock_validate")
    assert plan.blocks == min(396, -(-max(v, r, m) // 256))
    if max(v, r, m):
        for lanes in (v, r, m):
            seen, most = _lock_lanes(plan, lanes)
            assert (seen == 1).all()
            assert most <= _per_thread(plan, max(v, r, m))


# ------------------------------------------------------------ scalar scatter


@pytest.mark.parametrize("k", [0, 1, 16_384])
@pytest.mark.parametrize("grid", [66, 132, 1056])
def test_scalar_scatter_plan_shape(k, grid):
    n = 2_200_064                               # the probe's table
    plan = rk.scalar_scatter_plan(n, k, grid)
    # one claim word per table word, a power of two; none without lanes
    assert plan.win_words == (0 if k == 0 else 1 << 22)
    # the copy needs 550,016 16-byte words: the whole grid (one block an SM
    # on the H100, 132) takes part, each thread several words
    assert plan.blocks == min(grid, 1075)


@pytest.mark.parametrize("n,k,blocks,words", [
    (0, 0, 0, 0), (1, 0, 1, 0), (1, 1, 1, 1), (4, 1, 1, 4), (5, 3, 1, 8),
    (4 * 512 + 1, 1, 2, 4096), (100, 1500, 3, 128)])
def test_scalar_scatter_plan_small_work(n, k, blocks, words):
    """No more blocks than one 16-byte word or one lane a thread needs, at
    least one; an empty table launches nothing."""
    assert rk.scalar_scatter_plan(n, k, 1056) == (blocks, words)


def _claims(win, tab, idx, val, order):
    """The kernel's steps in numpy, lanes claiming in ``order``: each lane
    maxes its lane id into win[idx]; then every lane stores iff it is its
    index's winner, and the winner resets its word. Returns the output
    table."""
    for i in order:
        win[idx[i]] = max(win[idx[i]], i)
    out = tab.copy()
    for i in order:
        if win[idx[i]] == i:
            out[idx[i]] = val[i]
            win[idx[i]] = -1
    return out


@pytest.mark.parametrize("k,distinct", [(1, 1), (64, 1), (500, 7),
                                        (2048, 2048), (3000, 400)])
def test_claim_table_is_left_clean_and_last_lane_wins(k, distinct):
    """Two calls in a row on one claim table, lanes claiming and storing in
    a random order: each equals the plain version and leaves win all -1."""
    r = np.random.default_rng(k + distinct)
    n = 10_000
    win = np.full(rk.scalar_scatter_plan(n, k, 1056).win_words, -1, np.int64)
    for _ in range(2):
        tab = r.integers(0, 1 << 31, n)
        pool = r.choice(n, distinct, replace=False)
        idx = pool[r.integers(0, distinct, k)]
        idx[-1] = n - 1                               # the last word
        val = r.integers(0, 1 << 31, k)
        got = _claims(win, tab, idx, val, r.permutation(k))
        want = rk.scalar_scatter_ref(torch.from_numpy(tab),
                                     torch.from_numpy(idx),
                                     torch.from_numpy(val))
        assert np.array_equal(got, want.numpy())
        assert (win == -1).all()


def test_claim_tables_one_per_stream_regrown(monkeypatch):
    """One table per (device, stream), cleared at first use; a call that
    needs more words replaces it, and the outgrown one is dropped."""
    monkeypatch.setattr(rk, "_claim_tables", {})
    monkeypatch.setattr(rk, "_graph_claim_tables", {})
    cpu = torch.device("cpu")
    t1 = rk._claim_table(cpu, 7, 1 << 22)
    assert t1.numel() == 1 << 22 and bool((t1 == -1).all())
    assert rk._claim_table(cpu, 7, 5) is t1              # room already
    assert rk._claim_table(cpu, 8, 5).numel() == 5       # another stream
    t2 = rk._claim_table(cpu, 7, 1 << 23)                # outgrown
    assert t2.numel() == 1 << 23 and bool((t2 == -1).all())
    assert rk._claim_tables[(None, 7)] is t2             # the old one dropped
    assert len(rk._claim_tables) == 2 and not rk._graph_claim_tables


def test_claim_table_under_capture(monkeypatch):
    """While the stream is captured into a CUDA graph no table is made (its
    fill would run only inside the graph): without one large enough the
    call raises; with one, the graph's table is kept past a later
    regrowth."""
    dev = torch.device("cuda", 0)
    held = torch.full((64,), -1, dtype=torch.int32)
    monkeypatch.setattr(rk, "_claim_tables", {(0, 7): held})
    monkeypatch.setattr(rk, "_graph_claim_tables", {})
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="outside the capture"):
        rk._claim_table(dev, 8, 5)                       # no table yet
    with pytest.raises(RuntimeError, match="outside the capture"):
        rk._claim_table(dev, 7, 65)                      # too small
    assert rk._claim_tables == {(0, 7): held}
    assert rk._claim_table(dev, 7, 64) is held
    assert rk._graph_claim_tables == {held.data_ptr(): held}
