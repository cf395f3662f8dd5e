"""SmallBank's abort rate rising with the run's length, held against the
reference: `dint_tpu.engines.smallbank_dense` and the port's dense engine
on the same replayed draws over 60 blocks (240 cohorts) at a cut account
count and width, the stats compared block by block, aborts split into
ab_lock and ab_logic.

The climb is the workload's own: an amalgamate zeroes its first account's
savings and checking, and later send_payment and transact_saving on a
zeroed hot account fail their balance checks. So ab_logic grows with the
txns each hot account has seen, while ab_lock, the contention, stays
flat. The reference shows the same numbers, block for block."""
import jax
import numpy as np

from dint_tpu.engines import smallbank_dense as jsd
from dint_tpu_torch import convert
from dint_tpu_torch.engines import smallbank_dense as sd

import test_torch_smallbank_dense as tsd

# 40,000 accounts (a 1,600-account hot set), w = 128, 4 cohorts a block:
# each hot account sees ~7 txns over the run, as a hot account of the
# 24M-account bench does in ~3 s at w = 8192
N, W, CPB, BLOCKS = 40_000, 128, 4, 60


def test_abort_climb_is_the_references_own():
    jdb = jsd.create(N, log_capacity=64)
    start = tsd._jax_arrays(jdb)
    jrun, jinit, _ = jsd.build_pipelined_runner(
        N, w=W, cohorts_per_block=CPB, use_pallas=False, use_hotset=False,
        use_fused=False)
    prun, pinit, _ = sd.build_pipelined_runner(N, w=W, cohorts_per_block=CPB,
                                               device="cpu")
    jc = jinit(jdb)
    pc = pinit(convert.dense_bank_from_numpy(start, "cpu"))
    per_block = []
    for i in range(BLOCKS):
        key = jax.random.fold_in(jax.random.PRNGKey(11), i)
        jc, js = jrun(jc, key)
        pc, ps = prun.run_draws(pc, *tsd._block_draws(key, CPB, W))
        js = np.asarray(js)
        assert np.array_equal(js, ps.numpy()), i
        per_block.append(js.sum(0))
    tsd._assert_same(tsd._jax_arrays(jc[0]), pc[0])

    s = np.array(per_block, np.float64)
    att = s[:, sd.STAT_ATTEMPTED]
    q = BLOCKS // 4
    lock = s[:, sd.STAT_AB_LOCK] / att
    logic = s[:, sd.STAT_AB_LOGIC] / att
    # ab_logic climbs: the last quarter's rate is over twice the first's
    assert logic[-q:].mean() > 2 * logic[:q].mean() > 0
    # ab_lock does not: the two quarters agree within a fifth
    assert abs(lock[-q:].mean() - lock[:q].mean()) < 0.2 * lock[:q].mean()
    # the mechanism: savings an amalgamate zeroed gather in the hot set
    # (rows 0..N-1 are the savings, the first 4% of them hot)
    bal = convert.dense_bank_to_numpy(pc[0])["bal"].view(np.int32)
    hot = int(N * 0.04)
    assert (bal[:hot] == 0).mean() > 10 * (bal[hot:N] == 0).mean() > 0
