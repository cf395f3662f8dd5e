"""The port's generic TATP pipeline (`tatp_pipeline.build_pipelined_runner`
over `tatp.step`) against `dint_tpu` on the CPU: blocks plus drain on
JAX's replayed draws, with and without the counter plane; the replicas,
stats and counters bit-identical. The runner's own draws and its shape
checks close the file."""
import jax
import numpy as np
import pytest
import torch

from dint_tpu.engines import tatp_pipeline as jtp
from dint_tpu.monitor import counters as jmon
from dint_tpu_torch import convert
from dint_tpu_torch.clients import tatp_client as ptc
from dint_tpu_torch.engines import tatp_pipeline as tp
from dint_tpu_torch.monitor import counters as mon

import test_torch_tatp_dense as ttd
from test_torch_tatp_generic import (BLOCKS, CONTENTION, DEFAULT, LOG_CAP, VW,
                                     _assert_replicas_identical,
                                     _assert_same_stacked, _closes,
                                     _no_lock_held, _populate)


@pytest.fixture(scope="module")
def jax_pipes():
    """The JAX pipelined runner of each (configuration, monitor)."""
    cache = {}

    def get(cfg, monitor):
        if (cfg[:2], monitor) not in cache:
            cache[cfg[:2], monitor] = jtp.build_pipelined_runner(
                cfg[0], w=cfg[1], val_words=VW, cohorts_per_block=cfg[2],
                mix=cfg[3], monitor=monitor)
        return cache[cfg[:2], monitor]
    return get


@pytest.mark.parametrize("cfg,monitor", [(DEFAULT, False),
                                         (CONTENTION, True)],
                         ids=["default", "contention-monitor"])
def test_pipelined_runner_and_drain_bit_identical(jax_pipes, cfg, monitor):
    n_sub, w, cpb, mix = cfg
    jstacked, ps = _populate(n_sub, seed=5)
    jrun, jinit, jdrain = jax_pipes(cfg, monitor)
    prun, pinit, pdrain = tp.build_pipelined_runner(
        n_sub, w=w, val_words=VW, cohorts_per_block=cpb, mix=mix,
        monitor=monitor, device="cpu")
    jc, pc = jinit(jstacked), pinit(ps)
    key = jax.random.PRNGKey(5)
    total = np.zeros(tp.N_STATS, np.int64)
    for i in range(BLOCKS):
        bkey = jax.random.fold_in(key, i)
        jc, js = jrun(jc, bkey)
        pc, pstats = prun.run_draws(pc, *ttd._block_draws(bkey, cpb, w))
        assert np.array_equal(np.asarray(js), pstats.numpy()), i
        total += pstats.numpy().sum(0)
    jout = jdrain(jc)
    pout = pdrain(pc, payload=ttd._drain_payload(w))
    assert np.array_equal(np.asarray(jout[1]), pout[1].numpy())
    total += pout[1].numpy().sum(0)
    _assert_same_stacked(jout[0], pout[0])
    _assert_replicas_identical(pout[0])
    _no_lock_held(pout[0])
    assert _closes(total) and total[tp.STAT_MAGIC_BAD] == 0
    assert total[tp.STAT_ATTEMPTED] == BLOCKS * cpb * w
    if monitor:
        # bit-identical but for the reject split, which JAX's generic
        # engine leaves at 0 and the port's fills (held + arb == rejected)
        split = [mon.CTR_LOCK_REJECT_HELD, mon.CTR_LOCK_REJECT_ARB]
        jbuf = np.asarray(jout[2].buf)
        pbuf = convert.counters_to_numpy(pout[2])
        assert np.array_equal(np.delete(jbuf, split),
                              np.delete(pbuf, split))
        assert not jbuf[split].any()
        snap = mon.snapshot(pout[2])
        assert snap["lock_rejected"] == (snap["lock_reject_held"]
                                         + snap["lock_reject_arb"])
        assert snap["lock_reject_held"] > 0 and snap["lock_reject_arb"] > 0
        assert snap["txn_committed"] == total[tp.STAT_COMMITTED]
        assert snap["ab_validate"] == total[tp.STAT_AB_VALIDATE] > 0
        assert total[tp.STAT_AB_LOCK] > 0
        jsnap = jmon.snapshot(jout[2])
        assert {k: v for k, v in jsnap.items() if "reject_" not in k} == \
            {k: v for k, v in snap.items() if "reject_" not in k}




def test_runner_draws_its_own_and_checks_shapes():
    n_sub, w = 200, 32
    ps, _ = ptc.populate_shards(np.random.default_rng(7), n_sub,
                                val_words=VW, log_capacity=LOG_CAP,
                                device="cpu")
    run, init, drain = tp.build_pipelined_runner(
        n_sub, w=w, val_words=VW, cohorts_per_block=2, device="cpu")
    carry, stats = run(init(ps), torch.Generator().manual_seed(1))
    ps, tail = drain(carry)
    total = (stats.sum(0) + tail.sum(0)).numpy()
    assert _closes(total) and total[tp.STAT_COMMITTED] > 0
    with pytest.raises(ValueError):
        run.run_draws(carry, torch.zeros((1, w, 4), dtype=torch.int32),
                      torch.zeros((1, w, 2), dtype=torch.int32))
    with pytest.raises(ValueError):
        init(ps[:2])
