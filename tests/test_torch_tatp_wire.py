"""The port's TATP coordinator over the wire (dint_tpu_torch.clients.
tatp_wire: `serve_shards`, `WireCoordinator`, `_OP2WIRE`/`_WIRE2REP`) on
the CPU, against JAX's maps and against the host coordinator.

A wave of distinct (table, key) lanes sent over loopback UDP to three
pumps answers what `tatp_client.Coordinator._run_wave` answers over
identical replicas: the lanes of distinct rows do not interact, so how the
pumps batch them cannot change a reply. Then the twins of
tests/test_shim.py's whole-transaction case (three cohorts, the taxonomy
closes, no timeout) and of its dead-port case."""
import socket

import numpy as np
import pytest

from dint_tpu.clients import tatp_wire as jtw
from dint_tpu_torch import convert
from dint_tpu_torch.clients import tatp_client as tc
from dint_tpu_torch.clients import tatp_wire as tw
from dint_tpu_torch.engines import tatp
from dint_tpu_torch.engines.types import Op, Reply
from dint_tpu_torch.shim import TATP, EnginePump

from test_torch_lock_engines import assert_same

LOG = dict(log_lanes=4, log_capacity=1 << 12)


def test_wire_maps_equal_jax():
    assert tw._OP2WIRE.dtype == jtw._OP2WIRE.dtype
    assert np.array_equal(tw._OP2WIRE, jtw._OP2WIRE)
    assert tw._WIRE2REP.dtype == jtw._WIRE2REP.dtype
    assert np.array_equal(tw._WIRE2REP, jtw._WIRE2REP)
    assert tw._CHUNK == jtw._CHUNK == 256
    # the maps invert each other on every defined code
    for w in range(64):
        op = TATP.req_map[w]
        if op != Op.NOP:
            assert tw._OP2WIRE[op] == w
            for r in range(TATP.rep_map.shape[1]):
                if TATP.rep_map[w, r] >= 0:
                    assert tw._WIRE2REP[w, TATP.rep_map[w, r]] == r


def _distinct_wave(rng, n_sub, n):
    """n lanes of distinct (table, key): reads over all five tables, locks
    and installs on the dense tables; no log lane (the ring's order would
    follow the batching) and no CF lock (CF lock slots are hashed)."""
    p1 = n_sub + 1
    rows = {tatp.SUBSCRIBER: p1, tatp.SEC_SUBSCRIBER: p1,
            tatp.ACCESS_INFO: 4 * p1, tatp.SPECIAL_FACILITY: 4 * p1}
    lanes = []
    for tb, nrow in rows.items():
        keys = rng.choice(np.arange(1, nrow), n // 5, replace=False)
        ops = rng.choice([Op.OCC_READ, Op.OCC_LOCK, Op.COMMIT_BCK,
                          Op.COMMIT_PRIM], len(keys))
        lanes += [(o, tb, k) for o, k in zip(ops, keys)]
    cf = np.unique(tatp.cf_key(rng.integers(1, p1, n // 5),
                               rng.integers(1, 5, n // 5),
                               8 * rng.integers(0, 3, n // 5)))
    lanes += [(Op.OCC_READ, tatp.CALL_FORWARDING, k) for k in cf]
    lanes = [lanes[i] for i in rng.permutation(len(lanes))]
    ops = np.array([x[0] for x in lanes], np.int32)
    tbls = np.array([x[1] for x in lanes], np.int32)
    keys = np.array([x[2] for x in lanes], np.int64)
    vals = rng.integers(0, 1 << 32, (len(lanes), 10), dtype=np.uint64)
    vers = rng.integers(0, 8, len(lanes)).astype(np.uint32)
    return ops, tbls, keys, vals.astype(np.uint32), vers


def test_distinct_wave_over_the_wire_equals_host_coordinator():
    n_sub = 400
    wire_shards, _ = tc.populate_shards(np.random.default_rng(0), n_sub,
                                        device="cpu", **LOG)
    host_shards, _ = tc.populate_shards(np.random.default_rng(0), n_sub,
                                        device="cpu", **LOG)
    host = tc.Coordinator(host_shards, n_sub, width=2048, device="cpu")
    rng = np.random.default_rng(5)
    waves = [_distinct_wave(rng, n_sub, 1500) for _ in range(2)]
    pumps = [EnginePump(TATP, tatp.step, s, width=256, flush_us=500,
                        device="cpu").start() for s in wire_shards]
    try:
        with tw.WireCoordinator([p.port for p in pumps], n_sub, width=256,
                                n_socks=3) as wire:
            for ops, tbls, keys, vals, vers in waves:
                assert min(np.bincount(keys % 3)) > tw._CHUNK
                got = wire._run_wave(ops, tbls, keys, vals=vals, vers=vers)
                want = host._run_wave(ops, tbls, keys, vals=vals, vers=vers)
                for g, h in zip(got, want):
                    assert g.dtype == h.dtype and np.array_equal(g, h)
                assert (got[0] != Reply.NONE).all()
                assert {Reply.VAL, Reply.GRANT, Reply.ACK} <= set(got[0])
            assert wire.stats.timeout_lanes == 0
    finally:
        for p in pumps:
            p.close()
    assert all(p.batches_served > 3 for p in pumps)
    for p, h in zip(pumps, host.shards):
        assert_same(convert.tree_to_numpy(h), convert.tree_to_numpy(p.state))


def test_tatp_full_transactions_over_wire():
    """Three cohorts of whole transactions (read+lock, validate, log x3,
    bck x2, prim, abort) against three UDP shard servers."""
    with tw.serve_shards(200, width=256, flush_us=1000, device="cpu",
                         **LOG) as ports:
        with tw.WireCoordinator(ports, 200, width=256) as coord:
            rng = np.random.default_rng(0)
            for _ in range(3):
                coord.run_cohort(rng, 64)
            st = coord.stats
    assert st.attempted == 3 * 64
    assert (st.committed + st.aborted_lock + st.aborted_validate
            + st.aborted_missing + st.aborted_timeout) == st.attempted
    assert st.aborted_timeout == 0 and st.timeout_lanes == 0
    assert st.committed > st.attempted * 0.45
    assert st.lock_cnt == st.reject_sharing_cnt == st.reject_same_key_cnt \
        == 0


def test_tatp_wire_timeout_counts_not_raises():
    """Servers that never answer give a number and a timeout count, not a
    void run."""
    socks = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
             for _ in range(3)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    try:
        with tw.WireCoordinator(ports, 200, width=256, timeout_ms=50,
                                max_tries=2) as coord:
            st = coord.run_cohort(np.random.default_rng(0), 32)
    finally:
        for s in socks:
            s.close()
    assert st.attempted == 32 and st.committed == 0
    assert st.aborted_timeout == 32
    assert st.timeout_lanes > 0
    assert st.aborted_lock + st.aborted_validate + st.aborted_missing == 0


def test_serve_shards_needs_a_card_by_default():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with tw.serve_shards(10):
            pass
