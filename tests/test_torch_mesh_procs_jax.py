"""The port's 2-D mesh across processes (one gloo process a host, 3x2 over
3 ranks) against JAX's runners, on the CPU.

JAX runs `dint_tpu.parallel.multihost` (TATP) and `multihost_sb`
(SmallBank, hierarchical and flat) in this process over 6 of the 8
virtual CPU devices of tests/conftest.py; the port's ranks
(`testing.procs.launch`, spawned, no JAX in them) take JAX's draws (and
SmallBank's start state, each rank placing its own hosts' partitions) as
numpy inputs. Every comparison is bit-exact: each step's stats, every
partition's tables, backups, stamps, steps, log entries and heads, and
the monitored counters but for the dispatch pair. Each rank runs under
the partition audit, and rebuilds host 1's partitions from the ring of
host 2, which reaches it by one ppermute across ranks.
"""
import jax
import numpy as np
import pytest

from dint_tpu.parallel import multihost as jmh
from dint_tpu_torch.monitor import counters as mon
from dint_tpu_torch.testing import procs

import test_torch_multihost_sb as tmhs
from test_torch_dense_sharded import (LOG_CAP, VW, W, CPB, jax_state,
                                      mesh_block_draws, mesh_drain_payload)
from test_torch_lock_engines import assert_same

H, C = 3, 2
P = H * C
N_SUB = P * 128
BLOCKS = 2
RANKS = 3


def gathered(outs, n: int, lead) -> dict:
    """The ranks' per-partition state dicts (``p<p>/<key>``, leading [1])
    stacked into JAX's layout with the leading mesh shape ``lead``; the
    static ints as ints."""
    got = {}
    for arrays, _ in outs:
        got.update(arrays)
    keys = {k.split("/", 1)[1] for k in got if k.startswith("p0/")}
    out = {}
    for k in keys:
        if k == "counters":
            continue
        parts = [got[f"p{p}/{k}"] for p in range(n)]
        if parts[0].ndim == 0:
            assert all(int(x) == int(parts[0]) for x in parts), k
            out[k] = int(parts[0])
        else:
            st = np.concatenate(parts)
            out[k] = st.reshape(tuple(lead) + st.shape[1:])
    return out, got


def test_multihost_tatp_across_three_processes_bit_identical_to_jax():
    jmesh = jmh.make_mesh_2d(H, C)
    jstate = jmh.create_multihost(jmesh, N_SUB, val_words=VW, seed=3,
                                  log_capacity=LOG_CAP)
    jrun, jinit, jdrain = jmh.build_multihost_runner(
        jmesh, N_SUB, w=W, val_words=VW, cohorts_per_block=CPB)
    carry = jinit(jstate)
    key = jax.random.PRNGKey(3)
    inputs, stats = {}, []
    for i in range(BLOCKS):
        bkey = jax.random.fold_in(key, i)
        carry, s = jrun(carry, bkey)
        stats.append(np.asarray(s))
        bits, pay = mesh_block_draws(bkey, CPB, P, W)
        inputs[f"bits{i}"], inputs[f"second{i}"] = bits.numpy(), pay.numpy()
    inputs["drain"] = mesh_drain_payload(P, W).numpy()
    jout = jdrain(carry)
    stats.append(np.asarray(jout[1]))
    spec = dict(engine="multihost", shape=[H, C], n=N_SUB, w=W, cpb=CPB,
                vw=VW, log_cap=LOG_CAP, blocks=BLOCKS, seed=3,
                device="cpu", audit=True, recover=[1])
    outs = procs.launch("run", spec, RANKS, inputs=inputs, device="cpu")
    want = np.concatenate(stats)
    for arrays, rec in outs:
        assert np.array_equal(arrays["stats"], want)
        assert rec["audit_collectives"] > 0
    got, flat = gathered(outs, P, (H, C))
    assert_same(jax_state(jout[0]), got)
    # host 1's partitions rebuilt on their rank from host 2's ring
    for c in range(C):
        dead = 1 * C + c
        assert np.array_equal(flat[f"rec{dead}/val"], flat[f"p{dead}/db.val"][0])
        assert np.array_equal(flat[f"rec{dead}/meta"],
                              flat[f"p{dead}/db.meta"][0])
    assert want[:, 1].sum() > 0


@pytest.mark.parametrize("route", ["hier", "flat"])
def test_multihost_sb_across_three_processes_bit_identical_to_jax(route):
    shape = (H, C)
    ref = tmhs.jax_reference(shape, route)
    inputs = {f"state.{k}": np.asarray(v) for k, v in ref["start"].items()}
    for i in range(tmhs.BLOCKS):
        bits, amt = tmhs.block_draws(tmhs.block_key(i), n=P, w=tmhs.W,
                                     cpb=tmhs.CPB)
        inputs[f"bits{i}"], inputs[f"second{i}"] = bits.numpy(), amt.numpy()
    spec = dict(engine="multihost_sb", shape=list(shape), n=tmhs.N,
                w=tmhs.W, cpb=tmhs.CPB, log_cap=tmhs.LOG_CAP,
                blocks=tmhs.BLOCKS, state="inputs", device="cpu",
                route={"hierarchical": route == "hier", "monitor": True},
                audit=True, recover=[1])
    outs = procs.launch("run", spec, RANKS, inputs=inputs, device="cpu")
    want = np.concatenate(ref["stats"] + [ref["tail"]])
    for arrays, rec in outs:
        assert np.array_equal(arrays["stats"], want)
        assert rec["audit_collectives"] > 0
        assert rec["backend"] == "gloo" and len(rec["local"]) == C
    got, flat = gathered(outs, P, shape)
    assert_same(ref["end"], got)
    pbuf = np.stack([flat[f"p{p}/counters"] for p in range(P)])
    idx = mon.COUNTER_INDEX
    same = [i for i in range(mon.N_COUNTERS)
            if i not in (idx[k] for k in tmhs.DISPATCH)]
    assert np.array_equal(ref["counters"][:, same], pbuf[:, same])
    for c in range(C):
        dead = 1 * C + c
        assert np.array_equal(flat[f"rec{dead}/bal"], flat[f"p{dead}/bal"][0])
