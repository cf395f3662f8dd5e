"""The port's dense TATP kernel routes (dint_tpu_torch) against the JAX
package's `tatp_dense` on the same routes, on the CPU.

Each route (``use_hotset``, ``use_fused``, both) is held against the JAX
runner built with the same flags: the JAX runner draws with `jax.random`
inside its block and the test replays those draws into the port, as
tests/test_torch_tatp_dense.py does for the default route. Every
comparison is bit-exact: per-step stats, tables, arb stamps, step, log
entries and heads, and the hot mirrors. The JAX runner takes its XLA
gathers (``use_pallas=False``); its fused route runs the Pallas
`lock_validate` and `scatter_streams` kernels in interpret mode, which
tests/test_fused_ops.py pins bit-identical to the unfused route."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dint_tpu.engines import tatp_dense as jtd
from dint_tpu_torch import convert
from dint_tpu_torch.engines import tatp_dense as td

from test_torch_tatp_dense import (CONTENTION_MIX, LOG_CAP, VW, _block_draws,
                                   _closes, _drain_payload)

ROUTES = ("hotset", "fused", "fused+hotset")
# (n_sub, w, cohorts_per_block, mix, hot_frac): the default mix, and the
# contention mix over a tiny keyspace with half the subscribers hot
DEFAULT = (2000, 64, 2, None, None)
CONTENTION = (32, 256, 2, CONTENTION_MIX, 0.5)
CONFIGS = {"default": DEFAULT, "contention": CONTENTION}


def _jax_arrays(db) -> dict:
    out = {"val": np.asarray(db.val), "meta": np.asarray(db.meta),
           "arb": np.asarray(db.arb), "step": np.asarray(db.step),
           "log.entries": np.asarray(db.log.entries),
           "log.head": np.asarray(db.log.head),
           "val_words": db.val_words, "lanes": db.log.lanes,
           "replicas": db.log.replicas}
    if db.hot_meta is not None:
        out.update(hot_meta=np.asarray(db.hot_meta),
                   hot_val=np.asarray(db.hot_val), hot_n=db.hot_n)
    return out


def _assert_same_db(jarrays: dict, pdb):
    parrays = convert.dense_db_to_numpy(pdb)
    assert parrays.keys() == jarrays.keys()
    for k, v in jarrays.items():
        assert np.array_equal(np.asarray(v), np.asarray(parrays[k])), k


@pytest.fixture(scope="module")
def jax_runner():
    """The JAX runner of a (configuration, route), built once for the
    file."""
    cache = {}

    def get(name, route):
        if (name, route) not in cache:
            n_sub, w, cpb, mix, hot_frac = CONFIGS[name]
            use_hotset, use_fused = td.ROUTES[route]
            cache[name, route] = jtd.build_pipelined_runner(
                n_sub, w=w, val_words=VW, cohorts_per_block=cpb, mix=mix,
                use_pallas=False, use_hotset=use_hotset, hot_frac=hot_frac,
                use_fused=use_fused)
        return cache[name, route]
    return get


def _run_both(jax_runner, name, route, blocks, seed, step0=None):
    n_sub, w, cpb, mix, hot_frac = CONFIGS[name]
    use_hotset, use_fused = td.ROUTES[route]
    jdb = jtd.populate(np.random.default_rng(seed), n_sub, val_words=VW,
                       log_capacity=LOG_CAP)
    if step0 is not None:
        jdb = jdb.replace(step=jnp.asarray(step0, jnp.uint32))
    pdb = convert.dense_db_from_numpy(_jax_arrays(jdb), "cpu")
    jrun, jinit, jdrain = jax_runner(name, route)
    prun, pinit, pdrain = td.build_pipelined_runner(
        n_sub, w=w, val_words=VW, cohorts_per_block=cpb, mix=mix,
        use_hotset=use_hotset, hot_frac=hot_frac, use_fused=use_fused,
        device="cpu")
    jc, pc = jinit(jdb), pinit(pdb)
    _assert_same_db(_jax_arrays(jc[0]), pc[0])        # the attached mirrors
    total = np.zeros(td.N_STATS, np.int64)
    key = jax.random.PRNGKey(seed)
    for i in range(blocks):
        bkey = jax.random.fold_in(key, i)
        jc, js = jrun(jc, bkey)
        pc, ps = prun.run_draws(pc, *_block_draws(bkey, cpb, w))
        assert np.array_equal(np.asarray(js), ps.numpy()), i
        total += ps.numpy().sum(axis=0)
    jdb, jtail = jdrain(jc)
    pdb, ptail = pdrain(pc, payload=_drain_payload(w))
    assert np.array_equal(np.asarray(jtail), ptail.numpy())
    total += ptail.numpy().sum(axis=0)
    _assert_same_db(_jax_arrays(jdb), pdb)
    return pdb, total


def _mirrors_coherent(pdb):
    hn = pdb.hot_n
    return (torch.equal(pdb.hot_meta, pdb.meta[:hn])
            and torch.equal(pdb.hot_val, pdb.val[:hn * VW]))


@pytest.mark.parametrize("route", ROUTES)
def test_route_bit_identical_default_mix(jax_runner, route):
    pdb, total = _run_both(jax_runner, "default", route, blocks=3, seed=0)
    assert total[td.STAT_ATTEMPTED] == 3 * 2 * 64
    assert total[td.STAT_COMMITTED] > 0 and _closes(total)
    assert total[td.STAT_MAGIC_BAD] == 0
    assert not pdb.locked.any()
    if td.ROUTES[route][0]:
        assert pdb.hot_n == int(2001 * 0.04) and _mirrors_coherent(pdb)
    else:
        assert pdb.hot_meta is None and pdb.hot_n == 0


@pytest.mark.parametrize("route", ROUTES)
def test_route_bit_identical_contention_mix(jax_runner, route):
    pdb, total = _run_both(jax_runner, "contention", route, blocks=3,
                           seed=1)
    assert total[td.STAT_AB_LOCK] > 0           # conflicts really fired
    assert total[td.STAT_AB_VALIDATE] > 0
    assert _closes(total)
    if td.ROUTES[route][0]:
        assert pdb.hot_n == 16 and _mirrors_coherent(pdb)


def test_fused_hotset_bit_identical_across_stamp_rebase(jax_runner):
    """Start one step short of REBASE_AT: block 0 runs unrebased with
    stamps >= 2^31 through lock_validate, block 1 starts with
    rebase_stamps."""
    pdb, total = _run_both(jax_runner, "default", "fused+hotset", blocks=2,
                           seed=2, step0=td.REBASE_AT - 1)
    assert pdb.step == 3 + 2 + 2                # rebased once, then 2+2 steps
    assert _closes(total) and _mirrors_coherent(pdb)


def test_attach_hotset_matches_jax_and_copies():
    """The mirrors equal JAX's slices of the table prefix (clamped like
    JAX's), and are copies: a write to the table leaves them alone."""
    jdb = jtd.populate(np.random.default_rng(4), 50, val_words=VW,
                       log_capacity=LOG_CAP)
    pdb = convert.dense_db_from_numpy(_jax_arrays(jdb), "cpu")
    for hot_rows in (7, 0, 10**6):
        _assert_same_db(_jax_arrays(jtd.attach_hotset(jdb, hot_rows)),
                        td.attach_hotset(pdb, hot_rows))
    hdb = td.attach_hotset(pdb, 7)
    hdb.meta[0] = 12345
    hdb.val[0] = 12345
    assert int(hdb.hot_meta[0]) != 12345 and int(hdb.hot_val[0]) != 12345


def test_hot_route_needs_the_mirrors():
    db = td.create(20, val_words=VW, log_capacity=LOG_CAP, device="cpu")
    c = td.empty_ctx(8, "cpu")
    with pytest.raises(ValueError, match="attach_hotset"):
        td.pipe_step(db, c, c, None, torch.zeros((8, 2), dtype=torch.int32),
                     w=8, n_sub=20, val_words=VW, gen_new=False,
                     use_hotset=True)
