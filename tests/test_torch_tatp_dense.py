"""The port's dense TATP pipeline (dint_tpu_torch) against
`dint_tpu.engines.tatp_dense` on the CPU.

Both engines start from the same populated tables (carried across with
dint_tpu_torch.convert) and consume the same random draws: the JAX runner
makes them with `jax.random` inside its block, and the test replays those
exact draws into the port's ``run.run_draws``/``drain``. Every comparison
is bit-exact: tables, arb stamps, step, log entries and heads, and the
per-step stats. The JAX runner takes its XLA route, which
tests/test_pallas_ops.py pins bit-identical to the Pallas route the port
mirrors."""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dint_tpu.engines import tatp_dense as jtd
from dint_tpu.engines import tatp_pipeline as jtp
from dint_tpu_torch import convert, entry, serve
from dint_tpu_torch.clients import smallbank_client, tatp_client
from dint_tpu_torch.engines import tatp_dense as td
from dint_tpu_torch.engines import tatp_pipeline as tp
from dint_tpu_torch.ops import u32
from dint_tpu_torch.parallel import (dense_sharded, dense_sharded_sb, multihost,
                                     sharded)

REPO = Path(__file__).resolve().parent.parent
VW = 4
LOG_CAP = 64     # small ring: the runs below wrap it
CONTENTION_MIX = np.array([0, 0, 0, 50, 0, 50, 0], np.float64) / 100.0

# (n_sub, w, cohorts_per_block, mix): default mix, and the US/IC-heavy
# contention mix over a tiny keyspace of tests/test_tatp_dense.py
DEFAULT = (2000, 64, 2, None)
CONTENTION = (32, 256, 2, CONTENTION_MIX)


def _jax_arrays(db) -> dict:
    return {"val": np.asarray(db.val), "meta": np.asarray(db.meta),
            "arb": np.asarray(db.arb), "step": np.asarray(db.step),
            "log.entries": np.asarray(db.log.entries),
            "log.head": np.asarray(db.log.head),
            "val_words": db.val_words, "lanes": db.log.lanes,
            "replicas": db.log.replicas}


def _assert_same_db(jarrays: dict, pdb):
    parrays = convert.dense_db_to_numpy(pdb)
    assert parrays.keys() == jarrays.keys()
    for k, v in jarrays.items():
        assert np.array_equal(np.asarray(v), np.asarray(parrays[k])), k


def _step_draws(step_key, w):
    """The two draws of one JAX pipe_step (tatp_dense.py:476,501 and
    tatp_pipeline.py:105)."""
    kg, kv3 = jax.random.split(step_key)
    return (np.asarray(jax.random.bits(kg, (w, 4), jnp.uint32)),
            np.asarray(jax.random.randint(kv3, (w, 2), 0, 1 << 16,
                                          dtype=jnp.int32)))


def _block_draws(block_key, cpb, w):
    """The JAX runner's block: step keys = split(block_key, cpb)."""
    draws = [_step_draws(k, w) for k in jax.random.split(block_key, cpb)]
    return (u32.from_numpy(np.stack([d[0] for d in draws]), "cpu"),
            torch.from_numpy(np.stack([d[1] for d in draws])))


def _drain_payload(w):
    """JAX's drain draws both steps' payloads from PRNGKey(0)."""
    _, payload = _step_draws(jax.random.PRNGKey(0), w)
    return torch.from_numpy(np.stack([payload, payload]))


@pytest.fixture(scope="module")
def jax_runners():
    """One JAX runner per configuration, built once for the file."""
    return {cfg[:2]: jtd.build_pipelined_runner(
        cfg[0], w=cfg[1], val_words=VW, cohorts_per_block=cfg[2],
        mix=cfg[3], use_pallas=False, use_fused=False)
        for cfg in (DEFAULT, CONTENTION)}


def _run_both(jax_runners, cfg, blocks, seed, step0=None):
    n_sub, w, cpb, mix = cfg
    jdb = jtd.populate(np.random.default_rng(seed), n_sub, val_words=VW,
                       log_capacity=LOG_CAP)
    if step0 is not None:
        jdb = jdb.replace(step=jnp.asarray(step0, jnp.uint32))
    pdb = convert.dense_db_from_numpy(_jax_arrays(jdb), "cpu")
    jrun, jinit, jdrain = jax_runners[cfg[:2]]
    prun, pinit, pdrain = td.build_pipelined_runner(
        n_sub, w=w, val_words=VW, cohorts_per_block=cpb, mix=mix,
        device="cpu")
    jc, pc = jinit(jdb), pinit(pdb)
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


def _closes(total):
    return (total[td.STAT_COMMITTED] + total[td.STAT_AB_LOCK]
            + total[td.STAT_AB_MISSING] + total[td.STAT_AB_VALIDATE]
            == total[td.STAT_ATTEMPTED])


def test_slice_bit_identical_default_mix(jax_runners):
    pdb, total = _run_both(jax_runners, DEFAULT, blocks=4, seed=0)
    assert total[td.STAT_ATTEMPTED] == 4 * 2 * 64
    assert total[td.STAT_COMMITTED] > 0 and _closes(total)
    assert total[td.STAT_MAGIC_BAD] == 0
    assert not pdb.locked.any()


def test_slice_bit_identical_contention_mix(jax_runners):
    pdb, total = _run_both(jax_runners, CONTENTION, blocks=4, seed=1)
    assert total[td.STAT_AB_LOCK] > 0           # conflicts really fired
    assert total[td.STAT_AB_VALIDATE] > 0
    assert _closes(total)


def test_slice_bit_identical_across_stamp_rebase(jax_runners):
    """Start one step short of REBASE_AT: block 0 runs unrebased with
    stamps >= 2^31, block 1 starts with rebase_stamps."""
    pdb, total = _run_both(jax_runners, DEFAULT, blocks=3, seed=2,
                           step0=td.REBASE_AT - 1)
    assert pdb.step == 3 + 2 * 2 + 2            # rebased once, then 4+2 steps
    assert _closes(total)


def test_rebase_stamps_matches_jax():
    n_sub = 8
    t = td.REBASE_AT + 7
    arb = np.zeros(td.n_rows(n_sub) + 1, np.uint32)
    arb[3] = ((t - 1) << td.K_ARB) | 11       # held
    arb[5] = ((t - 2) << td.K_ARB) | 22       # expiring
    arb[7] = ((t - 3) << td.K_ARB) | 33       # stale
    arb[9] = (2 << td.K_ARB) | 1              # ancient
    jdb = jtd.populate(np.random.default_rng(0), n_sub, val_words=VW,
                       log_capacity=LOG_CAP)
    jdb = jdb.replace(arb=jnp.asarray(arb), step=jnp.asarray(t, jnp.uint32))
    pdb = convert.dense_db_from_numpy(_jax_arrays(jdb), "cpu")
    held = pdb.locked.clone()
    td.rebase_stamps(pdb)
    _assert_same_db(_jax_arrays(jtd.rebase_stamps(jdb)), pdb)
    assert torch.equal(pdb.locked, held)


# ------------------------------------------------------ module-level parity


@pytest.mark.parametrize("mix", [None, CONTENTION_MIX,
                                 np.array([1, 0, 0, 0, 0, 0, 0], float)])
def test_gen_cohort_from_bits_matches_jax(mix):
    w, n_sub = 512, 1000
    kg = jax.random.PRNGKey(17)
    want = jtp.gen_cohort(kg, w, n_sub, mix=mix)
    bits = u32.from_numpy(np.asarray(jax.random.bits(kg, (w, 4), jnp.uint32)),
                          "cpu")
    got = tp.gen_cohort_from_bits(bits, w, n_sub, mix=mix)
    flat_w, flat_g = jax.tree.leaves(want), [got[0], got[1], got[2], got[3],
                                             *got[4]]
    assert len(flat_w) == len(flat_g)
    for a, b in zip(flat_w, flat_g):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_classify_wave1_matches_jax():
    from dint_tpu.engines.types import Reply
    r = np.random.default_rng(4)
    w = 300
    ttype = r.integers(0, 7, w).astype(np.int32)
    rt = r.choice([Reply.NONE, Reply.GRANT, Reply.REJECT, Reply.NOT_EXIST,
                   Reply.VAL, Reply.REJECT_SAME_KEY], (w, tp.K)).astype(np.int32)
    ops = r.choice([0, 16, 17], (w, tp.K)).astype(np.int32)
    ws_active = r.random((w, 2)) < 0.5
    ws_lane = r.integers(1, 4, (w, 2)).astype(np.int32)
    ws_rt = r.choice([0, 1, 2, 8], (w, 2)).astype(np.int32)
    args = (ttype, rt, ops, ws_active, ws_lane)
    for extra in ((), (ws_rt,)):
        want = jtp.classify_wave1(*[jnp.asarray(a) for a in args + extra])
        got = tp.classify_wave1(*[torch.from_numpy(a) for a in args + extra])
        for a, b in zip(want, got):
            assert np.array_equal(np.asarray(a), b.numpy())


def test_populate_bit_identical():
    kw = dict(val_words=VW, log_capacity=LOG_CAP)
    jdb = jtd.populate(np.random.default_rng(5), 300, **kw)
    pdb = td.populate(np.random.default_rng(5), 300, device="cpu", **kw)
    _assert_same_db(_jax_arrays(jdb), pdb)


def test_populate_device_matches_population_rules():
    """The counterpart of tests/test_tatp_dense.py's populate_device test,
    with a torch generator: subscribers all present, ai/sf ~0.625 with >=1
    per subscriber, CF ~25% of present sf slots, payload/magic/meta wiring
    as in populate; then the engine runs clean on it."""
    n_sub = 500
    p1 = n_sub + 1
    gen = torch.Generator().manual_seed(0)
    db = td.populate_device(gen, n_sub, val_words=VW, device="cpu",
                            log_capacity=LOG_CAP)
    ex = db.exists.numpy()
    meta = u32.to_numpy(db.meta)
    val = u32.to_numpy(db.val).reshape(-1, VW)
    base = td._bases(p1)
    assert ex[base[0] + 1: base[0] + p1].all() and not ex[0]
    assert ex[base[1] + 1: base[1] + p1].all() and not ex[base[1]]
    assert not ex[-1]
    sf = ex[base[3]:base[3] + 4 * p1].reshape(p1, 4)
    assert not sf[0].any()
    assert sf[1:].any(axis=1).all()
    assert 0.57 < sf[1:].mean() < 0.69
    cf = ex[base[4]:-1].reshape(p1, 4, 3)
    assert not cf[~sf].any()
    assert 0.19 < cf[sf].mean() < 0.31
    rows = np.nonzero(ex[:-1])[0]
    region = np.searchsorted(base, rows, side="right") - 1
    assert (val[rows, 0] == rows - base[region]).all()
    assert (val[rows, 1] == td.MAGIC).all()
    assert (meta[rows] >> 1 == 1).all()
    absent = np.nonzero(~ex[:-1])[0]
    assert (val[absent] == 0).all() and (meta[absent] == 0).all()

    run, init, drain = td.build_pipelined_runner(
        n_sub, w=64, val_words=VW, cohorts_per_block=2, device="cpu")
    carry, stats = run(init(db), torch.Generator().manual_seed(1))
    db, tail = drain(carry)
    total = (stats.sum(0) + tail.sum(0)).numpy()
    assert total[td.STAT_MAGIC_BAD] == 0 and total[td.STAT_COMMITTED] > 0
    assert _closes(total)


# ------------------------------------------------------------ device rules


def test_entry_points_without_device_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(0)
    calls = [lambda: td.create(4),
             lambda: td.populate(rng, 4),
             lambda: td.populate_device(None, 4),
             lambda: td.build_pipelined_runner(4, w=8),
             lambda: convert.dense_db_from_numpy({}),
             lambda: tatp_client.Coordinator([], 4),
             lambda: smallbank_client.Coordinator([]),
             lambda: smallbank_client.init_shards(4),
             lambda: serve.ServeEngine("tatp_dense", 4, plan=None),
             lambda: serve.ServeEngine("store", 4, plan=None),
             lambda: serve.cached_runner("tatp_dense", 4, w=8),
             lambda: sharded.make_mesh(4),
             lambda: multihost.make_mesh_2d(3, 2),
             lambda: dense_sharded.create_sharded(sharded.make_mesh(4), 4,
                                                  64),
             lambda: multihost.create_multihost(
                 multihost.make_mesh_2d(3, 2), 64),
             lambda: dense_sharded.build_sharded_pipelined_runner(
                 sharded.make_mesh(4), 4, 64, w=8),
             lambda: multihost.build_multihost_runner(
                 multihost.make_mesh_2d(3, 2), 64, w=8),
             lambda: dense_sharded_sb.create_sharded_sb(
                 sharded.make_mesh(4), 4, 64),
             lambda: dense_sharded_sb.build_sharded_sb_runner(
                 sharded.make_mesh(4), 4, 64, w=8),
             lambda: entry.dryrun_multichip(4)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


_FORBIDDEN = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|flax|dint_tpu)\b",
                        re.M)


def test_port_imports_no_jax_and_nothing_of_dint_tpu():
    sources = list((REPO / "dint_tpu_torch").rglob("*.py"))
    sources.append(REPO / "chip_smoke.py")
    for path in sources:
        assert not _FORBIDDEN.search(path.read_text()), path
    code = (
        "import sys, importlib, pkgutil\n"
        "for m in ('jax', 'jaxlib', 'flax'):\n"
        "    sys.modules[m] = None\n"
        "import dint_tpu_torch\n"
        "for m in pkgutil.walk_packages(dint_tpu_torch.__path__,\n"
        "                               'dint_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "importlib.import_module('chip_smoke')\n"
        "bad = [n for n in sys.modules\n"
        "       if n == 'dint_tpu' or n.startswith('dint_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
