"""The port's twins of `__graft_entry__`: `entry()`, one dense TATP
pipeline step with example arguments, and `dryrun_multichip`, one run of
the sharded paths (TATP and SmallBank) on tiny shapes."""
from __future__ import annotations

import functools
import time

import numpy as np
import torch

from .device import resolve_device
from .engines import tatp_dense as td
from .engines.tatp_pipeline import draw_bits


def entry(device=None):
    """``(fn, args)``: ``fn(*args)`` is one `tatp_dense.pipe_step` (wave 1
    of a new cohort + validate + commit of the in-flight cohorts, all five
    tables, locks and the log x3) at n_sub=256, w=64, vw=10, on tables
    made by `populate` from ``np.random.default_rng(0)`` (the numpy draws
    JAX's `populate` makes). In place of JAX's ``PRNGKey(0)`` the step
    takes its draws, ``bits`` [64, 4] and ``payload`` [64, 2], from a torch
    generator seeded 0. ``device`` None means CUDA."""
    dev = resolve_device(device)
    n_sub, w, vw = 256, 64, 10
    db = td.populate(np.random.default_rng(0), n_sub, val_words=vw,
                     device=dev)
    fn = functools.partial(td.pipe_step, w=w, n_sub=n_sub, val_words=vw)
    gen = torch.Generator(device=dev).manual_seed(0)
    bits = draw_bits(gen, (w, 4), dev)
    payload = torch.randint(0, 1 << 16, (w, 2), dtype=torch.int32,
                            generator=gen, device=dev)
    return fn, (db, td.empty_ctx(w, dev), td.empty_ctx(w, dev), bits,
                payload)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """The sharded TATP paths over an in-process mesh of ``n_devices``
    partitions, on tiny shapes, each checked; prints a
    ``dryrun_multichip cards:`` line (the devices used) and then the
    ``dryrun_multichip ok:`` line, JAX's. With
    ``device`` None the partitions spread over the visible CUDA cards,
    one a partition where there are enough (as JAX's dry run takes
    ``jax.devices()[:n]``; `parallel.mesh.placement`), and it raises
    without a card; a ``device`` puts every partition on it.

    * the generic TATP shards (64 subscribers, VW 4): COMMIT_PRIM waves
      from `sharded.route_batches` through `build_sharded_step`, the
      psummed vote == the requests;
    * the generic SmallBank shards (65 accounts) the same way;
    * the dense sharded TATP runner (64 subscribers a shard, w = 32, 2
      cohorts a block, 2 blocks drawn from torch generators seeded 0 and
      1, then the drain): attempted == 2 * 2 * 32 * n, 0 < committed <=
      attempted;
    * the sharded dense SmallBank runner, cross-device transactions over
      `Mesh.all_to_all` (1024 accounts, w = 16, 2 cohorts a block, 2
      blocks drawn from torch generators seeded 10 and 11, then the
      drain): attempted == 2 * 2 * 16 * n, 0 < committed <= attempted,
      and the global balance moved by the summed STAT_BAL_DELTA mod 2^32.

    The generic shards' rings hold 2^12 entries a lane where
    `tatp.create` and `smallbank.create` default to 2^20: no wave here
    logs, so only the allocation differs."""
    from .engines import smallbank, tatp
    from .engines.types import Op
    from .parallel import dense_sharded as ds
    from .parallel import dense_sharded_sb as dsb
    from .parallel import sharded

    t0 = time.time()
    mesh = sharded.make_mesh(n_devices, device)
    dev = mesh.device                   # home: the psums, draws and totals
    vw = 4
    state = sharded.create_sharded_state(mesh, n_devices, 64, val_words=vw,
                                         cf_buckets=256, cf_lock_slots=256,
                                         log_capacity=1 << 12)
    step = sharded.build_sharded_step(mesh, n_devices)
    rng = np.random.default_rng(0)
    m = 4 * n_devices
    keys = rng.integers(1, 65, size=m).astype(np.int64)
    ops = np.full(m, Op.COMMIT_PRIM, np.int32)
    tbls = np.full(m, tatp.SUBSCRIBER, np.int32)
    waves, _ = sharded.route_batches(ops, tbls, keys, None, None, n_devices,
                                     width=8, val_words=vw,
                                     devices=mesh.devices)
    committed_total = 0
    for batch in waves:
        state, _, committed = step(state, batch)
        committed_total += int(committed[0])
    if committed_total != m:
        raise RuntimeError(f"tatp committed {committed_total} of {m}")

    # SmallBank over the same mesh machinery, sized 65 because the reused
    # TATP keys are 1-based and SmallBank accounts 0-based
    sb_state = sharded.create_sharded_smallbank(mesh, n_devices, 65,
                                                log_capacity=1 << 12)
    sb_step = sharded.build_sharded_step(mesh, n_devices, engine="smallbank")
    sb_tbls = np.full(m, smallbank.SAVINGS, np.int32)
    sb_vers = np.ones(m, np.uint32)     # client-supplied version
    sb_waves, _ = sharded.route_batches(ops, sb_tbls, keys, None, sb_vers,
                                        n_devices, width=8, val_words=2,
                                        devices=mesh.devices)
    sb_committed = 0
    for batch in sb_waves:
        sb_state, _, committed = sb_step(sb_state, batch)
        sb_committed += int(committed[0])
    if sb_committed != m:
        raise RuntimeError(f"smallbank committed {sb_committed} of {m}")

    # the flagship sharded path: dense pipelined TATP, installs forwarded
    # to the +1/+2 backups, stats summed over the mesh
    dstate = ds.create_sharded(mesh, n_devices, n_devices * 64,
                               val_words=vw)
    drun, dinit, ddrain = ds.build_sharded_pipelined_runner(
        mesh, n_devices, n_devices * 64, w=32, val_words=vw,
        cohorts_per_block=2)
    dcarry = dinit(dstate)
    total = torch.zeros(td.N_STATS, dtype=torch.int64, device=dev)
    for i in range(2):
        gen = torch.Generator(device=dev).manual_seed(i)
        dcarry, stats = drun(dcarry, gen)
        total += stats.sum(0)
    _, tail = ddrain(dcarry)
    total = (total + tail.sum(0)).tolist()
    att, com = total[td.STAT_ATTEMPTED], total[td.STAT_COMMITTED]
    if att != 2 * 2 * 32 * n_devices or not 0 < com <= att:
        raise RuntimeError(f"dense sharded TATP: attempted {att}, "
                           f"committed {com}")
    # cross-device transactions: dense SmallBank over all_to_all routing
    sbs = dsb.create_sharded_sb(mesh, n_devices, 1024)
    base = dsb.total_balance_global(sbs)
    srun, sinit, sdrain = dsb.build_sharded_sb_runner(
        mesh, n_devices, 1024, w=16, cohorts_per_block=2)
    scarry = sinit(sbs)
    stot = torch.zeros(dsb.N_STATS, dtype=torch.int64, device=dev)
    for i in range(2):
        gen = torch.Generator(device=dev).manual_seed(10 + i)
        scarry, stats = srun(scarry, gen)
        stot += stats.sum(0)
    sbs, tail = sdrain(scarry)
    stot = (stot + tail.sum(0)).tolist()
    sb_att, sb_com = stot[dsb.STAT_ATTEMPTED], stot[dsb.STAT_COMMITTED]
    if sb_att != 2 * 2 * 16 * n_devices or not 0 < sb_com <= sb_att:
        raise RuntimeError(f"dense sharded SmallBank: attempted {sb_att}, "
                           f"committed {sb_com}")
    final = dsb.total_balance_global(sbs)
    if (final - base) % (1 << 32) != stot[dsb.STAT_BAL_DELTA] % (1 << 32):
        raise RuntimeError(f"dense sharded SmallBank: balance moved by "
                           f"{final - base}, the stats say "
                           f"{stot[dsb.STAT_BAL_DELTA]}")

    rows = sharded.local_rows(65, n_devices)
    print("dryrun_multichip cards: "
          + ",".join(str(d) for d in mesh.cards), flush=True)
    print(f"dryrun_multichip ok: devices={n_devices} "
          f"tatp_local_rows={rows} tatp_committed={committed_total} "
          f"smallbank_committed={sb_committed} "
          f"dense_tatp_attempted={att} dense_tatp_committed={com} "
          f"dense_tatp_ab_lock={total[td.STAT_AB_LOCK]} "
          f"dense_tatp_ab_missing={total[td.STAT_AB_MISSING]} "
          f"dense_tatp_ab_validate={total[td.STAT_AB_VALIDATE]} "
          f"dense_sb_committed={sb_com} conservation_ok=True "
          f"wall_s={time.time() - t0:.1f}", flush=True)
