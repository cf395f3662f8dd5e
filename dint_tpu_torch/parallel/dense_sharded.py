"""Sharded dense TATP: partitioned subscribers with replication to two
backups (the port of `dint_tpu.parallel.dense_sharded`).

Every TATP table is keyed by the subscriber id (tatp/caladan/tatp.h:28),
so partitioning by SUBSCRIBER keeps every transaction on its shard; what
crosses shards is the replication the reference pays too:

* shard d runs the single-chip pipelined step (`tatp_dense.pipe_step`) on
  its own subscriber range, with its own draws, locks and validation;
* each step's install record (`tatp_dense.Installs`) goes to shards d+1
  and d+2 (`Mesh.ppermute`), which apply it to their backup copies of
  shard d's rows (the reference's CommitBck x2,
  client_ebpf_shard.cc:812-860);
* the receivers also append the record to their own log rings, tagged
  ``key_hi = source + 1``, so every write is logged on 3 shards (CommitLog
  x3, :779-810): each shard's ring holds one replica (``log_replicas=1``);
* the per-step stats are summed over the mesh (`Mesh.psum`).

Backups hold val and ver:exists in the interleaved 1-D layout, two slots
of ``n1`` rows (slot 0 shard d-1's rows, slot 1 d-2's, each with a zero
sentinel row); locks are primary-side state only.

The mesh is a list of shards, each on its partition's device (`mesh.py`:
one card a shard, or several shards sharing one), driven phase by phase
from one thread, so the order of work within a step is explicit: every
shard's `pipe_step` first, then hop 1 applied on every shard, then hop 2,
as JAX's program orders them on each device. A hop's record reaches its
receiver's card inside `Mesh.ppermute`; nothing else crosses cards. A
shard's log sees its own append, the hop-1 record and then the hop-2
record. The backup installs and the log appends are plain torch writes,
as JAX's are XLA scatters outside any Pallas kernel; each shard's
`pipe_step` launches its route's kernels.

What differs from JAX: the draws come in from outside (``run.run_draws``,
on any device: partition p's slice is copied to its card), the states
are updated in place, and the step counter is a host int a shard (all
shards advance in lockstep).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..engines import tatp_dense as td
from ..engines.tatp_pipeline import draw_bits
from ..monitor import counters as mon
from ..monitor import waves
from ..tables import log as logring
from .mesh import Mesh
from .sharded import SHARD_AXIS, make_mesh  # noqa: F401 (re-exported)

I32 = torch.int32

N_BCK = 2      # backup copies of each row range (reference: 3 replicas in all)


@dataclass
class ShardState:
    """One partition: a single-chip DenseDB over its subscriber range and
    tight backup copies of the two predecessors' ranges (slot 0 = d-1's
    rows, slot 1 = d-2's)."""
    db: td.DenseDB
    bck_val: torch.Tensor    # i32 [N_BCK * n1 * VW]  interleaved words
    bck_meta: torch.Tensor   # i32 [N_BCK * n1]       ver<<1 | exists


def n_sub_local(n_sub_global: int, n_shards: int) -> int:
    return (n_sub_global + n_shards - 1) // n_shards


def _with_backups(mesh: Mesh, axis: str, dbs: list) -> list:
    """The partitions' states from their populated DBs (flat mesh order,
    partition p's on ``mesh.device_of(p)``): partition p's backup slot
    ``off - 1`` starts as a copy of the partition ``off`` behind it along
    ``axis`` (its val and meta without the sentinel row, then one zero
    sentinel row), on p's device. The backups are fresh tensors, never
    views of a primary."""
    vw = dbs[0].val_words
    prims = [(db.val[:-vw], db.meta[:-1]) for db in dbs]
    srcs = {off: mesh.ppermute(prims, axis, off) for off in (1, 2)}
    out = []
    for p, db in enumerate(dbs):
        zv = db.val.new_zeros(vw)
        zm = db.meta.new_zeros(1)
        out.append(ShardState(
            db=db,
            bck_val=torch.cat([srcs[1][p][0], zv, srcs[2][p][0], zv]),
            bck_meta=torch.cat([srcs[1][p][1], zm, srcs[2][p][1], zm])))
    return out


def create_sharded(mesh: Mesh, n_shards: int, n_sub_global: int,
                   val_words: int = 10, seed: int = 0, **kw) -> list:
    """One `ShardState` a partition on its partition's device. Shard d's
    tables are `tatp_dense.populate(np.random.default_rng(seed + d),
    n_loc, log_replicas=1)`, bit-identical to JAX's (reference populate,
    client_ebpf_shard.cc:96-341); its backups start as its predecessors'
    populated rows."""
    if n_shards != mesh.size:
        raise ValueError(f"n_shards={n_shards} on a mesh of {mesh.size}")
    n_loc = n_sub_local(n_sub_global, n_shards)
    # log_replicas=1: the 3 log copies live on 3 shards (each receiver
    # appends the forwarded installs), not packed a slot
    dbs = [td.populate(np.random.default_rng(seed + d), n_loc,
                       val_words=val_words, log_replicas=1,
                       device=mesh.device_of(d), **kw)
           for d in range(n_shards)]
    return _with_backups(mesh, SHARD_AXIS, dbs)


def _apply_backup(state: ShardState, inst: td.Installs, slot: int, n1: int,
                  val_words: int, src_dev: int) -> ShardState:
    """Install a forwarded record into backup slot ``slot`` and log it
    locally (the backup server's COMMIT_BCK + COMMIT_LOG handling,
    tatp/ebpf/shard_kern.c:659-939), in place. Masked lanes are filtered
    out before the writes; the kept rows are unique (one X-holder a row at
    the source). Entries log ``key_hi = src_dev + 1``: 1-based, so a
    shard's own entries (key_hi 0) never collide with shard 0's, and a
    ring that mixes three shards' entries stays separable for recovery
    (recovery.recover_tatp_dense with key_hi_filter)."""
    keep = torch.nonzero(inst.wmask).squeeze(1)
    rows = slot * n1 + inst.rows[keep].to(torch.int64)
    state.bck_meta[rows] = inst.meta[keep]
    flat = (rows[:, None] * val_words
            + torch.arange(val_words, device=rows.device)).reshape(-1)
    state.bck_val[flat] = inst.val[keep].reshape(-1)
    src = torch.full_like(inst.key, src_dev + 1)
    logring.append_rep(state.db.log, inst.wmask, inst.tbl, inst.is_del, src,
                       inst.key, inst.ver, inst.val)
    return state


def _runner(mesh: Mesh, axis: str, n_sub_global: int, w: int,
            val_words: int, cohorts_per_block: int, mix, use_fused: bool,
            monitor: bool):
    """The (run, init, drain) of `build_sharded_pipelined_runner` over any
    mesh, replicating along ``axis`` (multihost.py's runner takes
    ``"dcn"``)."""
    if 2 * w > (1 << td.K_ARB):
        raise ValueError(f"w={w} exceeds the arb slot field")
    home, devs = mesh.device, mesh.devices
    n_parts, cpb = mesh.size, cohorts_per_block
    n_loc = n_sub_local(n_sub_global, n_parts)
    n1 = td.n_rows(n_loc) + 1
    # the step's device constants, once a card
    kws = [dict(w=w, n_sub=n_loc, val_words=val_words, mix=mix,
                use_fused=use_fused, emit_installs=True, consts=c)
           for c in mesh.per_partition(
               lambda d: td.step_consts(n_loc, w, mix, d))]

    def step(carry, bits, payload, gen_new=True):
        # every shard's local step first, then each hop on every shard:
        # a shard applies what its predecessors emitted THIS step
        states, c1s, c2s = carry[:3]
        cnts = carry[3] if monitor else [None] * n_parts
        insts, stats, new_c1, new_c2 = [], [], [], []
        for p in range(n_parts):
            out = td.pipe_step(states[p].db, c1s[p], c2s[p],
                               mesh.to_partition(bits[p], p) if gen_new
                               else None, mesh.to_partition(payload[p], p),
                               gen_new=gen_new, counters=cnts[p], **kws[p])
            _, new_ctx, c1, s, inst = out[:5]
            new_c1.append(new_ctx)
            new_c2.append(c1)
            stats.append(s)
            insts.append(inst)
        # CommitBck + CommitLog fan-out: shard p applies the records of
        # p-1 (hop 1, backup slot 0) and p-2 (hop 2, slot 1) along axis
        with waves.scope("dense_sharded", "replicate"):
            for off in (1, 2):
                fwd = mesh.ppermute(insts, axis, off)
                hop = (mon.CTR_REPL_PUSH_HOP1 if off == 1
                       else mon.CTR_REPL_PUSH_HOP2)
                for p in range(n_parts):
                    if monitor:
                        # replication pushes, counted where they are
                        # applied (the receiving backup)
                        mon.bump(cnts[p],
                                 {hop: fwd[p].wmask.sum(dtype=I32)})
                    _apply_backup(states[p], fwd[p], off - 1, n1, val_words,
                                  mesh.shift(p, axis, -off))
        return (states, new_c1, new_c2) + carry[3:], mesh.psum(stats)

    def run_draws(carry, bits, payload):
        want_b, want_p = (cpb, n_parts, w, 4), (cpb, n_parts, w, 2)
        if tuple(bits.shape) != want_b or tuple(payload.shape) != want_p:
            raise ValueError(f"expected bits {list(want_b)} and payload "
                             f"{list(want_p)}, got {tuple(bits.shape)} and "
                             f"{tuple(payload.shape)}")
        for st in carry[0]:
            if st.db.step >= td.REBASE_AT:
                td.rebase_stamps(st.db)
        stats = []
        for i in range(cpb):
            carry, s = step(carry, bits[i], payload[i])
            stats.append(s)
        return carry, torch.stack(stats)

    def run(carry, gen: torch.Generator):
        # one block's draws on the home device, so a seed gives the same
        # draws whatever the placement
        with waves.scope("tatp_dense", "gen"):
            bits = draw_bits(gen, (cpb, n_parts, w, 4), home)
            payload = torch.randint(0, 1 << 16, (cpb, n_parts, w, 2),
                                    dtype=I32, generator=gen, device=home)
        return run_draws(carry, bits, payload)

    run.run_draws = run_draws

    def init(states: list):
        if len(states) != n_parts:
            raise ValueError(f"{len(states)} states for {n_parts} "
                             f"partitions")
        for p, st in enumerate(states):
            if st.db.meta.device != devs[p]:
                raise ValueError(f"partition {p}'s tables on "
                                 f"{st.db.meta.device}, its mesh device "
                                 f"{devs[p]}")
        ctxs = [[td.empty_ctx(w, d) for d in devs] for _ in range(2)]
        return ((list(states), *ctxs)
                + (([mon.create(d) for d in devs],) if monitor else ()))

    def drain(carry, payload=None):
        if payload is None:
            g = torch.Generator(device=home)
            g.manual_seed(0)
            payload = torch.randint(0, 1 << 16, (2, n_parts, w, 2),
                                    dtype=I32, generator=g, device=home)
        carry, s1 = step(carry, None, payload[0], gen_new=False)
        carry, s2 = step(carry, None, payload[1], gen_new=False)
        return (carry[0], torch.stack([s1, s2])) + carry[3:]

    return run, init, drain


def build_sharded_pipelined_runner(mesh: Mesh, n_shards: int,
                                   n_sub_global: int, w: int = 4096,
                                   val_words: int = 10,
                                   cohorts_per_block: int = 8, mix=None,
                                   use_fused: bool = False,
                                   monitor: bool = False):
    """A loop of the shards' `pipe_step` plus the replication fan-out; the
    contract of the single-chip runner (`tatp_dense.build_pipelined_runner`)
    over lists, one entry a partition:

    * ``run(carry, gen)`` draws a block's bits [cpb, D, w, 4] and payloads
      [cpb, D, w, 2] with the torch generator ``gen`` on the mesh's home
      device and calls ``run.run_draws``;
    * ``run.run_draws(carry, bits, payload)`` runs ``cohorts_per_block``
      steps on the given draws (partition d's step i takes ``bits[i, d]``,
      copied to its card,
      where JAX's takes ``fold_in(split(block_key, cpb)[i], d)``) and
      returns (carry, stats i32 [cpb, N_STATS] summed over the shards, on
      the home device); at
      the start of a block each shard rebases its arb stamps once its step
      counter has reached REBASE_AT;
    * ``init(states)`` -> carry (states, c1s, c2s[, counters]) with two
      empty in-flight cohorts a shard;
    * ``drain(carry, payload=None)`` runs the two flush steps and returns
      (states, stats [2, N_STATS][, counters]); ``payload`` [2, D, w, 2]
      (drawn from a generator seeded 0 when None; JAX's shard d draws
      from ``fold_in(PRNGKey(0), d)`` and then ``fold_in(fold_in(
      PRNGKey(0), 1), d)``).

    ``use_fused``: each shard's step takes the fused route (lock_validate
    + install_log, with this path's ``log_replicas=1`` log stream); the
    fan-out is the same. ``monitor``: each shard bumps its own
    `monitor.counters.Counters` (the carry's last entry, a list), with the
    replication hops counted at the receiving shard;
    ``monitor.counters.snapshot`` sums their stacked buffers."""
    if n_shards != mesh.size:
        raise ValueError(f"n_shards={n_shards} on a mesh of {mesh.size}")
    return _runner(mesh, SHARD_AXIS, n_sub_global, w, val_words,
                   cohorts_per_block, mix, use_fused, monitor)
