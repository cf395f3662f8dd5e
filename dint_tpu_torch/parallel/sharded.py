"""Sharded generic engines: a partitioned keyspace with primary-backup
replication over an in-process mesh (the port of
`dint_tpu.parallel.sharded`).

The reference's deployment (SURVEY.md §2.3): the keyspace is hashed over 3
servers (``shard = key % 3``, tatp/caladan/client_ebpf_shard.cc:636-641)
and every record lives on 3 servers: the primary ``key % n`` and backups
at +1 and +2 (CommitLog to all, CommitBck to the backups, CommitPrim to
the primary). Here the servers are the partitions of a `mesh.Mesh`:

* each shard holds 3 roles of its dense rows: role 0 the rows it owns,
  roles 1 and 2 replicas of shards d-1 and d-2, at local row
  ``(key // n) * 3 + role``; the sparse CF table keeps global keys;
* `route_batches` buckets requests by owner on the host, as the
  reference client groups its per-shard batches;
* `replicated_step` forwards each shard's prim ops to shards +1 and +2 as
  backup ops (one `Mesh.ppermute` of the batch list a hop) and runs
  ONE engine step a shard over the [3w] concatenation; the commit vote is
  summed over the mesh (`Mesh.psum`).

What differs from JAX: the shards and batches are lists, one entry a
partition on its partition's device (across processes, another rank's
entries None), and each step updates its shard in place. JAX's `pcast_varying`
and its cache of built runners have no twin (nothing is traced or
compiled).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..engines import smallbank, tatp
from ..engines.types import Batch, Op, Replies, make_batch
from .mesh import Mesh

I32 = torch.int32

N_ROLES = 3
SHARD_AXIS = "shard"

# engine registry: step fn + how many leading table ids are dense (and so
# take the shard-local row remap)
ENGINES = {
    "tatp": (tatp.step, tatp.N_DENSE),
    "smallbank": (smallbank.step, 2),     # SAVINGS, CHECKING
}


def make_mesh(n_devices: int, device=None, devices=None,
              group=None) -> Mesh:
    """A 1-D mesh of ``n_devices`` partitions: one device a partition
    (``devices``), all on ``device``, or (both None) over the visible
    cards by `mesh.placement`; ``group`` (a `dist.Group`): across
    processes, rank r holding a contiguous block of the shards."""
    return Mesh((n_devices,), (SHARD_AXIS,), device, devices, group=group)


def local_rows(n_global: int, n_shards: int) -> int:
    """Dense rows a shard: 3 roles x ceil(n_global / n_shards)."""
    return N_ROLES * ((n_global + n_shards - 1) // n_shards)


def local_dense_key(global_key, n_shards: int, role: int):
    """Global dense key -> shard-local row for the given replica role (on
    ints, numpy arrays and int32 tensors; ``//`` floors in all three, as
    JAX's does on a negative int32)."""
    return (global_key // n_shards) * N_ROLES + role


_PRIM_TO_BCK = {Op.COMMIT_PRIM: Op.COMMIT_BCK, Op.INSERT_PRIM: Op.INSERT_BCK,
                Op.DELETE_PRIM: Op.DELETE_BCK}


def _as_backup_ops(op):
    out = torch.full_like(op, Op.NOP)
    for src, dst in _PRIM_TO_BCK.items():
        out = torch.where(op == src, dst, out)
    return out


def _remap_dense_keys(batch: Batch, n_shards: int, role: int,
                      n_dense: int) -> Batch:
    """Dense-table keys of a batch -> this shard's local rows. The low key
    word is read as int32, as JAX's ``astype(I32)``: a pad lane's
    0xFFFFFFFF becomes row ``role - 3`` (u32 bits), as in JAX."""
    lk = local_dense_key(batch.key_lo, n_shards, role)
    return dataclasses.replace(
        batch, key_lo=torch.where(batch.table < n_dense, lk, batch.key_lo))


def _is_prim(op):
    return (op == Op.COMMIT_PRIM) | (op == Op.INSERT_PRIM) | \
        (op == Op.DELETE_PRIM)


def replicated_step(mesh: Mesh, shards: list, batches: list, *,
                    step_fn=tatp.step, n_dense: int = tatp.N_DENSE):
    """One sharded engine step over the mesh's partitions.

    ``batches[d]`` holds shard d's primary-routed requests with GLOBAL
    keys. Shard d runs ``step_fn`` once over [3w] lanes: its primary lanes
    (role 0), then the backup ops of shards d-1 and d-2 (roles 1, 2). The
    three role views touch disjoint state (dense rows by the role remap,
    CF keys by owner), so one step serves them. Updates the shards in
    place; returns (shards, replies: one [w] `Replies` a shard, committed
    i32 [D], the psummed count of prim ops, the same in every entry)."""
    n = mesh.size
    fwd = {off: mesh.ppermute(batches, SHARD_AXIS, off) for off in (1, 2)}
    replies, votes = [None] * n, [None] * n
    for d in mesh.local:
        batch = batches[d]
        parts = [_remap_dense_keys(batch, n, 0, n_dense)]
        for off in (1, 2):
            src = fwd[off][d]
            parts.append(_remap_dense_keys(
                dataclasses.replace(src, op=_as_backup_ops(src.op)), n, off,
                n_dense))
        combined = Batch(**{f.name: torch.cat([getattr(p, f.name)
                                               for p in parts])
                            for f in dataclasses.fields(Batch)})
        shards[d], rep = step_fn(shards[d], combined)
        w = batch.width
        replies[d] = Replies(rtype=rep.rtype[:w], val=rep.val[:w],
                             ver=rep.ver[:w])
        votes[d] = _is_prim(batch.op).sum(dtype=I32)
    committed = mesh.psum(votes)
    return shards, replies, committed.expand(n).clone()


def build_sharded_step(mesh: Mesh, n_shards: int, engine: str = "tatp"):
    """``step(shards, batches) -> (shards, replies, committed [D])``: the
    `replicated_step` of ``engine`` (a key of ENGINES) over the mesh's
    partitions, one shard and one batch a partition."""
    if n_shards != mesh.size:
        raise ValueError(f"n_shards={n_shards} on a mesh of {mesh.size}")
    step_fn, n_dense = ENGINES[engine]

    def step(shards, batches):
        if len(shards) != n_shards or len(batches) != n_shards:
            raise ValueError(f"expected {n_shards} shards and batches, got "
                             f"{len(shards)} and {len(batches)}")
        return replicated_step(mesh, shards, batches, step_fn=step_fn,
                               n_dense=n_dense)

    return step


def create_sharded_state(mesh: Mesh, n_shards: int, n_subscribers: int,
                         val_words: int = 10, **kw) -> list:
    """One empty TATP shard a partition at the shard-local table sizes,
    each with storage of its own on its partition's device (over a group,
    the rank's shards only; None for the others')."""
    rows = local_rows(n_subscribers + 1, n_shards)
    return mesh.map_local(lambda d: tatp.create(
        rows - 1, val_words=val_words, device=mesh.device_of(d), **kw))


def create_sharded_smallbank(mesh: Mesh, n_shards: int, n_accounts: int,
                             val_words: int = 2, **kw) -> list:
    """One empty SmallBank shard a partition (the reference shards its 3
    servers identically, smallbank/caladan/client_ebpf_shard.cc:287-289)."""
    rows = local_rows(n_accounts, n_shards)
    return mesh.map_local(lambda d: smallbank.create(
        rows, val_words=val_words, device=mesh.device_of(d), **kw))


def route_batches(ops, tbls, keys, vals, vers, n_shards: int, width: int,
                  val_words: int, device=None, devices=None):
    """Host side: bucket flat request arrays by owner = key % n_shards into
    one [width] `Batch` a shard (the reference client's per-shard batches,
    smallbank/caladan/client_ebpf_shard.cc:287-289).

    A skewed batch SPILLS into further waves instead of failing: every
    request lands in exactly one wave, at most ``width`` a shard a wave.
    Returns (waves: a list of waves, each a list of ``n_shards`` Batches,
    shard d's on ``devices[d]`` when given (a mesh's ``devices``; over a
    group every rank routes the whole request batch and keeps its own
    shards' buckets, None for the others'), else on ``device`` (None =
    CUDA), owner [n])."""
    owner = np.asarray(keys, np.int64) % n_shards
    per_dev = [np.nonzero(owner == d)[0] for d in range(n_shards)]
    n_waves = max(1, max((len(i) + width - 1) // width for i in per_dev))
    waves = []
    for wv in range(n_waves):
        parts = []
        for d in range(n_shards):
            if devices is not None and devices[d] is None:
                parts.append(None)      # another rank's shard
                continue
            idx = per_dev[d][wv * width:(wv + 1) * width]
            parts.append(make_batch(
                ops[idx], keys[idx].astype(np.uint64),
                vals[idx] if vals is not None else None,
                vers=vers[idx] if vers is not None else None,
                tables=tbls[idx], width=width, val_words=val_words,
                device=device if devices is None else devices[d]))
        waves.append(parts)
    return waves, owner
