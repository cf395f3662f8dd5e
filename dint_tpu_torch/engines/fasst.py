"""lock_fasst: the batched FaSST-style OCC lock/version server (the port of
`dint_tpu.engines.fasst`; the reference's XDP primitives are
lock_fasst/ebpf/ls_kern.c:58-97, its userspace twin
lock_fasst/caladan/server.cc:30-92).

READ_VER returns the version (and the lock bit in reply val word 0, as the
reference's validation re-read does, lock_fasst/caladan/client.cc:199-215);
LOCK is a CAS; COMMIT_VER bumps the version and unlocks; ABORT unlocks.
Per slot, commits and aborts apply first, then reads (which see the
post-commit version and lock bit), then lock acquires in lane order: the
first acquirer of a free lock wins, the rest are rejected. Versions are
u32 and wrap at 2^32. Tables are updated in place.

`step_attr` is the lock-attribution variant (the reference's instrumented
TATP server, tatp/ebpf/lock_kern.c): the lock word carries its holder's
key, and a rejected LOCK answers REJECT_SAME_KEY when the key it lost to
equals its own (a true conflict) and plain REJECT otherwise (hash-slot
sharing, lock_kern.c:292-298).
"""
from __future__ import annotations

import torch

from ..ops import segments
from ..ops.u32 import to_u64, wrap_i32
from ..tables import locks
from .types import Batch, Op, Replies, Reply

I32 = torch.int32


def _occ(table, batch: Batch, attr: bool):
    r = batch.width
    slot = locks.lock_slot(batch.key_hi, batch.key_lo, table.n_slots)
    sb = segments.sort_batch(torch.zeros_like(slot), slot)
    op = batch.op[sb.perm]
    s_slot = slot[sb.perm].long()

    locked0 = table.locked[s_slot]
    ver0 = table.ver[s_slot]

    is_commit = op == Op.COMMIT_VER
    is_abort = op == Op.ABORT
    is_read = op == Op.READ_VER
    is_lock = op == Op.LOCK

    n_commits = segments.seg_sum(sb, is_commit.to(I32))
    unlock_any = segments.seg_any(sb, is_commit | is_abort)
    ver1 = wrap_i32(to_u64(ver0) + n_commits)        # u32 ver + commits
    locked1 = locked0 & ~unlock_any

    first_lock = segments.first_rank_where(sb, is_lock)
    grant = is_lock & ~locked1 & (sb.rank == first_lock)
    won = segments.seg_any(sb, grant)
    new_locked = locked1 | won

    rejected = torch.full_like(op, Reply.REJECT)
    writes = [(table.locked, new_locked), (table.ver, ver1)]
    if attr:
        k_hi = batch.key_hi[sb.perm]
        k_lo = batch.key_lo[sb.perm]
        own_hi0 = table.owner_hi[s_slot]
        own_lo0 = table.owner_lo[s_slot]
        # the owner after this batch: the granted lane's key, else the
        # prior owner
        pos_first = torch.clamp(sb.head_pos + first_lock, 0, r - 1).long()
        new_own_hi = torch.where(won, k_hi[pos_first], own_hi0)
        new_own_lo = torch.where(won, k_lo[pos_first], own_lo0)
        # the key a rejected LOCK lost to: the table's owner where the lock
        # was already held, else the lane granted in this batch
        lose_hi = torch.where(locked1, own_hi0, new_own_hi)
        lose_lo = torch.where(locked1, own_lo0, new_own_lo)
        same = (lose_hi == k_hi) & (lose_lo == k_lo)
        rejected = torch.where(same, Reply.REJECT_SAME_KEY, rejected)
        writes += [(table.owner_hi, new_own_hi), (table.owner_lo, new_own_lo)]

    rtype = torch.full_like(op, Reply.NONE)
    rtype = torch.where(is_commit | is_abort, Reply.ACK, rtype)
    rtype = torch.where(is_read, Reply.VAL, rtype)
    rtype = torch.where(is_lock, torch.where(grant, Reply.GRANT, rejected),
                        rtype)
    rver = torch.where(is_read, ver1, 0)
    rlocked = (is_read & locked1).to(I32)

    writer = sb.last & segments.seg_any(sb, op != Op.NOP)
    keep = torch.nonzero(writer).squeeze(1)
    rows = s_slot[keep]
    for dst, src in writes:
        dst[rows] = src[keep]
    o_rtype, o_rver, o_rlocked = segments.unsort(sb, rtype, rver, rlocked)
    rval = torch.zeros_like(batch.val)
    rval[:, 0] = o_rlocked
    return table, Replies(rtype=o_rtype, val=rval, ver=o_rver)


def step(table: locks.OCCTable, batch: Batch):
    """Certify and apply one batch. Returns (table, replies)."""
    return _occ(table, batch, attr=False)


def step_attr(table: locks.OCCAttrTable, batch: Batch):
    """`step` over an `OCCAttrTable`, with REJECT_SAME_KEY attribution."""
    return _occ(table, batch, attr=True)
