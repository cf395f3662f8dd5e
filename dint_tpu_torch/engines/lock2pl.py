"""lock_2pl: the batched no-wait S/X lock server (the port of
`dint_tpu.engines.lock2pl`; the reference's server is
lock_2pl/ebpf/ls_kern.c:33-110, its userspace twin
lock_2pl/caladan/server.cc:39-105).

Per lock slot, releases apply first, then acquires in lane order. No-wait
2PL never blocks, so the sequential outcome has a closed form:
  * ex held after the releases        -> reject every acquire
  * sh held after the releases        -> grant all S, reject all X
  * free, earliest acquire is X       -> grant exactly that X, reject the rest
  * free, earliest acquire is S       -> grant all S, reject all X
RETRY (the reference's busy entry spinlock) is never emitted. The table
is updated in place: one writer lane per touched slot.
"""
from __future__ import annotations

import torch

from ..ops import segments
from ..tables import locks
from .types import Batch, Op, Replies, Reply

I32 = torch.int32


def step(table: locks.SXLockTable, batch: Batch):
    """Certify and apply one batch. Returns (table, replies)."""
    r = batch.width
    slot = locks.lock_slot(batch.key_hi, batch.key_lo, table.n_slots)
    sb = segments.sort_batch(torch.zeros_like(slot), slot)
    op = batch.op[sb.perm]
    s_slot = slot[sb.perm].long()

    sh0 = table.num_sh[s_slot]
    ex0 = table.num_ex[s_slot]

    is_acq_s = op == Op.ACQ_S
    is_acq_x = op == Op.ACQ_X
    is_acq = is_acq_s | is_acq_x
    rel_s = segments.seg_sum(sb, (op == Op.REL_S).to(I32))
    rel_x = segments.seg_sum(sb, (op == Op.REL_X).to(I32))
    sh1 = torch.clamp(sh0 - rel_s, min=0)
    ex1 = torch.clamp(ex0 - rel_x, min=0)

    first_acq = segments.first_rank_where(sb, is_acq)
    pos_first = torch.clamp(sb.head_pos + first_acq, 0, r - 1).long()
    first_is_x = is_acq_x[pos_first] & (first_acq < segments.NO_RANK)
    x_takes = first_is_x & (sh1 == 0) & (ex1 == 0)

    grant_x = is_acq_x & x_takes & (sb.rank == first_acq)
    grant_s = is_acq_s & (ex1 == 0) & ~x_takes
    granted = grant_s | grant_x

    new_sh = sh1 + segments.seg_sum(sb, grant_s.to(I32))
    new_ex = ex1 + segments.seg_sum(sb, grant_x.to(I32))

    rtype = torch.full_like(op, Reply.NONE)
    rtype = torch.where((op == Op.REL_S) | (op == Op.REL_X), Reply.ACK, rtype)
    rtype = torch.where(is_acq, Reply.REJECT, rtype)
    rtype = torch.where(granted, Reply.GRANT, rtype)

    writer = sb.last & segments.seg_any(sb, op != Op.NOP)
    keep = torch.nonzero(writer).squeeze(1)
    table.num_sh[s_slot[keep]] = new_sh[keep]
    table.num_ex[s_slot[keep]] = new_ex[keep]
    return table, Replies(rtype=segments.unsort(sb, rtype),
                          val=torch.zeros_like(batch.val),
                          ver=torch.zeros_like(batch.ver))
