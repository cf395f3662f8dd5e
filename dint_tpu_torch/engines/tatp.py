"""The TATP shard server: OCC + replication over five tables (the port of
`dint_tpu.engines.tatp`; the reference's server is tatp/ebpf/shard_kern.c:
READ with bloom :140-250, ACQUIRE_LOCK :251-297, ABORT :298-337,
COMMIT_PRIM :338-476, INSERT/DELETE_PRIM :477-658, the backups' ops
:659-913, COMMIT/DELETE_LOG :914-939). The dense engine imports its table
ids and `cf_key`.

Tables (dense-indexed where the reference hashes a dense key):
  SUBSCRIBER(0)        dense by s_id, exact per-row OCC lock
  SEC_SUBSCRIBER(1)    dense by sub_nbr
  ACCESS_INFO(2)       dense by s_id*4 + (ai_type-1); ver 0 means absent
  SPECIAL_FACILITY(3)  dense by s_id*4 + (sf_type-1), per-row lock
  CALL_FORWARDING(4)   sparse composite key -> tables.kv.KVTable with
                       insert/delete and bloom; row locks hash-conflated in
                       a tables.locks.OCCTable (or OCCAttrTable)

The CF table rides `store.step` (GET/SET/INSERT/DELETE with SPILL) and
`fasst.step` (the lock word), each on a translated op view of the batch;
the dense tables take a closed-form OCC pass (commits and unlocks, then
reads, then lock acquires, per (table, row)). Versions increment on
install, so replicas that apply the same certified ops stay identical.

What the port keeps bit for bit: the dense pass reads a lane's row as the
low key word cast to int32 and clamped to [0, n-1] (JAX's ``jnp.clip``),
and the same clamped row is the writer's target. Writes are in place and
keep only the writer lanes (JAX's ``mode="drop"``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..device import resolve_device
from ..ops import segments
from ..ops.u32 import to_u64, wrap_i32
from ..tables import dense, kv, locks
from ..tables import log as logring
from . import fasst, store
from .types import Batch, Op, Replies, Reply

I32 = torch.int32

SUBSCRIBER = 0
SEC_SUBSCRIBER = 1
ACCESS_INFO = 2
SPECIAL_FACILITY = 3
CALL_FORWARDING = 4

N_DENSE = 4


def cf_key(s_id, sf_type, start_time):
    """Composite CALL_FORWARDING key (start_time in {0, 8, 16}); works on
    ints, numpy arrays and tensors alike."""
    return s_id * 12 + (sf_type - 1) * 3 + start_time // 8


@dataclass
class Shard:
    sub: dense.DenseTable
    sec: dense.DenseTable
    ai: dense.DenseTable
    sf: dense.DenseTable
    sub_lock: torch.Tensor   # bool [P+1]
    sec_lock: torch.Tensor
    ai_lock: torch.Tensor    # bool [4(P+1)]
    sf_lock: torch.Tensor
    cf: kv.KVTable
    cf_lock: locks.OCCTable | locks.OCCAttrTable
    log: logring.LogRing

    @property
    def n_subscribers(self) -> int:
        return self.sub.size - 1

    def dense_tables(self):
        """(table, lock) of the dense tables, by table id."""
        return ((self.sub, self.sub_lock), (self.sec, self.sec_lock),
                (self.ai, self.ai_lock), (self.sf, self.sf_lock))


def create(n_subscribers: int, val_words: int = 10,
           cf_buckets: int | None = None, cf_lock_slots: int | None = None,
           log_lanes: int = 16, log_capacity: int = 1 << 20,
           attr_locks: bool = False, device=None) -> Shard:
    """An empty shard on ``device`` (None = CUDA). ``attr_locks`` builds the
    lock-attribution variant: CF lock words carry their holder's key
    (tatp/ebpf/lock_kern.c:12-16)."""
    dev = resolve_device(device)
    p1 = n_subscribers + 1          # ids are 1-based
    if cf_buckets is None:
        cf_buckets = max(1 << (p1 * 4).bit_length(), 16)  # load <= ~0.25
    if cf_lock_slots is None:
        cf_lock_slots = max(cf_buckets, 16)

    def lock(n):
        return torch.zeros(n, dtype=torch.bool, device=dev)

    return Shard(
        sub=dense.create(p1, val_words, dev),
        sec=dense.create(p1, val_words, dev),
        ai=dense.create(4 * p1, val_words, dev),
        sf=dense.create(4 * p1, val_words, dev),
        sub_lock=lock(p1), sec_lock=lock(p1),
        ai_lock=lock(4 * p1), sf_lock=lock(4 * p1),
        cf=kv.create(cf_buckets, slots=4, val_words=val_words, device=dev),
        cf_lock=(locks.create_occ_attr(cf_lock_slots, dev) if attr_locks
                 else locks.create_occ(cf_lock_slots, dev)),
        log=logring.create(log_lanes, log_capacity, val_words, dev))


# --------------------------------------------------------------- dense OCC


def _dense_gather(shard: Shard, tbl, idx):
    """(val, ver, locked) of each lane's row in its dense table; rows
    clamped into each table, as JAX's; a lane of no dense table reads
    SPECIAL_FACILITY's, as JAX's select chain does."""
    parts = []
    for t, lock in shard.dense_tables():
        i = torch.clamp(idx, 0, t.size - 1).long()
        parts.append((dense.gather_rows(t, i), t.ver[i], lock[i]))
    val, ver, lck = parts[SPECIAL_FACILITY]
    for which in (ACCESS_INFO, SEC_SUBSCRIBER, SUBSCRIBER):
        m = tbl == which
        v, r, lk = parts[which]
        val = torch.where(m[:, None], v, val)
        ver = torch.where(m, r, ver)
        lck = torch.where(m, lk, lck)
    return val, ver, lck


def _dense_step(shard: Shard, batch: Batch):
    """Closed-form OCC pass over the four dense tables, in place.

    Per (table, row) group: commit installs and unlocks first, then the
    aborts' unlocks, then reads (which see the post-commit state), then
    lock acquires in lane order. Rows of ver 0 are absent (NOT_EXIST on
    read; commits create them)."""
    r = batch.width
    is_dense = batch.table < N_DENSE
    op = torch.where(is_dense, batch.op, Op.NOP)
    sb = segments.sort_batch(batch.table, batch.key_lo)
    op = op[sb.perm]
    val_in = batch.val[sb.perm]
    tbl = sb.key_hi
    idx = sb.key_lo

    val0, ver0, locked0 = _dense_gather(shard, tbl, idx)

    is_cprim = op == Op.COMMIT_PRIM
    is_commit = is_cprim | (op == Op.COMMIT_BCK)
    is_abort = op == Op.ABORT
    is_read = op == Op.OCC_READ
    is_lock = op == Op.OCC_LOCK

    # commits install (the last in lane order wins; X-certified, so one)
    last_c = segments.seg_max_where(sb, is_commit, sb.rank, -1)
    pos_c = torch.clamp(sb.head_pos + last_c, 0, r - 1).long()
    any_c = last_c >= 0
    n_c = segments.seg_sum(sb, is_commit.to(I32))
    val1 = torch.where(any_c[:, None], val_in[pos_c], val0)
    ver1 = torch.where(any_c, wrap_i32(to_u64(ver0) + n_c), ver0)
    locked1 = locked0 & ~segments.seg_any(sb, is_cprim | is_abort)

    first_lock = segments.first_rank_where(sb, is_lock)
    grant = is_lock & ~locked1 & (sb.rank == first_lock)
    new_locked = locked1 | segments.seg_any(sb, grant)

    exists = ver1 != 0
    rtype = torch.full_like(op, Reply.NONE)
    rtype = torch.where(is_commit | is_abort, Reply.ACK, rtype)
    rtype = torch.where(is_read, Reply.NOT_EXIST, rtype)
    rtype = torch.where(is_read & exists, Reply.VAL, rtype)
    rtype = torch.where(is_lock, Reply.REJECT, rtype)
    rtype = torch.where(grant, Reply.GRANT, rtype)
    rval = torch.where((is_read & exists)[:, None], val1, 0)
    rver = torch.where(is_read & exists, ver1, 0)

    writer = sb.last & segments.seg_any(sb, op != Op.NOP)
    for which, (t, lock) in enumerate(shard.dense_tables()):
        keep = torch.nonzero(writer & (tbl == which)).squeeze(1)
        i = torch.clamp(idx[keep], 0, t.size - 1).long()
        t.val.view(-1, t.val_words)[i] = val1[keep]
        t.ver[i] = ver1[keep]
        lock[i] = new_locked[keep]
    o_rtype, o_rver = segments.unsort(sb, rtype, rver)
    o_rval = segments.unsort(sb, rval)
    return shard, Replies(rtype=o_rtype, val=o_rval, ver=o_rver)


# --------------------------------------------------------------- CF (sparse)

_KV_OP = {Op.OCC_READ: Op.GET, Op.COMMIT_PRIM: Op.SET, Op.COMMIT_BCK: Op.SET,
          Op.INSERT_PRIM: Op.INSERT, Op.INSERT_BCK: Op.INSERT,
          Op.DELETE_PRIM: Op.DELETE, Op.DELETE_BCK: Op.DELETE}
_UNLOCK_OPS = (Op.COMMIT_PRIM, Op.INSERT_PRIM, Op.DELETE_PRIM, Op.ABORT)
_LOCK_OP = {Op.OCC_LOCK: Op.LOCK, **{o: Op.ABORT for o in _UNLOCK_OPS}}


def _translate(op, table, mapping, default=Op.NOP):
    """The CF lanes' ops through ``mapping``; every other lane ``default``."""
    out = torch.full_like(op, default)
    is_cf = table == CALL_FORWARDING
    for src, dst in mapping.items():
        out = torch.where(is_cf & (op == src), dst, out)
    return out


def _cf_step(shard: Shard, batch: Batch):
    """CALL_FORWARDING pass: `store.step` takes the KV mutations, the fasst
    step the hash-slot row locks; prim ops appear in both views (install
    in the KV view, unlock in the lock view)."""
    kv_ops = _translate(batch.op, batch.table, _KV_OP)
    shard.cf, kv_rep = store.step(shard.cf, dataclasses.replace(
        batch, op=kv_ops), maintain_bloom=True)
    lk_ops = _translate(batch.op, batch.table, _LOCK_OP)
    # the lock table's flavor picks the step (tatp.create attr_locks)
    lock_step = (fasst.step_attr
                 if isinstance(shard.cf_lock, locks.OCCAttrTable)
                 else fasst.step)
    shard.cf_lock, lk_rep = lock_step(shard.cf_lock, dataclasses.replace(
        batch, op=lk_ops))
    # lock replies only for OCC_LOCK lanes; the rest from the KV view
    use_lock = (batch.table == CALL_FORWARDING) & (batch.op == Op.OCC_LOCK)
    return shard, Replies(
        rtype=torch.where(use_lock, lk_rep.rtype, kv_rep.rtype),
        val=kv_rep.val, ver=torch.where(use_lock, lk_rep.ver, kv_rep.ver))


def step(shard: Shard, batch: Batch):
    """Certify and apply one batch (all 5 tables + log), in place. Returns
    (shard, replies)."""
    shard, dense_rep = _dense_step(shard, batch)
    shard, cf_rep = _cf_step(shard, batch)

    is_del_log = batch.op == Op.DELETE_LOG
    do_log = (batch.op == Op.COMMIT_LOG) | is_del_log
    logring.append(shard.log, do_log, batch.table, is_del_log.to(I32),
                   batch.key_hi, batch.key_lo, batch.ver, batch.val)

    is_cf = batch.table == CALL_FORWARDING
    rtype = torch.where(is_cf, cf_rep.rtype, dense_rep.rtype)
    rtype = torch.where(do_log, Reply.ACK, rtype)
    rval = torch.where(is_cf[:, None], cf_rep.val, dense_rep.val)
    rver = torch.where(is_cf, cf_rep.ver, dense_rep.ver)
    return shard, Replies(rtype=rtype, val=rval, ver=rver)
