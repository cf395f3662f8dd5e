"""The SmallBank shard server: 2PL + replication over dense tables (the
port of `dint_tpu.engines.smallbank`; the reference's server is
smallbank/ebpf/shard_kern.c). The dense engine imports its table ids.

Per shard: SAVINGS and CHECKING tables with S/X lock units, a replication
log, and fused lock+read ops: ACQ_{S,X}_READ takes the lock and returns
value + version in one round trip (shard_kern.c:96-328), REL_* releases
(:330-392), COMMIT_PRIM/BCK install a value and its version (:394-564),
COMMIT_LOG appends to the log (:566-583). Accounts are dense 0..N-1, so
locks are exact per account.

Per (table, account) group: releases first, then commit installs (the
newest version wins), then lock acquires with fused reads (which see the
installed value) in lane order, in closed form as in lock2pl.

What the port keeps bit for bit: the install compares versions as SIGNED
int32 (JAX's ``ver.astype(I32)``), so a version of 2^31 or more loses to
smaller ones; the int32 storage compares so without a cast. Account ids
are the low key word read as int32: a pad lane's 0xFFFFFFFF is -1, which
JAX's gather wraps to the last row. The port routes such lanes to that row
explicitly (they are NOPs and write nothing). Tables are updated in place.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import resolve_device
from ..ops import segments
from ..tables import dense
from ..tables import log as logring
from .types import Batch, Op, Replies, Reply

I32 = torch.int32

SAVINGS = 0
CHECKING = 1


@dataclass
class Shard:
    sav: dense.DenseTable
    chk: dense.DenseTable
    sav_sh: torch.Tensor   # i32 [N] shared-lock counts
    sav_ex: torch.Tensor   # i32 [N] exclusive-lock counts
    chk_sh: torch.Tensor
    chk_ex: torch.Tensor
    log: logring.LogRing

    @property
    def n_accounts(self) -> int:
        return self.sav.size


def create(n_accounts: int, val_words: int = 2, log_lanes: int = 16,
           log_capacity: int = 1 << 20, device=None) -> Shard:
    """An all-zero shard on ``device`` (None = CUDA)."""
    dev = resolve_device(device)

    def z():
        return torch.zeros(n_accounts, dtype=I32, device=dev)

    return Shard(sav=dense.create(n_accounts, val_words, dev),
                 chk=dense.create(n_accounts, val_words, dev),
                 sav_sh=z(), sav_ex=z(), chk_sh=z(), chk_ex=z(),
                 log=logring.create(log_lanes, log_capacity, val_words, dev))


def _gather(shard: Shard, is_chk, acct):
    sh0 = torch.where(is_chk, shard.chk_sh[acct], shard.sav_sh[acct])
    ex0 = torch.where(is_chk, shard.chk_ex[acct], shard.sav_ex[acct])
    val0 = torch.where(is_chk[:, None], dense.gather_rows(shard.chk, acct),
                       dense.gather_rows(shard.sav, acct))
    ver0 = torch.where(is_chk, shard.chk.ver[acct], shard.sav.ver[acct])
    return sh0, ex0, val0, ver0


def _scatter(dst, rows, src, mask):
    keep = torch.nonzero(mask).squeeze(1)
    for d, s in zip(dst, src):
        d[rows[keep]] = s[keep]


def step(shard: Shard, batch: Batch):
    """Certify and apply one batch against this shard, in place. Returns
    (shard, replies)."""
    r = batch.width
    n = shard.n_accounts
    # group by (table, account): the table id is the sort key's high word
    sb = segments.sort_batch(batch.table, batch.key_lo)
    op = batch.op[sb.perm]
    val_in = batch.val[sb.perm]
    ver_in = batch.ver[sb.perm]
    is_chk = sb.key_hi == CHECKING
    acct = sb.key_lo.long()
    acct = torch.clamp(torch.where(acct < 0, acct + n, acct), 0, n - 1)

    sh0, ex0, val0, ver0 = _gather(shard, is_chk, acct)

    # --- phase 1: releases
    rel_s = segments.seg_sum(sb, (op == Op.REL_S).to(I32))
    rel_x = segments.seg_sum(sb, (op == Op.REL_X).to(I32))
    sh1 = torch.clamp(sh0 - rel_s, min=0)
    ex1 = torch.clamp(ex0 - rel_x, min=0)

    # --- phase 2: commit installs; the newest version wins, compared as
    # signed int32 (the reference's ver.astype(I32))
    is_commit = (op == Op.COMMIT_PRIM) | (op == Op.COMMIT_BCK)
    max_cver = segments.seg_max_where(sb, is_commit, ver_in, -1)
    install = max_cver > ver0
    # the lane carrying the winning version supplies the value
    win_rank = segments.first_rank_where(sb, is_commit & (ver_in == max_cver))
    pos_win = torch.clamp(sb.head_pos + win_rank, 0, r - 1).long()
    val1 = torch.where(install[:, None], val_in[pos_win], val0)
    ver1 = torch.where(install, max_cver, ver0)

    # --- phase 3: lock acquires with fused read
    is_acq_s = op == Op.ACQ_S_READ
    is_acq_x = op == Op.ACQ_X_READ
    is_acq = is_acq_s | is_acq_x
    first_acq = segments.first_rank_where(sb, is_acq)
    pos_first = torch.clamp(sb.head_pos + first_acq, 0, r - 1).long()
    first_is_x = is_acq_x[pos_first] & (first_acq < segments.NO_RANK)
    x_takes = first_is_x & (sh1 == 0) & (ex1 == 0)
    grant_x = is_acq_x & x_takes & (sb.rank == first_acq)
    grant_s = is_acq_s & (ex1 == 0) & ~x_takes
    granted = grant_s | grant_x
    new_sh = sh1 + segments.seg_sum(sb, grant_s.to(I32))
    new_ex = ex1 + segments.seg_sum(sb, grant_x.to(I32))

    # --- replies
    rtype = torch.full_like(op, Reply.NONE)
    rtype = torch.where((op == Op.REL_S) | (op == Op.REL_X), Reply.ACK, rtype)
    rtype = torch.where(is_commit | (op == Op.COMMIT_LOG), Reply.ACK, rtype)
    rtype = torch.where(is_acq, Reply.REJECT, rtype)
    rtype = torch.where(granted, Reply.GRANT, rtype)
    rval = torch.where(granted[:, None], val1, 0)
    rver = torch.where(granted, ver1, 0)

    # --- scatters: one writer per (table, account) segment
    writer = sb.last & segments.seg_any(sb, op != Op.NOP)
    installs = segments.seg_any(sb, is_commit & install)
    _scatter((shard.sav_sh, shard.sav_ex), acct, (new_sh, new_ex),
             writer & ~is_chk)
    _scatter((shard.chk_sh, shard.chk_ex), acct, (new_sh, new_ex),
             writer & is_chk)
    for t, m in ((shard.sav, writer & ~is_chk & installs),
                 (shard.chk, writer & is_chk & installs)):
        _scatter((t.val.view(-1, t.val_words), t.ver), acct, (val1, ver1), m)

    # --- replication log append (original lane order)
    logring.append(shard.log, batch.op == Op.COMMIT_LOG, batch.table,
                   torch.zeros_like(batch.op), batch.key_hi, batch.key_lo,
                   batch.ver, batch.val)

    o_rtype, o_rver = segments.unsort(sb, rtype, rver)
    o_rval = segments.unsort(sb, rval)
    return shard, Replies(rtype=o_rtype, val=o_rval, ver=o_rver)
