"""The SmallBank transaction coordinator over three replicated shards (the
port of `dint_tpu.clients.smallbank_client`).

The host-side coordinator of the reference's client threads
(smallbank/caladan/client_ebpf_shard.cc): a cohort of w txns advances
through the commit pipeline in lockstep waves —

  lock+read (primary, X/S fused)  ->  compute  ->  CommitLog (all 3 shards)
  ->  CommitBck (2 backups)  ->  CommitPrim (primary)  ->  Release

(the pipeline at client_ebpf_shard.cc:389-560; the abort path releases the
granted locks, :330-370). Where the reference runs three coordinator
threads that fan messages out per shard (:287-325), this one builds one
batch of ``width`` lanes a shard a wave and runs `smallbank.step` on it; a
skewed wave that routes more than ``width`` lanes to one shard spills over
several batches.

Value layout: word 0 = balance (int32, two's complement), word 1 = magic
(the reference asserts sb_sav_magic/sb_chk_magic, smallbank/ebpf/
smallbank.h:12-14). Each replica and each field owns its storage, since
the steps update them in place (JAX donates the shard instead). Replies
come back with one host copy per field a batch, u32 words read as
``np.uint32`` from their int32 bit patterns.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import stats
from ..device import resolve_device
from ..engines import smallbank
from ..engines.types import Op, Reply, make_batch
from ..tables import dense
from . import workloads as wl
from .tatp_client import host_replies

VW = 2
N_SHARDS = 3


@dataclasses.dataclass
class Stats(stats.TxnStats):
    aborted_lock: int = 0
    aborted_logic: int = 0   # insufficient funds etc.


def init_shards(n_accounts: int, init_balance: int = 1000, device=None,
                **kw):
    """Three replicas populated alike on ``device`` (None = CUDA): every
    record on all three servers (smallbank/ebpf/shard_user.c:74-77),
    balance ``init_balance``, version 1. ``kw`` goes to `smallbank.create`
    (the log's size). No two fields or replicas share storage."""
    dev = resolve_device(device)
    vals = np.zeros((n_accounts, VW), np.uint32)
    vals[:, 0] = np.uint32(init_balance)
    vals[:, 1] = wl.SB_MAGIC
    shards = []
    for _ in range(N_SHARDS):
        s = smallbank.create(n_accounts, val_words=VW, device=dev, **kw)
        s.sav = dense.populate(s.sav, vals)
        s.chk = dense.populate(s.chk, vals)
        shards.append(s)
    return shards


class Coordinator:
    """The wave coordinator over ``shards`` (three replicas on ``device``,
    None = CUDA), ``width`` lanes a batch."""

    def __init__(self, shards, width: int = 4096, device=None):
        self.dev = resolve_device(device)
        self.shards = list(shards)
        for s in self.shards:
            if s.sav.ver.device.type != self.dev.type:
                raise ValueError(f"shard on {s.sav.ver.device}, "
                                 f"coordinator on {self.dev}")
        self.width = width
        self.stats = Stats()

    # -------------------------------------------------------------- helpers

    def _run_wave(self, ops, tbls, accts, vals=None, vers=None):
        """Route each lane to its account's primary (acct % 3) and run one
        wave; all arrays flat [M]."""
        return self._run_wave_explicit(ops, tbls, accts, accts % N_SHARDS,
                                       vals, vers)

    def _run_wave_explicit(self, ops, tbls, accts, shard_of, vals=None,
                           vers=None):
        m = len(ops)
        rt = np.zeros(m, np.int32)
        rv = np.zeros((m, VW), np.uint32)
        rver = np.zeros(m, np.uint32)
        if vals is None:
            vals = np.zeros((m, VW), np.uint32)
        if vers is None:
            vers = np.zeros(m, np.uint32)
        for s in range(N_SHARDS):
            all_idx = np.nonzero(shard_of == s)[0]
            # a skewed wave spills over several batches instead of failing
            # (the reference client spreads it over more round trips)
            for start in range(0, max(len(all_idx), 1), self.width):
                idx = all_idx[start:start + self.width]
                if len(idx) == 0:
                    continue
                batch = make_batch(ops[idx], accts[idx].astype(np.uint64),
                                   vals[idx], vers=vers[idx],
                                   tables=tbls[idx], width=self.width,
                                   val_words=VW, device=self.dev)
                self.shards[s], rep = smallbank.step(self.shards[s], batch)
                rt[idx], rv[idx], rver[idx] = host_replies(rep, len(idx))
        return rt, rv, rver

    # -------------------------------------------------------------- cohort

    def run_cohort(self, ttype, a1, a2):
        """Drive one cohort of txns (type [w], accounts a1, a2 [w]) through
        the whole pipeline; returns the running `Stats`."""
        w = len(ttype)
        self.stats.attempted += w
        SAV, CHK = smallbank.SAVINGS, smallbank.CHECKING
        X, S = Op.ACQ_X_READ, Op.ACQ_S_READ

        # --- the lock set (up to 3 a txn): (op, table, acct)
        l_op = np.zeros((w, 3), np.int32)     # 0 = unused slot
        l_tb = np.zeros((w, 3), np.int32)
        l_ac = np.zeros((w, 3), np.int64)

        def setlock(mask, slot, op, tb, ac):
            l_op[mask, slot] = op
            l_tb[mask, slot] = tb
            l_ac[mask, slot] = ac[mask]

        t = ttype
        m = t == wl.SB_AMALGAMATE
        setlock(m, 0, X, SAV, a1)
        setlock(m, 1, X, CHK, a1)
        setlock(m, 2, X, CHK, a2)
        m = t == wl.SB_BALANCE
        setlock(m, 0, S, SAV, a1)
        setlock(m, 1, S, CHK, a1)
        m = t == wl.SB_DEPOSIT
        setlock(m, 0, X, CHK, a1)
        m = t == wl.SB_SEND_PAYMENT
        setlock(m, 0, X, CHK, a1)
        setlock(m, 1, X, CHK, a2)
        m = t == wl.SB_TRANSACT_SAVING
        setlock(m, 0, X, SAV, a1)
        m = t == wl.SB_WRITE_CHECK
        setlock(m, 0, S, SAV, a1)
        setlock(m, 1, X, CHK, a1)

        # --- wave 1: fused lock+read at the primaries
        used = l_op.reshape(-1) != 0
        f_op = l_op.reshape(-1)[used]
        f_tb = l_tb.reshape(-1)[used]
        f_ac = l_ac.reshape(-1)[used]
        txn_of = np.repeat(np.arange(w), 3)[used]
        rt, rv, rver = self._run_wave(f_op, f_tb, f_ac)

        granted = rt == Reply.GRANT
        # the magic word of every read (the reference asserts it,
        # smallbank/caladan/client_ebpf_shard.cc:375-380)
        assert (rv[granted, 1] == wl.SB_MAGIC).all(), "magic corrupted"
        txn_rejected = np.zeros(w, bool)
        np.logical_or.at(txn_rejected, txn_of, ~granted)
        self.stats.aborted_lock += int(txn_rejected.sum())

        # balances read (int32), keyed back to (txn, slot)
        bal = np.zeros((w, 3), np.int64)
        ver = np.zeros((w, 3), np.uint32)
        flat_bal = rv[:, 0].astype(np.uint32).view(np.int32).astype(np.int64)
        slot_of = np.tile(np.arange(3), w)[used]
        bal[txn_of, slot_of] = flat_bal
        ver[txn_of, slot_of] = rver

        # --- compute (vectorized by txn type)
        alive = ~txn_rejected
        amt = np.full(w, 5, np.int64)  # fixed amounts keep invariants simple
        nw_val = np.zeros((w, 3), np.int64)    # new balances a lock slot
        nw_do = np.zeros((w, 3), bool)         # which slots are written
        logic_abort = np.zeros(w, bool)

        m = alive & (t == wl.SB_AMALGAMATE)
        nw_val[m, 0] = 0
        nw_val[m, 1] = 0
        nw_val[m, 2] = bal[m, 2] + bal[m, 0] + bal[m, 1]
        nw_do[m] = True
        m = alive & (t == wl.SB_DEPOSIT)
        nw_val[m, 0] = bal[m, 0] + amt[m]
        nw_do[m, 0] = True
        m = alive & (t == wl.SB_SEND_PAYMENT)
        insufficient = bal[:, 0] < amt
        logic_abort |= m & insufficient
        ok = m & ~insufficient
        nw_val[ok, 0] = bal[ok, 0] - amt[ok]
        nw_val[ok, 1] = bal[ok, 1] + amt[ok]
        nw_do[ok, 0] = True
        nw_do[ok, 1] = True
        m = alive & (t == wl.SB_TRANSACT_SAVING)
        neg = (bal[:, 0] + amt) < 0
        logic_abort |= m & neg
        ok = m & ~neg
        nw_val[ok, 0] = bal[ok, 0] + amt[ok]
        nw_do[ok, 0] = True
        m = alive & (t == wl.SB_WRITE_CHECK)
        overdraw = (bal[:, 0] + bal[:, 1]) < amt
        nw_val[m, 1] = bal[m, 1] - amt[m] - np.where(overdraw[m], 1, 0)
        nw_do[m, 1] = True

        self.stats.aborted_logic += int(logic_abort.sum())
        commit = alive & ~logic_abort & (t != wl.SB_BALANCE)

        # --- commit waves: log x3, bck x2, prim x1
        wmask = nw_do & commit[:, None]
        c_txn, c_slot = np.nonzero(wmask)
        c_tb = l_tb[c_txn, c_slot]
        c_ac = l_ac[c_txn, c_slot]
        c_val = np.zeros((len(c_txn), VW), np.uint32)
        c_val[:, 0] = nw_val[c_txn, c_slot].astype(np.int32).view(np.uint32)
        c_val[:, 1] = wl.SB_MAGIC
        c_ver = ver[c_txn, c_slot] + 1
        ops_log = np.full(len(c_txn), Op.COMMIT_LOG, np.int32)
        prim = (c_ac % N_SHARDS).astype(np.int64)
        # CommitLog to ALL 3 shards (client_ebpf_shard.cc:389-560)
        for s in range(N_SHARDS):
            self._run_wave_explicit(ops_log, c_tb, c_ac,
                                    np.full(len(c_txn), s), c_val, c_ver)
        ops_bck = np.full(len(c_txn), Op.COMMIT_BCK, np.int32)
        for off in (1, 2):
            self._run_wave_explicit(ops_bck, c_tb, c_ac,
                                    (prim + off) % N_SHARDS, c_val, c_ver)
        ops_prim = np.full(len(c_txn), Op.COMMIT_PRIM, np.int32)
        self._run_wave_explicit(ops_prim, c_tb, c_ac, prim, c_val, c_ver)

        # --- release every granted lock (aborts release too)
        rel_mask = granted
        r_op = np.where(f_op[rel_mask] == X, Op.REL_X,
                        Op.REL_S).astype(np.int32)
        rt_rel, _, _ = self._run_wave(r_op, f_tb[rel_mask], f_ac[rel_mask])
        assert (rt_rel == Reply.ACK).all()

        self.stats.committed += int(
            (commit | (alive & (t == wl.SB_BALANCE) & ~logic_abort)).sum())
        return self.stats


def total_balance(shards) -> int:
    """The sum of every balance on replica 0 (the invariant check)."""
    s = shards[0]
    sav = s.sav.val[0::s.sav.val_words].to(torch.int64).sum()
    chk = s.chk.val[0::s.chk.val_words].to(torch.int64).sum()
    return int(sav + chk)
