"""The TATP transaction coordinator over three replicated shards, and its
populate (the port of `dint_tpu.clients.tatp_client`).

`Coordinator` is the host-side wave coordinator of the reference's TATP
client (tatp/caladan/client_ebpf_shard.cc): a cohort of w txns advances in
waves through the FaSST-style OCC pipeline, each wave one `tatp.step` a
shard it touches —

  wave 1: READ the read set + LOCK the write set (fused)   (:608-677)
  wave 2: validate = re-READ, compare versions              (:688-768)
  wave 3: CommitLog -> all 3 shards                         (:779-810)
  wave 4: Commit/Insert/DeleteBck -> the 2 backups          (:812-860)
  wave 5: Commit/Insert/DeletePrim -> the primary           (:862-900)
  abort:  ABORT (unlock) each granted lock                  (:681-703)

Txn mix 35/35/10/2/14/2/2 with NURand subscriber ids (tatp/caladan/tatp.h:
40-43,57-63); a key's shard is key % 3 (client_ebpf_shard.cc:636-641).

The populate (client_ebpf_shard.cc:96-341): every subscriber has
SUBSCRIBER and SEC_SUBSCRIBER rows, a random subset (at least one) of the
four ACCESS_INFO and SPECIAL_FACILITY types, each present with probability
0.625, and each present SPECIAL_FACILITY row a CALL_FORWARDING row per
start time with probability 0.25. Value word 0 is a payload, word 1 the
magic (tatp/caladan/tatp.h:67-72).

The draws are numpy's, in JAX's order, so the tables and every cohort are
bit-identical to JAX's from the same generator. The CF table is placed
once and cloned: each replica owns its storage, since the steps update
them in place (JAX donates the shard to a jitted step instead). Replies
come back to the host with one copy per field a shard a wave; their u32
words are read as ``np.uint32`` from the int32 bit patterns.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import stats
from ..device import resolve_device
from ..engines import tatp
from ..engines.types import Op, Reply, make_batch
from ..tables import dense, kv, locks
from . import workloads as wl

N_SHARDS = 3
MAGIC = 0x7A79


@dataclasses.dataclass
class Stats(stats.TxnStats):
    aborted_lock: int = 0      # write-set lock rejected
    aborted_validate: int = 0  # read-set version changed
    aborted_missing: int = 0   # required row absent / insert-exists
    aborted_timeout: int = 0   # wire transport exhausted its resends (and
    timeout_lanes: int = 0     # in-doubt commits); lanes = raw datagrams
    # lock attribution (live over shards of tatp.create(attr_locks=True);
    # the reference's instrumented client keeps the same three,
    # tatp/caladan/client_lock.cc:62-64,768-771)
    lock_cnt: int = 0              # OCC_LOCK lanes issued
    reject_sharing_cnt: int = 0    # rejected by a DIFFERENT key (hash share)
    reject_same_key_cnt: int = 0   # rejected by the SAME key (true conflict)


def clone_tree(x):
    """A copy of a dataclass of tensors (nested), every tensor cloned."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: clone_tree(getattr(x, f.name))
            for f in dataclasses.fields(x) if f.init})
    return x


def populate_shards(rng: np.random.Generator, n_subscribers: int,
                    val_words: int = 10, device=None, **kw):
    """Three identical replicas on ``device`` (None = CUDA); ``kw`` goes to
    `tatp.create`. Returns (shards, cf_keys u64)."""
    dev = resolve_device(device)
    p1 = n_subscribers + 1

    def mkvals(n, payload):
        v = np.zeros((n, val_words), np.uint32)
        v[:, 0] = payload
        v[:, 1] = MAGIC
        return v

    # ai/sf: each subscriber has a random subset of types 1..4 (>= 1)
    ai_present = rng.random((p1, 4)) < 0.625   # 2.5 of 4 on average
    sf_present = rng.random((p1, 4)) < 0.625
    ai_present[0] = sf_present[0] = False
    ai_present[1:][ai_present[1:].sum(1) == 0, 0] = True
    sf_present[1:][sf_present[1:].sum(1) == 0, 0] = True

    # cf: each start time for 25% of the present sf rows
    cf_keys = []
    sfi, sft = np.nonzero(sf_present)
    for st in (0, 8, 16):
        mask = rng.random(len(sfi)) < 0.25
        cf_keys.append(tatp.cf_key(sfi[mask], sft[mask] + 1, st))
    cf_keys = np.unique(np.concatenate(cf_keys)).astype(np.uint64)

    s = tatp.create(n_subscribers, val_words=val_words, device=dev, **kw)
    sub_vals = mkvals(p1, np.arange(p1))
    ver1 = np.ones(p1, np.uint32)
    ver1[0] = 0
    quad = mkvals(4 * p1, np.arange(4 * p1))
    s.sub = dense.populate(s.sub, sub_vals, ver1)
    s.sec = dense.populate(s.sec, sub_vals, ver1)
    s.ai = dense.populate(s.ai, quad, ai_present.reshape(-1).astype(np.uint32))
    s.sf = dense.populate(s.sf, quad, sf_present.reshape(-1).astype(np.uint32))
    s.cf = kv.populate(s.cf, cf_keys,
                       mkvals(len(cf_keys), cf_keys.astype(np.uint32)))
    return [s] + [clone_tree(s) for _ in range(N_SHARDS - 1)], cf_keys


def host_replies(rep, n: int):
    """The first ``n`` lanes of replies, one host copy a field: (rtype i32,
    val u32 [n, VW], ver u32), the words read as np.uint32 from their
    int32 bit patterns."""
    return (rep.rtype[:n].cpu().numpy(),
            rep.val[:n].cpu().numpy().view(np.uint32),
            rep.ver[:n].cpu().numpy().view(np.uint32))


class Coordinator:
    """The wave coordinator over ``shards`` (three replicas on ``device``,
    None = CUDA), each wave at most one `tatp.step` of ``width`` lanes a
    shard."""

    def __init__(self, shards, n_subscribers: int, width: int = 4096,
                 val_words: int = 10, device=None):
        self.dev = resolve_device(device)
        self.shards = list(shards)
        for s in self.shards:
            if s.sub.ver.device.type != self.dev.type:
                raise ValueError(f"shard on {s.sub.ver.device}, "
                                 f"coordinator on {self.dev}")
        self.p = n_subscribers
        self.width = width
        self.vw = val_words
        # attribution counters mean something only over attr shards
        # (tatp.create(attr_locks=True)): the plain server cannot tell CF
        # same-key conflicts from hash sharing
        self.attr = isinstance(self.shards[0].cf_lock, locks.OCCAttrTable)
        self.stats = Stats()

    def _run_wave(self, ops, tbls, keys, shard_of=None, vals=None, vers=None):
        """One step a shard over the lanes routed to it (``key % 3`` unless
        ``shard_of`` says); returns the replies in lane order."""
        m = len(ops)
        rt = np.zeros(m, np.int32)
        rv = np.zeros((m, self.vw), np.uint32)
        rver = np.zeros(m, np.uint32)
        if vals is None:
            vals = np.zeros((m, self.vw), np.uint32)
        if vers is None:
            vers = np.zeros(m, np.uint32)
        if shard_of is None:
            shard_of = keys % N_SHARDS
        for s in range(N_SHARDS):
            idx = np.nonzero(shard_of == s)[0]
            if len(idx) == 0:
                continue
            assert len(idx) <= self.width
            batch = make_batch(ops[idx], keys[idx].astype(np.uint64),
                               vals[idx], vers=vers[idx], tables=tbls[idx],
                               width=self.width, val_words=self.vw,
                               device=self.dev)
            self.shards[s], rep = tatp.step(self.shards[s], batch)
            rt[idx], rv[idx], rver[idx] = host_replies(rep, len(idx))
        return rt, rv, rver

    def run_cohort(self, rng: np.random.Generator, w: int):
        """Draw one cohort of ``w`` txns from ``rng`` and drive it through
        the waves; returns the running `Stats`."""
        st = self.stats
        st.attempted += w
        T = tatp
        ttype = rng.choice(7, size=w, p=wl.TATP_MIX).astype(np.int32)
        s_id = wl.nurand(rng, wl.TATP_A, self.p, w).astype(np.int64)
        xtype = rng.integers(1, 5, size=w)          # ai_type / sf_type
        stime = rng.choice([0, 8, 16], size=w)

        # ---- wave 1: up to 4 lanes a txn: (op, table, key)
        K = 4
        ops = np.zeros((w, K), np.int32)
        tbl = np.zeros((w, K), np.int32)
        key = np.zeros((w, K), np.int64)
        sf_idx = s_id * 4 + (xtype - 1)
        ai_idx = s_id * 4 + (xtype - 1)
        cfk = tatp.cf_key(s_id, xtype, stime)

        def put(mask, lane, op, tb, k):
            ops[mask, lane] = op
            tbl[mask, lane] = tb
            key[mask, lane] = k[mask]

        t = ttype
        m = t == wl.TATP_GET_SUBSCRIBER
        put(m, 0, Op.OCC_READ, T.SUBSCRIBER, s_id)
        m = t == wl.TATP_GET_ACCESS
        put(m, 0, Op.OCC_READ, T.ACCESS_INFO, ai_idx)
        m = t == wl.TATP_GET_NEW_DEST
        put(m, 0, Op.OCC_READ, T.SPECIAL_FACILITY, sf_idx)
        put(m, 1, Op.OCC_READ, T.CALL_FORWARDING, cfk)
        m = t == wl.TATP_UPDATE_SUBSCRIBER
        put(m, 0, Op.OCC_READ, T.SUBSCRIBER, s_id)
        put(m, 1, Op.OCC_READ, T.SPECIAL_FACILITY, sf_idx)
        put(m, 2, Op.OCC_LOCK, T.SUBSCRIBER, s_id)
        put(m, 3, Op.OCC_LOCK, T.SPECIAL_FACILITY, sf_idx)
        m = t == wl.TATP_UPDATE_LOCATION
        put(m, 0, Op.OCC_READ, T.SEC_SUBSCRIBER, s_id)
        put(m, 1, Op.OCC_READ, T.SUBSCRIBER, s_id)
        put(m, 2, Op.OCC_LOCK, T.SUBSCRIBER, s_id)
        m = t == wl.TATP_INSERT_CF
        put(m, 0, Op.OCC_READ, T.SPECIAL_FACILITY, sf_idx)
        put(m, 1, Op.OCC_READ, T.CALL_FORWARDING, cfk)
        put(m, 2, Op.OCC_LOCK, T.CALL_FORWARDING, cfk)
        m = t == wl.TATP_DELETE_CF
        put(m, 0, Op.OCC_READ, T.CALL_FORWARDING, cfk)
        put(m, 1, Op.OCC_LOCK, T.CALL_FORWARDING, cfk)

        used = ops.reshape(-1) != 0
        txn_of = np.repeat(np.arange(w), K)[used]
        lane_of = np.tile(np.arange(K), w)[used]
        rt, rv, rver = self._run_wave(ops.reshape(-1)[used],
                                      tbl.reshape(-1)[used],
                                      key.reshape(-1)[used])
        # the magic word of every VAL (the reference client asserts it,
        # client_ebpf_shard.cc:879-884)
        isval = rt == Reply.VAL
        assert (rv[isval, 1] == MAGIC).all(), "magic corrupted"

        r_rt = np.full((w, K), -1, np.int32)
        r_ver = np.zeros((w, K), np.uint32)
        r_rt[txn_of, lane_of] = rt
        r_ver[txn_of, lane_of] = rver

        is_lock_lane = ops == Op.OCC_LOCK
        is_rej = (r_rt == Reply.REJECT) | (r_rt == Reply.REJECT_SAME_KEY)
        lock_rejected = (is_rej & is_lock_lane).any(1)
        if self.attr:
            # dense row locks are exact, so their rejects are same-key
            # conflicts; only the hashed CF lock table can reject on slot
            # sharing, which the attr server tells by REJECT_SAME_KEY
            # (lock_kern.c:292-298)
            is_dense_lane = tbl < T.CALL_FORWARDING
            st.lock_cnt += int(is_lock_lane.sum())
            st.reject_sharing_cnt += int(
                (is_lock_lane & ~is_dense_lane
                 & (r_rt == Reply.REJECT)).sum())
            st.reject_same_key_cnt += int(
                (is_lock_lane & ((r_rt == Reply.REJECT_SAME_KEY)
                                 | (is_dense_lane
                                    & (r_rt == Reply.REJECT)))).sum())

        # required rows
        missing = np.zeros(w, bool)
        m = t == wl.TATP_GET_ACCESS       # the ai row must exist (cc:583-587)
        missing |= m & (r_rt[:, 0] != Reply.VAL)
        m = t == wl.TATP_GET_NEW_DEST     # sf AND cf must exist
        missing |= m & ((r_rt[:, 0] != Reply.VAL)
                        | (r_rt[:, 1] != Reply.VAL))
        m = t == wl.TATP_UPDATE_SUBSCRIBER
        missing |= m & ((r_rt[:, 0] != Reply.VAL) | (r_rt[:, 1] != Reply.VAL))
        m = t == wl.TATP_UPDATE_LOCATION
        missing |= m & ((r_rt[:, 0] != Reply.VAL) | (r_rt[:, 1] != Reply.VAL))
        m = t == wl.TATP_INSERT_CF        # sf must exist; cf must NOT
        missing |= m & ((r_rt[:, 0] != Reply.VAL) | (r_rt[:, 1] == Reply.VAL))
        m = t == wl.TATP_DELETE_CF        # cf must exist
        missing |= m & (r_rt[:, 0] != Reply.VAL)

        is_ro = (t == wl.TATP_GET_SUBSCRIBER) | (t == wl.TATP_GET_ACCESS) | \
                (t == wl.TATP_GET_NEW_DEST)
        rw = ~is_ro
        # transport timeouts come first (a wire coordinator's; the
        # in-process steps never answer Reply.TIMEOUT): a lane whose reply
        # never came says nothing of locks or rows
        timed = (r_rt == Reply.TIMEOUT).any(1)
        st.aborted_timeout += int(timed.sum())
        alive = rw & ~lock_rejected & ~missing & ~timed
        st.aborted_lock += int((rw & lock_rejected & ~timed).sum())
        st.aborted_missing += int(
            (missing & ~(rw & lock_rejected) & ~timed).sum())

        # ---- wave 2: validate the read set (re-read, compare versions):
        # the OCC_READ lanes of live RW txns
        is_read_lane = (ops == Op.OCC_READ) & alive[:, None]
        v_used = is_read_lane.reshape(-1)
        if v_used.any():
            v_txn = np.repeat(np.arange(w), K)[v_used]
            v_lane = np.tile(np.arange(K), w)[v_used]
            vt, _, vver = self._run_wave(
                np.full(v_used.sum(), Op.OCC_READ, np.int32),
                tbl.reshape(-1)[v_used], key.reshape(-1)[v_used])
            changed = np.zeros(w, bool)
            # a row that vanished or changed version fails validation; an
            # InsertCF's cf read was NOT_EXIST and must still be
            bad = (vver != r_ver[v_txn, v_lane]) | \
                  ((vt != Reply.VAL) & (r_rt[v_txn, v_lane] == Reply.VAL))
            np.logical_or.at(changed, v_txn, bad)
            tmo2 = np.zeros(w, bool)   # a lost validate reply is no change
            np.logical_or.at(tmo2, v_txn, vt == Reply.TIMEOUT)
            st.aborted_timeout += int((alive & tmo2).sum())
            st.aborted_validate += int((alive & changed & ~tmo2).sum())
            alive = alive & ~changed & ~tmo2

        # ---- commit waves: the write set (table, key, kind) of each txn,
        # kind 0 = commit, 1 = insert, 2 = delete
        wr_ops = {0: Op.COMMIT_PRIM, 1: Op.INSERT_PRIM, 2: Op.DELETE_PRIM}
        bk_ops = {0: Op.COMMIT_BCK, 1: Op.INSERT_BCK, 2: Op.DELETE_BCK}
        w_tb, w_key, w_kind, w_txn = [], [], [], []

        def add_writes(mask, tb, k, kind):
            idxs = np.nonzero(mask)[0]
            w_tb.append(np.full(len(idxs), tb))
            w_key.append(k[idxs])
            w_kind.append(np.full(len(idxs), kind))
            w_txn.append(idxs)

        add_writes(alive & (t == wl.TATP_UPDATE_SUBSCRIBER), T.SUBSCRIBER,
                   s_id, 0)
        add_writes(alive & (t == wl.TATP_UPDATE_SUBSCRIBER),
                   T.SPECIAL_FACILITY, sf_idx, 0)
        add_writes(alive & (t == wl.TATP_UPDATE_LOCATION), T.SUBSCRIBER,
                   s_id, 0)
        add_writes(alive & (t == wl.TATP_INSERT_CF), T.CALL_FORWARDING, cfk, 1)
        add_writes(alive & (t == wl.TATP_DELETE_CF), T.CALL_FORWARDING, cfk, 2)

        if w_tb and sum(len(x) for x in w_tb):
            c_tb = np.concatenate(w_tb).astype(np.int32)
            c_key = np.concatenate(w_key).astype(np.int64)
            c_kind = np.concatenate(w_kind).astype(np.int32)
            c_txn = np.concatenate(w_txn)
            n_l = len(c_tb)
            c_val = np.zeros((n_l, self.vw), np.uint32)
            c_val[:, 0] = rng.integers(0, 1 << 16, size=n_l).astype(np.uint32)
            c_val[:, 1] = MAGIC
            prim = (c_key % N_SHARDS).astype(np.int64)

            # a TIMEOUT lane of any commit wave puts its whole txn in
            # doubt; later waves skip the doubted txns' lanes, so a write
            # that was not logged is never installed (the reference
            # resends until acked, client_ebpf_shard.cc:779-860)
            lane_to = np.zeros(n_l, bool)

            def wave(opv, shard_of):
                """One commit wave over the lanes of txns still clean;
                returns the replies of the lanes sent."""
                d = np.zeros(w, bool)
                np.logical_or.at(d, c_txn, lane_to)
                idx = np.nonzero(~d[c_txn])[0]
                rtw = np.zeros(0, np.int32)
                if len(idx):
                    rtw, _, _ = self._run_wave(opv[idx], c_tb[idx],
                                               c_key[idx], shard_of[idx],
                                               c_val[idx])
                    lane_to[idx] |= rtw == Reply.TIMEOUT
                return rtw

            log_op = np.where(c_kind == 2, Op.DELETE_LOG,
                              Op.COMMIT_LOG).astype(np.int32)
            for s in range(N_SHARDS):
                wave(log_op, np.full(n_l, s))
            bck = np.vectorize(bk_ops.get)(c_kind).astype(np.int32)
            for off in (1, 2):
                wave(bck, (prim + off) % N_SHARDS)
            pr = np.vectorize(wr_ops.get)(c_kind).astype(np.int32)
            prt = wave(pr, prim)
            assert (prt != Reply.NONE).all()

            in_doubt = np.zeros(w, bool)
            np.logical_or.at(in_doubt, c_txn, lane_to)
            st.aborted_timeout += int((alive & in_doubt).sum())
            alive = alive & ~in_doubt

        # ---- abort unlocks: the granted locks of dead RW txns (in-doubt
        # ones too: safe under one coordinator owning every in-flight txn,
        # as the reference's single client process does)
        dead = rw & ~alive
        ab_lane = is_lock_lane & (r_rt == Reply.GRANT) & dead[:, None]
        a_used = ab_lane.reshape(-1)
        if a_used.any():
            self._run_wave(np.full(a_used.sum(), Op.ABORT, np.int32),
                           tbl.reshape(-1)[a_used], key.reshape(-1)[a_used])

        st.committed += int((is_ro & ~missing & ~timed).sum() + alive.sum())
        return st
