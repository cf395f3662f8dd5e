"""The plain reference of the TATP cells: TATP under OCC over D shard
servers, each with its own subscribers, locks and log, in plain PyTorch.

It imports nothing of the measured package and takes nothing it made: it
decodes the benchmark's draws itself and starts from tables the benchmark
makes again from the seed. A step is the pipeline the configuration
states (DINT tatp/caladan/client_ebpf_shard.cc:608-939), cohort by cohort:

1. the cohort from two steps back commits: each write of a transaction
   that survived validation installs its row (version + 1; an insert
   makes the row exist, a delete clears it) and is appended to the log;
2. the cohort from one step back validates: a read-write transaction
   whose read rows changed version since its reads aborts;
3. a new cohort reads (a missing required row aborts it, a read-only
   transaction that read its rows commits) and locks its write rows,
   no-wait: a row locked in the previous step refuses, and of the
   requests on a free row the first in the cohort's order wins. A lock
   lives for the next step, through its holder's validation.

The log is L lanes of a ring each (DINT log_server/ebpf/ls_kern.c:63-77):
the step's write i (transaction-major, two write slots a transaction)
goes to lane i % L, after the lane's earlier writes of the step. With
``hops`` the shards are the sharded deployment: after every shard's own
step, shard p logs shard p-1's writes (tagged p-1+1 in the key's high
word), then shard p-2's, so every write is on three servers' logs.

``control`` names guarantees to break, for the control that has to come
out not correct: "no-validate" (OCC without its validation wave),
"log-2-replicas" (the third log copy never written).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import inputs

I32 = torch.int32
I64 = torch.int64
M32 = 0xFFFFFFFF
HDR = 4
SUB, SEC, AI, SF, CF = range(5)
N_STATS = 6    # attempted, committed, lock aborts, missing aborts,
#                validation aborts, bad magic words read


S_, X_, C_ = 0, 1, 2     # a lane's key: the subscriber, sf_idx, cf key
# Per transaction type, two lanes each (tatp/caladan/tatp.h:45-63): the
# rows read (table, key, used), which must exist (``need``) or must not
# (``absent``: insert call forwarding's new row), and the rows written
# and locked (table, key, used, kind: 0 update, 1 insert, 2 delete).
# Types: get subscriber data, get access data, get new destination,
# update subscriber data, update location, insert and delete call
# forwarding.
TYPES = {
    "r_tbl": [[SUB, 0], [AI, 0], [SF, CF], [SUB, SF], [SEC, SUB], [SF, CF],
              [CF, 0]],
    "r_key": [[S_, 0], [X_, 0], [X_, C_], [S_, X_], [S_, S_], [X_, C_],
              [C_, 0]],
    "r_ok": [[1, 0], [1, 0], [1, 1], [1, 1], [1, 1], [1, 1], [1, 0]],
    "need": [[0, 0], [1, 0], [1, 1], [1, 1], [1, 1], [1, 0], [1, 0]],
    "absent": [[0, 0], [0, 0], [0, 0], [0, 0], [0, 0], [0, 1], [0, 0]],
    "w_tbl": [[SUB, SF]] * 5 + [[CF, SF]] * 2,
    "w_key": [[S_, X_]] * 5 + [[C_, X_]] * 2,
    "w_ok": [[0, 0]] * 3 + [[1, 1], [1, 0], [1, 0], [1, 0]],
    "w_kind": [[0, 0]] * 5 + [[1, 0], [2, 0]],
}
TYPES = {k: np.asarray(v, np.int64) for k, v in TYPES.items()}
for _k in ("r_ok", "need", "absent", "w_ok"):
    TYPES[_k] = TYPES[_k].astype(bool)


def u32(x: torch.Tensor) -> torch.Tensor:
    return x.to(I64) & M32


def i32(x: torch.Tensor) -> torch.Tensor:
    x = x & M32
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(I32)


class Cohort:
    """A cohort between its waves: its reads, write slots and verdicts,
    a row per shard."""


class TatpReference:
    def __init__(self, seed: int, *, parts: int, n_sub: int, w: int,
                 val_words: int, mix, nurand_a: int, log_lanes: int,
                 log_capacity: int, device, control=()):
        """``parts`` shards of ``n_sub`` subscribers, each starting from
        the benchmark's tables of its partition (`inputs.tatp_tables`)
        made again from ``seed``. With more than one shard, the shards
        are the sharded deployment (``hops``)."""
        self.D, self.rows = parts, inputs.tatp_rows(n_sub)
        self.dev = torch.device(device)
        self.n, self.w, self.vw = n_sub, w, val_words
        # one row past the shards' rows takes the writes of masked lanes,
        # so no write waits on the host to learn which lanes are live
        self.dump = self.D * self.rows
        self.meta = torch.zeros(self.dump + 1, dtype=I32, device=self.dev)
        self.val = torch.zeros((self.dump + 1, val_words), dtype=I32,
                               device=self.dev)
        for p in range(parts):
            m, v = inputs.tatp_tables(seed, p, n_sub, val_words, self.dev)
            self.meta[p * self.rows:(p + 1) * self.rows] = m
            self.val[p * self.rows:(p + 1) * self.rows] = v.view(-1,
                                                                 val_words)
            del m, v
        self.lock = torch.zeros(self.dump + 1, dtype=I32, device=self.dev)
        self.base = torch.as_tensor(inputs.tatp_bases(n_sub), dtype=I64,
                                    device=self.dev)
        self.thresh = torch.as_tensor(inputs.mix_thresholds(mix),
                                      device=self.dev)
        self.a = int(nurand_a)
        self.types = {k: torch.as_tensor(v, device=self.dev)
                      for k, v in TYPES.items()}
        self.L, self.cap = log_lanes, log_capacity
        self.E = HDR + val_words
        self.ring = torch.zeros((self.D, log_lanes * log_capacity + 1,
                                 self.E), dtype=I32, device=self.dev)
        self.head = torch.zeros((self.D, log_lanes), dtype=I64,
                                device=self.dev)
        self.hops = parts > 1
        self.control = frozenset(control)
        self.t = 2
        self.c1 = self.c2 = None
        self.off = (torch.arange(self.D, device=self.dev, dtype=I64)
                    * self.rows)[:, None]

    # ----------------------------------------------------------- a step
    def step(self, bits, payload) -> torch.Tensor:
        """One step: ``bits`` i32 [D, w, 4] (None: no new cohort, the
        drain) and ``payload`` i32 [D, w, 2]. Returns the committing
        cohort's counts, i64 [D, N_STATS]."""
        stats = self._stats(self.c2)
        rec = self._install(self.c2, payload)
        if rec is not None:
            self._log(rec, torch.zeros(self.D, dtype=I64, device=self.dev))
            if self.hops:
                for off in (1, 2):
                    if off == 2 and "log-2-replicas" in self.control:
                        continue
                    src = (torch.arange(self.D, device=self.dev) - off) \
                        % self.D
                    self._log({k: v[src] for k, v in rec.items()}, src + 1)
        if "no-validate" not in self.control:
            self._validate(self.c1)
        new = None if bits is None else self._wave1(bits)
        self.c2, self.c1 = self.c1, new
        self.t += 1
        return stats

    def _stats(self, c) -> torch.Tensor:
        if c is None:
            return torch.zeros((self.D, N_STATS), dtype=I64,
                               device=self.dev)
        return torch.stack([
            torch.full((self.D,), self.w, dtype=I64, device=self.dev),
            (c.ro_commit | c.alive).sum(1), c.ab_lock, c.ab_missing,
            c.ab_validate, c.magic_bad], dim=1)

    # ---------------------------------------------------------- waves
    def _install(self, c, payload):
        if c is None:
            return None
        wmask = (c.ws_active & c.alive[:, :, None]).reshape(self.D, -1)
        grow = (c.ws_row + self.off[:, :, None]).reshape(self.D, -1)
        kind = c.ws_kind.reshape(self.D, -1)
        cur = self.meta[grow]
        ver = (u32(cur) >> 1) + 1
        exists = (kind != 2).to(I64)
        new_meta = i32(((ver << 1) | exists) & M32)
        newval = torch.zeros((self.D, 2 * self.w, self.vw), dtype=I32,
                             device=self.dev)
        keep = kind != 2
        newval[..., 0] = torch.where(keep, payload.reshape(self.D, -1), 0)
        newval[..., 1] = torch.where(keep, inputs.TATP_MAGIC, 0)
        rows = torch.where(wmask, grow, self.dump).reshape(-1)
        self.meta.index_put_((rows,), new_meta.reshape(-1))
        self.val.index_put_((rows,), newval.reshape(-1, self.vw))
        return {"mask": wmask, "tbl": c.ws_tbl.reshape(self.D, -1),
                "key": c.ws_key.reshape(self.D, -1),
                "is_del": (kind == 2).to(I64), "ver": i32(ver),
                "val": newval}

    def _log(self, rec, key_hi):
        """Append ``rec``'s writes to each shard's ring, tagged
        ``key_hi`` [D]."""
        m = rec["mask"]
        r = m.shape[1]
        pos = torch.arange(r, device=self.dev)
        lane = pos % self.L
        pad = (-r) % self.L
        # a write's rank among its lane's writes of the step: lanes are
        # the residues of the position, so a scan along each residue
        mi = torch.nn.functional.pad(m.to(I64), (0, pad)).view(
            self.D, -1, self.L).transpose(1, 2).contiguous()
        rank = (torch.cumsum(mi, 2) - mi).transpose(1, 2).reshape(
            self.D, -1)[:, :r]
        slot = (self.head[:, lane] + rank) % self.cap
        flat = torch.where(m, lane[None] * self.cap + slot,
                           self.L * self.cap)                  # [D, r]
        flags = rec["is_del"] | (u32(rec["tbl"]) << 8)
        entry = torch.cat([
            i32(flags)[..., None],
            i32(key_hi[:, None].expand(-1, r).to(I64))[..., None],
            rec["key"].to(I32)[..., None], rec["ver"][..., None],
            rec["val"]], dim=2)
        dd = torch.arange(self.D, device=self.dev)[:, None].expand(-1, r)
        self.ring.index_put_((dd.reshape(-1), flat.reshape(-1)),
                             entry.reshape(-1, self.E))
        self.head += mi.sum(2)

    def _validate(self, c):
        if c is None:
            return
        cur = self.meta[c.r_row + self.off[:, :, None]]
        bad = (c.r_ok & (cur != c.r_meta)).any(2)
        c.ab_validate = (c.alive & bad).sum(1)
        c.alive = c.alive & ~bad

    def _wave1(self, bits) -> Cohort:
        D, w, dev = self.D, self.w, self.dev
        b = u32(bits)
        ttype = (self.thresh[None, None] <= b[..., 0:1]).sum(2).clamp(max=6)
        n = self.n
        x = b[..., 1] % (self.a + 1)
        y = b[..., 2] % n + 1
        s = ((x | y) % n) + 1
        xtype = b[..., 3] % 4 + 1
        st = (b[..., 3] >> 2) % 3
        sf_idx = s * 4 + xtype - 1
        cfk = s * 12 + (xtype - 1) * 3 + st
        keys = torch.stack([s, sf_idx, cfk], 2)                # [D, w, 3]
        T = self.types

        def lanes(tbl, key):
            """Each transaction's two lanes of a kind: table row ids."""
            return self.base[tbl[ttype]] + keys.gather(2, key[ttype])

        # the read set and its rules (TYPES below)
        r_row = lanes(T["r_tbl"], T["r_key"])
        r_ok = T["r_ok"][ttype]
        g = r_row + self.off[:, :, None]
        r_meta = self.meta[g]
        ex = r_ok & ((r_meta & 1) != 0)
        magic = self.val[g.reshape(-1), 1].view(D, w, 2)
        magic_bad = (ex & (magic != inputs.TATP_MAGIC)).sum((1, 2))
        missing = ((T["need"][ttype] & ~ex & r_ok)
                   | (T["absent"][ttype] & ex)).any(2)
        rw = ttype >= 3

        # write slots (= lock requests)
        ws_row = lanes(T["w_tbl"], T["w_key"])
        ws_active = T["w_ok"][ttype]
        ws_tbl = T["w_tbl"][ttype]
        ws_key = keys.gather(2, T["w_key"][ttype])
        ws_kind = T["w_kind"][ttype]

        # no-wait locks: free rows go to their first request
        gw = (ws_row + self.off[:, :, None]).reshape(-1)
        cand = ws_active.reshape(-1) & (self.lock[gw] != self.t - 1)
        pos = torch.arange(gw.numel(), device=dev)
        key = torch.where(cand, gw * (2 * w * D) + pos, torch.iinfo(I64).max)
        order = torch.argsort(key)
        srow = gw[order]
        scand = cand[order]
        first = scand & torch.cat([torch.ones(1, dtype=torch.bool,
                                              device=dev),
                                   srow[1:] != srow[:-1]])
        granted = torch.zeros_like(cand).scatter_(0, order, first)
        self.lock.index_put_((torch.where(granted, gw, self.dump),),
                             torch.full_like(gw, self.t, dtype=I32))
        granted = granted.view(D, w, 2)
        lock_rej = (ws_active & ~granted).any(2)

        c = Cohort()
        c.r_row, c.r_ok, c.r_meta = r_row, r_ok, r_meta
        c.ws_row, c.ws_active, c.ws_tbl = ws_row, ws_active, ws_tbl
        c.ws_key, c.ws_kind = ws_key, ws_kind
        c.alive = rw & ~lock_rej & ~missing
        c.ro_commit = ~rw & ~missing
        c.ab_lock = (rw & lock_rej).sum(1)
        c.ab_missing = ((rw & ~lock_rej & missing) | (~rw & missing)).sum(1)
        c.ab_validate = torch.zeros(D, dtype=I64, device=dev)
        c.magic_bad = magic_bad
        return c

    # -------------------------------------------------------- outputs
    def tables(self):
        """Each shard's final tables: meta i32 [D, rows], val i32
        [D, rows * vw]."""
        return (self.meta[:self.dump].view(self.D, self.rows),
                self.val[:self.dump].view(self.D, -1))

    def log(self):
        """Each shard's ring i32 [D, lanes * capacity, HDR + vw] (slot
        lane * capacity + position) and its heads, u32 i64 [D, lanes]."""
        return self.ring[:, :-1], self.head & M32

    def locks_held(self) -> int:
        """Rows locked in the last step (none after a drain)."""
        return int((self.lock[:self.dump] == self.t - 1).sum())
