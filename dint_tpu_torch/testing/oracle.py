"""Sequential (pure Python dict) oracles for differential testing: the
port's copy of `dint_tpu.testing.oracle` (numpy only, the same models).

Each oracle implements the serialization contract that the batched engine
documents, so engine output must match the oracle exactly, batch for
batch: the store's upserts with monotonic versions, the 2PL lock server's
no-wait grants, and the OCC version server's lock/commit/read order.
"""
from __future__ import annotations

import numpy as np

from ..engines.types import Op, Reply

VER0 = 0


class StoreOracle:
    """Sequential model of engines.store: per key, GETs see pre-batch state,
    then writes apply in lane order; SET/INSERT are upserts bumping a
    monotonic version; DELETE invalidates."""

    def __init__(self):
        self.data: dict[int, tuple[tuple, int]] = {}   # key -> (val tuple, ver)

    def scan(self, start_key: int, scan_len: int):
        """Range scan against pre-batch state: the first `scan_len` live
        keys >= start_key in key order, as [(key, val tuple, ver), ...].
        SCANs are reads — they sit in phase 1 with the GETs."""
        rows = []
        for k in sorted(self.data):
            if len(rows) >= scan_len:
                break
            if k >= int(start_key):
                rows.append((k, self.data[k][0], self.data[k][1]))
        return rows

    def step(self, ops, keys, vals, scan_lens=None, scan_max: int = 0):
        """One batch. `scan_lens` [r] carries Op.SCAN lanes' requested row
        counts (clipped to scan_max, the engine's static slab width).
        Returns (rtype, rval, rver) — plus `scans`, a per-lane list of
        scan row lists, when scan_max > 0."""
        r = len(ops)
        rtype = np.zeros(r, np.int32)
        rver = np.zeros(r, np.uint32)
        rval = np.zeros((r, np.asarray(vals).shape[1]), np.uint32)
        scans: list[list] = [[] for _ in range(r)]
        # phase 1: reads against pre-state
        for i in range(r):
            if ops[i] == Op.GET:
                ent = self.data.get(int(keys[i]))
                if ent is None:
                    rtype[i] = Reply.NOT_EXIST
                else:
                    rtype[i] = Reply.VAL
                    rval[i] = ent[0]
                    rver[i] = ent[1]
            elif ops[i] == Op.SCAN:
                want = int(scan_lens[i]) if scan_lens is not None else 0
                rows = self.scan(int(keys[i]), max(0, min(want, scan_max)))
                scans[i] = rows
                rtype[i] = Reply.VAL
                rver[i] = np.uint32(len(rows))
        # phase 2: writes in lane order
        # version base = pre-batch version, recorded at the key's first write
        # in the batch; versions stay monotonic across delete+reinsert within
        # a batch (ABA avoidance — stronger than the reference's kvs)
        base: dict[int, int] = {}
        cnt: dict[int, int] = {}

        def touch(k):
            if k not in base:
                base[k] = self.data[k][1] if k in self.data else VER0
                cnt[k] = 0

        for i in range(r):
            k = int(keys[i])
            if ops[i] in (Op.SET, Op.INSERT):
                touch(k)
                cnt[k] += 1
                ver = base[k] + cnt[k]
                self.data[k] = (tuple(int(x) for x in vals[i]), ver)
                rtype[i] = Reply.ACK
                rver[i] = ver
            elif ops[i] == Op.DELETE:
                touch(k)
                if k in self.data:
                    del self.data[k]
                    rtype[i] = Reply.ACK
                else:
                    rtype[i] = Reply.NOT_EXIST
        if scan_max > 0:
            return rtype, rval, rver, scans
        return rtype, rval, rver


class SXLockOracle:
    """Sequential model of engines.lock2pl: per slot, releases apply first,
    then acquires in lane order under no-wait 2PL."""

    def __init__(self, n_slots: int):
        self.num_sh = np.zeros(n_slots, np.int64)
        self.num_ex = np.zeros(n_slots, np.int64)

    def step(self, ops, slots):
        r = len(ops)
        rtype = np.zeros(r, np.int32)
        for i in range(r):  # releases first
            s = int(slots[i])
            if ops[i] == Op.REL_S:
                self.num_sh[s] = max(self.num_sh[s] - 1, 0)
                rtype[i] = Reply.ACK
            elif ops[i] == Op.REL_X:
                self.num_ex[s] = max(self.num_ex[s] - 1, 0)
                rtype[i] = Reply.ACK
        for i in range(r):  # acquires in lane order
            s = int(slots[i])
            if ops[i] == Op.ACQ_S:
                if self.num_ex[s] == 0:
                    self.num_sh[s] += 1
                    rtype[i] = Reply.GRANT
                else:
                    rtype[i] = Reply.REJECT
            elif ops[i] == Op.ACQ_X:
                if self.num_ex[s] == 0 and self.num_sh[s] == 0:
                    self.num_ex[s] += 1
                    rtype[i] = Reply.GRANT
                else:
                    rtype[i] = Reply.REJECT
        return rtype


class OCCOracle:
    """Sequential model of engines.fasst: per slot, unlocks (commit/abort)
    first, then reads, then lock acquires in lane order."""

    def __init__(self, n_slots: int):
        self.locked = np.zeros(n_slots, bool)
        self.ver = np.zeros(n_slots, np.uint32)

    def step(self, ops, slots):
        r = len(ops)
        rtype = np.zeros(r, np.int32)
        rver = np.zeros(r, np.uint32)
        rlocked = np.zeros(r, np.uint32)
        for i in range(r):  # commits/aborts first
            s = int(slots[i])
            if ops[i] == Op.COMMIT_VER:
                self.ver[s] += 1
                self.locked[s] = False
                rtype[i] = Reply.ACK
            elif ops[i] == Op.ABORT:
                self.locked[s] = False
                rtype[i] = Reply.ACK
        for i in range(r):  # reads see post-commit versions + lock bits
            if ops[i] == Op.READ_VER:
                s = int(slots[i])
                rtype[i] = Reply.VAL
                rver[i] = self.ver[s]
                rlocked[i] = np.uint32(self.locked[s])
        for i in range(r):  # lock acquires in lane order
            if ops[i] == Op.LOCK:
                s = int(slots[i])
                if not self.locked[s]:
                    self.locked[s] = True
                    rtype[i] = Reply.GRANT
                else:
                    rtype[i] = Reply.REJECT
        return rtype, rver, rlocked
