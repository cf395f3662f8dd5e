"""The store's host tier: the backing KVS and the two-tier server (the port
of `dint_tpu.shim.host_kvs`).

`HostKVS` is the reference's userspace KVS worker (store/ebpf/store_user.c:
99-168: apply the evicted record the miss carries, then serve GET, SET,
INSERT and DELETE against the authoritative table), plus the bloom
bookkeeping the device cannot do. It is numpy end to end and the same code
as the JAX package's: a two-choice bucketed open-addressing table (8 slots
a bucket, grow and rehash under pressure, a small spill dict as the
overflow escape), batch lookup/upsert/delete, and exact per-(cache bucket,
bloom bit) liveness counters, so that DELETE keeps the device's bloom
words exact without a scan. `resolve_batch` keeps the engine's
serialization contract: per key, GETs see the pre-batch state and writes
apply in lane order with monotonic versions.

`CachedStore` is the two-tier server: the device cache
(`engines.store_cache`) in front, `HostKVS` behind, refills flowing back
at the start of each round. It calls `cache_step` and `refill` as plain
functions (JAX jits and donates them) and reads device words back with
``u32.to_numpy``. One more difference from JAX, for the reference's
24M-key keyspace: `CachedStore.populate` reserves the backing table for
all its keys, then loads it in chunks of `POPULATE_CHUNK` keys.
`HostKVS._place` seats one key a bucket slot a round for four rounds and
spills the rest to a Python dict, whose growth rehashes every live key in
one batch again; one 24M-key batch spilled millions and grew the table to
2^26 buckets (176 s on an H100 machine's host). Below one chunk of unique
keys the backing table is JAX's word for word; above, only where keys sit
differs, never a reply.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..engines import store_cache
from ..engines.types import Op, Reply, make_batch
from ..ops import hashing, u64
from ..ops.u32 import from_numpy, to_numpy

S = 8              # slots per backing bucket
GROW_SPILL = 1024  # spill-dict size that triggers a grow+rehash
POPULATE_CHUNK = 1 << 18   # keys a CachedStore.populate places at once


class HostKVS:
    """Authoritative backing store: vectorized two-choice hash table with
    per-cache-bucket bloom liveness counters."""

    def __init__(self, cache_buckets: int, val_words: int,
                 capacity: int = 1 << 15):
        self.cache_nb = cache_buckets
        self.vw = val_words
        nb = max(16, 1 << int(np.ceil(np.log2(max(capacity, 256) * 2 / S))))
        self._alloc(nb)
        # liveness count per (cache bucket, bloom bit); u16 add/sub exact
        # far past any realistic per-bit occupancy
        self._bloom_cnt = np.zeros(cache_buckets * 64, np.uint16)
        self._spill: dict[int, tuple[np.ndarray, int]] = {}
        self.n_live = 0

    def _alloc(self, nb: int):
        self.nb = nb
        self._keys = np.zeros((nb, S), np.uint64)
        self._used = np.zeros((nb, S), bool)
        self._vals = np.zeros((nb, S, self.vw), np.uint32)
        self._vers = np.zeros((nb, S), np.uint32)

    # ------------------------------------------------------------ core ops

    def _find(self, keys: np.ndarray):
        """Vectorized slot search. Returns (found [m], bkt [m], slot [m]);
        spill-dict keys report found=False here (callers check _spill)."""
        m = len(keys)
        b1, b2 = hashing.bucket_pair_np(keys, self.nb)
        found = np.zeros(m, bool)
        bkt = np.zeros(m, np.int64)
        slot = np.zeros(m, np.int64)
        for b in (np.asarray(b1, np.int64), np.asarray(b2, np.int64)):
            match = self._used[b] & (self._keys[b] == keys[:, None])
            hit = match.any(axis=1)
            take = hit & ~found
            bkt[take] = b[take]
            slot[take] = match.argmax(axis=1)[take]
            found |= hit
        return found, bkt, slot

    def contains(self, keys) -> np.ndarray:
        keys = np.asarray(keys, np.uint64)
        found, _, _ = self._find(keys)
        if not found.all() and self._spill:
            for i in np.nonzero(~found)[0]:
                found[i] = int(keys[i]) in self._spill
        return found

    def lookup(self, keys):
        """Batch read: (found [m], vals [m, VW], vers [m])."""
        keys = np.asarray(keys, np.uint64)
        found, bkt, slot = self._find(keys)
        vals = np.zeros((len(keys), self.vw), np.uint32)
        vers = np.zeros(len(keys), np.uint32)
        vals[found] = self._vals[bkt[found], slot[found]]
        vers[found] = self._vers[bkt[found], slot[found]]
        if self._spill:
            for i in np.nonzero(~found)[0]:
                ent = self._spill.get(int(keys[i]))
                if ent is not None:
                    found[i] = True
                    vals[i] = ent[0]
                    vers[i] = ent[1]
        return found, vals, vers

    def _bloom_add(self, keys: np.ndarray):
        idx = (hashing.bucket_np(keys, self.cache_nb).astype(np.int64) * 64
               + hashing.bloom_bit_np(keys).astype(np.int64))
        u, c = np.unique(idx, return_counts=True)
        self._bloom_cnt[u] += c.astype(np.uint16)

    def _bloom_sub(self, keys: np.ndarray):
        idx = (hashing.bucket_np(keys, self.cache_nb).astype(np.int64) * 64
               + hashing.bloom_bit_np(keys).astype(np.int64))
        u, c = np.unique(idx, return_counts=True)
        self._bloom_cnt[u] -= np.minimum(self._bloom_cnt[u],
                                         c.astype(np.uint16))

    def _insert_new(self, keys, vals, vers):
        """Place NEW unique keys (not present anywhere)."""
        self.n_live += len(keys)
        self._bloom_add(keys)
        self._place(keys, vals, vers)

    def _place(self, keys, vals, vers):
        """Raw placement (no bloom/liveness accounting): two-choice with
        in-batch (bucket, slot) contention retries; leftovers spill."""
        for _ in range(4):
            if len(keys) == 0:
                return
            b1, b2 = hashing.bucket_pair_np(keys, self.nb)
            b1 = np.asarray(b1, np.int64)
            b2 = np.asarray(b2, np.int64)
            use_b = np.where((~self._used[b1]).any(axis=1), b1, b2)
            free = ~self._used[use_b]
            has = free.any(axis=1)
            slot = free.argmax(axis=1)
            lin = use_b * S + slot
            _, first = np.unique(lin, return_index=True)
            win = np.zeros(len(keys), bool)
            win[first] = True
            ok = has & win
            self._used[use_b[ok], slot[ok]] = True
            self._keys[use_b[ok], slot[ok]] = keys[ok]
            self._vals[use_b[ok], slot[ok]] = vals[ok]
            self._vers[use_b[ok], slot[ok]] = vers[ok]
            keys, vals, vers = keys[~ok], vals[~ok], vers[~ok]
        for k, v, r in zip(keys, vals, vers):
            self._spill[int(k)] = (np.array(v, np.uint32), int(r))
        if len(self._spill) > GROW_SPILL:
            self._grow()

    def _grow(self):
        """Double the table and re-place every live entry (same live set,
        so bloom counters and n_live are untouched)."""
        live_b, live_s = np.nonzero(self._used)
        keys = self._keys[live_b, live_s]
        vals = self._vals[live_b, live_s]
        vers = self._vers[live_b, live_s]
        spill = self._spill
        self._spill = {}
        self._alloc(self.nb * 2)
        self._place(keys, vals, vers)
        if spill:
            sk = np.fromiter(spill.keys(), np.uint64, len(spill))
            sv = np.stack([v for v, _ in spill.values()])
            sr = np.fromiter((r for _, r in spill.values()), np.uint32,
                             len(spill))
            self._place(sk, sv, sr)

    def _reserve(self, extra: int):
        if (self.n_live + extra) > int(self.nb * S * 0.6):
            need = (self.n_live + extra) * 2 // S
            while self.nb < need:
                self._grow()

    def upsert_batch(self, keys, vals, vers):
        """Install (create-or-overwrite) keys with given versions.
        Duplicate keys collapse last-wins (a double _insert_new would
        occupy two slots and desync n_live/bloom counters)."""
        keys = np.asarray(keys, np.uint64)
        vals = np.asarray(vals, np.uint32)
        vers = np.asarray(vers, np.uint32)
        if len(keys) == 0:
            return
        _, ridx = np.unique(keys[::-1], return_index=True)
        if len(ridx) != len(keys):
            keep = len(keys) - 1 - ridx     # last occurrence of each key
            keys, vals, vers = keys[keep], vals[keep], vers[keep]
        self._reserve(len(keys))
        found, bkt, slot = self._find(keys)
        self._vals[bkt[found], slot[found]] = vals[found]
        self._vers[bkt[found], slot[found]] = vers[found]
        miss = ~found
        if miss.any() and self._spill:
            for i in np.nonzero(miss)[0]:
                k = int(keys[i])
                if k in self._spill:
                    self._spill[k] = (np.array(vals[i], np.uint32),
                                      int(vers[i]))
                    miss[i] = False
        if miss.any():
            self._insert_new(keys[miss], vals[miss], vers[miss])

    def delete_batch(self, keys):
        """Remove keys; returns found-mask (absent keys are no-ops).
        Duplicates collapse (double-clearing would over-decrement
        n_live/bloom counters)."""
        keys = np.asarray(keys, np.uint64)
        _, ridx = np.unique(keys[::-1], return_index=True)
        if len(ridx) != len(keys):
            dedup = np.zeros(len(keys), bool)
            dedup[len(keys) - 1 - ridx] = True
            out = np.zeros(len(keys), bool)
            sub = self.delete_batch(keys[dedup])
            out[np.nonzero(dedup)[0]] = sub
            # one lane per key carries the outcome; dup lanes read False
            return out
        found, bkt, slot = self._find(keys)
        self._used[bkt[found], slot[found]] = False
        gone = found.copy()
        if self._spill:
            for i in np.nonzero(~found)[0]:
                if self._spill.pop(int(keys[i]), None) is not None:
                    gone[i] = True
        self._bloom_sub(keys[gone])
        self.n_live -= int(gone.sum())
        return gone

    # ------------------------------------------------- protocol interfaces

    def populate(self, keys, vals, vers=None):
        keys = np.asarray(keys, np.uint64)
        vers = np.asarray(vers if vers is not None else np.ones(len(keys)),
                          np.uint32)
        self.upsert_batch(keys, np.asarray(vals, np.uint32), vers)

    def writeback_batch(self, keys, vals, vers):
        """Apply evicted dirty records (ext_message ver1==1 protocol)."""
        self.upsert_batch(keys, vals, vers)

    def bloom_words(self, cache_buckets) -> np.ndarray:
        """Exact bloom word per cache bucket from the liveness counters."""
        b = np.asarray(cache_buckets, np.int64)
        bits = self._bloom_cnt.reshape(-1, 64)[b] > 0       # [m, 64]
        weights = np.uint64(1) << np.arange(64, dtype=np.uint64)
        return (bits.astype(np.uint64) * weights).sum(axis=1,
                                                      dtype=np.uint64)

    def _live_keys(self) -> np.ndarray:
        """All live keys, ascending — the host-side ordered view (round-20
        dintscan). O(table) per call; scans through the cache tier are a
        deferral path, not the bandwidth-bound fast path (that is the
        authoritative store's OrderedRun)."""
        ks = self._keys[self._used].astype(np.uint64)
        if self._spill:
            ks = np.r_[ks, np.fromiter(self._spill.keys(), np.uint64,
                                       len(self._spill))]
        return np.sort(ks)

    def scan_batch(self, starts, lens, scan_max: int):
        """Range scans against current state: per lane, the first
        min(lens[i], scan_max) live keys >= starts[i] in key order.
        Returns a per-lane list of (key, val tuple, ver) rows — the
        oracle's row format (testing/oracle.StoreOracle.scan)."""
        live = self._live_keys()
        out = []
        for s, want in zip(np.asarray(starts, np.uint64),
                           np.asarray(lens, np.int64)):
            k = max(0, min(int(want), scan_max))
            i = np.searchsorted(live, s, side="left")
            ks = live[i:i + k]
            _, vals, vers = self.lookup(ks)
            out.append([(int(kk), tuple(int(x) for x in v), int(r))
                        for kk, v, r in zip(ks, vals, vers)])
        return out

    def resolve_batch(self, ops, keys, vals, scan_lens=None,
                      scan_max: int = 0):
        """Serve the deferred lanes of one batch with the engine's
        serialization contract (engines/store.py header): per key, GETs see
        pre-batch state, then writes apply in lane order with monotonic
        versions. Deferral is whole-segment, so every lane of a deferred key
        is here — semantics compose exactly with the cache's local segments.

        Op.SCAN lanes (always deferred by the cache — see
        store_cache.cache_step) resolve here too when ``scan_max`` > 0:
        they sit in phase 1 with the GETs (pre-batch state), rtype VAL
        with the row count in ver, and the return grows a 4th element —
        the per-lane row lists of scan_batch.

        Returns (rtype [m], val [m, VW], ver [m][, scans])."""
        ops = np.asarray(ops, np.int32)
        keys = np.asarray(keys, np.uint64)
        vals = np.asarray(vals, np.uint32)
        m = len(ops)
        rtype = np.zeros(m, np.int32)
        rver = np.zeros(m, np.uint32)
        rval = np.zeros((m, self.vw), np.uint32)
        scans: list[list] = [[] for _ in range(m)]

        # GET/SCAN phase: pre-batch state, fully vectorized
        gi = np.nonzero(ops == Op.GET)[0]
        if len(gi):
            found, gv, gr = self.lookup(keys[gi])
            rtype[gi] = np.where(found, Reply.VAL, Reply.NOT_EXIST)
            rval[gi[found]] = gv[found]
            rver[gi] = np.where(found, gr, 0)
        if scan_max > 0:
            si = np.nonzero(ops == Op.SCAN)[0]
            if len(si):
                lens = (np.asarray(scan_lens)[si]
                        if scan_lens is not None else np.zeros(len(si)))
                rows = self.scan_batch(keys[si], lens, scan_max)
                for i, rws in zip(si, rows):
                    scans[i] = rws
                rtype[si] = Reply.VAL
                rver[si] = np.array([len(r) for r in rows], np.uint32)

        def _done():
            return (rtype, rval, rver, scans) if scan_max > 0 \
                else (rtype, rval, rver)

        is_w = (ops == Op.SET) | (ops == Op.INSERT) | (ops == Op.DELETE)
        wi = np.nonzero(is_w)[0]
        if len(wi) == 0:
            return _done()
        order = np.argsort(keys[wi], kind="stable")
        sw = wi[order]                       # lanes in (key, arrival) order
        sk = keys[sw]
        head = np.r_[True, sk[1:] != sk[:-1]]
        seg = np.cumsum(head) - 1
        has_del = np.zeros(seg[-1] + 1, bool)
        np.logical_or.at(has_del, seg, ops[sw] == Op.DELETE)
        simple = ~has_del[seg]               # per sorted lane

        if simple.any():
            # SET/INSERT-only keys: ver = pre-ver + arrival rank + 1,
            # last lane's value installs
            pos = np.arange(len(sk))
            head_pos = np.maximum.accumulate(np.where(head, pos, 0))
            rank = pos - head_pos
            hmask = head & simple
            _, _, base = self.lookup(sk[hmask])
            base_per_seg = np.zeros(seg[-1] + 1, np.int64)
            base_per_seg[seg[hmask]] = base
            lane_ver = (base_per_seg[seg] + rank + 1)[simple]
            li = sw[simple]
            rtype[li] = Reply.ACK
            rver[li] = lane_ver.astype(np.uint32)
            last = np.r_[head[1:], True] & simple
            self.upsert_batch(sk[last], vals[sw[last]],
                              (base_per_seg[seg] + rank + 1)[last])

        if has_del.any():
            # delete-containing key groups: ordered scalar walk (rare)
            for li in np.nonzero(~simple)[0]:
                i = sw[li]
                k = keys[i:i + 1]
                if head[li]:
                    _, _, v0 = self.lookup(k)
                    base, cnt = int(v0[0]), 0
                if ops[i] in (Op.SET, Op.INSERT):
                    cnt += 1
                    self.upsert_batch(k, vals[i][None],
                                      np.array([base + cnt], np.uint32))
                    rtype[i] = Reply.ACK
                    rver[i] = base + cnt
                else:
                    gone = self.delete_batch(k)
                    rtype[i] = Reply.ACK if gone[0] else Reply.NOT_EXIST
        return _done()


@dataclasses.dataclass
class CacheStats:
    served: int = 0
    hits: int = 0          # lanes answered by the device cache
    misses: int = 0        # lanes deferred to the host
    bloom_negatives: int = 0
    writebacks: int = 0    # evicted dirty records applied


class CachedStore:
    """Two-tier store server: device cache + host KVS + refill loop, on
    ``device`` (None = CUDA)."""

    def __init__(self, cache_buckets: int, val_words: int = 10,
                 slots: int = 4, policy: str = store_cache.WB_BLOOM,
                 width: int = 4096, hot_keys: int = 0, device=None):
        """``hot_keys`` > 0 attaches the hot mirror of key ids
        [0, hot_keys) inside the device cache (`store_cache.CacheTable`)."""
        assert policy in store_cache.POLICIES
        self.device = resolve_device(device)
        self.cache = store_cache.create(cache_buckets, slots, val_words,
                                        hot_keys=hot_keys,
                                        device=self.device)
        self.kvs = HostKVS(cache_buckets, val_words)
        self.policy = policy
        self.vw = val_words
        self.width = width
        self.stats = CacheStats()
        self._pending: dict[int, bool] = {}    # refill keys (bloom-only if False)

    def populate(self, keys, vals, vers=None):
        """Load the backing store and prime the device bloom words, as a
        populate over the network would (every install travels the TC path
        and sets its bloom bit, store/ebpf/store_kern.c:302-372); a zeroed
        bloom would answer NOT_EXIST for populated keys not yet cached.
        The backing store grows once to hold every key (on an empty table
        the grows move nothing), then takes them in chunks of
        POPULATE_CHUNK (a later duplicate still wins)."""
        keys = np.asarray(keys, np.uint64)
        vals = np.asarray(vals, np.uint32)
        self.kvs._reserve(len(keys))
        for i in range(0, len(keys), POPULATE_CHUNK):
            j = slice(i, i + POPULATE_CHUNK)
            self.kvs.populate(keys[j], vals[j],
                              None if vers is None else np.asarray(vers)[j])
        t = self.cache.kv
        nb = t.n_buckets
        bloom = np.zeros(nb, np.uint64)
        np.bitwise_or.at(bloom, hashing.bucket_np(keys, nb),
                         np.uint64(1) << hashing.bloom_bit_np(keys)
                         .astype(np.uint64))
        t.bloom_hi = from_numpy((bloom >> np.uint64(32)).astype(np.uint32),
                                self.device)
        t.bloom_lo = from_numpy(bloom.astype(np.uint32), self.device)

    def _writeback_records(self, rec, mask):
        """Apply flushed or evicted dirty records to the backing store."""
        kh = to_numpy(rec["key_hi"])[mask]
        kl = to_numpy(rec["key_lo"])[mask]
        self.kvs.writeback_batch(u64.join(kh, kl),
                                 to_numpy(rec["val"])[mask],
                                 to_numpy(rec["ver"])[mask])
        self.stats.writebacks += int(mask.sum())

    def serve(self, ops, keys, vals=None, scan_lens=None,
              scan_max: int = 0):
        """One server round: refill, device step, host fallback.

        Op.SCAN lanes always miss (the cache holds an unordered subset of
        the keyspace) and resolve on the host in `resolve_batch`'s first
        phase; with ``scan_max`` > 0 the return grows a 4th element, the
        per-lane scan row lists (empty on other lanes).

        Returns (rtype [n], val [n, VW], ver [n][, scans]) numpy arrays."""
        n = len(ops)
        ops = np.asarray(ops, np.int32)
        keys = np.asarray(keys, np.uint64)
        scans: list[list] = [[] for _ in range(n)]
        if vals is None:
            vals = np.zeros((n, self.vw), np.uint32)

        self._do_refills()
        if scan_max > 0 and (ops == Op.SCAN).any():
            # scan barrier: the host answers scans from its own view, so
            # every dirty cached record must land there first; a point
            # deferral flushes its own segment's copy, a range crosses keys
            self._flush_dirty()
        batch = make_batch(ops, keys, vals, width=self.width,
                           val_words=self.vw, device=self.device)
        self.cache, replies, miss, flush = store_cache.cache_step(
            self.cache, batch, policy=self.policy)
        rtype = replies.rtype[:n].cpu().numpy()
        rval = to_numpy(replies.val[:n])
        rver = to_numpy(replies.ver[:n])
        miss = miss[:n].cpu().numpy()

        # the dirty cached copies of deferred segments land in the backing
        # store before their lanes are resolved (cache_step's contract)
        f_mask = flush["mask"].cpu().numpy()
        if f_mask.any():
            self._writeback_records(flush, f_mask)

        st = self.stats
        st.served += n
        st.misses += int(miss.sum())
        st.hits += int((~miss & (ops != Op.NOP)).sum())
        st.bloom_negatives += int((rtype[~miss] == Reply.NOT_EXIST).sum())

        # host fallback: the deferred lanes as one sub-batch
        mi = np.nonzero(miss)[0]
        if len(mi):
            out = self.kvs.resolve_batch(
                ops[mi], keys[mi], np.asarray(vals)[mi],
                scan_lens=(np.asarray(scan_lens)[mi]
                           if scan_lens is not None else None),
                scan_max=scan_max)
            rt, rv, rr = out[:3]
            rtype[mi], rver[mi] = rt, rr
            rval[mi] = rv
            if scan_max > 0:
                for i, rws in zip(mi, out[3]):
                    scans[i] = rws
            # refills: the record for present keys, the bloom word alone
            # after DELETE and for absent keys (keeps negatives exact);
            # scan starts are range predicates, not cacheable keys
            pt = mi[ops[mi] != Op.SCAN]
            for k, p in zip(keys[pt], self.kvs.contains(keys[pt])):
                self._pending[int(k)] = bool(p)
        if scan_max > 0:
            return rtype, rval, rver, scans
        return rtype, rval, rver

    def _flush_dirty(self):
        """Write back every dirty cached record (the scan barrier); the
        cached copies stay resident, now clean."""
        c = self.cache
        t = c.kv
        e = torch.nonzero(c.dirty & t.valid).squeeze(1)
        if len(e) == 0:
            return
        keys = u64.join(to_numpy(t.key_hi[e]), to_numpy(t.key_lo[e]))
        vals = to_numpy(t.val.view(-1, t.val_words)[e])
        vers = to_numpy(t.ver[e])
        self.kvs.writeback_batch(keys, vals, vers)
        self.stats.writebacks += len(e)
        c.dirty.zero_()

    def _do_refills(self):
        if not self._pending:
            return
        items = list(self._pending.items())[: self.width]
        for k, _ in items:
            del self._pending[k]
        key = np.array([k for k, _ in items], np.uint64)
        present = np.array([p for _, p in items], bool)

        # one install a bucket a call: re-queue the rest
        bkt = hashing.bucket_np(key, self.cache.kv.n_buckets)
        order = np.argsort(bkt, kind="stable")
        first = np.zeros(len(key), bool)
        ob = bkt[order]
        first[order] = np.r_[True, ob[1:] != ob[:-1]]
        for j in np.nonzero(~first)[0]:
            self._pending[int(key[j])] = bool(present[j])
        key, present, bkt = key[first], present[first], bkt[first]
        r = len(key)

        val = np.zeros((r, self.vw), np.uint32)
        ver = np.zeros(r, np.uint32)
        found, lv, lr = self.kvs.lookup(key)
        take = found & present
        val[take] = lv[take]
        ver[take] = lr[take]
        bloom = self.kvs.bloom_words(bkt)

        pad = self.width - r
        key_hi, key_lo = u64.split(key)
        b_hi, b_lo = u64.split(bloom)

        def p(x, fill=0):
            x = np.concatenate([x, np.full((pad,) + x.shape[1:], fill,
                                           x.dtype)])
            if x.dtype == np.bool_:
                return torch.from_numpy(x).to(self.device)
            return from_numpy(x, self.device)

        self.cache, ev = store_cache.refill(
            self.cache, p(key_hi), p(key_lo), p(val), p(ver), p(b_hi),
            p(b_lo), p(np.ones(r, bool), False))
        ev_mask = ev["mask"].cpu().numpy()
        if ev_mask.any():
            self._writeback_records(ev, ev_mask)
