"""The microbenchmark clients (the port of `dint_tpu.clients.micro`):
host-side, wave-batched equivalents of the reference's store, lock_2pl,
lock_fasst and log_server clients.

  * StoreClient: GET/SET mix over a populated table
    (store/caladan/client_caladan.cc:56-66, with the magic-word check
    every read asserts, :160).
  * Lock2PLClient: trace replay of sorted-key lock txns under no-wait 2PL;
    all of a txn's locks go out in one wave, and a txn with any REJECT
    releases what it got and restarts (lock_2pl/caladan/client.cc:205-219).
  * FasstClient: FaSST OCC replay: read-set READ_VER + write-set LOCK in
    one wave (lock_fasst/caladan/client.cc:246-277), the validation
    re-read (:199-215), then COMMIT_VER or ABORT (:216-236).
  * LogClient: log-append replay (log_server/caladan/client.cc:147-167).

A wave's wall time, replies read back, is attributed to every request in
it; a txn's latency runs from the first wave of its attempt chain to its
commit (tatp/caladan/client_ebpf_shard.cc:1617-1652).

What differs from JAX: the store's routes are explicit arguments, off by
default (``use_hotset``, ``use_scan``); nothing is read from the
environment, and there is no ``use_pallas``, since the port always takes
the kernel route. A step is a plain call on the client's state, updated
in place; the lock engines' ``(state, replies)`` step is wrapped to the
``(state, (replies,))`` form `_SteppedClient._wave` reads.
"""
from __future__ import annotations

import time

import numpy as np

from ..device import resolve_device
from ..engines import fasst, lock2pl, logsrv, store
from ..engines.types import Op, Reply, make_batch
from ..ops.u32 import to_numpy
from ..stats import Recorder
from ..tables import kv, locks
from ..tables import log as logring
from ..tables import run as run_mod
from . import workloads as wl

STORE_MAGIC = 0x55AA


def make_store_table(n_keys: int, *, n_buckets: int | None = None,
                     val_words: int = 10, device=None) -> kv.KVTable:
    """Populated store table on ``device`` (None = CUDA): keys 1..n, val
    word 0 = key, word 1 = the magic (store/caladan/client_caladan.cc:160),
    2^ceil(log2(n/2)) buckets of 4 slots unless ``n_buckets`` is given."""
    if n_buckets is None:
        n_buckets = max(16, 1 << int(np.ceil(np.log2(n_keys / 2))))
    keys = np.arange(1, n_keys + 1, dtype=np.uint64)
    vals = np.zeros((n_keys, val_words), np.uint32)
    vals[:, 0] = keys.astype(np.uint32)
    vals[:, 1] = STORE_MAGIC
    return kv.populate(kv.create(n_buckets, val_words=val_words,
                                 device=device), keys, vals)


def cache_stream(rng: np.random.Generator, n_keys: int, width: int,
                 n_rounds: int, val_words: int = 10) -> list:
    """The cache tier's traffic over a store of keys 1..n_keys: a GET sweep
    of the hot prefix [1, SB_HOT_FRAC * n_keys] that warms the cache, then
    ``n_rounds`` rounds of ``width`` lanes, 50/50 GET/SET (the reference's
    'contention' mix), keys SB_HOT_PROB from the prefix as the store
    runner draws, the rest uniform over [1, 1.1 * n_keys) so that absent
    keys exercise the bloom negatives. SET values carry the magic word.
    A list of (ops, keys, vals) numpy rounds, vals None in the sweep."""
    hot_n = int(n_keys * wl.SB_HOT_FRAC)
    sweep = np.arange(1, hot_n + 1, dtype=np.uint64)
    out = [(np.full(len(k), Op.GET, np.int32), k, None)
           for k in (sweep[i:i + width] for i in range(0, hot_n, width))]
    for _ in range(n_rounds):
        hot = rng.random(width) < wl.SB_HOT_PROB
        keys = np.where(hot, rng.integers(1, hot_n + 1, width),
                        rng.integers(1, int(n_keys * 1.1), width)
                        ).astype(np.uint64)
        ops = np.where(rng.random(width) < 0.5, Op.GET,
                       Op.SET).astype(np.int32)
        vals = np.zeros((width, val_words), np.uint32)
        vals[:, 0] = rng.integers(0, 1 << 30, width)
        vals[:, 1] = STORE_MAGIC
        out.append((ops, keys, vals))
    return out


class _SteppedClient:
    """Shared plumbing: the step over the client's state, and a timed wave
    runner whose wall time (replies read back) counts as device time."""

    def __init__(self, state, step_fn, width: int, val_words: int, device):
        self.state = state
        self.width = width
        self.vw = val_words
        self.device = device
        self._step = step_fn
        self.rec = Recorder()

    def _wave(self, ops, keys, vals=None, vers=None, tables=None):
        """Run one batch; returns (rtype, rval, rver, step output, wall s)."""
        m = len(ops)
        assert m <= self.width, f"wave of {m} exceeds width {self.width}"
        batch = make_batch(ops, keys, vals, vers=vers, tables=tables,
                           width=self.width, val_words=self.vw,
                           device=self.device)
        t0 = time.monotonic()
        self.state, out = self._step(self.state, batch)
        rep = out[0]
        rt = rep.rtype[:m].cpu().numpy()
        dt = time.monotonic() - t0
        self.rec.device_busy_s += dt
        return rt, to_numpy(rep.val[:m]), to_numpy(rep.ver[:m]), out, dt


class StoreClient(_SteppedClient):
    """GET/SET mix over a populated table. ``read_frac=1.0`` is the
    reference's 'parallel' benchmark, 0.5 its 'contention' one
    (store/caladan/client_caladan.cc:56-66).

    ``key_dist="zipfian"`` draws keys from the Zipfian whose hot head is
    the smallest key ids (`workloads.zipf_keys`). ``use_hotset`` attaches
    the hot mirror of the first ``hot_frac`` (0.04) of the keyspace and
    threads it through every step (replies identical to the plain route).

    ``use_scan`` attaches the ordered run and lets waves carry Op.SCAN
    lanes (``scan_frac`` of the mix, lengths uniform in [1,
    ``max_scan_len``] clipped to ``scan_max``). A scan must answer VAL,
    except when the run's overlay went stale: then it answers RETRY, the
    client rebuilds the run and re-sends exactly those lanes, which must
    answer VAL. The run is also rebuilt every ``rebuild_every`` waves."""

    def __init__(self, table: kv.KVTable, n_keys: int, width: int = 4096,
                 val_words: int = 10, read_frac: float = 0.5,
                 key_dist: str = "uniform", zipf_theta: float = wl.ZIPF_THETA,
                 hot_frac: float | None = None, use_hotset: bool = False,
                 use_scan: bool = False, scan_frac: float = 0.0,
                 scan_max: int = 8, max_scan_len: int | None = None,
                 delta_cap: int = 64, rebuild_every: int = 8):
        assert key_dist in ("uniform", "zipfian")
        self.use_hotset = bool(use_hotset)
        self.use_scan = bool(use_scan)
        self.scan_max = int(scan_max)
        self.scan_frac = float(scan_frac) if self.use_scan else 0.0
        self.max_scan_len = int(max_scan_len or scan_max)
        self.delta_cap = int(delta_cap)
        self.rebuild_every = max(int(rebuild_every), 1)
        self._waves_since_rebuild = 0
        run0 = (run_mod.from_table(table, delta_cap=self.delta_cap)
                if self.use_scan else None)
        hot = None
        if self.use_hotset:
            frac = 0.04 if hot_frac is None else float(hot_frac)
            # mirror ids are key_lo < hot_n; keys are 1-based, so cover
            # keys 1..frac*n with hot_n = frac*n + 1
            hot_n = min(int(n_keys * frac) + 1, n_keys + 1)
            hot = store.attach_hot(table, hot_n)
        smax = self.scan_max

        def step_fn(state, batch):
            t, h, rn = state
            out = store.step(t, batch, hot=h, run=rn, scan_max=smax)
            rest = list(out[2:])
            if h is not None:
                h = rest.pop(0)
            if rn is not None:
                rn = rest.pop(0)
            return (out[0], h, rn), (out[1], *rest)

        super().__init__((table, hot, run0), step_fn, width, val_words,
                         table.key_hi.device)
        self.n_keys = n_keys
        self.read_frac = read_frac
        self.key_dist = key_dist
        self.zipf_theta = zipf_theta

    @classmethod
    def populated(cls, n_keys: int, *, n_buckets: int | None = None,
                  val_words: int = 10, device=None, **kw):
        table = make_store_table(n_keys, n_buckets=n_buckets,
                                 val_words=val_words, device=device)
        return cls(table, n_keys, val_words=val_words, **kw)

    def _keys(self, rng: np.random.Generator, n: int) -> np.ndarray:
        if self.key_dist == "zipfian":
            return wl.zipf_keys(rng, n, self.n_keys, self.zipf_theta)
        return rng.integers(1, self.n_keys + 1, size=n).astype(np.uint64)

    def _rebuild(self):
        t, h, rn = self.state
        self.state = (t, h, store.rebuild_run(t, rn))
        self._waves_since_rebuild = 0

    def run_wave(self, rng: np.random.Generator, n: int | None = None):
        n = n or self.width
        keys = self._keys(rng, n)
        is_scan = rng.random(n) < self.scan_frac
        is_read = ~is_scan & (rng.random(n) < self.read_frac)
        ops = np.where(is_scan, Op.SCAN,
                       np.where(is_read, Op.GET, Op.SET)).astype(np.int32)
        vals = np.zeros((n, self.vw), np.uint32)
        vals[:, 0] = rng.integers(0, 1 << 30, size=n).astype(np.uint32)
        vals[:, 1] = STORE_MAGIC
        vers = None
        if self.use_scan:
            vers = np.where(is_scan,
                            wl.scan_lengths(rng, n, self.max_scan_len),
                            0).astype(np.uint32)
        else:
            assert not is_scan.any(), "scan lanes need use_scan=True"
        rt, rv, rr, out, dt = self._wave(ops, keys, vals, vers)
        got = rt[is_read] == Reply.VAL
        assert got.all(), "populated key missing"
        assert (rv[is_read][:, 1] == STORE_MAGIC).all(), "magic corrupted"
        ok = int((rt == Reply.VAL).sum() + (rt == Reply.ACK).sum())
        if self.use_scan:
            sc = rt[is_scan]
            assert np.isin(sc, (Reply.VAL, Reply.RETRY)).all(), \
                "scan lane answered neither VAL nor RETRY"
            cnt = out[1].count[:n].cpu().numpy()
            okv = is_scan & (rt == Reply.VAL)
            assert (cnt[okv] <= np.minimum(vers[okv], self.scan_max)).all()
            assert (rr[okv] == cnt[okv]).all()
            retry = is_scan & (rt == Reply.RETRY)
            if retry.any():
                # the stale overlay is the known cause: rebuild now and
                # re-send exactly the RETRY lanes, which must answer VAL
                self._rebuild()
                rt2 = self._wave(ops[retry], keys[retry], vals[retry],
                                 vers[retry])[0]
                assert (rt2 == Reply.VAL).all(), "scan retry still in doubt"
                ok += int(len(rt2))
        self.rec.record(n, ok, np.full(n, dt * 1e6))
        self._waves_since_rebuild += 1
        if self.use_scan and self._waves_since_rebuild >= self.rebuild_every:
            self._rebuild()
        return ok


def _replies_only(step_fn):
    """An engine's ``(state, replies)`` step in `_wave`'s ``(state, out)``
    form, ``out[0]`` the replies."""
    def step(state, batch):
        state, rep = step_fn(state, batch)
        return state, (rep,)
    return step


class LogClient(_SteppedClient):
    """Append replay (log_server/caladan/client.cc:147-167): each wave
    appends ``n`` entries of random keys, values and versions, and every
    one must be ACKed."""

    def __init__(self, ring: logring.LogRing | None = None, width: int = 4096,
                 val_words: int = 10, lanes: int = 16,
                 capacity: int = 1 << 20, device=None):
        ring = ring or logring.create(lanes, capacity, val_words, device)
        super().__init__(ring, _replies_only(logsrv.step), width, val_words,
                         ring.entries.device)

    def run_wave(self, rng: np.random.Generator, n: int | None = None):
        n = n or self.width
        keys = rng.integers(0, 10_000, size=n).astype(np.uint64)
        vals = rng.integers(0, 1 << 16, size=(n, self.vw)).astype(np.uint32)
        vers = rng.integers(1, 1 << 20, size=n).astype(np.uint32)
        ops = np.full(n, Op.LOG_APPEND, np.int32)
        rt, _, _, _, dt = self._wave(ops, keys, vals, vers)
        assert (rt == Reply.ACK).all()
        self.rec.record(n, n, np.full(n, dt * 1e6))
        return n


class _TraceCohort:
    """A rotating cohort of in-flight trace txns with retry-on-abort and
    per-txn start timestamps."""

    def __init__(self, trace, cohort: int, rng: np.random.Generator):
        self.trace = trace
        self.rng = rng
        self.next_txn = cohort
        idx = np.arange(cohort) % len(trace)
        self.cur = [trace[i] for i in idx]
        self.t_start = np.full(cohort, time.monotonic())

    def refill(self, done_mask: np.ndarray):
        """Replace completed txns with fresh ones; returns their latencies."""
        now = time.monotonic()
        lats = (now - self.t_start[done_mask]) * 1e6
        for i in np.nonzero(done_mask)[0]:
            self.cur[i] = self.trace[self.next_txn % len(self.trace)]
            self.next_txn += 1
            self.t_start[i] = now
        return lats


def _flatten(cohort_txns):
    """[(keys, is_read)] -> flat arrays + txn index per lane."""
    keys = np.concatenate([t[0] for t in cohort_txns])
    is_read = np.concatenate([t[1] for t in cohort_txns])
    txn_of = np.repeat(np.arange(len(cohort_txns)),
                       [len(t[0]) for t in cohort_txns])
    return keys.astype(np.uint64), is_read, txn_of


class Lock2PLClient(_SteppedClient):
    """No-wait 2PL trace replay (lock_2pl/caladan/client.cc:167-219)."""

    def __init__(self, trace, n_slots: int = 1 << 16, cohort: int = 512,
                 width: int = 8192, val_words: int = 1,
                 rng: np.random.Generator | None = None, device=None):
        dev = resolve_device(device)
        super().__init__(locks.create_sx(n_slots, dev),
                         _replies_only(lock2pl.step), width, val_words, dev)
        self.co = _TraceCohort(trace, cohort, rng or np.random.default_rng(1))

    def run_round(self):
        """One acquire wave + one release wave over the whole cohort."""
        keys, is_read, txn_of = _flatten(self.co.cur)
        w = len(self.co.cur)
        ops = np.where(is_read, Op.ACQ_S, Op.ACQ_X).astype(np.int32)
        rt = self._wave(ops, keys)[0]

        granted_lane = rt == Reply.GRANT
        rejected_txn = np.zeros(w, bool)
        np.logical_or.at(rejected_txn, txn_of, rt == Reply.REJECT)
        committed = ~rejected_txn

        # release everything granted (commit: txn end; abort: rollback,
        # client.cc:205-219), in one wave
        if granted_lane.any():
            rel_ops = np.where(is_read[granted_lane], Op.REL_S,
                               Op.REL_X).astype(np.int32)
            rrt = self._wave(rel_ops, keys[granted_lane])[0]
            assert (rrt == Reply.ACK).all()

        lats = self.co.refill(committed)  # aborted txns retry, keep t_start
        self.rec.record(int(w), int(committed.sum()), lats)
        return int(committed.sum())


class FasstClient(_SteppedClient):
    """FaSST OCC trace replay (lock_fasst/caladan/client.cc:184-280).

    ``attribute=True`` runs the lock-attribution server
    (`fasst.step_attr`, the reference's tatp/ebpf/lock_kern.c) and keeps
    the reference's attribution counters lock_cnt, reject_sharing_cnt and
    reject_same_key_cnt (tatp/caladan/client_lock.cc:62-64,768-771) in
    ``rec.extra``."""

    def __init__(self, trace, n_slots: int = 1 << 16, cohort: int = 512,
                 width: int = 8192, val_words: int = 1,
                 rng: np.random.Generator | None = None,
                 attribute: bool = False, device=None):
        dev = resolve_device(device)
        state = (locks.create_occ_attr(n_slots, dev) if attribute
                 else locks.create_occ(n_slots, dev))
        step_fn = fasst.step_attr if attribute else fasst.step
        super().__init__(state, _replies_only(step_fn), width, val_words,
                         dev)
        self.co = _TraceCohort(trace, cohort, rng or np.random.default_rng(2))
        self.attribute = attribute
        if attribute:
            self.rec.extra.update(lock_cnt=0, reject_sharing_cnt=0,
                                  reject_same_key_cnt=0)

    def run_round(self):
        keys, is_read, txn_of = _flatten(self.co.cur)
        w = len(self.co.cur)

        # wave 1: read-set versions + write-set locks (client.cc:246-277)
        ops = np.where(is_read, Op.READ_VER, Op.LOCK).astype(np.int32)
        rt, _, rver, _, _ = self._wave(ops, keys)
        lock_lane = ~is_read
        got_lock = rt == Reply.GRANT
        if self.attribute:
            self.rec.extra["lock_cnt"] += int(lock_lane.sum())
            self.rec.extra["reject_sharing_cnt"] += int(
                (lock_lane & (rt == Reply.REJECT)).sum())
            self.rec.extra["reject_same_key_cnt"] += int(
                (lock_lane & (rt == Reply.REJECT_SAME_KEY)).sum())
        lock_fail = np.zeros(w, bool)
        np.logical_or.at(lock_fail, txn_of, lock_lane & ~got_lock)

        # wave 2: validate = re-read the read-set; abort if the version
        # changed OR the slot is now locked by a concurrent writer
        # (:199-215; the lock bit rides reply val word 0)
        val_fail = np.zeros(w, bool)
        rd = is_read
        if rd.any():
            v_ops = np.full(int(rd.sum()), Op.READ_VER, np.int32)
            vrt, vval, vver, _, _ = self._wave(v_ops, keys[rd])
            assert (vrt == Reply.VAL).all()
            bad = (vver != rver[rd]) | (vval[:, 0] != 0)
            np.logical_or.at(val_fail, txn_of[rd], bad)
        aborted = lock_fail | val_fail
        committed = ~aborted

        # wave 3: COMMIT_VER for committed txns' write-sets; ABORT for the
        # granted locks of aborted txns (:216-236)
        fin_lane = lock_lane & got_lock
        if fin_lane.any():
            fl_ops = np.where(aborted[txn_of[fin_lane]], Op.ABORT,
                              Op.COMMIT_VER).astype(np.int32)
            frt = self._wave(fl_ops, keys[fin_lane])[0]
            assert (frt == Reply.ACK).all()

        lats = self.co.refill(committed)
        self.rec.record(int(w), int(committed.sum()), lats)
        return int(committed.sum())
