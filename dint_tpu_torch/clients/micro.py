"""The store benchmark's client (the part of `dint_tpu.clients.micro` the
store needs): the populated table and `StoreClient`, the host-side,
wave-batched GET/SET client of the reference's store microbenchmark
(store/caladan/client_caladan.cc:56-66, with the magic-word check every
read asserts, :160).

What differs from JAX: the routes are explicit arguments, off by default
(``use_hotset``, ``use_scan``); nothing is read from the environment, and
there is no ``use_pallas``, since the port always takes the kernel route.
The step is a plain call on state (table, hot mirror or None, ordered run
or None), updated in place.
"""
from __future__ import annotations

import time

import numpy as np

from ..engines import store
from ..engines.types import Op, Reply, make_batch
from ..ops.u32 import to_numpy
from ..stats import Recorder
from ..tables import kv
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

    def _wave(self, ops, keys, vals=None, vers=None):
        """Run one batch; returns (rtype, rval, rver, step output, wall s)."""
        m = len(ops)
        assert m <= self.width, f"wave of {m} exceeds width {self.width}"
        batch = make_batch(ops, keys, vals, vers=vers, width=self.width,
                           val_words=self.vw, device=self.device)
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
