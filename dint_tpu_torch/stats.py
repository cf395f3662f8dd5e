"""The clients' stat contract: what `Recorder` needs of
`dint_tpu.stats` (numpy only, the same definitions and numbers).

A client records attempted and committed requests and per-request
latencies (µs) over a measure window; `Recorder.block` turns them into the
reference's metric block (throughput, goodput, average/median/99th/99.9th
latency; tatp/caladan/client_ebpf_shard.cc:368-377), with the log-bucketed
histogram beside the reservoir's percentiles.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np


class LatencyHistogram:
    """Fixed log-bucketed latency histogram (µs): 8 buckets an octave over
    2^-4 .. 2^28 µs, out-of-range samples clamped to the edge buckets,
    non-finite samples dropped and counted. A percentile is the geometric
    midpoint of the bucket holding the ceil(q*n)-th sample."""

    LO_EXP = -4
    HI_EXP = 28
    PER_OCTAVE = 8
    N_BUCKETS = (HI_EXP - LO_EXP) * PER_OCTAVE
    SCHEMA = 1

    def __init__(self):
        self.counts = np.zeros(self.N_BUCKETS, np.int64)
        self.n = 0
        self.sum_us = 0.0
        self.dropped_nonfinite = 0

    def add(self, lat_us: np.ndarray | float):
        arr = np.atleast_1d(np.asarray(lat_us, np.float64))
        finite = np.isfinite(arr)
        self.dropped_nonfinite += int(len(arr) - finite.sum())
        arr = arr[finite]
        if not len(arr):
            return
        # log2 of a non-positive sample is -inf -> clamps to bucket 0
        with np.errstate(divide="ignore"):
            idx = np.floor(np.log2(np.maximum(arr, 0.0))
                           * self.PER_OCTAVE) - self.LO_EXP * self.PER_OCTAVE
        idx = np.clip(np.nan_to_num(idx, neginf=0.0), 0,
                      self.N_BUCKETS - 1).astype(np.int64)
        np.add.at(self.counts, idx, 1)
        self.n += len(arr)
        self.sum_us += float(arr.sum())

    def _rep(self, i: int) -> float:
        return 2.0 ** (self.LO_EXP + (i + 0.5) / self.PER_OCTAVE)

    def quantile(self, q: float) -> float:
        if self.n == 0:
            return 0.0
        rank = min(max(int(np.ceil(q * self.n)), 1), self.n)
        i = int(np.searchsorted(np.cumsum(self.counts), rank))
        return self._rep(i)

    def percentiles(self) -> dict:
        if self.n == 0:
            return dict(avg=0.0, p50=0.0, p99=0.0, p999=0.0)
        return dict(avg=self.sum_us / self.n, p50=self.quantile(0.50),
                    p99=self.quantile(0.99), p999=self.quantile(0.999))

    def to_dict(self) -> dict:
        """The artifact's "lat_hist" block: non-zero buckets by index."""
        return {
            "schema": self.SCHEMA,
            "lo_exp": self.LO_EXP, "per_octave": self.PER_OCTAVE,
            "n": int(self.n), "sum_us": round(self.sum_us, 3),
            "dropped_nonfinite": int(self.dropped_nonfinite),
            "buckets": {str(i): int(c) for i, c in enumerate(self.counts)
                        if c},
            **{f"{k}_us": round(v, 2)
               for k, v in self.percentiles().items()},
        }


class LatencyReservoir:
    """Latency samples (µs): every sample up to ``cap``, reservoir
    downsampling past it (store/caladan/stat.h:15-20 keeps them all), each
    sample also counted into ``hist``."""

    def __init__(self, cap: int = 1 << 20, seed: int = 0):
        self.cap = cap
        self.samples = np.empty(cap, np.float64)
        self.n_kept = 0
        self.n_seen = 0
        self.hist = LatencyHistogram()
        self._rng = np.random.default_rng(seed)

    def add(self, lat_us: np.ndarray | float):
        arr = np.atleast_1d(np.asarray(lat_us, np.float64))
        self.hist.add(arr)
        for start in range(0, len(arr), self.cap):
            self._add_chunk(arr[start:start + self.cap])

    def _add_chunk(self, arr):
        n = len(arr)
        room = self.cap - self.n_kept
        take = min(room, n)
        if take:
            self.samples[self.n_kept:self.n_kept + take] = arr[:take]
            self.n_kept += take
        rest = arr[take:]
        if len(rest):
            # each later sample replaces a random kept one with
            # probability cap / seen-so-far
            seen = self.n_seen + take + np.arange(1, len(rest) + 1)
            keep = self._rng.random(len(rest)) < (self.cap / seen)
            idx = self._rng.integers(0, self.cap, size=len(rest))
            self.samples[idx[keep]] = rest[keep]
        self.n_seen += n

    def percentiles(self):
        """All zeros when empty; non-finite samples excluded."""
        s = self.samples[: self.n_kept]
        if len(s):
            s = s[np.isfinite(s)]
        if len(s) == 0:
            return dict(avg=0.0, p50=0.0, p99=0.0, p999=0.0)
        p50, p99, p999 = np.percentile(s, [50, 99, 99.9])
        return dict(avg=float(s.mean()), p50=float(p50), p99=float(p99),
                    p999=float(p999))


@dataclasses.dataclass
class TxnStats:
    """Attempted/committed accounting."""
    attempted: int = 0
    committed: int = 0

    @property
    def abort_rate(self):
        if self.attempted == 0:
            return 0.0
        return 1.0 - self.committed / self.attempted


@dataclasses.dataclass
class MetricBlock:
    """The fixed stat block (client_ebpf_shard.cc:368-377), plus the
    fraction of wall time the device was stepping."""
    throughput: float        # attempted requests/s
    goodput: float           # committed requests/s
    avg_us: float
    p50_us: float
    p99_us: float
    p999_us: float
    device_duty: float = 0.0
    extra: dict = dataclasses.field(default_factory=dict)

    @property
    def abort_rate(self):
        if self.throughput <= 0:
            return 0.0
        return 1.0 - self.goodput / self.throughput

    def to_dict(self):
        d = dict(throughput=round(self.throughput, 1),
                 goodput=round(self.goodput, 1),
                 abort_rate=round(self.abort_rate, 6),
                 avg_us=round(self.avg_us, 2), p50_us=round(self.p50_us, 2),
                 p99_us=round(self.p99_us, 2), p999_us=round(self.p999_us, 2),
                 device_duty=round(self.device_duty, 4))
        d.update(self.extra)
        return d

    def format(self) -> str:
        lines = [
            f"throughput: {self.throughput:.1f}",
            f"goodput: {self.goodput:.1f}",
            f"average: {self.avg_us:.2f} us",
            f"median: {self.p50_us:.2f} us",
            f"99th: {self.p99_us:.2f} us",
            f"99.9th: {self.p999_us:.2f} us",
            f"device duty: {self.device_duty:.4f}",
        ]
        for k, v in self.extra.items():
            lines.append(f"{k}: {v}")
        return "\n".join(lines)

    def json(self) -> str:
        return json.dumps(self.to_dict())


class Recorder:
    """Counters and latencies a client drives during the measure window;
    `reset` after the warm-up, `block` at the end."""

    def __init__(self, lat_cap: int = 1 << 20):
        self._lat_cap = lat_cap
        self.extra: dict = {}
        self.reset()

    def reset(self):
        self.attempted = 0
        self.committed = 0
        self.lat = LatencyReservoir(self._lat_cap)
        self.device_busy_s = 0.0

    def record(self, attempted: int, committed: int,
               lat_us: np.ndarray | None = None,
               device_s: float = 0.0):
        self.attempted += attempted
        self.committed += committed
        if lat_us is not None and len(np.atleast_1d(lat_us)):
            self.lat.add(lat_us)
        self.device_busy_s += device_s

    def block(self, elapsed_s: float) -> MetricBlock:
        p = self.lat.percentiles()
        el = max(elapsed_s, 1e-12)
        extra = dict(self.extra)
        extra.setdefault("lat_hist", self.lat.hist.to_dict())
        return MetricBlock(
            throughput=self.attempted / el,
            goodput=self.committed / el,
            avg_us=p["avg"], p50_us=p["p50"], p99_us=p["p99"],
            p999_us=p["p999"],
            device_duty=self.device_busy_s / el,
            extra=extra,
        )
