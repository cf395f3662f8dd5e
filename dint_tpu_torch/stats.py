"""The clients' stat contract, the port's copy of `dint_tpu.stats`
(numpy only, the same definitions and numbers).

A client records attempted and committed requests and per-request
latencies (µs) over a measure window; `Recorder.block` turns them into the
reference's metric block (throughput, goodput, average/median/99th/99.9th
latency; tatp/caladan/client_ebpf_shard.cc:368-377), with the log-bucketed
histogram beside the reservoir's percentiles. The bench's timed window is
`run_window` (`run_latency_window` for one-step blocks), warm-up to
measure to done is `StatClock` (store/caladan/stat.h:10-13), and
`CpuMonitor` is the reference's cpu_util block.

What differs from JAX: the runners take a `torch.Generator`, which each
call advances, where JAX's take a key and fold in the block index; and a
block's stats are fetched with ``.cpu()``, the value fetch that closes the
window as ``np.asarray`` does in JAX.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np


@dataclasses.dataclass
class Window:
    """Warmup/measure/exit schedule (store/caladan/stat.h:10-13)."""
    warmup_s: float = 5.0
    measure_s: float = 10.0

    @property
    def total_s(self):
        return self.warmup_s + self.measure_s


class StatClock:
    """Drives a client loop through warmup -> measure -> done phases:
    `tick` each iteration, record only while `measuring`."""

    def __init__(self, window: Window | None = None):
        self.window = window or Window()
        self.t0 = time.monotonic()
        self._measure_t0 = None
        self._measure_t1 = None
        self._done = False

    def tick(self) -> str:
        now = time.monotonic()
        t = now - self.t0
        # close the interval over the wave since the previous tick before
        # classifying this one, so the last measured wave's time counts
        if self._measure_t0 is not None and not self._done:
            self._measure_t1 = now
        if t < self.window.warmup_s:
            return "warmup"
        if t < self.window.total_s:
            if self._measure_t0 is None:
                self._measure_t0 = self._measure_t1 = now
            return "measure"
        self._done = True
        return "done"

    @property
    def measuring(self) -> bool:
        return (not self._done and self._measure_t0 is not None
                and self._measure_t1 is not None)

    @property
    def measured_s(self) -> float:
        if self._measure_t0 is None or self._measure_t1 is None:
            return 0.0
        return self._measure_t1 - self._measure_t0


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

    def merge(self, other: "LatencyHistogram"):
        """Bucket counts add (exact, associative, commutative); returns
        self, so ``total.merge(a).merge(b)``."""
        self.counts += other.counts
        self.n += other.n
        self.sum_us += other.sum_us
        self.dropped_nonfinite += other.dropped_nonfinite
        return self

    def _edge(self, i: int) -> float:
        return 2.0 ** (self.LO_EXP + i / self.PER_OCTAVE)

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

    @classmethod
    def from_dict(cls, d: dict) -> "LatencyHistogram":
        if d.get("lo_exp", cls.LO_EXP) != cls.LO_EXP or \
                d.get("per_octave", cls.PER_OCTAVE) != cls.PER_OCTAVE:
            raise ValueError("histogram bucket geometry mismatch")
        h = cls()
        for i, c in (d.get("buckets") or {}).items():
            h.counts[int(i)] = int(c)
        h.n = int(d.get("n", int(h.counts.sum())))
        h.sum_us = float(d.get("sum_us", 0.0))
        h.dropped_nonfinite = int(d.get("dropped_nonfinite", 0))
        return h


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


class CpuMonitor:
    """Host core-seconds over a window, the reference's cpu_util service
    (smallbank/cpu_util.h:37-46): machine-wide user and kernel time from
    /proc/stat, and this process's (the host loop that feeds the card)."""

    def __init__(self):
        self._t0 = time.monotonic()
        self._m0 = self._machine()
        self._p0 = self._process()

    @staticmethod
    def _machine():
        with open("/proc/stat") as f:
            parts = f.readline().split()
        # user, nice, system, idle, iowait, irq, softirq
        user = int(parts[1]) + int(parts[2])
        kernel = int(parts[3]) + int(parts[6]) + int(parts[7])
        return user, kernel

    @staticmethod
    def _process():
        with open("/proc/self/stat") as f:
            parts = f.read().rsplit(") ", 1)[1].split()
        return int(parts[11]), int(parts[12])   # utime, stime

    def cores(self) -> dict:
        """Core-equivalents busy since construction (jiffies / HZ / wall)."""
        hz = float(os.sysconf("SC_CLK_TCK"))
        dt = max(time.monotonic() - self._t0, 1e-9)
        m1 = self._machine()
        p1 = self._process()
        return {
            "host_ucores": round((m1[0] - self._m0[0]) / hz / dt, 3),
            "host_kcores": round((m1[1] - self._m0[1]) / hz / dt, 3),
            "proc_ucores": round((p1[0] - self._p0[0]) / hz / dt, 3),
            "proc_kcores": round((p1[1] - self._p0[1]) / hz / dt, 3),
        }


def steady_blocks(block_s):
    """`run_window`'s block times trimmed to steady state: the first block
    is enqueue only and the last holds the final fetch."""
    return block_s[1:-1] if len(block_s) > 2 else block_s


def cohort_latency_percentiles(block_s, cohorts_per_block: int, depth: int):
    """Latency percentiles at cohort granularity from per-block wall times.

    A txn completes ``depth`` pipeline steps after its cohort's dispatch.
    Cohort j of a block spends its first (cpb - j) steps in its own block
    (a step = that block's wall / cpb) and the rest in the next block's
    steps, so the samples carry cross-block jitter. Returns the percentile
    dict with ``n`` (samples) and ``hist`` (the "lat_hist" block)."""
    bs = np.asarray(steady_blocks(block_s), np.float64)
    lat = LatencyReservoir()
    if len(bs):
        step = bs / cohorts_per_block
        j = np.arange(cohorts_per_block)
        spill = np.minimum(np.maximum(j + depth - cohorts_per_block, 0),
                           depth)
        for b in range(len(bs)):
            s_next = step[b + 1] if b + 1 < len(bs) else step[b]
            lat.add(((depth - spill) * step[b] + spill * s_next) * 1e6)
    out = lat.percentiles()
    out["n"] = lat.n_seen
    out["hist"] = lat.hist.to_dict()
    return out


def fetch_stats(stats) -> np.ndarray:
    """A block's stats [cpb, n_stats] on the host as int64: the value
    fetch (``.cpu()``) waits for the block's kernels."""
    return stats.cpu().numpy().astype(np.int64)


def run_latency_window(runner, state, gen, window_s: float, n_stats: int,
                       depth: int, warmup_blocks: int = 2):
    """Latency-mode window for runners of one step a block: each call's
    stats are fetched at once, so the cohort dispatched at call j
    completes in call j+depth-1 and its latency is t_end[j+depth-1] -
    t_start[j], measured on the host clock around real device work.

    Returns (state, total, dt, steps, percentiles with ``n`` and
    ``hist``). ``total`` also holds the warm-up cohorts' outcomes, which
    surface in the timed fetches."""
    for _ in range(warmup_blocks):
        state, stats = runner(state, gen)
        fetch_stats(stats)

    total = np.zeros(n_stats, np.int64)
    t_start, t_end = [], []
    t0 = time.time()
    i = 0
    while time.time() - t0 < window_s:
        t_start.append(time.time())
        state, stats = runner(state, gen)
        total += fetch_stats(stats).sum(axis=0)
        t_end.append(time.time())
        i += 1
    dt = time.time() - t0
    lat = LatencyReservoir()
    if i > depth:
        samples = (np.asarray(t_end[depth - 1:]) -
                   np.asarray(t_start[: i - depth + 1])) * 1e6
        lat.add(samples)
    out = lat.percentiles()
    out["n"] = lat.n_seen
    out["hist"] = lat.hist.to_dict()
    return state, total, dt, i, out


def run_window(runner, state, gen, window_s: float, n_stats: int,
               warmup_blocks: int = 1, ranks=None):
    """The bench's timed loop: ``warmup_blocks`` calls, then calls until
    ``window_s`` has passed, the fetch of block i-1's stats overlapping
    block i's device work. The window closes with the fetch of the last
    block's stats.

    ``ranks`` (`parallel.dist.Window`): the runner spans processes; the
    window starts with ``ranks.start()``, a block boundary asks
    ``ranks.passed(flag)`` whether any rank's window has passed (while
    the block in flight runs), and it ends with ``ranks.end()`` after the
    last fetch.

    Returns (state, total [n_stats] i64 of the timed blocks, warm_total
    of the warm-up blocks, elapsed_s, blocks, block_s): ``block_s`` is the
    wall time of each timed iteration, ~ one block of device time in
    steady state."""
    warm_total = np.zeros(n_stats, np.int64)
    for _ in range(warmup_blocks):
        state, stats = runner(state, gen)
        warm_total += fetch_stats(stats).sum(axis=0)

    total = np.zeros(n_stats, np.int64)
    block_s = []
    if ranks is not None:
        ranks.start()
    t0 = time.time()

    def passed() -> bool:
        flag = time.time() - t0 >= window_s
        return flag if ranks is None else ranks.passed(flag)

    blocks = 0
    pending = None
    tprev = t0
    while not passed():
        state, stats = runner(state, gen)
        if pending is not None:
            total += fetch_stats(pending).sum(axis=0)
        pending = stats
        blocks += 1
        now = time.time()
        block_s.append(now - tprev)
        tprev = now
    if pending is not None:
        total += fetch_stats(pending).sum(axis=0)
        # the last fetch closes the last block's device time
        block_s[-1] = time.time() - tprev + block_s[-1]
    if ranks is not None:
        ranks.end()
    dt = time.time() - t0
    return state, total, warm_total, dt, blocks, block_s


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
