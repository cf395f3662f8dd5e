"""Open-loop arrival schedules for the serving plane's front end (the
port's copy of `dint_tpu.serve.arrivals`, numpy only).

The reference's clients are Caladan open-loop load generators: arrival
times are drawn from a rate process BEFORE the run, and a transaction is
injected at its scheduled instant whether or not earlier ones finished
(Caladan OSDI'20; DINT NSDI'24 measures every latency-vs-load curve this
way). A closed-loop load never sees queueing delay: the client waits,
so the queue never builds. These schedules are that pre-drawn arrival
process: float64 timestamp arrays (seconds from the stream's start) made
from a seeded ``np.random.Generator``, so every run replays the same
stream.

An arrival is one admission slot. The dense engines draw transaction
content on the device from the cohort's draws, so the stream carries
timing only: the serving plane turns arrivals into per-cohort occupancy,
and the occupancy mask decides which drawn lanes are real. At full
occupancy the same draws replay the closed-loop run.
"""
from __future__ import annotations

import numpy as np


def constant_schedule(rate: float, window_s: float,
                      start_s: float = 0.0) -> np.ndarray:
    """Evenly spaced arrivals at ``rate``/s over ``window_s`` seconds."""
    n = int(np.floor(rate * window_s))
    if n <= 0:
        return np.zeros(0, np.float64)
    return start_s + (np.arange(n, dtype=np.float64) + 1.0) / rate


def poisson_schedule(rate: float, window_s: float, seed: int = 0,
                     start_s: float = 0.0) -> np.ndarray:
    """Poisson arrivals: i.i.d. exponential gaps at mean 1/rate, truncated
    to the window (the Caladan generators' default process)."""
    if rate <= 0 or window_s <= 0:
        return np.zeros(0, np.float64)
    rng = np.random.default_rng(seed)
    out = []
    t = 0.0
    # draw in chunks sized ~20% over expectation until the window is full
    chunk = max(int(rate * window_s * 1.2) + 16, 64)
    while t < window_s:
        gaps = rng.exponential(1.0 / rate, size=chunk)
        ts = t + np.cumsum(gaps)
        out.append(ts[ts < window_s])
        t = float(ts[-1])
    arr = np.concatenate(out) if out else np.zeros(0, np.float64)
    return start_s + arr


def burst_schedule(rate: float, window_s: float, *, burst_lanes: int,
                   burst_every_s: float, seed: int = 0,
                   start_s: float = 0.0) -> np.ndarray:
    """A trickle baseline plus periodic same-instant bursts of
    ``burst_lanes`` arrivals every ``burst_every_s`` — the adversarial
    shape for cohort batching: a burst lands in one poll, overfills the
    current block, and its tail straddles into the next (the case the
    straddle test pins). ``rate`` is the TOTAL average rate; the
    baseline takes what the bursts leave."""
    if window_s <= 0:
        return np.zeros(0, np.float64)
    n_bursts = int(np.floor(window_s / burst_every_s))
    burst_ts = (np.arange(n_bursts, dtype=np.float64) + 0.5) * burst_every_s
    bursts = np.repeat(burst_ts, burst_lanes)
    base_rate = max(rate - n_bursts * burst_lanes / window_s, 0.0)
    base = poisson_schedule(base_rate, window_s, seed=seed)
    return start_s + np.sort(np.concatenate([bursts, base]))


def make_schedule(kind: str, rate: float, window_s: float, seed: int = 0,
                  **kw) -> np.ndarray:
    """Schedule factory keyed by name ('constant' | 'poisson' | 'burst')
    — the CLI/exp.py entry point."""
    if kind == "constant":
        return constant_schedule(rate, window_s, **kw)
    if kind == "poisson":
        return poisson_schedule(rate, window_s, seed=seed, **kw)
    if kind == "burst":
        return burst_schedule(rate, window_s, seed=seed, **kw)
    raise ValueError(f"unknown schedule kind {kind!r} "
                     "(want constant | poisson | burst)")


class ArrivalStream:
    """Cursor over a pre-drawn schedule: ``take_until(t)`` pops every
    arrival timestamped <= t (FIFO), ``peek()`` returns the next pending
    timestamp or None. O(1) per pop — the timestamps array is never
    copied."""

    def __init__(self, times: np.ndarray):
        self.times = np.asarray(times, np.float64)
        assert (np.diff(self.times) >= 0).all(), "schedule must be sorted"
        self._i = 0

    def __len__(self):
        return len(self.times) - self._i

    def peek(self) -> float | None:
        if self._i >= len(self.times):
            return None
        return float(self.times[self._i])

    def take_until(self, t: float) -> np.ndarray:
        """All arrivals with timestamp <= t, removed from the stream."""
        j = int(np.searchsorted(self.times, t, side="right"))
        out = self.times[self._i:j]
        self._i = j
        return out

    @property
    def exhausted(self) -> bool:
        return self._i >= len(self.times)
