"""The closed loop and what it measures: the timed window, each cohort's
latency, and the host's spans.

The loop is the port's `stats.run_window` loop (the fetch of block i-1's
stats overlapping block i on the device; the window closes with the
fetch of the last stats), taken into the benchmark so that the yardstick
does not move with the program. Every block's draws come from the seed;
the next block is handed in when the runner returns. After the last
block the runner drains, so every cohort handed in during the window is
answered inside it: the window runs from the first hand-in to the fetch
of the drain's stats.

A cohort is the ``w`` transactions (a server) that one step draws. Its
counts come back in the stats row ``lag`` steps later; its latency runs
from the host's call of ``run_draws`` with its draws to the moment the
host holds that stats row.
"""
from __future__ import annotations

import time

import numpy as np


def now_ns() -> int:
    return time.time_ns()


class Spans:
    """The benchmark's own host spans (name, start, end) in ns of the
    wall clock, which the profiler's events share."""

    def __init__(self, on: bool):
        self.on = on
        self.items = []

    def add(self, name: str, t0: int, t1: int):
        if self.on:
            self.items.append((name, t0, t1))


class Record:
    """What a run of blocks left: the stats rows of every step, each
    block's hand-in time and the fetch time of every step's row."""

    def __init__(self, cpb: int, lag: int):
        self.cpb, self.lag = cpb, lag
        self.stats = []          # [cpb, n_stats] i64 a block (the drain's)
        self.hand_in = []        # ns a block
        self.fetched = []        # ns a block (the drain's too)
        self.blocks = 0          # blocks handed in (warm-up and window)

    def add_block(self, t_hand: int):
        self.hand_in.append(t_hand)
        self.blocks += 1

    def add_stats(self, rows: np.ndarray, t_fetch: int):
        self.stats.append(rows)
        self.fetched.append(t_fetch)

    def rows(self) -> np.ndarray:
        return np.concatenate(self.stats)


def fetch(stats) -> np.ndarray:
    """A stats tensor on the host as i64 (the copy waits for the block)."""
    return stats.cpu().numpy().astype(np.int64)


def run_blocks(sys, rec: Record, first: int, count=None, seconds=None,
               spans: Spans | None = None, agree=None):
    """Hand in blocks ``first, first + 1, ...``: ``count`` of them, or
    until ``seconds`` have passed since the first hand-in (``agree``:
    across ranks, true on every rank once any rank's clock passed; it is
    asked while the block in flight runs). Returns (t_start, t_end,
    blocks run) with t_end the fetch of the last block's stats."""
    spans = spans or Spans(False)
    t0 = now_ns()
    pending = None
    b = first
    while True:
        if count is not None and b - first >= count:
            break
        if seconds is not None:
            passed = (now_ns() - t0) / 1e9 >= seconds
            if agree is not None:
                passed = agree(passed)
            if passed:
                break
        tg = now_ns()
        draws = sys.draws(b)
        th = now_ns()
        spans.add("draws", tg, th)
        stats = sys.hand_in(draws)
        tr = now_ns()
        spans.add("run_draws", th, tr)
        rec.add_block(th)
        if pending is not None:
            rows = fetch(pending)
            tf = now_ns()
            spans.add("fetch_stats", tr, tf)
            rec.add_stats(rows, tf)
        pending = stats
        b += 1
    if pending is not None:
        tr = now_ns()
        rows = fetch(pending)
        tf = now_ns()
        spans.add("fetch_stats", tr, tf)
        rec.add_stats(rows, tf)
    return t0, now_ns(), b - first


def drain(sys, rec: Record, spans: Spans | None = None) -> int:
    spans = spans or Spans(False)
    t0 = now_ns()
    stats = sys.drain()
    t1 = now_ns()
    spans.add("drain", t0, t1)
    rows = fetch(stats)
    t2 = now_ns()
    spans.add("fetch_stats", t1, t2)
    rec.add_stats(rows, t2)
    return t2


def cohorts(rec: Record, first_block: int, last_block: int, cols):
    """The cohorts drawn in blocks [first_block, last_block): for each,
    its attempted, committed and conflict-aborted counts, its latency in
    ns, and whether its counts came back. ``cols`` = (attempted,
    committed, (conflict abort columns))."""
    cpb, lag = rec.cpb, rec.lag
    rows = rec.rows()
    # the fetch time of every step's row
    t_row = np.concatenate([np.full(len(s), t, np.int64)
                            for s, t in zip(rec.stats, rec.fetched)])
    g = np.arange(first_block * cpb, last_block * cpb)
    s = g + lag
    answered = s < len(rows)
    s = np.minimum(s, len(rows) - 1)
    att, com, ab = cols
    hand = np.asarray(rec.hand_in, np.int64)[g // cpb]
    return {"attempted": rows[s, att] * answered,
            "committed": rows[s, com] * answered,
            "conflict": rows[s][:, list(ab)].sum(1) * answered,
            "latency_ns": t_row[s] - hand,
            "answered": answered}


def p99(latency_ns: np.ndarray, weight: np.ndarray) -> float:
    """The 99th percentile (nearest rank) over every transaction, each
    cohort's latency standing for its ``weight`` transactions."""
    order = np.argsort(latency_ns, kind="stable")
    cum = np.cumsum(weight[order])
    rank = int(np.ceil(0.99 * cum[-1]))
    return float(latency_ns[order][np.searchsorted(cum, rank)])
