"""One cell's run: the system under test through its warm-up, the timed
(or traced) window and its drain, then the plain reference over the same
inputs, and the comparison.

`drive` runs the system in this process (one server, or one rank of a
sharded deployment) and returns what the result needs from it: the
stats record, the window's times, the outputs' digests, the locks still
held, the peak memory and, traced, the card's view. `judge` replays the
reference for as many blocks as the system ran and compares.
"""
from __future__ import annotations

import gc

import numpy as np
import torch

from . import compare, devtrace, window
from .reference import LAG, STATS_COLS, ReferenceSystem
from .registry import ROOT


def sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def drive(sys, cfg: dict, mix: dict, seconds: float, trace: bool,
          agree=None) -> dict:
    """Warm-up blocks, then the window (``seconds`` of blocks; traced:
    ``mix["trace_blocks"]`` blocks under the profiler), then the drain."""
    dev = sys.dev
    rec = window.Record(mix["cohorts_per_block"], LAG[cfg["system"]])
    warm = mix["warmup_blocks"]
    window.run_blocks(sys, rec, 0, count=warm)
    sync(dev)
    spans = window.Spans(trace)
    view = None
    if trace:
        prof = devtrace.start()
        t0, t1, n = window.run_blocks(sys, rec, warm,
                                      count=mix["trace_blocks"], spans=spans)
        events = devtrace.stop(prof)
        view = devtrace.CardView(events, spans.items, t0, t1,
                                 n * mix["cohorts_per_block"],
                                 devtrace.program_kernels(ROOT)).summary()
        t_end = window.drain(sys, rec)
    else:
        t0, _, n = window.run_blocks(sys, rec, warm, seconds=seconds,
                                     agree=agree)
        t_end = window.drain(sys, rec)
    sync(dev)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    out = {"rec": rec, "t0": t0, "t_end": t_end, "warm": warm,
           "blocks": rec.blocks, "window_blocks": n, "peak": int(peak),
           "digests": compare.digests(sys.outputs()),
           "locks": sys.locks_held(), "view": view,
           "route": getattr(sys, "route", {})}
    return out


def free(sys):
    """Drop the system's state so the reference starts on a clean card."""
    for k in list(vars(sys)):
        setattr(sys, k, None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def judge(cfg: dict, mix: dict, seed: int, device, run: dict,
          digests: dict, locks: int) -> dict:
    """Replay the reference over the blocks the system ran and its drain,
    and compare. Returns the checks' counts and the reference's seconds."""
    import time
    t = time.time()
    ref = ReferenceSystem(cfg, mix, seed, device)
    rows = []
    for b in range(run["blocks"]):
        rows.append(ref.hand_in(ref.draws(b)))
    rows.append(ref.drain())
    ref_stats = torch.cat(rows).cpu().numpy().astype(np.int64)
    ref_dig = compare.digests(ref.outputs())
    del ref
    gc.collect()
    sys_stats = run["rec"].rows()
    w = run["rec"]
    first, last = run["warm"], run["warm"] + run["window_blocks"]
    coh = window.cohorts(w, first, last, STATS_COLS[cfg["system"]])
    unanswered = int((~coh["answered"]).sum())
    cap = cfg["log_capacity"]
    counts = compare.checks(digests, ref_dig, sys_stats, ref_stats, locks,
                            unanswered, cap)
    return {"counts": counts, "ref_s": time.time() - t,
            "log_fill": compare.log_fill(digests, cap)}


def e2e(cfg: dict, mix: dict, run: dict, setup_s: float) -> tuple:
    """The end-to-end numbers and (attempted, failed) of the window."""
    cpb = mix["cohorts_per_block"]
    first, last = run["warm"], run["warm"] + run["window_blocks"]
    coh = window.cohorts(run["rec"], first, last, STATS_COLS[cfg["system"]])
    per = mix["width"] * cfg.get("servers", 1)
    n_coh = (last - first) * cpb
    attempted = n_coh * per
    # A lock or validation abort is the protocol's answer, judged step by
    # step against the reference (``stats``); only a transaction whose
    # answer never came has failed.
    failed = int((~coh["answered"]).sum()) * per
    window_s = (run["t_end"] - run["t0"]) / 1e9
    committed = int(coh["committed"].sum())
    lat = coh["latency_ns"].astype(np.float64)
    weight = np.full(len(lat), per, np.int64)
    vals = {"committed_txn_per_s": committed / window_s,
            "txn_latency_p99_ms": window.p99(lat, weight) / 1e6,
            "setup_s": setup_s}
    hand = np.asarray(run["rec"].hand_in[first:last], np.float64)
    block_ms = np.diff(hand) / 1e6
    q = (np.percentile(block_ms, [0, 25, 50, 75, 100]).round(2).tolist()
         if len(block_ms) else [])
    return vals, attempted, failed, {"window_s": window_s,
                                     "committed": committed,
                                     "conflict_aborts":
                                         int(coh["conflict"].sum()),
                                     "cohorts": n_coh, "block_ms": q}
