"""SmallBank bench window: committed txn/s on the dense pipeline, the port
of `dint_tpu.clients.bench_smallbank` (the bench's second leg).

Reference-scale parameters: 24M accounts x {SAVINGS, CHECKING}, 90% of
txns on the 4% hot set, mix 15/15/15/25/15/15, 3 replicated shards with
the log x3 / bck x2 / prim commit pipeline
(smallbank/caladan/client_ebpf_shard.cc:389-560).

Balance conservation is checked over the whole run, warm-up included:
the table-sum delta (mod 2^32) must equal the pipeline's own accounting
of committed deltas, and the magic word must never read bad. Either
fault raises: a corrupted run reports no number.
"""
from __future__ import annotations

import torch

from .. import stats
from ..device import resolve_device
from ..engines import smallbank_dense as sd
from . import workloads as wl

N_ACCOUNTS = 24_000_000
WIDTH = 8192
BLOCK = 16
# both sides of the width/abort trade, quoted side by side; the headline
# is the point with the lowest abort rate, because the baseline criterion
# is throughput at a matched abort rate, not peak throughput
WIDTHS = (8192, 16384)


def run(window_s: float = 10.0, n_accounts: int = N_ACCOUNTS,
        widths=WIDTHS, block: int = BLOCK, hot_frac: float | None = None,
        hot_prob: float | None = None, route: str = "default",
        device=None) -> dict:
    """Bench every width in ``widths`` on ``route`` (a key of
    `engines.types.ROUTES`) and return the bench line's ``smallbank_*``
    fields: the headline is the point with the lowest abort rate, and
    ``smallbank_points`` quotes every (width, txn/s, abort rate).
    ``hot_frac``/``hot_prob`` override the workload's 90%/4% skew."""
    dev = resolve_device(device)
    points = [_run_one(window_s, n_accounts, w, block, hot_frac, hot_prob,
                       route, dev)
              for w in widths]
    head = min(points, key=lambda p: p["abort_rate"])
    return {
        "smallbank_committed_txns_per_sec": head["committed_tps"],
        "smallbank_abort_rate": head["abort_rate"],
        "smallbank_width": head["width"],
        "smallbank_points": points,
        "smallbank_route": route,
        "smallbank_use_hotset": head["use_hotset"],
        "smallbank_hot_frac": head["hot_frac"],
        "smallbank_hot_prob": head["hot_prob"],
        "smallbank_balance_conserved": True,
    }


def _run_one(window_s: float, n_accounts: int, width: int, block: int,
             hot_frac: float | None, hot_prob: float | None, route: str,
             dev) -> dict:
    use_hotset, use_fused = sd.ROUTES[route]
    db = sd.create(n_accounts, device=dev)
    base = int(sd.total_balance(db))
    runner, init, drain = sd.build_pipelined_runner(
        n_accounts, w=width, cohorts_per_block=block, hot_frac=hot_frac,
        hot_prob=hot_prob, use_hotset=use_hotset, use_fused=use_fused,
        device=dev)
    carry = init(db)
    gen = torch.Generator(device=dev).manual_seed(1)

    # a block before the window, as JAX's leg runs one to compile: the
    # first call builds the kernels (nvcc) if they are not built yet
    carry, s0 = runner(carry, gen)
    warm0 = stats.fetch_stats(s0).sum(axis=0)

    carry, total, warm, dt, _, _ = stats.run_window(
        runner, carry, gen, window_s, sd.N_STATS, warmup_blocks=1)
    warm = warm + warm0
    db, tail = drain(carry)
    tail = stats.fetch_stats(tail).sum(axis=0)

    committed = int(total[sd.STAT_COMMITTED] + tail[sd.STAT_COMMITTED])
    attempted = int(total[sd.STAT_ATTEMPTED] + tail[sd.STAT_ATTEMPTED])
    if int(total[sd.STAT_MAGIC_BAD] + warm[sd.STAT_MAGIC_BAD]
           + tail[sd.STAT_MAGIC_BAD]) != 0:
        raise RuntimeError("smallbank magic-byte integrity violated")
    # conservation covers the whole run: warm-up writes land too
    accounted = int(total[sd.STAT_BAL_DELTA] + warm[sd.STAT_BAL_DELTA]
                    + tail[sd.STAT_BAL_DELTA])
    final = int(sd.total_balance(db))
    if (final - base) % (1 << 32) != accounted % (1 << 32):
        raise RuntimeError(
            f"balance conservation violated: table delta {final - base} != "
            f"accounted {accounted} (mod 2^32)")

    return {
        "width": width,
        "committed_tps": round(committed / dt, 1),
        "abort_rate": round(1 - committed / max(attempted, 1), 5),
        "route": route,
        "use_hotset": use_hotset,
        "hot_frac": wl.SB_HOT_FRAC if hot_frac is None else float(hot_frac),
        "hot_prob": wl.SB_HOT_PROB if hot_prob is None else float(hot_prob),
    }
