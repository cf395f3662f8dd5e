"""Device-resident counter plane: the fixed registry and the `Counters`
buffer (the port of `dint_tpu.monitor.counters`).

The reference's servers account for every hot-path event in per-CPU BPF
map counters that userspace reads asynchronously. Here the "map" is one
flat tensor of u32 words (int32-carried, ops/u32.py) on the engine's
device, threaded through the runner's carry; engines bump it in-step and
the host reads it between blocks. The registry below is the JAX module's:
names, kinds and order are schema (artifacts key on the names), so it is
append-only and kept identical to it.

* **Static index sets.** Every update adds reduced scalars at a sorted,
  duplicate-free set of counter ids. The index tensor of each set is made
  once per `Counters` (cached on it), so a step copies nothing from the
  host (a copy from pageable memory synchronises the stream).
* **u32 with wrap-safe draining.** Flow counters are monotonic mod 2^32;
  `delta` subtracts snapshots in uint32 (exact under a single wrap per
  window). Gauges (``ring_hwm``) are unsigned high-water marks.

What differs from JAX: `bump` and `gauge_max` update the buffer in place
(and return the same `Counters`), as the port's tables are updated in
place.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device
from ..ops.u32 import to_u64, wrap_i32

FLOW = "flow"      # monotonic accumulator (wrap-safe window deltas sum)
GAUGE = "gauge"    # high-water mark (windows report the current value)

# --------------------------------------------------------------- registry
# (name, kind, doc). APPEND ONLY — indices are schema. The docs are what
# `tools/dintmon.py summarize --describe` and OBSERVABILITY.md print.
_REGISTRY: tuple[tuple[str, str, str], ...] = (
    ("steps", FLOW,
     "fused pipeline steps executed (scan iterations, drains included)"),
    ("txn_attempted", FLOW,
     "transactions dispatched, counted when their cohort completes — "
     "reconciles with stats[STAT_ATTEMPTED]"),
    ("txn_committed", FLOW,
     "transactions committed — reconciles with stats[STAT_COMMITTED]"),
    ("ab_lock", FLOW,
     "aborts: write-set lock rejected (no-wait 2PL loss)"),
    ("ab_missing", FLOW,
     "aborts: required row absent / insert-exists (TATP semantics)"),
    ("ab_validate", FLOW,
     "aborts: OCC read-set version changed between read and validate"),
    ("ab_logic", FLOW,
     "aborts: SmallBank balance-logic failure (insufficient funds)"),
    ("magic_bad", FLOW,
     "integrity: VAL replies whose magic word mismatched"),
    ("lock_requests", FLOW,
     "lock lanes that requested a grant (active write slots)"),
    ("lock_granted", FLOW, "lock lanes granted"),
    ("lock_rejected", FLOW,
     "lock lanes rejected = reject_held + reject_arb (the generic "
     "engines split by `reject_split`)"),
    ("lock_reject_held", FLOW,
     "lock lanes rejected because the row/slot was stamped by an "
     "in-flight cohort (cross-cohort conflict)"),
    ("lock_reject_arb", FLOW,
     "lock lanes that lost intra-batch first-wins arbitration"),
    ("validate_lanes", FLOW,
     "read-set lanes of surviving RW transactions re-checked at wave 2"),
    ("validate_failed", FLOW,
     "validate lanes whose version compare failed"),
    ("install_writes", FLOW,
     "rows installed at the commit wave (commit/insert/delete lanes)"),
    ("log_appends", FLOW,
     "log entries appended (one per logical install; replicas not "
     "multiplied)"),
    ("repl_push_hop1", FLOW,
     "install records applied from the +1 ppermute hop (CommitBck)"),
    ("repl_push_hop2", FLOW,
     "install records applied from the +2 ppermute hop (CommitBck)"),
    ("route_overflow", FLOW,
     "all_to_all destination-bucket overflow lanes (sharded SmallBank)"),
    ("ring_hwm", GAUGE,
     "log-ring high-water mark: max monotonic lane head observed "
     "(occupancy = min(ring_hwm, capacity))"),
    ("dispatch_xla", FLOW,
     "steps whose random-access ops ran the XLA path"),
    ("dispatch_pallas", FLOW,
     "steps whose random-access ops ran the Pallas DMA-ring kernels"),
    ("hot_hits", FLOW,
     "hot-partition gather lanes served from the dintcache mirror "
     "(use_hotset; hot_hits + hot_cold_rows = partitioned lanes)"),
    ("hot_cold_rows", FLOW,
     "hot-partition gather lanes that fell through to cold full-table "
     "row access (the DMA ring on pallas, the big-array gather on XLA)"),
    ("hot_refresh_bytes", FLOW,
     "bytes of hot-mirror bulk refresh DMA'd to VMEM by the pallas hot "
     "kernels (one mirror copy per partitioned gather; 0 on the XLA "
     "partition route, which has no residency to refresh)"),
    ("fused_dispatch", FLOW,
     "steps whose paired waves ran the round-12 megakernels "
     "(lock_validate + install_log); counted ALONGSIDE dispatch_xla/"
     "dispatch_pallas — the magic gather still dispatches by use_pallas, "
     "so fused_dispatch <= steps and the xla/pallas split stays total"),
    ("route_ici_lanes", FLOW,
     "routed lanes (lock requests + installs) whose owner lives on the "
     "SAME host: the exchange crosses only the ICI axis (2-D sharded "
     "SmallBank; route_ici_lanes + route_dcn_lanes = lock_requests + "
     "install_writes)"),
    ("route_dcn_lanes", FLOW,
     "routed lanes (lock requests + installs) whose owner lives on "
     "ANOTHER host: the exchange pays the DCN hop (2-D sharded "
     "SmallBank)"),
    ("trace_dropped", FLOW,
     "dinttrace events lost to ring overflow: sampled events generated "
     "after the per-window event ring filled (keep-first semantics — "
     "the ring never wraps over recorded events, the excess is dropped "
     "and counted here; 0 whenever the ring is sized for the window)"),
    ("serve_occupancy_lanes", FLOW,
     "dintserve: lanes carrying real admitted transactions in variable-"
     "occupancy serving cohorts (occupancy rides the batch as a device "
     "scalar; serve_occupancy_lanes + serve_padded_lanes = width x "
     "serving steps — the padding-waste reconciliation identity)"),
    ("serve_padded_lanes", FLOW,
     "dintserve: lanes past occupancy masked to no-ops (padding waste "
     "paid to keep one pre-compiled width hot; see "
     "serve_occupancy_lanes for the reconciliation identity)"),
    ("serve_shed_lanes", FLOW,
     "dintserve: admissions shed by the SLO controller before dispatch, "
     "mirrored onto the device ledger like trace_dropped (host tally == "
     "device counter — the graceful-degradation audit trail)"),
    ("route_prefetch_lanes", FLOW,
     "valid lock-request lanes whose routed buckets were exchanged one "
     "step EARLY by the double-buffered mesh serve path (overlap=True): "
     "the DCN all_to_all of cohort i+1 issued under cohort i's owner "
     "waves. Summed over devices and a full run+drain it equals "
     "lock_requests — every prefetched lane is arbitrated exactly once; "
     "0 on unoverlapped routes"),
    ("scan_requests", FLOW,
     "dintscan: Op.SCAN lanes served by the store engine's ordered-run "
     "path (stale-run RETRY lanes included — they consumed a request "
     "slot even though they returned zero rows)"),
    ("scan_rows", FLOW,
     "dintscan: rows returned across all scan replies (sum of per-lane "
     "counts; scan_rows <= scan_requests x scan_max by construction, "
     "with equality iff every scan ran to its full requested length)"),
    ("scan_delta_hits", FLOW,
     "dintscan: scan reply rows served from the write-through delta "
     "overlay rather than the sorted run (scan_delta_hits <= scan_rows; "
     "0 in the step right after a drain-boundary rebuild — the overlay "
     "freshness diagnostic)"),
)

ALL_NAMES: tuple[str, ...] = tuple(n for n, _, _ in _REGISTRY)
COUNTER_KINDS: dict[str, str] = {n: k for n, k, _ in _REGISTRY}
COUNTER_DOCS: dict[str, str] = {n: d for n, _, d in _REGISTRY}
COUNTER_INDEX: dict[str, int] = {n: i for i, n in enumerate(ALL_NAMES)}
N_COUNTERS = len(_REGISTRY)
FLOW_NAMES = tuple(n for n, k, _ in _REGISTRY if k == FLOW)
GAUGE_NAMES = tuple(n for n, k, _ in _REGISTRY if k == GAUGE)

CTR_STEPS = COUNTER_INDEX["steps"]
CTR_TXN_ATTEMPTED = COUNTER_INDEX["txn_attempted"]
CTR_TXN_COMMITTED = COUNTER_INDEX["txn_committed"]
CTR_AB_LOCK = COUNTER_INDEX["ab_lock"]
CTR_AB_MISSING = COUNTER_INDEX["ab_missing"]
CTR_AB_VALIDATE = COUNTER_INDEX["ab_validate"]
CTR_AB_LOGIC = COUNTER_INDEX["ab_logic"]
CTR_MAGIC_BAD = COUNTER_INDEX["magic_bad"]
CTR_LOCK_REQUESTS = COUNTER_INDEX["lock_requests"]
CTR_LOCK_GRANTED = COUNTER_INDEX["lock_granted"]
CTR_LOCK_REJECTED = COUNTER_INDEX["lock_rejected"]
CTR_LOCK_REJECT_HELD = COUNTER_INDEX["lock_reject_held"]
CTR_LOCK_REJECT_ARB = COUNTER_INDEX["lock_reject_arb"]
CTR_VALIDATE_LANES = COUNTER_INDEX["validate_lanes"]
CTR_VALIDATE_FAILED = COUNTER_INDEX["validate_failed"]
CTR_INSTALL_WRITES = COUNTER_INDEX["install_writes"]
CTR_LOG_APPENDS = COUNTER_INDEX["log_appends"]
CTR_REPL_PUSH_HOP1 = COUNTER_INDEX["repl_push_hop1"]
CTR_REPL_PUSH_HOP2 = COUNTER_INDEX["repl_push_hop2"]
CTR_ROUTE_OVERFLOW = COUNTER_INDEX["route_overflow"]
CTR_RING_HWM = COUNTER_INDEX["ring_hwm"]
CTR_DISPATCH_XLA = COUNTER_INDEX["dispatch_xla"]
CTR_DISPATCH_PALLAS = COUNTER_INDEX["dispatch_pallas"]
CTR_HOT_HITS = COUNTER_INDEX["hot_hits"]
CTR_HOT_COLD_ROWS = COUNTER_INDEX["hot_cold_rows"]
CTR_HOT_REFRESH_BYTES = COUNTER_INDEX["hot_refresh_bytes"]
CTR_FUSED_DISPATCH = COUNTER_INDEX["fused_dispatch"]
CTR_ROUTE_ICI_LANES = COUNTER_INDEX["route_ici_lanes"]
CTR_ROUTE_DCN_LANES = COUNTER_INDEX["route_dcn_lanes"]
CTR_TRACE_DROPPED = COUNTER_INDEX["trace_dropped"]
CTR_SERVE_OCC_LANES = COUNTER_INDEX["serve_occupancy_lanes"]
CTR_SERVE_PAD_LANES = COUNTER_INDEX["serve_padded_lanes"]
CTR_SERVE_SHED_LANES = COUNTER_INDEX["serve_shed_lanes"]
CTR_ROUTE_PREFETCH_LANES = COUNTER_INDEX["route_prefetch_lanes"]
CTR_SCAN_REQUESTS = COUNTER_INDEX["scan_requests"]
CTR_SCAN_ROWS = COUNTER_INDEX["scan_rows"]
CTR_SCAN_DELTA_HITS = COUNTER_INDEX["scan_delta_hits"]

# the subset defined with IDENTICAL semantics by the dense engines and
# the generic sort-based pipelines: on the parity workloads
# (the JAX package's dense-vs-generic configuration) these must be
# bit-identical across engine families. Engine-local counters
# (held/arb reject split, ring gauge, dispatch/backend accounting,
# replication hops) are excluded by design — the generic engines either
# cannot observe them or implement the machinery differently.
PARITY_NAMES: tuple[str, ...] = (
    "txn_attempted", "txn_committed", "ab_lock", "ab_missing",
    "ab_validate", "ab_logic", "magic_bad", "lock_requests",
    "lock_granted", "lock_rejected", "validate_lanes", "validate_failed",
    "install_writes", "log_appends",
)


@dataclass
class Counters:
    """The counter plane: one flat i32 [N_COUNTERS] tensor of u32 words,
    and the device index tensors of the update sets seen so far."""
    buf: torch.Tensor
    _idx: dict = field(default_factory=dict, repr=False)


def create(device=None) -> Counters:
    """Zeroed counters on ``device`` (None means CUDA, and raises without
    one)."""
    return Counters(buf=torch.zeros(N_COUNTERS, dtype=torch.int32,
                                    device=resolve_device(device)))


def _update(c: Counters, updates: dict, reduce: str) -> Counters:
    """One in-place update at the sorted counter ids of ``updates``; values
    are Python ints or integer scalar tensors on the buffer's device."""
    if not updates:
        return c
    idx = tuple(sorted(updates))
    dev = c.buf.device
    at = c._idx.get(idx)
    if at is None:
        at = c._idx[idx] = torch.tensor(idx, dtype=torch.int64, device=dev)
    vals = torch.stack([
        to_u64(v.reshape(())) if isinstance(v, torch.Tensor)
        else torch.full((), int(v) & 0xFFFFFFFF, dtype=torch.int64,
                        device=dev) for v in (updates[i] for i in idx)])
    cur = to_u64(c.buf[at])
    new = cur + vals if reduce == "add" else torch.maximum(cur, vals)
    c.buf[at] = wrap_i32(new)
    return c


def bump(c: Counters | None, updates: dict):
    """Add reduced scalars to flow counters, wrapping mod 2^32; None
    passes through."""
    if c is None:
        return None
    return _update(c, updates, "add")


def gauge_max(c: Counters | None, updates: dict):
    """Raise gauge counters to new unsigned high-water marks."""
    if c is None:
        return None
    return _update(c, updates, "max")


# ------------------------------------------------------------- host side


def reject_split(rejected: torch.Tensor, granted: torch.Tensor,
                 tbl: torch.Tensor, key: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(held, arb) i32 counts of the ``rejected`` lock lanes of one batch,
    for engines whose lock server answers GRANT or not with no reason: a
    rejected lane whose (table, key) some lane of the same batch was
    granted lost the batch's first-wins arbitration (arb); any other was
    refused by a lock an earlier cohort holds (held). held + arb ==
    rejected.sum(), so `lock_rejected` splits as on the dense engines.
    Device ops only (no host sync)."""
    code = (tbl.to(torch.int64) << 32) | (key.to(torch.int64) & 0xFFFFFFFF)
    won = torch.where(granted, code, torch.full_like(code, -1))
    arb = rejected & torch.isin(code, won)
    return ((rejected & ~arb).sum(dtype=torch.int32),
            arb.sum(dtype=torch.int32))


def snapshot(counters) -> dict[str, int]:
    """A `Counters`, a list of them (one a partition; over a process
    group another rank's entries are None and skipped, so the dict covers
    this rank's partitions: `sum_over` adds the other ranks'), or a raw
    buffer (tensor or numpy, 1-D or stacked [D, N_COUNTERS]) as a
    {name: int} dict; stacked rows are summed for flow counters and maxed
    for gauges."""
    if isinstance(counters, (list, tuple)):
        # one a partition, each read from its own device
        counters = np.stack([c.buf.detach().cpu().numpy()
                             for c in counters if c is not None])
    buf = counters.buf if isinstance(counters, Counters) else counters
    if isinstance(buf, torch.Tensor):
        buf = buf.detach().cpu().numpy()
    arr = np.asarray(buf)
    if arr.dtype == np.int32:
        arr = arr.view(np.uint32)
    arr = arr.reshape(-1, N_COUNTERS).astype(np.uint64)
    out = {}
    for name, i in COUNTER_INDEX.items():
        col = arr[:, i]
        out[name] = int(col.max() if COUNTER_KINDS[name] == GAUGE
                        else col.sum())
    return out


def sum_over(group, snap: dict[str, int]) -> dict[str, int]:
    """One rank's `snapshot` combined over the ranks of ``group`` (a
    `parallel.dist.Group`) by `snapshot`'s rule across partitions: flow
    counters summed, gauges maxed, so every rank gets the whole mesh's
    dict. Two all_reduces of int64 on the host's group; ``group`` None
    or of one rank returns ``snap`` unchanged."""
    if group is None or group.size == 1:
        return snap
    import torch.distributed as tdist
    names = list(COUNTER_INDEX)
    flows = [n for n in names if COUNTER_KINDS[n] != GAUGE]
    gauges = [n for n in names if COUNTER_KINDS[n] == GAUGE]
    out = {}
    for keys, op in ((flows, tdist.ReduceOp.SUM),
                     (gauges, tdist.ReduceOp.MAX)):
        x = torch.tensor([int(snap.get(n, 0)) for n in keys],
                         dtype=torch.int64)
        tdist.all_reduce(x, op=op, group=group.host)
        out.update(zip(keys, (int(v) for v in x.tolist())))
    return {n: out[n] for n in names}


def delta(cur: dict[str, int], prev: dict[str, int] | None) -> dict[str, int]:
    """Window delta between two snapshots: flow counters subtract in
    uint32 (exact under a single wrap per window); gauges report the
    current value."""
    out = {}
    for name in ALL_NAMES:
        c = cur.get(name, 0)
        if COUNTER_KINDS[name] == GAUGE or prev is None:
            out[name] = int(c)
        else:
            out[name] = int(np.uint32(c) - np.uint32(prev.get(name, 0)))
    return out


def zeros_dict() -> dict[str, int]:
    return {name: 0 for name in ALL_NAMES}
