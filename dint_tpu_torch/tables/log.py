"""Replication log rings (the port of `dint_tpu.tables.log`): the generic
engines' multi-lane `LogRing` and the dense engines' replicated flat
`RepLog`.

Lanes replace the reference's per-CPU rings (log_server/ebpf/ls_kern.c:
63-77): append i goes to lane ``i % L``, its slot is ``head[lane]`` plus its
arrival rank within the lane, and rings wrap (ls_kern.c:72-73). A
`LogRing` holds one replica, [L, CAP, HDR+VW]; in a `RepLog` the three
replica entries of a slot sit side by side in the word axis, so one row
scatter installs all replicas.

Entry layout (u32 words): [flags(is_del|table<<8), key_hi, key_lo, ver, val...]
Words are int32-carried u32 (ops/u32.py); heads are monotonic u32 that wrap
at 2^32.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import resolve_device
from ..ops.u32 import to_u64, wrap_i32

HDR_WORDS = 4


@dataclass
class LogRing:
    entries: torch.Tensor   # i32 [L, CAP, HDR_WORDS + VW]
    head: torch.Tensor      # i32 [L] u32 bits (monotonic; slot = head % CAP)

    @property
    def lanes(self) -> int:
        return self.entries.shape[0]

    @property
    def capacity(self) -> int:
        return self.entries.shape[1]


def _check_capacity(capacity: int):
    if capacity <= 0 or capacity & (capacity - 1):
        raise ValueError(f"log capacity {capacity} is not a power of two")


def create(lanes: int, capacity: int, val_words: int = 10,
           device=None) -> LogRing:
    """An empty ring of ``lanes`` x ``capacity`` entries on ``device``
    (None means CUDA, and raises without one)."""
    _check_capacity(capacity)
    device = resolve_device(device)
    return LogRing(
        entries=torch.zeros((lanes, capacity, HDR_WORDS + val_words),
                            dtype=torch.int32, device=device),
        head=torch.zeros((lanes,), dtype=torch.int32, device=device))


def _lane_slots(head, do_append, lanes: int, cap: int):
    """Round-robin lanes, u32 ``head[lane] + rank`` slots mod ``cap`` and
    per-lane append counts of a batch: (lane, slot, lane_counts), int64.
    Lane l's appends sit at positions l, l+L, ..., so a cumulative sum per
    residue class gives each append its arrival rank within its lane."""
    r = do_append.shape[0]
    lane = torch.arange(r, device=do_append.device) % lanes
    one = do_append.to(torch.int64)
    pad = (-r) % lanes
    one_p = torch.nn.functional.pad(one, (0, pad)).view(-1, lanes)
    excl = torch.cumsum(one_p, 0) - one_p
    rank = excl.reshape(-1)[:r]
    pos = (to_u64(head)[lane] + rank) & 0xFFFFFFFF   # u32 head + rank
    return lane, pos % cap, one_p.sum(0)


def _entry(table_id, is_del, key_hi, key_lo, ver, val):
    """[R, HDR+VW] entries: [flags(is_del|table<<8), key_hi, key_lo, ver,
    val...]."""
    flags = wrap_i32(is_del.to(torch.int64) | (to_u64(table_id) << 8))
    return torch.cat([flags[:, None], key_hi[:, None], key_lo[:, None],
                      ver[:, None], val], dim=1)


def append(ring: LogRing, do_append, table_id, is_del, key_hi, key_lo, ver,
           val):
    """Batched append, in place. do_append: bool [R]; the others [R] or
    [R, VW]. Returns (ring, lane [R], slot [R]) with int32 lane and slot
    for every lane, as JAX's. Masked lanes write nothing: they are
    filtered out before the scatter (JAX routes them to the lane past the
    last and drops them). The kept (lane, slot) pairs are distinct while a
    batch appends fewer than ``capacity`` entries a lane."""
    lane, slot, lane_counts = _lane_slots(ring.head, do_append, ring.lanes,
                                          ring.capacity)
    entry = _entry(table_id, is_del, key_hi, key_lo, ver, val)
    keep = torch.nonzero(do_append).squeeze(1)
    ring.entries[lane[keep], slot[keep]] = entry[keep]
    ring.head = wrap_i32(to_u64(ring.head) + lane_counts)
    return ring, lane.to(torch.int32), slot.to(torch.int32)


@dataclass
class RepLog:
    entries: torch.Tensor   # i32 [L*CAP, S * (HDR_WORDS + VW)]
    head: torch.Tensor      # i32 [L] u32 bits (monotonic; replicas identical)
    lanes: int = 16
    replicas: int = 3

    @property
    def entry_words(self) -> int:
        return self.entries.shape[1] // self.replicas

    @property
    def capacity(self) -> int:
        return self.entries.shape[0] // self.lanes


def create_rep(lanes: int, capacity: int, val_words: int = 10,
               replicas: int = 3, device=None) -> RepLog:
    """An empty ring of ``lanes`` x ``capacity`` slots on ``device`` (None
    means CUDA, and raises without one)."""
    _check_capacity(capacity)
    device = resolve_device(device)
    return RepLog(
        entries=torch.zeros((lanes * capacity,
                             replicas * (HDR_WORDS + val_words)),
                            dtype=torch.int32, device=device),
        head=torch.zeros((lanes,), dtype=torch.int32, device=device),
        lanes=lanes, replicas=replicas)


def plan_rep(ring: RepLog, do_append, table_id, is_del, key_hi, key_lo,
             ver, val):
    """Plan a replicated append without writing: returns (flat [R] int64
    row ids, -1 for masked lanes; entry3 [R, S*(HDR+VW)] i32 replica-packed
    rows; lane_counts [L] int64)."""
    cap = ring.capacity
    lane, slot, lane_counts = _lane_slots(ring.head, do_append, ring.lanes,
                                          cap)
    flat = torch.where(do_append, lane * cap + slot, -1)
    entry = _entry(table_id, is_del, key_hi, key_lo, ver, val)
    entry3 = entry.repeat(1, ring.replicas)                # [R, S*(HDR+VW)]
    return flat, entry3, lane_counts


def append_rep(ring: RepLog, do_append, table_id, is_del, key_hi, key_lo,
               ver, val) -> RepLog:
    """Batched replicated append, in place. Masked lanes are filtered out
    before the row scatter; the kept rows are distinct (per-lane arrival
    ranks, fewer than ``capacity`` appends per lane per batch), so no write
    depends on the order of duplicate indices."""
    flat, entry3, lane_counts = plan_rep(ring, do_append, table_id, is_del,
                                         key_hi, key_lo, ver, val)
    keep = torch.nonzero(do_append).squeeze(1)
    ring.entries[flat[keep]] = entry3[keep]
    ring.head = wrap_i32(to_u64(ring.head) + lane_counts)
    return ring


def advance_watermark(ring: LogRing | RepLog, watermark: torch.Tensor,
                      consumed: torch.Tensor) -> torch.Tensor:
    """A ring's durability watermark [L] after ``consumed`` entries a lane
    were checkpointed or replayed downstream: the u32 ``min(head,
    watermark + consumed)`` on int32 bit patterns, the sum wrapping at
    2^32. The ring wraps regardless (ls_kern.c:72-73); a caller that keeps
    a watermark bounds it while head - watermark <= capacity. No engine
    threads one yet."""
    want = (to_u64(watermark) + to_u64(consumed)) & 0xFFFFFFFF
    return wrap_i32(torch.minimum(to_u64(ring.head), want))


def replica_entries(ring: RepLog, replica: int = 0) -> torch.Tensor:
    """One replica's slots in LogRing layout [L, CAP, HDR+VW]."""
    ew = ring.entry_words
    return ring.entries[:, replica * ew:(replica + 1) * ew].reshape(
        ring.lanes, ring.capacity, ew)
