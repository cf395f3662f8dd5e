"""Replicated flat log ring: the dense engine's log x3
(`dint_tpu.tables.log.RepLog`).

Lanes replace the reference's per-CPU rings (log_server/ebpf/ls_kern.c:
63-77): append i goes to lane ``i % L``, its slot is ``head[lane]`` plus its
arrival rank within the lane, and rings wrap (ls_kern.c:72-73). The three
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
    if capacity <= 0 or capacity & (capacity - 1):
        raise ValueError(f"log capacity {capacity} is not a power of two")
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
    r = do_append.shape[0]
    lanes = ring.lanes
    cap = ring.capacity
    lane = torch.arange(r, device=do_append.device) % lanes
    one = do_append.to(torch.int64)
    pad = (-r) % lanes
    one_p = torch.nn.functional.pad(one, (0, pad)).view(-1, lanes)
    excl = torch.cumsum(one_p, 0) - one_p
    rank = excl.reshape(-1)[:r]
    lane_counts = one_p.sum(0)
    pos = (to_u64(ring.head)[lane] + rank) & 0xFFFFFFFF   # u32 head + rank
    slot = pos % cap
    flat = torch.where(do_append, lane * cap + slot, -1)

    flags = wrap_i32(is_del.to(torch.int64)
                     | (to_u64(table_id) << 8))
    entry = torch.cat([flags[:, None], key_hi[:, None], key_lo[:, None],
                       ver[:, None], val], dim=1)          # [R, HDR+VW]
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


def advance_watermark(ring: RepLog, watermark: torch.Tensor,
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
