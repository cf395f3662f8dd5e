"""Lock and version tables of the generic engines (the port of
`dint_tpu.tables.locks`).

The reference's lock arrays:
  - no-wait 2PL shared/exclusive counters `struct lock_unit {lock, num_sh,
    num_ex}` (lock_2pl/ebpf/utils.h; smallbank/ebpf/shard_kern.c:26-38);
  - FaSST OCC: one lock word and a version table
    (lock_fasst/ebpf/ls_kern.c; tatp/ebpf/shard_kern.c:26-59).

Keys map to lock slots by hash, as in the reference (fasthash64(key) %
kLockHashSize, lock_2pl/caladan/proto.h:8): a collision conflates two
locks. Lock bits are ``torch.bool``; versions and owners are u32 words
carried in int32 (ops/u32.py); the S/X counters are int32. Tables are
updated in place by the engines.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import resolve_device
from ..ops import hashing

I32 = torch.int32


def _check_slots(n_slots: int):
    if n_slots <= 0 or n_slots & (n_slots - 1):
        raise ValueError(f"lock slots {n_slots} is not a power of two")


@dataclass
class SXLockTable:
    """No-wait 2PL shared/exclusive counters, one unit per hash slot."""
    num_sh: torch.Tensor   # i32 [NL]
    num_ex: torch.Tensor   # i32 [NL]

    @property
    def n_slots(self) -> int:
        return self.num_sh.shape[0]


def create_sx(n_slots: int, device=None) -> SXLockTable:
    """An all-free table on ``device`` (None = CUDA)."""
    _check_slots(n_slots)
    dev = resolve_device(device)
    return SXLockTable(num_sh=torch.zeros(n_slots, dtype=I32, device=dev),
                       num_ex=torch.zeros(n_slots, dtype=I32, device=dev))


@dataclass
class OCCTable:
    """FaSST-style OCC state: lock bit + record version per hash slot."""
    locked: torch.Tensor   # bool [NL]
    ver: torch.Tensor      # i32 [NL] u32 bits

    @property
    def n_slots(self) -> int:
        return self.locked.shape[0]


def create_occ(n_slots: int, device=None) -> OCCTable:
    _check_slots(n_slots)
    dev = resolve_device(device)
    return OCCTable(locked=torch.zeros(n_slots, dtype=torch.bool, device=dev),
                    ver=torch.zeros(n_slots, dtype=I32, device=dev))


@dataclass
class OCCAttrTable:
    """OCC lock word + the holder's key, so that a reject tells a true
    same-key conflict from hash-slot sharing: the reference's `struct
    txn_lock {lock_bit, key}` (tatp/ebpf/lock_kern.c:12-16)."""
    locked: torch.Tensor    # bool [NL]
    ver: torch.Tensor       # i32 [NL] u32 bits
    owner_hi: torch.Tensor  # i32 [NL] u32 bits
    owner_lo: torch.Tensor  # i32 [NL] u32 bits

    @property
    def n_slots(self) -> int:
        return self.locked.shape[0]


def create_occ_attr(n_slots: int, device=None) -> OCCAttrTable:
    _check_slots(n_slots)
    dev = resolve_device(device)

    def z():
        return torch.zeros(n_slots, dtype=I32, device=dev)

    return OCCAttrTable(
        locked=torch.zeros(n_slots, dtype=torch.bool, device=dev),
        ver=z(), owner_hi=z(), owner_lo=z())


def lock_slot(key_hi, key_lo, n_slots: int):
    """key -> lock-table slot (hash-sharded; collisions conflate)."""
    return hashing.bucket(key_hi, key_lo, n_slots)
