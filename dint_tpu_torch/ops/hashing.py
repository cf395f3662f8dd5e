"""fasthash64 for key -> bucket / bloom-bit mapping (the port of
`dint_tpu.ops.hashing`).

The reference hashes keys with fasthash64 (store/ebpf/utils.h:120-168).
The device version runs on (hi, lo) pairs of int32-carried u32 words
(ops/u64.py), the host version on numpy uint64; the two agree bit for bit
with each other and with the JAX package's.
"""
from __future__ import annotations

import numpy as np
import torch

from . import u64
from .u32 import shr

# fasthash64's mix constant (m) and seed, store/ebpf/utils.h:120-168
_M = 0x880355F21E6D1965
_C = 0x2127599BF4325C37
_SEED = 0xDEADBEEF
_H0 = (_SEED ^ (8 * _M)) & ((1 << 64) - 1)


def _mix(hi, lo):
    """h ^= h >> 23; h *= 0x2127599bf4325c37; h ^= h >> 47."""
    hi, lo = u64.xor(hi, lo, *u64.shr(hi, lo, 23))
    hi, lo = u64.mul(hi, lo, *u64.const(_C))
    return u64.xor(hi, lo, *u64.shr(hi, lo, 47))


def hash64(key_hi: torch.Tensor, key_lo: torch.Tensor):
    """fasthash64 of single u64 keys (len 8, fixed seed) -> (hi, lo)."""
    v_hi, v_lo = _mix(key_hi, key_lo)
    h_hi, h_lo = u64.xor(*u64.const(_H0), v_hi, v_lo)
    h_hi, h_lo = u64.mul(h_hi, h_lo, *u64.const(_M))
    return _mix(h_hi, h_lo)


def hash64_np(key: np.ndarray) -> np.ndarray:
    """Host-side fasthash64, bit-identical to `hash64`."""
    mask = np.uint64(0xFFFFFFFFFFFFFFFF)

    def mix(h):
        h = h ^ (h >> np.uint64(23))
        with np.errstate(over="ignore"):
            h = (h * np.uint64(_C)) & mask
        return h ^ (h >> np.uint64(47))

    key = np.asarray(key, np.uint64)
    with np.errstate(over="ignore"):
        h = (np.uint64(_H0) ^ mix(key)) * np.uint64(_M) & mask
    return mix(h)


def bucket_pair(key_hi, key_lo, n_buckets: int):
    """key -> two bucket choices from disjoint bits of one hash: the low
    word for the first, the high word for the second (n_buckets <= 2^26,
    clear of the bloom bits). Returns int32 [R] each."""
    assert n_buckets & (n_buckets - 1) == 0 and n_buckets <= (1 << 26)
    hi, lo = hash64(key_hi, key_lo)
    return lo & (n_buckets - 1), hi & (n_buckets - 1)


def bucket_pair_np(key, n_buckets: int):
    assert n_buckets & (n_buckets - 1) == 0 and n_buckets <= (1 << 26)
    h = hash64_np(key)
    return ((h & np.uint64(n_buckets - 1)).astype(np.int64),
            ((h >> np.uint64(32)) & np.uint64(n_buckets - 1)).astype(np.int64))


def bucket(key_hi, key_lo, n_buckets: int):
    """key -> bucket index in [0, n_buckets), a power of two."""
    assert n_buckets & (n_buckets - 1) == 0, "n_buckets must be a power of two"
    return hash64(key_hi, key_lo)[1] & (n_buckets - 1)


def bucket_np(key, n_buckets: int):
    assert n_buckets & (n_buckets - 1) == 0
    return (hash64_np(key) & np.uint64(n_buckets - 1)).astype(np.int64)


def bloom_bit(key_hi, key_lo):
    """key -> bit in a 64-bit per-bucket bloom filter: the hash's top 6
    bits (store/ebpf/store_kern.c:88-95). int32 [R] in [0, 64)."""
    return shr(hash64(key_hi, key_lo)[0], 26)


def bloom_bit_np(key):
    return (hash64_np(key) >> np.uint64(58)).astype(np.int64)
