"""64-bit keys as (hi, lo) pairs of int32-carried u32 words (the port of
`dint_tpu.ops.u64`).

Device code keeps a u64 key as two int32 tensors holding the u32 bit
patterns of its high and low words (ops/u32.py); host code uses numpy
uint64. Arithmetic widens each word to int64 (``u32.to_u64``) and narrows
back with ``u32.wrap_i32``. The 64-bit multiply keeps the JAX module's
16-bit limbs, so every partial product stays below 2^33 and no int64
product can overflow: signed overflow has no defined wrap in PyTorch on
either device.

Arguments may be tensors or Python ints (constants, as `const` returns
them); results are int32 tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from .u32 import MASK32, i32_bits, to_u64, wrap_i32


def split(x: np.ndarray):
    """Host-side: uint64 ndarray -> (hi, lo) uint32 ndarrays."""
    x = np.asarray(x, dtype=np.uint64)
    return ((x >> np.uint64(32)).astype(np.uint32),
            (x & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def join(hi, lo) -> np.ndarray:
    """Host-side: (hi, lo) uint32 ndarrays -> uint64 ndarray."""
    return ((np.asarray(hi).astype(np.uint32).astype(np.uint64)
             << np.uint64(32))
            | np.asarray(lo).astype(np.uint32).astype(np.uint64))


def _u(x):
    """A word as its u32 value: int64 tensor, or Python int."""
    return to_u64(x) if isinstance(x, torch.Tensor) else int(x) & MASK32


def const(value: int):
    """Python int -> (hi, lo) as the int32 bit patterns of its words."""
    value &= (1 << 64) - 1
    return i32_bits(value >> 32), i32_bits(value & MASK32)


def xor(a_hi, a_lo, b_hi, b_lo):
    return a_hi ^ b_hi, a_lo ^ b_lo


def add(a_hi, a_lo, b_hi, b_lo):
    """64-bit add on pairs, wrapping mod 2^64."""
    lo = _u(a_lo) + _u(b_lo)
    return wrap_i32(_u(a_hi) + _u(b_hi) + (lo >> 32)), wrap_i32(lo)


def shr(hi, lo, n: int):
    """Logical shift right by a constant 0 < n < 64."""
    h, l_ = _u(hi), _u(lo)
    if n >= 32:
        return torch.zeros_like(hi), wrap_i32(h >> (n - 32))
    return wrap_i32(h >> n), wrap_i32((l_ >> n) | (h << (32 - n)))


def shl(hi, lo, n: int):
    """Shift left by a constant 0 < n < 64."""
    h, l_ = _u(hi), _u(lo)
    if n >= 32:
        return wrap_i32(l_ << (n - 32)), torch.zeros_like(lo)
    return wrap_i32((h << n) | (l_ >> (32 - n))), wrap_i32(l_ << n)


def _mul32x32_u(a, b):
    """Full 32x32 -> 64-bit product of u32 values as (hi, lo) u32 values,
    by 16-bit limbs: each partial product is below 2^32 and every sum
    below 2^34."""
    a, b = _u(a), _u(b)
    a_lo, a_hi = a & 0xFFFF, a >> 16
    b_lo, b_hi = b & 0xFFFF, b >> 16
    ll = a_lo * b_lo
    mid = a_lo * b_hi + a_hi * b_lo + (ll >> 16)
    lo = ((mid & 0xFFFF) << 16) | (ll & 0xFFFF)
    hi = (a_hi * b_hi + (mid >> 16)) & MASK32
    return hi, lo


def mul32x32(a, b):
    """Full 32x32 -> 64-bit product as (hi, lo) int32 bit patterns."""
    hi, lo = _mul32x32_u(a, b)
    return wrap_i32(hi), wrap_i32(lo)


def mul(a_hi, a_lo, b_hi, b_lo):
    """64x64 -> the low 64 bits of the product, as pairs."""
    hi, lo = _mul32x32_u(a_lo, b_lo)
    cross = _mul32x32_u(a_lo, b_hi)[1] + _mul32x32_u(a_hi, b_lo)[1]
    return wrap_i32(hi + cross), wrap_i32(lo)


def sort_key(hi, lo) -> torch.Tensor:
    """One int64 per key whose signed order is the keys' unsigned u64
    order: ``(hi ^ 2^31)`` as a signed word, times 2^32, plus ``lo``.
    That is ``u64 ^ (1 << 63)`` read as int64, built without a shift into
    the sign bit. The PAD key 0xFFFFFFFF:FFFFFFFF maps to the int64
    maximum, so it sorts last."""
    top = (hi ^ torch.iinfo(torch.int32).min).to(torch.int64)
    return top * (1 << 32) + to_u64(lo)


def lt(a_hi, a_lo, b_hi, b_lo):
    """Unsigned 64-bit less-than."""
    return sort_key(a_hi, a_lo) < sort_key(b_hi, b_lo)
