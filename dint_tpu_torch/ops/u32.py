"""u32 words carried in ``torch.int32`` tensors.

Device tables hold the u32 bit patterns of the JAX package's u32 arrays in
int32 storage: 4 bytes a word, the same layout and byte count. PyTorch on
the CPU does no arithmetic on ``torch.uint32`` (shifts, adds and max raise
NotImplementedError), so the plain path widens to int64 only where an
unsigned shift, add or compare needs it, and narrows back with `wrap_i32`.
Equality compares and bitwise and/or need no widening: they are the same
on the bit patterns. The CUDA kernels read the same storage as
``uint32_t*``.
"""
from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF


def to_u64(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns (or any int tensor) -> int64 holding the u32 value."""
    return x.to(torch.int64) & MASK32


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values -> int32 bit patterns of their low 32 bits (u32 wrap)."""
    x = x & MASK32
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def i32_bits(v: int) -> int:
    """A Python int -> the signed value of its low 32 bits, the int32
    pattern a u32 scalar compares and stores as."""
    v = int(v) & MASK32
    return v - (1 << 32) if v >= (1 << 31) else v


def shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int32-carried u32 words; stays int32."""
    return (x >> k) & ((1 << (32 - k)) - 1)


def pack_stamp(step: int, low: torch.Tensor, k: int) -> torch.Tensor:
    """``(step << k) | low`` as int32-carried u32 (the arb stamp layout)."""
    return wrap_i32((int(step) << k) | low.to(torch.int64))


def from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """numpy u32 (or i32) array -> int32 tensor on ``device``, bits kept."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    if a.dtype != np.int32:
        raise TypeError(f"expected a uint32 or int32 array, got {a.dtype}")
    return torch.from_numpy(a.copy()).to(device)


def to_numpy(x: torch.Tensor) -> np.ndarray:
    """int32-carried u32 tensor -> numpy uint32 array, bits kept."""
    return x.detach().cpu().numpy().astype(np.int32, copy=False).view(np.uint32)
