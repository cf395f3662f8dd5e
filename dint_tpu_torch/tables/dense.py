"""Dense tables: direct-indexed value/version arrays for dense keyspaces
(the port of `dint_tpu.tables.dense`).

SmallBank accounts and TATP subscriber ids are dense integers, so their
tables index device arrays directly: no probe, no buckets, exact per-row
locks. ``val`` is a flat interleaved word array (row r's words at
[r*VW, (r+1)*VW)); words are int32-carried u32 (ops/u32.py). Writes are
in place.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..ops.u32 import from_numpy

I32 = torch.int32


@dataclass
class DenseTable:
    val: torch.Tensor    # i32 [N * VW] interleaved u32 words
    ver: torch.Tensor    # i32 [N] u32 bits
    val_words: int = 10

    @property
    def size(self) -> int:
        return self.ver.shape[0]


def create(n: int, val_words: int, device=None) -> DenseTable:
    """An all-zero table of ``n`` rows on ``device`` (None = CUDA)."""
    assert n * val_words < (1 << 31), "row*VW overflows i32 flat indices"
    dev = resolve_device(device)
    return DenseTable(val=torch.zeros(n * val_words, dtype=I32, device=dev),
                      ver=torch.zeros(n, dtype=I32, device=dev),
                      val_words=val_words)


def row_word_idx(idx: torch.Tensor, val_words: int) -> torch.Tensor:
    """Flat word indices [R, VW] of rows [R] in an interleaved value array
    (row r's words at [r*VW, (r+1)*VW)); int64."""
    return (idx.to(torch.int64)[:, None] * val_words
            + torch.arange(val_words, device=idx.device)[None])


def gather_rows(table: DenseTable, idx: torch.Tensor) -> torch.Tensor:
    """Row gather: in-bounds idx [R] -> values [R, VW]."""
    return table.val.view(-1, table.val_words)[idx.long()]


def scatter_rows_val(table: DenseTable, idx, values, mask) -> torch.Tensor:
    """Masked row scatter into ``table.val``, in place; masked lanes write
    nothing (JAX drops them out of bounds). Returns the flat val array."""
    keep = torch.nonzero(mask).squeeze(1)
    table.val.view(-1, table.val_words)[idx[keep].long()] = values[keep]
    return table.val


def populate(table: DenseTable, vals: np.ndarray, vers=None) -> DenseTable:
    """A table of the same geometry holding host ``vals`` [N, VW] (u32) and
    ``vers`` [N] (ones when None), on the table's device."""
    vals = np.asarray(vals, np.uint32)
    assert vals.shape == (table.size, table.val_words)
    if vers is None:
        vers = np.ones(table.size, np.uint32)
    dev = table.ver.device
    return dataclasses.replace(
        table, val=from_numpy(vals.reshape(-1), dev),
        ver=from_numpy(np.asarray(vers, np.uint32), dev))
