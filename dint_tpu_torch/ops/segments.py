"""Sort + segmented reductions: the store batch's conflict resolution (the
port of `dint_tpu.ops.segments`).

A batch of R requests is sorted by u64 key, stable in arrival order; equal
keys form segments, and closed-form segmented reductions give what
processing each segment's requests one at a time in arrival order would.

What differs from JAX: the sort is one stable `torch.sort` of an int64
key whose signed order is the unsigned u64 order (`u64.sort_key`); JAX
sorts (key_hi, key_lo, arrival) lexicographically, which orders the same.
`scatter_rows` updates its table in place and keeps only the masked-in
lanes (one ``nonzero``, a host sync).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .u64 import sort_key

I32 = torch.int32


class SortedBatch(NamedTuple):
    """A batch sorted by (key_hi, key_lo, arrival order); every field [R].
    ``perm`` maps sorted position -> original position."""
    key_hi: torch.Tensor
    key_lo: torch.Tensor
    perm: torch.Tensor       # int64: original index of each sorted element
    head: torch.Tensor       # bool: first element of its key segment
    last: torch.Tensor       # bool: last element of its key segment
    head_pos: torch.Tensor   # int32: sorted position of the segment's head
    seg_id: torch.Tensor     # int64: dense segment id (0..n_segments-1)
    rank: torch.Tensor       # int32: position within the segment


def sort_batch(key_hi, key_lo) -> SortedBatch:
    """Sort a batch of u64 keys; arrival order (the index) breaks ties."""
    r = key_hi.shape[0]
    perm = torch.sort(sort_key(key_hi, key_lo), stable=True).indices
    s_hi, s_lo = key_hi[perm], key_lo[perm]
    head = torch.ones(r, dtype=torch.bool, device=key_hi.device)
    head[1:] = (s_hi[1:] != s_hi[:-1]) | (s_lo[1:] != s_lo[:-1])
    last = torch.ones_like(head)
    last[:-1] = head[1:]
    idx = torch.arange(r, dtype=I32, device=key_hi.device)
    head_pos = torch.cummax(torch.where(head, idx, 0), 0).values
    seg_id = torch.cumsum(head, 0) - 1
    return SortedBatch(s_hi, s_lo, perm, head, last, head_pos, seg_id,
                       idx - head_pos)


def at_head(sb: SortedBatch, x):
    """Each segment's head value of x, broadcast to its elements."""
    return x[sb.head_pos.long()]


def seg_sum(sb: SortedBatch, x):
    """Per element, the sum of x over its whole segment."""
    totals = torch.zeros_like(x).index_add_(0, sb.seg_id, x)
    return totals[sb.seg_id]


def seg_cumsum_excl(sb: SortedBatch, x):
    """Segmented exclusive prefix sum (x over earlier same-key lanes)."""
    cs = torch.cumsum(x, 0, dtype=x.dtype)
    hp = sb.head_pos.long()
    return cs - (cs[hp] - x[hp]) - x


def _seg_reduce_where(sb, pred, x, default, how, ident):
    masked = torch.where(pred, x, ident)
    out = torch.full_like(x, ident).scatter_reduce_(0, sb.seg_id, masked, how)
    return torch.where(seg_any(sb, pred), out[sb.seg_id], default)


def seg_min_where(sb: SortedBatch, pred, x, default):
    """Per-segment min of x over elements where pred, broadcast; exactly
    ``default`` for segments where pred holds nowhere."""
    return _seg_reduce_where(sb, pred, x, default, "amin",
                             torch.iinfo(x.dtype).max)


def seg_max_where(sb: SortedBatch, pred, x, default):
    """Per-segment max of x over elements where pred, broadcast; exactly
    ``default`` for segments where pred holds nowhere."""
    return _seg_reduce_where(sb, pred, x, default, "amax",
                             torch.iinfo(x.dtype).min)


def seg_any(sb: SortedBatch, pred):
    return seg_sum(sb, pred.to(I32)) > 0


NO_RANK = 1 << 30     # first_rank_where's answer where pred holds nowhere


def first_rank_where(sb: SortedBatch, pred):
    """Rank (within its segment) of the segment's earliest element where
    pred holds, broadcast; NO_RANK where it holds nowhere."""
    return seg_min_where(sb, pred, sb.rank, NO_RANK)


def unsort(sb: SortedBatch, *xs):
    """Arrays computed in sorted order, back in original batch order."""
    out = []
    for x in xs:
        o = torch.empty_like(x)
        o[sb.perm] = x
        out.append(o)
    return out[0] if len(out) == 1 else tuple(out)


def scatter_rows(table, row_idx, values, mask):
    """``table[row_idx[i]] = values[i]`` where mask[i], in place; masked
    lanes write nothing (any dtype, bool tables included). One writer per
    row, or writers that agree, is the caller's job."""
    keep = torch.nonzero(mask).squeeze(1)
    table[row_idx[keep].long()] = values[keep]
    return table
