"""Device-resident bucketed hash table of the store (the port of
`dint_tpu.tables.kv`).

Layout (struct of arrays, S slots a bucket, all flat; entry e =
bucket*S + slot), as in the JAX module so that `convert` carries it leaf
for leaf:

    key_hi/key_lo  i32 [NB*S]      u32 words (ops/u32.py)
    val            i32 [NB*S*VW]   interleaved: entry e at [e*VW, (e+1)*VW)
    ver            i32 [NB*S]
    valid          bool [NB*S]
    bloom_hi/lo    i32 [NB]        the 64-bit per-bucket bloom word

Keys are placed by two-choice hashing (`assign_two_choice`, host numpy and
one stable sort per round on ``device``), and the whole keyspace lives on
the device.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..ops import hashing, segments, u64
from ..ops.u32 import MASK32, from_numpy, to_numpy, wrap_i32
from . import dense

I32 = torch.int32


@dataclass
class KVTable:
    key_hi: torch.Tensor     # i32 [NB*S]
    key_lo: torch.Tensor     # i32 [NB*S]
    val: torch.Tensor        # i32 [NB*S*VW] interleaved
    ver: torch.Tensor        # i32 [NB*S]
    valid: torch.Tensor      # bool [NB*S]
    bloom_hi: torch.Tensor   # i32 [NB]
    bloom_lo: torch.Tensor   # i32 [NB]
    slots: int = 4
    val_words: int = 10

    @property
    def n_buckets(self) -> int:
        return self.key_hi.shape[0] // self.slots

    @property
    def val2d(self) -> torch.Tensor:
        """[NB*S, VW] view of the flat val words."""
        return self.val.view(-1, self.val_words)

    def clone(self) -> "KVTable":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).clone()
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def create(n_buckets: int, slots: int = 4, val_words: int = 10,
           device=None) -> KVTable:
    """An empty table on ``device`` (None = CUDA)."""
    assert n_buckets & (n_buckets - 1) == 0
    ne = n_buckets * slots
    assert ne * val_words < (1 << 31), "entry*VW overflows i32 flat indices"
    dev = resolve_device(device)

    def z(n, dt=I32):
        return torch.zeros(n, dtype=dt, device=dev)

    return KVTable(key_hi=z(ne), key_lo=z(ne), val=z(ne * val_words),
                   ver=z(ne), valid=z(ne, torch.bool), bloom_hi=z(n_buckets),
                   bloom_lo=z(n_buckets), slots=slots, val_words=val_words)


def bucket_rows(table: KVTable, bkt: torch.Tensor) -> torch.Tensor:
    """Flat entry indices of each request's bucket row: int64 [R, S]."""
    s = table.slots
    return (bkt.to(torch.int64)[:, None] * s
            + torch.arange(s, device=bkt.device)[None])


def entry_val(table: KVTable, eidx: torch.Tensor) -> torch.Tensor:
    """Entry values: eidx [R] -> [R, VW]."""
    return table.val[dense.row_word_idx(eidx, table.val_words)]


def val_word_idx(table: KVTable, eidx: torch.Tensor) -> torch.Tensor:
    """Flat word indices [R*VW] of whole entry values."""
    return dense.row_word_idx(eidx, table.val_words).reshape(-1)


def _match_bucket(table: KVTable, key_hi, key_lo, bkt):
    rows = bucket_rows(table, bkt)                    # [R, S]
    rows_valid = table.valid[rows]
    match = (rows_valid & (table.key_hi[rows] == key_hi[:, None])
             & (table.key_lo[rows] == key_lo[:, None]))
    free = (~rows_valid).sum(-1, dtype=I32)
    # argmax over an int tensor: the first match, 0 when there is none
    return (match.any(-1), torch.argmax(match.to(I32), -1).to(I32), free)


def probe_loc(table: KVTable, key_hi, key_lo, b1, b2):
    """Two-choice location probe without the value gather. Returns (hit
    bool [R], bkt i32 [R], slot i32 [R], free1 i32 [R], free2 i32 [R])."""
    hit1, slot1, free1 = _match_bucket(table, key_hi, key_lo, b1)
    hit2, slot2, free2 = _match_bucket(table, key_hi, key_lo, b2)
    return (hit1 | hit2, torch.where(hit1, b1, b2),
            torch.where(hit1, slot1, slot2), free1, free2)


def probe(table: KVTable, key_hi, key_lo, b1, b2):
    """Two-choice probe. Returns (hit, bkt, slot, val [R, VW], ver, free1,
    free2); bkt/slot are the key's location when hit, arbitrary
    otherwise."""
    hit, bkt, slot, free1, free2 = probe_loc(table, key_hi, key_lo, b1, b2)
    eidx = bkt * table.slots + slot
    return (hit, bkt, slot, entry_val(table, eidx),
            table.ver[eidx.long()], free1, free2)


def bloom_maybe(table: KVTable, key_hi, key_lo, b1, b2):
    """True if either candidate bucket's bloom admits the key."""
    bit = hashing.bloom_bit(key_hi, key_lo)           # [R] in [0, 64)
    use_hi = bit >= 32
    shift = torch.where(use_hi, bit - 32, bit)

    def hit(b):
        b = b.long()
        word = torch.where(use_hi, table.bloom_hi[b], table.bloom_lo[b])
        return ((word >> shift) & 1) == 1

    return hit(b1) | hit(b2)


def nth_free_slot(valid_rows: torch.Tensor, rank: torch.Tensor):
    """Per request, the index of the (rank+1)-th free slot of its bucket
    row: valid_rows bool [R, S], rank i32 [R] -> (has bool, slot i32)."""
    free = ~valid_rows
    cumfree = torch.cumsum(free.to(I32), -1, dtype=I32)
    want = free & (cumfree == rank[:, None] + 1)
    return want.any(-1), torch.argmax(want.to(I32), -1).to(I32)


def _bloom_words(rows_hi, rows_lo, rows_valid):
    """OR of 1 << bloom_bit over the valid keys of each bucket row [R, S]
    -> (hi, lo) i32 [R]."""
    bit = hashing.bloom_bit(rows_hi, rows_lo)
    hi_bits = torch.where(rows_valid & (bit >= 32),
                          wrap_i32(torch.ones_like(bit, dtype=torch.int64)
                                   << (bit - 32).clamp(0, 31)), 0)
    lo_bits = torch.where(rows_valid & (bit < 32),
                          wrap_i32(torch.ones_like(bit, dtype=torch.int64)
                                   << bit.clamp(0, 31)), 0)
    new_hi, new_lo = hi_bits[:, 0], lo_bits[:, 0]
    for s in range(1, hi_bits.shape[1]):
        new_hi = new_hi | hi_bits[:, s]
        new_lo = new_lo | lo_bits[:, s]
    return new_hi, new_lo


def recompute_bloom(table: KVTable, bkt, write_mask) -> KVTable:
    """Recompute the bloom word of each masked bucket from its live keys,
    in place (one ``nonzero`` per word)."""
    rows = bucket_rows(table, bkt)
    new_hi, new_lo = _bloom_words(table.key_hi[rows], table.key_lo[rows],
                                  table.valid[rows])
    segments.scatter_rows(table.bloom_hi, bkt, new_hi, write_mask)
    segments.scatter_rows(table.bloom_lo, bkt, new_lo, write_mask)
    return table


# ---------------------------------------------------------------- host-side


def to_dict(table: KVTable) -> dict:
    """Live entries as {key: (val tuple, ver)} for differential tests."""
    valid = table.valid.cpu().numpy()
    e = np.nonzero(valid)[0]
    keys = u64.join(to_numpy(table.key_hi)[e], to_numpy(table.key_lo)[e])
    vals = to_numpy(table.val).reshape(-1, table.val_words)[e]
    vers = to_numpy(table.ver)[e]
    return {int(k): (tuple(int(x) for x in v), int(ver))
            for k, v, ver in zip(keys, vals, vers)}


def _within_bucket_rank(bkt: np.ndarray, priority, device: torch.device):
    """Rank of each key within its bucket, keys ordered by bucket and then
    by ``priority`` (numpy's ``lexsort((priority, bkt))``; without a
    priority, a stable sort by bucket). The sort runs on ``device`` as two
    stable torch sorts, so the order, ties included, is lexsort's."""
    b = torch.from_numpy(np.ascontiguousarray(bkt, np.int64)).to(device)
    if priority is not None:
        p = torch.from_numpy(np.ascontiguousarray(priority)).to(device)
        order = torch.sort(p, stable=True).indices
        order = order[torch.sort(b[order], stable=True).indices]
    else:
        order = torch.sort(b, stable=True).indices
    sorted_b = b[order]
    start = torch.ones_like(sorted_b, dtype=torch.bool)
    start[1:] = sorted_b[1:] != sorted_b[:-1]
    idx = torch.arange(len(bkt), device=b.device)
    within_sorted = idx - torch.cummax(torch.where(start, idx, 0), 0).values
    within = torch.empty_like(within_sorted)
    within[order] = within_sorted
    return within.cpu().numpy()


def assign_two_choice(keys: np.ndarray, n_buckets: int, slots: int,
                      max_iters: int = 200, device=None):
    """Offline two-choice placement (the JAX module's parallel random-walk
    cuckoo, with its rng and its draws): per key, one of its two candidate
    buckets so that no bucket holds more than ``slots`` keys. Each round's
    ranking sort runs on ``device`` (None = CUDA). Returns (bkt [N],
    slot [N]) int64; raises if it cannot converge."""
    device = resolve_device(device)
    keys = np.asarray(keys, np.uint64)
    b1, b2 = hashing.bucket_pair_np(keys, n_buckets)
    rng = np.random.default_rng(0xD1A7)
    choice = np.zeros(len(keys), bool)   # False -> b1
    for _ in range(max_iters):
        cur = np.where(choice, b2, b1)
        within = _within_bucket_rank(cur, priority=rng.random(len(keys)),
                                     device=device)
        over = within >= slots
        if not over.any():
            return cur, within
        choice ^= over & (rng.random(len(keys)) < 0.7)
    raise ValueError(
        f"two-choice placement did not converge: {len(keys)} keys into "
        f"{n_buckets} buckets x {slots} slots = {n_buckets * slots} capacity "
        f"(load {len(keys) / (n_buckets * slots):.2f}; need <~0.9 — grow "
        "n_buckets)")


def populate(table: KVTable, keys: np.ndarray, vals: np.ndarray,
             vers: np.ndarray | None = None) -> KVTable:
    """Bulk-load a table from host numpy keys and values, placed by
    two-choice hashing, on the table's device; returns a new table with
    the same geometry. Raises on duplicate keys or a keyspace the table
    cannot hold."""
    nb, s, vw = table.n_buckets, table.slots, table.val_words
    dev = table.key_hi.device
    ne = nb * s
    keys = np.asarray(keys, np.uint64)
    if len(np.unique(keys)) != len(keys):
        raise ValueError("duplicate keys in populate")
    if vers is None:
        vers = np.ones(len(keys), np.uint32)
    bkt, slot = assign_two_choice(keys, nb, s, device=dev)
    e = torch.from_numpy(bkt * s + slot).to(dev)

    k_hi, k_lo = u64.split(keys)
    out = create(nb, s, vw, device=dev)
    out.key_hi[e] = from_numpy(k_hi, dev)
    out.key_lo[e] = from_numpy(k_lo, dev)
    out.val.view(-1, vw)[e] = from_numpy(np.asarray(vals, np.uint32)
                                         .reshape(len(keys), vw), dev)
    out.ver[e] = from_numpy(np.asarray(vers, np.uint32), dev)
    out.valid[e] = True
    # bloom: one bit per key in its bucket's word; a bucket holds at most
    # S keys, one per slot, so an [NB, S] array ORed over slots builds it
    bits = torch.from_numpy(hashing.bloom_bit_np(keys)).to(dev)
    per_slot = torch.zeros((nb, s), dtype=torch.int64, device=dev)
    per_slot.view(-1)[e] = torch.ones_like(bits) << bits
    bloom = per_slot[:, 0]
    for j in range(1, s):
        bloom = bloom | per_slot[:, j]
    out.bloom_hi = wrap_i32((bloom >> 32) & MASK32)
    out.bloom_lo = wrap_i32(bloom & MASK32)
    return out
