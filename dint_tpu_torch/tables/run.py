"""Ordered run: a dense key-sorted snapshot of the store plus a small
write-through delta overlay, the source of range scans (the port of
`dint_tpu.tables.run`; its docstring has the design).

* run: the table's live records sorted by key, flat like the table
  (key_hi/key_lo/ver [cap], val [cap*VW]); rows past `n` hold the PAD key
  0xFFFFFFFF:FFFFFFFF, so binary search needs no bounds.
* delta overlay: the writes since the snapshot, key-sorted, one entry per
  key (latest wins), tombstones for deletes. Scans merge run ∪ delta.
* `refresh` folds the overlay back at block ends (`rebuild_run`), or
  re-snapshots from the table (`from_table`) when the overlay overflowed
  (`stale`): a stale run answers no scans until then.

What differs from JAX:

* Multi-key sorts are stable `torch.sort`s of one int64 key whose signed
  order is the unsigned u64 order (`u64.sort_key`), chained minor key
  first where the key does not fit 64 bits: `delta_append` sorts by
  ``~seq`` (widened, so descending unsigned) and then by key. JAX's
  ``pref`` key in `rebuild_run` and its ``iota`` tie-breakers are the
  arrival order that a stable sort keeps.
* `_compact` returns the take index, and callers gather each leaf once
  from its source through the composed index (one gather of the 2.68 GB
  val array at 24M keys, not two).
* `merge_scan` sorts each lane's candidates once, by key with the rows
  that do not qualify moved last (int64 maximum, a key no live row has):
  the first ``count`` rows, all that a reply keeps, are those of JAX's
  ``(bad, hi, lo, iota)`` sort.
* `refresh` branches on a host read of ``stale``: one sync per call.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..device import resolve_device
from ..ops import u64
from ..ops.u32 import to_numpy, to_u64, wrap_i32
from . import kv

I32 = torch.int32
PAD_W = -1                    # 0xFFFFFFFF as an int32 bit pattern
INT64_MAX = torch.iinfo(torch.int64).max


@dataclass
class OrderedRun:
    # dense sorted snapshot (rows >= n hold the PAD key, zero ver/val)
    key_hi: torch.Tensor      # i32 [cap]
    key_lo: torch.Tensor      # i32 [cap]
    ver: torch.Tensor         # i32 [cap]
    val: torch.Tensor         # i32 [cap*VW] interleaved
    n: torch.Tensor           # i32 [] live rows
    # key-sorted delta overlay (rows >= d_n hold the PAD key)
    d_key_hi: torch.Tensor    # i32 [dcap]
    d_key_lo: torch.Tensor    # i32 [dcap]
    d_ver: torch.Tensor       # i32 [dcap]
    d_val: torch.Tensor       # i32 [dcap*VW]
    d_tomb: torch.Tensor      # bool [dcap]: key deleted since the snapshot
    d_seq: torch.Tensor       # i32 [dcap] u32 arrival stamp (latest wins)
    d_n: torch.Tensor         # i32 [] live overlay entries
    d_seq_next: torch.Tensor  # i32 [] u32 next arrival stamp
    stale: torch.Tensor       # bool []: the overlay overflowed
    delta_cap: int = 64
    val_words: int = 10

    @property
    def cap(self) -> int:
        return self.key_hi.shape[0]


def _empty_delta(dcap: int, vw: int, dev) -> dict:
    def z(n, dt=I32):
        return torch.zeros(n, dtype=dt, device=dev)
    return dict(d_key_hi=torch.full((dcap,), PAD_W, dtype=I32, device=dev),
                d_key_lo=torch.full((dcap,), PAD_W, dtype=I32, device=dev),
                d_ver=z(dcap), d_val=z(dcap * vw), d_tomb=z(dcap, torch.bool),
                d_seq=z(dcap), d_n=z(()), d_seq_next=z(()),
                stale=z((), torch.bool), delta_cap=dcap, val_words=vw)


def create(cap: int, delta_cap: int = 64, val_words: int = 10,
           device=None) -> OrderedRun:
    """An empty run on ``device`` (None = CUDA)."""
    assert cap >= 1 and delta_cap >= 1
    dev = resolve_device(device)
    return OrderedRun(
        key_hi=torch.full((cap,), PAD_W, dtype=I32, device=dev),
        key_lo=torch.full((cap,), PAD_W, dtype=I32, device=dev),
        ver=torch.zeros(cap, dtype=I32, device=dev),
        val=torch.zeros(cap * val_words, dtype=I32, device=dev),
        n=torch.zeros((), dtype=I32, device=dev),
        **_empty_delta(delta_cap, val_words, dev))


def _head(s_hi, s_lo):
    """First row of each run of equal keys in key-sorted arrays."""
    head = torch.ones_like(s_hi, dtype=torch.bool)
    head[1:] = (s_hi[1:] != s_hi[:-1]) | (s_lo[1:] != s_lo[:-1])
    return head


def _not_pad(hi, lo):
    return (hi != PAD_W) | (lo != PAD_W)


def _compact(live: torch.Tensor, cap_out: int):
    """Stable-compact the ``live`` rows (already key-sorted) to the front
    of a cap_out-row layout: returns (take int64 [cap_out], ok bool
    [cap_out], n_live i32 []); row i of the result is source row take[i]
    where ok[i], PAD/zero otherwise."""
    perm = torch.sort((~live).to(torch.uint8), stable=True).indices
    n_live = live.sum(dtype=I32)
    ok = torch.arange(cap_out, dtype=I32, device=live.device) < n_live
    return perm[:cap_out], ok, n_live


def _rows(vals: torch.Tensor, vw: int, idx, ok) -> torch.Tensor:
    """Flat val words of rows ``idx`` of ``vals`` [*, vw], zero where not
    ``ok``."""
    out = vals.view(-1, vw)[idx]
    return out.masked_fill_(~ok[:, None], 0).reshape(-1)


def from_table(table: kv.KVTable, delta_cap: int = 64) -> OrderedRun:
    """Fresh snapshot: the table's live entries sorted into a dense run of
    cap = the table's entry count (so it can never overflow)."""
    vw = table.val_words
    hi = torch.where(table.valid, table.key_hi, PAD_W)
    lo = torch.where(table.valid, table.key_lo, PAD_W)
    perm = torch.sort(u64.sort_key(hi, lo), stable=True).indices
    take, ok, n_live = _compact(table.valid[perm], hi.shape[0])
    src = perm[take]
    return OrderedRun(
        key_hi=torch.where(ok, hi[src], PAD_W),
        key_lo=torch.where(ok, lo[src], PAD_W),
        ver=torch.where(ok, table.ver[src], 0),
        val=_rows(table.val, vw, src, ok), n=n_live,
        **_empty_delta(delta_cap, vw, hi.device))


def rebuild_run(run: OrderedRun) -> OrderedRun:
    """Merge-compact the delta overlay into the run (upserts replace or
    insert rows, tombstones remove them) and clear the overlay. A stale
    run cannot be repaired from its overlay; use `refresh`."""
    cap, dcap, vw = run.cap, run.delta_cap, run.val_words
    dev = run.key_hi.device
    d_live = torch.arange(dcap, dtype=I32, device=dev) < run.d_n
    hi = torch.cat([torch.where(d_live, run.d_key_hi, PAD_W), run.key_hi])
    lo = torch.cat([torch.where(d_live, run.d_key_lo, PAD_W), run.key_lo])
    # stable: an overlay row (first in the concatenation) heads its key
    # group, ahead of the run row of the same key
    perm = torch.sort(u64.sort_key(hi, lo), stable=True).indices
    s_hi, s_lo = hi[perm], lo[perm]
    tomb = torch.cat([run.d_tomb, torch.zeros(cap, dtype=torch.bool,
                                              device=dev)])[perm]
    live = _head(s_hi, s_lo) & _not_pad(s_hi, s_lo) & ~tomb
    take, ok, n_live = _compact(live, cap)
    src = perm[take]
    return OrderedRun(
        key_hi=torch.where(ok, hi[src], PAD_W),
        key_lo=torch.where(ok, lo[src], PAD_W),
        ver=torch.where(ok, torch.cat([run.d_ver, run.ver])[src], 0),
        val=_rows(torch.cat([run.d_val, run.val]), vw, src, ok),
        n=torch.clamp(n_live, max=cap), **_empty_delta(dcap, vw, dev))


def refresh(table: kv.KVTable, run: OrderedRun) -> OrderedRun:
    """The block-end entry point: merge-compact when the overlay is
    intact, re-snapshot from the table when it went stale (a host read of
    ``stale``: one sync)."""
    assert run.cap == table.key_hi.shape[0], \
        "refresh expects a from_table-sized run"
    if bool(run.stale):
        return from_table(table, run.delta_cap)
    return rebuild_run(run)


def delta_append(run: OrderedRun, key_hi, key_lo, ver, val, tomb,
                 mask) -> OrderedRun:
    """Write-through append of one batch's effective writes (at most one
    lane per key; ``val`` flat [r*VW]). Re-sorts the overlay by key with
    the latest write winning; overflow beyond delta_cap sets ``stale``."""
    dcap, vw = run.delta_cap, run.val_words
    dev = run.d_key_hi.device
    r = key_hi.shape[0]
    d_live = torch.arange(dcap, dtype=I32, device=dev) < run.d_n
    hi = torch.cat([torch.where(d_live, run.d_key_hi, PAD_W),
                    torch.where(mask, key_hi, PAD_W)])
    lo = torch.cat([torch.where(d_live, run.d_key_lo, PAD_W),
                    torch.where(mask, key_lo, PAD_W)])
    seq = torch.cat([run.d_seq, run.d_seq_next.expand(r)])
    # latest wins: order by (key, ~seq, arrival), minor key first
    p1 = torch.sort(0xFFFFFFFF - to_u64(seq), stable=True).indices
    perm = p1[torch.sort(u64.sort_key(hi, lo)[p1], stable=True).indices]
    s_hi, s_lo = hi[perm], lo[perm]
    live = _head(s_hi, s_lo) & _not_pad(s_hi, s_lo)
    take, ok, n_live = _compact(live, dcap)
    src = perm[take]
    return dataclasses.replace(
        run,
        d_key_hi=torch.where(ok, hi[src], PAD_W),
        d_key_lo=torch.where(ok, lo[src], PAD_W),
        d_ver=torch.where(ok, torch.cat([run.d_ver, ver])[src], 0),
        d_val=_rows(torch.cat([run.d_val, val]), vw, src, ok),
        d_tomb=ok & torch.cat([run.d_tomb, tomb])[src],
        d_seq=torch.where(ok, seq[src], 0),
        d_n=torch.clamp(n_live, max=dcap),
        d_seq_next=wrap_i32(to_u64(run.d_seq_next) + 1),
        stale=run.stale | (n_live > dcap))


def locate_bits(cap: int) -> int:
    """Binary-search depth over a cap-row run."""
    return max(1, int(cap).bit_length())


def locate(run: OrderedRun, q_hi, q_lo) -> torch.Tensor:
    """Lower bound: per lane, the first run offset whose key is >= the
    lane's start key (i32). Branchless binary search, `locate_bits(cap)`
    rounds of two word gathers a lane."""
    cap = run.cap
    q = u64.sort_key(q_hi, q_lo)
    pos = torch.zeros(q_hi.shape, dtype=I32, device=q_hi.device)
    for b in reversed(range(locate_bits(cap))):
        cand = pos + (1 << b)
        safe = (torch.clamp(cand, max=cap) - 1).long()
        less = u64.sort_key(run.key_hi[safe], run.key_lo[safe]) < q
        pos = torch.where((cand <= cap) & less, cand, pos)
    return pos


def _ge(hi, lo, q_hi, q_lo):
    k, q = u64.sort_key(hi, lo), u64.sort_key(q_hi, q_lo)
    return k >= (q if k.dim() == q.dim() else q[:, None])


def merge_scan(run: OrderedRun, slab_hi, slab_lo, slab_ver, slab_val,
               win_base, q_hi, q_lo, slen, scan_max: int):
    """Merge a gathered run window with the delta overlay into per-lane
    scan replies: the first ``slen`` live keys >= the start key of the
    merged view. slab_*: [r, LG(, vw)] run rows from ``win_base``.
    Returns (count i32 [r], hi/lo/ver [r, scan_max], val [r, scan_max,
    vw], delta_hits i32 [r]); rows past count are zero."""
    vw, dcap = run.val_words, run.delta_cap
    r, lg = slab_hi.shape
    dev = slab_hi.device
    d_live = torch.arange(dcap, dtype=I32, device=dev) < run.d_n
    slab_k = u64.sort_key(slab_hi, slab_lo)
    d_k = u64.sort_key(run.d_key_hi, run.d_key_lo)
    # run rows shadowed by any overlay entry of the same key: the flat
    # [r, LG, dcap] compare (the overlay is small)
    sh = ((slab_k[:, :, None] == d_k[None, None, :])
          & d_live[None, None, :]).any(-1)
    row_idx = win_base[:, None] + torch.arange(lg, dtype=I32, device=dev)
    run_ok = (row_idx < run.n) & ~sh & _ge(slab_hi, slab_lo, q_hi, q_lo)
    d_ok = ((d_live & ~run.d_tomb)[None, :]
            & _ge(run.d_key_hi.expand(r, dcap), run.d_key_lo.expand(r, dcap),
                  q_hi, q_lo))

    c_ok = torch.cat([run_ok, d_ok], 1)
    c_k = torch.cat([slab_k, d_k.expand(r, dcap)], 1)
    take = torch.sort(torch.where(c_ok, c_k, INT64_MAX), dim=1,
                      stable=True).indices[:, :scan_max]
    count = torch.minimum(slen.to(I32), c_ok.sum(1, dtype=I32))
    keep = (torch.arange(scan_max, dtype=I32, device=dev)[None, :]
            < count[:, None])
    from_d = take >= lg
    t_run = take.clamp(max=lg - 1)
    t_d = (take - lg).clamp(min=0)

    def pick(slab, d):
        got = torch.where(from_d, d[t_d], slab.gather(1, t_run))
        return torch.where(keep, got, 0)

    out_val = torch.where(
        from_d[:, :, None], run.d_val.view(dcap, vw)[t_d],
        slab_val.gather(1, t_run[:, :, None].expand(r, scan_max, vw)))
    out_val = torch.where(keep[:, :, None], out_val, 0)
    return (count, pick(slab_hi, run.d_key_hi), pick(slab_lo, run.d_key_lo),
            pick(slab_ver, run.d_ver), out_val,
            (keep & from_d).sum(1, dtype=I32))


# ------------------------------------------------------------- host side


def to_items(run: OrderedRun) -> dict:
    """Host-side merged view {key: (val tuple, ver)} for differential
    tests."""
    vw = run.val_words
    n, dn = int(run.n), int(run.d_n)
    out = {}
    keys = u64.join(to_numpy(run.key_hi)[:n], to_numpy(run.key_lo)[:n])
    val = to_numpy(run.val).reshape(-1, vw)[:n]
    ver = to_numpy(run.ver)[:n]
    for k, v, vr in zip(keys, val, ver):
        out[int(k)] = (tuple(int(x) for x in v), int(vr))
    d_keys = u64.join(to_numpy(run.d_key_hi)[:dn],
                      to_numpy(run.d_key_lo)[:dn])
    d_val = to_numpy(run.d_val).reshape(-1, vw)[:dn]
    d_ver = to_numpy(run.d_ver)[:dn]
    d_tomb = run.d_tomb.cpu().numpy()[:dn]
    for k, v, vr, t in zip(d_keys, d_val, d_ver, d_tomb):
        if t:
            out.pop(int(k), None)
        else:
            out[int(k)] = (tuple(int(x) for x in v), int(vr))
    return out
