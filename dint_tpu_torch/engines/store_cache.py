"""The store's cache tier in PyTorch: a device-resident cache in front of a
host backing KVS (the port of `dint_tpu.engines.store_cache`; its
docstring has the reference's kernel/user split it models).

A fixed-size single-hash S-way cache answers hits on the device. One
`cache_step` certifies a batch against the cache and emits a miss vector;
the host (`shim.host_kvs.CachedStore`) resolves the misses and queues
refill records, which `refill` installs at the start of the next round,
returning the evicted dirty records for the host to write back.

Three policies, as the reference's ablation servers:

    WB_BLOOM    write-back, GETs of keys the bucket's bloom word rules out
                answer NOT_EXIST on the device (store_kern.c)
    WB_NOBLOOM  write-back, every absent key misses (store_wb_kern.c)
    WT          write-through: GETs served from the cache, a SET drops the
                cached slot and goes to the host (store_wt_kern.c:115-151)

Per key segment, GETs see the pre-batch cache and writes apply in lane
order (the store step's contract). If any lane of a key segment misses,
the whole segment is deferred to the host (reply MISS); INSERT, DELETE and
SCAN lanes always defer.

What differs from JAX:

* The cache is updated in place (`cache_step` and `refill` still return
  it), and its victim rotor ``clock`` is a host int, not a device scalar.
* JAX's ``mode="drop"`` scatters route masked lanes out of range. The
  port keeps the lanes that write an entry, with one ``nonzero`` (a host
  sync) in each call: in `cache_step` the invalidated and the written-back
  entries share it (they are distinct entries; an invalidated lane writes
  its val and ver back), in `refill` the one lane a bucket that may
  install, whose record-less lanes write the entry back and set only the
  bloom word.
* With the hot tier the val/ver reads are the two streams of one
  `gather_rows_hot` launch, and the write-back and refill installs each
  the two streams of one `scatter_rows_hot` launch (the kernels on a CUDA
  tensor); JAX's refill takes its XLA form there, with the same output.
  There is no ``use_pallas`` argument.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import resolve_device
from ..ops import hashing, segments
from ..ops.row_kernels import gather_rows_hot, scatter_rows_hot
from ..ops.u32 import MASK32
from ..tables import kv
from .store import _add_u32, _hot_idx
from .types import Batch, Op, Replies, Reply

I32 = torch.int32

WB_BLOOM = "wb_bloom"
WB_NOBLOOM = "wb_nobloom"
WT = "wt"
POLICIES = (WB_BLOOM, WB_NOBLOOM, WT)

# reply code of lanes deferred to the host (the host overwrites it)
MISS = 100


@dataclass
class CacheTable:
    """The device cache: a `kv.KVTable` of NB buckets x S slots, a dirty
    flag per entry and the victim rotor. ``hot_val``/``hot_ver`` (None =
    off) are the hot tier inside the cache: a key-indexed write-through
    mirror of the val/ver of keys (0, k) with k < hot_n, kept at the
    write-back and refill installs. Mirror rows of keys not cached are
    stale by design; every reader of them is masked by the probe's hit.
    The mirrors are tensors of their own, never views of the table."""
    kv: kv.KVTable
    dirty: torch.Tensor                    # bool [NB*S]
    clock: int = 0                         # u32 victim rotor
    hot_val: torch.Tensor | None = None    # i32 [hot_n * VW]
    hot_ver: torch.Tensor | None = None    # i32 [hot_n]

    @property
    def hot_n(self) -> int:
        return 0 if self.hot_ver is None else self.hot_ver.shape[0]


def create(n_buckets: int, slots: int = 4, val_words: int = 10,
           hot_keys: int = 0, device=None) -> CacheTable:
    """An empty cache on ``device`` (None = CUDA); ``hot_keys`` > 0
    attaches the hot mirror of key ids [0, hot_keys), empty like the
    cache."""
    dev = resolve_device(device)

    def z(n):
        return torch.zeros(n, dtype=I32, device=dev)

    return CacheTable(kv=kv.create(n_buckets, slots, val_words, device=dev),
                      dirty=torch.zeros(n_buckets * slots, dtype=torch.bool,
                                        device=dev),
                      hot_val=z(hot_keys * val_words) if hot_keys else None,
                      hot_ver=z(hot_keys) if hot_keys else None)


def _probe1_loc(t: kv.KVTable, key_hi, key_lo, bkt):
    """Single-hash location probe: (hit, slot, entry), slot the first
    match (0 when there is none)."""
    rows = kv.bucket_rows(t, bkt)
    match = (t.valid[rows] & (t.key_hi[rows] == key_hi[:, None])
             & (t.key_lo[rows] == key_lo[:, None]))
    slot = torch.argmax(match.to(I32), -1).to(I32)
    return match.any(-1), slot, bkt * t.slots + slot


def _probe1(t: kv.KVTable, key_hi, key_lo, bkt):
    """`_probe1_loc` plus the entry's val [R, VW] and ver."""
    hit, slot, eidx = _probe1_loc(t, key_hi, key_lo, bkt)
    return hit, slot, kv.entry_val(t, eidx), t.ver[eidx.long()]


def cache_step(cache: CacheTable, batch: Batch, *, policy: str = WB_BLOOM):
    """Certify a batch against the cache. Returns (cache, replies, miss,
    flush):

    * miss: bool [R], the lanes the host must resolve (whole key segments;
      their replies carry rtype MISS);
    * flush: {mask, key_hi, key_lo, val, ver} in the step's sorted lane
      order, the dirty cached records of deferred segments, invalidated
      here. The host must write the masked lanes back before it resolves
      the miss lanes; the other lanes are don't-cares."""
    assert policy in POLICIES
    r = batch.width
    t = cache.kv
    s, vw = t.slots, t.val_words
    dev = batch.op.device
    sb = segments.sort_batch(batch.key_hi, batch.key_lo)
    op = batch.op[sb.perm]
    val_in = batch.val[sb.perm]

    bkt = hashing.bucket(sb.key_hi, sb.key_lo, t.n_buckets)
    hn = cache.hot_n
    if hn:
        # the hot partition: hot keys' val/ver from the mirror
        hit0, slot0, eidx0 = _probe1_loc(t, sb.key_hi, sb.key_lo, bkt)
        kmidx = _hot_idx(sb.key_hi, sb.key_lo, hn)
        # val and ver of the same lanes as the two streams of one launch
        val0, ver0 = gather_rows_hot((t.val, t.ver),
                                     (cache.hot_val, cache.hot_ver),
                                     (eidx0, eidx0), (kmidx, kmidx), (vw, 1))
        val0 = val0.view(r, vw)
    else:
        hit0, slot0, val0, ver0 = _probe1(t, sb.key_hi, sb.key_lo, bkt)

    is_get = op == Op.GET
    is_set = op == Op.SET
    used = op != Op.NOP
    none = torch.zeros(r, dtype=torch.bool, device=dev)
    absent = (~kv.bloom_maybe(t, sb.key_hi, sb.key_lo, bkt, bkt)
              if policy == WB_BLOOM else none)

    # lanes the cache alone can serve; everything else (INSERT, DELETE,
    # SCAN, misses) defers, and one deferred lane defers its whole segment
    local = is_get & (hit0 | absent)
    if policy != WT:
        local = local | (is_set & hit0)
    seg_miss = segments.seg_any(sb, used & ~local)
    miss = used & seg_miss

    # ---- cache-local semantics on fully-hit segments ----------------------
    n_set_before = segments.seg_cumsum_excl(sb, is_set.to(I32))
    n_set_total = segments.seg_sum(sb, is_set.to(I32))
    last_s = segments.seg_max_where(sb, is_set, sb.rank, -1)
    pos_last = torch.clamp(sb.head_pos + last_s, 0, r - 1).long()

    served = is_get & hit0 & ~miss
    rtype = torch.full((r,), Reply.NONE, dtype=I32, device=dev)
    rtype = torch.where(is_get & hit0, Reply.VAL, rtype)
    rtype = torch.where(is_get & absent & ~hit0, Reply.NOT_EXIST, rtype)
    rtype = torch.where(is_set, Reply.ACK, rtype)
    rtype = torch.where(miss, MISS, rtype)
    rval = torch.where(served[:, None], val0, 0)
    rver = torch.where(served, ver0, 0)
    rver = torch.where(is_set & ~miss, _add_u32(ver0, n_set_before + 1),
                       rver)

    # ---- mutations ---------------------------------------------------------
    # 1. a deferred segment drops its cached copy, flushing it when dirty,
    #    so that the host resolves it against fresh backing data (this is
    #    also the write-through SET invalidate)
    e0 = bkt * s + slot0
    inval = sb.last & seg_miss & hit0
    flush = {"mask": inval & cache.dirty[e0.long()],
             "key_hi": sb.key_hi, "key_lo": sb.key_lo, "val": val0,
             "ver": ver0}
    # 2. write-back: the last lane of a fully local segment installs its
    #    last SET's value and marks the entry dirty
    writer = (sb.last & ~seg_miss & (last_s >= 0) & hit0
              if policy != WT else none)
    keep = torch.nonzero(inval | writer).squeeze(1)   # the one host sync
    e = e0[keep].long()
    wk = writer[keep]
    t.valid[e] = wk             # a writer's entry is valid: it hit
    cache.dirty[e] = wk
    if policy != WT:
        new_ver = _add_u32(ver0, n_set_total)
        new_val = val_in[pos_last]
        if hn:
            # write-through to the mirror: one writer per key segment, so
            # distinct entries and distinct key ids
            w_midx = torch.where(writer & (kmidx >= 0), kmidx, -1)
            scatter_rows_hot((t.val, t.ver), (cache.hot_val, cache.hot_ver),
                             (e0, e0), (w_midx, w_midx), (writer, writer),
                             (new_val.reshape(-1), new_ver), (vw, 1))
        else:
            val2d = t.val.view(-1, vw)
            val2d[e] = torch.where(wk[:, None], new_val[keep], val2d[e])
            t.ver[e] = torch.where(wk, new_ver[keep], t.ver[e])

    o_rtype, o_rver, o_miss = segments.unsort(sb, rtype, rver, miss)
    o_rval = segments.unsort(sb, rval)
    return (cache, Replies(rtype=o_rtype.to(I32), val=o_rval, ver=o_rver),
            o_miss, flush)


def refill(cache: CacheTable, key_hi, key_lo, val, ver, bloom_hi, bloom_lo,
           mask):
    """Install host-fetched records and set each touched bucket's bloom
    word (the reference's TC-egress install, store_kern.c:302-372).

    ``mask`` bool [R] marks the lanes that carry a record; ``ver`` == 0
    means no record, only the bloom word (a refresh after DELETE or for an
    absent key). One install a bucket: only the first lane of each bucket
    counts, masked or not. Victim: the key's own slot, else the first
    invalid slot, else the rotor ``(clock + lane) % S``. Returns (cache,
    evicted), evicted = {mask, key_hi, key_lo, val, ver} of the dirty
    records the installs displaced, for the host to write back."""
    t = cache.kv
    s, vw = t.slots, t.val_words
    r = key_hi.shape[0]
    dev = key_hi.device
    bkt = hashing.bucket(key_hi, key_lo, t.n_buckets)
    sb = segments.sort_batch(torch.zeros_like(bkt), bkt)
    keep = segments.unsort(sb, mask[sb.perm] & sb.head)
    has_rec = keep & (ver != 0)

    hit, slot_h, _ = _probe1_loc(t, key_hi, key_lo, bkt)
    rows_valid = t.valid[kv.bucket_rows(t, bkt)]
    free_any = (~rows_valid).any(-1)
    first_free = torch.argmax((~rows_valid).to(I32), -1).to(I32)
    # the u32 rotor, widened: (clock + lane) wraps mod 2^32 before % S
    rotor = (((cache.clock + torch.arange(r, device=dev)) & MASK32)
             % s).to(I32)
    victim = torch.where(hit, slot_h, torch.where(free_any, first_free,
                                                  rotor))
    e_vic = bkt * s + victim
    ev = e_vic.long()
    evicted = {"mask": has_rec & ~hit & ~free_any & cache.dirty[ev],
               "key_hi": t.key_hi[ev], "key_lo": t.key_lo[ev],
               "val": kv.entry_val(t, e_vic), "ver": t.ver[ev]}

    k = torch.nonzero(keep).squeeze(1)     # the one host sync
    e = ev[k]
    hr = has_rec[k]
    if cache.hot_n:
        # write-through to the mirror; one install a bucket and host-deduped
        # keys keep both index sets unique
        midx = _hot_idx(key_hi, key_lo, cache.hot_n, has_rec)
        scatter_rows_hot((t.val, t.ver), (cache.hot_val, cache.hot_ver),
                         (e_vic, e_vic), (midx, midx), (has_rec, has_rec),
                         (val.reshape(-1), ver), (vw, 1))
    else:
        val2d = t.val.view(-1, vw)
        val2d[e] = torch.where(hr[:, None], val[k], val2d[e])
        t.ver[e] = torch.where(hr, ver[k], t.ver[e])
    t.key_hi[e] = torch.where(hr, key_hi[k], t.key_hi[e])
    t.key_lo[e] = torch.where(hr, key_lo[k], t.key_lo[e])
    t.valid[e] = hr | t.valid[e]
    cache.dirty[e] = ~hr & cache.dirty[e]
    b = bkt[k].long()
    t.bloom_hi[b] = bloom_hi[k]
    t.bloom_lo[b] = bloom_lo[k]
    cache.clock = (cache.clock + 1) & MASK32
    return cache, evicted
