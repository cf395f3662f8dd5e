"""The store engine in PyTorch: batched GET/SET/INSERT/DELETE over the
device-resident hash table, and range scans over the ordered run (the port
of `dint_tpu.engines.store`; its docstring has the serialization contract).

Per key, a batch runs all GETs and SCANs first (they see pre-batch
state), then the writes in lane order. SET/INSERT are upserts that bump
the version; DELETE invalidates; an insert that finds both candidate
buckets full answers SPILL and lands nowhere, neither in the table nor in
the run's overlay.

What differs from JAX:

* The table, the hot mirror and the run's overlay are updated in place
  (`step` still returns them, in JAX's order).
* JAX's masked installs route masked lanes out of range under
  ``mode="drop"``. The port keeps the JAX layout, with no padding entry,
  and keeps the lanes that write any slot (one ``nonzero``, one host sync
  a step); the lanes among them that only delete write the current key,
  val and ver back, so the five installs share that one filter. With
  ``maintain_bloom``, the bloom words take two more.
* The port always takes JAX's ``use_pallas`` route: the scan window runs
  the `scan_rows` kernel, and with ``hot`` the val/ver reads run as the
  two streams of one `gather_rows_hot` launch and the installs the two
  streams of one `scatter_rows_hot` launch.
* `build_serve_runner` takes the cohort draws from outside the step, and
  its ``use_scan`` is a plain boolean (JAX reads DINT_USE_SCAN for None).
  The block-end `refresh` reads ``stale`` on the host: one sync a block.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..clients import workloads as wl
from ..device import resolve_device
from ..monitor import counters as mon
from ..monitor import waves
from ..ops import hashing, segments
from ..ops.row_kernels import gather_rows_hot, scatter_rows_hot
from ..ops.scan_kernels import scan_slab
from ..ops.u32 import to_u64, wrap_i32
from ..tables import kv
from ..tables import run as run_mod
from .types import Batch, Op, Replies, Reply, ScanReplies

I32 = torch.int32
STORE_MAGIC = 0x55AA   # val word 1 of populated rows (clients/micro.py)


@dataclass
class HotKV:
    """The hot tier: a key-indexed write-through mirror of the val/ver of
    keys (0, k) with k < hot_n. Mirror entries of absent keys are stale by
    design; every reader of them is masked by the probe's hit."""
    val: torch.Tensor    # i32 [hot_n * VW]
    ver: torch.Tensor    # i32 [hot_n]

    @property
    def hot_n(self) -> int:
        return self.ver.shape[0]


def attach_hot(table: kv.KVTable, hot_n: int) -> HotKV:
    """The hot mirror of key ids [0, hot_n), built by one probe of the
    table: fresh tensors, never views of the table's."""
    hot_n = max(int(hot_n), 1)
    dev = table.key_hi.device
    klo = torch.arange(hot_n, dtype=I32, device=dev)
    khi = torch.zeros(hot_n, dtype=I32, device=dev)
    b1, b2 = hashing.bucket_pair(khi, klo, table.n_buckets)
    hit, _, _, val, ver, _, _ = kv.probe(table, khi, klo, b1, b2)
    return HotKV(val=torch.where(hit[:, None], val, 0).reshape(-1),
                 ver=torch.where(hit, ver, 0))


def _add_u32(a: torch.Tensor, b) -> torch.Tensor:
    return wrap_i32(to_u64(a) + b)


def _hot_idx(khi, klo, hot_n: int, mask=None):
    """Mirror index of each lane's key (its key id) where it is hot, -1
    elsewhere."""
    hot = (khi == 0) & (to_u64(klo) < hot_n)
    if mask is not None:
        hot = hot & mask
    return torch.where(hot, klo, -1)


def step(table: kv.KVTable, batch: Batch, *, maintain_bloom: bool = False,
         hot: HotKV | None = None, run: run_mod.OrderedRun | None = None,
         scan_max: int = 8):
    """One server step: certify and apply a batch. Returns (table,
    replies), plus ``hot`` when the hot tier is threaded, plus (run,
    scan_replies) when the ordered run is: (table, replies[, hot][, run,
    scan_replies]).

    ``maintain_bloom`` keeps the per-bucket bloom words exact. ``hot``
    serves hot keys' val/ver from the mirror and writes installs through
    to it (outputs identical to the plain route). ``run`` serves Op.SCAN
    lanes from the merged run ∪ delta view as of before the batch (VAL +
    the row count in ``ver``, RETRY when the run is stale; at most
    ``scan_max`` rows, the requested count in ``batch.ver``) and writes
    the batch's effective installs and deletes through to the overlay."""
    r = batch.width
    dev = batch.op.device
    s, vw = table.slots, table.val_words
    sb = segments.sort_batch(batch.key_hi, batch.key_lo)
    op = batch.op[sb.perm]
    val_in = batch.val[sb.perm]

    b1, b2 = hashing.bucket_pair(sb.key_hi, sb.key_lo, table.n_buckets)
    with waves.scope("store", "probe"):
        if hot is None:
            hit0, fbkt, slot0, val0, ver0, free1, free2 = kv.probe(
                table, sb.key_hi, sb.key_lo, b1, b2)
        else:
            hit0, fbkt, slot0, free1, free2 = kv.probe_loc(
                table, sb.key_hi, sb.key_lo, b1, b2)
            eidx0 = fbkt * s + slot0
            kmidx = _hot_idx(sb.key_hi, sb.key_lo, hot.hot_n)
            # val and ver of the same lanes as the two streams of one launch
            val0, ver0 = gather_rows_hot((table.val, table.ver),
                                         (hot.val, hot.ver), (eidx0, eidx0),
                                         (kmidx, kmidx), (vw, 1))
            val0 = val0.view(r, vw)
    # insert destination: the emptier of the two candidate buckets
    dest = torch.where(free2 > free1, b2, b1)
    bkt = torch.where(hit0, fbkt, dest)
    alt = torch.where(hit0, fbkt, b1 + b2 - dest)   # the other candidate

    is_get = op == Op.GET
    is_install = (op == Op.SET) | (op == Op.INSERT)
    is_delete = op == Op.DELETE
    is_write = is_install | is_delete

    n_inst_before = segments.seg_cumsum_excl(sb, is_install.to(I32))
    n_inst_total = segments.seg_sum(sb, is_install.to(I32))
    last_w_rank = segments.seg_max_where(sb, is_write, sb.rank, -1)
    pos_last = torch.clamp(sb.head_pos + last_w_rank, 0, r - 1).long()
    last_is_del = is_delete[pos_last]
    last_val = val_in[pos_last]

    ver0_eff = torch.where(hit0, ver0, 0)
    any_write = last_w_rank >= 0
    final_exists = torch.where(any_write, ~last_is_del, hit0)
    final_ver = _add_u32(ver0_eff, n_inst_total)

    # ---- replies (sorted space) -------------------------------------------
    # exact existence at each write: the latest earlier write of the
    # segment decides, else the pre-batch state
    idx = torch.arange(r, dtype=I32, device=dev)
    w_pos = torch.cummax(torch.where(is_write, idx, -1), 0).values
    prev_w_pos = torch.cat([w_pos.new_full((1,), -1), w_pos[:-1]])
    in_seg = prev_w_pos >= sb.head_pos
    existed_here = torch.where(
        in_seg, is_install[torch.clamp(prev_w_pos, 0, r - 1).long()], hit0)
    rtype = torch.full((r,), Reply.NONE, dtype=I32, device=dev)
    rtype = torch.where(is_get, torch.where(hit0, Reply.VAL, Reply.NOT_EXIST),
                        rtype)
    rtype = torch.where(is_install, Reply.ACK, rtype)
    rtype = torch.where(is_delete, torch.where(existed_here, Reply.ACK,
                                               Reply.NOT_EXIST), rtype)
    rval = torch.where((is_get & hit0)[:, None], val0, 0)
    rver = torch.where(is_get & hit0, ver0, 0)
    rver = torch.where(is_install, _add_u32(ver0_eff, n_inst_before + 1),
                       rver)

    # ---- writer election: the segment's last lane acts for its key -------
    writer = sb.last & any_write
    w_upd = writer & final_exists & hit0
    w_alloc = writer & final_exists & ~hit0
    w_del = writer & ~final_exists & hit0

    o_upd, o_alloc, o_del, o_bkt, o_alt, o_slot0, o_ver = segments.unsort(
        sb, w_upd, w_alloc, w_del, bkt, alt, slot0, final_ver)
    o_val = segments.unsort(sb, last_val)
    o_khi, o_klo = segments.unsort(sb, sb.key_hi, sb.key_lo)
    zeros = torch.zeros(r, dtype=I32, device=dev)

    # ---- phase B: slot allocation for inserts, per destination bucket ----
    sb2 = segments.sort_batch(zeros, o_bkt)
    alloc2 = o_alloc[sb2.perm]
    rank_alloc = segments.seg_cumsum_excl(sb2, alloc2.to(I32))
    bkt2 = o_bkt[sb2.perm]
    has2, slot_new2 = kv.nth_free_slot(
        table.valid[kv.bucket_rows(table, bkt2)], rank_alloc)
    ok, spill1, slot_new = segments.unsort(sb2, alloc2 & has2,
                                           alloc2 & ~has2, slot_new2)

    # ---- phase B2: an overflow retries its alternate candidate bucket,
    # skipping the slots phase B handed out there
    nb = table.n_buckets
    taken = torch.zeros(nb + 1, dtype=I32, device=dev).index_add_(
        0, torch.where(ok, o_bkt, nb).long(), torch.ones_like(o_bkt))
    sb3 = segments.sort_batch(zeros, o_alt)
    retry3 = spill1[sb3.perm]
    alt3 = o_alt[sb3.perm]
    rank3 = (segments.seg_cumsum_excl(sb3, retry3.to(I32))
             + taken[alt3.long()])
    has3, slot_new3 = kv.nth_free_slot(
        table.valid[kv.bucket_rows(table, alt3)], rank3)
    ok_alt, slot_alt = segments.unsort(sb3, retry3 & has3, slot_new3)
    spill = spill1 & ~ok_alt
    ok = ok | ok_alt
    o_bkt = torch.where(ok_alt, o_alt, o_bkt)
    slot_new = torch.where(ok_alt, slot_alt, slot_new)

    # a spill fails every install of its key: installs -> SPILL, deletes
    # -> NOT_EXIST; GETs already answered from the pre-batch state
    seg_spill = segments.seg_any(sb, spill[sb.perm])
    rtype = torch.where(seg_spill & is_install, Reply.SPILL, rtype)
    rtype = torch.where(seg_spill & is_delete, Reply.NOT_EXIST, rtype)
    rver = torch.where(seg_spill & is_install, 0, rver)

    # ---- installs: one writer per entry ----------------------------------
    with waves.scope("store", "install"):
        w_any = o_upd | ok | o_del
        wv = o_upd | ok
        e_all = o_bkt * s + torch.where(o_upd | o_del, o_slot0, slot_new)
        keep = torch.nonzero(w_any).squeeze(1)   # the step's one host sync
        e = e_all[keep].long()
        wv_k = wv[keep]
        table.valid[e] = ~o_del[keep]
        if hot is None:
            val2d = table.val.view(-1, vw)
            val2d[e] = torch.where(wv_k[:, None], o_val[keep], val2d[e])
            table.ver[e] = torch.where(wv_k, o_ver[keep], table.ver[e])
        else:
            # write-through: table entry and key-indexed mirror. A deleting
            # lane's e_all is its own slot, so the mask alone filters it
            w_midx = _hot_idx(o_khi, o_klo, hot.hot_n, wv)
            scatter_rows_hot((table.val, table.ver), (hot.val, hot.ver),
                             (e_all, e_all), (w_midx, w_midx), (wv, wv),
                             (o_val.reshape(-1), o_ver), (vw, 1))
        table.key_hi[e] = torch.where(wv_k, o_khi[keep], table.key_hi[e])
        table.key_lo[e] = torch.where(wv_k, o_klo[keep], table.key_lo[e])
    if maintain_bloom:
        kv.recompute_bloom(table, o_bkt, ok | o_del)

    o_rtype, o_rver = segments.unsort(sb, rtype, rver)
    o_rval = segments.unsort(sb, rval)

    # ---- scans, answered from the pre-batch run ∪ delta view, then this
    # batch's effective writes (the lanes installed above) go to the
    # overlay, keeping run ∪ delta == table
    scan_rep = None
    if run is not None:
        ne = table.key_hi.shape[0]
        assert run.cap == ne and run.val_words == vw, \
            "run must be from_table-shaped for this table"
        lg_win = scan_max + run.delta_cap
        assert ne >= lg_win, "table too small for scan_max + delta_cap"
        is_scan = batch.op == Op.SCAN
        with waves.scope("store", "scan_locate"):
            off = run_mod.locate(run, batch.key_hi, batch.key_lo)
        # clamped so every window is in bounds: clamping only moves a
        # window's start down, and the >= start check filters rows below
        off_c = torch.clamp(off, 0, ne - lg_win)
        with waves.scope("store", "scan"):
            s_hi, s_lo, s_ver, s_val = scan_slab(
                run.key_hi, run.key_lo, run.ver, run.val, off_c, lg_win, vw)
            # a stale overlay may miss writes: no rows, reply RETRY
            slen = torch.where(is_scan & ~run.stale,
                               torch.clamp(batch.ver, 0, scan_max), 0)
            count, k_hi, k_lo, k_ver, k_val, d_hits = run_mod.merge_scan(
                run, s_hi, s_lo, s_ver, s_val, off_c, batch.key_hi,
                batch.key_lo, slen, scan_max)
        scan_rep = ScanReplies(key_hi=k_hi, key_lo=k_lo, ver=k_ver,
                               val=k_val, count=count, delta_hits=d_hits)
        o_rtype = torch.where(is_scan, torch.where(run.stale, Reply.RETRY,
                                                   Reply.VAL), o_rtype)
        o_rver = torch.where(is_scan, count, o_rver)
        o_rval = torch.where(is_scan[:, None], 0, o_rval)
        with waves.scope("store", "delta_append"):
            run = run_mod.delta_append(run, o_khi, o_klo, o_ver,
                                       o_val.reshape(-1), o_del, w_any)

    out = (table, Replies(rtype=o_rtype.to(I32), val=o_rval, ver=o_rver))
    if hot is not None:
        out = out + (hot,)
    if run is not None:
        out = out + (run, scan_rep)
    return out


def rebuild_run(table: kv.KVTable, run: run_mod.OrderedRun):
    """Block-end run maintenance: merge-compact the overlay into the run,
    or re-snapshot from the table when the overlay went stale."""
    with waves.scope("store", "run_rebuild"):
        return run_mod.refresh(table, run)


# ------------------------------------------------------------- serve plane


def draw_block(gen: torch.Generator, cpb: int, w: int, n_keys: int,
               hot_n: int, max_scan_len: int, device):
    """One block's cohort draws with ``gen`` on ``device``: (u_scan,
    u_get, u_hot f32 [cpb, w]; k_hot, k_cold, slen i32 [cpb, w]), the six
    arrays the JAX runner draws per cohort (store.py:390-408)."""
    def uni():
        return torch.rand((cpb, w), generator=gen, device=device)

    def ints(lo, hi):
        return torch.randint(lo, hi, (cpb, w), generator=gen, device=device,
                             dtype=I32)
    return (uni(), uni(), uni(), ints(1, hot_n + 1), ints(1, n_keys + 1),
            ints(1, max_scan_len + 1))


def build_serve_runner(n_keys: int, w: int = 4096,
                       cohorts_per_block: int = 8, val_words: int = 10,
                       read_frac: float = 0.5, scan_frac: float = 0.0,
                       max_scan_len: int = 8, scan_max: int = 8,
                       delta_cap: int | None = None,
                       hot_frac: float | None = None,
                       hot_prob: float | None = None,
                       use_scan: bool = False, monitor: bool = False,
                       serve: bool = False, device=None):
    """The store's serve-plane runner, a loop of `step` over carry
    (table[, run][, counters]); returns (run, init, drain) as JAX does:

    * ``run(carry, gen[, occ, shed])`` draws a block's cohorts with the
      torch generator ``gen`` (`draw_block`) and calls ``run.run_draws``;
    * ``run.run_draws(carry, draws[, occ, shed])`` runs
      ``cohorts_per_block`` steps on the six draw arrays as given, then
      the block-end run refresh; returns (carry, stats i32 [cpb, 2]) with
      rows (attempted, committed);
    * ``init(db)`` -> carry (with ``use_scan``, the run of `from_table`);
    * ``drain(carry)`` -> (table, zeros [1, 2][, counters]): nothing is
      in flight, and the run is dropped.

    Cohorts are YCSB-E-shaped: ``scan_frac`` of the lanes scan, lengths
    uniform in [1, max_scan_len] (the engine clips to ``scan_max``); the
    rest split ``read_frac`` GET, else SET, over keys with the hot-prefix
    skew. Committed counts VAL and ACK replies; a stale scan's RETRY is
    not committed. ``use_scan`` off: no SCAN lane and no run. ``serve``:
    ``occ``/``shed`` device i32 [cpb]; lanes >= occ are NOP on PAD.
    ``monitor``: the carry gains a trailing `Counters`."""
    dev = resolve_device(device)
    cpb = cohorts_per_block
    hfrac = wl.SB_HOT_FRAC if hot_frac is None else float(hot_frac)
    hprob = wl.SB_HOT_PROB if hot_prob is None else float(hot_prob)
    hot_n = max(1, min(int(n_keys * hfrac), n_keys))
    if not use_scan:
        scan_frac = 0.0
    lane = torch.arange(w, dtype=I32, device=dev)
    full = torch.full((), w, dtype=I32, device=dev)

    def gen_cohort(draws, occ):
        """One cohort: (Batch, admitted, scan lanes)."""
        u_scan, u_get, u_hot, k_hot, k_cold, slen = draws
        admitted = lane < occ
        if scan_frac > 0.0:
            is_scan = u_scan < scan_frac          # in f32, as JAX compares
        else:
            is_scan = torch.zeros(w, dtype=torch.bool, device=dev)
        is_get = ~is_scan & (u_get < read_frac)
        klo = torch.where(u_hot < hprob, k_hot, k_cold)
        op = torch.where(is_scan, Op.SCAN,
                         torch.where(is_get, Op.GET, Op.SET)).to(I32)
        op = torch.where(admitted, op, Op.NOP)
        klo = torch.where(admitted, klo, -1)
        khi = torch.where(admitted, 0, lane.new_full((), -1))
        val = torch.zeros((w, val_words), dtype=I32, device=dev)
        val[:, 0] = klo
        val[:, 1].fill_(STORE_MAGIC)   # no scalar tensor, no item() read
        ver = torch.where(admitted & is_scan, slen, 0)
        batch = Batch(op=op, table=torch.zeros_like(op), key_hi=khi,
                      key_lo=klo, val=val, ver=ver)
        return batch, admitted, admitted & is_scan

    def one_step(carry, draws, occ, shed):
        table = carry[0]
        cnt = carry[-1] if monitor else None
        batch, admitted, scan_lanes = gen_cohort(draws, occ)
        if use_scan:
            table, rep, run_, srep = step(table, batch, run=carry[1],
                                          scan_max=scan_max)
        else:
            table, rep = step(table, batch)
        committed = (admitted & ((rep.rtype == Reply.VAL)
                                 | (rep.rtype == Reply.ACK))).sum(dtype=I32)
        mon.bump(cnt, {
            mon.CTR_STEPS: 1,
            mon.CTR_SERVE_OCC_LANES: occ,
            mon.CTR_SERVE_PAD_LANES: w - occ,
            mon.CTR_SERVE_SHED_LANES: shed,
            mon.CTR_DISPATCH_PALLAS: 1,     # the port runs the kernel route
            **({mon.CTR_SCAN_REQUESTS: scan_lanes.sum(dtype=I32),
                mon.CTR_SCAN_ROWS: srep.count.sum(dtype=I32),
                mon.CTR_SCAN_DELTA_HITS: srep.delta_hits.sum(dtype=I32)}
               if use_scan else {}),
        })
        out = (table,) + ((run_,) if use_scan else ()) \
            + ((cnt,) if monitor else ())
        return out, torch.stack([occ.to(I32), committed])

    def run_draws(carry, draws, occ=None, shed=None):
        draws = tuple(draws)
        if len(draws) != 6 or any(tuple(d.shape) != (cpb, w) for d in draws):
            raise ValueError(f"expected six draw arrays [{cpb}, {w}]")
        if serve != (occ is not None and shed is not None):
            raise ValueError("a serve runner takes occ and shed [cpb]; a "
                             "closed-loop runner takes neither")
        stats = []
        for i in range(cpb):
            o, sh = (occ[i], shed[i]) if serve else (full, 0)
            carry, s = one_step(carry, [d[i] for d in draws], o, sh)
            stats.append(s)
        if use_scan:
            # block end: fold the overlay back so the next block's scans
            # start from a fresh view
            carry = (carry[0], rebuild_run(carry[0], carry[1])) + carry[2:]
        return carry, torch.stack(stats)

    def run(carry, gen: torch.Generator, occ=None, shed=None):
        return run_draws(carry, draw_block(gen, cpb, w, n_keys, hot_n,
                                           max_scan_len, dev), occ, shed)

    run.run_draws = run_draws

    def init(db: kv.KVTable):
        assert db.val_words == val_words, (db.val_words, val_words)
        if db.key_hi.device.type != dev.type:
            raise ValueError(f"table on {db.key_hi.device}, runner on {dev}")
        base = (db,)
        if use_scan:
            ne = db.key_hi.shape[0]
            dcap = min(64, max(1, ne - scan_max)) if delta_cap is None \
                else int(delta_cap)
            assert ne >= scan_max + dcap, (ne, scan_max, dcap)
            base = base + (run_mod.from_table(db, delta_cap=dcap),)
        return base + ((mon.create(dev),) if monitor else ())

    def drain(carry):
        zero = torch.zeros((1, 2), dtype=I32, device=dev)
        return (carry[0], zero) + ((carry[-1],) if monitor else ())

    return run, init, drain
