"""Sort-free dense TATP engine in PyTorch: the port of
`dint_tpu.engines.tatp_dense` on its kernel routes (the JAX ``use_pallas``
route, with or without the hot tier and the fused megakernels).

The design is the JAX module's (its docstring has the full argument):

* All five TATP tables live in ONE flat row-id space: rows [0,p1) sub |
  [p1,2p1) sec | [2p1,6p1) ai | [6p1,10p1) sf | [10p1,22p1) cf, p1 =
  n_sub+1, and row N is the sentinel every NOP lane gathers from and no
  lane writes.
* ``meta[row] = ver << 1 | exists`` is the word OCC validation compares.
* Locks are step stamps in a separate array, ``arb[row] = step << K_ARB |
  (2w-1 - slot)``; a row is held iff its step field is ``step - 1``, so
  locks expire two steps after their grant and releases need no write.
* One step fuses the commit wave of cohort t-2 (install + log x3), the
  validate wave of t-1 and the read+lock wave of a new cohort.
* The hot tier (``use_hotset``) keeps write-through mirrors ``hot_meta``
  and ``hot_val`` of the flat row prefix [0, hot_n), which covers the
  subscriber-table prefix (`attach_hotset`).

Routes (static per runner, `ROUTES`), each bit-identical to the JAX XLA
route:

* default: the fused meta gather and the magic-word gather are the two
  streams of one `gather_rows` launch, the lock pass the `lock_arbitrate`
  kernel; the install and the log append are plain torch writes.
* ``use_hotset``: both gathers are the two streams of one
  `gather_rows_hot` launch over the mirrors, and the install writes
  through with the meta and val streams of one `scatter_rows_hot` launch.
* ``use_fused``: the validate re-read, the new cohort's meta read and the
  lock pass are one `lock_validate` launch (over the main meta table even
  with the hot tier on); the install, the log x3 append and (hot tier)
  the mirror write-through are the streams of one `scatter_streams`
  launch. The magic gather still runs `gather_rows` (`gather_rows_hot`
  with the hot tier).

The serve plane (``occupancy``/``shed``) masks the lanes of a cohort past
its admitted occupancy to no-ops before wave 1; the counter plane
(``counters``, monitor/counters.py) bumps the registry in-step.

What differs from JAX:

* Tables are int32 tensors holding u32 bit patterns (ops/u32.py), updated
  in place: the kernels update ``arb`` and the installs the tables; the
  default route's installs and log append are index_put_ writes.
* Masked install lanes are filtered out before the index_put_ (JAX routes
  them out of bounds under ``mode="drop"``); the kernel routes pass them
  as index -1. The kept rows are unique by certification (one X-lock
  holder per row), so no result depends on the order of duplicate writes.
* The step counter ``DenseDB.step`` is a Python int on the host: the stamp
  arithmetic and the rebase check need no device sync.
* Random draws come in from outside the step: ``bits`` [w, 4] u32 for the
  new cohort (JAX: ``jax.random.bits``) and ``payload`` [w, 2] i32 for the
  installed values (JAX: ``jax.random.randint(.., 0, 1 << 16)``). The
  runner's `run` draws them with a `torch.Generator`; its ``run_draws``
  takes them as given, which is how the tests replay JAX's draws.
* `lock_arbitrate` and `lock_validate` take no ``hot_n``: JAX's keeps the
  arb prefix in VMEM, which changes no output and has no twin on the card.

``emit_installs`` adds the step's wave-3 record (`Installs`: what a backup
replica applies, parallel/dense_sharded.py) after the stats, in JAX's
position: (db, new_ctx, c1, stats, inst[, counters][, ring]). Its tensors
are fresh or views of c2's, so the step's in-place writes leave it as it
was built.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..ops import u32
from ..monitor import counters as mon
from ..monitor import txnevents as txe
from ..monitor import waves
from ..ops.row_kernels import (gather_rows, gather_rows_hot, lock_arbitrate,
                               lock_validate, scatter_rows_hot,
                               scatter_streams)
from ..tables import log as logring
from . import tatp
from .tatp_pipeline import (K, MAGIC, N_SHARDS, CohortTables, classify_wave1,
                            cohort_tables, draw_bits, gen_cohort_from_bits)
from .tatp_pipeline import (STAT_ATTEMPTED, STAT_COMMITTED, STAT_AB_LOCK,  # noqa: F401 (re-exported)
                            STAT_AB_MISSING, STAT_AB_VALIDATE, STAT_MAGIC_BAD,
                            N_STATS)
from .types import ROUTES, Op, Reply  # noqa: F401 (ROUTES re-exported)

I32 = torch.int32

# arb stamp layout: step << K_ARB | (2w-1 - slot). Supports w <= 2^17 and
# 2^(32-K_ARB) = 16384 steps between rebases.
K_ARB = 18
REBASE_AT = (1 << (32 - K_ARB)) - 4096


def _bases(p1: int) -> np.ndarray:
    """Flat row-id base per table id (tatp.SUBSCRIBER..tatp.CALL_FORWARDING)."""
    return np.cumsum([0, p1, p1, 4 * p1, 4 * p1]).astype(np.int32)


def n_rows(n_sub: int) -> int:
    return 22 * (n_sub + 1)


@dataclass
class DenseDB:
    """All 5 TATP tables + locks + log x3 in flat dense tensors (row N is
    the sentinel). ``val`` is interleaved 1-D: row r's words at
    [r*VW, (r+1)*VW), 40 B/row at VW=10, 6.2 GB at 7M subscribers. The
    ``hot_*`` leaves are the hot tier's mirrors of the row prefix
    [0, hot_n) (None = no hot tier; see `attach_hotset`)."""
    val: torch.Tensor      # i32 [(N+1) * VW]; word0 payload, word1 magic
    meta: torch.Tensor     # i32 [N+1]  ver<<1 | exists
    arb: torch.Tensor      # i32 [N+1]  step-stamped lock arbitration word
    step: int              # host counter, starts at 2 (stamp 0 = never held)
    log: logring.RepLog    # 3 replica entries packed per slot (log x3)
    val_words: int = 10
    hot_meta: torch.Tensor | None = None   # i32 [hot_n]
    hot_val: torch.Tensor | None = None    # i32 [hot_n * VW]
    hot_n: int = 0

    @property
    def n_sub(self) -> int:
        return self.meta.shape[0] // 22 - 1

    @property
    def ver(self) -> torch.Tensor:
        return u32.shr(self.meta, 1)

    @property
    def exists(self) -> torch.Tensor:
        return (self.meta & 1) != 0

    @property
    def locked(self) -> torch.Tensor:
        """Rows X-held right now: stamped by the previous step."""
        return u32.shr(self.arb, K_ARB) == self.step - 1


def create(n_sub: int, val_words: int = 10, log_lanes: int = 16,
           log_capacity: int = 1 << 16, log_replicas: int = N_SHARDS,
           device=None) -> DenseDB:
    dev = resolve_device(device)
    n1 = n_rows(n_sub) + 1
    # flat word indices (row * VW + j) are computed in int32 on the device
    if n1 * val_words >= (1 << 31):
        raise ValueError(f"n_sub={n_sub} x val_words={val_words} overflows "
                         f"int32 row*VW indices")
    return DenseDB(
        val=torch.zeros((n1 * val_words,), dtype=I32, device=dev),
        meta=torch.zeros((n1,), dtype=I32, device=dev),
        arb=torch.zeros((n1,), dtype=I32, device=dev),
        step=2,
        log=logring.create_rep(log_lanes, log_capacity, val_words,
                               replicas=log_replicas, device=dev),
        val_words=val_words)


def populate(rng: np.random.Generator, n_sub: int, val_words: int = 10,
             device=None, **kw) -> DenseDB:
    """The JAX `populate` on the host with the same numpy draws, so the same
    ``rng`` state gives bit-identical tables (reference populate:
    tatp/caladan/client_ebpf_shard.cc:96-341): all subscribers present,
    ai/sf types present w.p. 0.625 (>=1 each), CF rows on 25% of present
    sf rows per start_time; val word0 = row payload, word1 = magic."""
    p1 = n_sub + 1
    db = create(n_sub, val_words=val_words, device=device, **kw)
    n1 = n_rows(n_sub) + 1
    base = _bases(p1)

    val = np.zeros((n1, val_words), np.uint32)
    meta = np.zeros(n1, np.uint32)

    def put(rows, payload):
        val[rows, 0] = payload.astype(np.uint32)
        val[rows, 1] = MAGIC
        meta[rows] = (1 << 1) | 1             # ver 1, exists

    s_ids = np.arange(1, p1)
    put(base[tatp.SUBSCRIBER] + s_ids, s_ids)
    put(base[tatp.SEC_SUBSCRIBER] + s_ids, s_ids)

    ai_present = rng.random((p1, 4)) < 0.625
    sf_present = rng.random((p1, 4)) < 0.625
    ai_present[0] = sf_present[0] = False
    ai_present[1:][ai_present[1:].sum(1) == 0, 0] = True
    sf_present[1:][sf_present[1:].sum(1) == 0, 0] = True
    ai_idx = np.nonzero(ai_present.reshape(-1))[0]
    sf_idx = np.nonzero(sf_present.reshape(-1))[0]
    put(base[tatp.ACCESS_INFO] + ai_idx, ai_idx)
    put(base[tatp.SPECIAL_FACILITY] + sf_idx, sf_idx)

    sfi, sft = np.nonzero(sf_present)
    cf_keys = []
    for st in (0, 8, 16):
        mask = rng.random(len(sfi)) < 0.25
        cf_keys.append(np.asarray(tatp.cf_key(sfi[mask], sft[mask] + 1, st)))
    cf_keys = np.unique(np.concatenate(cf_keys)).astype(np.int64)
    put(base[tatp.CALL_FORWARDING] + cf_keys, cf_keys)

    dev = db.meta.device
    db.val = u32.from_numpy(val.reshape(-1), dev)
    db.meta = u32.from_numpy(meta, dev)
    return db


def populate_device(gen: torch.Generator | None, n_sub: int,
                    val_words: int = 10, device=None, **kw) -> DenseDB:
    """Populate on the device for reference-scale tables: the population
    rules of `populate`, drawn with the torch generator ``gen`` (seeded 0
    when None) where the tables live, so the 6.2 GB val array at n_sub=7e6
    is made in device memory. Distribution-identical to `populate`, not
    bit-identical (another random stream)."""
    db = create(n_sub, val_words=val_words, device=device, **kw)
    dev = db.meta.device
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
    if torch.device(gen.device).type != dev.type:
        raise ValueError(f"generator on {gen.device}, tables on {dev}")
    p1 = n_sub + 1
    sub_e = torch.arange(p1, device=dev) >= 1                  # [p1]

    def present():
        pr = torch.rand(p1 * 4, generator=gen, device=dev) < 0.625
        pr4 = pr.view(p1, 4)                                    # idx = s*4+t
        pr4[:, 0] |= ~pr4.any(dim=1)                            # >=1 each
        return pr & sub_e.repeat_interleave(4)

    ai_p = present()                                            # [4*p1]
    sf_p = present()
    # cf rows flat [12*p1]: idx = s*12 + (sf_type-1)*3 + start_time/8 (the
    # cf_key layout); idx // 3 is the covering sf element
    cf_p = sf_p.repeat_interleave(3) \
        & (torch.rand(p1 * 12, generator=gen, device=dev) < 0.25)
    exists = torch.cat([sub_e, sub_e, ai_p, sf_p, cf_p,
                        torch.zeros(1, dtype=torch.bool, device=dev)])
    db.meta.copy_(exists.to(I32) * ((1 << 1) | 1))             # ver 1

    # payload = index within the row's table region (populate's `put`)
    rows = torch.nonzero(exists).squeeze(1)
    base = torch.as_tensor(_bases(p1).astype(np.int64), device=dev)
    region = torch.searchsorted(base, rows, right=True) - 1
    widx = rows * val_words
    db.val[widx] = (rows - base[region]).to(I32)
    db.val[widx + 1] = MAGIC
    return db


def attach_hotset(db: DenseDB, hot_rows: int) -> DenseDB:
    """The DB with the hot mirrors of the flat row prefix [0, hot_rows)
    built from its current tables (11.2 MB at 7M subscribers and
    hot_rows = 280,000). The mirrors are copies, not views of the tables,
    so the write-through writes two storages."""
    hot_rows = int(min(max(int(hot_rows), 1), n_rows(db.n_sub)))
    return dataclasses.replace(
        db, hot_meta=db.meta[:hot_rows].clone(),
        hot_val=db.val[:hot_rows * db.val_words].clone(), hot_n=hot_rows)


# ---------------------------------------------------------------- pipeline


@dataclass
class DenseCtx:
    """An in-flight cohort between pipeline stages (row ids and versions
    are captured once at wave 1). Bootstrap cohorts have attempted == 0 and
    all-False masks."""
    rows: torch.Tensor       # i32 [w, K] flat row ids (sentinel for NOP lanes)
    is_read: torch.Tensor    # bool [w, K] OCC_READ lanes
    vv1: torch.Tensor        # i32 [w, K] meta (ver<<1|exists) at wave 1
    alive: torch.Tensor      # bool [w]
    ro_commit: torch.Tensor  # bool [w]
    granted: torch.Tensor    # bool [w, 2]
    ws_rows: torch.Tensor    # i32 [w, 2] write-slot row ids (sentinel if inactive)
    ws_vv: torch.Tensor      # i32 [w, 2] write-slot ver:exists at wave 1
    ws_tbl: torch.Tensor     # i32 [w, 2]
    ws_key: torch.Tensor     # i32 [w, 2] (logged key)
    ws_kind: torch.Tensor    # i32 [w, 2] 0 commit / 1 insert / 2 delete
    ws_active: torch.Tensor  # bool [w, 2]
    attempted: torch.Tensor  # i32 scalar
    ab_lock: torch.Tensor    # i32 scalar
    ab_missing: torch.Tensor  # i32 scalar
    ab_validate: torch.Tensor  # i32 scalar
    magic_bad: torch.Tensor  # i32 scalar


def empty_ctx(w: int, device) -> DenseCtx:
    dev = torch.device(device)

    def z(shape, dt=I32):
        return torch.zeros(shape, dtype=dt, device=dev)

    b = torch.bool
    return DenseCtx(
        rows=z((w, K)), is_read=z((w, K), b), vv1=z((w, K)),
        alive=z((w,), b), ro_commit=z((w,), b), granted=z((w, 2), b),
        ws_rows=z((w, 2)), ws_vv=z((w, 2)), ws_tbl=z((w, 2)),
        ws_key=z((w, 2)), ws_kind=z((w, 2)), ws_active=z((w, 2), b),
        attempted=z(()), ab_lock=z(()), ab_missing=z(()),
        ab_validate=z(()), magic_bad=z(()))


def _stats_of(c: DenseCtx) -> torch.Tensor:
    return torch.stack([
        c.attempted, (c.ro_commit | c.alive).sum(dtype=I32),
        c.ab_lock, c.ab_missing, c.ab_validate, c.magic_bad])


@dataclass
class StepConsts:
    """Device constants of a step, made once per runner so that no step
    copies host data to the device (a copy from pageable host memory
    synchronises the stream)."""
    base: torch.Tensor     # i32 [5] flat row-id base per table
    cohort: CohortTables   # txn-mix thresholds and per-type lane layout
    lane: torch.Tensor     # i32 [w] lane index (the serve plane's mask)


def step_consts(n_sub: int, w: int, mix, device) -> StepConsts:
    return StepConsts(
        base=torch.as_tensor(_bases(n_sub + 1), device=device),
        cohort=cohort_tables(mix, device),
        lane=torch.arange(w, dtype=I32, device=device))


@dataclass
class Installs:
    """The wave-3 install record of one step: what a backup replica
    applies (the reference's CommitBck x2 + CommitLog fan-out,
    client_ebpf_shard.cc:779-900). Rows are the emitting shard's local ids;
    ``wmask`` marks real writes (releases are lock-only and stay local).
    Words are int32-carried u32."""
    wmask: torch.Tensor    # bool [2w]
    rows: torch.Tensor     # i32 [2w]
    meta: torch.Tensor     # i32 [2w]  new ver<<1|exists, 0 where masked
    val: torch.Tensor      # i32 [2w, VW]
    tbl: torch.Tensor      # i32 [2w]  (for the log)
    key: torch.Tensor      # i32 [2w]
    is_del: torch.Tensor   # i32 [2w]
    ver: torch.Tensor      # i32 [2w]


def pipe_step(db: DenseDB, c1: DenseCtx, c2: DenseCtx, bits, payload, *,
              w: int, n_sub: int, val_words: int, gen_new: bool = True,
              mix=None, check_magic: bool = True, use_hotset: bool = False,
              use_fused: bool = False, emit_installs: bool = False,
              occupancy=None, shed=None,
              counters: mon.Counters | None = None,
              ring: txe.TxnRing | None = None,
              tcfg: txe.TraceCfg | None = None,
              consts: StepConsts | None = None):
    """One fused step: commit wave of c2, validate wave of c1, and read+lock
    wave of a NEW cohort drawn from ``bits`` [w, 4] (unused when
    ``gen_new`` is False) — commits, then reads, then lock acquires, so
    cohort t-2's installs are visible to t-1's validation and this step's
    reads. ``payload`` [w, 2] i32 fills word 0 of c2's installed rows.

    ``use_hotset``/``use_fused`` pick the route (module docstring).
    ``occupancy``/``shed`` (device i32 scalars, or None = off): lanes >=
    occupancy of the new cohort become no-ops before wave 1 and
    ``attempted`` counts the admitted lanes only; ``shed`` is mirrored onto
    the counters. ``counters``: bumped in place when given.
    ``ring``/``tcfg`` (monitor.txnevents): the flight recorder — the new
    cohort's lock verdicts and wave-1 outcomes, c1's validate verdicts and
    wave-2 outcomes, and c2's installs of the sampled txn ids land in the
    ring with one write, in place.

    Each wave runs under its `waves.scope`; the meta and magic gathers
    are the two streams of one launch in the ``meta_gather`` scope on the
    unfused routes, so ``magic_gather`` holds the magic compare alone there.

    Updates ``db`` in place and returns (db, new_ctx, c1', stats-of-c2),
    plus c2's `Installs` when ``emit_installs``, plus the counters when
    ``counters`` is given, plus the ring when ``ring`` is given."""
    dev = db.meta.device
    if consts is None:
        consts = step_consts(n_sub, w, mix, dev)
    if use_hotset and db.hot_meta is None:
        raise ValueError("use_hotset needs the hot mirrors (attach_hotset)")
    sent = n_rows(n_sub)   # sentinel row: gathered by NOP lanes, never written
    base = consts.base
    t = db.step
    hn = db.hot_n
    observed = counters is not None or ring is not None

    # ---- wave 3 of c2: install + log --------------------------------------
    # only real writes touch meta: lock releases are implicit (c2's stamps
    # from step t-2 expire this step). Uniqueness: one X-holder per row,
    # and a txn's two slots target different tables.
    with waves.scope("tatp_dense", "install_log" if use_fused else "install"):
        do_write = c2.ws_active & c2.alive[:, None]             # [w, 2]
        wmask = do_write.reshape(-1)
        wkind = c2.ws_kind.reshape(-1)
        newex = (wkind != 2) & wmask
        vv = u32.to_u64(c2.ws_vv.reshape(-1))   # wave-1 meta: X-held since,
        #                                         so still current
        newver64 = (vv >> 1) + 1
        meta_new = u32.wrap_i32((newver64 << 1) | newex.to(torch.int64))
        newver = u32.wrap_i32(newver64)
        newval = torch.zeros((w, 2, val_words), dtype=I32, device=dev)
        newval[:, :, 0] = payload
        newval[:, :, 1] = torch.where(do_write & (c2.ws_kind != 2), MAGIC, 0)
        newval = newval.view(-1, val_words)
        newval = torch.where((wkind == 2)[:, None], 0, newval)  # delete zeroes
        log_tbl, log_key = c2.ws_tbl.reshape(-1), c2.ws_key.reshape(-1)
        is_del, zero_hi = (wkind == 2).to(I32), torch.zeros_like(log_key)
        wsr = c2.ws_rows.reshape(-1)
        if use_hotset:
            # the hot set is the row prefix: mirror index == row for hot rows
            w_midx = torch.where(wmask & (wsr < hn), wsr, -1)
        if use_fused:
            # install_log: val and meta installs, the log x3 append and (hot
            # tier) the mirror write-through as the streams of one launch;
            # the log plan routes masked lanes to -1 already
            lflat, entry3, lane_counts = logring.plan_rep(
                db.log, wmask, log_tbl, is_del, zero_hi, log_key, newver,
                newval)
            widx = torch.where(wmask, wsr, -1)
            tabs = [db.val, db.meta, db.log.entries.view(-1)]
            idxs = [widx, widx, lflat.to(I32)]
            vals = [newval.reshape(-1), meta_new, entry3.reshape(-1)]
            vws = [val_words, 1, db.log.entries.shape[1]]
            if use_hotset:
                tabs += [db.hot_val, db.hot_meta]
                idxs += [w_midx, w_midx]
                vals += [newval.reshape(-1), meta_new]
                vws += [val_words, 1]
            scatter_streams(tabs, idxs, vals, vws)
            db.log.head = u32.wrap_i32(u32.to_u64(db.log.head) + lane_counts)
        elif use_hotset:
            # meta and val: two streams of one launch on the same lanes
            scatter_rows_hot((db.meta, db.val), (db.hot_meta, db.hot_val),
                             (wsr, wsr), (w_midx, w_midx), (wmask, wmask),
                             (meta_new, newval.reshape(-1)), (1, val_words))
        else:
            keep = torch.nonzero(wmask).squeeze(1)
            wrows = wsr[keep].to(torch.int64)
            db.meta[wrows] = meta_new[keep]
            wflat = (wrows[:, None] * val_words
                     + torch.arange(val_words, device=dev)).reshape(-1)
            db.val[wflat] = newval[keep].reshape(-1)
    if not use_fused:
        with waves.scope("tatp_dense", "log_append"):
            logring.append_rep(db.log, wmask, log_tbl, is_del, zero_hi,
                               log_key, newver, newval)

    # ---- wave 1: new cohort read + lock -----------------------------------
    if gen_new:
        with waves.scope("tatp_dense", "gen"):
            ttype, ops, tbl, kk, ws = gen_cohort_from_bits(
                bits, w, n_sub, tables=consts.cohort)
        ws_active, ws_lane, ws_tbl, ws_key, ws_kind = ws
    else:
        ttype = torch.zeros((w,), dtype=I32, device=dev)
        ops, tbl, kk = (torch.zeros((w, K), dtype=I32, device=dev)
                        for _ in range(3))
        ws_active = torch.zeros((w, 2), dtype=torch.bool, device=dev)
        ws_lane, ws_tbl, ws_key, ws_kind = (
            torch.zeros((w, 2), dtype=I32, device=dev) for _ in range(4))

    if occupancy is not None:
        # serve plane: the cohort is drawn full-width and the lanes past
        # the admitted occupancy are erased before any wave sees them.
        # occ is a copy: ``attempted`` is read when the cohort completes,
        # after the caller may have refilled its occupancy buffer
        with waves.scope("tatp_dense", "serve"):
            occ = occupancy.to(I32, copy=True)
            lane_ok = consts.lane < occ
            ops = torch.where(lane_ok[:, None], ops, Op.NOP)
            ws_active = ws_active & lane_ok[:, None]

    used = ops != Op.NOP
    rows = torch.where(used, base[tbl] + kk, sent)              # [w, K]
    is_read = ops == Op.OCC_READ

    def lock_lanes():
        ws_rows = torch.where(ws_active, base[ws_tbl] + ws_key, sent)
        flat_ws = ws_rows.reshape(-1)
        # the won-vs-lost split needs the stamps from before arbitration,
        # which the lock kernels update in place
        held = (u32.shr(db.arb.index_select(0, flat_ws), K_ARB) == t - 1
                if observed else None)
        return ws_rows, flat_ws, ws_active.reshape(-1), held

    def magic_lanes():
        # word 1 of each row the new cohort reads: pre-scaled flat word
        # offsets, gathered with vw = 1; the mirror is the flat word prefix
        # [0, hn*VW), so a hot row's magic word sits at the same offset
        midx = (rows * val_words + 1).reshape(-1)
        mg_midx = (torch.where((rows < hn).reshape(-1), midx, -1)
                   if use_hotset else None)
        return midx, mg_midx

    def magic_count(rmagic):
        # reads of present rows whose magic word is not the populate magic
        rex = (rmeta & 1) != 0
        return (is_read & rex & (rmagic.view(w, K) != MAGIC)).sum(dtype=I32)

    if use_fused:
        # c1's validate re-read, the new cohort's meta read and the lock
        # pass in one launch; it reads meta after the installs above
        with waves.scope("tatp_dense", "lock_validate"):
            ws_rows, flat_ws, active, held = lock_lanes()
            _, grant, vbad, rmeta = lock_validate(
                db.arb, db.meta, c1.rows.reshape(-1), c1.vv1.reshape(-1),
                rows.reshape(-1), flat_ws, active, t, K_ARB)
            rmeta = rmeta.view(w, K)
        bad = c1.is_read & vbad.view(w, K)
        if check_magic:
            with waves.scope("tatp_dense", "magic_gather"):
                midx, mg_midx = magic_lanes()
                rmagic = (gather_rows_hot(db.val, db.hot_val, midx, mg_midx,
                                          1)
                          if use_hotset else gather_rows(db.val, midx, 1))
                magic_bad = magic_count(rmagic)
    else:
        # ONE meta gather serves wave 2 (c1's validate re-read) AND wave 1
        # (the new cohort's reads); the magic gather is the second stream
        # of its launch (both read after the installs above, and nothing
        # between them writes meta or val)
        with waves.scope("tatp_dense", "meta_gather"):
            gidx = torch.cat([c1.rows.reshape(-1), rows.reshape(-1)])
            tabs, idxs = [db.meta], [gidx]
            if check_magic:
                midx, mg_midx = magic_lanes()
                tabs.append(db.val)
                idxs.append(midx)
            vws = (1,) * len(tabs)
            if use_hotset:
                g_midx = torch.where(gidx < hn, gidx, -1)
                mirrors, midxs = [db.hot_meta], [g_midx]
                if check_magic:
                    mirrors.append(db.hot_val)
                    midxs.append(mg_midx)
                g, *rest = gather_rows_hot(tabs, mirrors, idxs, midxs, vws)
            else:
                g, *rest = gather_rows(tabs, idxs, vws)
            vvB = g[: w * K].view(w, K)
            rmeta = g[w * K:].view(w, K)
        bad = c1.is_read & (vvB != c1.vv1)
        if check_magic:
            # the magic words came with the meta gather's launch
            with waves.scope("tatp_dense", "magic_gather"):
                magic_bad = magic_count(rest[0])

    # ---- wave 2 of c1: validate read-set version compare ------------------
    changed = bad.any(dim=1)
    if observed:
        # lanes of surviving RW txns checked / failed; c1's alive before
        # the verdict is the wave-2 outcome events' mask
        v_alive = c1.is_read & c1.alive[:, None]
        v_bad = bad & v_alive
        c1_alive_pre = c1.alive
    c1 = dataclasses.replace(c1, alive=c1.alive & ~changed,
                             ab_validate=(c1.alive & changed).sum(dtype=I32))

    rex = (rmeta & 1) != 0
    if not check_magic:
        magic_bad = torch.zeros((), dtype=I32, device=dev)

    # lock arbitration in [w, 2] write-slot space: first slot wins per row
    # (batched CAS, tatp/ebpf/shard_kern.c:251-297); losers and held rows
    # REJECT. Candidates on held rows never stamp, so rejected attempts
    # cannot keep a hot row locked. On the fused route it ran above.
    ws_vv = torch.take_along_dim(rmeta, ws_lane.to(torch.int64), dim=1)
    if not use_fused:
        with waves.scope("tatp_dense", "lock"):
            ws_rows, flat_ws, active, held = lock_lanes()
            _, grant = lock_arbitrate(db.arb, flat_ws, active, t, K_ARB)
    grant = grant.view(w, 2)

    # reply types: reads from the gather; write-slot GRANT/REJECT direct
    rt = torch.where(is_read & used,
                     torch.where(rex, Reply.VAL, Reply.NOT_EXIST), Reply.NONE)
    ws_rt = torch.where(grant, Reply.GRANT,
                        torch.where(ws_active, Reply.REJECT, Reply.NONE))

    # ---- wave-1 outcome: shared per-txn-type rules ------------------------
    is_ro, rw, granted, lock_rejected, missing = classify_wave1(
        ttype, rt, ops, ws_active, ws_lane, ws_rt=ws_rt)

    if occupancy is not None:
        attempted = occ
    else:
        attempted = torch.full((), w if gen_new else 0, dtype=I32,
                               device=dev)
    new_ctx = DenseCtx(
        rows=rows, is_read=is_read & used, vv1=rmeta,
        alive=rw & ~lock_rejected & ~missing,
        ro_commit=is_ro & ~missing, granted=granted,
        ws_rows=ws_rows, ws_vv=ws_vv,
        ws_tbl=ws_tbl, ws_key=ws_key, ws_kind=ws_kind,
        ws_active=ws_active, attempted=attempted,
        ab_lock=(rw & lock_rejected).sum(dtype=I32),
        ab_missing=((rw & ~lock_rejected & missing)
                    | (is_ro & missing)).sum(dtype=I32),
        ab_validate=torch.zeros((), dtype=I32, device=dev),
        magic_bad=magic_bad)

    db.step = t + 1
    out = (db, new_ctx, c1, _stats_of(c2))
    if emit_installs:
        out += (Installs(wmask=wmask, rows=wsr,
                         meta=torch.where(wmask, meta_new, 0), val=newval,
                         tbl=log_tbl, key=log_key, is_del=is_del,
                         ver=newver),)
    grant_l = grant.reshape(-1)
    if counters is not None:
        upd = {}
        if use_hotset:
            # partition accounting over the meta and magic gathers; the
            # fused route reads meta from the main table, so only the magic
            # gather is partitioned there. Refresh bytes are what the JAX
            # kernel route (use_pallas) counts.
            if use_fused:
                hits, lanes, refresh = 0, 0, 0
            else:
                hits, lanes, refresh = ((g_midx >= 0).sum(dtype=I32),
                                        2 * w * K, hn * 4)
            if check_magic:
                hits = hits + (mg_midx >= 0).sum(dtype=I32)
                lanes += w * K
                refresh += hn * val_words * 4
            upd.update({mon.CTR_HOT_HITS: hits,
                        mon.CTR_HOT_COLD_ROWS: lanes - hits,
                        mon.CTR_HOT_REFRESH_BYTES: refresh})
        if occupancy is not None:
            upd.update({mon.CTR_SERVE_OCC_LANES: occ,
                        mon.CTR_SERVE_PAD_LANES: w - occ,
                        mon.CTR_SERVE_SHED_LANES: 0 if shed is None
                        else shed})
        n_writes = wmask.sum(dtype=I32)
        upd.update({
            mon.CTR_STEPS: 1,
            mon.CTR_TXN_ATTEMPTED: c2.attempted,
            mon.CTR_TXN_COMMITTED: (c2.ro_commit | c2.alive).sum(dtype=I32),
            mon.CTR_AB_LOCK: c2.ab_lock,
            mon.CTR_AB_MISSING: c2.ab_missing,
            mon.CTR_AB_VALIDATE: c2.ab_validate,
            mon.CTR_MAGIC_BAD: c2.magic_bad,
            mon.CTR_LOCK_REQUESTS: active.sum(dtype=I32),
            mon.CTR_LOCK_GRANTED: (active & grant_l).sum(dtype=I32),
            mon.CTR_LOCK_REJECTED: (active & ~grant_l).sum(dtype=I32),
            mon.CTR_LOCK_REJECT_HELD: (active & held).sum(dtype=I32),
            mon.CTR_LOCK_REJECT_ARB: (active & ~held & ~grant_l).sum(
                dtype=I32),
            mon.CTR_VALIDATE_LANES: v_alive.sum(dtype=I32),
            mon.CTR_VALIDATE_FAILED: v_bad.sum(dtype=I32),
            mon.CTR_INSTALL_WRITES: n_writes,
            mon.CTR_LOG_APPENDS: n_writes,
            mon.CTR_DISPATCH_PALLAS: 1,       # the port runs the kernel route
            **({mon.CTR_FUSED_DISPATCH: 1} if use_fused else {}),
        })
        mon.bump(counters, upd)
        mon.gauge_max(counters,
                      {mon.CTR_RING_HWM: u32.to_u64(db.log.head).max()})
        out += (counters,)
    if ring is not None:
        # dinttrace: a txn id is gen_step*w + lane (c1 generated at t-1, c2
        # at t-2), so a txn's events join with no id in the carry. The
        # outcome masks mirror the counters: ro commits and lock/missing
        # aborts classify at wave 1, rw commits and validate aborts at
        # wave 2, so full-rate event counts reconcile with the ledger.
        with waves.scope("tatp_dense", "trace"):
            txn_new, txn_c1, txn_c2 = (txe.txn_ids(t - d, w, consts.lane)
                                       for d in range(3))
            lock_aux = (torch.where(grant_l, txe.LOCK_GRANTED, 0)
                        | torch.where(held, txe.LOCK_HELD, 0))
            lock_ab = rw & lock_rejected
            miss_m = (rw & ~lock_rejected & missing) | (is_ro & missing)
            out1_cause = torch.where(
                lock_ab, txe.CAUSE_LOCK,
                torch.where(miss_m, txe.CAUSE_MISSING, txe.CAUSE_COMMIT))
            out2_cause = torch.where(changed, txe.CAUSE_VALIDATE,
                                     txe.CAUSE_COMMIT)
            lock_w, val_w, inst_w = (waves.full_name("tatp_dense", n)
                                     for n in ("lock", "meta_gather",
                                               "install"))
            groups = (
                txe.ev(active, txn_new.repeat_interleave(2), txe.EV_LOCK,
                       lock_w, aux=lock_aux, step=t),
                txe.ev(v_alive.reshape(-1), txn_c1.repeat_interleave(K),
                       txe.EV_VALIDATE, val_w, aux=v_bad.reshape(-1),
                       step=t),
                txe.ev(wmask, txn_c2.repeat_interleave(2), txe.EV_INSTALL,
                       inst_w, step=t),
                txe.ev(lock_ab | miss_m | new_ctx.ro_commit, txn_new,
                       txe.EV_OUTCOME, lock_w, aux=out1_cause, step=t),
                txe.ev(c1_alive_pre, txn_c1, txe.EV_OUTCOME, val_w,
                       aux=out2_cause, step=t),
            )
            txe.emit(ring, tcfg, groups, counters)
        out += (ring,)
    return out


def rebase_stamps(db: DenseDB) -> DenseDB:
    """Rebase arb stamps so the step field never overflows its budget:
    live stamps (step-1 -> 2, step-2 -> 1) are kept, everything older is
    zeroed, and the step counter restarts at 3. One elementwise pass over
    arb, once per ~12k steps; in place."""
    with waves.scope("tatp_dense", "rebase"):
        t = db.step
        ts = u32.to_u64(u32.shr(db.arb, K_ARB))
        keep = ts + 2 >= t
        new_ts = torch.where(keep, ts - (t - 3), 0)
        low = u32.to_u64(db.arb) & ((1 << K_ARB) - 1)
        db.arb.copy_(u32.wrap_i32(torch.where(keep, (new_ts << K_ARB) | low,
                                              0)))
    db.step = 3
    return db


def build_pipelined_runner(n_sub: int, w: int = 8192, val_words: int = 10,
                           cohorts_per_block: int = 8, mix=None,
                           check_magic: bool = True, use_hotset: bool = False,
                           hot_frac=None, use_fused: bool = False,
                           monitor: bool = False, trace=None,
                           trace_rate=None, trace_cap=None,
                           serve: bool = False, device=None):
    """A loop of `pipe_step` over carry (db, c1, c2); the contract of the
    JAX `build_pipelined_runner`: returns (run, init, drain).

    * ``run(carry, gen)`` draws a block's ``[cpb, w, 4]`` bits and
      ``[cpb, w, 2]`` payloads with the torch generator ``gen`` on the
      device (in the ``gen`` wave's scope) and calls ``run.run_draws``;
    * ``run.run_draws(carry, bits, payload)`` runs ``cohorts_per_block``
      steps on the given draws (int32 tensors on the runner's device; bits
      hold u32 patterns) and returns (carry, stats i32 [cpb, N_STATS]);
      at the start of a block it rebases the arb stamps when the host step
      counter has reached REBASE_AT;
    * ``init(db)`` -> carry with two empty in-flight cohorts; with
      ``use_hotset`` it first attaches the mirrors of the row prefix
      [0, (n_sub+1) * hot_frac) (hot_frac 0.04 when None) to a DB that has
      none;
    * ``drain(carry, payload=None)`` runs the two flush steps and returns
      (db, stats [2, N_STATS]); ``payload`` [2, w, 2] fills c2's and c1's
      installs (drawn from a generator seeded 0 when None).

    ``use_hotset``/``use_fused``: the route (`ROUTES`). ``serve``: the
    signatures become ``run(carry, gen, occ, shed)`` and
    ``run.run_draws(carry, bits, payload, occ, shed)``, with ``occ`` and
    ``shed`` device i32 [cpb]: step i masks lanes >= occ[i] to no-ops and
    mirrors shed[i] onto the counters; nothing is read back to the host.
    ``monitor``: the carry gains a trailing `monitor.counters.Counters`
    (made by ``init``), and ``drain`` returns (db, stats, counters).
    ``trace``/``trace_rate``/``trace_cap``: the dinttrace flight recorder
    (None = DINT_TRACE / DINT_TRACE_RATE). On, the carry gains a
    `monitor.txnevents.TxnRing` BEFORE the counters, zeroed at each block
    and drain entry; ``trace_cap`` defaults to a full block of candidates
    (w*(K+6) a step), so nothing drops at rate 1.0; ``init.trace_cfg`` is
    the resolved `TraceCfg` (None when off), and ``drain`` returns (db,
    stats, ring[, counters])."""
    dev = resolve_device(device)
    if 2 * w > (1 << K_ARB):
        raise ValueError(f"w={w} exceeds the arb slot field")
    cpb = cohorts_per_block
    hot_rows = 0
    if use_hotset:
        frac = 0.04 if hot_frac is None else float(hot_frac)
        hot_rows = max(1, min(int((n_sub + 1) * frac), n_rows(n_sub)))
    trace_on = txe.trace_enabled(trace)
    tcfg = None
    n_step = w * (K + 6)   # candidate events a step: lock 2w + validate wK
    #                        + install 2w + outcome x2 (2w)
    if trace_on:
        cap = int(trace_cap) if trace_cap else n_step * cpb
        tcfg = txe.TraceCfg(rate=txe.trace_rate(trace_rate), cap=cap,
                            wave=waves.full_name("tatp_dense", "trace"))
    kw = dict(w=w, n_sub=n_sub, val_words=val_words, mix=mix,
              check_magic=check_magic, use_hotset=use_hotset,
              use_fused=use_fused, tcfg=tcfg,
              consts=step_consts(n_sub, w, mix, dev))

    def step(carry, bits, payload, occ=None, shed=None, gen_new=True):
        # the ring and the counters are updated in place: carry[3:] holds
        # them after the step as before it
        db, c1, c2 = carry[:3]
        out = pipe_step(db, c1, c2, bits, payload, gen_new=gen_new,
                        occupancy=occ, shed=shed,
                        counters=carry[-1] if monitor else None,
                        ring=carry[3] if trace_on else None, **kw)
        return out[:3] + carry[3:], out[3]

    def run_draws(carry, bits, payload, occ=None, shed=None):
        if tuple(bits.shape) != (cpb, w, 4) or \
                tuple(payload.shape) != (cpb, w, 2):
            raise ValueError(f"expected bits [{cpb}, {w}, 4] and payload "
                             f"[{cpb}, {w}, 2], got {tuple(bits.shape)} and "
                             f"{tuple(payload.shape)}")
        if serve != (occ is not None and shed is not None):
            raise ValueError("a serve runner takes occ and shed [cpb]; a "
                             "closed-loop runner takes neither")
        if carry[0].step >= REBASE_AT:
            rebase_stamps(carry[0])
        if trace_on:        # each drained window is self-contained
            txe.reset(carry[3])
        stats = []
        for i in range(cpb):
            # carry (db, c1, c2) -> (db, new cohort, c1')
            carry, s = step(carry, bits[i], payload[i],
                            *((occ[i], shed[i]) if serve else ()))
            stats.append(s)
        return carry, torch.stack(stats)

    def run(carry, gen: torch.Generator, occ=None, shed=None):
        with waves.scope("tatp_dense", "gen"):
            bits = draw_bits(gen, (cpb, w, 4), dev)
            payload = torch.randint(0, 1 << 16, (cpb, w, 2), dtype=I32,
                                    generator=gen, device=dev)
        return run_draws(carry, bits, payload, occ, shed)

    run.run_draws = run_draws

    def init(db: DenseDB):
        if db.meta.device.type != dev.type:
            raise ValueError(f"tables on {db.meta.device}, runner on {dev}")
        if use_hotset and db.hot_n == 0:
            db = attach_hotset(db, hot_rows)
        return ((db, empty_ctx(w, dev), empty_ctx(w, dev))
                + ((txe.create_ring(tcfg.cap, dev, spill=n_step),)
                   if trace_on else ())
                + ((mon.create(dev),) if monitor else ()))

    init.trace_cfg = tcfg

    def drain(carry, payload=None):
        if payload is None:
            g = torch.Generator(device=dev)
            g.manual_seed(0)
            payload = torch.randint(0, 1 << 16, (2, w, 2), dtype=I32,
                                    generator=g, device=dev)
        if trace_on:
            txe.reset(carry[3])
        carry, s1 = step(carry, None, payload[0], gen_new=False)
        carry = (carry[0], empty_ctx(w, dev)) + carry[2:]
        carry, s2 = step(carry, None, payload[1], gen_new=False)
        return (carry[0], torch.stack([s1, s2])) + carry[3:]

    return run, init, drain
