"""Sort-free dense SmallBank engine in PyTorch: the port of
`dint_tpu.engines.smallbank_dense` on its kernel routes.

The design is the JAX module's (its docstring has the full argument):

* SAVINGS and CHECKING live in ONE flat row space, row = table*N + account,
  with row M = 2N as the sentinel every inactive lane gathers from and no
  lane writes. Balances are one 1-D array of i32 words.
* Locks are step stamps in a lock-slot space of H slots: exact (slot ==
  row) while the 2N+1 rows fit MAX_LOCK_SLOTS, multiply-shift hashed above
  it (24M accounts hash 48,000,001 rows onto 2^25 slots). A slot is held
  iff its X or S stamp is ``step - 1``: every lock lives exactly one step
  boundary and releases need no write.
* No-wait S/X arbitration without a sort: per slot, the first X lane and
  the first S lane (scatter-mins of the lane index) decide, in closed
  form, what processing the slot's requests in lane order would grant.
* One step runs wave 1 of a new cohort (lock + balance read + compute)
  against the previous cohort's still-held stamps, then wave 2 of that
  previous cohort (install + log x3), whose stats it returns.
* The hot tier (``use_hotset``) keeps a mirror of the hot-account prefix,
  mirror index ``tbl * hot_n + acc`` for ``acc < hot_n``, that every
  install writes through to. Stamp mirrors exist only in the exact lock
  regime, where a cold account cannot conflate onto a hot slot.
* The serve plane (``occupancy``/``shed``) erases the lock slots of the
  lanes past a cohort's admitted occupancy before arbitration; the counter
  plane (``counters``, monitor/counters.py) bumps the registry in-step.

Routes (static per runner), each bit-identical to the JAX XLA route:

* default: the JAX ``use_pallas`` route. The held-stamp reads and the
  balance read are the three streams of one `gather_rows` launch; the
  install and the log append are plain torch writes.
* ``use_hotset``: the balance read runs `gather_rows_hot` and the install
  `scatter_rows_hot` (the write-through). The held-stamp reads are one
  two-stream `gather_rows` launch; in the exact lock regime they read the
  stamp mirrors instead, as two streams of the balance read's
  `gather_rows_hot` launch.
* ``use_fused``: the held-stamp reads and the balance read are the three
  streams of one `gather_streams` launch, over the main arrays even with
  the hot tier on; the install, the log x3 append and (hot tier) the
  mirror write-through are the streams of one `scatter_streams` launch.

What differs from JAX:

* Tables are int32 tensors holding u32 bit patterns (ops/u32.py), updated
  in place. The step counter ``DenseBank.step`` is a Python int.
* The scatter-mins ``first_x``/``first_s`` get one extra drop slot [H]
  for the lanes that request no such lock (JAX routes them out of bounds
  under ``mode="drop"``); ``scatter_reduce_("amin")`` is deterministic.
* Masked stamp, mirror-stamp and (default route) install writes keep only
  their masked-in lanes (one ``nonzero`` each); those are unique by the
  arbitration, so no result depends on the order of duplicate writes.
* Random draws come in from outside the step: ``bits`` [w, 5] u32 for the
  cohort (JAX: ``jax.random.bits``) and ``ts_amt`` [w] i32 for
  transact_saving (JAX: ``jax.random.randint(.., -20, 21)``). The runner's
  `run` draws them with a `torch.Generator`; ``run.run_draws`` takes them
  as given, which is how the tests replay JAX's draws.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..clients import workloads as wl
from ..device import resolve_device
from ..monitor import counters as mon
from ..monitor import txnevents as txe
from ..monitor import waves
from ..ops import u32
from ..ops.row_kernels import (gather_rows, gather_rows_hot, gather_streams,
                               scatter_rows_hot, scatter_streams)
from ..tables import log as logring
from .smallbank_pipeline import (L, MAGIC, N_SHARDS, VW, compute_phase,
                                 draw_step, gen_cohort_from_bits, mix_thresh,
                                 _lock_slots)
from .smallbank_pipeline import (STAT_ATTEMPTED, STAT_COMMITTED,  # noqa: F401 (re-exported)
                                 STAT_AB_LOCK, STAT_AB_LOGIC, STAT_MAGIC_BAD,
                                 STAT_BAL_DELTA, N_STATS)
from .types import ROUTES, Op  # noqa: F401 (ROUTES re-exported)

I32 = torch.int32

BIG = 1 << 30
MAX_LOCK_SLOTS = 1 << 25


def lock_slots_for(m1: int) -> int:
    """Lock-table size: exact (>= m1) up to MAX_LOCK_SLOTS, hashed above
    (the reference's lock arrays are likewise a fixed hash space with
    hash-conflation rejects, smallbank/ebpf/utils.h:16-17)."""
    return min(1 << (m1 - 1).bit_length(), MAX_LOCK_SLOTS)


@dataclass
class DenseBank:
    """Both tables + locks + log x3 in flat dense tensors (row M = 2N is
    the sentinel). The ``hot_*`` leaves are the hot tier's mirrors of the
    hot-account prefix (None = no hot tier; see `attach_hotset`)."""
    bal: torch.Tensor        # i32 [M+1] balances
    x_step: torch.Tensor     # i32 [H] u32 step of the slot's last X grant
    s_step: torch.Tensor     # i32 [H] u32 step of the slot's last S grant
    step: int                # host counter, starts at 2 (stamp 0 = never)
    log: logring.RepLog      # 3 replica entries packed per slot (log x3)
    hot_bal: torch.Tensor | None = None   # i32 [2*hot_n] balance mirror
    hot_x: torch.Tensor | None = None     # i32 [2*hot_n] X-stamp mirror
    hot_s: torch.Tensor | None = None     # i32 [2*hot_n] S-stamp mirror
    hot_n: int = 0

    @property
    def n_accounts(self) -> int:
        return self.bal.shape[0] // 2

    @property
    def lock_slots(self) -> int:
        return self.x_step.shape[0]


def attach_hotset(db: DenseBank, hot_n: int) -> DenseBank:
    """The bank with the hot mirror of accounts [0, hot_n) built from its
    current tables (7.7 MB at 24M accounts and hot_n = 960,000). Stamps
    are mirrored only in the exact lock regime."""
    n = db.n_accounts
    hot_n = int(min(max(int(hot_n), 1), n))
    ar = torch.arange(hot_n, device=db.bal.device)
    idx = torch.cat([ar, n + ar])
    exact = db.lock_slots >= 2 * n + 1
    return dataclasses.replace(
        db, hot_bal=db.bal[idx],
        hot_x=db.x_step[idx] if exact else None,
        hot_s=db.s_step[idx] if exact else None,
        hot_n=hot_n)


def create(n_accounts: int, init_balance: int = 1000, log_lanes: int = 16,
           log_capacity: int = 1 << 16, device=None) -> DenseBank:
    """Every account at ``init_balance`` (reference: smallbank/ebpf/
    shard_user.c:74-77), made on ``device`` (None = CUDA)."""
    dev = resolve_device(device)
    m1 = 2 * n_accounts + 1
    if m1 >= (1 << 31):
        raise ValueError(f"{n_accounts} accounts overflow int32 row ids")
    h = lock_slots_for(m1)
    bal = torch.full((m1,), u32.i32_bits(init_balance), dtype=I32,
                     device=dev)
    bal[-1] = 0
    return DenseBank(
        bal=bal,
        x_step=torch.zeros((h,), dtype=I32, device=dev),
        s_step=torch.zeros((h,), dtype=I32, device=dev),
        step=2,
        log=logring.create_rep(log_lanes, log_capacity, VW,
                               replicas=N_SHARDS, device=dev))


def _slot_of(rows: torch.Tensor, m1: int, h: int) -> torch.Tensor:
    """Row -> lock slot: identity when exact, else the multiply-shift hash
    ``(row * 0x9E3779B1 mod 2^32) >> (32 - log2 h)``. Rows are below 2^31,
    so the int64 product does not overflow."""
    if h >= m1:
        return rows
    shift = 32 - (h.bit_length() - 1)
    return (((rows.to(torch.int64) * 0x9E3779B1) & u32.MASK32)
            >> shift).to(I32)


def total_balance(db: DenseBank) -> torch.Tensor:
    """Sum of all balances as an i32 that wraps mod 2^32, as JAX's i32
    accumulate does; conservation compares deltas under the same wrap."""
    return u32.wrap_i32(db.bal[:-1].sum(dtype=torch.int64))


@dataclass
class BankCtx:
    """A cohort between lock+compute (wave 1) and install (wave 2). Stats
    are emitted when its writes land. Bootstrap cohorts have attempted ==
    0 and all-False masks."""
    rows: torch.Tensor       # i32 [w, L] flat row ids (sentinel if inactive)
    do_write: torch.Tensor   # bool [w, L]
    nw: torch.Tensor         # i32 [w, L] new balances
    tbl: torch.Tensor        # i32 [w, L] (for the log)
    acc: torch.Tensor        # i32 [w, L] (for the log)
    attempted: torch.Tensor  # i32 scalar
    committed: torch.Tensor  # i32 scalar
    ab_lock: torch.Tensor    # i32 scalar
    ab_logic: torch.Tensor   # i32 scalar
    magic_bad: torch.Tensor  # i32 scalar (structurally 0, kept for schema)
    bal_delta: torch.Tensor  # i32 scalar


def empty_ctx(w: int, device) -> BankCtx:
    dev = torch.device(device)

    def z(shape, dt=I32):
        return torch.zeros(shape, dtype=dt, device=dev)

    return BankCtx(rows=z((w, L)), do_write=z((w, L), torch.bool),
                   nw=z((w, L)), tbl=z((w, L)), acc=z((w, L)),
                   attempted=z(()), committed=z(()), ab_lock=z(()),
                   ab_logic=z(()), magic_bad=z(()), bal_delta=z(()))


def _stats_of(c: BankCtx) -> torch.Tensor:
    return torch.stack([c.attempted, c.committed, c.ab_lock, c.ab_logic,
                        c.magic_bad, c.bal_delta])


@dataclass
class StepConsts:
    """Device constants of a step, made once per runner so that no step
    copies host data to the device (a copy from pageable host memory
    synchronises the stream)."""
    thresh: torch.Tensor   # i64 [6] cumulative u32 txn-mix thresholds
    lane: torch.Tensor     # i32 [w*L] lane index


def step_consts(w: int, mix, device) -> StepConsts:
    return StepConsts(thresh=mix_thresh(mix, device),
                      lane=torch.arange(w * L, dtype=I32, device=device))


def _stamp(arr: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor,
           value: int):
    """``arr[idx[mask]] = value`` in place; the masked-in indices are
    unique (one writer per slot)."""
    keep = torch.nonzero(mask).squeeze(1)
    arr[idx[keep].long()] = value


def pipe_step(db: DenseBank, c1: BankCtx, bits, ts_amt, *, w: int,
              n_accounts: int, gen_new: bool = True, hot_frac=None,
              hot_prob=None, mix=None, use_hotset: bool = False,
              use_fused: bool = False, occupancy=None, shed=None,
              counters: mon.Counters | None = None,
              ring: txe.TxnRing | None = None,
              tcfg: txe.TraceCfg | None = None,
              consts: StepConsts | None = None):
    """One fused step: wave 1 of a NEW cohort drawn from ``bits`` [w, 5]
    (transact_saving amounts ``ts_amt`` [w]; both unused when ``gen_new``
    is False) acquires against c1's still-held stamps, then wave 2
    installs c1's writes and appends them to the log x3.

    ``occupancy``/``shed`` (device i32 scalars, or None = off): the lock
    slots of lanes >= occupancy are erased before arbitration, so those
    lanes request, compute and install nothing, and ``attempted`` counts
    the admitted lanes only; ``shed`` is mirrored onto the counters.
    ``counters``: bumped in place when given. ``ring``/``tcfg``
    (monitor.txnevents): the flight recorder — the new cohort's lock
    verdicts and outcomes and c1's installs of the sampled txn ids land in
    the ring with one write, in place.

    Each wave runs under its `waves.scope`, once a step. The held-stamp
    reads and the balance read that share one launch sit in the ``read``
    scope (in ``lock_validate`` on the fused routes, which have no
    ``read``); with the hot tier in the hashed lock regime the stamps'
    own launch opens the ``lock`` scope and the balances' the ``read``.

    Updates ``db`` in place and returns (db, new_ctx, stats-of-c1), plus
    the counters when ``counters`` is given, plus the ring when ``ring``
    is given."""
    dev = db.bal.device
    if consts is None:
        consts = step_consts(w, mix, dev)
    if use_hotset and db.hot_bal is None:
        raise ValueError("use_hotset needs the hot mirror (attach_hotset)")
    m1 = 2 * n_accounts + 1
    sent = m1 - 1
    h = db.lock_slots
    t = db.step
    t_now, t_held = u32.i32_bits(t), u32.i32_bits(t - 1)

    # ---- wave 1: new cohort lock + fused read + compute -------------------
    if gen_new:
        skew = {k: v for k, v in (("hot_frac", hot_frac),
                                  ("hot_prob", hot_prob)) if v is not None}
        with waves.scope("smallbank_dense", "gen"):
            ttype, a1, a2 = gen_cohort_from_bits(bits, w, n_accounts,
                                                 thresh=consts.thresh,
                                                 **skew)
            l_op, l_tb, l_ac = _lock_slots(ttype, a1, a2)      # [w, L]
    else:
        ttype = torch.zeros((w,), dtype=I32, device=dev)
        ts_amt = ttype
        l_op, l_tb, l_ac = (torch.zeros((w, L), dtype=I32, device=dev)
                            for _ in range(3))

    if occupancy is not None:
        # serve plane: the cohort is drawn full-width and the lanes past
        # the admitted occupancy lose their lock slots.
        # occ is a copy: ``attempted`` is read when the cohort completes,
        # after the caller may have refilled its occupancy buffer
        with waves.scope("smallbank_dense", "serve"):
            occ = occupancy.to(I32, copy=True)
            lane_ok = consts.lane[:w] < occ
            l_op = torch.where(lane_ok[:, None], l_op, 0)

    active = l_op != 0
    rows = torch.where(active, l_tb * n_accounts + l_ac, sent)   # [w, L]
    flat_rows = rows.reshape(-1)
    slot = _slot_of(flat_rows, m1, h)                            # [wL]
    slot_l = slot.long()
    is_x = (l_op == Op.ACQ_X_READ).reshape(-1)
    is_s = (l_op == Op.ACQ_S_READ).reshape(-1)
    lane = consts.lane

    # hot partition: a lane is hot iff its account is in the mirrored
    # prefix; the stamp mirrors share the mapping (exact regime only)
    hn = db.hot_n
    stamp_hot = use_hotset and db.hot_x is not None
    if use_hotset:
        hot_lane = (active & (l_ac < hn)).reshape(-1)
        midx = torch.where(hot_lane, (l_tb * hn + l_ac).reshape(-1), -1)

    if use_fused:
        # both held-stamp reads AND the balance read in one launch, from
        # the main arrays: the rows c1 installs below were X-stamped by c1,
        # so this cohort is never granted (or consumes) them
        with waves.scope("smallbank_dense", "lock_validate"):
            hx, hs, raw_bal = gather_streams(
                (db.x_step, db.s_step, db.bal), (slot, slot, flat_rows),
                (1, 1, 1))
    elif stamp_hot:
        # the held-stamp reads and the balance read as the three streams
        # of one launch: only the stamp writes below come between them,
        # and those write x_step/s_step (and their mirrors), never bal
        with waves.scope("smallbank_dense", "read"):
            hx, hs, raw_bal = gather_rows_hot(
                (db.x_step, db.s_step, db.bal),
                (db.hot_x, db.hot_s, db.hot_bal), (slot, slot, flat_rows),
                (midx, midx, midx), (1, 1, 1))
    elif not use_hotset:
        # the three reads in one launch, as above
        with waves.scope("smallbank_dense", "read"):
            hx, hs, raw_bal = gather_rows((db.x_step, db.s_step, db.bal),
                                          (slot, slot, flat_rows),
                                          (1, 1, 1))

    with waves.scope("smallbank_dense", "lock"):
        if use_hotset and not use_fused and not stamp_hot:
            # hashed lock regime: no stamp mirrors, so the stamps come from
            # one plain launch and the balances from the mirror below
            hx, hs = gather_rows((db.x_step, db.s_step), (slot, slot),
                                 (1, 1))
        # per-slot first X / first S lane; lanes without such a request go
        # to the drop slot h
        first_x = torch.full((h + 1,), BIG, dtype=I32, device=dev)
        first_x.scatter_reduce_(0, torch.where(is_x, slot, h).long(), lane,
                                "amin")
        first_s = torch.full((h + 1,), BIG, dtype=I32, device=dev)
        first_s.scatter_reduce_(0, torch.where(is_s, slot, h).long(), lane,
                                "amin")
        fx, fs = first_x[slot_l], first_s[slot_l]
        # held = stamped by the previous step's cohort
        held_x, held_s = hx == t_held, hs == t_held
        x_wins = (fx < fs) & ~held_x & ~held_s
        grant_x = is_x & x_wins & (fx == lane)
        grant_s = is_s & ~held_x & ~x_wins
        s_writer = grant_s & (fs == lane)   # the first S lane stamps for all
        _stamp(db.x_step, slot, grant_x, t_now)
        _stamp(db.s_step, slot, s_writer, t_now)
        if stamp_hot:
            # grant masks are one-writer-per-slot, so their hot subsets are
            # one-writer-per-mirror-index
            _stamp(db.hot_x, midx, grant_x & (midx >= 0), t_now)
            _stamp(db.hot_s, midx, s_writer & (midx >= 0), t_now)

        granted = (grant_x | grant_s).view(w, L)
        lock_rejected = (active & ~granted).any(dim=1)
        lead = l_op[:, 0] != 0
        alive = ~lock_rejected & lead

    if use_hotset and not use_fused and not stamp_hot:
        with waves.scope("smallbank_dense", "read"):
            raw_bal = gather_rows_hot(db.bal, db.hot_bal, flat_rows, midx, 1)

    with waves.scope("smallbank_dense", "compute"):
        bal = torch.where(granted, raw_bal.view(w, L), 0)
        nw, do, logic_abort, commit, committed = compute_phase(
            ttype, bal, alive, ts_amt)
        do_write = do & commit[:, None] & active
        bal_delta = u32.wrap_i32(torch.where(
            do_write, nw.to(torch.int64) - bal.to(torch.int64), 0).sum())

    if occupancy is not None:
        attempted = occ
    else:
        attempted = torch.full((), w if gen_new else 0, dtype=I32,
                               device=dev)
    new_ctx = BankCtx(
        rows=rows, do_write=do_write, nw=nw, tbl=l_tb, acc=l_ac,
        attempted=attempted,
        committed=committed.sum(dtype=I32),
        ab_lock=(lock_rejected & lead).sum(dtype=I32),
        ab_logic=logic_abort.sum(dtype=I32),
        magic_bad=torch.zeros((), dtype=I32, device=dev),
        bal_delta=bal_delta)

    # ---- wave 2 of c1: install + log x3 (locks expire by stamp) -----------
    with waves.scope("smallbank_dense",
                     "install_log" if use_fused else "install"):
        dwf = c1.do_write.reshape(-1)
        c1_rows, c1_tbl, c1_acc = (c1.rows.reshape(-1), c1.tbl.reshape(-1),
                                   c1.acc.reshape(-1))
        newbal = c1.nw.reshape(-1)
        newval = torch.stack([newbal, torch.where(dwf, MAGIC, 0).to(I32)],
                             dim=1)
        zero = torch.zeros_like(newbal)
        # log ver = step index: monotonic per row (one X writer per row a
        # step)
        stepv = torch.full_like(newbal, t_now)
        if use_hotset:
            w_midx = torch.where(dwf & (c1_acc < hn), c1_tbl * hn + c1_acc,
                                 -1)
        if use_fused:
            # install_log: balance install, log x3 append and (hot tier)
            # the mirror write-through as the streams of one launch; the log
            # plan routes masked lanes to -1 already
            lflat, entry3, lane_counts = logring.plan_rep(
                db.log, dwf, c1_tbl, zero, zero, c1_acc, stepv, newval)
            tabs = [db.bal, db.log.entries.view(-1)]
            idxs = [torch.where(dwf, c1_rows, -1), lflat.to(I32)]
            vals = [newbal, entry3.reshape(-1)]
            vws = [1, db.log.entries.shape[1]]
            if use_hotset:
                tabs.append(db.hot_bal)
                idxs.append(w_midx)
                vals.append(newbal)
                vws.append(1)
            scatter_streams(tabs, idxs, vals, vws)
            db.log.head = u32.wrap_i32(u32.to_u64(db.log.head) + lane_counts)
        elif use_hotset:
            scatter_rows_hot(db.bal, db.hot_bal, c1_rows, w_midx, dwf,
                             newbal, 1)
        else:
            keep = torch.nonzero(dwf).squeeze(1)
            db.bal[c1_rows[keep].long()] = newbal[keep]
    if not use_fused:
        with waves.scope("smallbank_dense", "log_append"):
            logring.append_rep(db.log, dwf, c1_tbl, zero, zero, c1_acc,
                               stepv, newval)

    db.step = t + 1
    out = (db, new_ctx, _stats_of(c1))
    grant_l = granted.reshape(-1)
    held_l = held_x | held_s            # [wL] slot stamped last step
    act_l = active.reshape(-1)
    if counters is not None:
        rej_l = act_l & ~grant_l
        upd = {}
        if use_hotset:
            # partition accounting: each partitioned gather serves its hot
            # lanes from the mirror; the fused route reads the main arrays,
            # so none of its gathers is partitioned. Refresh bytes are what
            # the JAX kernel route (use_pallas) counts.
            n_g = 0 if use_fused else 1 + (2 if stamp_hot else 0)
            hits = (midx >= 0).sum(dtype=I32)
            upd.update({mon.CTR_HOT_HITS: n_g * hits,
                        mon.CTR_HOT_COLD_ROWS: n_g * (w * L) - n_g * hits,
                        mon.CTR_HOT_REFRESH_BYTES: n_g * 2 * hn * 4})
        if occupancy is not None:
            upd.update({mon.CTR_SERVE_OCC_LANES: occ,
                        mon.CTR_SERVE_PAD_LANES: w - occ,
                        mon.CTR_SERVE_SHED_LANES: 0 if shed is None
                        else shed})
        n_writes = dwf.sum(dtype=I32)
        upd.update({
            mon.CTR_STEPS: 1,
            mon.CTR_TXN_ATTEMPTED: c1.attempted,
            mon.CTR_TXN_COMMITTED: c1.committed,
            mon.CTR_AB_LOCK: c1.ab_lock,
            mon.CTR_AB_LOGIC: c1.ab_logic,
            mon.CTR_MAGIC_BAD: c1.magic_bad,
            mon.CTR_LOCK_REQUESTS: act_l.sum(dtype=I32),
            mon.CTR_LOCK_GRANTED: grant_l.sum(dtype=I32),
            mon.CTR_LOCK_REJECTED: rej_l.sum(dtype=I32),
            mon.CTR_LOCK_REJECT_HELD: (rej_l & held_l).sum(dtype=I32),
            mon.CTR_LOCK_REJECT_ARB: (rej_l & ~held_l).sum(dtype=I32),
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
        # dinttrace: the new cohort's lock verdicts and outcome (txn id =
        # gen_step*w + lane, stable across waves) and c1's installs
        with waves.scope("smallbank_dense", "trace"):
            txn_new, txn_c1 = (txe.txn_ids(t - d, w, lane[:w])
                               for d in range(2))
            lock_aux = (torch.where(grant_l, txe.LOCK_GRANTED, 0)
                        | torch.where(held_l, txe.LOCK_HELD, 0))
            ab_lock_m = lock_rejected & lead
            cause = torch.where(
                ab_lock_m, txe.CAUSE_LOCK,
                torch.where(logic_abort, txe.CAUSE_LOGIC, txe.CAUSE_COMMIT))
            groups = (
                txe.ev(act_l, txn_new.repeat_interleave(L), txe.EV_LOCK,
                       waves.full_name("smallbank_dense", "lock"),
                       aux=lock_aux, step=t),
                txe.ev(committed | ab_lock_m | logic_abort, txn_new,
                       txe.EV_OUTCOME,
                       waves.full_name("smallbank_dense", "compute"),
                       aux=cause, step=t),
                txe.ev(dwf, txn_c1.repeat_interleave(L), txe.EV_INSTALL,
                       waves.full_name("smallbank_dense", "install"),
                       step=t),
            )
            txe.emit(ring, tcfg, groups, counters)
        out += (ring,)
    return out


def build_pipelined_runner(n_accounts: int, w: int = 8192,
                           cohorts_per_block: int = 8, hot_frac=None,
                           hot_prob=None, mix=None, use_hotset: bool = False,
                           use_fused: bool = False, monitor: bool = False,
                           trace=None, trace_rate=None, trace_cap=None,
                           serve: bool = False, device=None):
    """A loop of `pipe_step` over carry (db, c1); the contract of the JAX
    `build_pipelined_runner`: returns (run, init, drain).

    * ``run(carry, gen)`` draws a block's ``[cpb, w, 5]`` bits and
      ``[cpb, w]`` transact_saving amounts with the torch generator ``gen``
      on the device (in the ``gen`` wave's scope) and calls
      ``run.run_draws``;
    * ``run.run_draws(carry, bits, ts_amt)`` runs ``cohorts_per_block``
      steps on the given draws (int32 tensors on the runner's device; bits
      hold u32 patterns) and returns (carry, stats i32 [cpb, N_STATS]);
    * ``init(db)`` -> carry with one empty in-flight cohort; with
      ``use_hotset`` it first attaches the mirror of the workload's hot set
      (``hot_frac``, else SB_HOT_FRAC) to a bank that has none;
    * ``drain(carry)`` runs the flush step, which draws nothing, and
      returns (db, stats [1, N_STATS]).

    ``use_hotset``/``use_fused``: the route (`ROUTES`). ``serve``: the
    signatures become ``run(carry, gen, occ, shed)`` and
    ``run.run_draws(carry, bits, ts_amt, occ, shed)``, with ``occ`` and
    ``shed`` device i32 [cpb]: step i masks lanes >= occ[i] and mirrors
    shed[i] onto the counters; nothing is read back to the host.
    ``monitor``: the carry gains a trailing `monitor.counters.Counters`
    (made by ``init``), and ``drain`` returns (db, stats, counters).
    ``trace``/``trace_rate``/``trace_cap``: the dinttrace flight recorder
    (None = DINT_TRACE / DINT_TRACE_RATE). On, the carry gains a
    `monitor.txnevents.TxnRing` BEFORE the counters, zeroed at each block
    and drain entry; ``trace_cap`` defaults to a full block of candidates
    (w*(2L+1) a step); ``init.trace_cfg`` is the resolved `TraceCfg` (None
    when off), and ``drain`` returns (db, stats, ring[, counters])."""
    dev = resolve_device(device)
    if w * L >= BIG:
        raise ValueError(f"w={w} exceeds the lane field of the scatter-mins")
    cpb = cohorts_per_block
    hot_n = 0
    if use_hotset:
        frac = wl.SB_HOT_FRAC if hot_frac is None else float(hot_frac)
        hot_n = max(1, min(int(n_accounts * frac), n_accounts))
    trace_on = txe.trace_enabled(trace)
    tcfg = None
    n_step = w * (2 * L + 1)   # candidate events a step: lock wL +
    #                            outcome w + install wL
    if trace_on:
        cap = int(trace_cap) if trace_cap is not None else n_step * cpb
        tcfg = txe.TraceCfg(rate=txe.trace_rate(trace_rate), cap=cap,
                            wave=waves.full_name("smallbank_dense",
                                                 "trace"))
    kw = dict(w=w, n_accounts=n_accounts, hot_frac=hot_frac,
              hot_prob=hot_prob, mix=mix, use_hotset=use_hotset,
              use_fused=use_fused, tcfg=tcfg,
              consts=step_consts(w, mix, dev))

    def step(carry, bits, ts_amt, occ=None, shed=None, gen_new=True):
        # the ring and the counters are updated in place: carry[2:] holds
        # them after the step as before it
        out = pipe_step(carry[0], carry[1], bits, ts_amt, gen_new=gen_new,
                        occupancy=occ, shed=shed,
                        counters=carry[-1] if monitor else None,
                        ring=carry[2] if trace_on else None, **kw)
        return out[:2] + carry[2:], out[2]

    def run_draws(carry, bits, ts_amt, occ=None, shed=None):
        if tuple(bits.shape) != (cpb, w, 5) or \
                tuple(ts_amt.shape) != (cpb, w):
            raise ValueError(f"expected bits [{cpb}, {w}, 5] and ts_amt "
                             f"[{cpb}, {w}], got {tuple(bits.shape)} and "
                             f"{tuple(ts_amt.shape)}")
        if serve != (occ is not None and shed is not None):
            raise ValueError("a serve runner takes occ and shed [cpb]; a "
                             "closed-loop runner takes neither")
        if trace_on:        # each drained window is self-contained
            txe.reset(carry[2])
        stats = []
        for i in range(cpb):
            carry, s = step(carry, bits[i], ts_amt[i],
                            *((occ[i], shed[i]) if serve else ()))
            stats.append(s)
        return carry, torch.stack(stats)

    def run(carry, gen: torch.Generator, occ=None, shed=None):
        with waves.scope("smallbank_dense", "gen"):
            draws = draw_step(gen, (cpb, w), dev)
        return run_draws(carry, *draws, occ, shed)

    run.run_draws = run_draws

    def init(db: DenseBank):
        if db.bal.device.type != dev.type:
            raise ValueError(f"tables on {db.bal.device}, runner on {dev}")
        if use_hotset and db.hot_n == 0:
            db = attach_hotset(db, hot_n)
        return ((db, empty_ctx(w, dev))
                + ((txe.create_ring(tcfg.cap, dev, spill=n_step),)
                   if trace_on else ())
                + ((mon.create(dev),) if monitor else ()))

    init.trace_cfg = tcfg

    def drain(carry):
        if trace_on:
            txe.reset(carry[2])
        carry, s = step(carry, None, None, gen_new=False)
        return (carry[0], s[None]) + carry[2:]

    return run, init, drain
