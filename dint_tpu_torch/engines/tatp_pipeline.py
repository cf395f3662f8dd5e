"""The TATP transaction pipeline over three replicated shard servers (the
port of `dint_tpu.engines.tatp_pipeline`): cohort generation and the
wave-1 outcome rules, which the dense engine shares, and the generic
engine's pipelines over `tatp.step`.

A cohort of w txns runs three waves against the three replicas, each a
`tatp.step` per replica: wave 1 reads the read-set and locks the
write-set at each key's owner shard (key % 3), wave 2 re-reads the
read-set of the surviving read-write txns (validation), wave 3 appends
the log on all shards and installs at the owner (PRIM) and the backups
(BCK), or unlocks the granted locks of a dead txn (ABORT). `cohort_step`
runs the three waves of one cohort in turn; `pipe_step` runs wave 1 of a
new cohort, wave 2 of the one before and wave 3 of the one before that
in one combined batch, so that commits land between other txns' reads
and validations (ab_validate is live).

What differs from JAX:

* Draws are fed, not made: a cohort consumes ``bits`` [w, 4] (its txns,
  `gen_cohort_from_bits`) and ``payload`` [w, 2] (the installed values).
  The runners draw both with a `torch.Generator` (``run(carry, gen)``) or
  take them as given (``run.run_draws``, ``drain(carry, payload)``), so
  the tests replay JAX's `jax.random` draws.
* The three replicas are a list of three `tatp.Shard`s with storage of
  their own (JAX stacks them on a leading axis and vmaps `tatp.step`); a
  step updates each in place, in turn, on the same batch lanes, so they
  stay bit-identical.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..clients import workloads as wl
from ..device import resolve_device
from ..monitor import counters as mon
from ..monitor import waves
from ..ops.u32 import i32_bits, to_u64, wrap_i32
from . import tatp
from .types import PAD_KEY, Batch, Op, Replies, Reply

I32 = torch.int32

N_SHARDS = 3
K = 4                  # wave-1 lanes per txn
MAGIC = 0x7A79         # parity with the reference client's magic word

# stats vector layout
STAT_ATTEMPTED = 0
STAT_COMMITTED = 1
STAT_AB_LOCK = 2
STAT_AB_MISSING = 3
STAT_AB_VALIDATE = 4
STAT_MAGIC_BAD = 5
N_STATS = 6


# Lane layout per txn type (tatp/caladan/tatp.h:45-63), as lookup tables so
# that a cohort is laid out by a few gathers on its type column: per type
# and lane, the op, the table, and which key the lane uses (_KEY_*).
_KEY_NONE, _KEY_SID, _KEY_SF, _KEY_CF = 0, 1, 2, 3
_R, _L = Op.OCC_READ, Op.OCC_LOCK
_T = tatp
_LANES = {   # txn type -> [(op, table, key)] for lanes 0.., NOP lanes after
    wl.TATP_GET_SUBSCRIBER: [(_R, _T.SUBSCRIBER, _KEY_SID)],
    wl.TATP_GET_ACCESS: [(_R, _T.ACCESS_INFO, _KEY_SF)],   # ai_idx == sf_idx
    wl.TATP_GET_NEW_DEST: [(_R, _T.SPECIAL_FACILITY, _KEY_SF),
                           (_R, _T.CALL_FORWARDING, _KEY_CF)],
    wl.TATP_UPDATE_SUBSCRIBER: [(_R, _T.SUBSCRIBER, _KEY_SID),
                                (_R, _T.SPECIAL_FACILITY, _KEY_SF),
                                (_L, _T.SUBSCRIBER, _KEY_SID),
                                (_L, _T.SPECIAL_FACILITY, _KEY_SF)],
    wl.TATP_UPDATE_LOCATION: [(_R, _T.SEC_SUBSCRIBER, _KEY_SID),
                              (_R, _T.SUBSCRIBER, _KEY_SID),
                              (_L, _T.SUBSCRIBER, _KEY_SID)],
    wl.TATP_INSERT_CF: [(_R, _T.SPECIAL_FACILITY, _KEY_SF),
                        (_R, _T.CALL_FORWARDING, _KEY_CF),
                        (_L, _T.CALL_FORWARDING, _KEY_CF)],
    wl.TATP_DELETE_CF: [(_R, _T.CALL_FORWARDING, _KEY_CF),
                        (_L, _T.CALL_FORWARDING, _KEY_CF)],
}
# write slots (== lock lanes) per type: (active, lane_idx, table, key,
# kind); kind 0 = commit (dense install), 1 = insert (CF), 2 = delete (CF).
# Slot 0 is the row lock of US/UL (subscriber) or IC/DC (CF); slot 1 the
# sf lock of US. Inactive slots keep the values the JAX layout gives them.
_US, _UL = wl.TATP_UPDATE_SUBSCRIBER, wl.TATP_UPDATE_LOCATION
_IC, _DC = wl.TATP_INSERT_CF, wl.TATP_DELETE_CF
_WS = {t: [(t in (_US, _UL, _IC, _DC), 1 if t == _DC else 2,
            _T.SUBSCRIBER if t in (_US, _UL) else _T.CALL_FORWARDING,
            _KEY_SID if t in (_US, _UL) else _KEY_CF,
            {_IC: 1, _DC: 2}.get(t, 0)),
           (t == _US, 3, _T.SPECIAL_FACILITY, _KEY_SF, 0)]
       for t in range(7)}


def _lane_tables() -> np.ndarray:
    """[7, K, 3] (op, table, key selector) per txn type and lane."""
    lanes = np.zeros((7, K, 3), np.int64)
    for t, spec in _LANES.items():
        lanes[t, :len(spec)] = spec
    return lanes


@dataclass
class CohortTables:
    """Device constants of cohort generation, made once per runner so that
    no step copies host data to the device (a copy from pageable host
    memory synchronises the stream)."""
    thresh: torch.Tensor   # i64 [7] cumulative u32 txn-mix thresholds
    lane_op: torch.Tensor  # i32 [7, K]
    lane_tbl: torch.Tensor  # i32 [7, K]
    lane_key: torch.Tensor  # i64 [7, K] key selector
    ws: torch.Tensor       # i32 [7, 2, 5] write-slot fields (_WS)
    ws_key: torch.Tensor   # i64 [7, 2] key selector of each write slot


def cohort_tables(mix, device) -> CohortTables:
    lanes = _lane_tables()
    ws = np.asarray([_WS[t] for t in range(7)], np.int64)     # [7, 2, 5]
    dev = torch.device(device)

    def put(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev)

    return CohortTables(
        thresh=put(wl.mix_thresholds(wl.TATP_MIX if mix is None else mix)
                   .astype(np.int64), torch.int64),
        lane_op=put(lanes[..., 0], I32), lane_tbl=put(lanes[..., 1], I32),
        lane_key=put(lanes[..., 2], torch.int64),
        ws=put(ws, I32), ws_key=put(ws[..., 3], torch.int64))


def draw_bits(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Uniform u32 words (int32-carried) drawn with ``gen`` on ``device``."""
    return wrap_i32(torch.randint(0, 1 << 32, shape, dtype=torch.int64,
                                  generator=gen, device=device))


def gen_cohort_from_bits(bits: torch.Tensor, w: int, n_sub: int, mix=None,
                         tables: CohortTables | None = None):
    """Workload generation (tatp/caladan/tatp.h:40-63) from one [w, 4] u32
    draw: word 0 picks the txn type by searchsorted over the cumulative mix
    (side="right", clamped to 6), words 1-2 make the NURand subscriber id,
    word 3 the ai/sf type and CF start time; each type's lanes and write
    slots come from the per-type tables. ``tables`` (`cohort_tables` of
    ``mix`` on the device) may be passed in so that a loop of steps copies
    them to the device once.

    Returns (ttype [w], ops/tbl/kk [w, K], (ws_active, ws_lane, ws_tbl,
    ws_key, ws_kind) [w, 2]); int32 / bool tensors on ``bits.device``."""
    if tables is None:
        tables = cohort_tables(mix, bits.device)
    b = to_u64(bits)                                    # u32 values in int64
    ttype = torch.searchsorted(tables.thresh, b[:, 0].contiguous(),
                               right=True).clamp(max=6)
    # NURand: ((x | y) % n) + 1, each word reduced as u32 before use
    x = b[:, 1] % (wl.TATP_A + 1)
    y = b[:, 2] % n_sub + 1
    s_id = ((x | y) % n_sub) + 1
    kx = b[:, 3]
    xtype = kx % 4 + 1                        # ai_type / sf_type 1..4
    stime = ((kx >> 2) % 3) * 8               # logical shift: 0 / 8 / 16
    sf_idx = s_id * 4 + (xtype - 1)
    cfk = tatp.cf_key(s_id, xtype, stime)
    keys = torch.stack([torch.zeros_like(s_id), s_id, sf_idx, cfk],
                       dim=1).to(I32)                   # by _KEY_* selector

    ops = tables.lane_op[ttype]
    tbl = tables.lane_tbl[ttype]
    kk = keys.gather(1, tables.lane_key[ttype])
    ws = tables.ws[ttype]                               # [w, 2, 5]
    ws_key = keys.gather(1, tables.ws_key[ttype])
    return ttype.to(I32), ops, tbl, kk, (
        ws[..., 0] != 0, ws[..., 1], ws[..., 2], ws_key, ws[..., 4])


def classify_wave1(ttype, rt, ops, ws_active, ws_lane, ws_rt=None):
    """Per-txn-type wave-1 outcome rules (client_ebpf_shard.cc:608-703):
    read-only commit on success, REJECT -> lock abort, required-row absence
    or insert-exists -> missing abort. Returns (is_ro, rw, granted [w,2],
    lock_rejected, missing), masked to txns whose lane 0 is not a NOP.

    ``ws_rt`` [w, 2]: write-slot reply types; defaults to gathering rt at
    ws_lane."""
    t = ttype
    live = ops[:, 0] != Op.NOP
    is_ro = ((t == wl.TATP_GET_SUBSCRIBER) | (t == wl.TATP_GET_ACCESS)
             | (t == wl.TATP_GET_NEW_DEST)) & live
    rw = live & ~is_ro

    if ws_rt is None:
        ws_rt = torch.take_along_dim(rt, ws_lane.to(torch.int64), dim=1)
    granted = ws_active & (ws_rt == Reply.GRANT)
    rejected = (ws_rt == Reply.REJECT) | (ws_rt == Reply.REJECT_SAME_KEY)
    lock_rejected = (ws_active & rejected).any(dim=1)

    not_val0 = rt[:, 0] != Reply.VAL
    not_val1 = rt[:, 1] != Reply.VAL
    missing = (t == wl.TATP_GET_ACCESS) & not_val0
    missing |= (t == wl.TATP_GET_NEW_DEST) & (not_val0 | not_val1)
    missing |= (((t == wl.TATP_UPDATE_SUBSCRIBER)
                 | (t == wl.TATP_UPDATE_LOCATION)) & (not_val0 | not_val1))
    missing |= (t == wl.TATP_INSERT_CF) & (not_val0 | ~not_val1)
    missing |= (t == wl.TATP_DELETE_CF) & not_val0
    missing &= live
    return is_ro, rw, granted, lock_rejected, missing


# ------------------------------------------------ the generic engine's pipes

PAD32 = i32_bits(PAD_KEY)      # the pad key's low word as int32 bits


def stack_shards(shards) -> list:
    """The three replicas as one list; each must own its storage, since the
    steps update them in place."""
    shards = list(shards)
    if len(shards) != N_SHARDS:
        raise ValueError(f"expected {N_SHARDS} replicas, got {len(shards)}")
    ptrs = [s.sub.val.data_ptr() for s in shards]
    if len(set(ptrs)) != len(ptrs):
        raise ValueError("replicas share storage")
    return shards


def _broadcast_batch(op_s, table, key_lo, val, ver):
    """Per-shard ops [S, R] + shared lane fields [R] -> one Batch a shard."""
    key_hi = torch.zeros_like(key_lo)
    return [Batch(op=op_s[s], table=table, key_hi=key_hi, key_lo=key_lo,
                  val=val, ver=ver) for s in range(op_s.shape[0])]


def _step_all(step_fn, stacked, batches) -> Replies:
    """``step_fn`` (an engine's step) of each replica on its batch, in
    place, one replica after another (JAX vmaps it over the stacked
    replicas); the replies stacked [S, R...]."""
    reps = []
    for s, b in enumerate(batches):
        stacked[s], rep = step_fn(stacked[s], b)
        reps.append(rep)
    return Replies(rtype=torch.stack([r.rtype for r in reps]),
                   val=torch.stack([r.val for r in reps]),
                   ver=torch.stack([r.ver for r in reps]))


def _merge(owner, stacked):
    """Each lane's reply from its owner shard: [S, R...] -> [R...]."""
    r = owner.shape[0]
    return stacked[owner.long(), torch.arange(r, device=owner.device)]


def _owner_ops(owner, used, lane_op):
    """[S, R]: each lane's op at its owner shard, NOP elsewhere."""
    sid = torch.arange(N_SHARDS, dtype=I32, device=owner.device)
    return torch.where((owner[None] == sid[:, None]) & used[None],
                       lane_op[None], Op.NOP)


def _wave1_lanes(ops, tbl, kk):
    """Flat wave-1 lane arrays + owner routing ([r] each, r = w*K)."""
    r = ops.shape[0] * K
    lane_op = ops.reshape(r)
    used = lane_op != Op.NOP
    # NOP lanes get the pad key so they never join a real key's segment
    lane_key = torch.where(used, kk.reshape(r), PAD32)
    owner = kk.reshape(r) % N_SHARDS
    return lane_op, tbl.reshape(r), lane_key, owner, used


@dataclass
class PipeCtx:
    """An in-flight cohort between pipeline stages (all [w]-shaped unless
    noted). Bootstrap cohorts have attempted == 0 and all-False masks, so
    they contribute NOP lanes and zero stats."""
    ops: torch.Tensor        # i32 [w, K] wave-1 lane ops
    tbl: torch.Tensor        # i32 [w, K]
    kk: torch.Tensor         # i32 [w, K] lane keys
    rver1: torch.Tensor      # i32 [w, K] u32 versions read at wave 1
    rt1_val: torch.Tensor    # bool [w, K] lane replied VAL at wave 1
    granted: torch.Tensor    # bool [w, 2] write-slot locks granted
    alive: torch.Tensor      # bool [w] still commit-eligible
    ro_commit: torch.Tensor  # bool [w] read-only txn that succeeded
    ws_active: torch.Tensor  # bool [w, 2]
    ws_tbl: torch.Tensor     # i32 [w, 2]
    ws_key: torch.Tensor     # i32 [w, 2]
    ws_kind: torch.Tensor    # i32 [w, 2] 0 commit / 1 insert / 2 delete
    attempted: torch.Tensor  # i32 scalar (w, or 0 for bootstrap)
    ab_lock: torch.Tensor    # i32 scalar
    ab_missing: torch.Tensor  # i32 scalar
    ab_validate: torch.Tensor  # i32 scalar (set by the validate stage)
    magic_bad: torch.Tensor  # i32 scalar


def empty_ctx(w: int, device) -> PipeCtx:
    dev = torch.device(device)

    def z(shape, dt=I32):
        return torch.zeros(shape, dtype=dt, device=dev)

    b = torch.bool
    return PipeCtx(ops=z((w, K)), tbl=z((w, K)), kk=z((w, K)),
                   rver1=z((w, K)), rt1_val=z((w, K), b), granted=z((w, 2), b),
                   alive=z((w,), b), ro_commit=z((w,), b),
                   ws_active=z((w, 2), b), ws_tbl=z((w, 2)),
                   ws_key=z((w, 2)), ws_kind=z((w, 2)), attempted=z(()),
                   ab_lock=z(()), ab_missing=z(()), ab_validate=z(()),
                   magic_bad=z(()))


def _validate_lanes(ops, tbl, kk, alive):
    """Wave-2 lane arrays for an in-flight cohort: re-read the read-set of
    surviving RW txns (and of nothing else)."""
    r = alive.shape[0] * K
    is_read_lane = (ops == Op.OCC_READ) & alive[:, None]
    v_used = is_read_lane.reshape(r)
    v_op = torch.where(v_used, Op.OCC_READ, Op.NOP).to(I32)
    v_key = torch.where(v_used, kk.reshape(r), PAD32)
    owner = kk.reshape(r) % N_SHARDS
    return v_op, tbl.reshape(r), v_key, owner, v_used, is_read_lane


def _wave3_lanes(ws_active, ws_tbl, ws_key, ws_kind, granted, alive,
                 payload, val_words: int):
    """Wave-3 lane arrays for a validated cohort (4w lanes: log ws0 | log
    ws1 | role ws0 | role ws1) from its write slots [w, 2], granted locks
    and alive mask; ``payload`` [w, 2] i32 is value word 0 of each write
    slot. Returns (op_s [S, 4w], tbl, key, val)."""
    w = alive.shape[0]
    dev = alive.device
    sid = torch.arange(N_SHARDS, dtype=I32, device=dev)
    w_owner = ws_key % N_SHARDS                            # [w, 2]
    do_write = ws_active & alive[:, None]
    newval = torch.zeros((w, 2, val_words), dtype=I32, device=dev)
    newval[:, :, 0] = payload
    newval[:, :, 1] = torch.where(do_write, MAGIC, 0)

    kind = ws_kind
    log_op = torch.where(do_write, torch.where(kind == 2, Op.DELETE_LOG,
                                               Op.COMMIT_LOG), Op.NOP)
    prim_op = torch.where(kind == 1, Op.INSERT_PRIM, torch.where(
        kind == 2, Op.DELETE_PRIM, Op.COMMIT_PRIM))
    bck_op = torch.where(kind == 1, Op.INSERT_BCK, torch.where(
        kind == 2, Op.DELETE_BCK, Op.COMMIT_BCK))
    # role op per shard s: owner -> prim; others -> bck; dead+granted ->
    # ABORT at the owner
    dead_abort = granted & ~alive[:, None]
    at_owner = w_owner[None] == sid[:, None, None]
    role_s = torch.where(
        do_write[None], torch.where(at_owner, prim_op[None], bck_op[None]),
        torch.where(dead_abort[None] & at_owner, Op.ABORT, Op.NOP))

    c_key = torch.where(do_write | dead_abort, ws_key, PAD32)
    lane_key = torch.cat([c_key[:, 0], c_key[:, 1], c_key[:, 0], c_key[:, 1]])
    lane_tbl = torch.cat([ws_tbl[:, 0], ws_tbl[:, 1],
                          ws_tbl[:, 0], ws_tbl[:, 1]])
    lane_val = torch.cat([newval[:, 0], newval[:, 1],
                          newval[:, 0], newval[:, 1]])
    op_s = torch.cat([log_op[:, 0][None].expand(N_SHARDS, w),
                      log_op[:, 1][None].expand(N_SHARDS, w),
                      role_s[:, :, 0], role_s[:, :, 1]], dim=1).to(I32)
    return op_s, lane_tbl, lane_key, lane_val


def _count(x) -> torch.Tensor:
    return x.sum(dtype=I32)


def cohort_step(stacked, bits, payload, *, w: int, n_sub: int,
                val_words: int, validate: bool = True,
                tables: CohortTables | None = None):
    """One full cohort of w txns (``bits`` [w, 4], wave-3 ``payload`` [w, 2])
    against the three replicas, waves in turn; in place.

    ``validate`` keeps the reference protocol's wave-2 re-read
    (client_ebpf_shard.cc:688-768). Cohorts run one after another here, so
    no commit lands between a txn's read and its validation: ab_validate
    is structurally 0, and the wave is kept to pay the same per-txn work
    the reference client pays. Returns (stacked, stats [N_STATS] i32)."""
    dev = bits.device
    ttype, ops, tbl, kk, ws = gen_cohort_from_bits(bits, w, n_sub,
                                                   tables=tables)
    ws_active, ws_lane = ws[0], ws[1]
    lane_op, lane_tbl, lane_key, owner, used = _wave1_lanes(ops, tbl, kk)
    r = w * K
    zval = torch.zeros((r, val_words), dtype=I32, device=dev)
    zver = torch.zeros((r,), dtype=I32, device=dev)

    # ---- wave 1: read + lock at owners
    rep1 = _step_all(tatp.step, stacked, _broadcast_batch(
        _owner_ops(owner, used, lane_op), lane_tbl, lane_key, zval, zver))
    rt1 = _merge(owner, rep1.rtype).view(w, K)
    rv1 = _merge(owner, rep1.val)
    rver1 = _merge(owner, rep1.ver).view(w, K)
    magic_bad = _count((rt1.reshape(r) == Reply.VAL) & (rv1[:, 1] != MAGIC))

    # generated cohorts always have a lane-0 op, so classify_wave1's NOP
    # guard is vacuous here
    is_ro, rw, granted, lock_rejected, missing = classify_wave1(
        ttype, rt1, ops, ws_active, ws_lane)
    ab_lock = rw & lock_rejected
    ab_missing = rw & ~lock_rejected & missing
    alive = rw & ~lock_rejected & ~missing

    # ---- wave 2: validate the read-set of surviving RW txns
    if validate:
        v_op, v_tbl, v_key, v_owner, v_used, is_read_lane = \
            _validate_lanes(ops, tbl, kk, alive)
        rep2 = _step_all(tatp.step, stacked, _broadcast_batch(
            _owner_ops(v_owner, v_used, v_op), v_tbl, v_key, zval, zver))
        vrt = _merge(v_owner, rep2.rtype).view(w, K)
        vver = _merge(v_owner, rep2.ver).view(w, K)
        bad_lane = is_read_lane & ((vver != rver1) | (
            (vrt != Reply.VAL) & (rt1 == Reply.VAL)))
        changed = bad_lane.any(dim=1)
    else:
        changed = torch.zeros((w,), dtype=torch.bool, device=dev)
    ab_validate = alive & changed
    alive = alive & ~changed

    # ---- wave 3: log block + role block (prim/bck/abort)
    op3_s, lane3_tbl, lane3_key, lane3_val = _wave3_lanes(
        ws_active, ws[2], ws[3], ws[4], granted, alive, payload, val_words)
    _step_all(tatp.step, stacked, _broadcast_batch(
        op3_s, lane3_tbl, lane3_key, lane3_val,
        torch.zeros((w * 4,), dtype=I32, device=dev)))

    committed = (is_ro & ~missing) | alive
    stats = torch.stack([
        torch.full((), w, dtype=I32, device=dev), _count(committed),
        _count(ab_lock), _count(ab_missing | (is_ro & missing)),
        _count(ab_validate), magic_bad])
    return stacked, stats


def pipe_step(stacked, c1: PipeCtx, c2: PipeCtx, bits, payload, *, w: int,
              n_sub: int, val_words: int, gen_new: bool = True, mix=None,
              counters: mon.Counters | None = None,
              tables: CohortTables | None = None):
    """One pipelined step: wave 1 of a NEW cohort (``bits`` [w, 4], unused
    when ``gen_new`` is False, which feeds an empty cohort to drain the
    pipeline) + wave 2 of c1 + wave 3 of c2 (``payload`` [w, 2]), in one
    batch a replica, in place. Returns (stacked, new_ctx, c1', stats of
    c2), plus the counters when ``counters`` is given.

    ``counters`` (bumped in place): the engine-independent parity counters
    (txn outcomes, lock grant/reject, validate lanes/failures, installs
    and log appends), JAX's definitions; the held-vs-arb reject split and
    the ring gauge are dense-engine observables and stay 0 here."""
    dev = payload.device
    r = w * K
    if gen_new:
        with waves.scope("tatp_pipeline", "gen"):
            ttype, ops, tbl, kk, ws = gen_cohort_from_bits(bits, w, n_sub,
                                                           mix=mix,
                                                           tables=tables)
        ws_active, ws_lane, ws_tbl, ws_key, ws_kind = ws
    else:
        e = empty_ctx(w, dev)
        ttype = torch.zeros((w,), dtype=I32, device=dev)
        ops, tbl, kk = e.ops, e.tbl, e.kk
        ws_active, ws_lane = e.ws_active, torch.zeros_like(e.ws_tbl)
        ws_tbl, ws_key, ws_kind = e.ws_tbl, e.ws_key, e.ws_kind

    # ---- assemble the combined batch [12w lanes]
    with waves.scope("tatp_pipeline", "assemble"):
        a_op, a_tbl, a_key, a_owner, a_used = _wave1_lanes(ops, tbl, kk)
        b_op, b_tbl, b_key, b_owner, b_used, is_read_lane = _validate_lanes(
            c1.ops, c1.tbl, c1.kk, c1.alive)
        c_op_s, c_tbl, c_key, c_val = _wave3_lanes(
            c2.ws_active, c2.ws_tbl, c2.ws_key, c2.ws_kind, c2.granted,
            c2.alive,
            payload, val_words)
        lane_tbl = torch.cat([a_tbl, b_tbl, c_tbl])
        lane_key = torch.cat([a_key, b_key, c_key])
        lane_val = torch.cat([torch.zeros((2 * r, val_words), dtype=I32,
                                          device=dev), c_val])
        op_s = torch.cat([_owner_ops(a_owner, a_used, a_op),
                          _owner_ops(b_owner, b_used, b_op), c_op_s], dim=1)
    with waves.scope("tatp_pipeline", "engine_step"):
        rep = _step_all(tatp.step, stacked, _broadcast_batch(
            op_s, lane_tbl, lane_key, lane_val, torch.zeros_like(lane_key)))

    # ---- wave-1 outcome for the new cohort
    with waves.scope("tatp_pipeline", "classify"):
        rtA = _merge(a_owner, rep.rtype[:, :r]).view(w, K)
        rvA = _merge(a_owner, rep.val[:, :r])
        rverA = _merge(a_owner, rep.ver[:, :r]).view(w, K)
        magic_bad = _count((rtA.reshape(r) == Reply.VAL)
                           & (rvA[:, 1] != MAGIC))
        is_ro, rw, granted, lock_rejected, missing = classify_wave1(
            ttype, rtA, ops, ws_active, ws_lane)
        new_ctx = PipeCtx(
            ops=ops, tbl=tbl, kk=kk, rver1=rverA, rt1_val=rtA == Reply.VAL,
            granted=granted, alive=rw & ~lock_rejected & ~missing,
            ro_commit=is_ro & ~missing, ws_active=ws_active, ws_tbl=ws_tbl,
            ws_key=ws_key, ws_kind=ws_kind,
            attempted=torch.full((), w if gen_new else 0, dtype=I32,
                                 device=dev),
            ab_lock=_count(rw & lock_rejected),
            ab_missing=_count((rw & ~lock_rejected & missing)
                              | (is_ro & missing)),
            ab_validate=torch.zeros((), dtype=I32, device=dev),
            magic_bad=magic_bad)

        # ---- validate outcome for c1
        rtB = _merge(b_owner, rep.rtype[:, r:2 * r]).view(w, K)
        rverB = _merge(b_owner, rep.ver[:, r:2 * r]).view(w, K)
        bad_lane = is_read_lane & ((rverB != c1.rver1)
                                   | ((rtB != Reply.VAL) & c1.rt1_val))
        changed = bad_lane.any(dim=1)
        c1 = dataclasses.replace(c1, alive=c1.alive & ~changed,
                                 ab_validate=_count(c1.alive & changed))

        # ---- c2 completed: its stats
        stats = torch.stack([c2.attempted, _count(c2.ro_commit | c2.alive),
                             c2.ab_lock, c2.ab_missing, c2.ab_validate,
                             c2.magic_bad])
    if counters is None:
        return stacked, new_ctx, c1, stats
    n_writes = _count(c2.ws_active & c2.alive[:, None])  # wave-3 do_write
    mon.bump(counters, {
        mon.CTR_STEPS: 1,
        mon.CTR_TXN_ATTEMPTED: stats[STAT_ATTEMPTED],
        mon.CTR_TXN_COMMITTED: stats[STAT_COMMITTED],
        mon.CTR_AB_LOCK: c2.ab_lock,
        mon.CTR_AB_MISSING: c2.ab_missing,
        mon.CTR_AB_VALIDATE: c2.ab_validate,
        mon.CTR_MAGIC_BAD: c2.magic_bad,
        mon.CTR_LOCK_REQUESTS: _count(ws_active),
        mon.CTR_LOCK_GRANTED: _count(granted),
        mon.CTR_LOCK_REJECTED: _count(ws_active & ~granted),
        mon.CTR_VALIDATE_LANES: _count(is_read_lane),
        mon.CTR_VALIDATE_FAILED: _count(bad_lane),
        mon.CTR_INSTALL_WRITES: n_writes,
        mon.CTR_LOG_APPENDS: n_writes,
        mon.CTR_DISPATCH_XLA: 1,    # the plain route, JAX's XLA one
    })
    return stacked, new_ctx, c1, stats, counters


def _draw_block(gen, cpb: int, w: int, dev):
    """A block's draws: bits [cpb, w, 4] and payload [cpb, w, 2]."""
    bits = draw_bits(gen, (cpb, w, 4), dev)
    payload = torch.randint(0, 1 << 16, (cpb, w, 2), dtype=I32,
                            generator=gen, device=dev)
    return bits, payload


def _check_draws(bits, payload, cpb: int, w: int):
    if tuple(bits.shape) != (cpb, w, 4) or \
            tuple(payload.shape) != (cpb, w, 2):
        raise ValueError(f"expected bits [{cpb}, {w}, 4] and payload "
                         f"[{cpb}, {w}, 2], got {tuple(bits.shape)} and "
                         f"{tuple(payload.shape)}")


def _check_replicas(stacked, dev):
    if len(stacked) != N_SHARDS:
        raise ValueError(f"expected {N_SHARDS} replicas, got {len(stacked)}")
    if stacked[0].sub.ver.device.type != dev.type:
        raise ValueError(f"tables on {stacked[0].sub.ver.device}, runner "
                         f"on {dev}")


def build_pipelined_runner(n_sub: int, w: int = 4096, val_words: int = 10,
                           cohorts_per_block: int = 8, mix=None,
                           monitor: bool = False, device=None):
    """A loop of `pipe_step` over carry (stacked, c1, c2): returns (run,
    init, drain), the contract of the JAX runner with the draws fed.

    * ``run(carry, gen)`` draws a block's bits [cpb, w, 4] and payloads
      [cpb, w, 2] with the torch generator ``gen`` and calls
      ``run.run_draws``;
    * ``run.run_draws(carry, bits, payload)`` runs ``cohorts_per_block``
      steps on the given draws and returns (carry, stats [cpb, N_STATS]);
    * ``init(stacked)`` -> carry with two empty cohorts in flight;
    * ``drain(carry, payload=None)`` runs the two flush steps and returns
      (stacked, stats [2, N_STATS]); ``payload`` [2, w, 2] fills c2's and
      c1's installs (drawn from a generator seeded 0 when None; JAX draws
      both from PRNGKey(0)).

    ``monitor``: the carry gains a trailing `monitor.counters.Counters`
    (made by ``init``), and ``drain`` returns (stacked, stats, counters)."""
    dev = resolve_device(device)
    cpb = cohorts_per_block
    kw = dict(w=w, n_sub=n_sub, val_words=val_words, mix=mix,
              tables=cohort_tables(mix, dev))

    def step(carry, bits, payload, gen_new=True):
        out = pipe_step(*carry[:3], bits, payload, gen_new=gen_new,
                        counters=carry[3] if monitor else None, **kw)
        return out[:3] + out[4:], out[3]

    def run_draws(carry, bits, payload):
        _check_draws(bits, payload, cpb, w)
        stats = []
        for i in range(cpb):
            carry, s = step(carry, bits[i], payload[i])
            stats.append(s)
        return carry, torch.stack(stats)

    def run(carry, gen: torch.Generator):
        return run_draws(carry, *_draw_block(gen, cpb, w, dev))

    run.run_draws = run_draws

    def init(stacked):
        _check_replicas(stacked, dev)
        return ((list(stacked), empty_ctx(w, dev), empty_ctx(w, dev))
                + ((mon.create(dev),) if monitor else ()))

    def drain(carry, payload=None):
        if payload is None:
            payload = _draw_block(torch.Generator(device=dev).manual_seed(0),
                                  2, w, dev)[1]
        carry, s1 = step(carry, None, payload[0], gen_new=False)
        carry = (carry[0], empty_ctx(w, dev)) + carry[2:]
        carry, s2 = step(carry, None, payload[1], gen_new=False)
        return (carry[0], torch.stack([s1, s2])) + carry[3:]

    return run, init, drain


def build_runner(n_sub: int, w: int = 4096, val_words: int = 10,
                 cohorts_per_block: int = 8, validate: bool = True,
                 device=None):
    """A loop of `cohort_step`: ``run(stacked, gen)`` draws a block's bits
    [cpb, w, 4] and payloads [cpb, w, 2] with ``gen`` and runs
    ``cohorts_per_block`` cohorts one after another, in place; returns
    (stacked, stats [cpb, N_STATS]). ``run.run_draws(stacked, bits,
    payload)`` takes the draws as given."""
    dev = resolve_device(device)
    cpb = cohorts_per_block
    kw = dict(w=w, n_sub=n_sub, val_words=val_words, validate=validate,
              tables=cohort_tables(None, dev))

    def run_draws(stacked, bits, payload):
        _check_replicas(stacked, dev)
        _check_draws(bits, payload, cpb, w)
        stats = []
        for i in range(cpb):
            stacked, s = cohort_step(stacked, bits[i], payload[i], **kw)
            stats.append(s)
        return stacked, torch.stack(stats)

    def run(stacked, gen: torch.Generator):
        return run_draws(stacked, *_draw_block(gen, cpb, w, dev))

    run.run_draws = run_draws
    return run
