"""TATP cohort generation and the shared wave-1 outcome rules (the dense
engine's part of `dint_tpu.engines.tatp_pipeline`).

`gen_cohort_from_bits` is the pure function of one ``[w, 4]`` u32 draw; the
JAX `gen_cohort` makes that draw itself with `jax.random.bits`. The port
draws with a `torch.Generator` instead (`draw_bits`), so it gives other
cohorts than JAX from the same seed, and the tests feed both the same bits.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..clients import workloads as wl
from ..ops.u32 import to_u64, wrap_i32
from . import tatp
from .types import Op, Reply

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
