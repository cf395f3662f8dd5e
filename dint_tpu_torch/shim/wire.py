"""Wire-code profiles (the port of `dint_tpu.shim.wire`): each reference
workload's packet-type enum to the engines' op codes and back.

The reference gives each workload family its own packet-type enum; the
engines share one Op/Reply vocabulary (`engines.types`). A `Profile` maps a
whole polled batch both ways with numpy lookups. ``rep_map`` is indexed by
the Reply code, so the port's Reply values are JAX's. Wire enum sources:
  store      store/ebpf/utils.h:22-32
  lock_2pl   lock_2pl/ebpf/utils.h:9-17
  lock_fasst lock_fasst/ebpf/utils.h:9-17
  log_server log_server/ebpf/utils.h:11-12
  smallbank  smallbank/caladan/proto.h:14-37
  tatp       tatp/ebpf/utils.h:38-73
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..engines.types import Op, Reply
from .native import FMT_FASST9, FMT_LOCK6, FMT_LOG53, FMT_MSG55

N_WIRE = 64   # wire codes are u8; 64 covers every reference enum
N_REPLY = 16  # room over the Reply codes (0..9)


@dataclasses.dataclass(frozen=True)
class Profile:
    """req_map[wire_type] -> Op;  rep_map[wire_req_type, Reply] -> wire code.

    Entries are -1 where undefined: an unknown request becomes a NOP lane,
    and an undefined reply goes out as 255, a code no reference enum uses.
    """
    name: str
    fmt: int
    req_map: np.ndarray   # i32 [N_WIRE]
    rep_map: np.ndarray   # i32 [N_WIRE, N_REPLY]

    def to_ops(self, wire_type: np.ndarray, wire_table: np.ndarray):
        """(wire type, wire table) -> engine op array."""
        return self.req_map[np.minimum(wire_type, N_WIRE - 1)]

    def to_wire(self, wire_req_type: np.ndarray, rtype: np.ndarray):
        """(original wire request type, engine Reply code) -> wire reply."""
        w = self.rep_map[np.minimum(wire_req_type, N_WIRE - 1), rtype]
        return np.where(w < 0, 255, w).astype(np.uint8)


def _profile(name, fmt, req: dict, rep: dict, cls=Profile) -> Profile:
    req_map = np.full(N_WIRE, Op.NOP, np.int32)
    for wcode, op in req.items():
        req_map[wcode] = op
    rep_map = np.full((N_WIRE, N_REPLY), -1, np.int32)
    for wcode, m in rep.items():
        for rcode, wreply in m.items():
            rep_map[wcode, rcode] = wreply
    return cls(name, fmt, req_map, rep_map)


class _Lock2PLProfile(Profile):
    """lock_2pl's ACQUIRE 0 / RELEASE 1 carry the lock type in the table
    byte (SHARED_LOCK 0, EXCLUSIVE_LOCK 1)."""

    def to_ops(self, wire_type, wire_table):
        is_x = wire_table != 0
        acq = np.where(is_x, Op.ACQ_X, Op.ACQ_S)
        rel = np.where(is_x, Op.REL_X, Op.REL_S)
        return np.where(wire_type == 0, acq,
                        np.where(wire_type == 1, rel, Op.NOP)).astype(np.int32)


# --- store: READ 0 / SET 1 / INSERT 2; replies GRANT_READ 3, REJECT_READ 4,
#     SET_ACK 5, REJECT_SET 6, NOT_EXIST 7, INSERT_ACK 8, REJECT_INSERT 9.
STORE = _profile("store", FMT_MSG55,
                 {0: Op.GET, 1: Op.SET, 2: Op.INSERT},
                 {0: {Reply.VAL: 3, Reply.REJECT: 4, Reply.NOT_EXIST: 7},
                  1: {Reply.ACK: 5, Reply.SPILL: 6, Reply.NOT_EXIST: 7},
                  2: {Reply.ACK: 8, Reply.SPILL: 9}})

# --- lock_2pl: GRANT_LOCK 2, REJECT_LOCK 3, RETRY 4, RELEASE_ACK 5.
LOCK2PL = _profile("lock_2pl", FMT_LOCK6, {},
                   {0: {Reply.GRANT: 2, Reply.REJECT: 3, Reply.RETRY: 4},
                    1: {Reply.ACK: 5}}, cls=_Lock2PLProfile)

# --- lock_fasst: READ 0 / ACQUIRE_LOCK 1 / ABORT 2 / COMMIT 3; replies
#     GRANT_READ 4, GRANT_LOCK 5, REJECT_LOCK 6, ABORT_ACK 7, COMMIT_ACK 8.
FASST = _profile("lock_fasst", FMT_FASST9,
                 {0: Op.READ_VER, 1: Op.LOCK, 2: Op.ABORT, 3: Op.COMMIT_VER},
                 {0: {Reply.VAL: 4},
                  # the wire enum has no same-key code: the attributing
                  # server's same-key reject goes out as REJECT_LOCK
                  1: {Reply.GRANT: 5, Reply.REJECT: 6,
                      Reply.REJECT_SAME_KEY: 6},
                  2: {Reply.ACK: 7},
                  3: {Reply.ACK: 8, Reply.REJECT: 6}})

# --- log_server: COMMIT 0 -> ACK 1.
LOG = _profile("log_server", FMT_LOG53,
               {0: Op.LOG_APPEND},
               {0: {Reply.ACK: 1}})

# --- smallbank: kAcquireShared..kCommitLog 0-6 (fused lock+read); replies
#     kGrantShared 7 .. kCommitLogAck 15, kRetry 16.
SMALLBANK = _profile("smallbank", FMT_MSG55,
                     {0: Op.ACQ_S_READ, 1: Op.ACQ_X_READ, 2: Op.REL_S,
                      3: Op.REL_X, 4: Op.COMMIT_PRIM, 5: Op.COMMIT_BCK,
                      6: Op.COMMIT_LOG},
                     {0: {Reply.GRANT: 7, Reply.REJECT: 8, Reply.RETRY: 16},
                      1: {Reply.GRANT: 9, Reply.REJECT: 10, Reply.RETRY: 16},
                      2: {Reply.ACK: 11},
                      3: {Reply.ACK: 12},
                      4: {Reply.ACK: 13, Reply.REJECT: 11},
                      5: {Reply.ACK: 14, Reply.REJECT: 11},
                      6: {Reply.ACK: 15}})

# --- tatp: READ 0, ACQUIRE_LOCK 1, ABORT 2, COMMIT_PRIM/BCK/LOG 12-14,
#     INSERT_PRIM/BCK 18/19, DELETE_PRIM/BCK/LOG 22-24; replies
#     GRANT_READ 4, REJECT_READ 5, NOT_EXIST 6, GRANT_LOCK 7, REJECT_LOCK 8,
#     ABORT_ACK 9, REJECT_COMMIT 11, *_ACK 15-17/20-21/25-27,
#     REJECT_LOCK_SAME_KEY 28.
TATP = _profile("tatp", FMT_MSG55,
                {0: Op.OCC_READ, 1: Op.OCC_LOCK, 2: Op.ABORT,
                 12: Op.COMMIT_PRIM, 13: Op.COMMIT_BCK, 14: Op.COMMIT_LOG,
                 18: Op.INSERT_PRIM, 19: Op.INSERT_BCK,
                 22: Op.DELETE_PRIM, 23: Op.DELETE_BCK, 24: Op.DELETE_LOG},
                {0: {Reply.VAL: 4, Reply.REJECT: 5, Reply.NOT_EXIST: 6},
                 1: {Reply.GRANT: 7, Reply.REJECT: 8,
                     Reply.REJECT_SAME_KEY: 28},
                 2: {Reply.ACK: 9},
                 12: {Reply.ACK: 15, Reply.REJECT: 11},
                 13: {Reply.ACK: 16, Reply.REJECT: 11},
                 14: {Reply.ACK: 17},
                 18: {Reply.ACK: 20, Reply.SPILL: 11},
                 19: {Reply.ACK: 21},
                 22: {Reply.ACK: 25, Reply.NOT_EXIST: 6},
                 23: {Reply.ACK: 26},
                 24: {Reply.ACK: 27}})

PROFILES = {p.name: p for p in
            (STORE, LOCK2PL, FASST, LOG, SMALLBANK, TATP)}
