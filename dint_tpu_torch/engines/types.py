"""Op and reply codes (the members of `dint_tpu.engines.types.Op`/`Reply`
that this package uses, same values), the dense engines' kernel routes, and
the store engine's batch and reply containers."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..ops import u64
from ..ops.u32 import from_numpy

# route name -> (use_hotset, use_fused) of both dense engines'
# `build_pipelined_runner`
ROUTES = {"default": (False, False), "hotset": (True, False),
          "fused": (False, True), "fused+hotset": (True, True)}

# reserved key of padding lanes (never a legal application key)
PAD_KEY = 0xFFFFFFFFFFFFFFFF


class Op:
    NOP = 0
    # store / KV
    GET = 1
    SET = 2
    INSERT = 3
    DELETE = 4
    # lock server (2PL) and OCC version server
    ACQ_S = 5
    ACQ_X = 6
    REL_S = 7
    REL_X = 8
    READ_VER = 9
    LOCK = 10
    COMMIT_VER = 11
    ABORT = 12
    # log server
    LOG_APPEND = 13
    # txn engines: fused lock+read and the commit pipeline's ops
    ACQ_S_READ = 14    # acquire shared + read value in one RTT
    ACQ_X_READ = 15    # acquire exclusive + read value in one RTT
    OCC_READ = 16      # read value + version (no lock)
    OCC_LOCK = 17      # row lock (write-slot arbitration)
    COMMIT_PRIM = 18   # install value, ver++, release the row lock
    COMMIT_BCK = 19    # install value + ver on a backup replica
    COMMIT_LOG = 20    # append to the replication log
    INSERT_PRIM = 21
    DELETE_PRIM = 22
    INSERT_BCK = 23
    DELETE_BCK = 24
    DELETE_LOG = 25
    # range scan over the ordered run: key = start key, ver = row count
    SCAN = 26


class Reply:
    NONE = 0
    GRANT = 1          # lock granted
    REJECT = 2         # no-wait lock reject
    RETRY = 3          # scan over a stale run: re-send after the rebuild
    ACK = 4            # release/commit/log/set ack
    NOT_EXIST = 5      # missing row
    VAL = 6            # read reply carrying value + version
    SPILL = 7          # bucket overflow: the host takes this key
    REJECT_SAME_KEY = 8  # lock attribution: the holder has the same key
    TIMEOUT = 9        # a wire client's resends ran out (no engine sends it)


@dataclass
class Batch:
    """A fixed-width batch of requests (struct of arrays); arrival order is
    the lane index. Words are int32-carried u32 (ops/u32.py)."""
    op: torch.Tensor       # i32 [R]
    table: torch.Tensor    # i32 [R]
    key_hi: torch.Tensor   # i32 [R]
    key_lo: torch.Tensor   # i32 [R]
    val: torch.Tensor      # i32 [R, VW]
    ver: torch.Tensor      # i32 [R] (SCAN: the requested row count)

    @property
    def width(self) -> int:
        return self.op.shape[0]


@dataclass
class Replies:
    rtype: torch.Tensor    # i32 [R]
    val: torch.Tensor      # i32 [R, VW]
    ver: torch.Tensor      # i32 [R]


@dataclass
class ScanReplies:
    """Row slabs of Op.SCAN lanes: the first `count` live keys >= the
    lane's start key of the merged run ∪ delta view, in key order; rows
    past count are zero. `delta_hits` counts rows served from the
    overlay."""
    key_hi: torch.Tensor      # i32 [R, SMAX]
    key_lo: torch.Tensor      # i32 [R, SMAX]
    ver: torch.Tensor         # i32 [R, SMAX]
    val: torch.Tensor         # i32 [R, SMAX, VW]
    count: torch.Tensor       # i32 [R]
    delta_hits: torch.Tensor  # i32 [R]


def make_batch(ops, keys, vals=None, vers=None, tables=None, width=None,
               val_words: int = 10, device=None) -> Batch:
    """Host-side batch builder (numpy in, tensors on ``device`` out, None
    = CUDA), padded to ``width`` with NOP lanes on PAD_KEY."""
    dev = resolve_device(device)
    ops = np.asarray(ops, np.int32)
    keys = np.asarray(keys, np.uint64)
    r = len(ops)
    width = width or r
    assert width >= r
    pad = width - r

    def _pad(x, fill=0):
        if pad == 0:
            return x
        return np.concatenate([x, np.full((pad,) + x.shape[1:], fill,
                                          x.dtype)])

    hi, lo = u64.split(_pad(keys, PAD_KEY))
    if vals is None:
        vals = np.zeros((r, val_words), np.uint32)
    vals = _pad(np.asarray(vals, np.uint32))
    vers = _pad(np.asarray(vers if vers is not None else np.zeros(r),
                           np.uint32))
    tables = _pad(np.asarray(tables if tables is not None else np.zeros(r),
                             np.int32))
    return Batch(op=from_numpy(_pad(ops), dev),
                 table=from_numpy(tables, dev), key_hi=from_numpy(hi, dev),
                 key_lo=from_numpy(lo, dev), val=from_numpy(vals, dev),
                 ver=from_numpy(vers, dev))
