"""Carry dense TATP and SmallBank state between the JAX package and the
port.

The JAX `DenseDB`'s and `DenseBank`'s leaves travel as numpy arrays in a
plain dict, so this module needs nothing of JAX:

    DenseDB:   {"val", "meta", "arb": u32 arrays, "step": u32 scalar,
                "log.entries": u32 [L*CAP, S*(HDR+VW)], "log.head": u32 [L],
                "val_words", "lanes", "replicas": ints, and, only when
                the hot mirrors are present, "hot_meta", "hot_val": u32
                arrays and "hot_n": int}
    DenseBank: {"bal", "x_step", "s_step": u32 arrays, "step": u32 scalar,
                "log.entries", "log.head", "lanes", "replicas" as above,
                "hot_bal", "hot_x", "hot_s": u32 arrays, each only when
                present, "hot_n": int}
    Counters:  the u32 [N_COUNTERS] buffer
"""
from __future__ import annotations

import numpy as np

from .device import resolve_device
from .engines.smallbank_dense import DenseBank
from .engines.tatp_dense import DenseDB
from .monitor.counters import Counters
from .ops.u32 import from_numpy, to_numpy
from .tables.log import RepLog

HOT_LEAVES = ("hot_bal", "hot_x", "hot_s")
TATP_HOT_LEAVES = ("hot_meta", "hot_val")


def _log_from_numpy(arrays: dict, dev) -> RepLog:
    return RepLog(entries=from_numpy(arrays["log.entries"], dev),
                  head=from_numpy(arrays["log.head"], dev),
                  lanes=int(arrays["lanes"]),
                  replicas=int(arrays["replicas"]))


def _log_to_numpy(log: RepLog) -> dict:
    return {"log.entries": to_numpy(log.entries),
            "log.head": to_numpy(log.head),
            "lanes": log.lanes, "replicas": log.replicas}


def dense_db_from_numpy(arrays: dict, device=None) -> DenseDB:
    dev = resolve_device(device)
    hot = {k: from_numpy(arrays[k], dev) for k in TATP_HOT_LEAVES
           if arrays.get(k) is not None}
    return DenseDB(
        val=from_numpy(arrays["val"], dev),
        meta=from_numpy(arrays["meta"], dev),
        arb=from_numpy(arrays["arb"], dev),
        step=int(arrays["step"]),
        log=_log_from_numpy(arrays, dev),
        val_words=int(arrays["val_words"]),
        hot_n=int(arrays.get("hot_n", 0)), **hot)


def dense_db_to_numpy(db: DenseDB) -> dict:
    out = {"val": to_numpy(db.val), "meta": to_numpy(db.meta),
           "arb": to_numpy(db.arb), "step": np.uint32(db.step),
           **_log_to_numpy(db.log), "val_words": db.val_words}
    if db.hot_meta is not None:
        out.update(hot_meta=to_numpy(db.hot_meta),
                   hot_val=to_numpy(db.hot_val), hot_n=db.hot_n)
    return out


def dense_bank_from_numpy(arrays: dict, device=None) -> DenseBank:
    dev = resolve_device(device)
    hot = {k: from_numpy(arrays[k], dev) for k in HOT_LEAVES
           if arrays.get(k) is not None}
    return DenseBank(
        bal=from_numpy(arrays["bal"], dev),
        x_step=from_numpy(arrays["x_step"], dev),
        s_step=from_numpy(arrays["s_step"], dev),
        step=int(arrays["step"]),
        log=_log_from_numpy(arrays, dev),
        hot_n=int(arrays.get("hot_n", 0)), **hot)


def dense_bank_to_numpy(db: DenseBank) -> dict:
    out = {"bal": to_numpy(db.bal), "x_step": to_numpy(db.x_step),
           "s_step": to_numpy(db.s_step), "step": np.uint32(db.step),
           **_log_to_numpy(db.log), "hot_n": db.hot_n}
    for k in HOT_LEAVES:
        if getattr(db, k) is not None:
            out[k] = to_numpy(getattr(db, k))
    return out


def counters_from_numpy(buf, device=None) -> Counters:
    return Counters(buf=from_numpy(np.asarray(buf), resolve_device(device)))


def counters_to_numpy(c: Counters) -> np.ndarray:
    return to_numpy(c.buf)
