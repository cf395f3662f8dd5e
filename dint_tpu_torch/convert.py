"""Carry dense TATP, SmallBank, store and cache-tier state between the JAX
package and the port.

The JAX `DenseDB`'s, `DenseBank`'s, `KVTable`'s, `OrderedRun`'s, `HotKV`'s
and `CacheTable`'s leaves travel as numpy arrays in a plain dict, so this
module needs nothing of JAX:

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
    KVTable:   KV_LEAVES (u32 arrays, "valid" bool) and "slots",
               "val_words": ints
    OrderedRun: RUN_LEAVES (u32 arrays; "n", "d_n", "d_seq_next" scalars;
               "d_tomb" bool array, "stale" bool scalar) and "delta_cap",
               "val_words": ints
    HotKV:     {"val", "ver": u32 arrays}
    CacheTable: the KVTable dict of its ``kv``, plus "dirty" (bool array),
               "clock" (u32 scalar) and, only when the hot mirrors are
               present, "hot_val", "hot_ver" (u32 arrays)
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .engines.smallbank_dense import DenseBank
from .engines.store_cache import CacheTable
from .engines.store import HotKV
from .engines.tatp_dense import DenseDB
from .monitor.counters import Counters
from .ops.u32 import from_numpy, to_numpy
from .tables.kv import KVTable
from .tables.log import RepLog
from .tables.run import OrderedRun

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


KV_LEAVES = ("key_hi", "key_lo", "val", "ver", "valid", "bloom_hi",
             "bloom_lo")
RUN_LEAVES = ("key_hi", "key_lo", "ver", "val", "n", "d_key_hi", "d_key_lo",
              "d_ver", "d_val", "d_tomb", "d_seq", "d_n", "d_seq_next",
              "stale")


def _leaf_from_numpy(a, dev):
    """A u32/i32 array (or scalar) -> int32 tensor; bool stays bool."""
    a = np.asarray(a)
    if a.dtype == np.bool_:
        return torch.from_numpy(a.copy()).to(dev)
    return from_numpy(a, dev).reshape(a.shape)


def _leaf_to_numpy(x):
    return x.cpu().numpy() if x.dtype == torch.bool else to_numpy(x)


def kv_table_from_numpy(arrays: dict, device=None) -> KVTable:
    dev = resolve_device(device)
    return KVTable(**{k: _leaf_from_numpy(arrays[k], dev) for k in KV_LEAVES},
                   slots=int(arrays["slots"]),
                   val_words=int(arrays["val_words"]))


def kv_table_to_numpy(t: KVTable) -> dict:
    return {**{k: _leaf_to_numpy(getattr(t, k)) for k in KV_LEAVES},
            "slots": t.slots, "val_words": t.val_words}


def ordered_run_from_numpy(arrays: dict, device=None) -> OrderedRun:
    dev = resolve_device(device)
    return OrderedRun(**{k: _leaf_from_numpy(arrays[k], dev)
                         for k in RUN_LEAVES},
                      delta_cap=int(arrays["delta_cap"]),
                      val_words=int(arrays["val_words"]))


def ordered_run_to_numpy(run: OrderedRun) -> dict:
    return {**{k: _leaf_to_numpy(getattr(run, k)) for k in RUN_LEAVES},
            "delta_cap": run.delta_cap, "val_words": run.val_words}


def hot_kv_from_numpy(arrays: dict, device=None) -> HotKV:
    dev = resolve_device(device)
    return HotKV(val=from_numpy(arrays["val"], dev),
                 ver=from_numpy(arrays["ver"], dev))


def hot_kv_to_numpy(hot: HotKV) -> dict:
    return {"val": to_numpy(hot.val), "ver": to_numpy(hot.ver)}


def cache_table_from_numpy(arrays: dict, device=None) -> CacheTable:
    """A CacheTable from the dict; the mirrors are fresh tensors."""
    dev = resolve_device(device)
    hot = {k: from_numpy(arrays[k], dev) for k in ("hot_val", "hot_ver")
           if arrays.get(k) is not None}
    return CacheTable(kv=kv_table_from_numpy(arrays, dev),
                      dirty=_leaf_from_numpy(arrays["dirty"], dev),
                      clock=int(arrays["clock"]), **hot)


def cache_table_to_numpy(c: CacheTable) -> dict:
    out = {**kv_table_to_numpy(c.kv), "dirty": _leaf_to_numpy(c.dirty),
           "clock": np.uint32(c.clock)}
    if c.hot_ver is not None:
        out.update(hot_val=to_numpy(c.hot_val), hot_ver=to_numpy(c.hot_ver))
    return out
