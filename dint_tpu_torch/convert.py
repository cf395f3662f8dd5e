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

The generic engines' state travels as the flat dict of its dataclass tree
(`tree_to_numpy`): each leaf under its dotted path, arrays as numpy
(32-bit words as uint32, lock bits as bool; `*_from_numpy` also take
JAX's int32 counters), static ints as ints:

    SXLockTable:  {"num_sh", "num_ex"}
    OCCTable:     {"locked", "ver"}; OCCAttrTable adds "owner_hi",
                  "owner_lo"
    LogRing:      {"entries" [L, CAP, HDR+VW], "head" [L]}
    DenseTable:   {"val", "ver", "val_words"}
    tatp.Shard:   "sub.*", "sec.*", "ai.*", "sf.*" (DenseTable),
                  "sub_lock" ... "sf_lock", "cf.*" (KVTable), "cf_lock.*",
                  "log.*"
    smallbank.Shard: "sav.*", "chk.*", "sav_sh", "sav_ex", "chk_sh",
                  "chk_ex", "log.*"
    the three replicas: the same keys, each array with a leading [3] axis
                  (JAX's stacked pytree); JAX's sharded generic state
                  (`parallel.sharded.create_sharded_state`,
                  `create_sharded_smallbank`) the same with a leading [D]

The sharded dense TATP state (`parallel.dense_sharded.ShardState`, JAX's
stacked over a leading [D] or [H, C] mesh axis) travels as the DenseDB
dict of its ``db`` under the prefix ``db.`` plus "bck_val" and
"bck_meta", every array stacked over the mesh's shape and the static
ints ("db.val_words", "db.lanes", "db.replicas") as ints.

The sharded dense SmallBank state (`parallel.dense_sharded_sb.SBShard`,
JAX's stacked over a leading [D]) travels as

    {"bal", "bck_bal", "x_step", "s_step": u32 [D, ...], "step": u32 [D],
     "log.entries": u32 [D, L*CAP, HDR+VW], "log.head": u32 [D, L],
     "lanes", "replicas": ints, and, only when the hot mirrors are
     present, "hot_bal", "hot_x", "hot_s": u32 [D, 2*hot_loc] and
     "hot_loc": int}

A mesh state's converters place each partition on its own device: the
mesh's (``mesh=``, `parallel.mesh.Mesh.devices`), or one device for all
(``device``, None = CUDA).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .device import resolve_device
from .engines import smallbank, tatp
from .engines.smallbank_dense import DenseBank
from .engines.store_cache import CacheTable
from .engines.store import HotKV
from .engines.tatp_dense import DenseDB
from .monitor.counters import Counters
from .ops.u32 import from_numpy, to_numpy
from .tables.dense import DenseTable
from .tables.kv import KVTable
from .tables.locks import OCCAttrTable, OCCTable, SXLockTable
from .tables.log import LogRing, RepLog
from .tables.run import OrderedRun

HOT_LEAVES = ("hot_bal", "hot_x", "hot_s")
TATP_HOT_LEAVES = ("hot_meta", "hot_val")


def partition_devices(n: int, device=None, mesh=None) -> list:
    """The device of each of ``n`` partitions: ``mesh.devices`` (the
    mesh's size must be ``n``), else ``device`` (None = CUDA) for every
    partition."""
    if mesh is None:
        return [resolve_device(device)] * n
    if device is not None:
        raise ValueError("give a converter device= or mesh=, not both")
    if mesh.size != n:
        raise ValueError(f"{mesh.size} devices for {n} partitions")
    return list(mesh.devices)


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


def tree_to_numpy(obj) -> dict:
    """A dataclass tree of tensors -> the flat dict of its leaves under
    their dotted paths (arrays as numpy, static ints as ints)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            out[f.name] = _leaf_to_numpy(v)
        elif dataclasses.is_dataclass(v):
            out.update({f"{f.name}.{k}": x
                        for k, x in tree_to_numpy(v).items()})
        else:
            out[f.name] = v
    return out


# a KVTable's, OrderedRun's and HotKV's dicts are their trees' leaves
kv_table_to_numpy = ordered_run_to_numpy = hot_kv_to_numpy = tree_to_numpy


def kv_table_from_numpy(arrays: dict, device=None) -> KVTable:
    dev = resolve_device(device)
    return KVTable(**{k: _leaf_from_numpy(arrays[k], dev) for k in KV_LEAVES},
                   slots=int(arrays["slots"]),
                   val_words=int(arrays["val_words"]))


def ordered_run_from_numpy(arrays: dict, device=None) -> OrderedRun:
    dev = resolve_device(device)
    return OrderedRun(**{k: _leaf_from_numpy(arrays[k], dev)
                         for k in RUN_LEAVES},
                      delta_cap=int(arrays["delta_cap"]),
                      val_words=int(arrays["val_words"]))


def hot_kv_from_numpy(arrays: dict, device=None) -> HotKV:
    dev = resolve_device(device)
    return HotKV(val=from_numpy(arrays["val"], dev),
                 ver=from_numpy(arrays["ver"], dev))


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


# ---------------------------------------------------- the generic engines


def _sub(arrays: dict, prefix: str) -> dict:
    p = prefix + "."
    return {k[len(p):]: v for k, v in arrays.items() if k.startswith(p)}


def _leaves(arrays: dict, names, dev) -> dict:
    return {k: _leaf_from_numpy(arrays[k], dev) for k in names}


def sx_lock_table_from_numpy(arrays: dict, device=None) -> SXLockTable:
    return SXLockTable(**_leaves(arrays, ("num_sh", "num_ex"),
                                 resolve_device(device)))


def occ_table_from_numpy(arrays: dict, device=None):
    """An OCCAttrTable where the dict has owners, else an OCCTable."""
    dev = resolve_device(device)
    if "owner_hi" in arrays:
        return OCCAttrTable(**_leaves(
            arrays, ("locked", "ver", "owner_hi", "owner_lo"), dev))
    return OCCTable(**_leaves(arrays, ("locked", "ver"), dev))


def log_ring_from_numpy(arrays: dict, device=None) -> LogRing:
    return LogRing(**_leaves(arrays, ("entries", "head"),
                             resolve_device(device)))


def dense_table_from_numpy(arrays: dict, device=None) -> DenseTable:
    return DenseTable(**_leaves(arrays, ("val", "ver"),
                                resolve_device(device)),
                      val_words=int(arrays["val_words"]))


def tatp_shard_from_numpy(arrays: dict, device=None) -> tatp.Shard:
    dev = resolve_device(device)
    return tatp.Shard(
        **{k: dense_table_from_numpy(_sub(arrays, k), dev)
           for k in ("sub", "sec", "ai", "sf")},
        **_leaves(arrays, ("sub_lock", "sec_lock", "ai_lock", "sf_lock"),
                  dev),
        cf=kv_table_from_numpy(_sub(arrays, "cf"), dev),
        cf_lock=occ_table_from_numpy(_sub(arrays, "cf_lock"), dev),
        log=log_ring_from_numpy(_sub(arrays, "log"), dev))


def smallbank_shard_from_numpy(arrays: dict, device=None) -> smallbank.Shard:
    dev = resolve_device(device)
    return smallbank.Shard(
        sav=dense_table_from_numpy(_sub(arrays, "sav"), dev),
        chk=dense_table_from_numpy(_sub(arrays, "chk"), dev),
        **_leaves(arrays, ("sav_sh", "sav_ex", "chk_sh", "chk_ex"), dev),
        log=log_ring_from_numpy(_sub(arrays, "log"), dev))


def stacked_to_numpy(shards) -> dict:
    """The replica list -> one dict, every array stacked on a leading axis
    (the layout of JAX's stacked Shard pytree)."""
    dicts = [tree_to_numpy(s) for s in shards]
    out = {}
    for k, v in dicts[0].items():
        if isinstance(v, np.ndarray):
            out[k] = np.stack([d[k] for d in dicts])
        else:
            assert all(d[k] == v for d in dicts), k
            out[k] = v
    return out


def _replica(arrays: dict, i: int) -> dict:
    return {k: v[i] if isinstance(v, np.ndarray) else v
            for k, v in arrays.items()}


def tatp_stacked_from_numpy(arrays: dict, device=None) -> list:
    """JAX's stacked TATP Shard dict -> the port's list of replicas."""
    n = len(arrays["sub.ver"])
    return [tatp_shard_from_numpy(_replica(arrays, i), device)
            for i in range(n)]


def smallbank_stacked_from_numpy(arrays: dict, device=None) -> list:
    """JAX's stacked SmallBank Shard dict -> the port's list of replicas."""
    n = len(arrays["sav.ver"])
    return [smallbank_shard_from_numpy(_replica(arrays, i), device)
            for i in range(n)]


def tatp_sharded_from_numpy(arrays: dict, device=None, mesh=None) -> list:
    """JAX's `sharded.create_sharded_state` state (stacked [D]) -> the
    port's list of D shards, shard d on its device (`partition_devices`)."""
    n = len(arrays["sub.ver"])
    devs = partition_devices(n, device, mesh)
    return [tatp_shard_from_numpy(_replica(arrays, i), devs[i])
            for i in range(n)]


def smallbank_sharded_from_numpy(arrays: dict, device=None,
                                 mesh=None) -> list:
    """JAX's `sharded.create_sharded_smallbank` state (stacked [D]) -> the
    port's list of D shards, shard d on its device (`partition_devices`)."""
    n = len(arrays["sav.ver"])
    devs = partition_devices(n, device, mesh)
    return [smallbank_shard_from_numpy(_replica(arrays, i), devs[i])
            for i in range(n)]


# ------------------------------------------------- sharded dense TATP


def sharded_state_from_numpy(arrays: dict, device=None, mesh=None) -> list:
    """JAX's stacked `ShardState` dict (leading [D] or [H, C]) -> the
    port's list of `ShardState`, in flat partition order (h * C + c),
    each on its partition's device (`partition_devices`)."""
    from .parallel.dense_sharded import ShardState
    lead = np.asarray(arrays["bck_meta"]).shape[:-1]
    n = int(np.prod(lead))
    devs = partition_devices(n, device, mesh)
    flat = {k: (np.asarray(v).reshape((n,) + np.shape(v)[len(lead):])
                if isinstance(v, (np.ndarray, np.generic)) else v)
            for k, v in arrays.items()}
    out = []
    for i in range(n):
        a, dev = _replica(flat, i), devs[i]
        out.append(ShardState(db=dense_db_from_numpy(_sub(a, "db"), dev),
                              bck_val=from_numpy(a["bck_val"], dev),
                              bck_meta=from_numpy(a["bck_meta"], dev)))
    return out


def sharded_state_to_numpy(states, mesh_shape) -> dict:
    """The port's list of `ShardState` -> the stacked dict, every array
    with the leading mesh shape (JAX's layout)."""
    mesh_shape = tuple(mesh_shape)
    dicts = [{**{f"db.{k}": v for k, v in dense_db_to_numpy(s.db).items()},
              "bck_val": to_numpy(s.bck_val),
              "bck_meta": to_numpy(s.bck_meta)} for s in states]
    out = {}
    for k, v in dicts[0].items():
        if isinstance(v, (np.ndarray, np.generic)):
            st = np.stack([d[k] for d in dicts])
            out[k] = st.reshape(mesh_shape + st.shape[1:])
        else:
            assert all(d[k] == v for d in dicts), k
            out[k] = v
    return out


# ------------------------------------------------- sharded dense SmallBank


def sharded_sb_from_numpy(arrays: dict, device=None, mesh=None) -> list:
    """JAX's stacked `SBShard` dict (leading [D]) -> the port's list of
    `SBShard`, each with storage of its own on its partition's device
    (`partition_devices`)."""
    from .parallel.dense_sharded_sb import SBShard
    n = len(arrays["bal"])
    devs = partition_devices(n, device, mesh)
    out = []
    for i in range(n):
        a, dev = _replica(arrays, i), devs[i]
        hot = {k: from_numpy(a[k], dev) for k in HOT_LEAVES
               if a.get(k) is not None}
        out.append(SBShard(
            bal=from_numpy(a["bal"], dev),
            bck_bal=from_numpy(a["bck_bal"], dev),
            x_step=from_numpy(a["x_step"], dev),
            s_step=from_numpy(a["s_step"], dev),
            step=int(a["step"]), log=_log_from_numpy(a, dev),
            hot_loc=int(a.get("hot_loc", 0)), **hot))
    return out


def sharded_sb_to_numpy(states) -> dict:
    """The port's list of `SBShard` -> the stacked dict (JAX's layout)."""
    dicts = []
    for s in states:
        d = {"bal": to_numpy(s.bal), "bck_bal": to_numpy(s.bck_bal),
             "x_step": to_numpy(s.x_step), "s_step": to_numpy(s.s_step),
             "step": np.uint32(s.step), **_log_to_numpy(s.log)}
        if s.hot_bal is not None:
            d.update({k: to_numpy(getattr(s, k)) for k in HOT_LEAVES},
                     hot_loc=s.hot_loc)
        dicts.append(d)
    out = {}
    for k, v in dicts[0].items():
        if isinstance(v, (np.ndarray, np.generic)):
            out[k] = np.stack([d[k] for d in dicts])
        else:
            assert all(d[k] == v for d in dicts), k
            out[k] = v
    return out


# ------------------------------------------- SmallBank on the 2-D mesh


def multihost_sb_from_numpy(arrays: dict, device=None, mesh=None) -> list:
    """JAX's `multihost_sb` state dict (every array leading [H, C]) -> the
    port's list of `SBShard`, in flat partition order (h * C + c), each on
    its partition's device (`partition_devices`)."""
    lead = np.asarray(arrays["bal"]).shape[:2]
    n = int(np.prod(lead))
    flat = {k: (np.asarray(v).reshape((n,) + np.shape(v)[2:])
                if isinstance(v, (np.ndarray, np.generic)) else v)
            for k, v in arrays.items()}
    return sharded_sb_from_numpy(flat, device, mesh)


def multihost_sb_to_numpy(states, mesh_shape) -> dict:
    """The port's list of `SBShard` -> the dict of JAX's `multihost_sb`
    state, every array with the leading mesh shape [H, C]."""
    mesh_shape = tuple(mesh_shape)
    return {k: (v.reshape(mesh_shape + v.shape[1:])
                if isinstance(v, np.ndarray) else v)
            for k, v in sharded_sb_to_numpy(states).items()}
