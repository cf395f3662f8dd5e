"""Carry dense TATP state between the JAX package and the port.

The JAX `DenseDB`'s leaves travel as numpy arrays in a plain dict, so this
module needs nothing of JAX:

    {"val", "meta", "arb": u32 arrays, "step": u32 scalar,
     "log.entries": u32 [L*CAP, S*(HDR+VW)], "log.head": u32 [L],
     "val_words", "lanes", "replicas": ints}
"""
from __future__ import annotations

import numpy as np

from .device import resolve_device
from .engines.tatp_dense import DenseDB
from .ops.u32 import from_numpy, to_numpy
from .tables.log import RepLog


def dense_db_from_numpy(arrays: dict, device=None) -> DenseDB:
    dev = resolve_device(device)
    return DenseDB(
        val=from_numpy(arrays["val"], dev),
        meta=from_numpy(arrays["meta"], dev),
        arb=from_numpy(arrays["arb"], dev),
        step=int(arrays["step"]),
        log=RepLog(entries=from_numpy(arrays["log.entries"], dev),
                   head=from_numpy(arrays["log.head"], dev),
                   lanes=int(arrays["lanes"]),
                   replicas=int(arrays["replicas"])),
        val_words=int(arrays["val_words"]))


def dense_db_to_numpy(db: DenseDB) -> dict:
    return {
        "val": to_numpy(db.val), "meta": to_numpy(db.meta),
        "arb": to_numpy(db.arb), "step": np.uint32(db.step),
        "log.entries": to_numpy(db.log.entries),
        "log.head": to_numpy(db.log.head),
        "val_words": db.val_words, "lanes": db.log.lanes,
        "replicas": db.log.replicas,
    }
