"""The store benchmark's populated table (the part of
`dint_tpu.clients.micro` the store engine needs)."""
from __future__ import annotations

import numpy as np

from ..tables import kv

STORE_MAGIC = 0x55AA


def make_store_table(n_keys: int, *, n_buckets: int | None = None,
                     val_words: int = 10, device=None) -> kv.KVTable:
    """Populated store table on ``device`` (None = CUDA): keys 1..n, val
    word 0 = key, word 1 = the magic (store/caladan/client_caladan.cc:160),
    2^ceil(log2(n/2)) buckets of 4 slots unless ``n_buckets`` is given."""
    if n_buckets is None:
        n_buckets = max(16, 1 << int(np.ceil(np.log2(n_keys / 2))))
    keys = np.arange(1, n_keys + 1, dtype=np.uint64)
    vals = np.zeros((n_keys, val_words), np.uint32)
    vals[:, 0] = keys.astype(np.uint32)
    vals[:, 1] = STORE_MAGIC
    return kv.populate(kv.create(n_buckets, val_words=val_words,
                                 device=device), keys, vals)
