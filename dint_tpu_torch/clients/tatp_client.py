"""TATP's populate of three replicated shards (the part of
`dint_tpu.clients.tatp_client` the generic engine needs; its
`Coordinator` is not ported yet).

The reference's populate (tatp/caladan/client_ebpf_shard.cc:96-341):
every subscriber has SUBSCRIBER and SEC_SUBSCRIBER rows, a random subset
(at least one) of the four ACCESS_INFO and SPECIAL_FACILITY types, each
present with probability 0.625, and each present SPECIAL_FACILITY row a
CALL_FORWARDING row per start time with probability 0.25. Value word 0 is
a payload, word 1 the magic (tatp/caladan/tatp.h:67-72).

The draws are numpy's, in JAX's order, so the tables are bit-identical
to JAX's from the same generator. The CF table is placed once and cloned:
each replica owns its storage, since the steps update them in place.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..engines import tatp
from ..tables import dense, kv

N_SHARDS = 3
MAGIC = 0x7A79


def clone_tree(x):
    """A copy of a dataclass of tensors (nested), every tensor cloned."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: clone_tree(getattr(x, f.name))
            for f in dataclasses.fields(x) if f.init})
    return x


def populate_shards(rng: np.random.Generator, n_subscribers: int,
                    val_words: int = 10, device=None, **kw):
    """Three identical replicas on ``device`` (None = CUDA); ``kw`` goes to
    `tatp.create`. Returns (shards, cf_keys u64)."""
    dev = resolve_device(device)
    p1 = n_subscribers + 1

    def mkvals(n, payload):
        v = np.zeros((n, val_words), np.uint32)
        v[:, 0] = payload
        v[:, 1] = MAGIC
        return v

    # ai/sf: each subscriber has a random subset of types 1..4 (>= 1)
    ai_present = rng.random((p1, 4)) < 0.625   # 2.5 of 4 on average
    sf_present = rng.random((p1, 4)) < 0.625
    ai_present[0] = sf_present[0] = False
    ai_present[1:][ai_present[1:].sum(1) == 0, 0] = True
    sf_present[1:][sf_present[1:].sum(1) == 0, 0] = True

    # cf: each start time for 25% of the present sf rows
    cf_keys = []
    sfi, sft = np.nonzero(sf_present)
    for st in (0, 8, 16):
        mask = rng.random(len(sfi)) < 0.25
        cf_keys.append(tatp.cf_key(sfi[mask], sft[mask] + 1, st))
    cf_keys = np.unique(np.concatenate(cf_keys)).astype(np.uint64)

    s = tatp.create(n_subscribers, val_words=val_words, device=dev, **kw)
    sub_vals = mkvals(p1, np.arange(p1))
    ver1 = np.ones(p1, np.uint32)
    ver1[0] = 0
    quad = mkvals(4 * p1, np.arange(4 * p1))
    s.sub = dense.populate(s.sub, sub_vals, ver1)
    s.sec = dense.populate(s.sec, sub_vals, ver1)
    s.ai = dense.populate(s.ai, quad, ai_present.reshape(-1).astype(np.uint32))
    s.sf = dense.populate(s.sf, quad, sf_present.reshape(-1).astype(np.uint32))
    s.cf = kv.populate(s.cf, cf_keys,
                       mkvals(len(cf_keys), cf_keys.astype(np.uint32)))
    return [s] + [clone_tree(s) for _ in range(N_SHARDS - 1)], cf_keys
