"""Failure recovery: rebuild a dense engine's tables from a base snapshot
and ONE replica's log ring, the port of `dint_tpu.recovery`.

Every certified write is appended to the three replicas' log rings before
it is installed (log_server/ebpf/ls_kern.c:63-77; the reference never
replays them). Versions are monotonic per row, so the highest-versioned
log entry of a row is the row's final state, and any one surviving
replica rebuilds the tables.

Two forms, as in JAX:

* `recover_tatp_dense`, `recover_smallbank_dense`: numpy on the host.
  They refuse a ring that has wrapped (its oldest entries are gone) and a
  log whose keys fall outside db0's tables (another geometry).
* `replay_tatp_dense`, `replay_smallbank_dense`: torch on the tables'
  device. The winner of a row is found by two scatter-maxes, of ver+1 and
  then of the entry's flat index, which breaks version ties as the numpy
  path's stable lexsort does; one index_put_ installs the winners. A
  wrapped ring is clamped at its capacity, not refused.

What differs from JAX:

* Ring words are int32 bit patterns (ops/u32.py). Versions, flags and
  heads are read as u32 (numpy uint32 views; int64 widening in torch), so
  versions and heads of 2^31 and above order as JAX's u32 do.
* JAX's ``.at[...](mode="drop")`` has no torch form: the winner arrays
  have one extra slot, n_rows, that non-live entries go to, and the
  install keeps only the winning entries (one ``nonzero``).
* JAX's replay casts key_lo to int32, so a logged key of 2^31 or above
  makes a negative row id that ``.at[]`` wraps NumPy-style. The port reads
  key_lo as u32: such an entry is outside its table and is ignored, as
  the numpy path refuses it. No engine logs such a key.
* Each function returns a new DB whose every tensor is fresh, so db0 is
  never written and running the result leaves db0 as it was. The result
  carries no hot mirrors: a hot-route runner's ``init`` attaches them
  from the rebuilt tables. The step counter is a host int.
* `recover_sb_shard` and `replay_sb_shard` rebuild one partition of the
  sharded SmallBank path (`parallel.dense_sharded_sb`) from any of the
  three rings that carry its stream; as in JAX they return its balance
  array (numpy u32, and an int32 tensor on the device of the lost
  partition's base array), not a state.
* A replay runs on the device of its base (db0, bal0): a lost partition
  is rebuilt on its own card from a ring on another card, whose entries
  and heads are copied there first.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ops import u32
from .tables.log import HDR_WORDS, RepLog

SB_VW = 2      # SmallBank's log value words (balance, magic)


def _u32(x) -> np.ndarray:
    """Ring words (a tensor, or a numpy uint32 or int32 array) as uint32."""
    if isinstance(x, torch.Tensor):
        return u32.to_numpy(x)
    a = np.asarray(x)
    if a.dtype == np.int32:
        return a.view(np.uint32)
    if a.dtype != np.uint32:
        raise TypeError(f"expected u32 ring words, got {a.dtype}")
    return a


def _flat_entries(entries, heads, key_hi_filter: int | None = None):
    """Live entries of a multi-lane ring, as flat arrays.

    entries [L, CAP, HDR+VW] u32, heads [L] u32 (monotonic; the ring
    wraps) -> (flags, key_hi, key_lo, ver, val [n, VW]) of every written
    slot. ``key_hi_filter`` keeps only entries whose key_hi word matches
    (the sharded path's source tag)."""
    entries, heads = _u32(entries), _u32(heads)
    lanes, cap, _ = entries.shape
    if (heads.astype(np.int64) > cap).any():
        # the oldest entries were overwritten: a row whose only records
        # were evicted cannot be rebuilt (ls_kern.c:72-73 rings likewise)
        raise ValueError("log ring wrapped: recovery window exceeded "
                         f"(head max {int(heads.max())} > capacity {cap})")
    counts = np.minimum(heads.astype(np.int64), cap)
    lane_of = np.repeat(np.arange(lanes), counts)
    slot_of = np.concatenate([np.arange(c) for c in counts])
    e = entries[lane_of, slot_of]
    if key_hi_filter is not None:
        e = e[e[:, 1] == np.uint32(key_hi_filter)]
    return e[:, 0], e[:, 1], e[:, 2], e[:, 3], e[:, HDR_WORDS:]


def latest_per_row(rows: np.ndarray, vers: np.ndarray):
    """Index of the max-version entry per distinct row (the last one in
    ring order on a tie). Returns (row_ids, idx)."""
    if len(rows) == 0:
        return rows, np.zeros(0, np.int64)
    order = np.lexsort((vers, rows))
    sr = rows[order]
    last = np.r_[sr[1:] != sr[:-1], True]
    return sr[last], order[last]


def _host_copy(t: torch.Tensor) -> np.ndarray:
    """A fresh host copy of an int32 tensor, as uint32."""
    return t.detach().to("cpu", copy=True).numpy().view(np.uint32)


def _to_device(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(dev)


def _copy_log(log: RepLog) -> RepLog:
    return dataclasses.replace(log, entries=log.entries.clone(),
                               head=log.head.clone())


def _rebuilt_tatp(db0, val: torch.Tensor, meta: torch.Tensor):
    """db0 with val and meta replaced; locks are volatile (a recovering
    replica restarts with db0's lock table, like the reference's fresh
    server)."""
    return dataclasses.replace(db0, val=val, meta=meta, arb=db0.arb.clone(),
                               log=_copy_log(db0.log), hot_meta=None,
                               hot_val=None, hot_n=0)


def _rebuilt_bank(db0, bal: torch.Tensor, step: int):
    """db0 with bal replaced, lock stamps reset and the step resumed."""
    return dataclasses.replace(db0, bal=bal,
                               x_step=torch.zeros_like(db0.x_step),
                               s_step=torch.zeros_like(db0.s_step),
                               step=step, log=_copy_log(db0.log),
                               hot_bal=None, hot_x=None, hot_s=None, hot_n=0)


def recover_tatp_dense(db0, log_entries, log_heads,
                       key_hi_filter: int | None = None):
    """A `tatp_dense.DenseDB` rebuilt from the base snapshot db0 (the
    populated state, which fixes the geometry) and one replica's ring
    (`tables.log.replica_entries`, and the heads): val, ver and exists
    equal the logged state of every logged row and db0's elsewhere."""
    from .engines import tatp_dense as td

    flags, _, key_lo, vers, vals = _flat_entries(log_entries, log_heads,
                                                 key_hi_filter)
    is_del = (flags & 0xFF).astype(bool)
    table = (flags >> 8).astype(np.int64)
    p1 = db0.n_sub + 1
    sizes = np.array([p1, p1, 4 * p1, 4 * p1, 12 * p1], np.int64)
    if not ((table < 5) & (key_lo.astype(np.int64)
                           < sizes[np.minimum(table, 4)])).all():
        raise ValueError("log key out of its table's range: the log "
                         "belongs to a different-geometry database than db0")
    rows = td._bases(p1).astype(np.int64)[table] + key_lo.astype(np.int64)
    urows, idx = latest_per_row(rows, vers)

    vw = db0.val_words
    val = _host_copy(db0.val).reshape(-1, vw)
    meta = _host_copy(db0.meta)
    val[urows] = vals[idx][:, :vw]
    meta[urows] = ((vers[idx] << 1)
                   | (~is_del[idx]).astype(np.uint32))
    dev = db0.meta.device
    return _rebuilt_tatp(db0, _to_device(val.reshape(-1), dev),
                         _to_device(meta, dev))


def recover_smallbank_dense(db0, log_entries, log_heads):
    """A `smallbank_dense.DenseBank` rebuilt from db0 and one replica's
    ring: balances from the max-version entry of each row (SmallBank logs
    no deletes; ``ver`` is the step that installed it), lock stamps
    reset, the step resumed past the last logged one."""
    n = db0.n_accounts
    flags, _, key_lo, vers, vals = _flat_entries(log_entries, log_heads)
    table = (flags >> 8).astype(np.int64)
    if not ((table < 2) & (key_lo.astype(np.int64) < n)).all():
        raise ValueError("log key out of its table's range: the log "
                         "belongs to a different-geometry database than db0")
    rows = table * n + key_lo.astype(np.int64)
    urows, idx = latest_per_row(rows, vers)
    bal = _host_copy(db0.bal)
    bal[urows] = vals[idx][:, 0]
    next_step = max(int(vers.max(initial=1)) + 2, 2)
    return _rebuilt_bank(db0, _to_device(bal, db0.bal.device), next_step)


def recover_sb_shard(n_accounts: int, dead: int, n_shards: int,
                     log_entries, log_heads, init_balance: int = 1000,
                     ring_owner: int | None = None) -> np.ndarray:
    """Partition ``dead``'s primary balances (u32 [m1_loc], sentinel last)
    rebuilt from ANY ring that carries its stream: its own or a backup
    holder's (`tables.log.replica_entries` of the ring, and its heads).
    Entries log GLOBAL account ids, so ``dead``'s stream is the entries
    with ``acct % n_shards == dead``; rows no entry names keep
    ``init_balance``.

    ``ring_owner``: the partition whose ring this is; when given, every
    entry's key_hi source tag (0 = the owner's own install, src + 1 =
    forwarded from src) is checked against ``acct % n_shards``, so a ring
    written under another shard geometry raises instead of rebuilding the
    wrong accounts."""
    from .parallel.dense_sharded_sb import m1_local, n_acct_local

    flags, key_hi, key_lo, vers, vals = _flat_entries(log_entries, log_heads)
    table = (flags >> 8).astype(np.int64)
    acct = key_lo.astype(np.int64)
    if ring_owner is not None:
        src = np.where(key_hi == 0, ring_owner, key_hi.astype(np.int64) - 1)
        if not ((acct % n_shards) == src).all():
            raise ValueError(
                "log stream mismatch: entry source tags disagree with "
                "acct % n_shards — the ring was written under a different "
                "shard geometry")
    mine = (acct % n_shards) == dead
    table, acct, vers, vals = (table[mine], acct[mine], vers[mine],
                               vals[mine])
    if not ((table < 2) & (acct < n_accounts)).all():
        raise ValueError("log key out of its table's range: the log "
                         "belongs to a different-geometry database")
    n_loc = n_acct_local(n_accounts, n_shards)
    rows = table * n_loc + acct // n_shards
    urows, idx = latest_per_row(rows, vers)
    bal = np.full(m1_local(n_accounts, n_shards), init_balance, np.uint32)
    bal[-1] = 0
    bal[urows] = vals[idx][:, 0]
    return bal


def _replay_columns(entries: torch.Tensor, heads: torch.Tensor,
                    val_words: int):
    """Live-slot mask, header words and value words of a [L, CAP, HDR+VW]
    ring, flattened to [L*CAP] streams in lane-major order."""
    _, cap, _ = entries.shape
    flags = entries[:, :, 0].reshape(-1)
    key_lo = entries[:, :, 2].reshape(-1)
    ver = entries[:, :, 3].reshape(-1)
    vals = entries[:, :, HDR_WORDS:HDR_WORDS + val_words].reshape(
        -1, val_words)
    slot = torch.arange(cap, device=entries.device)
    live = (slot[None, :]
            < torch.clamp(u32.to_u64(heads), max=cap)[:, None]).reshape(-1)
    return live, flags, key_lo, ver, vals


def _replay_winners(rows: torch.Tensor, ver: torch.Tensor,
                    live: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The mask of each row's winning live entry: a scatter-max of the u32
    ver+1 per row, then a scatter-max of the flat index over the entries
    that reach it, so a version tie goes to the last entry in ring order
    (`latest_per_row`'s rule) and each row has one winner. Non-live
    entries go to the extra slot n_rows."""
    dev = rows.device
    safe = torch.where(live, rows, n_rows)
    vp1 = (u32.to_u64(ver) + 1) & u32.MASK32
    best = torch.zeros(n_rows + 1, dtype=torch.int64, device=dev)
    best.scatter_reduce_(0, safe, vp1, "amax")
    cand = live & (vp1 == best[safe])
    fidx = torch.arange(rows.shape[0], device=dev)
    last = torch.full((n_rows + 1,), -1, dtype=torch.int64, device=dev)
    last.scatter_reduce_(0, torch.where(cand, rows, n_rows), fidx, "amax")
    return cand & (fidx == last[safe])


def replay_tatp_dense(db0, entries: torch.Tensor, heads: torch.Tensor):
    """The torch twin of `recover_tatp_dense` on db0's device, over one
    replica's ring view (`tables.log.replica_entries`) and the heads, on
    any device (copied to db0's)."""
    from .engines import tatp_dense as td

    dev = db0.meta.device
    entries, heads = entries.to(dev), heads.to(dev)
    vw = db0.val_words
    live, flags, key_lo, ver, vals = _replay_columns(entries, heads, vw)
    is_del = (flags & 0xFF) != 0
    table = u32.shr(flags, 8).to(torch.int64)
    m = db0.meta.shape[0]
    base = torch.as_tensor(td._bases(db0.n_sub + 1).astype(np.int64),
                           device=dev)
    rows = base[torch.clamp(table, max=4)] + u32.to_u64(key_lo)
    live = live & (table < 5) & (rows < m)
    keep = torch.nonzero(_replay_winners(rows, ver, live, m)).squeeze(1)
    wr = rows[keep]
    val = db0.val.clone().view(-1, vw)
    val[wr] = vals[keep]
    meta = db0.meta.clone()
    meta[wr] = u32.wrap_i32((u32.to_u64(ver[keep]) << 1)
                            | (~is_del[keep]).to(torch.int64))
    return _rebuilt_tatp(db0, val.view(-1), meta)


def replay_smallbank_dense(db0, entries: torch.Tensor, heads: torch.Tensor):
    """The torch twin of `recover_smallbank_dense` on db0's device (the
    ring copied there): the step resumes at the u32 ``max(live ver) + 2``,
    at least 2."""
    n = db0.n_accounts
    entries, heads = entries.to(db0.bal.device), heads.to(db0.bal.device)
    live, flags, key_lo, ver, vals = _replay_columns(entries, heads, SB_VW)
    table = u32.shr(flags, 8).to(torch.int64)
    key = u32.to_u64(key_lo)
    rows = table * n + key
    live = live & (table < 2) & (key < n)
    keep = torch.nonzero(
        _replay_winners(rows, ver, live, db0.bal.shape[0])).squeeze(1)
    bal = db0.bal.clone()
    bal[rows[keep]] = vals[keep, 0]
    top = int(torch.where(live, u32.to_u64(ver), 0).max())
    return _rebuilt_bank(db0, bal, max((top + 2) & u32.MASK32, 2))


def replay_sb_shard(bal0: torch.Tensor, entries: torch.Tensor,
                    heads: torch.Tensor, *, dead: int,
                    n_shards: int) -> torch.Tensor:
    """The torch twin of `recover_sb_shard` on ``bal0``'s device: partition
    ``dead``'s balances rebuilt from one ring that carries its stream, on
    any device (copied to ``bal0``'s), over ``bal0``, the init-balance
    local array (``m1_local`` words, sentinel last), which is not written.
    Returns a fresh int32 tensor."""
    entries, heads = entries.to(bal0.device), heads.to(bal0.device)
    live, flags, key_lo, ver, vals = _replay_columns(entries, heads, SB_VW)
    table = u32.shr(flags, 8).to(torch.int64)
    acct = u32.to_u64(key_lo)
    n_loc = (bal0.shape[0] - 1) // 2
    live = (live & (acct % n_shards == dead) & (table < 2)
            & (acct // n_shards < n_loc))
    rows = table * n_loc + acct // n_shards
    keep = torch.nonzero(
        _replay_winners(rows, ver, live, bal0.shape[0])).squeeze(1)
    bal = bal0.clone()
    bal[rows[keep]] = vals[keep, 0]
    return bal
