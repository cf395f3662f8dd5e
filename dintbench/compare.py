"""The comparison that decides ``correct``.

Both sides' outputs (the measured system's after its drain, the plain
reference's after its replay of the same inputs) are reduced to chunk
digests: every int32 word, with its position, goes through the splitmix64
finaliser, and the results are summed mod 2^64 over chunks of 2^20
words. Two equal tensors give equal digests; a changed word changes its
chunk's digest but for a chance of 2^-64. So a side's state can be freed
(or live in another process) before the other side runs, and the count
of chunks that differ is the number compared: a tensor of another length
counts every chunk.

The checks, each a count with the limit 0 (an exact comparison):

* ``stats``: steps whose counts (attempted, committed, each abort cause,
  the bad magic words read, SmallBank's balance change) differ;
* ``tables``: chunks of the primary tables (TATP's meta and value words,
  SmallBank's balances) that differ;
* ``backups``: chunks of the backup copies that differ (sharded only);
* ``log``: chunks of the log replicas that differ, ``heads``: log lanes
  whose head differs;
* ``wrapped``: log lanes, on the system's side and on the reference's,
  whose appends since the ring was made (the head, a u32 count from 0)
  exceed the lane's capacity: such a ring has overwritten acknowledged
  writes, which the two sides would still agree on;
* ``locks``: lock words the system still holds after its drain;
* ``unanswered``: cohorts handed in whose counts never came back.
"""
from __future__ import annotations

import numpy as np
import torch

CHUNK = 1 << 20
PIECE = 1 << 24          # words a pass, to bound the temporaries
M64 = (1 << 64) - 1
C1 = 0xBF58476D1CE4E5B9 - (1 << 64)
C2 = 0x94D049BB133111EB - (1 << 64)

LIMITS = {"stats": 0, "tables": 0, "backups": 0, "log": 0, "heads": 0,
          "wrapped": 0, "locks": 0, "unanswered": 0}


def _shr(z: torch.Tensor, k: int) -> torch.Tensor:
    return (z >> k) & ((1 << (64 - k)) - 1)


def digest(x: torch.Tensor) -> np.ndarray:
    """Chunk digests (int64 [ceil(n / CHUNK)]) of ``x``'s int32 words in
    row-major order, with ``x``'s length as a last entry."""
    flat = x.reshape(-1)
    n = flat.numel()
    out = []
    for lo in range(0, n, PIECE):
        part = flat[lo:lo + PIECE].to(torch.int64) & 0xFFFFFFFF
        pos = torch.arange(lo, lo + part.numel(), device=part.device,
                           dtype=torch.int64)
        z = (pos << 32) | part
        z = (z ^ _shr(z, 30)) * C1
        z = (z ^ _shr(z, 27)) * C2
        z = z ^ _shr(z, 31)
        pad = (-z.numel()) % CHUNK
        if pad:
            z = torch.nn.functional.pad(z, (0, pad))
        out.append(z.view(-1, CHUNK).sum(1))
    d = torch.cat(out).cpu().numpy() if out else np.zeros(0, np.int64)
    return np.concatenate([d, np.asarray([n], np.int64)])


def digests(outputs: dict) -> dict:
    """Every output's digests, by name; small outputs (at most one chunk,
    as the log heads) are kept whole."""
    out = {}
    for k, v in outputs.items():
        if v.numel() <= 64:
            out[k] = ("whole", v.to(torch.int64).cpu().numpy())
        else:
            out[k] = ("digest", digest(v))
    return out


def differ(a, b) -> int:
    """Chunks (or, for small outputs, entries) in which two digests of
    `digests` differ."""
    (ka, va), (kb, vb) = a, b
    if ka != kb or va.shape != vb.shape:
        return max(len(va), len(vb))
    return int((va != vb).sum())


GROUPS = {"meta": "tables", "val": "tables", "bal": "tables",
          "log": "log", "heads": "heads", "bck": "backups"}


def group_of(name: str) -> str:
    base = name.split(".")[0].rstrip("0123456789")
    for prefix, g in GROUPS.items():
        if base.startswith(prefix):
            return g
    raise KeyError(name)


def heads(digests_: dict) -> list:
    """Every log lane's head (appends since the ring was made) in one
    side's `digests`."""
    return [int(x) for k, (kind, v) in sorted(digests_.items())
            if group_of(k) == "heads" for x in v]


def log_fill(digests_: dict, capacity: int) -> float:
    """The fullest lane's appends over its capacity (1.0: full)."""
    h = heads(digests_)
    return max(h) / capacity if h else 0.0


def checks(sys_digests: dict, ref_digests: dict, sys_stats: np.ndarray,
           ref_stats: np.ndarray, locks: int, unanswered: int,
           capacity: int) -> dict:
    """The counts the limits hold, by check name. Stats rows compare
    step by step; an output the reference has and the system lacks (or
    the other way) counts all its chunks. ``capacity``: entries a log
    lane holds."""
    out = {k: 0 for k in LIMITS}
    out["wrapped"] = sum(h > capacity for side in (sys_digests, ref_digests)
                         for h in heads(side))
    if sys_stats.shape != ref_stats.shape:
        out["stats"] = max(len(sys_stats), len(ref_stats))
    else:
        out["stats"] = int((sys_stats != ref_stats).any(1).sum())
    names = set(sys_digests) | set(ref_digests)
    for k in sorted(names):
        g = group_of(k)
        if k not in sys_digests or k not in ref_digests:
            have = sys_digests.get(k) or ref_digests.get(k)
            out[g] += len(have[1])
            continue
        out[g] += differ(sys_digests[k], ref_digests[k])
    out["locks"] = int(locks)
    out["unanswered"] = int(unanswered)
    return out


def verdict(counts: dict) -> bool:
    return all(counts[k] <= LIMITS[k] for k in LIMITS)


def report(counts: dict) -> dict:
    """``{name: [number, limit]}``, the result line's last key."""
    return {k: [counts[k], LIMITS[k]] for k in LIMITS}
