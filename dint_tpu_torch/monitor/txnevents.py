"""dinttrace event plane: the device-resident per-transaction flight
recorder (the port of `dint_tpu.monitor.txnevents`).

dintmon counts and dintscope times; this plane narrates: it records the
journey of sampled transactions through the waves (lock verdicts,
validate verdicts, installs, outcome classifications), one 16-byte record
per event, in a ring on the engine's device that rides the runner's
carry. The design is the JAX module's:

* **Deterministic sampling.** A lane is recorded iff
  ``murmur_mix(txn_id) & 0xFFFF < round(rate * 65536)``: a pure function
  of the txn id, so lower-rate event sets are subsets of higher-rate ones.
* **Keep-first overflow, loss-counted.** The ring is zeroed at each block
  entry; within a block the first `cap` sampled events are kept and the
  rest dropped. ``head`` keeps counting past `cap`, and monitored runs bump
  ``trace_dropped`` with the same number.
* **Drained at block boundaries** by `TxnMonitor`, to JSONL records that
  `monitor/txntrace.py` joins into per-transaction span trees.

Record layout (4 u32 words, schema 1), as in JAX:

    w0  txn id      engine-defined, stable across waves/retries/shards
    w1  bits 31..24 event kind (EV_*)
        bits 23..16 wave ordinal (index into waves.ALL_WAVES)
        bits 15..8  shard/device ordinal (0 on single-device engines)
        bits  7..0  aux payload: verdict bits / abort cause / hop / dest
    w2  step        db.step at emission (the engine's wave clock)
    w3  lane        flat lane index within the emitting wave

What differs from JAX:

* Words are int32 tensors holding u32 bit patterns (ops/u32.py); the
  murmur3 multiplies are done on int64-widened words in 16-bit limbs, so
  no int64 product overflows.
* **The spill tail.** JAX lands every candidate lane with one scatter-add
  under ``mode="drop"``, sending each unsampled or overflowed lane to its
  own out-of-bounds row. torch has no drop mode, and filtering the lanes
  (``nonzero``) would synchronise the host with the card. So the ring's
  buffer carries, past its `cap` rows, a spill tail of one row for each
  candidate lane of a step (`create_ring`'s ``spill``): such a lane goes
  to row ``cap + lane``, and every lane is written with ONE unique-index
  ``index_copy_``. The tail is scratch and is never decoded. Because the
  ring is zeroed at each block entry and the rows are unique, the copy
  equals JAX's add on the first ``cap * WORDS`` words, which with
  ``head`` are what parity compares.
* ``head`` stays on the device; nothing in `emit` reads back to the host.
* `TxnMonitor.observe(defer=True)` copies the ring on the device, starts
  a ``non_blocking`` copy into pinned host memory and records a CUDA
  event; the next observe or flush waits on the event and decodes. On a
  CPU ring the deferred copy is a clone. A failed copy raises.

Off means off: a runner built without ``trace`` threads no ring, and its
steps are what they are without the plane.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from ..device import resolve_device
from ..ops.u32 import MASK32, to_u64, wrap_i32
from . import counters as ctr
from . import waves
from .trace import DeferredCopy

SCHEMA = 1
WORDS = 4          # u32 words per event record

# ------------------------------------------------------------ event kinds
# Append-only: kind codes are baked into checked-in fixtures/artifacts.
EV_ROUTE = 1       # request left its source lane for an owner shard
EV_LOCK = 2        # lock arbitration verdict at the owner
EV_VALIDATE = 3    # OCC read-set re-check verdict
EV_VOTE = 4        # 2PC vote the source derives from its grant replies
EV_INSTALL = 5     # certified write landed in the primary table
EV_REPL = 6        # install record applied at a +off backup shard
EV_OUTCOME = 7     # final classification of the attempt (aux = cause)

KIND_NAMES: dict[int, str] = {
    EV_ROUTE: "route", EV_LOCK: "lock", EV_VALIDATE: "validate",
    EV_VOTE: "vote", EV_INSTALL: "install", EV_REPL: "repl",
    EV_OUTCOME: "outcome",
}

# EV_OUTCOME aux payload: the dintmon abort taxonomy, one code per ab_*
CAUSE_COMMIT = 0
CAUSE_LOCK = 1     # ab_lock
CAUSE_MISSING = 2  # ab_missing
CAUSE_VALIDATE = 3  # ab_validate
CAUSE_LOGIC = 4    # ab_logic

CAUSE_NAMES: dict[int, str] = {
    CAUSE_COMMIT: "commit", CAUSE_LOCK: "ab_lock",
    CAUSE_MISSING: "ab_missing", CAUSE_VALIDATE: "ab_validate",
    CAUSE_LOGIC: "ab_logic",
}

# EV_LOCK aux verdict bits
LOCK_GRANTED = 0x1
LOCK_HELD = 0x2    # rejected because the slot was held (vs lost the arb)

# EV_ROUTE aux bit: the hop crossed the DCN axis (2-D meshes only)
ROUTE_DCN = 0x40

I64 = torch.int64


@dataclasses.dataclass
class TxnRing:
    """The event ring: ``buf`` holds `cap` 4-word records, then the spill
    tail (``spill`` rows, never decoded); ``head`` counts the sampled
    events of this window, dropped ones included (an i32 scalar holding
    u32 bits)."""
    buf: torch.Tensor      # i32 [(cap + spill) * WORDS]
    head: torch.Tensor     # i32 scalar
    cap: int
    spill: int


@dataclasses.dataclass(frozen=True)
class TraceCfg:
    """Static trace configuration a runner closes over."""
    rate: float        # sampling rate in [0, 1]
    cap: int           # ring capacity in records
    wave: str = ""     # full scope name of the engine's trace wave

    @property
    def thresh(self) -> int:
        """16-bit sampling threshold; monotone in rate, so lower-rate
        event sets are strict subsets of higher-rate ones."""
        return max(0, min(65536, round(float(self.rate) * 65536)))


def trace_enabled(flag: bool | None = None) -> bool:
    """Builders' gate: explicit `trace=` wins, else DINT_TRACE=1."""
    if flag is not None:
        return bool(flag)
    return os.environ.get("DINT_TRACE", "0") == "1"


def trace_rate(rate: float | None = None) -> float:
    """Explicit `trace_rate=` wins, else DINT_TRACE_RATE (default 1.0)."""
    if rate is not None:
        return float(rate)
    return float(os.environ.get("DINT_TRACE_RATE", "1.0"))


def create_ring(cap: int, device=None, spill: int = 0) -> TxnRing:
    """A zeroed ring of ``cap`` records and a spill tail of ``spill`` rows
    (at least the candidate lanes of one step) on ``device`` (None means
    CUDA, and raises without one)."""
    dev = resolve_device(device)
    return TxnRing(buf=torch.zeros((int(cap) + int(spill)) * WORDS,
                                   dtype=torch.int32, device=dev),
                   head=torch.zeros((), dtype=torch.int32, device=dev),
                   cap=int(cap), spill=int(spill))


def reset(ring: TxnRing | None) -> TxnRing | None:
    """Zero the ring in place at a window boundary; None passes through."""
    if ring is not None:
        ring.buf.zero_()
        ring.head.zero_()
    return ring


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x holding u32 values, in 16-bit limbs of
    ``c`` so that no int64 product overflows."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def sample_mask(txn: torch.Tensor, thresh: int) -> torch.Tensor:
    """murmur3 finalizer over the txn id -> bottom 16 bits vs thresh."""
    x = to_u64(txn)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return (x & 0xFFFF) < thresh


def txn_ids(step: int, w: int, lane: torch.Tensor) -> torch.Tensor:
    """The dense engines' txn id ``step * w + lane`` in u32 arithmetic, as
    int64 values (``step`` the cohort's generation step)."""
    return ((((step & MASK32) * w) & MASK32) + to_u64(lane)) & MASK32


def ev(mask: torch.Tensor, txn, kind: int, wave_name: str, *, shard=0,
       aux=0, step=0, lane=None):
    """One candidate event group: `mask` [n] selects lanes, everything
    else broadcasts to [n] (tensors or Python ints; words are taken as
    u32). `wave_name` must be a registered waves.ALL_WAVES entry — the
    ordinal baked into w1 is its index."""
    n = int(mask.shape[0])
    dev = mask.device
    wave_ord = waves.ALL_WAVES.index(wave_name)

    def b(v):
        if isinstance(v, torch.Tensor):
            return to_u64(v).expand(n) if v.dim() == 0 else to_u64(v)
        return torch.full((n,), int(v) & MASK32, dtype=I64, device=dev)

    if lane is None:
        lane = torch.arange(n, dtype=I64, device=dev)
    return (mask, b(txn), b(kind), b(wave_ord), b(shard), b(aux), b(step),
            b(lane))


def emit(ring: TxnRing, cfg: TraceCfg, groups, counters=None):
    """Land one step's candidate events: concatenate the groups, sample by
    txn id, and write the packed records at head+rank with ONE
    unique-index copy (keep-first: unsampled lanes and candidates past
    `cap` go to their own rows of the spill tail). Updates the ring in
    place and returns (ring, counters); counters gains the window's
    `trace_dropped` delta when given."""
    mask = torch.cat([g[0] for g in groups])
    txn, kind, wave_ord, shard, aux, step, lane = (
        torch.cat([g[i] for g in groups]) for i in range(1, 8))
    n = int(mask.shape[0])
    if n > ring.spill:
        raise ValueError(f"{n} candidate lanes a step exceed the ring's "
                         f"spill tail of {ring.spill} rows")
    samp = mask & sample_mask(txn, cfg.thresh)
    s64 = samp.to(I64)
    pos = torch.cumsum(s64, 0) - s64                  # exclusive rank
    head = to_u64(ring.head)
    cap = ring.cap
    row = (head + pos) & MASK32
    lanes = torch.arange(n, dtype=I64, device=mask.device)
    row = torch.where(samp & (row < cap), row, cap + lanes)
    w1 = ((kind << 24) | ((wave_ord & 0xFF) << 16) | ((shard & 0xFF) << 8)
          | (aux & 0xFF))
    vals = wrap_i32(torch.stack([txn, w1, step, lane], dim=1))   # [n, 4]
    ring.buf.view(-1, WORDS).index_copy_(0, row, vals)
    new_head = (head + s64.sum()) & MASK32
    ring.head.copy_(wrap_i32(new_head))
    # events lost this step = growth of max(head, cap) beyond cap
    dropped = (torch.clamp(new_head, min=cap) - torch.clamp(head, min=cap))
    ctr.bump(counters, {ctr.CTR_TRACE_DROPPED: dropped})
    return ring, counters


# ------------------------------------------------------------- host side


def _u32_numpy(x) -> np.ndarray:
    """A host copy of ``x`` (tensor or array) as u32: never a view of a
    buffer the engine goes on writing."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", copy=True).numpy()
    a = np.array(x, copy=True)
    return a.view(np.uint32) if a.dtype == np.int32 else a.astype(np.uint32)


def decode(buf, head, cap: int) -> np.ndarray:
    """Recorded events of one drained ring, in append order: a u32
    [n, WORDS] array with n = min(head, cap) (keep-first overflow), copied
    to the host. The spill tail is never read."""
    n = int(min(int(_u32_numpy(head).reshape(())), int(cap)))
    return _u32_numpy(buf.reshape(-1)[:n * WORDS]).reshape(n, WORDS)


def dropped_of(head, cap: int) -> int:
    return max(0, int(_u32_numpy(head).reshape(())) - int(cap))


def unpack_w1(w1: int) -> tuple[int, int, int, int]:
    """w1 -> (kind, wave ordinal, shard, aux)."""
    w1 = int(w1)
    return ((w1 >> 24) & 0xFF, (w1 >> 16) & 0xFF, (w1 >> 8) & 0xFF,
            w1 & 0xFF)


class TxnMonitor:
    """Drives the event-ring drain at window boundaries, mirroring
    monitor.trace.Monitor for the counter plane: fetch each block's ring,
    decode it, and append one `txnevents` JSONL record (device 0: the
    port's engines run on one device).

    ``defer=True`` is the double buffer: the recorded words and the head
    are copied on the device and sent to pinned host memory without
    blocking (`trace.DeferredCopy`), and decoded at the NEXT observe or
    flush, so the drain does not hold the host behind the card."""

    def __init__(self, cfg: TraceCfg, path: str | None = None,
                 meta: dict | None = None):
        self.cfg = cfg
        self.windows: list[list[dict]] = []   # per window: records/device
        self._f = open(path, "w") if path else None
        self._window = 0
        self._pending: DeferredCopy | None = None
        self.total_events = 0
        self.total_dropped = 0
        rec = {"type": "txnmeta", "schema": SCHEMA,
               "rate": float(cfg.rate), "cap": int(cfg.cap),
               "waves": list(waves.ALL_WAVES)}
        rec.update(meta or {})
        self.meta = rec
        self._write(rec)

    def _write(self, rec: dict):
        if self._f is not None:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()

    def observe(self, ring: TxnRing, *, defer: bool = False):
        """Drain one window's ring. Returns the records of the completed
        window (the PREVIOUS one under ``defer``; None when pending)."""
        out = self.flush()
        words = ring.buf[:self.cfg.cap * WORDS]
        if defer:
            self._pending = DeferredCopy(words, ring.head)
            return out
        return self._process(words, ring.head)

    def flush(self):
        """Materialize a deferred window, if any."""
        if self._pending is None:
            return None
        pending, self._pending = self._pending, None
        return self._process(*pending.get())

    def _process(self, buf, head) -> list[dict]:
        events = decode(buf, head, self.cfg.cap)
        dropped = dropped_of(head, self.cfg.cap)
        rec = {"type": "txnevents", "window": self._window, "device": 0,
               "head": int(_u32_numpy(head).reshape(())),
               "cap": int(self.cfg.cap), "dropped": dropped,
               "events": events.astype(np.int64).tolist()}
        self._write(rec)
        self.total_events += len(events)
        self.total_dropped += dropped
        self.windows.append([rec])
        self._window += 1
        return [rec]

    def summary(self) -> dict:
        """The `"dinttrace"` artifact block the bench embeds."""
        drop_windows = sorted({r["window"] for w in self.windows
                               for r in w if r["dropped"]})
        return {"schema": SCHEMA, "rate": float(self.cfg.rate),
                "cap": int(self.cfg.cap), "windows": self._window,
                "events": int(self.total_events),
                "dropped": int(self.total_dropped),
                "dropped_windows": drop_windows}

    def close(self):
        if self._f is not None and not self._f.closed:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.flush()
        self.close()
