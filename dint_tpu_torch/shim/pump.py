"""EnginePump: a server engine served over the native UDP shim (the port of
`dint_tpu.shim.pump`).

The C++ pump (native/shim.cc) gathers reference-wire-format datagrams into
a fixed-width batch; this class maps wire codes to engine ops (the
`shim.wire` profiles), pads the batch to ``width`` lanes on PAD_KEY, runs
the engine's step, maps the Reply codes back and hands the reply arrays to
C++, which scatters them with sendmmsg.

The serve loop keeps up to ``depth - 1`` dispatched batches in flight
behind the one being polled, and counts what JAX's counts: batches,
occupied and padded lanes, the C++ ring's shed datagrams, and one queue and
one service sample a batch.

What differs from JAX: the step is called eagerly on the pump's state
(``step_fn(state, batch) -> (state, replies)``; the port's generic steps
update their state in place, where JAX jits the step and donates the
state), and batches are built on ``device`` (None = CUDA; a missing card
raises). The steps read their replies back to the host in `nonzero` and
friends, so a dispatch returns once most of its step has run; the depth-k
loop is kept so that what it does and counts matches JAX's.
"""
from __future__ import annotations

import collections
import threading
import time

import numpy as np

from ..device import resolve_device
from ..engines.types import make_batch
from ..ops.u32 import to_numpy
from ..stats import LatencyHistogram
from .native import VAL_SIZE, ShimServer
from .wire import Profile


class EnginePump:
    """Owns an engine's state and serves the batches a ShimServer polls.

    Every batch is stamped at poll return (arrival on the host), at step
    dispatch and after its replies went out: ``queue_hist`` holds arrival
    -> dispatch, ``service_hist`` dispatch -> replies on the wire (one
    sample a batch each); `latency_snapshot` gives both."""

    def __init__(self, profile: Profile, step_fn, state, width: int = 4096,
                 port: int = 0, flush_us: int = 200, val_words: int = 10,
                 depth: int = 2, idle_poll_us: int = 50_000, device=None):
        if depth < 1:
            raise ValueError(f"EnginePump: depth must be >= 1, got {depth}")
        self.device = resolve_device(device)
        self.profile = profile
        self.state = state
        self.width = width
        self.val_words = val_words
        self.depth = depth              # serve_forever keeps <= depth-1
        self.idle_poll_us = idle_poll_us  # .. in flight; poll bound idle
        self._step = step_fn
        self.server = ShimServer(port=port, width=width, flush_us=flush_us,
                                 fmt=profile.fmt)
        self.port = self.server.port
        self.batches_served = 0
        self.occupancy_lanes = 0        # real requests across served batches
        self.padded_lanes = 0           # width - occupancy, summed
        self.queue_hist = LatencyHistogram()
        self.service_hist = LatencyHistogram()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _dispatch(self, got, t_arrival: float | None = None):
        """Translate a polled batch and run the step. The ring slot's views
        are read here only: `make_batch` copies them and ``type`` is copied
        before the reply, so only the slot id and the reply metadata
        survive. Returns the pending record `_finish` takes."""
        slot, b = got
        n = len(b["key"])
        wire_type = b["type"].copy()
        ops = self.profile.to_ops(wire_type, b["table"])
        vals = np.ascontiguousarray(b["val"]).view(np.uint32)
        vals = vals[:, :self.val_words]
        batch = make_batch(ops, b["key"], vals=vals, vers=b["ver"],
                           tables=b["table"].astype(np.int32),
                           width=self.width, val_words=self.val_words,
                           device=self.device)
        t_disp = time.monotonic()
        self.state, replies = self._step(self.state, batch)
        self.occupancy_lanes += n
        self.padded_lanes += self.width - n
        if t_arrival is not None:
            self.queue_hist.add(max(t_disp - t_arrival, 0.0) * 1e6)
        return slot, n, wire_type, replies, t_disp

    def _finish(self, pending):
        """Read a dispatched batch's replies back and scatter them over the
        wire: type, the value words as u32 bytes, ver as u32."""
        slot, n, wire_type, replies, t_disp = pending
        rtype = replies.rtype[:n].cpu().numpy()
        rval32 = to_numpy(replies.val[:n, :self.val_words])
        rver = to_numpy(replies.ver[:n])
        wire_reply = self.profile.to_wire(wire_type, rtype)
        rval = np.zeros((n, VAL_SIZE), np.uint8)
        rval[:, :self.val_words * 4] = np.ascontiguousarray(
            rval32).view(np.uint8).reshape(n, -1)
        self.server.reply(slot, wire_reply, rval, rver)
        self.service_hist.add((time.monotonic() - t_disp) * 1e6)
        self.batches_served += 1

    def latency_snapshot(self) -> dict:
        """The queue/service split (percentiles and the exact histograms,
        one sample a served batch) and the occupancy accounting: width, real
        and padded lanes (occupancy + padded == width * batches), and the
        datagrams the C++ ring dropped before the host saw them
        ("shed")."""
        def side(h):
            return {**{f"{k}_us": round(v, 2)
                       for k, v in h.percentiles().items()},
                    "hist": h.to_dict()}

        return {"batches": self.batches_served,
                "width": self.width,
                "depth": self.depth,
                "occupancy_lanes": self.occupancy_lanes,
                "padded_lanes": self.padded_lanes,
                "shed": int(self.server.stats()["dropped"]),
                "queue": side(self.queue_hist),
                "service": side(self.service_hist)}

    def serve_one(self, timeout_us: int = 100_000) -> bool:
        """Poll one batch, run it and reply. True if a batch ran."""
        got = self.server.poll(timeout_us)
        if got is None:
            return False
        self._finish(self._dispatch(got, time.monotonic()))
        return True

    def serve_forever(self):
        """The depth-k loop: up to ``depth - 1`` dispatched batches stay in
        flight behind the one being polled. While any is in flight the poll
        does not block: a ready batch is dispatched, else the oldest
        pending replies go out at once (closed-loop clients wait on them);
        an idle pump blocks ``idle_poll_us`` a poll."""
        pending = collections.deque()
        while not self._stop.is_set():
            got = self.server.poll(
                timeout_us=0 if pending else self.idle_poll_us)
            if got is not None:
                pending.append(self._dispatch(got, time.monotonic()))
                if len(pending) < self.depth:
                    continue            # room to run ahead: poll again
            while pending:
                self._finish(pending.popleft())
                if got is not None:
                    break               # keep only the freshest in flight
        while pending:
            self._finish(pending.popleft())

    def start(self):
        """Run `serve_forever` on a background thread."""
        self._thread = threading.Thread(target=self.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join()
            self._thread = None

    def close(self):
        self.stop()
        self.server.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
