"""MeshServeEngine: the whole (hosts x chips) mesh as one open-loop
transactional service (the port of `dint_tpu.serve.mesh`).

It composes the single-device serving plane (`engine.ServeEngine`) with
the serve route of `parallel/multihost_sb.py`:

* **Per-host admission, one global controller.** Arrival k goes to host k
  mod H at ingest (a stand-in for H independent NIC queues, deterministic
  under a VirtualClock); each host sheds newest-first against its own
  backlog bound (the single-device bound times the chips it feeds), and
  one `WidthController` in per-partition units (``lanes_scale = H*C``)
  picks the width every partition serves at.
* **Mesh-coordinated width switches.** A width switch drains the runner
  on every partition (flush steps, tail stats, the counters) before the
  next width attaches, so no partition runs another width than its peers.
* **Shed mirror across the mesh.** Host h's shed tally rides the next
  block at occupancy/shed slot [h, 0, 0], so the device's
  ``serve_shed_lanes`` reconciles with the per-host tallies.
* **Plan knobs.** ``hierarchical`` and ``overlap`` left at None come from
  the pinned plan's ``multihost_serve`` workload (PLAN_H100.json), else
  ON and OFF.

Under a VirtualClock the ServiceModel is the device (one block advances
virtual time by cpb x service_us(w)), so two runs with the same schedule
and draws give the same report. What differs from JAX is the base
class's (`engine.py`): the draws (``draws=`` replays JAX's), the tables
updated in place, ``device`` (None = CUDA) the mesh's device. On one card
the mesh's partitions share it, so the overlap route reorders work and
overlaps no link (`parallel/multihost_sb.py`).
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from .arrivals import ArrivalStream
from .controller import ControllerCfg, ServiceModel, WidthController
from .engine import ServeEngine, cached_runner


class MeshServeEngine(ServeEngine):
    """Open-loop SmallBank serving over the 2-D (dcn x ici) mesh.

    Parameters beyond ServeEngine's: ``mesh_shape`` = (n_hosts, n_ici)
    (>= 3 hosts: the replication's fault-domain rule); ``hierarchical``
    picks the ici-then-dcn exchange; ``overlap`` the double-buffered
    route; both None = the plan's, else ON / OFF. ``size`` is the global
    number of accounts. ``draws`` (block_idx, w) -> the runner's
    ``run.run_draws`` draw arguments (bits [cpb, H*C, w, 5], ts_amt [cpb,
    H*C, w]); for ``block_idx`` None, the drain's (none: ``()``)."""

    ENGINES = ("multihost_sb",)

    def __init__(self, n_accounts: int, *,
                 mesh_shape: tuple[int, int] = (4, 2),
                 cfg: ControllerCfg | None = None,
                 model: ServiceModel | None = None,
                 cohorts_per_block: int = 2, depth: int = 2,
                 clock=None, monitor: bool = True, seed: int = 0,
                 idle_poll_us: float = 50_000.0,
                 hierarchical: bool | None = None,
                 overlap: bool | None = None,
                 runner_kw: dict | None = None, plan="auto",
                 adapt_hot_frac: bool | None = None, draws=None,
                 device=None):
        from ..parallel import multihost_sb as mhs
        self.n_hosts, self.n_ici = int(mesh_shape[0]), int(mesh_shape[1])
        self.mesh = mhs.make_mesh_2d(self.n_hosts, self.n_ici, device)
        self.n_devices = self.n_hosts * self.n_ici
        self.hierarchical = hierarchical
        self.overlap = overlap
        super().__init__("multihost_sb", n_accounts, cfg=cfg, model=model,
                         cohorts_per_block=cohorts_per_block, depth=depth,
                         clock=clock, monitor=monitor, seed=seed,
                         idle_poll_us=idle_poll_us, runner_kw=runner_kw,
                         plan=plan, adapt_hot_frac=adapt_hot_frac,
                         draws=draws, device=self.mesh.device)
        # one global controller in per-partition units: D cohorts of width
        # w serve every step
        self.ctl = WidthController(self.cfg, self.model,
                                   lanes_scale=self.n_devices)
        # per-host admission (the base class's _backlog stays unused)
        self._host_backlog: list[collections.deque] = [
            collections.deque() for _ in range(self.n_hosts)]
        self._host_shed_pending = [0] * self.n_hosts
        self.shed_by_host = [0] * self.n_hosts
        self.admitted_by_host = [0] * self.n_hosts
        self._arrival_idx = 0

    # -- construction ---------------------------------------------------

    def _apply_plan_knobs(self, knobs: dict) -> None:
        """hierarchical/overlap are attributes here, not runner_kw: taken
        from the plan where the caller left them None, else ON / OFF.
        Runs inside ServeEngine's __init__ before the runners are built."""
        if self.hierarchical is None:
            self.hierarchical = bool(knobs.get("hierarchical", True))
        if self.overlap is None:
            self.overlap = bool(knobs.get("overlap", False))
        super()._apply_plan_knobs(
            {k: v for k, v in knobs.items()
             if k not in ("hierarchical", "overlap")})

    def _fresh_db(self, seed: int):
        from ..parallel import multihost_sb as mhs
        return mhs.create_multihost_sb(self.mesh, self.size)

    def _build(self, w: int):
        return cached_runner(
            "multihost_sb", self.size, mesh=self.mesh, w=w,
            cohorts_per_block=self.cpb, monitor=self.monitor,
            hierarchical=self.hierarchical, serve=True,
            overlap=self.overlap, **self.runner_kw)

    def warmup(self) -> None:
        """Each width once (a block and its drain) on a clone of the
        partitions' tables, freed before the next: the live tables are
        never touched."""
        from ..clients.tatp_client import clone_tree
        zeros = torch.zeros((self.n_hosts, self.n_ici, self.cpb),
                            dtype=torch.int32, device=self.dev)
        for w in self.cfg.widths:
            run, init, drain = self._runners[w]
            carry = init([clone_tree(st) for st in self._db])
            gen = torch.Generator(device=self.dev)
            gen.manual_seed(0)
            carry, _ = run(carry, gen, zeros, zeros)
            drain(carry)
            del carry

    # -- the pump and per-host admission --------------------------------

    def _dispatch(self, occ: np.ndarray, shed: np.ndarray) -> None:
        self._launch(occ, shed)

    def _ingest(self, stream: ArrivalStream, dt: float) -> None:
        got = stream.take_until(self._rel_now())
        self.offered_total += len(got)
        for ts in got.tolist():
            self._host_backlog[self._arrival_idx % self.n_hosts].append(ts)
            self._arrival_idx += 1
        if dt > 0:
            # the global rate; the controller converts to per-partition
            self.ctl.observe_rate(len(got) / dt)

    def _admit(self) -> int:
        """Per-host newest-first shedding: each host's bound is the
        single-device backlog bound times the n_ici chips it feeds."""
        cap = self.ctl.max_backlog() * self.n_ici
        shed = 0
        for h, bl in enumerate(self._host_backlog):
            backlog0 = len(bl)
            host_shed = 0
            while len(bl) > cap:
                bl.pop()                      # newest first
                self.shed_by_host[h] += 1
                self._host_shed_pending[h] += 1
                host_shed += 1
            if host_shed:
                self.ctl.journal_shed(backlog0, host_shed,
                                      scale=self.n_ici, host=h)
            shed += host_shed
        self.shed_total += shed
        self._shed_pending += shed
        return shed

    def _fill_block(self, w: int) -> np.ndarray:
        """Per-host FIFO fill into [H, C, cpb] occupancies (cohort-major
        across the host's chips), each admitted lane charged its queueing
        delay."""
        occ = np.zeros((self.n_hosts, self.n_ici, self.cpb), np.int32)
        t = self._rel_now()
        for h, bl in enumerate(self._host_backlog):
            for i in range(self.cpb):
                for c in range(self.n_ici):
                    n = min(len(bl), w)
                    occ[h, c, i] = n
                    if n:
                        ts = np.fromiter(
                            (bl.popleft() for _ in range(n)),
                            np.float64, count=n)
                        self.queue_hist.add(np.maximum(t - ts, 0.0) * 1e6)
            self.admitted_by_host[h] += int(occ[h].sum())
        self.admitted_total += int(occ.sum())
        return occ

    def _shed_mirror(self) -> np.ndarray:
        """The pending per-host shed tallies onto the device ledger: host
        h's count rides slot [h, 0, 0] of the next block."""
        shed = np.zeros((self.n_hosts, self.n_ici, self.cpb), np.int32)
        for h in range(self.n_hosts):
            shed[h, 0, 0] = self._host_shed_pending[h]
            self._host_shed_pending[h] = 0
        self._shed_pending = 0
        return shed

    # -- the serving loop -----------------------------------------------

    def run(self, schedule: np.ndarray, *, max_blocks: int | None = None
            ) -> dict:
        stream = ArrivalStream(schedule)
        if self._t0 is None:
            self._t0 = self.clock.now()
        last_poll = self._rel_now()

        while True:
            now = self._rel_now()
            self._ingest(stream, now - last_poll)
            last_poll = now
            self._admit()

            if not any(self._host_backlog):
                if stream.exhausted:
                    break
                nxt = stream.peek() - self._rel_now()
                self.clock.sleep(max(min(nxt, self.idle_poll_us * 1e-6),
                                     1e-9))
                continue

            w = self.ctl.width()
            if w != self._cur_w:
                # the switch drains every partition first: the mesh-wide
                # barrier
                if self._cur_w is not None:
                    self._detach()
                self._maybe_rebuild_hot_frac()
                self._attach(w)

            occ = self._fill_block(w)
            self._dispatch(occ, self._shed_mirror())

            if max_blocks is not None and self.blocks >= max_blocks:
                break

        self._retire_all()
        self._elapsed = self._rel_now()
        return self.snapshot()

    # -- reporting ------------------------------------------------------

    def snapshot(self) -> dict:
        rep = super().snapshot()
        rep["mesh"] = {"n_hosts": self.n_hosts, "n_ici": self.n_ici,
                       "hierarchical": self.hierarchical,
                       "overlap": self.overlap}
        rep["per_host"] = [
            {"host": h, "admitted": self.admitted_by_host[h],
             "shed": self.shed_by_host[h]}
            for h in range(self.n_hosts)]
        return rep
