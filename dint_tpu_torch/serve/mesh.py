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
updated in place, and the placement: ``device`` None spreads the
partitions over the visible cards (`parallel.mesh.placement`), a device
puts them all on it. The engine draws and admits on the mesh's home
device; the runner hands each partition its draws and occupancies on its
own card. On one card the mesh's partitions share it, so the overlap
route reorders work and overlaps no link (`parallel/multihost_sb.py`).

**Across processes** (``group=``, a `parallel.dist.Group` of several
ranks, one a host or a block of hosts: JAX's engine under
``jax.distributed``, whose mesh spans the processes): every rank builds
the engine with the same arguments over its part of the mesh, and rank 0
leads. It alone owns the arrival stream, the clock, the per-host backlogs,
the controller with its journal and the service-time observations. Before
every runner call it broadcasts one int32 command (`dist.broadcast_ints`
on the host's group) ``[op, w, block_idx, hot_frac (2 words), occ
[H*C*cpb], shed [H*C*cpb]]``:

* ``BLOCK``: every rank runs the block at width ``w`` on the same ``occ``
  and ``shed`` and the same block index, so each draws the whole block
  alike (or replays ``draws=``) and keeps its partitions' slices;
* ``SWITCH``: every rank drains (`_detach`); rank 0 then makes the
  hot_frac choice from the counters (summed over the ranks) and sends it
  in a second ``SWITCH``, and every rank attaches at ``w``;
* ``IDLE``: a heartbeat, at most one each ``idle_poll_us`` while rank 0
  waits for arrivals, so a follower's wait, bounded by the group's
  timeout, never expires on a quiet schedule;
* ``STOP``: the end of ``run``.

A follower's ``run`` executes these commands and nothing else: it never
admits or serves on its own. Every rank retires its own blocks' stats,
the mesh's psum, so ``stats_total`` is equal on every rank; every read
of the counter ledger is summed over the ranks (`counters.sum_over`);
``run`` and ``snapshot`` return rank 0's report on every rank, with the
``processes``, the ``backend`` and each rank's cards (``rank_cards``).
``warmup`` and ``close`` run on every rank. A rank that dies, or a
command that never comes, makes the others raise within the group's
timeout. ``group`` None (or of one rank) is the one-process engine.
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from ..monitor import counters as mon
from ..parallel import dist
from .arrivals import ArrivalStream
from .controller import ControllerCfg, ServiceModel, WidthController
from .engine import ServeEngine, cached_runner

# the leader's commands (module docstring)
OP_BLOCK, OP_SWITCH, OP_IDLE, OP_STOP = 1, 2, 3, 4
_HEAD = 5                       # op, w, block_idx, hot_frac as 2 words


class MeshServeEngine(ServeEngine):
    """Open-loop SmallBank serving over the 2-D (dcn x ici) mesh.

    Parameters beyond ServeEngine's: ``mesh_shape`` = (n_hosts, n_ici)
    (>= 3 hosts: the replication's fault-domain rule); ``hierarchical``
    picks the ici-then-dcn exchange; ``overlap`` the double-buffered
    route; both None = the plan's, else ON / OFF. ``size`` is the global
    number of accounts. ``draws`` (block_idx, w) -> the runner's
    ``run.run_draws`` draw arguments (bits [cpb, H*C, w, 5], ts_amt [cpb,
    H*C, w]); for ``block_idx`` None, the drain's (none: ``()``).
    ``device``: the placement (None = the visible cards, one a partition
    where there are enough; over a group the rank's cards);
    ``self.mesh.cards`` lists the cards used. ``group``: a
    `parallel.dist.Group`, this process one rank of several (the module
    docstring); None: the whole mesh here."""

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
                 device=None, group=None):
        from ..parallel import multihost_sb as mhs
        self.n_hosts, self.n_ici = int(mesh_shape[0]), int(mesh_shape[1])
        self.mesh = mhs.make_mesh_2d(self.n_hosts, self.n_ici, device,
                                     group=group)
        self.n_devices = self.n_hosts * self.n_ici
        self.group = group
        self._across = group is not None and group.size > 1
        self._lead = not self._across or group.rank == 0
        self._cmd_len = _HEAD + 2 * self.n_devices * cohorts_per_block
        self._last_cmd = 0.0
        self.rank_cards = None if not self._across else dist.gather_objects(
            group, [str(c) for c in self.mesh.cards])
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
        self._send(OP_BLOCK, self._cur_w, occ, shed)
        self._launch(occ, shed)

    def _switch(self, w: int) -> None:
        """The width switch: every partition drains first (the mesh-wide
        barrier), then the hot_frac choice, then the attach at ``w``."""
        self._send(OP_SWITCH, w)
        if self._cur_w is not None:
            self._detach()
        self._maybe_rebuild_hot_frac()
        self._send(OP_SWITCH, w, hot_frac=self._hot_frac)
        self._attach(w)

    def _retire_one(self) -> None:
        if self._lead:
            super()._retire_one()
            return
        # a follower keeps the stats; the service times are the leader's
        stats, _, _ = self._pending.popleft()
        self._absorb_stats(stats.cpu().numpy().astype(np.int64))

    def _read_counters(self, counters) -> dict[str, int]:
        return mon.sum_over(self.group, mon.snapshot(counters))

    # -- the leader's commands ------------------------------------------

    def _send(self, op: int, w: int = 0, occ=None, shed=None,
              hot_frac=None) -> None:
        """Rank 0: broadcast one command (nothing in one process)."""
        if not self._across:
            return
        cmd = np.zeros(self._cmd_len, np.int32)
        hf = np.nan if hot_frac is None else float(hot_frac)
        cmd[:3] = [op, w, self._block_idx]
        cmd[3:_HEAD] = np.array([hf], np.float64).view(np.int32)
        n = self.n_devices * self.cpb
        if occ is not None:
            cmd[_HEAD:_HEAD + n] = np.asarray(occ, np.int32).reshape(-1)
            cmd[_HEAD + n:] = np.asarray(shed, np.int32).reshape(-1)
        dist.broadcast_ints(self.group, cmd, self._cmd_len)
        self._last_cmd = self._rel_now()

    def _recv(self):
        """A follower: the next command as (op, w, block_idx, hot_frac,
        occ [H, C, cpb], shed [H, C, cpb])."""
        cmd = dist.broadcast_ints(self.group, None, self._cmd_len)
        hf = float(cmd[3:_HEAD].copy().view(np.float64)[0])
        n = self.n_devices * self.cpb
        shape = (self.n_hosts, self.n_ici, self.cpb)
        return (int(cmd[0]), int(cmd[1]), int(cmd[2]),
                None if np.isnan(hf) else hf,
                cmd[_HEAD:_HEAD + n].reshape(shape),
                cmd[_HEAD + n:].reshape(shape))

    def _heartbeat(self) -> None:
        """Rank 0, idle: an IDLE command at most once each
        ``idle_poll_us`` since the last command."""
        if self._across and \
                self._rel_now() - self._last_cmd >= self.idle_poll_us * 1e-6:
            self._send(OP_IDLE)

    def _follow(self) -> dict:
        """A follower's ``run``: execute the leader's commands until
        STOP, then retire its blocks and return the leader's report."""
        if self._t0 is None:
            self._t0 = self.clock.now()
        while True:
            op, w, idx, _, occ, shed = self._recv()
            if op == OP_STOP:
                break
            if op == OP_IDLE:
                continue
            if op == OP_SWITCH:
                if self._cur_w is not None:
                    self._detach()
                op2, w2, _, hot_frac, _, _ = self._recv()
                if (op2, w2) != (OP_SWITCH, w):
                    raise RuntimeError(f"rank {self.group.rank}: a switch "
                                       f"to {w} answered by op {op2} at "
                                       f"{w2}")
                if hot_frac is not None:
                    self._use_hot_frac(hot_frac)
                self._attach(w)
                continue
            if op != OP_BLOCK or w != self._cur_w or \
                    idx != self._block_idx:
                raise RuntimeError(
                    f"rank {self.group.rank} out of step: op {op} at width "
                    f"{w}, block {idx}; this rank is at width "
                    f"{self._cur_w}, block {self._block_idx}")
            self._launch(occ, shed)
        self._retire_all()
        self._elapsed = self._rel_now()
        return self.snapshot()

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

    def run(self, schedule: np.ndarray | None, *,
            max_blocks: int | None = None) -> dict:
        """Serve ``schedule`` (the base class's ``run``). Across
        processes rank 0 serves its schedule and leads; a follower's
        ``schedule`` and ``max_blocks`` are ignored."""
        if not self._lead:
            return self._follow()
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
                self._heartbeat()
                continue

            w = self.ctl.width()
            if w != self._cur_w:
                self._switch(w)

            occ = self._fill_block(w)
            self._dispatch(occ, self._shed_mirror())

            if max_blocks is not None and self.blocks >= max_blocks:
                break

        self._retire_all()
        self._elapsed = self._rel_now()
        self._send(OP_STOP)
        return self.snapshot()

    # -- reporting ------------------------------------------------------

    def snapshot(self) -> dict:
        """The report (the base class's, with the mesh and the per-host
        split). Across processes every rank calls it together (the live
        counters are summed over the ranks) and gets rank 0's report, with
        ``processes``, ``backend`` and ``rank_cards``."""
        rep = super().snapshot()
        rep["mesh"] = {"n_hosts": self.n_hosts, "n_ici": self.n_ici,
                       "hierarchical": self.hierarchical,
                       "overlap": self.overlap}
        rep["per_host"] = [
            {"host": h, "admitted": self.admitted_by_host[h],
             "shed": self.shed_by_host[h]}
            for h in range(self.n_hosts)]
        if self._across:
            rep = dist.broadcast_object(self.group, rep)
            rep.update(processes=self.group.size,
                       backend=self.group.backend,
                       rank_cards=self.rank_cards)
        return rep
