"""ServeEngine: the long-lived serving loop (the port of
`dint_tpu.serve.engine`).

It turns the batch-certification engines into a service: an open-loop
arrival stream (arrivals.py) fills variable-occupancy cohorts, a depth-k
pump keeps up to ``depth`` blocks in flight while the host fills the next
and retires the oldest, and an SLO controller (controller.py) adapts the
cohort width among a menu of serve runners, one per width, and sheds the
admissions the SLO can no longer cover.

Three structural commitments, each pinned by a test:

* **Serving is a masking of batch certification.** A block's cohorts are
  drawn full width, and the occupancy mask erases lanes >= occ after the
  draw. At occ == width the serve path is the closed-loop runner on the
  same draws.
* **No steady-state allocation of tables.** Every block of one width runs
  through the same runner on the same carry, updated in place: the
  tables' storage does not move block over block, and the memory the
  card holds is the same after each steady block.
* **Graceful degradation.** Past saturation the controller sits at the
  knee width and SHEDS (newest first) instead of stalling; every shed
  lane is tallied on the host and mirrored into the device counter
  ledger (serve_shed_lanes).

Clocking: a RealClock serves wall time (card runs); a VirtualClock plus
the controller's ServiceModel makes the loop (ingestion, width choices,
shedding) a deterministic function of (schedule, draws), which is how the
CPU tests hold it against the reference.

What differs from JAX:

* Draws. JAX draws block i from ``fold_in(PRNGKey(seed), i)``. The port
  draws it with a `torch.Generator` on the runner's device seeded
  ``block_seed(seed, i)``; warmup draws from seed 0. The ``draws``
  argument, a callable ``(block_idx, w) ->`` the draw arguments of the
  runner's ``run.run_draws`` (``block_idx`` None: those of its drain),
  replaces them, which is how the tests replay JAX's draws.
* The tables are updated in place, so `warmup` runs each width on a
  clone of the live tables (freed before serving) where JAX donates a
  copy. The runners are plain callables, one per width, so building one
  compiles nothing.
* The card runs eagerly and the runners read host scalars inside a
  block, so ``run`` returns after most of the block's host work: a
  block's ``service_us`` (dispatch to retire, under a RealClock) covers
  the host's enqueue of the block and the device's work left behind it.
  Retiring a block is one host copy of its stats.
* ``device`` (None = CUDA) places the tables and the runners; the mesh
  family is `serve.mesh.MeshServeEngine`'s.
"""
from __future__ import annotations

import collections
import time

import numpy as np
import torch

from ..device import resolve_device
from ..monitor import counters as mon
from ..stats import LatencyHistogram
from .arrivals import ArrivalStream
from .controller import (ControllerCfg, ServiceModel, WidthController,
                         recommend_hot_frac)


class RealClock:
    """Wall time (monotonic): serving on the card."""

    def now(self) -> float:
        return time.monotonic()

    def sleep(self, s: float) -> None:
        if s > 0:
            time.sleep(s)


class VirtualClock:
    """Deterministic time: advances only when told. Under it the serve
    loop never calls time.*, so two runs with the same schedule and draws
    are identical, every controller decision included."""

    def __init__(self):
        self.t = 0.0

    def now(self) -> float:
        return self.t

    def sleep(self, s: float) -> None:
        if s > 0:
            self.t += s


def block_seed(seed: int, block_idx: int) -> int:
    """The generator seed of block ``block_idx`` of an engine seeded
    ``seed``."""
    return ((int(seed) & 0x7FFFFFFF) << 32) | (int(block_idx) & 0xFFFFFFFF)


# process-wide (run, init, drain) cache: two ServeEngines over the same
# (engine, geometry, width, flags, device) share one runner
_RUNNER_CACHE: dict = {}


def cached_runner(engine: str, size: int, *, val_words: int = 4, **kw):
    """(run, init, drain) of a serve family's runner, built at most once
    per process per distinct (engine, size, val_words, kw): ``tatp_dense``
    and ``smallbank_dense`` (`build_pipelined_runner`), ``store``
    (`store.build_serve_runner`), ``multihost_sb``
    (`multihost_sb.build_multihost_sb_runner`, ``kw["mesh"]`` the 2-D
    mesh, which places it). ``kw`` goes to that function (``device`` None
    = CUDA). Unhashable kw values build uncached."""
    if engine == "multihost_sb":
        # the mesh places its runner
        mesh = kw["mesh"]
        if resolve_device(kw.get("device") or mesh.device) != mesh.device:
            raise ValueError(f"device {kw['device']} for a mesh on "
                             f"{mesh.device}")
        kw["device"] = mesh.device
    else:
        kw["device"] = resolve_device(kw.get("device"))
    try:
        key = (engine, size, val_words, tuple(sorted(kw.items())))
        hash(key)
    except TypeError:
        key = None
    if key is not None and key in _RUNNER_CACHE:
        return _RUNNER_CACHE[key]
    if engine == "tatp_dense":
        from ..engines import tatp_dense as td
        out = td.build_pipelined_runner(size, val_words=val_words, **kw)
    elif engine == "store":
        from ..engines import store as st
        out = st.build_serve_runner(size, val_words=val_words, **kw)
    elif engine == "smallbank_dense":
        from ..engines import smallbank_dense as sd
        out = sd.build_pipelined_runner(size, **kw)
    elif engine == "multihost_sb":
        # the mesh serving plane (serve/mesh.py): kw carries the 2-D mesh
        from ..parallel import multihost_sb as mhs
        mkw = dict(kw)
        del mkw["device"]
        out = mhs.build_multihost_sb_runner(mkw.pop("mesh"), size, **mkw)
    else:
        raise ValueError(f"no serve family {engine!r} (want tatp_dense | "
                         f"smallbank_dense | store | multihost_sb)")
    if key is not None:
        _RUNNER_CACHE[key] = out
    return out


class ServeEngine:
    """Long-lived serving plane over one engine family.

    Parameters
    ----------
    engine : 'tatp_dense' | 'smallbank_dense' | 'store'
    size : table size (n_sub / n_accounts / n_keys)
    cfg / model : controller config + service-time prior
    cohorts_per_block : steps a dispatched block runs
    depth : the pump's depth: the host runs at most ``depth`` blocks
        ahead of the oldest unretired block
    clock : RealClock (default) or VirtualClock (deterministic tests)
    monitor : thread the counter plane (needed for the serve counter
        reconciliation and hot_frac auto-sizing)
    runner_kw : forwarded to the runner's build function (mix, use_hotset,
        use_fused, hot_frac, use_scan, ...); always wins over the plan
    plan : "auto" (default) reads the pinned plan, PLAN_H100.json
        (`..plan`): the width menu + SLO come from the plan's serve
        priors when ``cfg`` is None, the ServiceModel when ``model`` is
        None, build knobs the
        plan pins for this family's serve workload fill ``runner_kw``,
        and the hot_frac prior seeds the rebuild loop. A plan dict is
        taken as it is, and the snapshot's plan source says
        ``"<document>"``; None reads no plan. Without a readable plan the
        snapshot records ``"plan": None``.
    adapt_hot_frac : rebuild the width menu at the recommended hot_frac at
        width-switch drain boundaries (the pipeline is empty there). None
        = on iff a hot_frac prior exists and the counter plane is on.
    draws : None, or ``(block_idx, w) ->`` the draw arguments of the
        runner's ``run.run_draws`` (``block_idx`` None: the drain's)
    device : where the tables and runners live (None = CUDA)
    """

    ENGINES: tuple[str, ...] = ("tatp_dense", "smallbank_dense", "store")

    def __init__(self, engine: str, size: int, *,
                 cfg: ControllerCfg | None = None,
                 model: ServiceModel | None = None,
                 cohorts_per_block: int = 2, depth: int = 2,
                 val_words: int = 4, clock=None, monitor: bool = True,
                 seed: int = 0, idle_poll_us: float = 50_000.0,
                 runner_kw: dict | None = None, plan="auto",
                 adapt_hot_frac: bool | None = None, draws=None,
                 device=None):
        assert engine in self.ENGINES, engine
        assert depth >= 1
        self.dev = resolve_device(device)
        self.engine = engine
        self.size = size
        self.cpb = cohorts_per_block
        self.depth = depth
        self.val_words = val_words
        self.clock = clock or RealClock()
        self.monitor = monitor
        self.idle_poll_us = idle_poll_us
        self.runner_kw = dict(runner_kw or {})
        self.draws = draws

        plan_knobs, priors, self.plan_meta = self._resolve_plan(plan)
        if cfg is None and priors:
            cfg = ControllerCfg(
                widths=tuple(sorted(int(w) for w in priors["widths"])),
                slo_us=float(priors["slo_us"]))
        self.cfg = cfg or ControllerCfg()
        if model is None and priors:
            model = ServiceModel(base_us=priors["model"]["base_us"],
                                 per_lane_ns=priors["model"]["per_lane_ns"])
        self.model = model or ServiceModel()
        self._apply_plan_knobs(plan_knobs)

        # the hot_frac rebuild loop: the caller's pin, else the plan's
        # prior; None = no hot tier prior, the loop stays off
        self._hot_frac = self.runner_kw.get("hot_frac")
        if self._hot_frac is None and priors:
            self._hot_frac = priors.get("hot_frac")
        if adapt_hot_frac is None:
            adapt_hot_frac = self._hot_frac is not None and self.monitor
        self.adapt_hot_frac = bool(adapt_hot_frac)
        self.hot_frac_rebuilds = 0

        self.seed = seed
        self.ctl = WidthController(self.cfg, self.model)

        # one runner per registered width, built up front
        self._runners = {w: self._build(w) for w in self.cfg.widths}

        self._db = self._fresh_db(seed)
        self._cur_w: int | None = None
        self._carry = None

        # host-side ledgers
        self.queue_hist = LatencyHistogram()     # per admitted lane (µs)
        self.service_hist = LatencyHistogram()   # per retired block (µs)
        self.stats_total = None                  # summed engine stats
        self.counters_total: dict[str, int] = {}
        self.shed_total = 0
        self._shed_pending = 0                   # awaiting the device mirror
        self.admitted_total = 0
        self.offered_total = 0
        self.blocks = 0
        self.steps_by_width: dict[int, int] = {w: 0 for w in self.cfg.widths}
        self._backlog: collections.deque[float] = collections.deque()
        self._pending: collections.deque = collections.deque()
        self._block_idx = 0
        self._t0 = None
        self._elapsed = 0.0

    # -- construction ---------------------------------------------------

    def _resolve_plan(self, plan):
        """-> (knobs, serve_priors | None, meta | None) for this family's
        serve workload; no plan, an unreadable one or a family without a
        serve workload gives ({}, None, None)."""
        if plan is None:
            return {}, None, None
        from .. import plan as P
        doc, source = plan, None
        if not isinstance(doc, dict):
            try:
                doc, source = P.load_plan(), str(P.plan_path())
            except (OSError, ValueError):
                return {}, None, None
        wname = P.SERVE_WORKLOADS.get(self.engine)
        if wname is None or wname not in doc.get("workloads", {}):
            return {}, None, None
        knobs, meta = P.resolve_for(wname, plan=doc, source=source)
        return knobs, doc["workloads"][wname].get("serve"), meta

    def _apply_plan_knobs(self, knobs: dict) -> None:
        """Plan-resolved build knobs fill what the caller left out of
        runner_kw (under DINT_PLAN_OVERRIDE=1 resolve_for has already
        folded the env flags in); explicit runner_kw always wins."""
        for k, v in knobs.items():
            self.runner_kw.setdefault(k, v)

    def _fresh_db(self, seed: int):
        if self.engine == "tatp_dense":
            from ..engines import tatp_dense as td
            return td.populate(np.random.default_rng(seed), self.size,
                               val_words=self.val_words, device=self.dev)
        if self.engine == "store":
            from ..clients import micro
            return micro.make_store_table(self.size,
                                          val_words=self.val_words,
                                          device=self.dev)
        from ..engines import smallbank_dense as sd
        return sd.create(self.size, device=self.dev)

    def _build(self, w: int):
        return cached_runner(
            self.engine, self.size, val_words=self.val_words,
            w=w, cohorts_per_block=self.cpb, monitor=self.monitor,
            serve=True, device=self.dev, **self.runner_kw)

    def warmup(self) -> None:
        """Run every registered width once (a block and its drain) on a
        clone of the tables before serving starts, so the first block a
        client waits on pays no kernel build; the live tables are never
        touched, and each clone is freed before the next."""
        from ..clients.tatp_client import clone_tree
        zeros = torch.zeros(self.cpb, dtype=torch.int32, device=self.dev)
        for w in self.cfg.widths:
            run, init, drain = self._runners[w]
            carry = init(clone_tree(self._db))
            gen = torch.Generator(device=self.dev)
            gen.manual_seed(0)
            carry, _ = run(carry, gen, zeros, zeros)
            drain(carry)
            del carry

    # -- width lifecycle ------------------------------------------------

    def _attach(self, w: int) -> None:
        """init at width w (first block or after a width-switch drain)."""
        _, init, _ = self._runners[w]
        self._carry = init(self._db)
        self._db = None          # the tables now live in the carry
        self._cur_w = w

    def _detach(self) -> None:
        """Drain the live pipeline: flush in-flight cohorts, absorb the
        tail stats and the device counter ledger, recover the tables."""
        self._retire_all()
        _, _, drain = self._runners[self._cur_w]
        args = () if self.draws is None else self.draws(None, self._cur_w)
        out = drain(self._carry, *args)
        self._carry = None
        db, tail = out[0], out[1]
        self._absorb_stats(tail.cpu().numpy().astype(np.int64))
        if self.monitor:
            snap = self._read_counters(out[-1])
            for k, v in snap.items():
                self.counters_total[k] = self.counters_total.get(k, 0) + v
        self._db = db
        self._cur_w = None

    def _read_counters(self, counters) -> dict[str, int]:
        """The {name: int} dict of the runner's device counter ledger
        (every read of it goes through here: the mesh plane across
        processes sums it over the ranks)."""
        return mon.snapshot(counters)

    def _absorb_stats(self, stats: np.ndarray) -> None:
        row = stats.astype(np.int64).sum(axis=0)
        self.stats_total = (row if self.stats_total is None
                            else self.stats_total + row)

    def _maybe_rebuild_hot_frac(self) -> None:
        """At a width-switch drain boundary (the pipeline is empty) fold
        the observed hot-tier counters into a new hot_frac and rebuild the
        width menu when the recommendation moved. With no hot-tier
        traffic the recommendation is the status quo and this is a no-op."""
        if not self.adapt_hot_frac or self._hot_frac is None:
            return
        rec = self.hot_frac_recommendation(self._hot_frac)
        self.ctl.journal_hot_frac(
            self._hot_frac, self.counters_total.get("hot_hits", 0),
            self.counters_total.get("hot_cold_rows", 0), rec)
        self._use_hot_frac(rec)

    def _use_hot_frac(self, rec: float) -> None:
        """Rebuild the width menu at hot_frac ``rec`` when it moved."""
        if rec == self._hot_frac:
            return
        self._hot_frac = rec
        self.runner_kw["hot_frac"] = rec
        self.hot_frac_rebuilds += 1
        self._runners = {w: self._build(w) for w in self.cfg.widths}

    # -- the pump -------------------------------------------------------

    def _dispatch(self, occ: np.ndarray, shed0: int) -> None:
        shed = np.zeros(self.cpb, np.int32)
        shed[0] = shed0
        self._launch(occ, shed)

    def _launch(self, occ: np.ndarray, shed: np.ndarray) -> None:
        """Run one block at the current width on ``occ``/``shed`` (the
        runner's shapes), keep its stats pending, retire past the depth."""
        run, _, _ = self._runners[self._cur_w]
        occ_t = torch.from_numpy(occ.astype(np.int32)).to(self.dev)
        shed_t = torch.from_numpy(shed.astype(np.int32)).to(self.dev)
        t_disp = self.clock.now()
        if self.draws is None:
            gen = torch.Generator(device=self.dev)
            gen.manual_seed(block_seed(self.seed, self._block_idx))
            self._carry, stats = run(self._carry, gen, occ_t, shed_t)
        else:
            self._carry, stats = run.run_draws(
                self._carry, *self.draws(self._block_idx, self._cur_w),
                occ_t, shed_t)
        self._pending.append((stats, t_disp, self._cur_w))
        self._block_idx += 1
        self.blocks += 1
        self.steps_by_width[self._cur_w] += self.cpb
        if isinstance(self.clock, VirtualClock):
            # the model IS the device under virtual time
            self.clock.sleep(self.cpb * self.model.service_us(self._cur_w)
                             * 1e-6)
        if len(self._pending) >= self.depth:
            self._retire_one()

    def _retire_one(self) -> None:
        stats, t_disp, w = self._pending.popleft()
        host = stats.cpu().numpy().astype(np.int64)   # waits for the block
        if isinstance(self.clock, VirtualClock):
            service_us = self.cpb * self.model.service_us(w)
        else:
            service_us = max((self.clock.now() - t_disp) * 1e6, 1e-3)
        self._absorb_stats(host)
        self.service_hist.add(service_us)
        self.ctl.observe_service(w, service_us / self.cpb)

    def _retire_all(self) -> None:
        while self._pending:
            self._retire_one()

    # -- the serving loop -----------------------------------------------

    def _rel_now(self) -> float:
        return self.clock.now() - self._t0

    def _ingest(self, stream: ArrivalStream, dt: float) -> None:
        got = stream.take_until(self._rel_now())
        self.offered_total += len(got)
        self._backlog.extend(got.tolist())
        if dt > 0:
            self.ctl.observe_rate(len(got) / dt)

    def _admit(self) -> int:
        """Shed the newest arrivals past the SLO-feasible backlog bound.
        Returns the lanes shed this poll (also queued for the device
        mirror)."""
        cap = self.ctl.max_backlog()
        backlog0 = len(self._backlog)
        shed = 0
        while len(self._backlog) > cap:
            self._backlog.pop()               # newest first
            shed += 1
        if shed:
            self.ctl.journal_shed(backlog0, shed)
        self.shed_total += shed
        self._shed_pending += shed
        return shed

    def _fill_block(self, w: int) -> np.ndarray:
        """Pop FIFO arrivals into per-cohort occupancies and charge each
        admitted lane its queueing delay (dispatch - arrival)."""
        occ = np.zeros(self.cpb, np.int32)
        t = self._rel_now()
        for i in range(self.cpb):
            n = min(len(self._backlog), w)
            occ[i] = n
            if n:
                ts = np.fromiter((self._backlog.popleft() for _ in range(n)),
                                 np.float64, count=n)
                self.queue_hist.add(np.maximum(t - ts, 0.0) * 1e6)
        self.admitted_total += int(occ.sum())
        return occ

    def run(self, schedule: np.ndarray, *, max_blocks: int | None = None
            ) -> dict:
        """Serve one arrival schedule to completion (every arrival served
        or shed), retire every block, and return the report. Re-entrant:
        a second schedule continues on the same tables."""
        stream = ArrivalStream(schedule)
        if self._t0 is None:
            self._t0 = self.clock.now()
        last_poll = self._rel_now()

        while True:
            now = self._rel_now()
            self._ingest(stream, now - last_poll)
            last_poll = now
            self._admit()

            if not self._backlog:
                if stream.exhausted:
                    break
                nxt = stream.peek() - self._rel_now()
                # idle: park until the next arrival (bounded by the idle
                # poll, so a real server still services its control plane)
                self.clock.sleep(max(min(nxt, self.idle_poll_us * 1e-6),
                                     1e-9))
                continue

            w = self.ctl.width()
            if w != self._cur_w:
                if self._cur_w is not None:
                    self._detach()
                self._maybe_rebuild_hot_frac()
                self._attach(w)

            occ = self._fill_block(w)
            shed0, self._shed_pending = self._shed_pending, 0
            self._dispatch(occ, shed0)

            if max_blocks is not None and self.blocks >= max_blocks:
                break

        self._retire_all()
        self._elapsed = self._rel_now()
        return self.snapshot()

    def close(self) -> None:
        """Flush and drain; the tables come back into self._db."""
        if self._cur_w is not None:
            self._detach()

    # -- reporting ------------------------------------------------------

    def hot_frac_recommendation(self, cur: float) -> float:
        """The hot_frac the observed hot-tier counters recommend (applied
        at the next rebuild)."""
        return recommend_hot_frac(
            cur, self.counters_total.get("hot_hits", 0),
            self.counters_total.get("hot_cold_rows", 0))

    def snapshot(self) -> dict:
        elapsed = self._elapsed or max(self._rel_now(), 1e-9)
        qp, sp = self.queue_hist.percentiles(), self.service_hist.percentiles()
        counters = dict(self.counters_total)
        if self.monitor and self._carry is not None:
            # a peek at the live ledger (absorbed for real at the next
            # drain), so a snapshot reconciles mid-flight
            for k, v in self._read_counters(self._carry[-1]).items():
                counters[k] = counters.get(k, 0) + v
        committed = attempted = 0
        if self.stats_total is not None:
            # column 0 is attempted and column 1 committed in every family
            attempted, committed = int(self.stats_total[0]), \
                int(self.stats_total[1])
        return {
            "engine": self.engine,
            "widths": list(self.cfg.widths),
            "blocks": self.blocks,
            "steps_by_width": {str(k): v
                               for k, v in self.steps_by_width.items()},
            "offered": self.offered_total,
            "admitted": self.admitted_total,
            "shed": self.shed_total,
            "attempted": attempted,
            "committed": committed,
            "elapsed_s": elapsed,
            "offered_rate": self.offered_total / elapsed,
            "achieved_rate": committed / elapsed,
            "slo_us": self.cfg.slo_us,
            "slo_met": qp["p99"] <= self.cfg.slo_us,
            "queue": {**qp, "hist": self.queue_hist.to_dict()},
            "service": {**sp, "hist": self.service_hist.to_dict()},
            "controller": self.ctl.snapshot(),
            "counters": counters,
            "plan": self.plan_meta,
            "hot_frac": {"current": self._hot_frac,
                         "adaptive": self.adapt_hot_frac,
                         "rebuilds": self.hot_frac_rebuilds},
        }
