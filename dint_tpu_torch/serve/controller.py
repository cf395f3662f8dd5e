"""The SLO-driven cohort-width controller of the serving plane (the port's
copy of `dint_tpu.serve.controller`, numpy only).

The serving plane builds one serve runner per REGISTERED width, so
adaptivity means choosing among a small fixed menu. The controller's
inputs are the per-block SERVICE time of each width (observed,
EWMA-smoothed, seeded from a ServiceModel prior) and the QUEUE delay the
offered rate implies. Everything here is a pure function of (observed
rates, observed service times, config), with no wall clock and no RNG,
so under a VirtualClock the width trajectory is a deterministic function
of the arrival schedule.

Width policy (one decision rule, stated once):

  capacity(w)  = w / service_s(w)          [lanes per second]
  feasible(w)  = capacity(w) >= offered * headroom
                 and block_time(w) <= slo_fraction * slo
  choose       = smallest feasible width   (smallest => lowest latency:
                 a half-empty big cohort pays the big cohort's service
                 time on every admitted txn)
  none feasible=> knee width (max capacity) + saturated flag: past
                 saturation throughput is maximized and admission
                 control sheds the excess rather than stall.

Admission policy: the backlog a queue can hold while still meeting the
SLO is capacity * slo seconds of work; arrivals beyond it are shed
(newest first: the oldest waiters are closest to their deadline).
Shed lanes are counted on the host AND mirrored into the device counter
ledger (serve_shed_lanes).

Decision journal: every control decision (width re-evaluation,
admission shed, hot_frac evaluation) is appended to
``WidthController.journal`` as a schema-stable entry carrying the exact
inputs the pure policy functions consumed next to the outcome, so a
journal can be replayed through choose_width / max_backlog /
recommend_hot_frac decision for decision.

The ServiceModel's defaults and PLAN.json's serve priors are the
reference's (calibrated for a TPU); they seed the controller, and the
service times it observes on the card replace them block by block.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# bumped when the journal header/entry shapes change; an audit
# refuses journals it does not understand rather than mis-replaying them
JOURNAL_SCHEMA = 1

# keep-first cap on the (width, service_us) fit-sample ledger: 2-param
# least squares saturates long before this, and keep-first (never
# reservoir) preserves VirtualClock determinism
SAMPLE_CAP = 512


@dataclasses.dataclass(frozen=True)
class ServiceModel:
    """Prior for per-block service time by width, used to seed the
    controller's EWMA before any block of that width has run (and as the
    whole truth under a VirtualClock, where nothing is measured).

    ``base_us`` is the width-independent dispatch floor (host->device
    hop + kernel launch); ``per_lane_ns`` the marginal lane cost. Both
    are calibratable from one bench.py run; the DEFAULTS are CPU-scale
    so virtual tests exercise realistic shapes.
    """
    base_us: float = 150.0
    per_lane_ns: float = 40.0

    def service_us(self, width: int) -> float:
        return self.base_us + width * self.per_lane_ns * 1e-3


@dataclasses.dataclass(frozen=True)
class ControllerCfg:
    """Knobs for the width/admission controller."""
    widths: tuple[int, ...] = (256, 1024, 4096, 8192)
    slo_us: float = 5_000.0        # p99 queueing-delay objective
    headroom: float = 1.25         # capacity must beat offered by this
    slo_fraction: float = 0.5      # block time may eat this much of SLO
    rate_alpha: float = 0.3        # EWMA weight for offered-rate estimate
    service_alpha: float = 0.2     # EWMA weight for service-time samples
    hysteresis_blocks: int = 4     # min blocks between width switches

    def __post_init__(self):
        assert self.widths == tuple(sorted(self.widths)), \
            "widths must be ascending"


def choose_width(offered_rate: float, service_us: dict[int, float],
                 cfg: ControllerCfg) -> tuple[int, bool]:
    """Pick the serving width for an offered rate (lanes/s) given the
    current per-width service-time estimates. Returns (width,
    saturated). Pure — this is the function the determinism test pins."""
    best_cap, knee = -1.0, cfg.widths[-1]
    for w in cfg.widths:
        s = service_us[w] * 1e-6
        cap = w / s
        if cap > best_cap:
            best_cap, knee = cap, w
        ok_rate = cap >= offered_rate * cfg.headroom
        ok_slo = service_us[w] <= cfg.slo_fraction * cfg.slo_us
        if ok_rate and ok_slo:
            return w, False
    return knee, True


def max_backlog(width: int, service_us_w: float, cfg: ControllerCfg) -> int:
    """Largest admissible queue (in lanes) that can still drain within
    the SLO at this width's capacity. Admissions past this are shed."""
    cap = width / (service_us_w * 1e-6)
    return max(int(cap * cfg.slo_us * 1e-6), width)


def recommend_hot_frac(cur: float, hot_hits: int, hot_cold_rows: int, *,
                       target_hit_rate: float = 0.90,
                       shrink_above: float = 0.995,
                       lo: float = 1 / 64, hi: float = 0.5) -> float:
    """Auto-size the hot-set fraction from the observed hot_hits /
    hot_cold_rows counters (the hot tier's hit/miss split): double the
    hot set while the hit rate misses ``target_hit_rate``, halve it once
    hits are so saturated (> ``shrink_above``) that device memory is
    spent on rows the workload no longer touches. Pure; applied only at
    runner-rebuild boundaries (hot_frac sizes the mirrors)."""
    total = hot_hits + hot_cold_rows
    if total == 0:
        return cur
    hit_rate = hot_hits / total
    if hit_rate < target_hit_rate:
        return min(cur * 2.0, hi)
    if hit_rate > shrink_above:
        return max(cur / 2.0, lo)
    return cur


class WidthController:
    """Online width/admission controller.

    Feed it per-block observations (``observe_rate`` on every ingest
    poll, ``observe_service`` after every finished block) and ask
    ``width()`` before each dispatch. Hysteresis: a switch is only
    proposed after ``hysteresis_blocks`` blocks at the current width,
    because a width switch costs a drain (flush the 3-stage pipeline)
    plus an init at the new width.

    ``lanes_scale``: number of parallel serving lanesets behind ONE
    controller — a mesh serving plane runs D = hosts x chips cohorts of
    width w per step but keeps a single global controller, so offered
    rates are observed in PER-DEVICE units (inst_rate / lanes_scale) and
    the width policy/backlog bound stay exactly the single-device
    functions above. 1 (the default) is the single-device plane.
    """

    def __init__(self, cfg: ControllerCfg, model: ServiceModel,
                 lanes_scale: int = 1):
        self.cfg = cfg
        self.model = model
        self.lanes_scale = max(int(lanes_scale), 1)
        # EWMA state, seeded from the prior
        self.service_us = {w: model.service_us(w) for w in cfg.widths}
        self.offered_rate = 0.0
        self._cur = cfg.widths[0]
        self._blocks_at_cur = 0
        self.saturated = False
        self.switches: list[tuple[int, int]] = []   # (block_idx, new_width)
        self._block_idx = 0
        # the decision journal (schema-stable dict entries) and
        # the (width, service_us) fit-sample ledger — JSON-native types
        # only, appended in program order, never mutated after append
        self.journal: list[dict] = []
        self.samples: list[list] = []               # [[width, service_us]]
        self.samples_seen = 0

    def observe_rate(self, inst_rate: float) -> None:
        inst_rate = inst_rate / self.lanes_scale
        a = self.cfg.rate_alpha
        self.offered_rate = ((1 - a) * self.offered_rate + a * inst_rate
                             if self.offered_rate > 0.0 else inst_rate)

    def observe_service(self, width: int, service_us: float) -> None:
        a = self.cfg.service_alpha
        self.service_us[width] = ((1 - a) * self.service_us[width]
                                  + a * service_us)
        self.samples_seen += 1
        if len(self.samples) < SAMPLE_CAP:
            self.samples.append([int(width), float(service_us)])
        self._block_idx += 1
        self._blocks_at_cur += 1

    def width(self) -> int:
        """Current serving width; re-evaluates the policy when the
        hysteresis window has elapsed. Every re-evaluation is journaled
        with the exact choose_width inputs, so it can be replayed."""
        if self._blocks_at_cur >= self.cfg.hysteresis_blocks \
                or self._block_idx == 0:
            want, sat = choose_width(self.offered_rate, self.service_us,
                                     self.cfg)
            self.journal.append({
                "kind": "width", "block": int(self._block_idx),
                "inputs": {
                    "offered_rate": float(self.offered_rate),
                    "service_us": {str(w): float(self.service_us[w])
                                   for w in self.cfg.widths}},
                "decision": {"width": int(want), "saturated": bool(sat)},
                "prev": int(self._cur), "switched": want != self._cur})
            self.saturated = sat
            if want != self._cur:
                self.switches.append((self._block_idx, want))
                self._cur = want
                self._blocks_at_cur = 0
        return self._cur

    def max_backlog(self) -> int:
        return max_backlog(self._cur, self.service_us[self._cur], self.cfg)

    # -- the decision journal -------------------------------------------

    def journal_shed(self, backlog: int, shed: int, *, scale: int = 1,
                     host: int | None = None) -> None:
        """Record one admission-shed decision: `backlog` is the queue
        length BEFORE shedding, `shed` the lanes dropped against the
        bound max_backlog(width, service_us[width]) * scale (`scale` is
        the chips a mesh host feeds; 1 on the single-device plane)."""
        w = self._cur
        s = float(self.service_us[w])
        self.journal.append({
            "kind": "shed", "block": int(self._block_idx),
            "host": None if host is None else int(host),
            "inputs": {"width": int(w), "service_us_w": s,
                       "backlog": int(backlog), "scale": int(scale)},
            "decision": {
                "bound": max_backlog(w, s, self.cfg) * int(scale),
                "shed": int(shed)}})

    def journal_hot_frac(self, cur: float, hot_hits: int,
                         hot_cold_rows: int, rec: float) -> None:
        """Record one hot_frac evaluation (engine rebuild boundaries):
        the counter inputs recommend_hot_frac consumed and the outcome,
        rebuilt or not — no-op evaluations are evidence too."""
        self.journal.append({
            "kind": "hot_frac", "block": int(self._block_idx),
            "inputs": {"cur": float(cur), "hot_hits": int(hot_hits),
                       "hot_cold_rows": int(hot_cold_rows)},
            "decision": {"hot_frac": float(rec),
                         "rebuilt": float(rec) != float(cur)}})

    def journal_meta(self) -> dict:
        """The journal header: everything audit replay needs beyond the
        entries themselves (the ControllerCfg the pure policy functions
        close over, the lanes scale, the seeding ServiceModel)."""
        c = self.cfg
        return {
            "kind": "dintcal_journal", "schema": JOURNAL_SCHEMA,
            "cfg": {"widths": [int(w) for w in c.widths],
                    "slo_us": c.slo_us, "headroom": c.headroom,
                    "slo_fraction": c.slo_fraction,
                    "rate_alpha": c.rate_alpha,
                    "service_alpha": c.service_alpha,
                    "hysteresis_blocks": c.hysteresis_blocks},
            "lanes_scale": self.lanes_scale,
            "model": {"base_us": self.model.base_us,
                      "per_lane_ns": self.model.per_lane_ns}}

    def journal_doc(self) -> dict:
        """Header + entries as one auditable document (the JSONL stream
        is the same header line followed by one line per entry)."""
        return {**self.journal_meta(), "entries": list(self.journal)}

    def snapshot(self) -> dict:
        return {
            "width": self._cur,
            "offered_rate": self.offered_rate,
            "saturated": self.saturated,
            "service_us": dict(self.service_us),
            "switches": list(self.switches),
            "lanes_scale": self.lanes_scale,
            "journal": list(self.journal),
            "service_samples": {"n": self.samples_seen,
                                "samples": [list(s) for s in self.samples]},
        }


def simulate_widths(schedule: np.ndarray, cfg: ControllerCfg,
                    model: ServiceModel, *, cohorts_per_block: int = 2,
                    lanes_scale: int = 1) -> list[int]:
    """Closed-form controller trajectory for an arrival schedule under a
    pure ServiceModel (no engine, no clock): the sequence of widths the
    controller would serve each block at, which shows the policy before
    any card runs it. Deterministic by construction. ``lanes_scale``
    rehearses a mesh plane: D devices serve each block, so the controller
    sees per-device rates."""
    ctl = WidthController(cfg, model, lanes_scale=lanes_scale)
    widths, i, t = [], 0, 0.0
    n = len(schedule)
    while i < n:
        w = ctl.width()
        block_s = cohorts_per_block * model.service_us(w) * 1e-6
        j = int(np.searchsorted(schedule, t + block_s, side="right"))
        got = j - i
        ctl.observe_rate(got / block_s)
        ctl.observe_service(w, model.service_us(w))
        widths.append(w)
        i, t = j, t + block_s
    return widths
