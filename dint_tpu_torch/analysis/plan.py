"""dintplan: the port's static configuration planner behind PLAN_H100.json
(the port of `dint_tpu.analysis.plan`).

The knob space is a first-class registry (`KNOBS`: each knob knows its
env var, its legal values, the engines it applies to and the registered
target variant it maps to). `enumerate_candidates` spans the feasible
(engine x geometry x skew x mesh) lattice (`WORKLOADS` x knob values,
filtered against analysis/targets.py: a knob combination with no
registered target is infeasible by construction, never silently priced),
`build_plan` prices every candidate through the dintcost `CostModel`
(analysis/cost.py: bytes, dispatches, footprint, per-axis link bytes)
plus the `ServiceModel` capacity priors, prunes statically dominated
points and pins the result as a schema-versioned plan with provenance
hashes.

One decision rule, stated once (recorded verbatim in the plan):

  dominated  a candidate is pruned iff some candidate in the SAME
             workload is strictly better on HBM bytes/step AND
             dispatches/step AND footprint (all three, strictly; ties
             survive)
  choose     lexicographic minimize (dcn_bytes_per_step,
             dispatches_per_step, bytes_per_step, footprint_bytes) over
             the undominated frontier

The chosen config is the plan's ``predicted`` pick. The plan also carries
a ``pinned`` config per workload (what the bench, exp and the serving
planes run: every planned knob at its registered default) and, where
pinned != predicted, an explicit per-knob override with a written reason
(`MEASURED_OVERRIDES`, each quoting the port's own H100 records).
passes/plan_check.py fails the gate when the pinned plan drifts from this
module's view; `dint_tpu_torch.plan` resolves the consumers' knobs FROM
the plan (`resolve_for`), env flags demoted to ``DINT_PLAN_OVERRIDE=1``.

What differs from the reference:

* The plan file is the port's: ``$DINT_PLAN_PATH``, else
  ``PLAN_H100.json`` at the repository's root, priced from the port's
  own cost model and from ``CALIB_H100.json`` (`monitor.calib`). It never
  resolves to ``PLAN.json``, the reference's plan with a TPU's serve
  priors.
* Knobs dropped: ``use_pallas`` (the port's CUDA kernels are its only
  route, so no target carries ``@pallas``), ``pallas_interpret`` (no
  interpret mode: a CUDA kernel runs on the card or its plain version on
  the CPU) and ``trace_cap`` (a memo-key-only knob with no consumer).
  ``env_knob_signature`` is left out: its one caller, the reference's
  builder memo, is never ported (the port compiles nothing per config).
* Mesh geometry: each workload's ``mesh`` is the geometry its targets are
  traced at. ``multihost_4x2``'s candidates (``multihost_sb/block`` and
  ``@flat``) trace at 4 x 2 as the reference's do; ``multihost_3x2`` and
  ``multihost_serve`` at 3 x 2, the 1-D mesh workloads at 3 partitions
  (analysis/targets.py).
* Link bytes: the mesh's collectives are ``dint_mesh`` nodes in the
  trace (ops/mesh_ops.py), so ``ici``/``dcn_bytes_per_step`` are the cost
  model's per-axis ledger, and the first key of the choice separates
  ``hierarchical`` from ``@flat`` on the 2-D workloads. Since one node
  moves every partition's operand, a row's link bytes are the whole
  mesh's (d times the reference's per-device figure). Each frontier row
  keeps ``unpriced_waves`` (the one schema addition): the collective
  waves its model could not price, empty on every row.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from pathlib import Path

SCHEMA = 1

ENV_PLAN_PATH = "DINT_PLAN_PATH"          # override the pinned plan file
ENV_PLAN_OVERRIDE = "DINT_PLAN_OVERRIDE"  # "1": env flags beat the plan
ENV_PLAN_STATIC = "DINT_PLAN_STATIC"      # "1": plan_check skips tracing
ENV_PLAN_ANCHOR = "DINT_PLAN_ANCHOR"      # plan_check's reporting target

PLAN_FILE = "PLAN_H100.json"
# resolve_for's meta["source"] for a plan document handed in by the caller
DOCUMENT_SOURCE = "<document>"

# the one registered target the whole-plan checks anchor their findings
# to (the cheapest always-traceable target)
DEFAULT_ANCHOR = "tatp_dense/block"

DECISION_RULE = (
    "choose = lexicographic min (dcn_bytes_per_step, dispatches_per_step, "
    "bytes_per_step, footprint_bytes) over the undominated frontier; "
    "dominated = strictly worse than some same-workload candidate on "
    "bytes AND dispatches AND footprint")


def plan_path() -> Path:
    """The pinned plan: $DINT_PLAN_PATH, else PLAN_H100.json at the
    repository's root (never PLAN.json, the reference's)."""
    env = os.environ.get(ENV_PLAN_PATH)
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / PLAN_FILE


def override_active(environ=None) -> bool:
    env = os.environ if environ is None else environ
    return env.get(ENV_PLAN_OVERRIDE, "0") == "1"


# ------------------------------------------------------ the knob registry
#
# Every ambient configuration flag the engines, bench and serving planes
# consult, declared ONCE. `planned` knobs span the priced lattice; the
# rest are registered so resolution covers them, but the planner holds
# them at their default (counters and tracing are priced by their own
# @mon/@trace targets).

# token order inside registered names ("@fused+hot", "@hot+mon",
# "@overlap+mon", "@h3+flat"): rank sorts tokens into the registry's
# canonical spelling
_TOKEN_RANK = {"fused": 0, "hot": 1, "h3": 2, "overlap": 3, "scan": 4,
               "mon": 5, "flat": 7, "trace": 8}

_DENSE = ("tatp_dense", "smallbank_dense")
_SHARDED = ("dense_sharded", "dense_sharded_sb")
_MESH = ("multihost_sb",)


@dataclasses.dataclass(frozen=True)
class Knob:
    """One ambient configuration knob, declared once."""
    name: str                     # canonical name ("use_fused")
    env: str | None               # env var; None = CLI/constructor only
    kind: str                     # resolution semantics, see _resolve_one
    default: object
    values: tuple                 # legal values (floats: observed range)
    engines: tuple[str, ...]      # registry engine prefixes it applies to
    token: str | None = None      # target variant token it maps to
    token_when: object = True     # knob value that turns the token ON
    planned: bool = False         # spans the priced lattice
    build_identity: bool = False  # part of the built runner's identity
    doc: str = ""

    def to_dict(self) -> dict:
        return {
            "name": self.name, "env": self.env, "kind": self.kind,
            "default": self.default, "values": list(self.values),
            "engines": list(self.engines), "token": self.token,
            "token_when": self.token_when, "planned": self.planned,
            "build_identity": self.build_identity, "doc": self.doc,
        }


_KNOB_LIST = (
    Knob("use_hotset", "DINT_USE_HOTSET", "flag01", False, (False, True),
         _DENSE + ("dense_sharded_sb",), token="hot", planned=True,
         build_identity=True,
         doc="keep the hot row-prefix mirror (write-through on install; "
             "the B6/B7 kernels)"),
    Knob("use_fused", "DINT_USE_FUSED", "flag01", False, (False, True),
         _DENSE + _SHARDED, token="fused", planned=True,
         build_identity=True,
         doc="fuse lock+validate and install+log-append into the B4/B3 "
             "launches (TATP 6 -> 4 dispatches/step)"),
    Knob("hierarchical", None, "bool", True, (False, True),
         _MESH, token="flat", token_when=False, planned=True,
         doc="exchange along ici, then dcn, instead of one flat "
             "tuple-axis all_to_all; False = the @flat twin"),
    Knob("overlap", None, "bool", False, (False, True),
         _MESH, token="overlap", planned=True,
         doc="prefetch the next cohort's exchange under the lock wave "
             "(the mesh serving plane)"),
    Knob("use_scan", "DINT_USE_SCAN", "flag01", False, (False, True),
         ("store",), token="scan", planned=False, build_identity=True,
         doc="thread the ordered-run snapshot and delta overlay through "
             "the store step (B8 range replies); not planned, priced by "
             "the @scan targets; the store takes it as an argument"),
    Knob("monitor", "DINT_MONITOR", "flag1", False, (False, True),
         _DENSE + _SHARDED + _MESH, token="mon",
         doc="thread the counter plane through the carry; priced by the "
             "@mon targets, not planned"),
    Knob("trace", "DINT_TRACE", "flag1", False, (False, True),
         _DENSE + _SHARDED + _MESH, token="trace", build_identity=True,
         doc="arm the dinttrace flight recorder ring; priced by the "
             "@trace targets, not planned"),
    Knob("trace_rate", "DINT_TRACE_RATE", "float", 1.0, (0.0, 1.0),
         _DENSE + _SHARDED + _MESH, build_identity=True,
         doc="dinttrace sampling rate (monitor.txnevents.trace_rate)"),
    Knob("hot_frac", "DINT_BENCH_HOT_FRAC", "optfloat", None,
         (None, 1 / 64, 0.5), ("smallbank_dense", "dense_sharded_sb",
                               "multihost_sb"),
         doc="hot-set fraction; None = workloads.SB_HOT_FRAC. The serve "
             "plane re-pins it from recommend_hot_frac at width-switch "
             "drain boundaries"),
)

KNOBS: dict[str, Knob] = {k.name: k for k in _KNOB_LIST}


def _resolve_one(knob: Knob, environ) -> object:
    """One knob's env resolution, the consumers' exact semantics."""
    if knob.env is None:
        return knob.default
    raw = environ.get(knob.env)
    if knob.kind == "flag01":       # set-and-not-"0"/"": hot/fused/scan
        return (raw or "0") not in ("", "0")
    if knob.kind == "flag1":        # exactly "1": DINT_MONITOR, DINT_TRACE
        return (raw or "0") == "1"
    if knob.kind == "float":
        try:
            return float(raw) if raw is not None else float(knob.default)
        except ValueError:
            return float(knob.default)
    if knob.kind == "optfloat":
        try:
            return float(raw) if raw is not None else knob.default
        except ValueError:
            return knob.default
    return raw                      # "bool": no env semantics


def resolve_knobs(environ=None) -> dict[str, object]:
    """Resolve every registered knob from the environment (an explicit
    mapping for tests; default os.environ). Knobs without an env var
    resolve to their default."""
    env = os.environ if environ is None else environ
    return {k.name: _resolve_one(k, env) for k in _KNOB_LIST}


# ------------------------------------------------------ workload lattice


@dataclasses.dataclass(frozen=True)
class Workload:
    """One (engine x geometry x skew x mesh) point the planner prices."""
    name: str
    engine: str                       # registry engine prefix
    base: str                         # "block" | "serve"
    knobs: tuple[str, ...]            # planned knobs that vary here
    base_tokens: tuple[str, ...] = () # geometry tokens ("h3")
    mesh: str = ""                    # "" | "d=3" | "4x2" | "3x2"
    skew: str = "uniform"
    serve: bool = False               # attach ServiceModel priors
    lanes_scale: int = 1              # mesh serve: hosts x chips
    doc: str = ""

    def to_dict(self) -> dict:
        return {"name": self.name, "engine": self.engine,
                "base": self.base, "knobs": list(self.knobs),
                "base_tokens": list(self.base_tokens), "mesh": self.mesh,
                "skew": self.skew, "serve": self.serve,
                "lanes_scale": self.lanes_scale, "doc": self.doc}


WORKLOADS: tuple[Workload, ...] = (
    Workload("tatp_uniform", "tatp_dense", "block",
             ("use_hotset", "use_fused"),
             doc="single-device TATP, uniform subscriber draw"),
    Workload("smallbank_skewed", "smallbank_dense", "block",
             ("use_hotset", "use_fused"), skew="hot-90/4",
             doc="single-device SmallBank, 90% of txns on the 4% hot "
                 "prefix (clients/workloads.py)"),
    Workload("tatp_sharded", "dense_sharded", "block",
             ("use_fused",), mesh="d=3",
             doc="3-partition TATP (parallel/dense_sharded), traced at "
                 "the port's 3 partitions"),
    Workload("smallbank_sharded", "dense_sharded_sb", "block",
             ("use_hotset", "use_fused"), mesh="d=3", skew="hot-90/4",
             doc="3-partition SmallBank (parallel/dense_sharded_sb)"),
    Workload("multihost_4x2", "multihost_sb", "block",
             ("hierarchical",), mesh="4x2", skew="hot-90/4",
             doc="4 hosts x 2 chips, 2-D (dcn x ici) mesh, hierarchical "
                 "vs flat exchange"),
    Workload("multihost_3x2", "multihost_sb", "block",
             ("hierarchical",), base_tokens=("h3",), mesh="3x2",
             skew="hot-90/4",
             doc="3 hosts x 2 chips: the non-power-of-two host count"),
    Workload("multihost_serve", "multihost_sb", "serve",
             ("hierarchical", "overlap"), mesh="3x2", skew="hot-90/4",
             serve=True, lanes_scale=6,
             doc="mesh serving plane at 3 x 2 (serve/mesh.py): the "
                 "exchange prefetched under the lock wave vs not"),
    Workload("smallbank_serve", "smallbank_dense", "serve",
             (), skew="hot-90/4", serve=True,
             doc="single-device SmallBank serving plane; no planned knob "
                 "varies, pinned for the width/hot_frac priors"),
    Workload("tatp_serve", "tatp_dense", "serve",
             (), serve=True,
             doc="single-device TATP serving plane; pinned for the width "
                 "priors (no hot tier)"),
)

WORKLOADS_BY_NAME = {w.name: w for w in WORKLOADS}

# consumer lookup: which workload an entry point resolves its knobs from
# (bench/exp block runs vs the serving planes)
BLOCK_WORKLOADS = {
    "tatp_dense": "tatp_uniform",
    "smallbank_dense": "smallbank_skewed",
    "dense_sharded": "tatp_sharded",
    "dense_sharded_sb": "smallbank_sharded",
    "multihost_sb": "multihost_4x2",
}
SERVE_WORKLOADS = {
    "tatp_dense": "tatp_serve",
    "smallbank_dense": "smallbank_serve",
    "multihost_sb": "multihost_serve",
}


def target_name(workload: Workload, values: dict[str, object]) -> str:
    """The registered target a knob assignment maps to:
    engine/base[@tok+tok...], tokens in the registry's rank order."""
    tokens = list(workload.base_tokens)
    for kname in workload.knobs:
        knob = KNOBS[kname]
        if knob.token and values.get(kname) == knob.token_when:
            tokens.append(knob.token)
    tokens.sort(key=lambda t: _TOKEN_RANK.get(t, 99))
    suffix = ("@" + "+".join(tokens)) if tokens else ""
    return f"{workload.engine}/{workload.base}{suffix}"


def enumerate_candidates(workload: Workload) -> list[dict]:
    """The workload's full knob lattice: every assignment of its planned
    knobs, each mapped to a target name and marked feasible iff that
    target is registered (``multihost_sb/serve@overlap+flat`` has no
    target: infeasible, never priced)."""
    from . import targets as T
    assigns: list[dict] = [{}]
    for kname in workload.knobs:
        knob = KNOBS[kname]
        assigns = [dict(a, **{kname: v}) for a in assigns
                   for v in knob.values]
    out = []
    for a in assigns:
        name = target_name(workload, a)
        out.append({"knobs": a, "target": name,
                    "feasible": name in T.TARGETS})
    return out


def pinned_knobs(workload: Workload) -> dict[str, object]:
    """What the consumers run: every planned knob at its registered
    default (env flags all unset)."""
    return {k: KNOBS[k].default for k in workload.knobs}


# pinned != predicted needs a WRITTEN reason; each quotes the port's own
# H100 records (PERF.md) beside the card, or says the A/B is unmeasured.
_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
MEASURED_OVERRIDES: dict[str, str] = {
    "use_fused": (
        "the fused route trims dispatches statically (the planner's "
        "pick), and the port's bench put it ahead on the card: PERF.md "
        "§5, TATP 1.71-1.85 M default vs 2.37-2.54 M fused committed "
        "txn/s (" + _CARD + "); chip_smoke phase 22 (d)'s 1 s turns "
        "(P N N P) have not ordered the two routes (PERF.md §5). The pin "
        "stays at the registered default route until an A/B of the "
        "bench's windows in turns does; opt in with DINT_PLAN_OVERRIDE=1 "
        "DINT_USE_FUSED=1"),
    "use_hotset": (
        "the hot tier prices as MORE scheduled work (B7 writes table and "
        "mirror); its win is locality, which a bytes ledger cannot see, "
        "and the single-device bench has no A/B of it in turns: opt-in "
        "until one orders the routes"),
    "overlap": (
        "overlap exists to hide the exchange under the lock wave, a "
        "wall-clock effect, and statically it adds the prefetch "
        "footprint; on one card the partitions share one stream, so no "
        "link is overlapped and no A/B can show its win: opt-in "
        "(--overlap)"),
}


# ------------------------------------------------------ pricing + choice


def price_model(model) -> dict:
    """One candidate's price from its CostModel: the reference's five
    numbers and the collective waves the model leaves unpriced."""
    if model.error:
        raise RuntimeError(f"{model.target}: cost derivation failed: "
                           f"{model.error}")
    axis = model.axis_bytes_per_step()
    return {
        "dispatches_per_step": round(model.dispatches_per_step, 3),
        "bytes_per_step": round(model.bytes_per_step, 2),
        "footprint_bytes": int(model.footprint_bytes),
        "ici_bytes_per_step": round(axis.get("ici", 0.0), 2),
        "dcn_bytes_per_step": round(axis.get("dcn", 0.0), 2),
        "unpriced_waves": sorted(model.unpriced_waves),
    }


def _price_target(name: str) -> dict:
    """One candidate's static price (traces the target on the CPU on
    first use; memoized process-wide via cost.model_for)."""
    from . import cost
    return price_model(cost.model_for(name))


def decision_key(row: dict) -> tuple:
    """The lexicographic choice key (DECISION_RULE, stated once)."""
    return (row["dcn_bytes_per_step"], row["dispatches_per_step"],
            row["bytes_per_step"], row["footprint_bytes"])


def dominates(a: dict, b: dict) -> bool:
    """True iff candidate `a` is strictly better than `b` on bytes AND
    dispatches AND footprint (the prune rule; ties do NOT dominate)."""
    return (a["bytes_per_step"] < b["bytes_per_step"]
            and a["dispatches_per_step"] < b["dispatches_per_step"]
            and a["footprint_bytes"] < b["footprint_bytes"])


def rank_rows(rows: list[dict]) -> None:
    """In place: mark dominated rows (`dominated_by` = the cheapest
    dominator) and rank the survivors by the decision key (rank 0 = the
    predicted pick). Deterministic: ties broken by target name."""
    for row in rows:
        doms = [o for o in rows if o is not row and dominates(o, row)]
        if doms:
            best = min(doms, key=lambda o: (decision_key(o), o["target"]))
            row["dominated"] = True
            row["dominated_by"] = best["target"]
        else:
            row["dominated"] = False
            row["dominated_by"] = None
    frontier = sorted((r for r in rows if not r["dominated"]),
                      key=lambda r: (decision_key(r), r["target"]))
    for i, row in enumerate(frontier):
        row["rank"] = i
    for row in rows:
        if row["dominated"]:
            row["rank"] = None


def serve_priors(workload: Workload) -> dict:
    """ServiceModel capacity priors for a serve workload: the width menu
    with each width's service time, capacity and admissible backlog, the
    knee, and the hot_frac prior. The model comes from THE resolver
    (monitor/calib.resolve_service_model: CALIB_H100.json's coefficients
    when it loads, the ServiceModel defaults otherwise), and the row
    records which (source + hash)."""
    from ..monitor.calib import resolve_service_model
    from ..serve.controller import ControllerCfg, max_backlog
    cfg = ControllerCfg()
    model, model_meta = resolve_service_model()
    widths = {}
    best_cap, knee = -1.0, cfg.widths[-1]
    for w in cfg.widths:
        s_us = model.service_us(w)
        cap = w / (s_us * 1e-6)
        if cap > best_cap:
            best_cap, knee = cap, w
        widths[str(w)] = {
            "service_us": round(s_us, 3),
            "capacity_lanes_per_s": round(cap, 1),
            "max_backlog": max_backlog(w, s_us, cfg),
        }
    hot_frac = None
    if "smallbank" in workload.engine or workload.engine == "multihost_sb":
        from ..clients import workloads as wl
        hot_frac = wl.SB_HOT_FRAC
    return {
        "widths": widths,
        "knee_width": knee,
        "slo_us": cfg.slo_us,
        "lanes_scale": workload.lanes_scale,
        "hot_frac": hot_frac,
        "model": {"base_us": model.base_us,
                  "per_lane_ns": model.per_lane_ns,
                  "source": model_meta["source"],
                  "hash": model_meta["hash"]},
    }


# ------------------------------------------------------------ provenance


def _digest(obj) -> str:
    blob = json.dumps(obj, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def knobs_hash() -> str:
    """Digest of the knob registry + workload lattice + decision rule: a
    plan generated against a different planner is stale."""
    return _digest({"knobs": [k.to_dict() for k in _KNOB_LIST],
                    "workloads": [w.to_dict() for w in WORKLOADS],
                    "rule": DECISION_RULE})


def calibration_hash() -> str:
    """Digest of targets.TARGET_COST (the port's calibration ledger): any
    recalibration invalidates the pinned plan's prices. Recomputable
    without tracing, which plan_check's static mode leans on."""
    from . import targets as T
    return _digest(T.TARGET_COST)


def frontier_hash(rows: list[dict]) -> str:
    return _digest(sorted(rows, key=lambda r: (r["workload"],
                                               r["target"])))


# --------------------------------------------------------- plan building


def price_frontier(pricer=None) -> dict[str, list[dict]]:
    """Every workload's feasible candidates priced and ranked:
    {workload: rows}. ``pricer(target) -> price`` defaults to the CPU
    trace at the lint geometry (`_price_target`); chip_smoke.py passes
    one that traces on the card."""
    pricer = pricer or _price_target
    out: dict[str, list[dict]] = {}
    for wl in WORKLOADS:
        rows = []
        for c in enumerate_candidates(wl):
            if not c["feasible"]:
                continue
            row = {"workload": wl.name, "target": c["target"],
                   "knobs": c["knobs"]}
            row.update(pricer(c["target"]))
            rows.append(row)
        if not rows:
            raise RuntimeError(f"{wl.name}: no feasible candidate")
        rank_rows(rows)
        out[wl.name] = rows
    return out


def build_plan(pricer=None) -> dict:
    """Enumerate, price, prune and choose: the full plan document. Traces
    every feasible candidate (memoized; 23 targets)."""
    frontier: list[dict] = []
    workloads: dict[str, dict] = {}
    priced = price_frontier(pricer)
    for wl in WORKLOADS:
        cands = enumerate_candidates(wl)
        rows = priced[wl.name]
        frontier.extend(rows)
        predicted = min((r for r in rows if not r["dominated"]),
                        key=lambda r: (decision_key(r), r["target"]))
        pinned = pinned_knobs(wl)
        overrides = []
        for kname in wl.knobs:
            if pinned[kname] != predicted["knobs"][kname]:
                overrides.append({
                    "knob": kname,
                    "pinned": pinned[kname],
                    "predicted": predicted["knobs"][kname],
                    "reason": MEASURED_OVERRIDES[kname],
                })
        workloads[wl.name] = {
            "engine": wl.engine, "base": wl.base, "mesh": wl.mesh,
            "skew": wl.skew,
            "pinned": pinned,
            "target": target_name(wl, pinned),
            "predicted": predicted["knobs"],
            "predicted_target": predicted["target"],
            "overrides": overrides,
            "infeasible": sorted(c["target"] for c in cands
                                 if not c["feasible"]),
            "serve": serve_priors(wl) if wl.serve else None,
        }
    return {
        "schema": SCHEMA,
        "decision_rule": DECISION_RULE,
        "provenance": {
            "knobs_hash": knobs_hash(),
            "calibration_hash": calibration_hash(),
            "cost_model_hash": frontier_hash(frontier),
        },
        "workloads": workloads,
        "frontier": sorted(frontier,
                           key=lambda r: (r["workload"], r["target"])),
    }


def save_plan(plan: dict, path: Path | None = None) -> Path:
    path = Path(path) if path else plan_path()
    path.write_text(json.dumps(plan, indent=1, sort_keys=True) + "\n")
    return path


def load_plan(path: Path | None = None) -> dict:
    """Parse the pinned plan. Raises FileNotFoundError / ValueError;
    callers that want soft-fail use resolve_for."""
    path = Path(path) if path else plan_path()
    plan = json.loads(path.read_text())
    if not isinstance(plan, dict) or plan.get("schema") != SCHEMA:
        raise ValueError(f"{path}: not a schema-{SCHEMA} plan")
    return plan


# ------------------------------------------------------ consumer resolve


def resolve_for(workload: str, environ=None, plan: dict | None = None,
                source: str | None = None) -> tuple[dict, dict]:
    """The consumer entry point (bench, exp, the serving planes,
    dintserve): ``(knobs, meta)`` for one workload.

    Knobs start from the plan's pinned config; a knob's env flag is
    consulted ONLY under DINT_PLAN_OVERRIDE=1 (``meta["overridden"]``
    names the knobs it changed). Without a readable plan the knobs come
    from plain env resolution and ``meta["source"]`` is None, so a
    record says ``"plan": null``, never a silent default. A pinned knob
    the port does not register (the reference plan's ``use_pallas``) is
    left out of the knobs and named in ``meta["dropped"]``, a key present
    only when the pin names such a knob.

    ``meta["source"]`` names the file the plan was read from: the
    default plan's path when ``plan`` is None, else ``source``, and
    `DOCUMENT_SOURCE` for a document handed in without one."""
    env = os.environ if environ is None else environ
    if plan is None:
        try:
            plan = load_plan()
            source = str(plan_path())
        except (OSError, ValueError):
            plan = None
    resolved = resolve_knobs(env)
    if plan is None or workload not in plan.get("workloads", {}):
        wl = WORKLOADS_BY_NAME.get(workload)
        knobs = ({k: resolved[k] for k in wl.knobs} if wl
                 else dict(resolved))
        return knobs, {"source": None, "hash": None, "overridden": []}
    pinned = plan["workloads"][workload]["pinned"]
    knobs = {k: v for k, v in pinned.items() if k in KNOBS}
    dropped = sorted(k for k in pinned if k not in KNOBS)
    overridden = []
    if override_active(env):
        for kname in list(knobs):
            knob = KNOBS[kname]
            if knob.env is None:
                continue
            if env.get(knob.env) is not None \
                    and resolved[kname] != knobs[kname]:
                knobs[kname] = resolved[kname]
                overridden.append(kname)
    meta = {"source": DOCUMENT_SOURCE if source is None else source,
            "hash": plan.get("provenance", {}).get("cost_model_hash"),
            "overridden": overridden}
    if dropped:
        meta["dropped"] = dropped
    return knobs, meta


def contradictions(plan: dict, environ=None) -> list[tuple[str, str,
                                                           object, object]]:
    """Env flags that are SET and contradict a workload's pinned knob:
    [(workload, knob, pinned, env_value)]. plan_check ERRORs on these
    unless DINT_PLAN_OVERRIDE=1."""
    env = os.environ if environ is None else environ
    resolved = resolve_knobs(env)
    out = []
    for wname, entry in sorted(plan.get("workloads", {}).items()):
        for kname, pinned in sorted(entry.get("pinned", {}).items()):
            knob = KNOBS.get(kname)
            if knob is None or knob.env is None:
                continue
            if env.get(knob.env) is None:
                continue
            if resolved[kname] != pinned:
                out.append((wname, kname, pinned, resolved[kname]))
    return out
