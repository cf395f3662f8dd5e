"""PLAN.json as the port reads it: the pinned build knobs and serve priors
of each workload (the port's copy of what the bench and the serving plane
read from `dint_tpu.analysis.plan`: `SERVE_WORKLOADS`, `load_plan` and
`resolve_for`).

The consumer rule is the reference's: a workload's knobs start from the
plan's pinned config, and a knob's environment flag is read ONLY under
``DINT_PLAN_OVERRIDE=1`` (``meta["overridden"]`` names the knobs it
changed). Without a readable plan the knobs come from the environment and
``meta["source"]`` is None, so a record says ``"plan": null`` rather than
hide a default.

What differs: the port has the reference's build knobs ``use_hotset``
and ``use_fused`` (its routes, `engines.types.ROUTES`) and its plan-only
mesh knobs ``hierarchical`` and ``overlap`` (no env flag: without a plan
they take their defaults, ON and OFF). It has no ``use_pallas``: its CUDA
kernels are its only route. A pinned knob the port lacks is left out of
the knobs and named in ``meta["dropped"]``, a key that is present only
when the pin names such a knob.
"""
from __future__ import annotations

import json
import os
from pathlib import Path

SCHEMA = 1
ENV_PLAN_PATH = "DINT_PLAN_PATH"          # read another plan file
ENV_PLAN_OVERRIDE = "DINT_PLAN_OVERRIDE"  # "1": env flags beat the plan

# the port's knobs: name -> env flag, set-and-not-"0"/"" meaning True;
# None = plan-only, its default below without a plan
KNOBS = {"use_hotset": "DINT_USE_HOTSET", "use_fused": "DINT_USE_FUSED",
         "hierarchical": None, "overlap": None}
PLAN_ONLY_DEFAULTS = {"hierarchical": True, "overlap": False}

# the planned knobs of the workloads the port reads, less use_pallas
WORKLOAD_KNOBS = {"tatp_uniform": ("use_hotset", "use_fused"),
                  "smallbank_skewed": ("use_hotset", "use_fused"),
                  "tatp_serve": (), "smallbank_serve": (),
                  "multihost_4x2": ("hierarchical",),
                  "multihost_3x2": ("hierarchical",),
                  "multihost_serve": ("hierarchical", "overlap")}

# which workload's serve priors a serving-plane engine family reads (the
# store family has none)
SERVE_WORKLOADS = {"tatp_dense": "tatp_serve",
                   "smallbank_dense": "smallbank_serve",
                   "multihost_sb": "multihost_serve"}


def plan_path() -> Path:
    """$DINT_PLAN_PATH, else PLAN.json at the repository's root."""
    env = os.environ.get(ENV_PLAN_PATH)
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[1] / "PLAN.json"


def override_active(environ=None) -> bool:
    env = os.environ if environ is None else environ
    return env.get(ENV_PLAN_OVERRIDE, "0") == "1"


def _flag(environ, name: str) -> bool:
    if KNOBS[name] is None:
        return PLAN_ONLY_DEFAULTS[name]
    return (environ.get(KNOBS[name]) or "0") not in ("", "0")


def load_plan(path: Path | None = None) -> dict:
    """The parsed plan; raises OSError or ValueError (a missing file, or
    not a schema-1 plan)."""
    path = Path(path) if path else plan_path()
    plan = json.loads(path.read_text())
    if not isinstance(plan, dict) or plan.get("schema") != SCHEMA:
        raise ValueError(f"{path}: not a schema-{SCHEMA} PLAN.json")
    return plan


def resolve_for(workload: str, environ=None,
                plan: dict | None = None) -> tuple[dict, dict]:
    """``(knobs, meta)`` for one workload: the pinned knobs the port has,
    each replaced by its env flag under ``DINT_PLAN_OVERRIDE=1`` when the
    flag is set and disagrees; meta = {source, hash, overridden} (and
    ``dropped`` where the pin names a knob the port lacks)."""
    env = os.environ if environ is None else environ
    if plan is None:
        try:
            plan = load_plan()
        except (OSError, ValueError):
            plan = None
    if plan is None or workload not in plan.get("workloads", {}):
        names = WORKLOAD_KNOBS.get(workload, ("use_hotset", "use_fused"))
        return ({k: _flag(env, k) for k in names},
                {"source": None, "hash": None, "overridden": []})
    pinned = plan["workloads"][workload]["pinned"]
    knobs = {k: v for k, v in pinned.items() if k in KNOBS}
    dropped = sorted(k for k in pinned if k not in KNOBS)
    overridden = []
    if override_active(env):
        for name in list(knobs):
            if KNOBS[name] is not None \
                    and env.get(KNOBS[name]) is not None \
                    and _flag(env, name) != knobs[name]:
                knobs[name] = _flag(env, name)
                overridden.append(name)
    meta = {"source": str(plan_path()),
            "hash": plan.get("provenance", {}).get("cost_model_hash"),
            "overridden": overridden}
    if dropped:
        meta["dropped"] = dropped
    return knobs, meta
