"""The pinned plan as the port's consumers read it: the build knobs and
serve priors of each workload (bench, exp and the serving planes import
these names).

One source of truth: every table here is the planner's registry,
`dint_tpu_torch.analysis.plan` (`KNOBS`, `WORKLOADS`, `SERVE_WORKLOADS`),
and `resolve_for`/`load_plan`/`plan_path` are its. The plan file is
``$DINT_PLAN_PATH``, else ``PLAN_H100.json`` at the repository's root,
the port's own plan priced from its cost model and ``CALIB_H100.json``;
never ``PLAN.json``, the reference's plan with a TPU's serve priors (hand
it in as ``plan=`` to read it).

The consumer rule is the reference's: a workload's knobs start from the
plan's pinned config, and a knob's environment flag is read ONLY under
``DINT_PLAN_OVERRIDE=1`` (``meta["overridden"]`` names the knobs it
changed). Without a readable plan the knobs come from the environment and
``meta["source"]`` is None, so a record says ``"plan": null`` rather than
hide a default. The port has no ``use_pallas``: a pinned knob it lacks is
left out of the knobs and named in ``meta["dropped"]``.
"""
from __future__ import annotations

from .analysis.plan import (ENV_PLAN_OVERRIDE, ENV_PLAN_PATH,  # noqa: F401
                            KNOBS, SCHEMA, SERVE_WORKLOADS, WORKLOADS,
                            load_plan, override_active, plan_path,
                            resolve_for, resolve_knobs)

# the planned knobs each workload resolves
WORKLOAD_KNOBS = {w.name: w.knobs for w in WORKLOADS}
