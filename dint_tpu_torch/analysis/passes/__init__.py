"""dintlint pass registry: importing this package registers every pass.

Each module encodes ONE invariant of the engine hot paths as a node-level
predicate over the traced fx graph (see analysis/core.py for the walking
machinery):

  scatter_race       one writer per table row, provably
  aliasing           state tensors and a kernel's written arguments share
                     no storage; nothing reads a stale alias of a table a
                     kernel or an in-place op rewrote
  purity             a step is one device program: no host sync, and the
                     host scalars each kernel call takes are listed
  u64_overflow       u32 words (stamps, versions, log heads) are widened
                     before an unsigned compare, shift or division
  protocol           lock-dominates-write / validate-before-install /
                     abort-implies-unlock / writer-election, proven by the
                     dataflow layer (analysis/dataflow.py)
  cost_budget        the static cost model (analysis/cost.py) against the
                     waves.py ledger, the budgets of targets.TARGET_COST
                     and the fused twins (the dintcost gate)
  durability         log-before-visible, ring bounds, replay coverage and
                     in-doubt totality over the LOG_SLOT/LOGGED/TRUNCATED
                     facts (the dintdur gate)
  plan_check         the pinned PLAN_H100.json against the knob registry,
                     the calibration ledger and the priced frontier (the
                     dintplan gate; static inside dintlint)
  calib_check        the pinned CALIB_H100.json against its own evidence
                     and the plan's serve-model provenance (the dintcal
                     gate)
  shard_consistency  the mesh's collectives name axes their mesh has, and
                     each ppermute's perm is a partial permutation of its
                     axis
  mut_check          the pinned MUTCOV_TORCH.json against the mutation
                     operator registry, the target matrix and the
                     kill-rate/triage policy (the dintmut gate; static)

Adding a pass: write ``passes/<name>.py``, decorate the entry point with
``@core.register_pass("<name>")``, import it here.
"""
from . import (aliasing, calib_check, cost_budget,  # noqa: F401
               durability, mut_check, plan_check, protocol, purity,
               scatter_race, shard_consistency, u64_overflow)
