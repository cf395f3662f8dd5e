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

The reference's model-level gates (cost_budget, durability, plan_check,
calib_check, mut_check) and the mesh-collective check
(shard_consistency) are not ported yet (ROADMAP §A.8).

Adding a pass: write ``passes/<name>.py``, decorate the entry point with
``@core.register_pass("<name>")``, import it here.
"""
from . import (aliasing, protocol, purity, scatter_race,  # noqa: F401
               u64_overflow)
