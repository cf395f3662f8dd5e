"""dintlint: fx-graph static analysis of the port's engine hot paths.

The server hot path's correctness rests on invariants no test exercises
deterministically — conflict-free scatters (one writer per row), clones
for mirrors and kernel arguments written in place with nothing reading
around them, steps the host never waits on, u32 stamp arithmetic widened
before it is compared, and the lock/validate/install protocol. This
package traces every registered engine step function with
``torch.fx.experimental.proxy_tensor.make_fx`` on small real tensors (the
CPU by default; the card in chip_smoke.py) and walks the graphs with a
registry of passes, each encoding one invariant; ``python -m
dint_tpu_torch.dintlint`` is the CLI and tests/test_torch_dintlint*.py the
tests. The pass catalogue lives in the docstrings of analysis/passes.

Library API:

    from dint_tpu_torch import analysis
    findings = analysis.run()                       # all targets, passes
    findings = analysis.run(targets=["tatp_dense/block"],
                            passes=["scatter_race"],
                            allowlist_path=analysis.DEFAULT_ALLOWLIST)
    analysis.has_errors(findings)                   # -> CLI exit code
"""
from __future__ import annotations

import os
import time as _time

from . import passes as _passes          # noqa: F401 — registers the passes
from . import allowlist as _allowlist
from .core import (Finding, PASS_DOCS, PASSES, SEV_ERROR, SEV_INFO,  # noqa: F401
                   SEV_WARNING, TargetTrace, to_sarif, trace_target)
from .targets import (TARGET_DOCS, TARGET_PROTOCOL, TARGETS,  # noqa: F401
                      TRACE_CACHE, SkipTarget, get_trace)

DEFAULT_ALLOWLIST = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "dintlint_allow.json")

def run(targets=None, passes=None, allowlist_path: str | None = None,
        allowlist_entries=None, timings: dict | None = None
        ) -> list[Finding]:
    """Trace the requested targets, run the requested passes, apply the
    allowlist. Unknown names raise KeyError (the CLI turns that into a
    usage error); a target whose prerequisites are missing
    yields one INFO finding instead of failing the run.

    Traces are built ONCE per process (targets.TRACE_CACHE) and shared by
    every pass and every run() call. Pass a dict as ``timings`` to get
    per-target wall time filled in:
    {"total_s", "targets": {name: {"trace_s", "cached", "passes": {...}}}}
    — trace_s is the build cost (0-ish on cache hits, flagged "cached"),
    so tier-1 budget regressions in the matrix are attributable."""
    target_names = list(targets) if targets else list(TARGETS)
    pass_names = list(passes) if passes else list(PASSES)
    for name in target_names:
        if name not in TARGETS:
            raise KeyError(f"unknown target {name!r}; known: "
                           f"{sorted(TARGETS)}")
    for name in pass_names:
        if name not in PASSES:
            raise KeyError(f"unknown pass {name!r}; known: "
                           f"{sorted(PASSES)}")

    t_all = _time.perf_counter()
    findings: list[Finding] = []
    for tname in target_names:
        cached = tname in TRACE_CACHE
        try:
            trace = get_trace(tname)
        except SkipTarget as e:
            findings.append(Finding(
                "harness", "target-skipped", SEV_INFO, tname,
                f"target skipped: {e}"))
            continue
        except Exception as e:      # noqa: BLE001 — a broken builder must
            # not hide every other target's findings; it IS a gate failure
            findings.append(Finding(
                "harness", "target-build-failed", SEV_ERROR, tname,
                f"target builder raised {type(e).__name__}: {e} — the "
                "engine builder itself no longer runs at lint geometry",
                suggestion="run the builder directly to reproduce; if the "
                           "entry point moved, update "
                           "dint_tpu_torch/analysis/targets.py"))
            continue
        per_pass: dict[str, float] = {}
        for pname in pass_names:
            t0 = _time.perf_counter()
            findings.extend(PASSES[pname](trace))
            per_pass[pname] = round(_time.perf_counter() - t0, 4)
        if timings is not None:
            timings.setdefault("targets", {})[tname] = {
                "trace_s": round(TRACE_CACHE.seconds.get(tname, 0.0), 4),
                "cached": cached,
                "passes": per_pass,
            }
    if timings is not None:
        timings["total_s"] = round(_time.perf_counter() - t_all, 4)
    findings = _dedup(findings)

    entries = list(allowlist_entries) if allowlist_entries else []
    if allowlist_path:
        entries += _allowlist.load(allowlist_path)
    findings = _allowlist.apply(
        findings, entries,
        check_unused=targets is None and passes is None)
    findings.sort(key=lambda f: f.sort_key())
    return findings


def _dedup(findings: list[Finding]) -> list[Finding]:
    """Merge identical findings (one source line traced many times — the
    steps of a block, the partitions of a mesh) into one carrying a count:
    the report should scale with distinct problems, not with trace
    multiplicity."""
    merged: dict[tuple, Finding] = {}
    for f in findings:
        k = (f.pass_name, f.code, f.severity, f.target, f.primitive,
             f.site, f.path, f.message)
        if k in merged:
            merged[k].count += 1
        else:
            merged[k] = f
    return list(merged.values())


def has_errors(findings) -> bool:
    """True if any unsuppressed error-severity finding remains — the CLI's
    nonzero-exit condition and the CI gate's assertion."""
    return any(f.severity == SEV_ERROR and not f.suppressed
               for f in findings)
