"""Scatter-race pass: every table scatter must be provably conflict-free.

The dense engines' determinism argument (engines/tatp_dense.py "Scatter
discipline") is that a scatter with duplicate indices is a race: the
winner of an overwrite is unspecified, and even order-independent
reducers (add on floats) pick up nondeterministic rounding. aten has no
``unique_indices`` flag, so the evidence that a scatter has one writer a
row is found in the trace, on this ladder:

  (a) the op's own contract: a ``dint::scatter_streams`` or
      ``dint::scatter_rows_hot`` stream (unique rows among the lanes it
      keeps, as the reference's ``scatter_streams`` and
      ``scatter_rows_hot`` contracts say), an index that is a boolean mask
      (each position written once by construction), or an index the trace
      holds as a constant whose values are distinct (the counters'
      fixed slots);
  (b) an index def-chain through ``sort``, ``argsort`` or ``unique*`` (the
      segment machinery of ops/segments.py, whose head/last masks make the
      scatter one-writer by construction);
  (c) an index that carries LOCK_WIN in the dataflow (analysis/
      dataflow.py): the lanes were filtered by a lock grant, and one lane
      wins each row.

Overwrite scatters are ``index_put(_)`` with ``accumulate=False``,
``index_copy(_)``, ``scatter(_)`` with a src or a value,
``masked_scatter(_)`` and the ``dint::`` scatters; reducers are
``scatter_reduce(_)``, ``scatter_add(_)``, ``index_add(_)`` and
``index_put_(accumulate=True)``.

Severity ladder (the reference's):
  * overwrite scatter with no evidence -> ERROR ``nonunique-<op>``: the
    installed value is nondeterministic under duplicates.
  * float add/mul reducer with no evidence -> ERROR ``nonunique-<op>``:
    the value depends on reduction order (rounding).
  * integer add/max/min reducer with no evidence -> INFO ``reducer-dup``:
    the value is order-independent (the deliberate ``amin``/``amax``
    arbitration pattern) but duplicates serialize, so the node is
    surfaced for review, not failed.

The reference's ``batched-scatter`` warning (a vmapped scatter lowering to
a serial per-batch loop on a TPU) has no twin: a trace here holds no
batching dimension.
"""
from __future__ import annotations

from .. import dataflow as df
from ..core import (Finding, SEV_ERROR, SEV_INFO, TargetTrace,
                    def_chain_prims, register_pass)

_SEGMENT_EVIDENCE = df.SORTS


@register_pass("scatter_race")
def scatter_race(trace: TargetTrace) -> list[Finding]:
    """Flags scatters whose index operands are not provably conflict-free."""
    if trace.graph is None:
        return []
    out: list[Finding] = []
    for r in df.analyze(trace).scatters:
        if r.unique:
            continue                    # (a) the op's own contract
        if def_chain_prims(r.index) & _SEGMENT_EVIDENCE:
            continue                    # (b) segment-head-masked
        if df.LOCK_WIN in r.index_facts:
            continue                    # (c) grant-filtered lanes
        path = "/".join(r.path)
        if r.kind == "overwrite" or (r.kind in ("add", "mul")
                                     and r.is_float):
            out.append(Finding(
                "scatter_race", "nonunique-" + r.prim, SEV_ERROR,
                trace.name,
                f"`{r.prim}` with indices not certified unique (no kernel "
                "contract, no boolean mask, no segment sort, no lock "
                "grant in their def-chain): duplicate rows make the "
                "result nondeterministic "
                + ("(unspecified winner)" if r.kind == "overwrite"
                   else "(float reduction order)"),
                primitive=r.prim, site=r.site, path=path,
                suggestion="filter the lanes by the lock grant, resolve "
                           "duplicates with the segment machinery "
                           "(ops/segments.py) first, or install through "
                           "dint::scatter_streams, whose masked-in rows "
                           "are unique by contract"))
        else:
            out.append(Finding(
                "scatter_race", "reducer-dup", SEV_INFO, trace.name,
                f"`{r.prim}` ({r.kind}) without uniqueness evidence: the "
                "result is order-independent on integers (the deliberate "
                "arbitration pattern) but duplicate rows serialize",
                primitive=r.prim, site=r.site, path=path))
    return out
