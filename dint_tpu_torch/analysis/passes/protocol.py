"""Protocol pass: dataflow proofs of the engines' transaction invariants.

The reference's eBPF verifier gives structural guarantees before a
handler may run (DINT, NSDI'24); the steps' equivalents — the FaSST-style
OCC contract "install only what you locked AND validated" and 2PL's
"every abort path releases its locks" (FaSST, OSDI'16) — are checked
here. The pass consumes the forward fact propagation of
analysis/dataflow.py (LOCK_WIN / VALIDATED / STAMP / ABORT_MASK over a
block of unrolled steps, its carry fed back to a fixpoint) and enforces
ERROR-severity checks gated by the per-target protocol flags of
analysis/targets.py:

  lock-dominance       ["certified"]  every overwrite scatter into
      persistent table state (an aten scatter or a ``dint::`` scatter
      stream) must have indices or updates data-dependent on LOCK_WIN —
      the write mask descends from a lock grant — or on SORTED (the
      segment machinery's one-writer representatives).
      -> ``unlocked-install``

  validate-before-install ["occ"]     on OCC paths the same scatters must
      also carry VALIDATED: the install mask descends from the read-set
      version compare (or ``dint::lock_validate``'s verdict).
      -> ``unvalidated-install``

  abort-implies-unlock ["certified" or "drain"]  if the trace produces an
      ABORT_MASK, every lock array that receives grants (a state scatter
      whose write facts carry LOCK_WIN) must also release:
      (a) expiring stamps — some write to the array stores the step
          counter (updates carry STAMP), or the arbitration runs in a
          ``dint::lock_arbitrate``/``lock_validate`` kernel (the witness
          of the reference's lock_arbitrate Pallas kernel); or
      (b) a release write — a write whose facts carry ABORT_MASK; or
      (c) two distinct scatter sites on the array (an acquire wave and a
          release wave). Sites with their callers (a helper such as
          ops/segments.scatter_rows writes both waves from one line), not
          records: a block traces each site once a step.
      -> ``abort-leaks-lock``

  writer-election      ["elected"]  lock-free server engines (the store)
      elect one writer per key with the segment machinery:
      (a) ``no-writer-election`` — the trace must hold a
          ``scatter_reduce`` amax/amin over SORTED indices;
      (b) ``unelected-install`` — every overwrite install into state must
          carry SORTED in its write facts;
      (c) ``uncertified-install`` — each such install must state its one
          writer a row: a ``dint::`` scatter (unique rows by contract) or
          a boolean-mask index, the port's counterparts of
          ``unique_indices=True``.

  commit-after-replication ["replicated"]  mesh paths must push
      install records over a replication hop and land them: at least one
      ``dint_mesh::ppermute`` in the trace (``no-replication-push``), and
      at least one scatter into persistent state whose write facts carry
      REPL_PUSHED, the backup-apply and forwarded-log writes
      (``push-not-applied``). The committed-outcome stats ride the same
      carry those writes update, so a path that drops the push or
      discards the pushed payload fails deterministically.

Targets whose builders close no protocol loop in-trace declare fewer
flags, as the reference's do (``sharded/*`` servers: the coordinator owns
the sequencing; ``tatp_dense/drain``: only abort-implies-unlock).
Fixtures in tests/test_torch_dintlint.py prove each check fires on a
mutated engine and stays silent on the safe idiom.
"""
from __future__ import annotations

from .. import dataflow as df
from ..core import Finding, SEV_ERROR, TargetTrace, register_pass

FLAG_CERTIFIED = "certified"
FLAG_OCC = "occ"
FLAG_REPLICATED = "replicated"
FLAG_DRAIN = "drain"
FLAG_SERVER = "server"
FLAG_ELECTED = "elected"


def _installs(flow: df.Dataflow):
    """Overwrite scatters into persistent state (the install writes the
    first two checks govern)."""
    return [r for r in flow.scatters
            if r.kind == "overwrite" and r.is_state and not r.in_kernel]


def _lock_roots(flow: df.Dataflow):
    """Group state scatters by operand root and keep the arrays that
    receive lock grants (some scatter's write facts carry LOCK_WIN)."""
    by_root: dict = {}
    for r in flow.scatters:
        if r.is_state and not r.in_kernel and r.root is not None:
            by_root.setdefault(r.root, []).append(r)
    return [recs for recs in by_root.values()
            if any(df.LOCK_WIN in r.write_facts for r in recs)]


@register_pass("protocol")
def protocol(trace: TargetTrace) -> list[Finding]:
    """Proves lock-dominates-write, validate-before-install,
    abort-implies-unlock and writer-election dataflow."""
    if trace.graph is None:
        return []                    # the purity pass owns trace failures
    flags = set(getattr(trace, "protocol", None) or ())
    if not flags:
        return []
    flow = df.analyze(trace)
    out: list[Finding] = []

    installs = _installs(flow)
    if FLAG_CERTIFIED in flags:
        for r in installs:
            if not (r.write_facts & {df.LOCK_WIN, df.SORTED}):
                out.append(Finding(
                    "protocol", "unlocked-install", SEV_ERROR, trace.name,
                    "overwrite scatter into persistent table state whose "
                    "indices/updates carry neither LOCK_WIN (a lock-grant "
                    "dependency) nor segment-sort evidence: the write "
                    "mask does not descend from lock certification, so a "
                    "refactor can install rows nobody locked",
                    primitive=r.prim, site=r.site, path="/".join(r.path),
                    suggestion="derive the scatter mask (or its "
                               "where()-masked indices) from the grant of "
                               "the lock arbitration, as "
                               "engines/tatp_dense.pipe_step's wmask "
                               "does, or resolve writers with "
                               "ops/segments.sort_batch"))

    if FLAG_OCC in flags:
        for r in installs:
            if df.VALIDATED not in r.write_facts:
                out.append(Finding(
                    "protocol", "unvalidated-install", SEV_ERROR,
                    trace.name,
                    "install scatter on an OCC path whose indices/updates "
                    "do not depend on VALIDATED (the read-set stamp "
                    "equality re-check): the engine can install a write "
                    "whose read set changed after wave 1 — the exact "
                    "FaSST verify-stage contract",
                    primitive=r.prim, site=r.site, path="/".join(r.path),
                    suggestion="fold the validate compare into the "
                               "surviving-txn mask before the install "
                               "wave (alive & ~changed in "
                               "engines/tatp_dense.pipe_step)"))

    if flags & {FLAG_CERTIFIED, FLAG_DRAIN}:
        aborts = flow.seeded(df.ABORT_MASK)
        roots = _lock_roots(flow)
        if aborts and (roots or flow.kernel_locks):
            for recs in roots:
                expiring = any(df.STAMP in r.update_facts for r in recs)
                releasing = any(df.ABORT_MASK in r.write_facts
                                for r in recs)
                two_site = len({r.stack for r in recs}) >= 2
                if not (expiring or releasing or two_site
                        or flow.kernel_locks):
                    grant_site = next(
                        (r for r in recs
                         if df.LOCK_WIN in r.write_facts), recs[0])
                    out.append(Finding(
                        "protocol", "abort-leaks-lock", SEV_ERROR,
                        trace.name,
                        "this trace produces an abort mask "
                        f"(first seed: {aborts[0].prim} at "
                        f"{aborts[0].site}) but the lock array written "
                        "here is grant-only: no expiring step stamp in "
                        "its updates, no write whose facts carry "
                        "ABORT_MASK, and no second release site — an "
                        "aborting transaction leaves its lock held "
                        "forever",
                        primitive=grant_site.prim, site=grant_site.site,
                        path="/".join(grant_site.path),
                        suggestion="stamp the step counter into the "
                                   "lock word so stale locks expire "
                                   "(engines/smallbank_dense), or add "
                                   "the release wave over every granted "
                                   "lock, committed or aborted "
                                   "(engines/smallbank_pipeline's REL "
                                   "block)"))

    if FLAG_REPLICATED in flags:
        if not flow.ppermutes:
            out.append(Finding(
                "protocol", "no-replication-push", SEV_ERROR, trace.name,
                "replicated path with no ppermute in the trace: install "
                "records are never forwarded to the +1/+2 backup "
                "partitions (the reference's CommitBck x2 / CommitLog x3 "
                "fan-out)",
                suggestion="forward the Installs record with "
                           "Mesh.ppermute as parallel/dense_sharded.py "
                           "does"))
        elif not any(df.REPL_PUSHED in r.write_facts and r.is_state
                     for r in flow.scatters):
            out.append(Finding(
                "protocol", "push-not-applied", SEV_ERROR, trace.name,
                "ppermute present but nothing it moved is ever scattered "
                "into persistent state: the pushed install records are "
                "discarded, so backups and forwarded logs silently "
                "diverge from the primary",
                primitive=flow.ppermutes[0].prim,
                site=flow.ppermutes[0].site,
                path="/".join(flow.ppermutes[0].path),
                suggestion="apply the ppermuted record to the backup "
                           "tables and append it to the local log "
                           "(parallel/dense_sharded._apply_backup)"))

    if FLAG_ELECTED in flags:
        elections = [r for r in flow.scatters
                     if r.kind in ("max", "min") and not r.in_kernel
                     and df.SORTED in r.index_facts]
        if not elections:
            out.append(Finding(
                "protocol", "no-writer-election", SEV_ERROR, trace.name,
                "lock-free server trace with no segment reduction: no "
                "scatter_reduce amax/amin over SORTED indices exists, so "
                "nothing arbitrates between duplicate writers to the same "
                "key — last-writer-wins degrades to whichever lane "
                "happens to scatter last",
                suggestion="elect one writer per key segment with "
                           "ops/segments.seg_max_where over the sorted "
                           "batch ranks, as engines/store.step does"))
        for r in installs:
            if df.SORTED not in r.write_facts:
                out.append(Finding(
                    "protocol", "unelected-install", SEV_ERROR,
                    trace.name,
                    "overwrite scatter into persistent server state "
                    "whose indices/updates carry no SORTED evidence: the "
                    "write mask does not descend from the segment writer "
                    "election, so duplicate or unelected lanes can "
                    "install racing rows",
                    primitive=r.prim, site=r.site, path="/".join(r.path),
                    suggestion="route the install mask through the "
                               "sorted-batch election "
                               "(segments.sort_batch + seg_max_where) "
                               "before scattering"))
            elif not r.unique:
                out.append(Finding(
                    "protocol", "uncertified-install", SEV_ERROR,
                    trace.name,
                    "elected install scatter that does not state one "
                    "writer a row (neither a dint:: scatter, unique by "
                    "contract, nor a boolean-mask index)",
                    primitive=r.prim, site=r.site, path="/".join(r.path),
                    suggestion="install through dint::scatter_rows_hot / "
                               "scatter_streams, or write through a "
                               "boolean mask"))

    return out
