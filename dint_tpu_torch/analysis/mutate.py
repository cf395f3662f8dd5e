"""dintmut engine: machine-made mutants of the fx traces prove the gates
bite (the port of `dint_tpu.analysis.mutate`).

Every standing gate (dintlint's protocol and structural passes, dintcost,
dintdur) claims it would catch a class of engine corruption: an install
nobody locked, a dropped replication hop, an unbounded ring, a doubled
gather. The fixtures of the tests back those claims on mini engines;
this module corrupts the REAL traces, the way mutation testing corrupts
a program for its test suite. It takes the traced fx graph of a
registered target (targets.TRACE_CACHE), applies one corruption from an
operator registry to a COPY of the graph (the cached trace is never
edited, and nothing is ever executed), re-runs every structural pass on
the mutant, and attributes the kill to the pass/code that fired. The
verdict matrix is pinned as ``MUTCOV_TORCH.json`` under the plan's
provenance-hash discipline; passes/mut_check.py is the standing gate
over that artifact.

Operator registry (OPERATORS), each the twin of the reference's:

  drop-eqn        delete protocol-bearing nodes: every lock arbitration
                  (the ``dint::lock_arbitrate``/``lock_validate`` kernels
                  and the ``scatter_reduce`` amax/amin of the unfused
                  route), every ``dint_mesh::ppermute`` hop, or the first
                  unfused log-append write. A dropped node's readers get
                  fresh placeholders (an in-place write's readers its
                  operand), so the fact it seeded never flows
                  (unlocked-install / no-replication-push / wal-order).
  weaken-scatter  the first arbitration made an overwrite (an amax/amin
                  ``scatter_reduce`` retargeted to ``scatter``; a lock
                  kernel replaced by an ``index_put_`` of its rows into
                  the arb table, its grant by a placeholder); or, as aten
                  has no ``unique_indices`` flag to flip, the first
                  certified install's index replaced by a fresh
                  placeholder: the one-writer evidence the scatter-race
                  ladder reads is gone (nonunique-*).
  mask-swap       an install's index AND values replaced by fresh
                  placeholders that nothing constrains (unlocked-,
                  unvalidated-, unelected-install).
  axis-swap       a dcn replication hop moved onto the ici axis, or every
                  hop's perm collapsed to the one +1 neighbour
                  (quorum-fanout).
  widen-gather    the leading dim of the largest table gather's output
                  doubled; its readers see the widened shape (formula-
                  mismatch, over-bytes-budget).
  out-of-place-write  the twin of the reference's ``drop-donation``
                  (the port has no donation): a step's last in-place
                  write to a table made out of place, so the table the
                  step returns is a fresh copy whose alias root is no
                  input (over-footprint-budget).
  ring-shrink     a log ring's placeholder shrunk to 2 slots: the
                  statically counted appends overflow it
                  (unbounded-ring).

A mutant never executes; it must stay WALKABLE by the dataflow and cost
analyzers: every fresh placeholder carries a meta value, and a widened
gather is marked (``meta["dint_widened"]``) so `core.logical_vals`
re-derives its readers' shapes. Placeholders are added after the
trace's own, so the carry pairs and the state inputs keep their places.

Kill attribution: the mutant runs `mut_passes()` (every structural pass;
plan_check, calib_check and mut_check check pinned documents, not
graphs) under the port's allowlist; ``new_errors`` is the mutant's
unsuppressed ERROR (pass, code) set minus the base trace's, ``killed``
means it is non-empty, and ``killer`` is the first new error matching
the operator's declared expectation (else the lexicographic first).
A pass that crashes on a mutant is a trace error, never a kill: the cell
records verdict ``crashed`` and mut_check fails on it. Suppressed codes
are recorded per cell, so the ``durability/no-ring-truncation``
allowlist entries stay cross-referenced against the ring operator
(mut_check's ring-triage-drift).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import random
from pathlib import Path
from typing import Callable

import torch

from ..ops import mesh_ops
from . import dataflow as df
from .core import (Finding, PASSES, SEV_ERROR, TargetTrace, _to_meta,
                   flat_nodes, op_name, site_of)

SCHEMA = 1
ARTIFACT = "MUTCOV_TORCH.json"
ENV_MUTCOV = "DINT_MUTCOV"          # artifact path override (tests)
QUICK_SEED = 20260807               # pinned quick-sample seed
KILL_RATE_FLOOR = 0.90              # standing ERROR below this
MAX_SITES = 2                       # per (target, operator) cell cap

# the artifact-anchored checks verify pinned documents, not graphs, and
# would fire identically on every mutant
_ANCHORED = {"plan_check", "calib_check", "mut_check"}


def mut_passes() -> list[str]:
    return sorted(p for p in PASSES if p not in _ANCHORED)


# ------------------------------------------------------ the graph copy


class _Module:
    """A mutant's module: its own graph, the base trace's constants."""

    def __init__(self, graph, base):
        self.graph = graph
        self._base = base

    def __getattr__(self, name):
        return getattr(self.__dict__["_base"], name)


def copy_trace(trace: TargetTrace) -> TargetTrace:
    """A TargetTrace over a fresh copy of ``trace``'s graph (node names
    kept; each node's meta a shallow copy without the memoized input
    list), sharing everything else. The cached trace is untouched."""
    g = torch.fx.Graph()
    vm: dict = {}
    out = g.graph_copy(trace.graph, vm)
    g.output(out)
    for n in g.nodes:
        n.meta = {k: v for k, v in n.meta.items() if k != "dint_inputs"}
    return dataclasses.replace(trace, gm=_Module(g, trace.gm))


def _by_name(graph) -> dict:
    return {n.name: n for n in graph.nodes}


def _fresh(graph, like, name: str):
    """A new placeholder after the trace's own, carrying ``like``'s meta
    value (a tensor, or a meta tensor of a given shape and dtype)."""
    first = next(n for n in graph.nodes if n.op != "placeholder")
    with graph.inserting_before(first):
        ph = graph.placeholder(f"mut_{name}")
    ph.meta = {"val": _to_meta(like) if isinstance(like, torch.Tensor)
               else None, "dint_site": "", "dint_stack": ()}
    return ph


def _val(node):
    v = node.meta.get("val") if isinstance(node, torch.fx.Node) else None
    return v


def _drop(graph, node):
    """Delete ``node``: an in-place aten write's readers read its operand;
    any other node's readers (its getitems' readers, for a tuple output)
    get fresh placeholders."""
    if df.is_inplace(node) or (df.scatter_kind(node) is not None
                               and isinstance(node.args[0], torch.fx.Node)
                               and "::" not in op_name(node)):
        node.replace_all_uses_with(node.args[0])
        graph.erase_node(node)
        return
    for u in list(node.users):
        if op_name(u) == "getitem":
            u.replace_all_uses_with(_fresh(graph, _val(u), u.name))
            graph.erase_node(u)
    if node.users:
        node.replace_all_uses_with(_fresh(graph, _val(node), node.name))
    graph.erase_node(node)


# ------------------------------------------------------ operator bricks


@dataclasses.dataclass
class Mutant:
    """One (target, operator, site) cell, before its edit."""
    target: str
    operator: str
    index: int                      # ordinal within (target, operator)
    site: str                       # source line of the edited node
    note: str                       # which edit variant is applied
    addr: tuple                     # the names of the nodes it edits
    edit: Callable                  # (graph, nodes by name) -> None

    @property
    def cell_id(self) -> str:
        return f"{self.target}|{self.operator}|{self.index}"

    def build(self, trace: TargetTrace) -> TargetTrace:
        mt = copy_trace(trace)
        self.edit(mt.graph, _by_name(mt.graph))
        return mt


@dataclasses.dataclass(frozen=True)
class MutOp:
    """One registered mutation operator (``stands_for``: the reference
    operator it is the twin of, where the name differs)."""
    name: str
    doc: str
    expect: tuple[str, ...]         # "pass/code" kill expectations, ranked
    find: Callable                  # (trace, flow) -> [(nodes, note, edit)]
    stands_for: str = ""


def _calls(trace):
    return [n for n in trace.graph.nodes if n.op == "call_function"]


def _site_group(trace, node) -> list:
    """Every node of ``node``'s op traced at its site and callers: a
    block unrolls its steps (and a mesh its partitions), so one line of
    the step is one node a step and a partition, where the reference's
    scan body holds one eqn. An edit of a site edits them all."""
    key = (op_name(node), node.meta.get("dint_stack"))
    return [n for n in _calls(trace)
            if (op_name(n), n.meta.get("dint_stack")) == key]


def _each(edit_one, names):
    def edit(graph, by):
        for nm in names:
            edit_one(graph, by, nm)
    return edit


def _is_arb(node) -> bool:
    return (op_name(node) in df.KERNEL_LOCKS
            or df.scatter_kind(node) in ("max", "min"))


def _installs(flow: df.Dataflow) -> list:
    """The overwrite scatters into state the protocol pass governs, in
    node order (kernel streams once a call)."""
    out, seen = [], set()
    for r in flow.scatters:
        if r.kind == "overwrite" and r.is_state \
                and df.LOG_SLOT not in r.index_facts \
                and r.node not in seen:
            seen.add(r.node)
            out.append(r)
    return out


def _drop_all(names):
    def edit(graph, by):
        for nm in names:
            if nm in by:
                _drop(graph, by[nm])
    return edit


def _find_drop_eqn(trace, flow):
    """The lock-arbitration group (every arbitration node: a step's win
    mask merges its tables' arbitrations, so dropping one of a pair
    leaves it tainted by the other), the ppermute group, the first
    unfused log-append write."""
    out = []
    arbs = [n for n in _calls(trace) if _is_arb(n)]
    if arbs:
        out.append((arbs, f"drop {len(arbs)} lock-arb node(s)",
                    _drop_all([n.name for n in arbs])))
    hops = [n for n in _calls(trace)
            if op_name(n) == "dint_mesh::ppermute"]
    if hops:
        out.append((hops, f"drop {len(hops)} ppermute node(s)",
                    _drop_all([n.name for n in hops])))
    logs = [r for r in flow.log_appends()
            if not r.fused and "::" not in r.prim]
    if logs:
        grp = _site_group(trace, logs[0].node)
        out.append((grp, f"drop log-append ({op_name(grp[0])}, "
                    f"{len(grp)} node(s))",
                    _drop_all([n.name for n in grp])))
    return out


def _to_overwrite(graph, by, name):
    node = by[name]
    if "::" in op_name(node):      # a lock kernel: index_put_ its rows
        arb, rows = node.args[0], node.args[1]
        r, a = _val(rows), _val(arb)
        like = torch.empty(tuple(r.shape), dtype=a.dtype, device="meta") \
            if isinstance(r, torch.Tensor) and isinstance(
                a, torch.Tensor) else None
        val = _fresh(graph, like, f"{name}_val")
        with graph.inserting_before(node):
            graph.call_function(torch.ops.aten.index_put_.default,
                                (arb, [rows], val))
        _drop(graph, node)
        return
    inplace = df.is_inplace(node)
    node.target = (torch.ops.aten.scatter_.src if inplace
                   else torch.ops.aten.scatter.src)
    node.args = tuple(node.args[:4])
    node.kwargs = {}


def _swap_index(graph, by, name):
    node = by[name]
    _, idx, _ = df.scatter_args(node)
    i = df._SCATTER_ARGS[df.base_name(node)][0]
    fresh = []
    for k, n in enumerate(flat_nodes(idx)):
        v = _val(n)
        if isinstance(v, torch.Tensor) and v.dtype == torch.bool:
            v = torch.empty((v.numel(),), dtype=torch.int64,
                            device="meta")
        fresh.append(_fresh(graph, v, f"{name}_idx{k}"))
    args = list(node.args)
    args[i] = fresh if isinstance(idx, (list, tuple)) else fresh[0]
    node.args = tuple(args)


def _find_weaken_scatter(trace, flow):
    """The first arbitration site made an overwrite; the first certified
    aten install site's index made unconstrained."""
    out = []
    arb = next((n for n in _calls(trace) if _is_arb(n)), None)
    if arb is not None:
        grp = _site_group(trace, arb)
        out.append((grp, f"{op_name(arb)} -> overwrite scatter "
                    f"({len(grp)} node(s))",
                    _each(_to_overwrite, [n.name for n in grp])))
    for r in _installs(flow):
        if "::" in r.prim:
            continue
        if r.unique or df.LOCK_WIN in r.index_facts \
                or df.SORTED in r.index_facts:
            grp = _site_group(trace, r.node)
            out.append((grp, f"{r.prim} index -> unconstrained, the "
                        f"one-writer evidence removed ({len(grp)} "
                        "node(s))",
                        _each(_swap_index, [n.name for n in grp])))
            break
    return out


def _swap_mask(graph, by, name):
    node = by[name]
    if "::" in op_name(node):      # a dint:: scatter: stream 0
        hot = op_name(node) == "dint::scatter_rows_hot"
        i_idx, i_val = (2, 5) if hot else (1, 2)
        args = list(node.args)
        for i in (i_idx, i_val):
            lst = list(args[i])
            lst[0] = _fresh(graph, _val(lst[0]), f"{name}_{i}")
            args[i] = lst
        node.args = tuple(args)
        return
    i_idx, i_val = df._SCATTER_ARGS[df.base_name(node)]
    args = list(node.args)
    for i in (i_idx, i_val):
        a = args[i] if len(args) > i else None
        nodes = flat_nodes(a)
        if not nodes:
            continue
        fresh = [_fresh(graph, _val(n), f"{name}_{i}_{k}")
                 for k, n in enumerate(nodes)]
        args[i] = fresh if isinstance(a, (list, tuple)) else fresh[0]
    node.args = tuple(args)


def _find_mask_swap(trace, flow):
    """Replace an install's index AND values with fresh placeholders: the
    write no longer descends from the grant or the validate compare.
    Swapping only the index is not enough: the engines bake the win mask
    into the values (``where(win, new, old)``). Two installs of distinct
    sites at most."""
    out, sites = [], set()
    for r in _installs(flow):
        key = r.stack
        if key in sites:
            continue
        sites.add(key)
        grp = _site_group(trace, r.node)
        out.append((grp, "index+values -> unconstrained placeholders "
                    f"({len(grp)} node(s))",
                    _each(_swap_mask, [n.name for n in grp])))
        if len(out) >= MAX_SITES:
            break
    return out


def _find_axis_swap(trace, flow):
    """A dcn hop moved onto the ici axis (2-D meshes); every hop's perm
    collapsed to one shared +1 destination a source (quorum-fanout
    unions the destinations over every hop, so collapsing one of a
    redundant pair changes nothing)."""
    hops = [n for n in _calls(trace)
            if op_name(n) == "dint_mesh::ppermute"]
    live = []
    for n in hops:
        perm = mesh_ops.node_perm(n)
        if perm and not all(s == d for s, d in perm):
            live.append(n)
    out = []
    dcn = next((n for n in live if "dcn" in str(n.args[1])
                and len(mesh_ops.node_mesh(n)[1]) >= 2), None)
    if dcn is not None:
        axes = mesh_ops.node_mesh(dcn)[1]
        ici = next(a for a in axes if "dcn" not in a)

        def to_ici(graph, by, name=dcn.name, ici=ici):
            node = by[name]
            args = list(node.args)
            args[1] = ici
            node.args = tuple(args)
        out.append(([dcn], f"axis {str(dcn.args[1])!r} -> {ici!r}",
                    to_ici))
    if live:
        names = [n.name for n in live]

        def collapse(graph, by, names=names):
            for nm in names:
                node = by[nm]
                shape, axes = mesh_ops.node_mesh(node)
                size = shape[axes.index(str(node.args[1]))]
                perm = mesh_ops.node_perm(node)
                args = list(node.args)
                args[2] = [v for s, _ in perm for v in (s, (s + 1) % size)]
                node.args = tuple(args)
        out.append((live, f"{len(live)} perm(s) -> single +1 destination",
                    collapse))
    return out


_GATHER_OPS = frozenset({"index", "index_select", "gather", "take"})
_KERNEL_GATHERS = frozenset({"dint::gather_rows", "dint::gather_streams",
                             "dint::gather_rows_hot"})


def _nbytes(v) -> int:
    if isinstance(v, torch.Tensor):
        return int(v.numel()) * int(v.element_size())
    return 0


def _find_widen_gather(trace, flow):
    """Double the leading dim of the largest table gather's output (an
    aten gather of a state table, or a stream of a ``dint::`` gather
    kernel): the read that dominates its wave's byte ledger."""
    best = None
    for n in _calls(trace):
        name = op_name(n)
        if name in _KERNEL_GATHERS:
            vals = _val(n) or []
            for s, v in enumerate(vals):
                if isinstance(v, torch.Tensor) and v.dim() and (
                        best is None or _nbytes(v) > best[0]):
                    best = (_nbytes(v), n, s)
        elif df.base_name(n) in _GATHER_OPS:
            src = n.args[0]
            root = flow.roots.get(src, src)
            v = _val(n)
            if isinstance(root, torch.fx.Node) and root.op == "placeholder" \
                    and isinstance(v, torch.Tensor) and v.dim() and (
                        best is None or _nbytes(v) > best[0]):
                best = (_nbytes(v), n, None)
    if best is None:
        return []
    _, node, stream = best
    v = _val(node) if stream is None else _val(node)[stream]
    wide = (2 * int(v.shape[0]),) + tuple(v.shape[1:])
    grp = _site_group(trace, node)

    def widen(graph, by, name):
        n = by[name]
        old = _val(n)
        cur = old if stream is None else old[stream]
        w = torch.empty((2 * int(cur.shape[0]),) + tuple(cur.shape[1:]),
                        dtype=cur.dtype, device="meta")
        if stream is None:
            n.meta["val"] = w
        else:
            vals = list(old)
            vals[stream] = w
            n.meta["val"] = vals
        n.meta["dint_widened"] = True
    where = "" if stream is None else f" stream {stream}"
    return [(grp, f"gather{where} out {tuple(v.shape)} -> {wide} "
             f"({len(grp)} node(s))",
             _each(widen, [n.name for n in grp]))]


def _find_out_of_place(trace, flow):
    """The step's last in-place write to a table, made out of place: the
    table it returns is then a fresh copy (the corruption class of a
    dropped donation)."""
    last = list(trace.graph.nodes)[-1]
    outs = flat_nodes(last.args[0]) if last.op == "output" else []
    for o in outs:
        name = op_name(o)
        if o.op != "call_function" or not df.is_inplace(o) \
                or df.scatter_kind(o) is None:
            continue
        root = flow.roots.get(o, o)
        if not (isinstance(root, torch.fx.Node) and root.op == "placeholder"):
            continue
        functional = getattr(torch.ops.aten, name[:-1], None)
        overload = getattr(functional, o.target._overloadname, None) \
            if functional is not None else None
        if overload is None:
            continue

        def edit(graph, by, nm=o.name, overload=overload):
            by[nm].target = overload
        return [([o], f"{name} -> {name[:-1]} (the returned table is a "
                 "fresh copy)", edit)]
    return []


def _find_ring_shrink(trace, flow):
    """Shrink the ring placeholder an unfused append writes to 2 slots."""
    out, done = [], set()
    for r in flow.log_appends():
        if r.fused or "::" in r.prim:
            continue
        root = r.root
        if not (isinstance(root, torch.fx.Node) and root.op == "placeholder"):
            continue
        if root.name in done:
            continue
        v = _val(root)
        shape = tuple(v.shape) if isinstance(v, torch.Tensor) else ()
        if len(shape) == 3:
            small = (1, 2) + shape[2:]
        elif len(shape) == 2:
            small = (2,) + shape[1:]
        else:
            continue
        done.add(root.name)

        def edit(graph, by, nm=root.name, small=small, dtype=v.dtype):
            n = by[nm]
            n.meta["val"] = torch.empty(small, dtype=dtype, device="meta")
        out.append(([r.node], f"ring {shape} -> {small} (2 slots)", edit))
        if len(out) >= MAX_SITES:
            break
    return out


OPERATORS: dict[str, MutOp] = {op.name: op for op in [
    MutOp("drop-eqn",
          "delete the lock arbitrations / the ppermute hops / a "
          "log-append write",
          ("protocol/unlocked-install", "durability/quorum-fanout",
           "protocol/no-replication-push", "durability/wal-order",
           "protocol/no-writer-election"),
          _find_drop_eqn),
    MutOp("weaken-scatter",
          "arbitration -> overwrite; an install's one-writer evidence "
          "removed",
          ("scatter_race/nonunique-scatter",
           "scatter_race/nonunique-scatter_",
           "scatter_race/nonunique-index_put_",
           "scatter_race/nonunique-index_put",
           "protocol/unlocked-install", "protocol/uncertified-install",
           "protocol/no-writer-election"),
          _find_weaken_scatter),
    MutOp("mask-swap",
          "replace an install's index and values with unconstrained "
          "placeholders",
          ("protocol/unlocked-install", "protocol/unvalidated-install",
           "protocol/unelected-install"),
          _find_mask_swap),
    MutOp("axis-swap",
          "ppermute dcn -> ici; collapse the perms' destinations",
          ("durability/quorum-fanout",),
          _find_axis_swap),
    MutOp("widen-gather",
          "double a table gather's output rows to blow the byte ledger",
          ("cost_budget/formula-mismatch", "cost_budget/over-bytes-budget"),
          _find_widen_gather),
    MutOp("out-of-place-write",
          "a step's last in-place table write made out of place (a "
          "copied table)",
          ("cost_budget/over-footprint-budget",),
          _find_out_of_place, stands_for="drop-donation"),
    MutOp("ring-shrink",
          "shrink a log ring to 2 slots",
          ("durability/unbounded-ring",),
          _find_ring_shrink),
]}


def discover(trace: TargetTrace, operators) -> list[Mutant]:
    """The mutant cells of one target, deterministically (graph order x
    registry order), at most MAX_SITES an operator."""
    if trace.graph is None:
        return []
    flow = df.analyze(trace)
    out: list[Mutant] = []
    for opname in operators:
        op = OPERATORS[opname]
        for idx, (nodes, note, edit) in enumerate(
                op.find(trace, flow)[:MAX_SITES]):
            out.append(Mutant(trace.name, opname, idx, site_of(nodes[0]),
                              note, tuple(n.name for n in nodes), edit))
    return out


# ------------------------------------------------------- mutant running


def _run_passes(trace: TargetTrace, passes, entries) -> tuple[list, list]:
    """(findings, crashed passes) of the structural pass matrix on one
    (possibly mutant) trace, the allowlist applied."""
    from . import allowlist as al
    findings: list[Finding] = []
    crashed: list[str] = []
    for pname in passes:
        try:
            findings.extend(PASSES[pname](trace))
        except Exception as e:      # noqa: BLE001 — recorded, never a kill
            crashed.append(f"{pname}/pass-crash: {type(e).__name__}: {e}")
    al.apply(findings, entries, check_unused=False)
    return findings, crashed


def _error_set(findings) -> set[tuple[str, str]]:
    return {(f.pass_name, f.code) for f in findings
            if f.severity == SEV_ERROR and not f.suppressed}


def _suppressed_set(findings) -> set[tuple[str, str]]:
    return {(f.pass_name, f.code) for f in findings if f.suppressed}


def _load_entries(path=None):
    from . import allowlist as al
    from .. import analysis
    path = path or analysis.DEFAULT_ALLOWLIST
    return al.load(path) if os.path.exists(path) else []


class MutRunner:
    """Shared state for a matrix run: the pass list, the allowlist, and
    each target's baseline error set (computed once a target)."""

    def __init__(self, passes=None, entries=None):
        self.passes = list(passes) if passes else mut_passes()
        self.entries = entries if entries is not None else _load_entries()
        self._baseline: dict[str, set] = {}

    def baseline(self, trace: TargetTrace) -> set[tuple[str, str]]:
        got = self._baseline.get(trace.name)
        if got is None:
            findings, _ = _run_passes(trace, self.passes, self.entries)
            got = self._baseline[trace.name] = _error_set(findings)
        return got

    def run_cell(self, trace: TargetTrace, mut: Mutant, expect) -> dict:
        """Build and analyze one mutant: its MUTCOV cell record."""
        base = self.baseline(trace)
        try:
            mtrace = mut.build(trace)
            findings, crashed = _run_passes(mtrace, self.passes,
                                            self.entries)
        except Exception as e:      # noqa: BLE001 — the edit itself broke
            findings, crashed = [], [f"build/crash: {type(e).__name__}: {e}"]
        new = sorted(f"{p}/{c}" for p, c in _error_set(findings) - base)
        killer = ""
        if crashed:
            verdict, new = "crashed", sorted(
                c.split(":", 1)[0] for c in crashed)
        elif new:
            verdict = "killed"
            killer = next((e for e in expect if e in new), new[0])
        else:
            verdict = "survived"
        return {
            "id": mut.cell_id,
            "target": mut.target,
            "operator": mut.operator,
            "site": mut.site,
            "note": mut.note,
            "verdict": verdict,
            "killer": killer,
            "new_errors": new,
            "suppressed": sorted(f"{p}/{c}" for p, c
                                 in _suppressed_set(findings)),
        }


# --------------------------------------------------- MUTCOV pinning


def _digest(obj) -> str:
    return hashlib.sha256(
        json.dumps(obj, sort_keys=True, default=str).encode()
    ).hexdigest()[:16]


def _operators_doc() -> dict:
    return {name: {"doc": op.doc, "expect": list(op.expect),
                   **({"stands_for": op.stands_for} if op.stands_for
                      else {})}
            for name, op in sorted(OPERATORS.items())}


def registry_hash() -> str:
    """Pins the operator registry, the pass matrix and the policy knobs:
    any edit to what dintmut mutates or how kills are judged re-pins."""
    return _digest({
        "schema": SCHEMA,
        "floor": KILL_RATE_FLOOR,
        "max_sites": MAX_SITES,
        "passes": mut_passes(),
        "operators": _operators_doc(),
    })


def matrix_hash() -> str:
    """Pins the target matrix (names, protocol flags, operator sets)."""
    from . import targets as T
    return _digest({
        name: {"protocol": list(T.TARGET_PROTOCOL.get(name, ())),
               "operators": list(ops)}
        for name, ops in T.MUT_TARGETS.items()})


def _summary(cells: list[dict]) -> dict:
    by_op: dict[str, dict] = {}
    killers: dict[str, int] = {}
    for c in cells:
        rec = by_op.setdefault(c["operator"], {"cells": 0, "killed": 0})
        rec["cells"] += 1
        if c["verdict"] == "killed":
            rec["killed"] += 1
            kp = c["killer"].split("/", 1)[0]
            killers[kp] = killers.get(kp, 0) + 1
    n_killed = sum(r["killed"] for r in by_op.values())
    return {
        "n_cells": len(cells),
        "n_killed": n_killed,
        "n_survived": len(cells) - n_killed,
        "kill_rate": round(n_killed / len(cells), 4) if cells else 0.0,
        "by_operator": {k: by_op[k] for k in sorted(by_op)},
        "killer_passes": {k: killers[k] for k in sorted(killers)},
    }


def quick_sample(cells: list[dict], seed: int = QUICK_SEED) -> list[str]:
    """One deterministically drawn cell an operator (the quick gate
    re-runs these bit for bit)."""
    rnd = random.Random(seed)
    out = []
    by_op: dict[str, list[str]] = {}
    for c in cells:
        by_op.setdefault(c["operator"], []).append(c["id"])
    for op in sorted(by_op):
        ids = sorted(by_op[op])
        out.append(ids[rnd.randrange(len(ids))])
    return out


def _trace_of(tname, get_trace):
    from . import targets as T
    try:
        trace = get_trace(tname)
    except T.SkipTarget:
        return None
    return None if trace.graph is None else trace


def run_matrix(targets=None, progress=None, get_trace=None) -> dict:
    """Run the whole (target x operator x site) matrix and assemble the
    MUTCOV document (unpinned: `save_mutcov` pins it). ``get_trace``
    (default: the lint geometry's cache) names where the traces come
    from: chip_smoke.py passes its traces of the card."""
    from . import targets as T
    get_trace = get_trace or T.get_trace
    matrix = dict(T.MUT_TARGETS)
    if targets is not None:
        matrix = {k: v for k, v in matrix.items() if k in set(targets)}
    runner = MutRunner()
    cells: list[dict] = []
    skipped: list[str] = []
    for tname in sorted(matrix):
        trace = _trace_of(tname, get_trace)
        if trace is None:
            skipped.append(tname)
            continue
        for mut in discover(trace, matrix[tname]):
            if progress:
                progress(mut)
            cells.append(runner.run_cell(
                trace, mut, OPERATORS[mut.operator].expect))
    return {
        "schema": SCHEMA,
        "kill_rate_floor": KILL_RATE_FLOOR,
        "passes": runner.passes,
        "operators": _operators_doc(),
        "targets": {name: {"protocol":
                           list(T.TARGET_PROTOCOL.get(name, ())),
                           "operators": list(matrix[name])}
                    for name in sorted(matrix)},
        "skipped": skipped,
        "cells": cells,
        "summary": _summary(cells),
        "quick": {"seed": QUICK_SEED, "cells": quick_sample(cells)},
        "provenance": {"registry": registry_hash(),
                       "matrix": matrix_hash(),
                       "cells": _digest(cells)},
    }


def run_cells(cell_ids, passes=None, get_trace=None) -> list[dict]:
    """Re-run the named pinned cells (the quick gate): rediscover their
    targets' mutants and run exactly those ids. An id no longer found
    comes back as verdict 'missing-cell' (registry or code drift)."""
    from . import targets as T
    get_trace = get_trace or T.get_trace
    wanted = list(cell_ids)
    by_target: dict[str, list[str]] = {}
    for cid in wanted:
        by_target.setdefault(cid.split("|", 1)[0], []).append(cid)
    runner = MutRunner(passes=passes)
    got: dict[str, dict] = {}
    for tname, ids in sorted(by_target.items()):
        if tname not in T.MUT_TARGETS:
            continue
        trace = _trace_of(tname, get_trace)
        if trace is None:
            continue
        muts = {m.cell_id: m
                for m in discover(trace, T.MUT_TARGETS[tname])}
        for cid in ids:
            if cid in muts:
                got[cid] = runner.run_cell(
                    trace, muts[cid], OPERATORS[muts[cid].operator].expect)
    return [got.get(cid, {"id": cid, "verdict": "missing-cell"})
            for cid in wanted]


def mutcov_path() -> Path:
    env = os.environ.get(ENV_MUTCOV)
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / ARTIFACT


def save_mutcov(doc: dict, path=None) -> Path:
    p = Path(path) if path else mutcov_path()
    p.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")
    return p


def load_mutcov(path=None) -> dict:
    p = Path(path) if path else mutcov_path()
    with open(p) as fh:
        doc = json.load(fh)
    if not isinstance(doc, dict) or doc.get("schema") != SCHEMA:
        got = doc.get("schema") if isinstance(doc, dict) else None
        raise ValueError(
            f"{p}: MUTCOV schema {got!r} != {SCHEMA} — regenerate with "
            "`python -m dint_tpu_torch.dintmut run`")
    return doc
