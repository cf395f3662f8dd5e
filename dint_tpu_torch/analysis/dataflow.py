"""dintproof dataflow: forward protocol-fact propagation over fx traces.

The local passes look at one node plus a backward def slice. The protocol
invariants the engines' correctness rests on — OCC's "install only what
you locked AND validated" and 2PL's "every abort path releases its locks"
(FaSST, OSDI'16; engines/tatp_dense.py "Scatter discipline") — are
dataflow properties: the lock grant computed at wave 1 of step t gates
the install at wave 3 of step t+2. This module is the taint layer under
passes/protocol.py: a forward fact propagation over the whole traced
graph in node order. A target traces a block of at least three steps,
unrolled, so the grant of step t reaches the install of step t+2 through
real dataflow; the carry the block hands to its next call (the pairs
``TargetTrace.carry``, and every state input's in-place contents) is fed
back into the inputs until the facts stop growing, as the reference
iterates its scan carries to a fixpoint.

Facts (a small powerset lattice, may-analysis: a fact on a value means
"some contributing definition carries it"):

  provenance facts (computed first)
    STATE       the value IS persistent carry state (a table). Seeded on
                the state inputs (the carry's tensors); held by their
                alias roots, so a view of a table is the table.
    TBL_READ    gathered out of persistent state (``index``,
                ``index_select``, ``gather``, a view of a table, or a
                ``dint::`` gather of a state table).
    ARB         produced by arbitration: ``scatter_reduce`` with
                amax/amin, or the ``dint::lock_arbitrate`` /
                ``lock_validate`` kernels (their arb argument and grant).
                KILLED at overwrite writes, so the character of an array
                tracks its last write.
    SORTED      derived from ``sort``/``argsort``/``unique*`` — the
                segment machinery whose head/last masks make scatters
                one-writer by construction.

  protocol facts (computed second, against the converged provenance)
    LOCK_WIN    data-dependent on winning lock arbitration. Seeded at
                eq/ne compares with an ARB-carrying input (``first_x[slot]
                == lane``, the expiring-stamp held test) and at the grant
                and the arb argument of the ``dint::`` lock kernels.
    VALIDATED   data-dependent on an OCC stamp-equality check. Seeded at
                eq/ne compares of two non-constant tensors where an input
                carries TBL_READ and none ARB (``vvB != vv1``), and at
                ``dint::lock_validate``'s ``vbad``.
    STAMP       derived from the host step counter. The counter is a
                Python int, so a trace holds it as a literal: STAMP seeds
                at a node whose scalar constant takes another value at
                each traced step at one site (the stamp value a step
                writes), and at the ``dint::`` lock kernels' grant and arb.
    ABORT_MASK  a transaction-level abort aggregate: ``any`` over
                LOCK_WIN/VALIDATED-carrying lanes (``lock_rejected =
                (active & ~granted).any(1)``, ``changed = bad.any(1)``).

  durability facts (dintdur, passes/durability.py)
    LOG_SLOT    (provenance) a ring slot id computed by the log-append
                machinery. Seeded at ``remainder`` nodes whose site lies
                in tables/log.py (``arange % lanes`` and ``pos % cap`` of
                `_lane_slots`), so any scatter whose INDICES carry
                LOG_SLOT is a log append: `LogRing.append`, `append_rep`,
                and the fused route's log stream (plan_rep's ``flat``
                rides into ``dint::scatter_streams``).
    LOGGED      (protocol) written by a log-append scatter: seeded at a
                scatter whose index carries LOG_SLOT, and on a
                ``dint::scatter_streams`` call stream by stream (only the
                ring's stream of the fused install_log is an append; the
                meta and val streams are installs).
    TRUNCATED   (protocol) a ring watermark advance: seeded at the
                ``minimum`` clamp of tables/log.advance_watermark.

  Not in this port yet: REPL_PUSHED (the mesh's collectives do not show
  in a trace; parallel/mesh.py re-indexes a list).

In-place writes: facts live on alias roots. A view (``view``, ``slice``,
``select``, ``expand`` ...) shares its base's root; an in-place op
(``index_put_``, ``copy_``, ``fill_``, any ``*_`` overload, and the
``(a!)`` arguments of a ``dint::`` op) joins its write facts into the
root at that point in the order, and every later read of any alias of the
root sees them.

Why two phases: seed conditions like "TBL_READ without ARB" are not
monotone, so phase 2's seeds read phase 1's converged provenance (a
node's own facts and its root's final facts).

The result (`Dataflow`) is an inventory the protocol pass consumes:
per-scatter fact summaries with operand roots, seed sites, the lock
kernels, the in-place writes and the alias roots. `analyze()` memoizes
per TargetTrace.
"""
from __future__ import annotations

import dataclasses

import torch

from .core import (TargetTrace, flat_nodes, logical_vals, node_inputs,
                   op_name, site_of, walk)

# ------------------------------------------------------------------ facts

LOCK_WIN = "LOCK_WIN"
VALIDATED = "VALIDATED"
STAMP = "STAMP"
ABORT_MASK = "ABORT_MASK"
STATE = "STATE"
TBL_READ = "TBL_READ"
ARB = "ARB"
SORTED = "SORTED"
LOG_SLOT = "LOG_SLOT"
LOGGED = "LOGGED"
TRUNCATED = "TRUNCATED"

# source anchor of the durability seeds: the slot math of `_lane_slots`
# and the watermark clamp of `advance_watermark` both live here
_LOG_MODULE = "tables/log.py"

# ops whose output aliases their first argument's storage
VIEWS = frozenset({
    "view", "_unsafe_view", "_reshape_alias", "reshape", "squeeze",
    "unsqueeze", "slice", "select", "expand", "permute", "transpose", "t",
    "alias", "as_strided", "diagonal", "unfold", "view_as", "narrow",
    "split", "split_with_sizes", "unbind", "chunk", "detach", "flatten",
    "unflatten", "movedim", "expand_as", "view_as_real", "view_as_complex",
    "_unsafe_view", "lift_fresh"})
# (index argument, update argument) of the scatter family, by base name
_SCATTER_ARGS = {
    "index_put": (1, 2), "index_copy": (2, 3), "scatter": (2, 3),
    "scatter_add": (2, 3), "scatter_reduce": (2, 3), "index_add": (2, 3),
    "masked_scatter": (1, 2),
}
_OVERWRITE = frozenset({"index_copy", "scatter", "masked_scatter"})
GATHERS = frozenset({"index", "index_select", "gather", "take",
                     "take_along_dim", "embedding"})
SORTS = frozenset({"sort", "argsort", "msort", "unique", "_unique",
                   "_unique2", "unique_dim", "unique_consecutive",
                   "unique_dim_consecutive", "topk"})
_CMP = frozenset({"eq", "ne"})
_ANY = frozenset({"any"})
_KERNEL_SCATTERS = frozenset({"dint::scatter_streams",
                              "dint::scatter_rows_hot"})
KERNEL_LOCKS = frozenset({"dint::lock_arbitrate", "dint::lock_validate"})

_MAX_ROUNDS = 12
_EMPTY: frozenset = frozenset()


def base_name(node) -> str:
    """An op's name without its in-place underscore (``index_put_`` ->
    ``index_put``); kernels keep their ``dint::`` name."""
    name = op_name(node)
    if name.endswith("_") and not name.startswith("_") and "::" not in name:
        return name[:-1]
    return name


def is_inplace(node) -> bool:
    """An aten op that writes its first argument in place."""
    name = op_name(node)
    return (node.op == "call_function" and "::" not in name
            and name.endswith("_") and not name.startswith("_"))


def scatter_kind(node) -> str | None:
    """'overwrite', 'add', 'max', 'min' or 'mul' for a scatter-family
    node; None for anything else (the kernels' scatters included)."""
    b = base_name(node)
    if b not in _SCATTER_ARGS:
        return None
    if b == "index_put":
        acc = node.kwargs.get("accumulate",
                              node.args[3] if len(node.args) > 3 else False)
        return "add" if acc else "overwrite"
    if b in _OVERWRITE:
        return "overwrite"
    if b == "scatter_reduce":
        red = node.kwargs.get("reduce", node.args[4]
                              if len(node.args) > 4 else "sum")
        return {"amax": "max", "amin": "min", "prod": "mul"}.get(red, "add")
    return "add"


def scatter_args(node):
    """(operand, index argument, update argument) of a scatter node; the
    update is a scalar for ``scatter.value`` and ``index_put`` of one."""
    i, u = _SCATTER_ARGS[base_name(node)]
    args = list(node.args)
    return (args[0], args[i] if len(args) > i else None,
            args[u] if len(args) > u else None)


def bool_index(arg) -> bool:
    """True when an index argument holds a boolean mask (each position
    written once by construction)."""
    for n in flat_nodes(arg):
        v = n.meta.get("val")
        if v is not None and getattr(v, "dtype", None) == torch.bool:
            return True
    return False


def distinct_const(gm, index) -> bool:
    """An index argument whose tensors are all constants of the trace
    (lifted tensor constants) holding distinct values: the counters'
    fixed slots."""
    nodes = flat_nodes(index)
    if not nodes:
        return False
    for n in nodes:
        while n.op == "call_function" and op_name(n) in (
                "lift_fresh_copy", "lift_fresh", "_to_copy", "view"):
            n = n.args[0]
        if n.op != "get_attr":
            return False
        t = getattr(gm, str(n.target), None)
        if not isinstance(t, torch.Tensor) or \
                t.unique().numel() != t.numel():
            return False
    return True


def is_const(arg) -> bool:
    """A literal, or a tensor constant the trace lifted."""
    if not isinstance(arg, torch.fx.Node):
        return True
    if arg.op == "get_attr":
        return True
    return (op_name(arg) in ("lift_fresh_copy", "lift_fresh")
            and all(is_const(a) for a in arg.args))


def _scalar_consts(node, gm):
    """The scalar constants a node reads: its literal arguments and the
    one-element tensor constants it lifts."""
    out = []
    for pos, a in enumerate(list(node.args) + list(node.kwargs.values())):
        if isinstance(a, bool) or a is None:
            continue
        if isinstance(a, (int, float)):
            out.append((pos, a))
        elif isinstance(a, torch.fx.Node) and a.op == "get_attr":
            t = getattr(gm, str(a.target), None)
            if isinstance(t, torch.Tensor) and t.numel() == 1:
                out.append((pos, t.item()))
    return out


# ops whose scalar arguments are data (a value computed or stored), as
# opposed to positions, dims and shapes (``bits[i]``'s step index)
_VALUE_OPS = frozenset({
    "add", "sub", "rsub", "mul", "bitwise_or", "bitwise_and",
    "bitwise_xor", "__or__", "__and__", "__xor__", "__lshift__",
    "bitwise_left_shift", "where", "full", "full_like", "fill", "fill_",
    "scalar_tensor", "lift_fresh_copy", "masked_fill", "masked_fill_",
    "eq", "ne", "lt", "le", "gt", "ge", "maximum", "minimum", "clamp",
    "index_put", "index_put_", "scatter", "scatter_"})


def varying_nodes(trace: TargetTrace) -> set:
    """Nodes whose scalar data constants take more than one value over the
    nodes of one site and op: the host step counter (or another host
    scalar that changes per step) traced as a literal. Positions (an
    index, a dim, a slice bound) do not count: ``bits[i]`` takes step i's
    draws, not a stamp."""
    seen: dict = {}
    for ctx in walk(trace):
        site = site_of(ctx.node)
        if not site or ctx.prim not in _VALUE_OPS:
            continue
        for pos, v in _scalar_consts(ctx.node, trace.gm):
            seen.setdefault((site, ctx.prim, pos), []).append((ctx.node, v))
    out = set()
    for vals in seen.values():
        if len({v for _, v in vals}) > 1:
            out.update(n for n, _ in vals)
    return out


# ---------------------------------------------------------------- records


@dataclasses.dataclass
class SeedSite:
    """One node that introduced a protocol fact (reported provenance)."""
    fact: str
    prim: str
    site: str
    path: tuple[str, ...]


@dataclasses.dataclass
class ScatterRec:
    """One scatter-family write with its fact summary (a kernel scatter
    gives one record per stream and per mirror).

    ``root`` identifies WHICH array the write updates: the operand's
    alias root (a state input, or a fresh array). Records sharing a root
    write the same array — how the protocol pass groups a lock table's
    acquire and release sites. ``kind``: 'overwrite', 'add', 'max',
    'min' or 'mul'. ``unique``: the one-writer evidence the op itself
    gives (a ``dint::`` scatter's contract, a boolean-mask index, or a
    constant index of distinct values). ``idx_rows``: the lanes the write
    takes, as if every masked-in filter kept all of them (core.
    logical_vals; dintdur's ring bound); ``fused``: one stream of a
    ``dint::`` scatter."""
    prim: str
    kind: str
    site: str
    path: tuple[str, ...]
    in_kernel: bool
    is_state: bool
    is_float: bool
    operand_facts: frozenset
    index_facts: frozenset
    update_facts: frozenset
    root: object
    unique: bool
    node: object = None
    index: object = None
    idx_rows: int = 0
    fused: bool = False

    @property
    def stack(self) -> tuple:
        """The site and its callers (a helper's writes differ by caller)."""
        return self.node.meta.get("dint_stack", (self.site,)) \
            if self.node is not None else (self.site,)

    @property
    def write_facts(self) -> frozenset:
        return self.index_facts | self.update_facts


@dataclasses.dataclass
class Dataflow:
    """Analysis result for one TargetTrace (memoized on the trace)."""
    seeds: list[SeedSite]
    scatters: list[ScatterRec]
    kernel_locks: list[SeedSite]       # dint:: lock kernel calls
    roots: dict                        # node -> alias root node
    writes: list                       # (node, root, written arg node)

    def seeded(self, fact: str) -> list[SeedSite]:
        return [s for s in self.seeds if s.fact == fact]

    def log_appends(self) -> list[ScatterRec]:
        """Scatters whose indices descend from the log slot math: the
        LOGGED sites, fused and unfused routes alike."""
        return [r for r in self.scatters if LOG_SLOT in r.index_facts]


# --------------------------------------------------------------- analyzer


class _Analyzer:
    def __init__(self, trace: TargetTrace):
        self.trace = trace
        self.nodes = list(trace.graph.nodes)
        self.ctx = {c.node: c for c in walk(trace)}
        self.placeholders = [n for n in self.nodes if n.op == "placeholder"]
        self.state = {ph for ph, (_, st) in zip(self.placeholders,
                                                trace.inputs) if st}
        self.roots = self._alias_roots()
        self.varying = varying_nodes(trace)
        self.logical = logical_vals(trace)
        self.env: dict = {}
        self.root_env: dict = {}
        self.prov_env: dict = {}
        self.prov_root: dict = {}
        self.protocol_phase = False
        self.recording = False
        self._seeds: dict = {}
        self._scatters: list = []
        self._locks: dict = {}
        self._writes: list = []

    # -- structure ------------------------------------------------------

    def _alias_roots(self) -> dict:
        roots: dict = {}
        for n in self.nodes:
            r = n
            if n.op == "call_function":
                name = op_name(n)
                src = n.args[0] if n.args else None
                if name == "getitem" and isinstance(src, torch.fx.Node) \
                        and op_name(src) in VIEWS:
                    r = roots.get(src, src)
                elif isinstance(src, torch.fx.Node) and (
                        name in VIEWS or is_inplace(n)):
                    r = roots.get(src, src)
            roots[n] = r
        return roots

    def root(self, node):
        return self.roots.get(node, node)

    # -- env helpers ----------------------------------------------------

    def facts(self, arg) -> frozenset:
        """Facts of an argument at this point of the order (its own and
        its alias root's); a list argument joins its elements'."""
        out = set()
        for n in flat_nodes(arg):
            v = self.env.get(n, _EMPTY)
            out |= v if isinstance(v, frozenset) else frozenset().union(*v)
            out |= self.root_env.get(self.root(n), _EMPTY)
        return frozenset(out)

    def pfacts(self, arg) -> frozenset:
        """Converged provenance facts of an argument (phase 1's result in
        phase 2, the current facts in phase 1)."""
        if not self.protocol_phase:
            return self.facts(arg)
        out = set()
        for n in flat_nodes(arg):
            v = self.prov_env.get(n, _EMPTY)
            out |= v if isinstance(v, frozenset) else frozenset().union(*v)
            out |= self.prov_root.get(self.root(n), _EMPTY)
        return frozenset(out)

    def write(self, target, fs, kill_arb=False):
        """Join ``fs`` into the alias root of each node of ``target``."""
        for n in flat_nodes(target):
            r = self.root(n)
            cur = set(self.root_env.get(r, _EMPTY))
            if kill_arb:
                cur.discard(ARB)
            self.root_env[r] = frozenset(cur | (set(fs) - {STATE}))
            if self.recording:
                self._writes.append((self._current, r, n))

    def _width(self, index) -> int:
        """Lanes of an index argument: the largest logical numel of its
        tensors."""
        out = 0
        for n in flat_nodes(index):
            v = self.logical.get(n)
            if isinstance(v, torch.Tensor):
                out = max(out, int(v.numel()))
        return out

    def _seed(self, fact, node):
        if self.recording:
            c = self.ctx.get(node)
            self._seeds[(fact, node)] = SeedSite(
                fact, op_name(node), site_of(node), c.path if c else ())

    # -- entry ------------------------------------------------------------

    def run(self) -> Dataflow:
        self._phase(protocol=False)
        self.prov_env, self.prov_root = self.env, self.root_env
        self._phase(protocol=True)
        return Dataflow(seeds=list(self._seeds.values()),
                        scatters=self._scatters,
                        kernel_locks=list(self._locks.values()),
                        roots=self.roots, writes=self._writes)

    def _carry_back(self) -> dict:
        """What one call of the block hands to the next: each state
        input's in-place contents, and each output carry leaf's facts for
        the input it becomes."""
        out = {ph: set(self.root_env.get(ph, _EMPTY)) for ph in self.state}
        last = self.nodes[-1] if self.nodes else None
        outputs = list(last.args[0]) if last is not None and \
            last.op == "output" else []
        for o, i in self.trace.carry:
            if o < len(outputs) and isinstance(outputs[o], torch.fx.Node):
                out.setdefault(self.placeholders[i], set()).update(
                    self.facts(outputs[o]))
        return out

    def _phase(self, protocol: bool):
        self.protocol_phase = protocol
        carried: dict = {}
        for _ in range(_MAX_ROUNDS):
            self._round(carried)
            back = self._carry_back()
            changed = False
            for ph, fs in back.items():
                new = fs - carried.get(ph, set())
                if new:
                    carried.setdefault(ph, set()).update(new)
                    changed = True
            if not changed:
                break
        self.recording = protocol
        self._round(carried)
        self.recording = False

    def _round(self, carried):
        self.env, self.root_env = {}, {}
        seed = {STATE} if not self.protocol_phase else set()
        for ph in self.placeholders:
            fs = set(carried.get(ph, ()))
            if ph in self.state:
                fs |= seed
            self.root_env[ph] = frozenset(fs)
        for n in self.nodes:
            if n.op == "call_function":
                self._current = n
                self.transfer(n)

    # -- transfer ---------------------------------------------------------

    def transfer(self, node):
        name = op_name(node)
        if name == "getitem":
            src, idx = node.args[0], node.args[1]
            v = self.env.get(src, _EMPTY)
            self.env[node] = (v[idx] if isinstance(v, list) and idx < len(v)
                              else (v if isinstance(v, frozenset)
                                    else frozenset().union(*v)))
            return
        if name.startswith("dint::"):
            return self._kernel(node, name)
        if scatter_kind(node) is not None:
            return self._scatter(node)
        ins = node_inputs(node)
        base = set(self.facts(ins))
        extra = set()
        if not self.protocol_phase:
            src = node.args[0] if node.args else None
            src_state = STATE in self.facts(src)
            base.discard(STATE)
            if name in SORTS:
                extra.add(SORTED)
            elif name == "remainder" and _LOG_MODULE in site_of(node):
                # the slot math of the log rings: whatever it feeds is
                # log-append indexing (monotone: the site test is fixed)
                extra.add(LOG_SLOT)
            elif name in GATHERS or name in VIEWS:
                if src_state:
                    extra.add(TBL_READ)
        else:
            pin = self.pfacts(ins)
            if name in _CMP:
                tensors = [a for a in node.args[:2]
                           if isinstance(a, torch.fx.Node)]
                if ARB in pin:
                    extra.add(LOCK_WIN)
                    self._seed(LOCK_WIN, node)
                elif TBL_READ in pin and len(tensors) == 2 \
                        and not any(is_const(a) for a in tensors):
                    extra.add(VALIDATED)
                    self._seed(VALIDATED, node)
            elif name in _ANY:
                if base & {LOCK_WIN, VALIDATED}:
                    extra.add(ABORT_MASK)
                    self._seed(ABORT_MASK, node)
            elif name == "minimum" and _LOG_MODULE in site_of(node):
                # the watermark clamp of advance_watermark: the only
                # truncation anchor the rings expose
                extra.add(TRUNCATED)
                self._seed(TRUNCATED, node)
            if node in self.varying:
                extra.add(STAMP)
                self._seed(STAMP, node)
        out = frozenset(base | extra)
        self.env[node] = out
        if is_inplace(node):
            self.write(node.args[0], self.facts(node.args[1:]) | extra)

    def _scatter(self, node):
        kind = scatter_kind(node)
        operand, idx, upd = scatter_args(node)
        idx_f, upd_f = self.facts(idx), self.facts(upd)
        extra = set()
        if not self.protocol_phase:
            if kind in ("max", "min"):
                extra.add(ARB)
        else:
            if node in self.varying:
                extra.add(STAMP)
                self._seed(STAMP, node)
            if LOG_SLOT in self.pfacts(idx):
                extra.add(LOGGED)
                self._seed(LOGGED, node)
            upd_f = upd_f | (extra if not isinstance(upd, torch.fx.Node)
                             else _EMPTY)
        write = (set(idx_f) | set(upd_f) | extra) - {STATE}
        if kind == "overwrite":
            write.discard(ARB)
        out = set(self.facts(operand)) | write
        if kind == "overwrite":
            out.discard(ARB)
        self.env[node] = frozenset(out)
        if is_inplace(node):
            self.write(operand, write, kill_arb=kind == "overwrite")
        if self.recording:
            c = self.ctx.get(node)
            val = operand.meta.get("val") if isinstance(
                operand, torch.fx.Node) else None
            self._scatters.append(ScatterRec(
                prim=op_name(node), kind=kind, site=site_of(node),
                path=c.path if c else (), in_kernel=False,
                is_state=STATE in self.pfacts(operand),
                is_float=bool(val is not None and val.dtype.is_floating_point),
                operand_facts=self.facts(operand) | self.pfacts(operand),
                index_facts=idx_f | self.pfacts(idx),
                update_facts=upd_f | self.pfacts(upd),
                root=self.root(operand) if isinstance(
                    operand, torch.fx.Node) else None,
                unique=(bool_index(idx) or base_name(node) == "masked_scatter"
                        or distinct_const(self.trace.gm, idx)),
                node=node, index=idx, idx_rows=self._width(idx)))

    def _kernel(self, node, name):
        a = node.args
        if name in KERNEL_LOCKS:
            return self._lock(node, name)
        if name in _KERNEL_SCATTERS:
            return self._kernel_scatter(node, name)
        if name in ("dint::gather_rows", "dint::gather_streams",
                    "dint::gather_rows_hot"):
            hot = name == "dint::gather_rows_hot"
            tabs, idxs = a[0], a[2] if hot else a[1]
            outs = []
            for s in range(len(tabs)):
                srcs = [tabs[s], idxs[s]] + ([a[1][s], a[3][s]] if hot
                                             else [])
                fs = set(self.facts(srcs)) - {STATE}
                if not self.protocol_phase and STATE in self.facts(
                        [tabs[s]] + ([a[1][s]] if hot else [])):
                    fs.add(TBL_READ)
                outs.append(frozenset(fs))
            self.env[node] = outs
            return
        fs = set(self.facts(node_inputs(node))) - {STATE}
        if not self.protocol_phase and name == "dint::scan_rows" and \
                STATE in self.facts(node_inputs(node)):
            fs.add(TBL_READ)
        n_out = 4 if name == "dint::scan_rows" else 1
        self.env[node] = [frozenset(fs)] * n_out if n_out > 1 \
            else frozenset(fs)

    def _lock(self, node, name):
        a = node.args
        arb = a[0]
        merged = set(self.facts(node_inputs(node))) - {STATE}
        validate = name == "dint::lock_validate"
        if not self.protocol_phase:
            arb_side = frozenset(merged | {ARB})
            read = set(merged) - {ARB}
            if validate and STATE in self.facts(a[1]):
                read.add(TBL_READ)
            self.write(arb, arb_side)
            self.env[node] = ([arb_side, frozenset(read), frozenset(read)]
                              if validate else arb_side)
            return
        won = frozenset(merged | {LOCK_WIN, STAMP})
        self.write(arb, won)
        if self.recording:
            c = self.ctx.get(node)
            self._locks[node] = SeedSite(LOCK_WIN, name, site_of(node),
                                         c.path if c else ())
        self._seed(LOCK_WIN, node)
        self._seed(STAMP, node)
        if validate:
            self._seed(VALIDATED, node)
            self.env[node] = [won, frozenset(merged | {VALIDATED}),
                              frozenset(merged)]
        else:
            self.env[node] = won

    def _kernel_scatter(self, node, name):
        a = node.args
        hot = name == "dint::scatter_rows_hot"
        if hot:
            tabs, mirrors, idxs, midxs, masks, vals = a[:6]
        else:
            tabs, idxs, vals = a[:3]
        c = self.ctx.get(node)
        for s in range(len(tabs)):
            lanes = [(tabs[s], idxs[s])]
            if hot:
                lanes.append((mirrors[s], midxs[s]))
            for tab, idx in lanes:
                index = [idx] + ([masks[s]] if hot else [])
                idx_f, upd_f = self.facts(index), self.facts(vals[s])
                write = (set(idx_f) | set(upd_f)) - {STATE, ARB}
                if self.protocol_phase and LOG_SLOT in self.pfacts(idx):
                    # this stream is the ring's: an append, the others
                    # of the call are installs
                    write.add(LOGGED)
                    self._seed(LOGGED, node)
                if self.recording:
                    self._scatters.append(ScatterRec(
                        prim=name, kind="overwrite", site=site_of(node),
                        path=c.path if c else (), in_kernel=False,
                        is_state=STATE in self.pfacts(tab), is_float=False,
                        operand_facts=self.facts(tab) | self.pfacts(tab),
                        index_facts=idx_f | self.pfacts(index),
                        update_facts=upd_f | self.pfacts(vals[s]),
                        root=self.root(tab), unique=True, node=node,
                        index=index, idx_rows=self._width(idx),
                        fused=True))
                self.write(tab, write, kill_arb=True)
        self.env[node] = _EMPTY


# -------------------------------------------------------------------- API


def analyze(trace: TargetTrace) -> Dataflow:
    """Run (or fetch the memoized) dataflow for a traced target."""
    cached = getattr(trace, "_dataflow", None)
    if cached is not None:
        return cached
    flow = _Analyzer(trace).run()
    trace._dataflow = flow
    return flow

