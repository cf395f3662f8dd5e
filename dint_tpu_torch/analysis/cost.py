"""dintcost derivation: the static cost model behind passes/cost_budget,
the port of `dint_tpu.analysis.cost`.

dintlint proves the hot paths safe and the protocol pass that they are
sequenced; neither says what they COST. The port has two copies of the
row-traffic ledger already: the hand-declared formulas of
monitor/waves.py and the card's timings that dintscope attributes. This
module derives a third FROM THE TRACE, so an extra memory-op dispatch, a
doubled gather or a table that a step copies where it should write in
place becomes a deterministic CPU failure.

Per registered target (analysis/targets.py, trace-once cache) one walk
over the fx graph (`core.walk`) derives:

* **Logical bytes per step.** A gather (``index``, ``index_select``,
  ``gather``, ``take``) whose operand is persistent state counts its
  output bytes (random row reads); an overwrite or reducing scatter into
  state (``index_put``, ``index_copy``, ``scatter``, ``scatter_reduce``,
  ``scatter_add``, ``index_add``, in place or not) counts the elements it
  writes; each ``dint::`` kernel is priced by the rule of its schema
  (`kernel_bytes`, the counterpart of the reference's ``_pallas_bytes``).
  "State" is the reference's boolean shadow: a state input, an alias of
  one (analysis/dataflow.py's alias roots), or the output of any op that
  keeps a state operand's element count (a conversion, an elementwise
  op, a reshape). A state word read through such an op is priced at the
  word size of the state it came from: the port widens u32 words to int64
  for arithmetic (ops/u32.py), which is not row traffic.
  Elementwise traffic is not modeled, as in the reference.
* **Dispatches per step.** One per priced node: the chain of memory ops
  the megakernels exist to shrink.
* **Persistent footprint.** The bytes of the distinct storages of the
  step's inputs, plus every output whose alias root is no input (a fresh
  allocation the step keeps live): the counterpart of the reference's
  donation-aware footprint. A step that clones a table where it should
  write in place grows it by the table's bytes.

What differs from the reference:

* **The nonzero rule.** JAX's installs and log appends are ``mode="drop"``
  scatters over all w lanes; the port keeps the masked-in lanes with a
  ``nonzero`` first, so a real-tensor trace holds the draws' widths. Every
  width is taken from `core.logical_vals` (each filter keeps all its
  lanes), which prices what JAX prices and does not depend on the draws;
  the filter's own lane compaction (``x[keep]``, JAX's ``where``) is not a
  memory op. An access behind a filter records its lane count.
* **No collectives.** The in-process mesh's ``ppermute``/``all_to_all``
  re-index a Python list (parallel/mesh.py), so no collective appears in
  a trace and the per-axis link bytes stay zero. A wave whose waves.py
  formula prices collective bytes (`COLLECTIVE_WAVES`) is left out of
  reconciliation and of the ledger and named in ``unpriced_waves``.
* **Per step.** A target traces a block of ``steps`` steps, unrolled, and
  the model divides by it, as the reference divides by its scan length.

Wave attribution is the innermost ``dint.<engine>.<wave>`` range of the
node's path (the `record_function` scopes of monitor/waves.py), the same
names monitor/attrib.py charges device time to: dintscope measures what
dintcost predicts. Models are memoized per TargetTrace (`model_for`).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Iterable

import torch

from ..monitor import waves
from ..monitor.attrib import WAVE_ALIASES
from . import dataflow as df
from .core import (TargetTrace, filter_mask, flat_nodes, logical_vals,
                   node_inputs, op_name, site_of, walk)

# formula-vs-derived reconciliation band: |derived/declared - 1| <= tol
# (covers the registry's coarsest hand estimate, the ~20 B log-entry
# header against the real HDR_WORDS = 4, 16 B)
DEFAULT_TOL = 0.25

_WAVE_RE = re.compile(r"^dint\.[A-Za-z0-9_]+\.[A-Za-z0-9_]+$")

_GATHERS = frozenset({"index", "index_select", "gather", "take"})
_SCATTERS = frozenset({"index_put", "index_copy", "scatter",
                       "scatter_reduce", "scatter_add", "index_add"})
# ops whose output never carries the state shadow (their numel matching a
# state operand's is a coincidence of the draws or of the geometry)
_NOT_STATE = frozenset({"nonzero", "_local_scalar_dense"})
# views through which a filter's index reaches its lane compaction
_LANE_VIEWS = frozenset({"squeeze", "view", "_unsafe_view", "reshape",
                         "select", "unsqueeze", "flatten", "alias"})

# waves whose waves.py formula prices collective bytes (the mesh's
# routes, replies and replication): the trace cannot see the collectives
COLLECTIVE_WAVES = frozenset(waves.full_name(e, w) for e, w in (
    ("dense_sharded", "replicate"),
    ("dense_sharded_sb", "route"), ("dense_sharded_sb", "reply"),
    ("dense_sharded_sb", "install_route"),
    ("dense_sharded_sb", "replicate"),
    ("multihost_sb", "route"), ("multihost_sb", "reply"),
    ("multihost_sb", "install_route"), ("multihost_sb", "replicate"),
    ("multihost_sb", "route_prefetch")))


def _numel(v) -> int:
    return int(v.numel()) if isinstance(v, torch.Tensor) else 0


def _nbytes(v) -> int:
    if isinstance(v, torch.Tensor):
        return int(v.numel()) * int(v.element_size())
    if isinstance(v, (list, tuple)):
        return sum(_nbytes(x) for x in v)
    return 0


def wave_of(ctx) -> str | None:
    """The innermost registered dint.<engine>.<wave> scope of a node's
    path, or None."""
    for name in reversed(ctx.path):
        if _WAVE_RE.match(name):
            return name
    return None


@dataclasses.dataclass
class Access:
    """One counted memory operation of the trace."""
    kind: str           # "gather" | "scatter" | "kernel"
    prim: str
    wave: str | None    # full dint.<engine>.<wave> name, or None
    bytes: float        # logical bytes for the whole trace
    dispatches: float   # dispatch count for the whole trace
    site: str = ""
    path: str = ""
    lanes: int = 0      # behind a nonzero filter: its mask's lanes
    axis: str = ""      # collectives only (none in a port trace)
    link_bytes: float = 0.0


@dataclasses.dataclass
class CostModel:
    """The derived per-target cost model (every ``*_per_step`` figure is
    normalized by the steps a trace holds)."""
    target: str
    steps: float
    geom: dict
    accesses: list[Access]
    footprint_bytes: int
    input_bytes: int
    donated_bytes: int
    error: str = ""
    unpriced_waves: list = dataclasses.field(default_factory=list)

    @property
    def bytes_per_step(self) -> float:
        return sum(a.bytes for a in self.accesses) / self.steps

    @property
    def dispatches_per_step(self) -> float:
        return sum(a.dispatches for a in self.accesses) / self.steps

    def _per_step(self, key, field: str) -> dict[str, float]:
        """Sums of an access field by ``key(access)`` (None = skipped),
        each divided by the steps once (a block's totals are exact)."""
        out: dict[str, float] = {}
        for a in self.accesses:
            k = key(a)
            if k is not None:
                out[k] = out.get(k, 0.0) + getattr(a, field)
        return {k: v / self.steps for k, v in out.items()}

    def wave_bytes_per_step(self) -> dict[str, float]:
        return self._per_step(lambda a: a.wave or "(unattributed)", "bytes")

    def wave_dispatches_per_step(self) -> dict[str, float]:
        return self._per_step(lambda a: a.wave or "(unattributed)",
                              "dispatches")

    def kernel_dispatches_per_step(self) -> dict[str, float]:
        """``dint::`` dispatches a step by kernel name."""
        return self._per_step(lambda a: a.prim.split("::")[-1]
                              if a.kind == "kernel" else None, "dispatches")

    def axis_bytes_per_step(self) -> dict[str, float]:
        """Per-axis link bytes/step; zero on the port (no collective shows
        in a trace)."""
        out = {"ici": 0.0, "dcn": 0.0}
        for a in self.accesses:
            if a.axis:
                out[a.axis] = out.get(a.axis, 0.0) \
                    + a.link_bytes / self.steps
        return out

    @property
    def dcn_bytes_per_step(self) -> float:
        return self.axis_bytes_per_step().get("dcn", 0.0)

    def wave_axis_bytes_per_step(self) -> dict[str, dict[str, float]]:
        out: dict[str, dict[str, float]] = {}
        for a in self.accesses:
            if not a.axis:
                continue
            key = a.wave or "(unattributed)"
            per = out.setdefault(key, {"ici": 0.0, "dcn": 0.0})
            per[a.axis] = per.get(a.axis, 0.0) + a.link_bytes / self.steps
        return out

    def to_dict(self) -> dict:
        per_axis = self.wave_axis_bytes_per_step()
        tot_axis = self.axis_bytes_per_step()
        disp = self.wave_dispatches_per_step()
        return {
            "target": self.target,
            "steps": self.steps,
            "geom": dict(self.geom),
            "bytes_per_step": round(self.bytes_per_step, 2),
            "dispatches_per_step": round(self.dispatches_per_step, 3),
            "ici_bytes_per_step": round(tot_axis.get("ici", 0.0), 2),
            "dcn_bytes_per_step": round(tot_axis.get("dcn", 0.0), 2),
            "footprint_bytes": self.footprint_bytes,
            "input_bytes": self.input_bytes,
            "donated_bytes": self.donated_bytes,
            "waves": {
                w: {"bytes_per_step": round(b, 2),
                    "dispatches_per_step": round(disp.get(w, 0.0), 3),
                    "ici_bytes_per_step": round(
                        per_axis.get(w, {}).get("ici", 0.0), 2),
                    "dcn_bytes_per_step": round(
                        per_axis.get(w, {}).get("dcn", 0.0), 2)}
                for w, b in sorted(self.wave_bytes_per_step().items())},
            "unpriced_waves": list(self.unpriced_waves),
            "error": self.error,
        }


# ------------------------------------------------- per-kernel byte rules
#
# A kernel moves its traffic inside one dispatch; the trace shows the
# call, so bytes come from its schema (ops/library.py). Each rule is the
# logical row traffic of the torch chain the kernel replaces, as the
# reference's rules for its Pallas kernels are.


def kernel_bytes(name: str, args, out) -> float:
    """Bytes a call of the ``dint::`` kernel ``name`` moves, from its
    arguments and output values (logical shapes)."""
    def nb(v):
        return float(_nbytes(v))

    def n(v):
        return _numel(v)

    if name == "lock_arbitrate":
        # the 3-pass RMW (stamp gather, scatter-max, grant read-back) over
        # m = rows.numel() lanes, 4 B each (waves.py lock)
        return float(4 * 3 * n(args[1]))
    if name == "lock_validate":
        # + the validate read (vidx) and the fresh meta read (ridx)
        return float(4 * (3 * n(args[5]) + n(args[2]) + n(args[4])))
    if name == "scatter_streams":
        # every vals stream, masked lanes counted, as JAX's rule: a hot
        # mirror is a stream of its own
        return nb(args[2])
    if name == "scatter_rows_hot":
        # each vals stream written to the table and, where midx >= 0, to
        # its mirror: two masked passes over the lanes, priced as B3's
        # mirror streams and as JAX's hot/cold double pass
        return 2 * nb(args[5])
    if name == "scalar_scatter":
        return nb(args[2])
    # gather_rows, gather_streams, gather_rows_hot (no mirror refresh),
    # scan_rows: the rows they return
    return nb(out)


# ------------------------------------------------------------ the walker


class _Walker:
    def __init__(self, trace: TargetTrace):
        self.trace = trace
        self.flow = df.analyze(trace)
        self.vals = logical_vals(trace)
        self.accesses: list[Access] = []
        self.seen_waves: set[str] = set()
        self.origin: dict = {}       # node -> itemsize of its state word
        phs = [n for n in trace.graph.nodes if n.op == "placeholder"]
        for ph, (_, st) in zip(phs, trace.inputs):
            v = self.vals.get(ph)
            if st and isinstance(v, torch.Tensor):
                self.origin[ph] = int(v.element_size())

    def root(self, node):
        return self.flow.roots.get(node, node)

    def state_of(self, arg) -> int:
        """The word size of the state ``arg`` is (an alias of), 0 if none."""
        if not isinstance(arg, torch.fx.Node):
            return 0
        return self.origin.get(arg) or self.origin.get(self.root(arg), 0)

    def run(self):
        for ctx in walk(self.trace):
            wave = wave_of(ctx)
            if wave:
                self.seen_waves.add(wave)
            self.node(ctx, wave)
        return self.accesses

    def _rec(self, ctx, wave, kind, nbytes, lanes=0):
        self.accesses.append(Access(
            kind=kind, prim=ctx.prim, wave=wave, bytes=float(nbytes),
            dispatches=1.0, site=site_of(ctx.node), path="/".join(ctx.path),
            lanes=int(lanes)))

    def _lanes(self, index) -> int:
        mask = filter_mask(index)
        v = self.vals.get(mask) if mask is not None else None
        return _numel(v)

    def node(self, ctx, wave):
        node = ctx.node
        name = df.base_name(node)
        out = self.vals.get(node)
        if ctx.in_kernel:
            args = torch.fx.node.map_arg(node.args, self.vals.get)
            self._rec(ctx, wave, "kernel",
                      kernel_bytes(name.split("::")[-1], args, out))
            return
        if name in _GATHERS:
            word = self.state_of(node.args[0])
            index = node.args[1:]
            if word and not self._lane_compaction(node):
                self._rec(ctx, wave, "gather", _numel(out) * word,
                          self._lanes(index))
            return
        if name in _SCATTERS:
            operand = node.args[0]
            word = self.state_of(operand)
            if word:
                self.origin[node] = word
                _, idx, _ = df.scatter_args(node)
                self._rec(ctx, wave, "scatter",
                          self._written(node, name) * word,
                          self._lanes(idx))
            return
        if op_name(node) in _NOT_STATE:
            return
        # the state shadow: an op that keeps a state operand's element
        # count (a conversion, an elementwise op, a view) is state too
        n_out = _numel(out)
        if n_out:
            for i in node_inputs(node):
                w = self.state_of(i)
                if w and _numel(self.vals.get(i)) == n_out:
                    self.origin[node] = w
                    return

    def _lane_compaction(self, node) -> bool:
        """``x[keep]`` with ``keep`` a ``nonzero``'s rows (through views):
        the filter's own lane selection, JAX's ``where``, not a row read."""
        if op_name(node) != "index":
            return False
        idx = node.args[1] if len(node.args) > 1 else None
        nodes = flat_nodes(idx)
        if len(nodes) != 1:
            return False
        n = nodes[0]
        while n.op == "call_function" and op_name(n) in _LANE_VIEWS:
            n = n.args[0]
        return n.op == "call_function" and op_name(n) == "nonzero"

    def _written(self, node, name) -> int:
        """Elements a scatter writes (logical widths)."""
        args = node.args
        v = self.vals.get
        if name == "index_put":
            val = v(args[2]) if len(args) > 2 and isinstance(
                args[2], torch.fx.Node) else None
            if _numel(val) > 1:
                return _numel(val)
            idxs = [v(i) for i in flat_nodes(args[1])]
            shapes = [tuple(t.shape) for t in idxs
                      if isinstance(t, torch.Tensor)]
            op = v(args[0])
            if not shapes or not isinstance(op, torch.Tensor):
                return max(_numel(val), 1)
            lanes = torch.Size(torch.broadcast_shapes(*shapes)).numel()
            rest = torch.Size(op.shape[len(shapes):]).numel()
            return int(lanes * rest)
        if name in ("index_copy", "index_add"):
            return _numel(v(args[3])) if len(args) > 3 else 0
        # scatter / scatter_add / scatter_reduce: one element an index
        return _numel(v(args[2])) if len(args) > 2 else 0

    def footprint(self) -> tuple[int, int, int]:
        """(footprint, input, donated) bytes: the distinct input storages,
        plus each output root that is no input (a fresh allocation); the
        donated bytes are the input storages an output writes in place."""
        trace = self.trace
        phs = [n for n in trace.graph.nodes if n.op == "placeholder"]
        store = dict(zip(phs, trace.arg_storages))
        inputs: dict = {}
        for ptr, nb in trace.arg_storages:
            inputs[ptr] = max(inputs.get(ptr, 0), nb)
        in_b = sum(inputs.values())
        last = list(trace.graph.nodes)[-1]
        outs = flat_nodes(last.args[0]) if last.op == "output" else []
        fresh: dict = {}
        reused: dict = {}
        for o in outs:
            r = self.root(o)
            if r in store:
                ptr, nb = store[r]
                reused[ptr] = nb
            else:
                fresh[r] = _nbytes(self.vals.get(r))
        return in_b + sum(fresh.values()), in_b, sum(reused.values())


# ----------------------------------------------------------- derivation


def derive(trace: TargetTrace, *, steps: float = 1.0,
           geom: dict | None = None) -> CostModel:
    """Walk one traced target into a CostModel (use `model_for` for the
    registered, memoized path)."""
    geom = dict(geom or {})
    if trace.graph is None:
        return CostModel(trace.name, steps, geom, [], 0, 0, 0,
                         error=f"trace failed: {trace.trace_error!r}")
    walker = _Walker(trace)
    accesses = walker.run()
    fp, in_b, don_b = walker.footprint()
    return CostModel(trace.name, max(steps, 1e-9), geom, accesses, fp, in_b,
                     don_b, unpriced_waves=sorted(
                         walker.seen_waves & COLLECTIVE_WAVES))


def model_for(name: str, trace: TargetTrace | None = None) -> CostModel:
    """The memoized cost model of a registered target (per-trace cache,
    like dataflow.analyze: the matrix derives once per process)."""
    from . import targets as T
    if trace is None:
        trace = T.get_trace(name)
    cached = getattr(trace, "_cost_model", None)
    if cached is not None:
        return cached
    meta = T.TARGET_COST.get(name, {})
    model = derive(trace, steps=meta.get("steps", 1.0),
                   geom=meta.get("geom", {}))
    trace._cost_model = model
    return model


# ------------------------------------------------------- reconciliation


@dataclasses.dataclass
class WaveCheck:
    """One wave's derived-vs-declared comparison (after fused-group
    folding and wave_expect adjustment)."""
    wave: str                   # the formula-bearing wave name
    members: tuple[str, ...]    # observed waves folded into it
    derived: float              # bytes/step
    declared: float             # expectation at the target's geometry
    tol: float
    expect: object = None       # applied wave_expect override, if any

    @property
    def ratio(self) -> float:
        return self.derived / self.declared if self.declared else 0.0

    @property
    def ok(self) -> bool:
        return abs(self.ratio - 1.0) <= self.tol


def _apply_expect(declared: float, expect, geom: dict) -> float:
    """A wave_expect value adjusts the registry formula for ONE target's
    documented layout deviation: a number scales it, a string REPLACES it
    with a geometry formula evaluated at the target's geom."""
    if expect is None:
        return declared
    if isinstance(expect, (int, float)):
        return declared * float(expect)
    scope = {k: v for k, v in geom.items() if v is not None}
    try:
        return float(eval(str(expect), {"__builtins__": {}}, scope))  # noqa: S307
    except Exception:               # noqa: BLE001 — bad override = no change
        return declared


def reconcile(model: CostModel,
              wave_expect: dict[str, object] | None = None,
              tol_overrides: dict[str, float] | None = None,
              default_tol: float = DEFAULT_TOL) -> list[WaveCheck]:
    """Compare the derived per-wave bytes against every declared waves.py
    formula the target exercises. Fused megakernel waves absorb their
    swallowed constituents first (attrib.WAVE_ALIASES, the folding
    dintscope uses), and `wave_expect` carries the target's documented
    layout deviations. Waves whose formula prices collectives
    (`COLLECTIVE_WAVES`) are not reconciled: the trace cannot see them."""
    tols = tol_overrides or {}
    expects = wave_expect or {}
    per_wave = model.wave_bytes_per_step()
    observed = {w for w in per_wave
                if w != "(unattributed)" and w not in COLLECTIVE_WAVES}
    groups: dict[str, set[str]] = {}
    consumed: set[str] = set()
    for w in observed:
        if w in WAVE_ALIASES and WAVE_ALIASES[w] in observed:
            succ = WAVE_ALIASES[w]
            groups.setdefault(succ, {succ}).add(w)
            consumed.add(w)
    checks: list[WaveCheck] = []
    for w in sorted(observed):
        if w in consumed:
            continue
        members = tuple(sorted(groups.get(w, {w})))
        declared = waves.wave_bytes(w, **model.geom)
        if declared is None:
            continue                    # compute-only / unmodeled wave
        exp = expects.get(w)
        adj = _apply_expect(float(declared), exp, model.geom)
        derived = sum(per_wave.get(m, 0.0) for m in members)
        checks.append(WaveCheck(
            wave=w, members=members, derived=derived, declared=adj,
            tol=tols.get(w, default_tol), expect=exp))
    return checks


def reconcile_for(name: str, model: CostModel | None = None
                  ) -> list[WaveCheck]:
    """reconcile() with the target's registered cost meta applied."""
    from . import targets as T
    if model is None:
        model = model_for(name)
    meta = T.TARGET_COST.get(name, {})
    return reconcile(model,
                     wave_expect=meta.get("wave_expect"),
                     tol_overrides=meta.get("tol"))


# ------------------------------------------------------------- budgets


def eval_budget_bytes(formula, geom: dict, ledger: float) -> float | None:
    """Evaluate a bytes-budget geometry formula. Variables: the target's
    geom (w, k, l, vw, d, ...) plus `ledger` = the summed waves.py
    formulas of every formula-backed wave the derivation observed, so
    "1.25*ledger" means "at most 25% above what the declared ledger says
    these waves should move"."""
    if formula is None:
        return None
    if isinstance(formula, (int, float)):
        return float(formula)
    scope = {k: v for k, v in geom.items() if v is not None}
    scope["ledger"] = ledger
    try:
        return float(eval(formula, {"__builtins__": {}}, scope))  # noqa: S307
    except Exception:               # noqa: BLE001 — bad formula = no budget
        return None


def ledger_bytes(model: CostModel,
                 wave_expect: dict[str, object] | None = None) -> float:
    """The declared-ledger total for the waves this model observed (after
    wave_expect adjustment): the budget formulas' `ledger` variable."""
    return float(sum(c.declared
                     for c in reconcile(model, wave_expect=wave_expect)))


def fused_twin(name: str) -> str | None:
    """The unfused registry twin of an @fused target (dominance check)."""
    if "@fused" not in name:
        return None
    for a, b in (("@fused+hot", "@hot"), ("@fused+mon", "@mon"),
                 ("@fused", "")):
        if a in name:
            return name.replace(a, b)
    return None


def iter_models(names: Iterable[str]) -> Iterable[CostModel]:
    for n in names:
        yield model_for(n)
