"""dintlint core: fx tracing, walking, and the pass/finding machinery.

The engines' correctness rests on invariants stated in docstrings (one
writer per row, expiring stamps, clones for mirrors, u32 words widened
before unsigned arithmetic, a step that never waits on the host) that no
test exercises deterministically: a refactor that breaks one fails only
now and then, at run time, on the card. dintlint checks them statically
on the CPU: every registered step function (analysis/targets.py) is
traced to a ``torch.fx`` graph with
``torch.fx.experimental.proxy_tensor.make_fx(fn, tracing_mode="real")``
and walked by a registry of passes (analysis/passes), each encoding one
invariant as a node-level predicate. Findings carry severity and
provenance (op, source line, enclosing wave scopes) and feed the CLI
(``python -m dint_tpu_torch.dintlint``) and the tests.

Design notes:

* A *target* is a thunk that builds a step function and its arguments at
  a small geometry on real tensors; the carry's tensors are the graph's
  inputs, so the persistent state is the placeholders the passes seed.
  A block traces as several steps, unrolled: the trace of a Python loop
  is straight-line code.
* The nine kernels are ``torch.ops.dint`` operators (ops/library.py), so
  a trace holds one node per kernel call on either device, with the
  arguments it writes declared by its schema; nothing of the kernel's
  plain version shows (the counterpart of a ``pallas_call`` eqn).
* make_fx records no source lines here (``record_stack_traces`` leaves
  ``node.meta["stack_trace"]`` empty on this torch), so the trace runs
  under `_Provenance`, a dispatch mode above the tracer's that stamps
  every node it sees created with the innermost frame of the package
  (``node.meta["dint_site"]``; its two callers follow in
  ``node.meta["dint_stack"]``) and the storages of each kernel call's
  arguments. It also records ``aten._local_scalar_dense`` (``.item()``,
  ``int(t)``, ``bool(t)``) as a node and returns the value, where the
  tracer alone would raise: a host read is a purity finding, not a trace
  failure. A draw from a ``torch.Generator`` runs untraced and enters the
  graph as a constant (not every torch's tracer takes a generator as a
  node's argument).
* The wave scopes of monitor/waves.py are on while a target traces
  (`waves.forced`); their ``record_function`` enter and exit nodes give
  each node its path, the counterpart of the enclosing-jaxpr path.
* Tracing failures are findings, not crashes (``TargetTrace.trace_error``).
* Graphs are not functionalized: in-place writes stay in place, and
  analysis/dataflow.py follows them on alias roots.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Callable, Iterator

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

from ..monitor import waves
from ..ops import library

SEV_ERROR = "error"
SEV_WARNING = "warning"
SEV_INFO = "info"
_SEV_ORDER = {SEV_ERROR: 0, SEV_WARNING: 1, SEV_INFO: 2}


@dataclasses.dataclass
class Finding:
    """One structured lint finding (the CLI's unit of report)."""
    pass_name: str      # registered pass (e.g. "scatter_race")
    code: str           # stable slug within the pass (e.g. "nonunique-set")
    severity: str       # SEV_ERROR | SEV_WARNING | SEV_INFO
    target: str         # registered target name (e.g. "tatp_dense/block")
    message: str        # human sentence: invariant + why it is at risk
    primitive: str = "" # offending node's op ("" = whole-target)
    site: str = ""      # user-code provenance "file.py:line" (best effort)
    path: str = ""      # enclosing wave scopes (e.g. "dint.tatp_dense.lock")
    suggestion: str = ""  # suggested fix
    allowed_by: str = ""  # reason string of the allowlist entry, if matched
    count: int = 1        # identical findings merged (same site, many nodes)

    @property
    def suppressed(self) -> bool:
        return bool(self.allowed_by)

    def sort_key(self):
        return (_SEV_ORDER.get(self.severity, 3), self.target,
                self.pass_name, self.code, self.site)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["suppressed"] = self.suppressed
        return d

    def __str__(self):
        where = f" [{self.site}]" if self.site else ""
        if self.count > 1:
            where += f" x{self.count}"
        prim = f" ({self.primitive})" if self.primitive else ""
        sup = f"  -- allowed: {self.allowed_by}" if self.suppressed else ""
        fix = f"\n      fix: {self.suggestion}" if self.suggestion else ""
        return (f"{self.severity.upper():7s} {self.target} "
                f"{self.pass_name}/{self.code}{prim}{where}: "
                f"{self.message}{sup}{fix}")


# --------------------------------------------------------------- tracing


@dataclasses.dataclass
class TargetTrace:
    """A traced target: the graph (or the trace failure) and what the
    passes key on: the protocol flags (passes/protocol.py), which inputs
    are persistent state and what each input is (``inputs``: one
    (path, is_state) per placeholder, in order), the storage of each state
    input (``storages``), the pairs (output, input) of carry positions a
    block hands from one call to the next (``carry``), the storage and
    its bytes of every input (``arg_storages``: (ptr, nbytes) per
    placeholder, the cost model's footprint), and the device it was
    traced on."""
    name: str
    gm: torch.fx.GraphModule | None
    trace_error: BaseException | None = None
    inputs: tuple = ()
    storages: tuple = ()
    carry: tuple = ()
    arg_storages: tuple = ()
    protocol: tuple[str, ...] = ("certified",)
    device: str = "cpu"

    @property
    def graph(self) -> torch.fx.Graph | None:
        return None if self.gm is None else self.gm.graph


_PKG = os.sep + "dint_tpu_torch" + os.sep
# frames that are the kernels', the collectives' and the scopes'
# plumbing, not the step's code: a kernel or collective node's site is
# its caller's line
_PLUMBING = tuple(os.sep + p for p in (
    "dint_tpu_torch/ops/library.py", "dint_tpu_torch/ops/row_kernels.py",
    "dint_tpu_torch/ops/scan_kernels.py", "dint_tpu_torch/monitor/waves.py",
    "dint_tpu_torch/ops/mesh_ops.py", "dint_tpu_torch/parallel/mesh.py",
    "dint_tpu_torch/analysis/"))


def _frame_sites(depth: int = 3) -> tuple[str, ...]:
    """The innermost ``depth`` frames of the package (or of a test)
    outside the kernels' and the analysis's plumbing, innermost first, as
    'dir/file.py:line'."""
    out = []
    f = sys._getframe(2)
    while f is not None and len(out) < depth:
        fname = f.f_code.co_filename
        if not any(p in fname for p in _PLUMBING):
            for marker in (_PKG, os.sep + "tests" + os.sep):
                if marker in fname:
                    rel = fname[fname.index(marker) + 1:]
                    out.append(f"{rel.replace(os.sep, '/')}:{f.f_lineno}")
                    break
        f = f.f_back
    return tuple(out)


_ITEM = torch.ops.aten._local_scalar_dense.default


def _storage(x) -> int:
    try:
        return x.untyped_storage().data_ptr()
    except Exception:               # noqa: BLE001 — not a plain tensor
        return 0


def _storage_bytes(x) -> int:
    try:
        return int(x.untyped_storage().nbytes())
    except Exception:               # noqa: BLE001 — not a plain tensor
        return 0


class _Provenance(TorchDispatchMode):
    """Stamps provenance on the nodes the tracer below creates (see the
    module docstring)."""

    def __init__(self, tracer):
        super().__init__()
        self.tracer = tracer

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.fx.experimental.proxy_tensor import get_proxy_slot
        kwargs = kwargs or {}
        graph = self.tracer.graph
        last = graph._root.prev
        if func is _ITEM:
            proxy = get_proxy_slot(args[0], self.tracer).proxy
            self.tracer.create_proxy("call_function", func, (proxy,), {})
            with _disable_current_modes():
                out = func(*args, **kwargs)
        elif any(isinstance(a, torch.Generator)
                 for a in (*args, *kwargs.values())):
            # a draw from a seeded generator: run it untraced, so that its
            # result enters the graph as a constant (the block's draws)
            with _disable_current_modes():
                return func(*args, **kwargs)
        else:
            out = func(*args, **kwargs)
        stack = _frame_sites()
        node = last.next
        while node is not graph._root:
            node.meta.setdefault("dint_site", stack[0] if stack else "")
            node.meta.setdefault("dint_stack", stack)
            if library.is_dint(node.target):
                node.meta["dint_storages"] = [
                    [_storage(t) for t in a] if isinstance(a, (list, tuple))
                    else (_storage(a) if isinstance(a, torch.Tensor) else None)
                    for a in args]
            node = node.next
        return out


def trace_target(name: str, fn: Callable, args, *, inputs=(), carry=(),
                 protocol: tuple[str, ...] = ("certified",)) -> TargetTrace:
    """Trace ``fn(*args)`` (``args``: tensors, the graph's inputs) with
    make_fx on real tensors, under `_Provenance` and with the wave scopes
    on. ``inputs``: (path, is_state) per argument (default: every argument
    is state). A trace failure is captured as ``trace_error`` for the
    purity pass instead of raised."""
    from torch.fx.experimental.proxy_tensor import get_proxy_mode, make_fx
    args = list(args)
    if not inputs:
        inputs = tuple((f"arg{i}", True) for i in range(len(args)))
    storages = tuple(_storage(a) if st else 0
                     for a, (_, st) in zip(args, inputs))
    arg_storages = tuple((_storage(a), _storage_bytes(a)) for a in args)
    device = str(args[0].device.type) if args else "cpu"

    def traced(*a):
        with _Provenance(get_proxy_mode().tracer), waves.forced():
            return fn(*a)

    kw = dict(inputs=tuple(inputs), storages=storages, carry=tuple(carry),
              protocol=tuple(protocol), device=device,
              arg_storages=arg_storages)
    # the tracer makes each node's metadata under the tracing context's
    # fake mode, else under a new FakeTensorMode a node (whose
    # construction walks the Python stack): one mode for the whole trace
    from torch._guards import TracingContext, tracing
    from torch._subclasses.fake_tensor import FakeTensorMode
    try:
        with tracing(TracingContext(FakeTensorMode(
                allow_fallback_kernels=True))):
            gm = make_fx(traced, tracing_mode="real")(*args)
    except Exception as e:          # noqa: BLE001 — any trace failure is data
        return TargetTrace(name, None, trace_error=e, **kw)
    return TargetTrace(name, gm, **kw)


class TraceCache:
    """Trace-once cache: every pass of every `analysis.run()` call in a
    process shares ONE graph per target. Records per-target build seconds
    so the CLI's ``--time`` report can show where the wall time went."""

    def __init__(self):
        self._traces: dict[str, TargetTrace] = {}
        self.seconds: dict[str, float] = {}   # trace-build time (misses)
        self.hits = 0
        self.misses = 0

    def __contains__(self, name: str) -> bool:
        return name in self._traces

    def get(self, name: str, builder: Callable[[], TargetTrace]
            ) -> TargetTrace:
        hit = self._traces.get(name)
        if hit is not None:
            self.hits += 1
            return hit
        self.misses += 1
        t0 = time.perf_counter()
        trace = builder()
        self.seconds[name] = time.perf_counter() - t0
        self._traces[name] = trace
        return trace

    def clear(self):
        self._traces.clear()
        self.seconds.clear()
        self.hits = self.misses = 0


# --------------------------------------------------------------- walking


def op_name(node) -> str:
    """A node's op: ``index_put_`` for aten, ``dint::lock_arbitrate`` for
    the kernels, ``profiler::...`` for the scopes; '' for non-calls."""
    if node.op != "call_function":
        return ""
    schema = getattr(node.target, "_schema", None)
    if schema is None:
        return getattr(node.target, "__name__", str(node.target))
    name = schema.name
    return name[len("aten::"):] if name.startswith("aten::") else name


_ENTER = "profiler::_record_function_enter_new"
_EXIT = "profiler::_record_function_exit"


@dataclasses.dataclass
class NodeCtx:
    """One call node in context: its position in the graph's node order,
    the enclosing wave scopes, and whether it is a kernel (a ``dint::``
    op, whose body the trace does not see)."""
    node: torch.fx.Node
    index: int
    path: tuple[str, ...] = ()
    in_kernel: bool = False

    @property
    def prim(self) -> str:
        return op_name(self.node)


def walk(trace: TargetTrace) -> Iterator[NodeCtx]:
    """Every ``call_function`` node in order, with its wave path. The
    scopes' own enter/exit nodes are consumed, not yielded."""
    if trace.graph is None:
        return
    stack: list = []
    for i, node in enumerate(trace.graph.nodes):
        if node.op != "call_function":
            continue
        name = op_name(node)
        if name == _ENTER:
            stack.append((node, str(node.args[0])))
            continue
        if name == _EXIT:
            enter = node.args[0] if node.args else None
            for j in range(len(stack) - 1, -1, -1):
                if stack[j][0] is enter:
                    del stack[j:]
                    break
            continue
        yield NodeCtx(node, i, tuple(s for _, s in stack),
                      library.is_dint(node.target))


def site_of(node) -> str:
    """The user-code 'file.py:line' the node was traced at ('' when the
    trace recorded none)."""
    return node.meta.get("dint_site", "") if node is not None else ""


def flat_nodes(arg) -> list:
    """The fx nodes in an argument, in order (lists, tuples and dicts
    flattened)."""
    if isinstance(arg, torch.fx.Node):
        return [arg]
    out = []
    if isinstance(arg, (list, tuple)):
        for a in arg:
            out += flat_nodes(a)
    elif isinstance(arg, dict):
        for a in arg.values():
            out += flat_nodes(a)
    return out


def node_inputs(node) -> list:
    """Every fx node a node reads, positional and keyword (memoized)."""
    ins = node.meta.get("dint_inputs")
    if ins is None:
        ins = node.meta["dint_inputs"] = flat_nodes(
            list(node.args) + list(node.kwargs.values()))
    return ins


def _chains(graph, stop: frozenset) -> dict:
    """node -> the op names of its backward def slice, cut at ``stop``,
    for every node of ``graph`` (computed once per graph and cut set)."""
    memo = graph.__dict__.setdefault("_dint_chains", {})
    got = memo.get(stop)
    if got is None:
        got = memo[stop] = {}
        for n in graph.nodes:
            if n.op != "call_function":
                got[n] = frozenset()
                continue
            name = op_name(n)
            acc = {name}
            if name not in stop:
                for i in node_inputs(n):
                    acc |= got.get(i, frozenset())
            got[n] = frozenset(acc)
    return got


def def_chain_prims(arg, stop: frozenset[str] = frozenset()) -> set[str]:
    """Op names in the backward def slice of ``arg`` (a node, or an
    argument holding nodes). Placeholders contribute nothing.

    ``stop`` names ops whose INPUTS are not traversed (the node itself is
    still recorded): passes cut the slice at range-limiting ops — a value
    that went through ``bitwise_and`` with a mask or ``remainder`` no
    longer carries its producers' magnitude.

    This is the provenance oracle of the scatter-race pass (indices whose
    slice holds a ``sort``, ``argsort`` or ``unique`` come from the segment
    machinery, ops/segments.py) and of the u32 pass's drift rules."""
    nodes = flat_nodes(arg)
    if not nodes:
        return set()
    chains = _chains(nodes[0].graph, frozenset(stop))
    out: set[str] = set()
    for n in nodes:
        out |= chains.get(n, frozenset())
    return out


def used_after(node, after) -> str:
    """If ``node`` is read by a node after ``after`` in the graph's order
    (or escapes as an output), describe the first such use; else ''."""
    order = {n: i for i, n in enumerate(node.graph.nodes)}
    limit = order[after]
    users = sorted((u for u in node.users if order[u] > limit),
                   key=order.__getitem__)
    for u in users:
        if u.op == "output":
            return "escapes as a graph output"
        return f"read by `{op_name(u)}` at {site_of(u)}"
    return ""


# ------------------------------------------------------- logical widths
#
# JAX's installs and log appends are full-width scatters with
# ``mode="drop"``: a masked lane rides an out-of-range index, so a jaxpr
# prices all w lanes whatever the draws. The port keeps the masked-in
# lanes with a ``nonzero`` filter first, so in a real-tensor trace the
# width of every op behind the filter is the number of lanes the draws
# kept. `logical_vals` re-derives those shapes as if every lane were
# kept: a ``nonzero`` of a mask of n elements gives n rows, and each op
# downstream of one is re-run on meta tensors. Widths so derived do not
# depend on the draws. (No target indexes by a boolean mask, a host sync
# the purity pass reports.)

_DATA_DEP = frozenset({"nonzero"})


def _shape_of(v):
    if isinstance(v, torch.Tensor):
        return tuple(v.shape)
    if isinstance(v, (list, tuple)):
        return tuple(_shape_of(x) for x in v)
    return None


def _to_meta(v):
    if isinstance(v, torch.Tensor):
        if v.device.type == "meta":
            return v
        return torch.empty_strided(tuple(v.shape), tuple(v.stride()),
                                   dtype=v.dtype, device="meta")
    if isinstance(v, (list, tuple)):
        return type(v)(_to_meta(x) for x in v)
    return v


_RESHAPES = frozenset({"view", "_unsafe_view", "reshape"})


def _rescaled_view(name, args, kwargs, target):
    """A reshape whose size list the trace fixed from the kept lanes
    (``view(x, [6])`` for one kept lane of six words), re-run with its
    lane dimension scaled to the input's logical numel; None if it does
    not divide."""
    if name not in _RESHAPES or len(args) < 2 or kwargs \
            or not isinstance(args[0], torch.Tensor):
        return None
    shape = [int(d) for d in args[1]]
    if not shape or -1 in shape:
        return None
    n = int(args[0].numel())
    lane = next((i for i, d in enumerate(shape) if d == 0), 0)
    rest = 1
    for i, d in enumerate(shape):
        if i != lane:
            rest *= d
    if rest <= 0 or n % rest:
        return None
    shape[lane] = n // rest
    try:
        return target(args[0], shape)
    except Exception:               # noqa: BLE001
        return None


def logical_vals(trace: TargetTrace) -> dict:
    """node -> its value as if every masked-in filter kept all its lanes
    (the recorded ``meta["val"]`` where nothing upstream is such a
    filter). Memoized per trace."""
    cached = getattr(trace, "_logical_vals", None)
    if cached is not None:
        return cached
    vals: dict = {}
    differs: set = set()
    if trace.graph is not None:
        for node in trace.graph.nodes:
            rec = node.meta.get("val")
            if node.op == "get_attr":
                rec = getattr(trace.gm, str(node.target), rec)
            vals[node] = rec
            if node.op != "call_function":
                continue
            name = op_name(node)
            ins = node_inputs(node)
            if node.meta.get("dint_widened"):
                # a mutant's widened output (analysis/mutate.py): its
                # readers are re-derived from the recorded widened val
                differs.add(node)
                continue
            if name in _DATA_DEP:
                m = vals.get(node.args[0])
                if isinstance(m, torch.Tensor):
                    vals[node] = torch.empty((m.numel(), m.dim()),
                                             dtype=torch.int64,
                                             device="meta")
                    differs.add(node)
                continue
            if not any(i in differs for i in ins):
                continue
            args = torch.fx.node.map_arg(
                node.args, lambda n: _to_meta(vals.get(n)))
            kwargs = torch.fx.node.map_arg(
                node.kwargs, lambda n: _to_meta(vals.get(n)))
            try:
                got = node.target(*args, **kwargs)
            except Exception:       # noqa: BLE001 — a shape fixed at trace
                got = _rescaled_view(name, args, kwargs, node.target)
                if got is None:     # keep the recorded val
                    continue
            vals[node] = got
            if _shape_of(got) != _shape_of(rec):
                differs.add(node)
    trace._logical_vals = vals
    return vals


def _filter_masks(graph) -> dict:
    """node -> the boolean mask of the ``nonzero`` its value descends from
    (the one reached first through its inputs), for every node of
    ``graph`` (computed once per graph)."""
    got = graph.__dict__.get("_dint_filter_masks")
    if got is None:
        got = graph.__dict__["_dint_filter_masks"] = {}
        for n in graph.nodes:
            if n.op != "call_function":
                continue
            if op_name(n) in _DATA_DEP:
                got[n] = n.args[0]
                continue
            for i in node_inputs(n):
                if got.get(i) is not None:
                    got[n] = got[i]
                    break
    return got


def filter_mask(arg) -> torch.fx.Node | None:
    """The boolean mask whose ``nonzero`` an argument descends from, or
    None: the filter that replaced JAX's ``mode="drop"`` for it."""
    nodes = flat_nodes(arg)
    if not nodes:
        return None
    masks = _filter_masks(nodes[0].graph)
    for n in nodes:
        if masks.get(n) is not None:
            return masks[n]
    return None


# ------------------------------------------------------------ SARIF export

# Minimal SARIF 2.1.0: one run, one rule per pass/code pair, one result
# per finding; allowlisted findings ride along as suppressions so SARIF
# viewers grey them out instead of dropping them.
_SARIF_LEVEL = {SEV_ERROR: "error", SEV_WARNING: "warning", SEV_INFO: "note"}


def to_sarif(findings: list[Finding], tool_name: str) -> dict:
    """Serialize findings as a SARIF 2.1.0 log (the CLI's --sarif)."""
    rules: dict[str, dict] = {}
    results = []
    for f in findings:
        rule_id = f"{f.pass_name}/{f.code}"
        rules.setdefault(rule_id, {
            "id": rule_id,
            "shortDescription": {"text": PASS_DOCS.get(f.pass_name,
                                                       f.pass_name)},
        })
        result = {
            "ruleId": rule_id,
            "level": _SARIF_LEVEL.get(f.severity, "none"),
            "message": {"text": f.message + (
                f"\nfix: {f.suggestion}" if f.suggestion else "")},
            "properties": {"target": f.target, "primitive": f.primitive,
                           "path": f.path, "count": f.count},
        }
        if f.site:
            uri, _, line = f.site.rpartition(":")
            region = {}
            if line.isdigit():
                region["startLine"] = int(line)
            else:
                uri = f.site
            loc = {"physicalLocation": {
                "artifactLocation": {"uri": uri or f.site}}}
            if region:
                loc["physicalLocation"]["region"] = region
            result["locations"] = [loc]
        if f.suppressed:
            result["suppressions"] = [{"kind": "external",
                                       "justification": f.allowed_by}]
        results.append(result)
    return {
        "$schema": ("https://raw.githubusercontent.com/oasis-tcs/"
                    "sarif-spec/master/Schemata/sarif-schema-2.1.0.json"),
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {"name": tool_name,
                                "rules": sorted(rules.values(),
                                                key=lambda r: r["id"])}},
            "results": results,
        }],
    }


# ---------------------------------------------------------- pass registry

PASSES: dict[str, Callable[[TargetTrace], list[Finding]]] = {}
PASS_DOCS: dict[str, str] = {}


def register_pass(name: str):
    """Register ``fn(trace: TargetTrace) -> list[Finding]`` under ``name``."""
    def deco(fn):
        PASSES[name] = fn
        PASS_DOCS[name] = (fn.__doc__ or "").strip().splitlines()[0]
        return fn
    return deco
