"""Aliasing pass: in-place writes must not reach a buffer twice or be
read around.

The port updates tables in place: the ``dint::`` kernels write the
arguments their schemas mark ``(a!)`` (B2/B4's arb, B3's tables, B7's
tables and mirrors), and the plain paths use in-place aten ops. Those are
the reference's ``input_output_aliases`` and donated buffers, and the
hazards carry over:

  * ``shared-state-storage`` (ERROR): two persistent state tensors of a
    target share a storage. Mirrors and backups are clones, never views
    (ROADMAP §C): a view would make a write-through write one storage
    twice, and a backup that is a view of its primary is no backup.
  * a ``dint::`` call whose written argument shares a storage with
    another argument of the same call (the check that used to sit in
    ops/row_kernels.py's wrappers): ``double-alias-input`` (ERROR) when
    two written arguments share one, ``donated-operand-duplicated``
    (ERROR) when a written argument is also read through another
    argument — the kernel reads through a second name what it writes
    (B3/B7 load values through the read-only cache path, which may not
    see the launch's own stores). Judged on the storages the trace saw,
    else on alias roots.
  * ``use-after-donate`` (ERROR): a view of an array, taken before an op
    rewrote the array in place, is read after the write by something
    that is not itself a write through it: the reader holds the old
    name and sees the new contents. Reads of the array itself, or of a
    view taken after the write, are fresh reads and pass.

The reference's ``alias-shape-mismatch`` and ``double-alias-output`` have
no twin: an in-place argument is its own output.
"""
from __future__ import annotations

from .. import dataflow as df
from ..core import (Finding, SEV_ERROR, TargetTrace, flat_nodes, op_name,
                    register_pass, site_of, walk)
from ...ops import library


def _state_storage(trace: TargetTrace) -> list[Finding]:
    out = []
    seen: dict[int, str] = {}
    for (path, st), ptr in zip(trace.inputs, trace.storages):
        if not st or not ptr:
            continue
        if ptr in seen:
            out.append(Finding(
                "aliasing", "shared-state-storage", SEV_ERROR, trace.name,
                f"state tensors `{seen[ptr]}` and `{path}` share one "
                "storage: a write to either reaches both (mirrors and "
                "backups must be clones, never views)",
                suggestion="clone the mirror/backup when it is made"))
        else:
            seen[ptr] = path
    return out


def _kernel_args(ctx, flow) -> list[Finding]:
    node = ctx.node
    schema = node.target._schema
    written = set(library.mutated_args(node.target))
    stores = node.meta.get("dint_storages")
    keys = []      # (arg name, is written, key) per tensor of the call
    for pos, a in enumerate(schema.arguments):
        if pos >= len(node.args):
            break
        arg = node.args[pos]
        nodes = flat_nodes(arg)
        ptrs = None
        if stores is not None and pos < len(stores):
            p = stores[pos]
            ptrs = p if isinstance(p, list) else [p]
        for i, n in enumerate(nodes):
            if ptrs is not None and i < len(ptrs) and ptrs[i]:
                key = ("storage", ptrs[i])
            elif ptrs is not None:
                continue            # an empty tensor holds no memory
            else:
                key = ("root", flow.roots.get(n, n))
            keys.append((a.name, a.name in written, key))
    out = []
    reported = set()
    for i, (name, w, key) in enumerate(keys):
        if not w:
            continue
        for j, (name2, w2, key2) in enumerate(keys):
            if j == i or key2 != key or (w2 and j < i):
                continue
            code = "double-alias-input" if w2 else \
                "donated-operand-duplicated"
            if (code, name, name2) in reported:
                continue
            reported.add((code, name, name2))
            out.append(Finding(
                "aliasing", code, SEV_ERROR, "",
                f"`{ctx.prim}` writes `{name}` in place, and `{name2}` of "
                "the same call shares its storage: "
                + ("two in-place writers share one buffer" if w2 else
                   "the kernel reads through a second name what it "
                   "writes"),
                primitive=ctx.prim, site=site_of(node),
                path="/".join(ctx.path),
                suggestion="pass distinct arrays; copy the values first"))
    return out


def _stale_views(trace: TargetTrace, flow) -> list[Finding]:
    order = {n: i for i, n in enumerate(trace.graph.nodes)}
    targets = {n for _, _, n in flow.writes}
    out = []
    by_root: dict = {}
    for n, r in flow.roots.items():
        if n is not r and op_name(n) in df.VIEWS:
            by_root.setdefault(r, []).append(n)
    done = set()
    for w, root, arg in flow.writes:
        for v in by_root.get(root, ()):
            if v in done or v in targets or order[v] >= order[w]:
                continue
            late = [u for u in v.users
                    if order[u] > order[w] and u.op == "call_function"
                    and op_name(u) not in df.VIEWS
                    and not (df.is_inplace(u) and u.args[0] is v)]
            if not late:
                continue
            done.add(v)
            u = min(late, key=order.__getitem__)
            out.append(Finding(
                "aliasing", "use-after-donate", SEV_ERROR, trace.name,
                f"a view of an array (`{op_name(v)}` at {site_of(v)}) "
                f"taken before `{op_name(w)}` at {site_of(w)} rewrote the "
                f"array in place is read after it by `{op_name(u)}`: the "
                "reader holds the old name and sees the new contents",
                primitive=op_name(u), site=site_of(u),
                suggestion="clone the value before the write if the old "
                           "contents are meant, else take the view after "
                           "the write"))
    return out


@register_pass("aliasing")
def aliasing(trace: TargetTrace) -> list[Finding]:
    """Checks state storages, kernel arguments written in place, and stale
    views read after an in-place write."""
    out = _state_storage(trace)
    if trace.graph is None:
        return out
    flow = df.analyze(trace)
    for ctx in walk(trace):
        if ctx.in_kernel:
            for f in _kernel_args(ctx, flow):
                f.target = trace.name
                out.append(f)
    out += _stale_views(trace, flow)
    return out
