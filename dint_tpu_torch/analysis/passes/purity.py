"""Hot-path purity pass: a step must be one device program.

The throughput model prices a step as device work the host enqueues and
never waits on. The port's counterpart of the reference's "one pure
device program" is the host sync: an op whose result size or value the
host must read before it can enqueue the next one. Each is a stall of the
stream a step and a blocker of CUDA-graph capture.

  * trace-time: a target that cannot be traced at all -> ERROR
    ``untraceable`` with the original exception text.
  * host syncs -> WARNING, one per node, with its site:
      ``_local_scalar_dense``  ``.item()``, ``int(t)`` or ``bool(t)`` on a
                               tensor (recorded by the trace's
                               provenance mode, which returns the value);
      ``nonzero``              a data-dependent output size;
      ``masked_select``        likewise;
      ``index-bool-mask``      ``x[mask]``: a boolean-mask index;
      ``unique``               ``unique*`` (a data-dependent size);
      ``copy-to-cpu``          a copy from the card to the host.
  * ``host-scalar`` (INFO): an int argument of a ``dint::`` kernel call
    that changes from step to step at one site — the host step counter
    passed by value (``db.step`` into ``lock_arbitrate`` and
    ``lock_validate``). A captured CUDA graph would replay the first
    step's value; this is the blocker named in ROADMAP §B.2.

These findings list what stands between each step and graph capture; the
CLI's ``--json`` gathers them per target (``host_syncs``).
"""
from __future__ import annotations

import torch

from .. import dataflow as df
from ..core import (Finding, SEV_ERROR, SEV_INFO, SEV_WARNING, TargetTrace,
                    flat_nodes, register_pass, site_of, walk)

_SYNCS = {"_local_scalar_dense": "a host read of a device value",
          "nonzero": "a data-dependent output size",
          "masked_select": "a data-dependent output size",
          "unique": "a data-dependent output size",
          "_unique": "a data-dependent output size",
          "_unique2": "a data-dependent output size",
          "unique_dim": "a data-dependent output size",
          "unique_consecutive": "a data-dependent output size"}
HOST_SYNC_CODES = ("_local_scalar_dense", "nonzero", "masked_select",
                   "index-bool-mask", "unique", "copy-to-cpu")


def _sync_code(ctx) -> str | None:
    prim, node = ctx.prim, ctx.node
    if prim in _SYNCS:
        return "unique" if "unique" in prim else prim
    if prim == "index" and df.bool_index(node.args[1:]):
        return "index-bool-mask"
    if prim in ("_to_copy", "to", "copy_"):
        src = node.args[1] if prim == "copy_" else node.args[0]
        dst = node if prim != "copy_" else node.args[0]
        sv, dv = ([n.meta.get("val") for n in flat_nodes(src)] or [None])[0], \
            ([n.meta.get("val") for n in flat_nodes(dst)] or [None])[0]
        if sv is not None and dv is not None and \
                getattr(sv, "device", torch.device("cpu")).type == "cuda" \
                and getattr(dv, "device", None) is not None \
                and dv.device.type == "cpu":
            return "copy-to-cpu"
    return None


@register_pass("purity")
def purity(trace: TargetTrace) -> list[Finding]:
    """Detects host syncs and per-step host scalars that break the
    enqueue-only step model."""
    out: list[Finding] = []
    if trace.trace_error is not None:
        msg = f"{type(trace.trace_error).__name__}: {trace.trace_error}"
        out.append(Finding(
            "purity", "untraceable", SEV_ERROR, trace.name,
            "step function cannot be traced: it fails on the trace's "
            f"real tensors. Trace error: {msg[:500]}",
            suggestion="run the builder directly to reproduce"))
        return out
    kernel_ints: dict = {}
    for ctx in walk(trace):
        code = _sync_code(ctx)
        if code is not None:
            out.append(Finding(
                "purity", code, SEV_WARNING, trace.name,
                f"host sync `{ctx.prim}` inside the step "
                f"({_SYNCS.get(ctx.prim, 'a device-to-host transfer')}): "
                "the host waits on the device every step, and the step "
                "cannot be captured in a CUDA graph",
                primitive=ctx.prim, site=site_of(ctx.node),
                path="/".join(ctx.path),
                suggestion="keep the value on the device: fixed-size "
                           "masked lanes (torch.where) instead of a "
                           "filtered index, device scalars instead of "
                           "host reads"))
        if ctx.in_kernel:
            for pos, a in enumerate(ctx.node.args):
                if isinstance(a, int) and not isinstance(a, bool):
                    kernel_ints.setdefault(
                        (ctx.prim, site_of(ctx.node), pos),
                        (ctx, set()))[1].add(a)
    for (prim, site, pos), (ctx, vals) in kernel_ints.items():
        if len(vals) > 1:
            arg = ctx.node.target._schema.arguments[pos].name
            out.append(Finding(
                "purity", "host-scalar", SEV_INFO, trace.name,
                f"int argument `{arg}` of `{prim}` changes from step to "
                f"step at this site ({len(vals)} values traced): a "
                "captured CUDA graph would replay one value",
                primitive=prim, site=site, path="/".join(ctx.path),
                suggestion="pass the value in a device scalar the step "
                           "updates in place"))
    return out
