"""The partition audit: proof, on any device, that a mesh runner keeps
each partition's data to itself outside the mesh's collectives.

A mesh (`parallel.mesh.Mesh`) may put every partition on a card of its
own, where an operator that takes tensors of two partitions fails or, in
a kernel, reads another card's memory. On one device such a mix runs and
gives a result, so the tests catch it here instead: `PartitionAudit`
tags every tensor of partition p's state with p (`PartitionAudit.tag`),
follows the tags through every operator the runner dispatches (an
operator's outputs, and the arguments it writes, take the tag of its
tagged inputs) and raises `CrossPartition` where an operator takes
tensors of two partitions. Untagged tensors (the draws, the runner's
constants, the stats' sum) may meet any partition's.

The ``dint_mesh`` collectives are the exceptions, as they are on the
cards: entry p of a collective must hold partition p's tensors (or
untagged ones), output p of a ``ppermute`` or ``all_to_all`` becomes
partition p's, and a ``psum``'s sum is untagged (the home device's).
A ``dint::`` kernel is one operator: all its tensors belong to one
partition. A copy between devices takes its source's tag, unless the
audit is made with ``transfers=True``: then its output is untagged, a
message handed to the receiving card, which is how recovery rebuilds a
lost partition on its own card from a ring on another card (on one
device such a copy dispatches nothing, so that audit runs on tensors of
a fake mode's devices).

    audit = PartitionAudit()
    audit.tag_partitions(states)        # entry p of a list -> partition p
    with audit:
        carry = init(states)
        carry, stats = run.run_draws(carry, bits, payload)
    audit.ops, audit.collectives        # what it checked
"""
from __future__ import annotations

import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

from ..ops import mesh_ops
from ..parallel.mesh import leaves


_TO_COPY = torch.ops.aten._to_copy.default


class CrossPartition(RuntimeError):
    """An operator other than a collective took tensors of two
    partitions."""


def _written(func, args) -> list:
    """The tensor arguments ``func``'s schema marks as written."""
    schema = getattr(func, "_schema", None)
    if schema is None:
        return []
    out = []
    for a, v in zip(schema.arguments, args):
        if a.alias_info is not None and a.alias_info.is_write:
            out.extend(leaves(v))
    return out


class PartitionAudit(TorchDispatchMode):
    """A dispatch mode that tags, propagates and checks partitions (see the
    module docstring). ``ops`` counts the operators it checked,
    ``collectives`` the collective calls."""

    def __init__(self, transfers: bool = False):
        super().__init__()
        self.transfers = transfers
        self.tags = WeakIdKeyDictionary()
        self.ops = 0
        self.collectives = 0

    def tag(self, obj, p: int):
        """Tag every tensor of ``obj`` as partition ``p``'s."""
        for t in leaves(obj):
            self.tags[t] = p

    def tag_partitions(self, entries):
        """Tag entry p of ``entries`` (a list a partition) as p's; a
        tensor that several entries share (a runner's constant, where the
        partitions share a device) stays untagged."""
        owners = {}
        for p, e in enumerate(entries):
            for t in leaves(e):
                owners.setdefault(id(t), (t, set()))[1].add(p)
        for t, ps in owners.values():
            if len(ps) == 1:
                self.tags[t] = ps.pop()

    def part(self, t):
        """The partition of tensor ``t``, None when untagged."""
        return self.tags.get(t)

    def _collective(self, func, args, out):
        name = func.name().split("::")[-1].split(".")[0]
        xs = args[0]
        shape = args[3] if name == "ppermute" else args[2]
        size = math.prod(int(n) for n in shape)
        per = len(xs) // size
        for k, t in enumerate(xs):
            p = self.part(t)
            if p is not None and p != k // per:
                raise CrossPartition(
                    f"{func}: entry {k // per} carries partition {p}'s "
                    f"tensor")
        self.collectives += 1
        if name == "psum":
            return
        for k, t in enumerate(out):
            self.tags[t] = k // per

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        if mesh_ops.is_collective(func):
            self._collective(func, args, out)
            return out
        if self.transfers and func is _TO_COPY \
                and out.device != args[0].device:
            return out
        parts = {p for t in leaves((args, kwargs))
                 if (p := self.part(t)) is not None}
        if len(parts) > 1:
            raise CrossPartition(f"{func} takes tensors of partitions "
                                 f"{sorted(parts)}")
        if parts:
            p = parts.pop()
            for t in leaves(out) + _written(func, args):
                self.tags[t] = p
        return out
