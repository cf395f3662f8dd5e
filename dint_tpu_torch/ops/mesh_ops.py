"""The mesh's three collectives as operators of the ``dint_mesh`` namespace
in ``torch.library``.

parallel/mesh.py keeps a mesh's partitions as a Python list, one device
a partition (several partitions may share one). Its moves
(`Mesh.ppermute`, `Mesh.all_to_all`, `Mesh.psum`) call these operators
with every partition's tensors in one ``Tensor[]``
(partition-major: partition p's leaves at ``p * L ... p * L + L - 1``), so
a trace of a mesh step (``make_fx``) holds one node per collective call,
and the node carries what a JAX collective eqn carries as parameters: the
axis (or the tuple of axes), the explicit permutation of a ``ppermute``
(pairs of coordinates along the axis), and the mesh's shape and axis
names. The static analysis (dint_tpu_torch/analysis) reads them straight
off the node.

The namespace is not ``dint``: ``library.is_dint`` means one of the nine
kernels, and the passes tell a collective (`is_collective`) apart from a
kernel.

These are JAX collectives, not Pallas kernels: one implementation, plain
PyTorch, serves CPU and CUDA tensors alike, plus a fake (shapes and
devices only) for ``make_fx`` and fake tensor modes. A partition's device
is the device of its own entry (every leaf of an entry on one device, else
the call raises): a receiver's output lands there, a copy between cards
where the sender sits on another (``Tensor.to``; the copy is the link),
and ``psum`` sums on ``xs[0]``'s device, the mesh's home. So the
operators take no device argument, and a trace keeps the schemas it had
when every partition shared one device. An operator returns fresh
tensors, never an alias of its input, so a ``ppermute`` copies the
records it moves, on one card too. Arguments that do not fit the mesh
raise; nothing falls back.

A mesh across processes (`parallel.dist`, one rank a host) calls the same
operators with the same schemas, holding only its own partitions'
tensors (``Tensor[]`` has no None), inside `across`, which binds the
call to the mesh's process group and its partitions' ranks. A move
between two of the rank's partitions is a copy as above; what crosses
ranks goes by point-to-point messages, one a pair of ranks a call (every
tensor for that rank packed into one byte buffer, 16-byte aligned, and
one ``batch_isend_irecv`` for all of the call's messages). A ``psum``
sums the rank's partitions, then takes one ``all_reduce`` in their
dtype. With gloo on CUDA tensors the buffers are staged through host
memory. A receiver sizes a message from its own entry: across ranks a
``ppermute``'s entries share their shapes and dtypes (every runner's do),
and a rank whose own entries differ raises.
"""
from __future__ import annotations

import contextlib
import functools
import math
import threading

import torch
import torch.distributed as tdist

NAMESPACE = "dint_mesh"

SCHEMAS = {
    # perm: the (source, destination) pairs along ``axis``, flattened
    "ppermute": ("(Tensor[] xs, str axis, int[] perm, int[] mesh_shape, "
                 "str[] mesh_axes) -> Tensor[]"),
    # axes: one axis name, or every axis name major first (the 1-D
    # exchange over the flat index)
    "all_to_all": ("(Tensor[] xs, str[] axes, int[] mesh_shape, "
                   "str[] mesh_axes) -> Tensor[]"),
    "psum": ("(Tensor[] xs, str[] axes, int[] mesh_shape, "
             "str[] mesh_axes) -> Tensor"),
}

COLLECTIVES = frozenset(f"{NAMESPACE}::{n}" for n in SCHEMAS)


class Across:
    """What a mesh across processes binds its collective calls to: the
    rank's `parallel.dist.Group`, the rank of each flat partition
    (``rank_of``) and the partitions this rank holds (``local``, in flat
    order: a call's ``xs`` holds theirs, partition-major)."""

    def __init__(self, group, rank_of):
        self.group = group
        self.rank_of = tuple(int(r) for r in rank_of)
        self.local = tuple(p for p, r in enumerate(self.rank_of)
                           if r == group.rank)


_BOUND = threading.local()


@contextlib.contextmanager
def across(binding: Across):
    """Calls of the ``dint_mesh`` operators inside this block run across
    the ranks of ``binding`` (this thread only)."""
    stack = _BOUND.__dict__.setdefault("stack", [])
    stack.append(binding)
    try:
        yield binding
    finally:
        stack.pop()


def bound() -> Across | None:
    """The binding of the innermost `across` block, None outside one (a
    mesh in one process)."""
    stack = _BOUND.__dict__.get("stack")
    return stack[-1] if stack else None


def entry_partitions(n_tensors: int, mesh_shape) -> list:
    """The flat partition whose entry holds each of a call's
    ``n_tensors`` tensors: every partition in one process, the rank's own
    (`Across.local`) inside `across`."""
    b = bound()
    parts = b.local if b is not None else range(math.prod(
        int(n) for n in mesh_shape))
    per = n_tensors // max(len(parts), 1)
    return [parts[k // per] for k in range(n_tensors)] if per else []


def _coords(p: int, shape) -> list:
    out = []
    for n in reversed(shape):
        p, c = divmod(p, n)
        out.append(c)
    return out[::-1]


def _flat(coords, shape) -> int:
    p = 0
    for c, n in zip(coords, shape):
        p = p * n + c
    return p


def _check(xs, mesh_shape, mesh_axes):
    shape = tuple(int(n) for n in mesh_shape)
    if len(shape) != len(mesh_axes) or not shape or min(shape) < 1:
        raise ValueError(f"mesh shape {shape} and axes {tuple(mesh_axes)} "
                         "do not match")
    size = math.prod(shape)
    b = bound()
    entries = size if b is None else len(b.local)
    if not xs or len(xs) % entries:
        raise ValueError(f"{len(xs)} tensors for {entries} partitions")
    leaves = len(xs) // entries
    for p in range(entries):
        own = xs[p * leaves:(p + 1) * leaves]
        if any(x.device != own[0].device for x in own):
            raise ValueError(f"partition {p}'s tensors are on different "
                             f"devices: {[str(x.device) for x in own]}")
    return shape, size


def perm_pairs(perm) -> list:
    """The flat ``int[] perm`` argument as (source, destination) pairs."""
    perm = [int(v) for v in perm]
    if len(perm) % 2:
        raise ValueError(f"perm {perm} is not a list of pairs")
    return list(zip(perm[0::2], perm[1::2]))


def ppermute_sources(axis: str, perm, mesh_shape, mesh_axes) -> list:
    """For each flat partition, the flat partition it receives from along
    ``axis`` (-1: none, it receives zeros), as ``jax.lax.ppermute``: the
    pairs name coordinates along the axis; the other coordinates stay."""
    shape = tuple(int(n) for n in mesh_shape)
    axes = tuple(mesh_axes)
    if axis not in axes:
        raise ValueError(f"axis {axis!r} is not one of the mesh's {axes}")
    i = axes.index(axis)
    n = shape[i]
    pairs = perm_pairs(perm)
    srcs = [s for s, _ in pairs]
    dsts = [d for _, d in pairs]
    if any(not 0 <= v < n for v in srcs + dsts) \
            or len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        raise ValueError(f"perm {pairs} is not a partial permutation of "
                         f"axis {axis!r} of size {n}")
    frm = dict((d, s) for s, d in pairs)
    out = []
    for p in range(math.prod(shape)):
        c = _coords(p, shape)
        if c[i] in frm:
            c[i] = frm[c[i]]
            out.append(_flat(c, shape))
        else:
            out.append(-1)
    return out


def _moved(x: torch.Tensor, dev) -> torch.Tensor:
    """A fresh copy of ``x`` on ``dev``: a clone on its own device, else
    a copy between devices."""
    if x.device == dev:
        return x.clone()
    return x.to(dev, non_blocking=True)


def _ppermute(xs, axis, perm, mesh_shape, mesh_axes, make):
    """``make(sender's leaf, receiver's device)`` for every receiving
    partition's leaves, zeros on its own device for the others."""
    shape, size = _check(xs, mesh_shape, mesh_axes)
    if bound() is not None:
        return _ppermute_across(bound(), xs, axis, perm, shape, mesh_axes,
                                make)
    leaves = len(xs) // size
    srcs = ppermute_sources(axis, perm, mesh_shape, mesh_axes)
    out = []
    for p, s in enumerate(srcs):
        dev = xs[p * leaves].device
        for leaf in range(leaves):
            if s < 0:
                out.append(torch.zeros_like(xs[p * leaves + leaf]))
            else:
                out.append(make(xs[s * leaves + leaf], dev))
    return out


def _exchange_axis(axes, mesh_shape, mesh_axes):
    """(the grid the exchange indexes, the axis position in it): the mesh's
    shape and the axis for one name; the flat index for every name."""
    axes = tuple(axes)
    shape = tuple(int(n) for n in mesh_shape)
    if len(axes) == 1 and axes[0] in tuple(mesh_axes):
        return shape, tuple(mesh_axes).index(axes[0])
    if axes == tuple(mesh_axes):
        return (math.prod(shape),), 0
    raise ValueError(f"axes {axes} are neither one axis nor every axis of "
                     f"the mesh's {tuple(mesh_axes)} in order")


def _a2a_check(xs, axes, mesh_shape, mesh_axes):
    shape, size = _check(xs, mesh_shape, mesh_axes)
    b = bound()
    if len(xs) != (size if b is None else len(b.local)):
        raise ValueError(f"{len(xs)} tensors for {size} partitions")
    grid, i = _exchange_axis(axes, mesh_shape, mesh_axes)
    rows = xs[0].shape[0] if xs[0].dim() else 0
    if any(tuple(x.shape) != tuple(xs[0].shape) for x in xs) \
            or xs[0].dim() == 0 or rows % grid[i]:
        raise ValueError(f"all_to_all needs one shape on every partition "
                         f"with rows splitting into {grid[i]} buckets")
    return grid, i, size


@functools.lru_cache(maxsize=None)
def _exchange_plan(devs, grid, i):
    """How an exchange along axis ``i`` of ``grid`` runs when partition q
    sits on ``devs[q]``: one group of receivers a device, (device, the
    senders in stack order, the buckets [a0, a1) they send it, the
    receivers in the order the stack's transpose yields them). A group is
    the product of its off-axis coordinates and an axis range; a device
    whose receivers are no such product gives one group a receiver. One
    card: one group, the whole exchange."""
    n = grid[i]
    by_dev = {}
    for q, dev in enumerate(devs):
        c = _coords(q, grid)
        by_dev.setdefault(dev, []).append((tuple(c[:i] + c[i + 1:]), c[i]))
    groups = []
    for dev, cs in by_dev.items():
        offs = sorted({o for o, _ in cs})
        a = sorted({b for _, b in cs})
        if len(cs) == len(offs) * len(a) and a[-1] - a[0] == len(a) - 1:
            groups.append((dev, offs, a[0], a[-1] + 1))
        else:
            groups += [(dev, [o], b, b + 1) for o, b in cs]

    def at(o, j):
        return _flat(o[:i] + (j,) + o[i:], grid)
    return tuple((dev, tuple(at(o, j) for o in offs for j in range(n)),
                  a0, a1, tuple(at(o, b) for o in offs
                                for b in range(a0, a1)))
                 for dev, offs, a0, a1 in groups)


def _all_to_all(xs, axes, mesh_shape, mesh_axes):
    grid, i, size = _a2a_check(xs, axes, mesh_shape, mesh_axes)
    if bound() is not None:
        return _all_to_all_across(bound(), xs, grid, i)
    n = grid[i]
    rows, *rest = xs[0].shape
    cap = rows // n
    out = [None] * size
    for dev, srcs, a0, a1, dests in _exchange_plan(
            tuple(x.device for x in xs), grid, i):
        # the senders' buckets a0..a1 on the group's device, one stack,
        # then one copy that swaps the sender's coordinate with its bucket
        part = [xs[s] if a1 - a0 == n else xs[s][a0 * cap:a1 * cap]
                for s in srcs]
        x = torch.stack([t if t.device == dev else t.to(dev, non_blocking=True)
                         for t in part])
        x = x.reshape(len(srcs) // n, n, a1 - a0, cap, *rest).transpose(1, 2)
        for q, t in zip(dests, x.reshape(len(dests), rows, *rest).unbind(0)):
            out[q] = t
    return out


def _all_to_all_fake(xs, axes, mesh_shape, mesh_axes):
    _a2a_check(xs, axes, mesh_shape, mesh_axes)
    return [torch.empty_like(x) for x in xs]


def _psum_check(xs, axes, mesh_shape, mesh_axes):
    shape, size = _check(xs, mesh_shape, mesh_axes)
    b = bound()
    if len(xs) != (size if b is None else len(b.local)) \
            or tuple(axes) != tuple(mesh_axes):
        raise ValueError(f"psum takes one tensor a partition over every "
                         f"axis {tuple(mesh_axes)}; got {len(xs)} over "
                         f"{tuple(axes)}")
    if any(tuple(x.shape) != tuple(xs[0].shape) or x.dtype != xs[0].dtype
           for x in xs):
        raise ValueError("psum needs one shape and dtype on every partition")


def _psum(xs, axes, mesh_shape, mesh_axes):
    _psum_check(xs, axes, mesh_shape, mesh_axes)
    home = xs[0].device
    # on the home device, in the partitions' dtype: int32 wraps, as JAX's
    out = torch.stack([x.to(home, non_blocking=True) for x in xs]).sum(
        0, dtype=xs[0].dtype)
    if bound() is not None:     # then over the ranks, in the same dtype
        out = _all_reduce(bound().group, out)
    return out


def _psum_fake(xs, axes, mesh_shape, mesh_axes):
    _psum_check(xs, axes, mesh_shape, mesh_axes)
    return torch.empty_like(xs[0])


# ------------------------------------------------------ across processes

_ALIGN = 16      # bytes: every tensor of a message starts aligned


def _nbytes(shape, dtype) -> int:
    n = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    return n + (-n) % _ALIGN


def _pack(group, ts) -> torch.Tensor:
    """``ts`` as one uint8 buffer (each tensor's bytes padded to
    ``_ALIGN``) on the wire device."""
    wire = group.wire
    parts = []
    for t in ts:
        b = t.contiguous().reshape(-1).view(torch.uint8)
        parts.append(b)
        if b.numel() % _ALIGN:
            parts.append(torch.zeros((-b.numel()) % _ALIGN,
                                     dtype=torch.uint8, device=b.device))
    if not parts:
        return torch.zeros(0, dtype=torch.uint8, device=wire)
    if len({x.device for x in parts}) > 1:
        parts = [x.to(wire) for x in parts]
    buf = torch.cat(parts)      # one copy to the wire, where it is not there
    return buf if buf.device == wire else buf.to(wire)


def _unpack(buf, specs) -> list:
    """The tensors of a received buffer, one (shape, dtype, device) a
    tensor: views of the buffer copied to their device where it is not
    there (one copy a device)."""
    on = {}
    out, off = [], 0
    for shape, dtype, dev in specs:
        n = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        if dev not in on:
            on[dev] = buf if buf.device == dev else buf.to(dev)
        out.append(on[dev][off:off + n].view(dtype).reshape(shape))
        off += n + (-n) % _ALIGN
    return out


def _p2p(group, sends: dict, recvs: dict):
    """One ``batch_isend_irecv`` of every buffer of ``sends`` {rank:
    tensor} and into every buffer of ``recvs`` {rank: tensor}, waited
    on."""
    ops = [tdist.P2POp(tdist.isend, buf, r, group.pg)
           for r, buf in sorted(sends.items())]
    ops += [tdist.P2POp(tdist.irecv, buf, r, group.pg)
            for r, buf in sorted(recvs.items())]
    if ops:
        for work in tdist.batch_isend_irecv(ops):
            work.wait()


def _exchange(b: Across, sends: dict, recvs: dict) -> dict:
    """Move ``sends`` {rank: [tensor]} to their ranks and receive
    ``recvs`` {rank: [(shape, dtype, device)]} from theirs: one message a
    pair of ranks. Returns {rank: [tensor]} in the order of ``recvs``."""
    g = b.group
    wire = g.wire
    bufs = {r: torch.empty(sum(_nbytes(s, d) for s, d, _ in specs),
                           dtype=torch.uint8, device=wire)
            for r, specs in recvs.items()}
    _p2p(g, {r: _pack(g, ts) for r, ts in sends.items()}, bufs)
    return {r: _unpack(bufs[r], specs) for r, specs in recvs.items()}


def _ppermute_across(b: Across, xs, axis, perm, shape, mesh_axes, make):
    """`_ppermute` for the rank's own partitions: a sender on this rank
    hands ``make(leaf, device)`` to its receiver, one on another rank
    sends its leaves in the call's message to that rank; a receiver sizes
    what it gets from its own leaves, so the rank's entries must share
    their shapes and dtypes."""
    nl = len(b.local)
    leaves = len(xs) // nl
    for k in range(leaves):
        if any(xs[i * leaves + k].shape != xs[k].shape
               or xs[i * leaves + k].dtype != xs[k].dtype
               for i in range(1, nl)):
            raise ValueError("across ranks a ppermute's entries share their "
                             f"shapes and dtypes; leaf {k} differs")
    pos = {p: i for i, p in enumerate(b.local)}
    srcs = ppermute_sources(axis, perm, shape, mesh_axes)
    me, fake = b.group.rank, make is not _moved
    out = [None] * len(xs)
    sends, recvs, slots = {}, {}, {}
    for p, s in enumerate(srcs):
        mine = p in pos
        if mine:
            base = pos[p] * leaves
            dev = xs[base].device
        if s < 0:
            if mine:
                for k in range(leaves):
                    out[base + k] = torch.zeros_like(xs[base + k])
            continue
        if mine and s in pos:
            for k in range(leaves):
                out[base + k] = make(xs[pos[s] * leaves + k], dev)
        elif s in pos and not fake:
            sends.setdefault(b.rank_of[p], []).extend(
                xs[pos[s] * leaves:(pos[s] + 1) * leaves])
        elif mine:
            if fake:
                for k in range(leaves):
                    out[base + k] = make(xs[base + k], dev)
                continue
            r = b.rank_of[s]
            recvs.setdefault(r, []).extend(
                (tuple(x.shape), x.dtype, dev)
                for x in xs[base:base + leaves])
            slots.setdefault(r, []).extend(range(base, base + leaves))
    if not fake:
        for r, got in _exchange(b, sends, recvs).items():
            for i, t in zip(slots[r], got):
                out[i] = t
    return out


def _all_to_all_across(b: Across, xs, grid, i):
    """`_all_to_all` for the rank's own partitions: receiver q's slot j
    is bucket q[i] of the sender at q's coordinates with j along the
    axis; the buckets between two ranks travel in one message, those
    within the rank are slices. Each receiver's slots are concatenated on
    its device."""
    n = grid[i]
    rows, *rest = xs[0].shape
    cap = rows // n
    pos = {p: k for k, p in enumerate(b.local)}
    pieces = {q: [None] * n for q in b.local}
    sends, recvs, slots = {}, {}, {}
    for q in range(len(b.rank_of)):
        c = _coords(q, grid)
        bucket = c[i]
        for j in range(n):
            s = _flat(c[:i] + [j] + c[i + 1:], grid)
            if q in pos and s in pos:
                piece = xs[pos[s]][bucket * cap:(bucket + 1) * cap]
                dev = xs[pos[q]].device
                pieces[q][j] = piece if piece.device == dev else \
                    piece.to(dev, non_blocking=True)
            elif s in pos:
                sends.setdefault(b.rank_of[q], []).append(
                    xs[pos[s]][bucket * cap:(bucket + 1) * cap])
            elif q in pos:
                r = b.rank_of[s]
                recvs.setdefault(r, []).append(
                    ((cap, *rest), xs[0].dtype, xs[pos[q]].device))
                slots.setdefault(r, []).append((q, j))
    for r, got in _exchange(b, sends, recvs).items():
        for (q, j), t in zip(slots[r], got):
            pieces[q][j] = t
    return [torch.cat(pieces[q]) for q in b.local]


def _all_reduce(group, x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks of ``group`` (one ``all_reduce``, in
    ``x``'s dtype: int32 wraps whatever the order), on ``x``'s device."""
    wire = group.wire
    buf = x.to(wire) if x.device != wire else x
    tdist.all_reduce(buf, op=tdist.ReduceOp.SUM, group=group.pg)
    return buf if buf.device == x.device else buf.to(x.device)


LIB = torch.library.Library(NAMESPACE, "DEF")
for _name, _schema in SCHEMAS.items():
    LIB.define(_name + _schema)
_IMPL = torch.library.Library(NAMESPACE, "IMPL")


def _register(name, kernel, fake):
    for key in ("CPU", "CUDA"):
        _IMPL.impl(name, kernel, key)
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_IMPL)


_register("ppermute",
          lambda xs, axis, perm, shape, axes: _ppermute(
              xs, axis, perm, shape, axes, _moved),
          lambda xs, axis, perm, shape, axes: _ppermute(
              xs, axis, perm, shape, axes,
              lambda x, dev: torch.empty_like(x, device=dev)))
_register("all_to_all", _all_to_all, _all_to_all_fake)
_register("psum", _psum, _psum_fake)


def op(name: str):
    """The overload packet ``torch.ops.dint_mesh.<name>``."""
    return getattr(torch.ops.dint_mesh, name)


def is_collective(target) -> bool:
    """True for an fx node target that is one of the ``dint_mesh`` ops."""
    return getattr(target, "namespace", None) == NAMESPACE


# ------------------------------------------------- reading a traced node


def node_axes(node) -> tuple:
    """The axis names a collective node names (one for a ``ppermute``)."""
    name = node.target.name() if hasattr(node.target, "name") else ""
    a = node.args[1] if len(node.args) > 1 else ()
    if name.endswith("ppermute"):
        return (str(a),)
    return tuple(str(x) for x in a)


def node_mesh(node) -> tuple[tuple, tuple]:
    """(mesh shape, mesh axis names) a collective node carries."""
    shape, axes = node.args[-2], node.args[-1]
    return tuple(int(n) for n in shape), tuple(str(a) for a in axes)


def node_perm(node) -> list:
    """The (source, destination) pairs of a ``ppermute`` node."""
    return perm_pairs(node.args[2])
