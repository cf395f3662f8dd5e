"""The mesh's three collectives as operators of the ``dint_mesh`` namespace
in ``torch.library``.

parallel/mesh.py keeps a mesh's partitions as a Python list on one
device. Its moves (`Mesh.ppermute`, `Mesh.all_to_all`, `Mesh.psum`) call
these operators with every partition's tensors in one ``Tensor[]``
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
PyTorch, serves CPU and CUDA tensors alike (no link is crossed: every
partition lives on one device), plus a fake (shapes only) for ``make_fx``
and meta tensors. An operator returns fresh tensors, never an alias of
its input, so a ``ppermute`` copies the records it moves. Arguments that
do not fit the mesh raise; nothing falls back.
"""
from __future__ import annotations

import math

import torch

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
    if not xs or len(xs) % size:
        raise ValueError(f"{len(xs)} tensors for {size} partitions")
    dev = xs[0].device
    if any(x.device != dev for x in xs):
        raise ValueError("the partitions' tensors are on different devices")
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


def _ppermute(xs, axis, perm, mesh_shape, mesh_axes, make):
    shape, size = _check(xs, mesh_shape, mesh_axes)
    leaves = len(xs) // size
    srcs = ppermute_sources(axis, perm, mesh_shape, mesh_axes)
    out = []
    for p, s in enumerate(srcs):
        for leaf in range(leaves):
            if s < 0:
                out.append(torch.zeros_like(xs[p * leaves + leaf]))
            else:
                out.append(make(xs[s * leaves + leaf]))
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
    if len(xs) != size:
        raise ValueError(f"{len(xs)} tensors for {size} partitions")
    grid, i = _exchange_axis(axes, mesh_shape, mesh_axes)
    rows = xs[0].shape[0] if xs[0].dim() else 0
    if any(tuple(x.shape) != tuple(xs[0].shape) for x in xs) \
            or xs[0].dim() == 0 or rows % grid[i]:
        raise ValueError(f"all_to_all needs one shape on every partition "
                         f"with rows splitting into {grid[i]} buckets")
    return grid, i, size


def _all_to_all(xs, axes, mesh_shape, mesh_axes):
    grid, i, size = _a2a_check(xs, axes, mesh_shape, mesh_axes)
    rows, *rest = xs[0].shape
    n = grid[i]
    x = torch.stack(list(xs)).reshape(*grid, n, rows // n, *rest)
    # swap the sender's coordinate along the axis with its bucket; one
    # copy into a fresh tensor, whose rows are the partitions' outputs
    x = x.transpose(i, len(grid)).reshape(size, rows, *rest)
    return list(x.unbind(0))


def _all_to_all_fake(xs, axes, mesh_shape, mesh_axes):
    _a2a_check(xs, axes, mesh_shape, mesh_axes)
    return [torch.empty_like(x) for x in xs]


def _psum_check(xs, axes, mesh_shape, mesh_axes):
    shape, size = _check(xs, mesh_shape, mesh_axes)
    if len(xs) != size or tuple(axes) != tuple(mesh_axes):
        raise ValueError(f"psum takes one tensor a partition over every "
                         f"axis {tuple(mesh_axes)}; got {len(xs)} over "
                         f"{tuple(axes)}")
    if any(tuple(x.shape) != tuple(xs[0].shape) or x.dtype != xs[0].dtype
           for x in xs):
        raise ValueError("psum needs one shape and dtype on every partition")


def _psum(xs, axes, mesh_shape, mesh_axes):
    _psum_check(xs, axes, mesh_shape, mesh_axes)
    # in the partitions' dtype: int32 wraps, as JAX's
    return torch.stack(list(xs)).sum(0, dtype=xs[0].dtype)


def _psum_fake(xs, axes, mesh_shape, mesh_axes):
    _psum_check(xs, axes, mesh_shape, mesh_axes)
    return torch.empty_like(xs[0])


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
              xs, axis, perm, shape, axes, torch.clone),
          lambda xs, axis, perm, shape, axes: _ppermute(
              xs, axis, perm, shape, axes, torch.empty_like))
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
