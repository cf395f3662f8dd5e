"""An in-process device mesh: the counterpart of `jax.sharding.Mesh` plus
the three collectives the sharded TATP and SmallBank paths use, for
partitions kept as a Python list on one device.

One card has no peers, and NCCL puts one rank on a card, so the port runs
the reference's mesh in one process: partition ``p`` of a mesh of shape
``(D,)`` or ``(H, C)`` is entry ``p`` of a list, its flat index ``h * C +
c`` (the order `dint_tpu.parallel.multihost` derives a partition id in).
A collective is one call of a ``dint_mesh`` operator (ops/mesh_ops.py)
over every partition's tensors, so a trace of a mesh step shows one node
a collective, carrying its axis, its permutation and the mesh:

* `Mesh.ppermute` moves each partition's entry along one axis (JAX's
  ``perm = [(i, (i + off) % n)]``): the receiver gets a fresh copy of the
  sender's tensors (the hop's records, never a table);
* `Mesh.all_to_all` exchanges buckets along one axis (JAX's
  ``all_to_all(x.reshape(n, cap), axis, 0, 0, tiled=False)``), or along
  the tuple of every axis (the 1-D exchange over the flat index): bucket
  d of partition s lands in slot s of partition d, with one stack and one
  transposed copy on the device, and no link;
* `Mesh.psum` sums equal-shape tensors over the whole list.

So a run on such a mesh measures the work of every partition, replication
included, and no link between devices. The same code runs on the CPU,
where the tests hold it against JAX's runners on virtual devices.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..device import resolve_device
from ..ops import mesh_ops


class Mesh:
    """``shape`` partitions named by ``axis_names`` (one name an axis), all
    on ``device`` (None means CUDA, and raises without one)."""

    def __init__(self, shape, axis_names, device=None):
        self.shape = tuple(int(n) for n in shape)
        self.axis_names = tuple(axis_names)
        if len(self.shape) != len(self.axis_names) or \
                min(self.shape, default=0) < 1:
            raise ValueError(f"mesh shape {self.shape} and axes "
                             f"{self.axis_names} do not match")
        self.device = resolve_device(device)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def coords(self, p: int) -> tuple:
        """The coordinates of flat partition ``p``, major axis first."""
        out = []
        for n in reversed(self.shape):
            p, c = divmod(p, n)
            out.append(c)
        return tuple(reversed(out))

    def flat(self, coords) -> int:
        p = 0
        for c, n in zip(coords, self.shape):
            p = p * n + c
        return p

    def axis_index(self, p: int, axis: str) -> int:
        """``jax.lax.axis_index(axis)`` as partition ``p`` sees it."""
        return self.coords(p)[self.axis_names.index(axis)]

    def shift(self, p: int, axis: str, off: int) -> int:
        """The partition ``off`` steps from ``p`` along ``axis``, wrapping."""
        c = list(self.coords(p))
        i = self.axis_names.index(axis)
        c[i] = (c[i] + off) % self.shape[i]
        return self.flat(c)

    def _check(self, xs: list):
        if len(xs) != self.size:
            raise ValueError(f"{len(xs)} entries for {self.size} partitions")

    def ppermute(self, xs: list, axis: str, off: int) -> list:
        """``jax.lax.ppermute`` with ``perm = [(i, (i + off) % n)]`` along
        ``axis``: partition ``p`` receives what partition ``p - off`` along
        the axis holds. ``xs`` has one entry a partition: a tensor, or a
        tuple, list, dict or dataclass of them (None and Python scalars
        ride along with their tensors), the same structure on every
        partition. One ``dint_mesh::ppermute`` call moves every
        partition's tensors (fresh copies)."""
        self._check(xs)
        flat = [_leaves(x) for x in xs]
        n_leaves = len(flat[0])
        if any(len(f) != n_leaves for f in flat):
            raise ValueError("the partitions' entries hold different "
                             "numbers of tensors")
        n = self.shape[self.axis_names.index(axis)] \
            if axis in self.axis_names else 0
        pairs = [v for i in range(n) for v in (i, (i + off) % n)]
        srcs = mesh_ops.ppermute_sources(axis, pairs, self.shape,
                                         self.axis_names)
        if not n_leaves:            # no tensor to move: a host re-index
            return [xs[s] for s in srcs]
        moved = mesh_ops.op("ppermute")(
            [t for f in flat for t in f], axis, pairs, list(self.shape),
            list(self.axis_names))
        return [_rebuild(xs[s], iter(moved[p * n_leaves:
                                           (p + 1) * n_leaves]))
                for p, s in enumerate(srcs)]

    def all_to_all(self, xs: list, axis) -> list:
        """``jax.lax.all_to_all(x.reshape(n, cap, ...), axis, 0, 0,
        tiled=False)`` along ``axis`` of length n: each entry of ``xs`` is
        one tensor a partition, of n buckets of ``cap`` rows along its
        first dim (the same shape on every partition), and partition p
        receives, in its slot s, bucket ``p``'s coordinate along the axis
        of the partition at coordinate s. ``axis`` may also be the tuple of
        every axis name, major first (JAX's tuple-axis form): then n is the
        mesh's size, a coordinate is the flat index, and the exchange is
        the 1-D one over all partitions. Returns one tensor a partition, of
        ``xs[0]``'s shape (one ``dint_mesh::all_to_all`` call: one stack
        and one transposed copy on the device)."""
        self._check(xs)
        axes = list(axis) if isinstance(axis, tuple) else [axis]
        return mesh_ops.op("all_to_all")(list(xs), axes, list(self.shape),
                                         list(self.axis_names))

    def psum(self, xs: list) -> torch.Tensor:
        """``jax.lax.psum`` over every axis: the sum of the partitions'
        equal-shape tensors, in their dtype (int32 wraps, as JAX's)."""
        self._check(xs)
        return mesh_ops.op("psum")(list(xs), list(self.axis_names),
                                   list(self.shape), list(self.axis_names))


def _leaves(obj) -> list:
    """The tensors of an entry, in a fixed order."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [t for f in dataclasses.fields(obj)
                for t in _leaves(getattr(obj, f.name))]
    if isinstance(obj, (tuple, list)):
        return [t for x in obj for t in _leaves(x)]
    if isinstance(obj, dict):
        return [t for x in obj.values() for t in _leaves(x)]
    return []


def _rebuild(obj, it):
    """``obj``'s structure with its tensors replaced from ``it`` in
    `_leaves` order."""
    if isinstance(obj, torch.Tensor):
        return next(it)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _rebuild(getattr(obj, f.name), it)
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, (tuple, list)):
        items = [_rebuild(x, it) for x in obj]
        return type(obj)(*items) if hasattr(obj, "_fields") \
            else type(obj)(items)
    if isinstance(obj, dict):
        return {k: _rebuild(x, it) for k, x in obj.items()}
    return obj
