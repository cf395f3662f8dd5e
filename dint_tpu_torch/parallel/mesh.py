"""An in-process device mesh: the counterpart of `jax.sharding.Mesh` plus
the three collectives the sharded TATP and SmallBank paths use, for
partitions kept as a Python list on one device.

One card has no peers, and NCCL puts one rank on a card, so the port runs
the reference's mesh in one process: partition ``p`` of a mesh of shape
``(D,)`` or ``(H, C)`` is entry ``p`` of a list, its flat index ``h * C +
c`` (the order `dint_tpu.parallel.multihost` derives a partition id in).
A collective is then list work on the host:

* `Mesh.ppermute` re-indexes the list along one axis (JAX's ``perm =
  [(i, (i + off) % n)]``): the receiver reads the sender's tensors, and
  no byte moves;
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

import math

import torch

from ..device import resolve_device


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

    def ppermute(self, xs: list, axis: str, off: int) -> list:
        """``jax.lax.ppermute`` with ``perm = [(i, (i + off) % n)]`` along
        ``axis``: partition ``p`` receives what partition ``p - off`` along
        the axis holds. ``xs`` has one entry (any object) a partition."""
        if len(xs) != self.size:
            raise ValueError(f"{len(xs)} entries for {self.size} partitions")
        return [xs[self.shift(p, axis, -off)] for p in range(self.size)]

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
        ``xs[0]``'s shape."""
        if len(xs) != self.size:
            raise ValueError(f"{len(xs)} entries for {self.size} partitions")
        rows, *rest = xs[0].shape
        if isinstance(axis, tuple):
            if axis != self.axis_names:
                raise ValueError(f"the tuple axis {axis} is not the mesh's "
                                 f"axes {self.axis_names} in order")
            shape, i = (self.size,), 0
        else:
            shape, i = self.shape, self.axis_names.index(axis)
        n = shape[i]
        if rows % n:
            raise ValueError(f"{rows} rows do not split into {n} buckets")
        x = torch.stack(list(xs)).reshape(*shape, n, rows // n, *rest)
        # swap the sender's coordinate along the axis with its bucket
        x = x.transpose(i, len(shape)).reshape(self.size, rows, *rest)
        return list(x.unbind(0))

    def psum(self, xs: list) -> torch.Tensor:
        """``jax.lax.psum`` over every axis: the sum of the partitions'
        equal-shape tensors, in their dtype (int32 wraps, as JAX's)."""
        if len(xs) != self.size:
            raise ValueError(f"{len(xs)} entries for {self.size} partitions")
        return torch.stack(list(xs)).sum(0, dtype=xs[0].dtype)
