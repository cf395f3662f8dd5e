"""An in-process device mesh: the counterpart of `jax.sharding.Mesh` plus
the three collectives the sharded TATP and SmallBank paths use, for
partitions kept as a Python list, one device a partition.

One process drives the whole mesh, as one JAX controller drives its
devices: partition ``p`` of a mesh of shape ``(D,)`` or ``(H, C)`` is entry
``p`` of a list, its flat index ``h * C + c`` (the order
`dint_tpu.parallel.multihost` derives a partition id in), and its tensors
live on ``mesh.device_of(p)``. `placement` says which card that is when
the caller names none (JAX's ``Mesh(np.array(jax.devices()[:n]))``, with
blocks of partitions sharing a card where there are fewer cards than
partitions); ``device=`` puts every partition on one device, so a run
then measures the partitions' work and their replication and no link.
NCCL's one rank a card is not used: a 3-partition mesh must also run on
one card.

A collective is one call of a ``dint_mesh`` operator (ops/mesh_ops.py)
over every partition's tensors, so a trace of a mesh step shows one node
a collective, carrying its axis, its permutation and the mesh; it is the
only place where one partition's data reaches another's card:

* `Mesh.ppermute` moves each partition's entry along one axis (JAX's
  ``perm = [(i, (i + off) % n)]``): the receiver gets a fresh copy of the
  sender's tensors on its own device (the hop's records, never a table);
* `Mesh.all_to_all` exchanges buckets along one axis (JAX's
  ``all_to_all(x.reshape(n, cap), axis, 0, 0, tiled=False)``), or along
  the tuple of every axis (the 1-D exchange over the flat index): bucket
  d of partition s lands in slot s of partition d, on d's device;
* `Mesh.psum` sums equal-shape tensors over the whole list on the home
  device, ``devices[0]``, where the runners also draw their random bits.

The same code runs on the CPU, where the tests hold it against JAX's
runners on virtual devices and audit that no operator but a collective
takes tensors of two partitions.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..device import resolve_device
from ..ops import mesh_ops


def placement(shape, cards) -> list:
    """The device of each flat partition of a mesh of ``shape`` over the
    visible ``cards`` (a list of devices, k of them), when the caller
    names none:

    * k >= the mesh's size n: partition p on ``cards[p]`` (JAX's
      ``jax.devices()[:n]``);
    * fewer cards, 1-D mesh: contiguous blocks, partition p on
      ``cards[p * k // n]``;
    * fewer cards, (H, C) mesh: a host's chips share one card and the
      hosts spread over min(k, H) cards in contiguous blocks, host h on
      ``cards[h * min(k, H) // H]``, so only the "dcn" axis crosses cards.
    """
    shape = tuple(int(n) for n in shape)
    n, k = math.prod(shape), len(cards)
    if not k:
        raise ValueError("no device to place the mesh on")
    if k >= n:
        return list(cards[:n])
    if len(shape) == 1:
        return [cards[p * k // n] for p in range(n)]
    hosts = shape[0]
    per_host = n // hosts
    used = min(k, hosts)
    return [cards[(p // per_host) * used // hosts] for p in range(n)]


def _card(device) -> torch.device:
    """``device`` resolved (`resolve_device`), a CUDA device without an
    index pinned to the current one, so it compares equal to its
    tensors' devices."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """``shape`` partitions named by ``axis_names`` (one name an axis).
    ``devices``: one device a flat partition; else ``device``: every
    partition on that one device; else (both None) the visible CUDA cards
    by `placement`, which raises without a card (nothing falls back to
    the CPU). ``device`` is the home device, ``devices[0]``."""

    def __init__(self, shape, axis_names, device=None, devices=None):
        self.shape = tuple(int(n) for n in shape)
        self.axis_names = tuple(axis_names)
        if len(self.shape) != len(self.axis_names) or \
                min(self.shape, default=0) < 1:
            raise ValueError(f"mesh shape {self.shape} and axes "
                             f"{self.axis_names} do not match")
        if devices is not None and device is not None:
            raise ValueError("give a mesh device= or devices=, not both")
        if devices is not None:
            devs = [_card(d) for d in devices]
            if len(devs) != self.size:
                raise ValueError(f"{len(devs)} devices for {self.size} "
                                 f"partitions")
        elif device is not None:
            devs = [_card(device)] * self.size
        else:
            resolve_device(None)    # raises without a card
            devs = placement(self.shape, [
                torch.device("cuda", i)
                for i in range(torch.cuda.device_count())])
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"a mesh's partitions share one device type, "
                             f"got {sorted({str(d) for d in devs})}")
        self.devices = tuple(devs)
        self.device = self.devices[0]
        self.cards = tuple(dict.fromkeys(self.devices))

    def device_of(self, p: int) -> torch.device:
        """The device partition ``p``'s tensors live on."""
        return self.devices[p]

    def per_partition(self, make) -> list:
        """``make(card)`` called once for each card of the mesh, listed by
        partition (the partitions on one card share what it made): a
        runner's device constants."""
        made = {d: make(d) for d in self.cards}
        return [made[d] for d in self.devices]

    def to_partition(self, x: torch.Tensor, p: int) -> torch.Tensor:
        """``x`` on partition ``p``'s device: ``x`` itself where it is
        already there, else a copy. How a runner hands each partition its
        slice of draws made on the home device."""
        return x.to(self.devices[p], non_blocking=True)

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
        partition's tensors (fresh copies, on the receiver's device)."""
        self._check(xs)
        flat = [leaves(x) for x in xs]
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
        return [rebuild(xs[s], iter(moved[p * n_leaves:
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
        ``xs[0]``'s shape on its own device (one ``dint_mesh::all_to_all``
        call: for each card's receivers, the buckets they take copied to
        the card, one stack and one transposed copy; on one card, the
        whole exchange in those two)."""
        self._check(xs)
        axes = list(axis) if isinstance(axis, tuple) else [axis]
        return mesh_ops.op("all_to_all")(list(xs), axes, list(self.shape),
                                         list(self.axis_names))

    def psum(self, xs: list) -> torch.Tensor:
        """``jax.lax.psum`` over every axis: the sum of the partitions'
        equal-shape tensors, in their dtype (int32 wraps, as JAX's), on
        the home device."""
        self._check(xs)
        return mesh_ops.op("psum")(list(xs), list(self.axis_names),
                                   list(self.shape), list(self.axis_names))


def leaves(obj) -> list:
    """The tensors of an entry (a tensor, or a tuple, list, dict or
    dataclass of them, at any depth), in a fixed order."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [t for f in dataclasses.fields(obj)
                for t in leaves(getattr(obj, f.name))]
    if isinstance(obj, (tuple, list)):
        return [t for x in obj for t in leaves(x)]
    if isinstance(obj, dict):
        return [t for x in obj.values() for t in leaves(x)]
    return []


def rebuild(obj, it):
    """``obj``'s structure with its tensors replaced from ``it`` in
    `leaves` order."""
    if isinstance(obj, torch.Tensor):
        return next(it)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: rebuild(getattr(obj, f.name), it)
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, (tuple, list)):
        items = [rebuild(x, it) for x in obj]
        return type(obj)(*items) if hasattr(obj, "_fields") \
            else type(obj)(items)
    if isinstance(obj, dict):
        return {k: rebuild(x, it) for k, x in obj.items()}
    return obj
