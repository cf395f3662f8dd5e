"""A device mesh: the counterpart of `jax.sharding.Mesh` plus the three
collectives the sharded TATP and SmallBank paths use, for partitions kept
as a Python list, one device a partition.

Partition ``p`` of a mesh of shape ``(D,)`` or ``(H, C)`` is entry ``p``
of a list, its flat index ``h * C + c`` (the order
`dint_tpu.parallel.multihost` derives a partition id in), and its tensors
live on ``mesh.device_of(p)``. `placement` says which card that is when
the caller names none (JAX's ``Mesh(np.array(jax.devices()[:n]))``, with
blocks of partitions sharing a card where there are fewer cards than
partitions); ``device=`` puts every partition on one device, so a run
then measures the partitions' work and their replication and no link.

One process may drive the whole mesh, as one JAX controller drives its
devices (a world of one: a 3-partition mesh also runs on one card). Or
the mesh spans processes, one a host, as JAX's does under
``jax.distributed``: ``group=`` (`parallel.dist.initialize`) gives rank r
of P ranks a contiguous block of the partitions (`Mesh.local`): on an
(H, C) mesh the hosts ``[r*H/P, (r+1)*H/P)``, so "ici" never crosses
ranks and only "dcn" does; on a 1-D mesh a block of shards. The lists
stay ``mesh.size`` long, another rank's entries None, so the runners
index partitions as in one process and loop over `Mesh.local`. The
collectives cross ranks over the group's transport: NCCL where each rank
has its cards, gloo (through host memory for CUDA tensors) where ranks
share a card or run on the CPU.

A collective is one call of a ``dint_mesh`` operator (ops/mesh_ops.py)
over every local partition's tensors, so a trace of a mesh step shows one
node a collective, carrying its axis, its permutation and the mesh; it is
the only place where one partition's data reaches another's card or
rank:

* `Mesh.ppermute` moves each partition's entry along one axis (JAX's
  ``perm = [(i, (i + off) % n)]``): the receiver gets a fresh copy of the
  sender's tensors on its own device (the hop's records, never a table);
* `Mesh.all_to_all` exchanges buckets along one axis (JAX's
  ``all_to_all(x.reshape(n, cap), axis, 0, 0, tiled=False)``), or along
  the tuple of every axis (the 1-D exchange over the flat index): bucket
  d of partition s lands in slot s of partition d, on d's device;
* `Mesh.psum` sums equal-shape tensors over the whole mesh on the home
  device, the first local partition's, where the runners also draw their
  random bits; every rank gets the sum.

The same code runs on the CPU, where the tests hold it against JAX's
runners on virtual devices (and across gloo processes) and audit that no
operator but a collective takes tensors of two partitions.
"""
from __future__ import annotations

import contextlib
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


def rank_blocks(shape, n_ranks: int) -> list:
    """The rank of each flat partition of a mesh of ``shape`` over
    ``n_ranks`` processes: contiguous blocks along the major axis (whole
    hosts of an (H, C) mesh), which ``n_ranks`` must divide."""
    shape = tuple(int(n) for n in shape)
    if n_ranks < 1 or shape[0] % n_ranks:
        raise ValueError(f"{n_ranks} processes do not divide the "
                         f"{shape[0]} {'hosts' if len(shape) > 1 else 'shards'}"
                         f" of a {'x'.join(map(str, shape))} mesh")
    per = math.prod(shape) // n_ranks
    return [p // per for p in range(math.prod(shape))]


class Mesh:
    """``shape`` partitions named by ``axis_names`` (one name an axis).
    ``devices``: one device a flat partition (over a group, only the
    local partitions' entries are read; the others may be None); else
    ``device``: every local partition on that one device; else (both
    None) `placement` over the cards the rank owns (the group's, or every
    visible card in one process), which raises without a card (nothing
    falls back to the CPU). ``group``: a `parallel.dist.Group`, this
    process one rank of several (None: the whole mesh here). ``device``
    is the home device, the first local partition's; another rank's
    partitions have None in ``devices``."""

    def __init__(self, shape, axis_names, device=None, devices=None,
                 group=None):
        self.shape = tuple(int(n) for n in shape)
        self.axis_names = tuple(axis_names)
        if len(self.shape) != len(self.axis_names) or \
                min(self.shape, default=0) < 1:
            raise ValueError(f"mesh shape {self.shape} and axes "
                             f"{self.axis_names} do not match")
        if devices is not None and device is not None:
            raise ValueError("give a mesh device= or devices=, not both")
        self.group = group
        self._ranks = tuple(rank_blocks(self.shape, 1 if group is None
                                        else group.size))
        me = 0 if group is None else group.rank
        self.local = tuple(p for p, r in enumerate(self._ranks) if r == me)
        if devices is not None:
            if len(devices) != self.size:
                raise ValueError(f"{len(devices)} devices for {self.size} "
                                 f"partitions")
            devs = {p: _card(devices[p]) for p in self.local}
        elif device is not None:
            devs = dict.fromkeys(self.local, _card(device))
        else:
            resolve_device(None)    # raises without a card
            cards = list(group.cards) if group is not None else [
                torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
            block = (len(self.local),) if len(self.shape) == 1 else \
                (len(self.local) // self.shape[1],) + self.shape[1:]
            devs = dict(zip(self.local, placement(block, cards)))
        if len({d.type for d in devs.values()}) != 1:
            raise ValueError(f"a mesh's partitions share one device type, "
                             f"got {sorted({str(d) for d in devs.values()})}")
        self.devices = tuple(devs.get(p) for p in range(self.size))
        self.device = self.devices[self.local[0]]
        self.cards = tuple(dict.fromkeys(devs.values()))
        # what the collectives cross ranks with (None: one process)
        self._across = None if group is None or group.size == 1 else \
            mesh_ops.Across(group, self._ranks)

    def device_of(self, p: int) -> torch.device:
        """The device partition ``p``'s tensors live on (None: another
        rank's)."""
        return self.devices[p]

    def rank_of(self, p: int) -> int:
        """The rank that holds partition ``p`` (0 in one process)."""
        return self._ranks[p]

    def per_partition(self, make) -> list:
        """``make(card)`` called once for each card of the rank, listed by
        partition (the partitions on one card share what it made; another
        rank's entries None): a runner's device constants."""
        made = {d: make(d) for d in self.cards}
        return [None if d is None else made[d] for d in self.devices]

    def map_local(self, make) -> list:
        """``[make(p) for each local p]`` as a list a partition, another
        rank's entries None."""
        return [make(p) if d is not None else None
                for p, d in enumerate(self.devices)]

    def to_partition(self, x: torch.Tensor, p: int) -> torch.Tensor:
        """``x`` on partition ``p``'s device: ``x`` itself where it is
        already there, else a copy. How a runner hands each partition its
        slice of draws made on the home device."""
        return x.to(self.devices[p], non_blocking=True)

    def _bind(self):
        """The collectives' binding: `mesh_ops.across` over the group, or
        nothing in one process."""
        if self._across is None:
            return contextlib.nullcontext()
        return mesh_ops.across(self._across)

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
        if self._across is not None and any(
                xs[p] is None for p in self.local):
            raise ValueError("a local partition's entry is None")

    def ppermute(self, xs: list, axis: str, off: int) -> list:
        """``jax.lax.ppermute`` with ``perm = [(i, (i + off) % n)]`` along
        ``axis``: partition ``p`` receives what partition ``p - off`` along
        the axis holds. ``xs`` has one entry a partition: a tensor, or a
        tuple, list, dict or dataclass of them (None and Python scalars
        ride along with their tensors), the same structure on every
        partition. One ``dint_mesh::ppermute`` call moves every
        partition's tensors (fresh copies, on the receiver's device)."""
        self._check(xs)
        flat = {p: leaves(xs[p]) for p in self.local}
        n_leaves = len(flat[self.local[0]])
        if any(len(f) != n_leaves for f in flat.values()):
            raise ValueError("the partitions' entries hold different "
                             "numbers of tensors")
        n = self.shape[self.axis_names.index(axis)] \
            if axis in self.axis_names else 0
        pairs = [v for i in range(n) for v in (i, (i + off) % n)]
        srcs = mesh_ops.ppermute_sources(axis, pairs, self.shape,
                                         self.axis_names)
        out = [None] * self.size
        # another rank's sender: the receiver's own entry gives the
        # structure and the host values (the entries share them)
        like = {p: xs[s] if s in flat else xs[p]
                for p, s in enumerate(srcs) if p in flat}
        if not n_leaves:            # no tensor to move: a host re-index
            for p in like:
                out[p] = like[p]
            return out
        with self._bind():
            moved = mesh_ops.op("ppermute")(
                [t for p in self.local for t in flat[p]], axis, pairs,
                list(self.shape), list(self.axis_names))
        for i, p in enumerate(self.local):
            out[p] = rebuild(like[p], iter(moved[i * n_leaves:
                                                 (i + 1) * n_leaves]))
        return out

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
        with self._bind():
            got = mesh_ops.op("all_to_all")(
                [xs[p] for p in self.local], axes, list(self.shape),
                list(self.axis_names))
        out = [None] * self.size
        for p, t in zip(self.local, got):
            out[p] = t
        return out

    def psum(self, xs: list) -> torch.Tensor:
        """``jax.lax.psum`` over every axis: the sum of the partitions'
        equal-shape tensors, in their dtype (int32 wraps, as JAX's), on
        the home device of every rank."""
        self._check(xs)
        with self._bind():
            return mesh_ops.op("psum")(
                [xs[p] for p in self.local], list(self.axis_names),
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
