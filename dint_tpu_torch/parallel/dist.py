"""The mesh across processes: one process a host, joined by
`torch.distributed` (the counterpart of ``jax.distributed.initialize``).

JAX's runners are one program over ``jax.devices()``; under
``jax.distributed`` the same program spans real hosts, ``jax.devices()``
enumerates them host-major and a "dcn" collective crosses them
(`dint_tpu.parallel.multihost`). Here each process is one rank of a
process group, a `parallel.mesh.Mesh` built with ``group=`` holds a
contiguous block of the partitions on the rank's own cards, and the
mesh's collectives carry what crosses ranks (ops/mesh_ops.py).

`initialize` takes the rendezvous from its arguments, or, where they are
None, from the environment that ``python -m torch.distributed.run``
(torchrun) sets: ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT`` (``init_method="env://"``), ``LOCAL_RANK`` and
``LOCAL_WORLD_SIZE``. The backend follows the placement:

* ``device="cpu"``: gloo;
* each rank of a host with a card of its own (at least as many cards as
  ranks): NCCL, which moves CUDA tensors between the cards itself;
* ranks sharing a card (more ranks on a host than cards, as three ranks
  on one card): gloo, and the mesh's collectives stage CUDA tensors
  through host memory themselves (NCCL refuses two ranks on one card).

An explicit ``backend`` that cannot serve the placement raises (NCCL on
the CPU or on a shared card); nothing retries with another backend. Every
wait of the group ends within ``timeout_s``: a rank that never joins or
dies makes the others raise, never hang (gloo reports a closed peer at
once; NCCL waits are made blocking, so they raise at the timeout).
"""
from __future__ import annotations

import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as tdist

from ..device import resolve_device

DEFAULT_TIMEOUT_S = 120.0


@dataclasses.dataclass(frozen=True)
class Group:
    """One rank's view of the process group: the group itself (``pg``),
    its ``rank`` and ``size``, the ``backend`` it runs (gloo moves CUDA
    tensors through host memory) and this rank's own ``cards`` (its CUDA
    card, or the CPU). ``host_pg``: a gloo group over the same ranks for
    the host's agreements (`barrier`, `all_agree`, `gather_objects`),
    which so never wait on a card's queued work; None: ``pg`` itself (a
    gloo group)."""
    pg: object
    rank: int
    size: int
    backend: str
    cards: tuple
    host_pg: object = None

    @property
    def device(self) -> torch.device:
        """The rank's default device, its first card."""
        return self.cards[0]

    @property
    def wire(self) -> torch.device:
        """Where ``pg``'s tensors live: the rank's card under NCCL, the
        host under gloo."""
        return self.device if self.backend == "nccl" else torch.device("cpu")

    @property
    def host(self):
        """The group the host's agreements travel over."""
        return self.pg if self.host_pg is None else self.host_pg


def _env_int(name: str, value):
    if value is not None:
        return int(value)
    if name not in os.environ:
        raise ValueError(f"{name} is neither given nor set in the "
                         f"environment (torchrun sets it)")
    return int(os.environ[name])


def rank_cards(local_rank: int, local_world: int, n_cards: int) -> tuple:
    """The CUDA card of local rank ``local_rank`` of ``local_world`` ranks
    on a host with ``n_cards``, and whether it shares it: with at least as
    many cards as ranks, card ``local_rank`` of its own (JAX's one
    process a host, here one a card); with fewer, card
    ``local_rank * n_cards // local_world``, shared with the ranks beside
    it."""
    if n_cards < 1:
        raise RuntimeError("no CUDA card to place the rank on")
    if not 0 <= local_rank < local_world:
        raise ValueError(f"local rank {local_rank} of {local_world}")
    if n_cards >= local_world:
        return (local_rank,), False
    return (local_rank * n_cards // local_world,), True


def choose_backend(device_type: str, shared: bool, backend=None) -> str:
    """The backend for ranks on ``device_type`` (sharing a card or not);
    ``backend``, when given, is checked against the placement."""
    want = "gloo" if device_type == "cpu" or shared else "nccl"
    if backend is None:
        return want
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: the mesh runs on gloo or "
                         f"nccl")
    if backend == "nccl" and device_type == "cpu":
        raise ValueError("backend='nccl' needs CUDA cards; the ranks are "
                         "on the CPU (gloo serves them)")
    if backend == "nccl" and shared:
        raise ValueError("backend='nccl' cannot serve ranks that share a "
                         "card (NCCL refuses two ranks on one device); "
                         "gloo stages their tensors through the host")
    return backend


def initialize(init_method=None, world_size=None, rank=None, backend=None,
               timeout_s: float = DEFAULT_TIMEOUT_S, device=None,
               local_rank=None, local_world_size=None) -> Group:
    """Join the process group and return this rank's `Group`.

    ``init_method``: a URL (``tcp://host:port``, ``file:///path``), or
    None for ``env://`` (MASTER_ADDR/MASTER_PORT). ``world_size`` and
    ``rank``: None reads WORLD_SIZE and RANK. ``device``: "cpu", or None
    for the card (raises without one); the rank's cards come from its
    local rank among the host's ranks (LOCAL_RANK, LOCAL_WORLD_SIZE;
    default: the rank and the world size, one host). ``backend``: None
    chooses (`choose_backend`), else it must serve the placement.
    ``timeout_s`` bounds every wait of the group."""
    if tdist.is_initialized():
        raise RuntimeError("a process group is already initialised in this "
                           "process; call shutdown() first")
    world_size = _env_int("WORLD_SIZE", world_size)
    rank = _env_int("RANK", rank)
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} of a world of {world_size}")
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if local_world_size is None:
        local_world_size = int(os.environ.get("LOCAL_WORLD_SIZE",
                                              world_size))
    dev = resolve_device(device)
    if dev.type == "cpu":
        cards, shared = (torch.device("cpu"),), False
    else:
        idx, shared = rank_cards(local_rank, local_world_size,
                                 torch.cuda.device_count())
        cards = tuple(torch.device("cuda", i) for i in idx)
    backend = choose_backend(dev.type, shared, backend)
    if backend == "nccl":
        # a wait on a dead peer raises at the timeout instead of hanging
        os.environ.setdefault("TORCH_NCCL_BLOCKING_WAIT", "1")
        torch.cuda.set_device(cards[0])
    timeout = datetime.timedelta(seconds=timeout_s)
    tdist.init_process_group(
        backend, init_method=init_method or "env://",
        world_size=world_size, rank=rank, timeout=timeout)
    pg = tdist.group.WORLD
    host_pg = None if backend == "gloo" else tdist.new_group(
        backend="gloo", timeout=timeout)
    group = Group(pg=pg, rank=rank, size=world_size, backend=backend,
                  cards=cards, host_pg=host_pg)
    # the group's first collective takes every rank (NCCL's point-to-point
    # calls require it), and a rank that joined but died fails it
    tdist.all_reduce(torch.zeros(1, dtype=torch.int32,
                                 device=group.wire), group=pg)
    barrier(group)
    return group


def barrier(group: Group):
    """Every rank of ``group`` reaches this point (a one-element
    all_reduce on the host's group, so it ends within the timeout where a
    rank is gone)."""
    tdist.all_reduce(torch.zeros(1, dtype=torch.int32), group=group.host)


def all_agree(group: Group, flag: bool) -> bool:
    """True on every rank when ``flag`` is true on any rank: one
    all_reduce (MAX) on the host's group. How ranks end a timed window
    together."""
    x = torch.tensor([int(bool(flag))], dtype=torch.int32)
    tdist.all_reduce(x, op=tdist.ReduceOp.MAX, group=group.host)
    return bool(x.item())


def gather_objects(group: Group, obj) -> list:
    """Every rank's ``obj`` (picklable), in rank order, on every rank."""
    out = [None] * group.size
    tdist.all_gather_object(out, obj, group=group.host)
    return out


def broadcast_ints(group: Group, arr, n: int) -> np.ndarray:
    """Rank 0's int32 vector of ``n`` elements (``arr``; ignored on the
    other ranks, which may pass None) on every rank: one broadcast on the
    host's group, so it never waits on a card and ends within the
    group's timeout where rank 0 is gone. How the leader of a serving
    plane sends each step's command."""
    if group.rank == 0:
        x = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.int32))
        if x.shape != (n,):
            raise ValueError(f"broadcast of {tuple(x.shape)} ints, the "
                             f"ranks expect ({n},)")
    else:
        x = torch.empty(n, dtype=torch.int32)
    tdist.broadcast(x, src=0, group=group.host)
    return x.numpy()


def broadcast_object(group: Group, obj):
    """Rank 0's ``obj`` (picklable) on every rank (the other ranks'
    ``obj`` is ignored), over the host's group."""
    box = [obj if group.rank == 0 else None]
    tdist.broadcast_object_list(box, src=0, group=group.host)
    return box[0]


class Window:
    """`stats.run_window`'s timed window across the ranks of ``group``
    (its ``ranks=``): it starts on a barrier; at each block boundary
    `passed` is true on every rank once any rank's clock has passed the
    window (one all_reduce on the host's group, while the block in flight
    runs on the cards), so every rank runs the same blocks; it ends once
    the rank's ``cards`` are synchronised, on a barrier."""

    def __init__(self, group: Group, cards=()):
        self.group = group
        self.cards = tuple(c for c in cards if c.type == "cuda")

    def start(self):
        barrier(self.group)

    def passed(self, flag: bool) -> bool:
        return all_agree(self.group, flag)

    def end(self):
        for c in self.cards:
            torch.cuda.synchronize(c)
        barrier(self.group)


def shutdown():
    """Leave the process group (a no-op when none is initialised)."""
    if tdist.is_initialized():
        tdist.destroy_process_group()


def from_env() -> bool:
    """True when torchrun started this process as one rank of several
    (WORLD_SIZE > 1)."""
    return int(os.environ.get("WORLD_SIZE", "1")) > 1
