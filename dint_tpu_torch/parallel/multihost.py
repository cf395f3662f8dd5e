"""Multi-host dense TATP: replication across host fault domains over a
(host, chip) mesh (the port of `dint_tpu.parallel.multihost`).

The reference deploys 3 server machines, each holding every record once
(primary for key % 3 == id, backup for the rest), so a machine failure
loses at most one replica of any row (smallbank/caladan/proto.h:62-66).
This is the 2-D form of the sharded runner, on a mesh with the axes

    DCN_AXIS ("dcn")  hosts, the major axis;
    ICI_AXIS ("ici")  chips within a host.

Partition (h, c), flat id ``h * C + c``, is primary for its own subscriber
range; its install records go to hosts h+1 and h+2 AT THE SAME CHIP
(`Mesh.ppermute` along "dcn"), so the 3 replicas of every row sit on 3
different hosts. Host h's partitions rebuild from the logs of (h+1, c) or
(h+2, c), filtered by the source tag (recovery.recover_tatp_dense
key_hi_filter). Needs n_hosts >= 3: with 2 hosts the +2 hop would alias
the source host.

The partitions sit one a card where there are cards enough, else a
host's chips share one card (`mesh.placement`), so the "dcn" hops are the
ones that cross cards; on one card (``device=``) a run measures the
partitions' work and their replication, and no link between hosts. With
``group=`` the hosts are processes (`dist`, as under
``jax.distributed``: "the program is identical, only the transport
changes"), and a lost host's partitions are rebuilt on their rank from
the next host's ring (`rings_from`).
"""
from __future__ import annotations

import os

import numpy as np

from ..engines import tatp_dense as td
from .dense_sharded import (N_BCK, ShardState, _runner,  # noqa: F401
                            _with_backups, n_sub_local)
from .mesh import Mesh

DCN_AXIS = "dcn"
ICI_AXIS = "ici"


def mesh_shape_from_env(default: str = "4x2",
                        env: str = "DINT_BENCH_MESH") -> tuple[int, int]:
    """The mesh-geometry knob: ``DINT_BENCH_MESH="HxC"`` (e.g. "3x2" = 3
    hosts x 2 chips)."""
    spec = os.environ.get(env) or default
    try:
        h, c = (int(p) for p in spec.lower().replace("*", "x").split("x"))
    except ValueError as e:
        raise ValueError(f"{env}={spec!r}: expected 'HxC', e.g. '4x2'") \
            from e
    return h, c


def make_mesh_2d(n_hosts: int, chips_per_host: int, device=None,
                 devices=None, group=None) -> Mesh:
    """A (host, chip) mesh of ``n_hosts * chips_per_host`` partitions,
    host-major, so "dcn" is the major axis: one device a partition
    (``devices``, flat order ``h * C + c``), all on ``device``, or (both
    None) over the visible cards by `mesh.placement`. ``group`` (a
    `dist.Group`): one process a host, or a block of hosts, as under
    ``jax.distributed``; the group's size must divide ``n_hosts``."""
    return Mesh((n_hosts, chips_per_host), (DCN_AXIS, ICI_AXIS), device,
                devices, group=group)


def rings_from(mesh: Mesh, logs: list, off: int = 1) -> list:
    """Each partition (h, c) gets a copy of the log ring of ((h + off) %
    H, c), on its own device: one `Mesh.ppermute` along "dcn" (across
    ranks where the hosts are processes). How a lost host's partitions are
    rebuilt on their rank from a surviving host's ring
    (`recovery.recover_tatp_dense` with ``key_hi_filter``,
    `recovery.recover_sb_shard` with ``ring_owner``), JAX's fault-domain
    story with the ring crossing a process. ``logs``: a `RepLog` a
    partition (None for another rank's)."""
    return mesh.ppermute(logs, DCN_AXIS, -off)


def _check_hosts(mesh: Mesh):
    if mesh.axis_names != (DCN_AXIS, ICI_AXIS):
        raise ValueError(f"expected a ({DCN_AXIS}, {ICI_AXIS}) mesh, got "
                         f"{mesh.axis_names}")
    return mesh.shape


def create_multihost(mesh: Mesh, n_sub_global: int, val_words: int = 10,
                     seed: int = 0, **kw) -> list:
    """One `ShardState` a partition, in flat order, on its partition's
    device (over a group, the rank's hosts only; None for the others'):
    partition (h, c)'s range populated from ``np.random.default_rng(seed
    + h * C + c)``, its backups copies of hosts h-1 and h-2 at the same
    chip."""
    n_hosts, _ = _check_hosts(mesh)
    if n_hosts < 3:
        raise ValueError("multihost replication needs >= 3 hosts "
                         "(reference topology: 3 server machines)")
    n_loc = n_sub_local(n_sub_global, mesh.size)
    dbs = mesh.map_local(lambda d: td.populate(
        np.random.default_rng(seed + d), n_loc, val_words=val_words,
        log_replicas=1, device=mesh.device_of(d), **kw))
    return _with_backups(mesh, DCN_AXIS, dbs)


def build_multihost_runner(mesh: Mesh, n_sub_global: int, w: int = 4096,
                           val_words: int = 10, cohorts_per_block: int = 8,
                           mix=None):
    """(run, init, drain) with the contract of
    `dense_sharded.build_sharded_pipelined_runner` (flat partition order in
    the draws, the states and the counts), the replication pinned to the
    "dcn" axis: partition (h, c) applies the records of ((h-1) % H, c) and
    ((h-2) % H, c), and the stats are summed over both axes."""
    n_hosts, _ = _check_hosts(mesh)
    if n_hosts < 3:
        raise ValueError(
            f"n_hosts={n_hosts}: the replication permute pushes backups "
            "to hosts h+1 and h+2 along the dcn axis; with fewer than 3 "
            "hosts the +2 hop aliases the source host, so one failure "
            "would take a primary AND its second backup together")
    return _runner(mesh, DCN_AXIS, n_sub_global, w, val_words,
                   cohorts_per_block, mix, use_fused=False, monitor=False)
