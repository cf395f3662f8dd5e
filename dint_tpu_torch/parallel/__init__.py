"""The multi-device paths of the port (the port of `dint_tpu.parallel`),
on a mesh (`mesh.Mesh`): the partitions are a list, each on its own
device (the visible cards by `mesh.placement`, or one device for all),
driven by one process or by one process a host (`dist`, the counterpart
of ``jax.distributed``: each rank holds a block of the list), and
`ppermute`, `all_to_all` and `psum` are `dint_mesh` operators over the
partitions' tensors (ops/mesh_ops.py), one node a call in a trace, the
only place one partition's data reaches another's card or rank.

* `dist` — the process group: `initialize` (torchrun's environment or
  explicit arguments; gloo or NCCL by the placement), the host's
  agreements and rank 0's broadcasts (`broadcast_ints`,
  `broadcast_object`: how the mesh serving plane's leader commands the
  ranks), `shutdown`.

* `sharded` — the generic engines over a partitioned keyspace with
  primary-backup replication (`build_sharded_step`, `route_batches`).
* `dense_sharded` — dense TATP partitioned by subscriber, each step's
  installs applied to two backups and logged on three shards.
* `dense_sharded_sb` — dense SmallBank over the global keyspace, each
  transaction's locks, reads and installs routed to their owners with
  `all_to_all`, the installs applied to two backups and logged on three
  shards.
* `multihost` — the sharded TATP path over a (host, chip) mesh, the backups on the
  next two hosts.
* `multihost_sb` — sharded SmallBank's step over the (host, chip) mesh:
  hierarchical or flat exchanges, the backups on the next two hosts, the
  serve and double-buffered (overlap) routes of the mesh serving plane.
"""
from . import (dense_sharded, dense_sharded_sb, dist, mesh,  # noqa: F401
               multihost, multihost_sb, sharded)
