"""The multi-device paths of the port (the port of `dint_tpu.parallel`),
on an in-process mesh (`mesh.Mesh`): the partitions are a list, each on
its own device (the visible cards by `mesh.placement`, or one device for
all), and `ppermute`, `all_to_all` and `psum` are `dint_mesh` operators
over the whole list (ops/mesh_ops.py), one node a call in a trace, the
only place one partition's data reaches another's card.

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
from . import (dense_sharded, dense_sharded_sb, mesh, multihost,  # noqa: F401
               multihost_sb, sharded)
