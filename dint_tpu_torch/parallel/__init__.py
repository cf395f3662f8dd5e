"""The multi-device paths of the port (the port of `dint_tpu.parallel`),
on an in-process mesh (`mesh.Mesh`): the partitions are a list on one
device, `ppermute` re-indexes it, `all_to_all` exchanges buckets over it
and `psum` sums over it.

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
