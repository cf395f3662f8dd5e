"""The multi-device paths of the port (the port of `dint_tpu.parallel`),
on an in-process mesh (`mesh.Mesh`): the partitions are a list on one
device, `ppermute` re-indexes it and `psum` sums over it.

* `sharded` — the generic engines over a partitioned keyspace with
  primary-backup replication (`build_sharded_step`, `route_batches`).
* `dense_sharded` — dense TATP partitioned by subscriber, each step's
  installs applied to two backups and logged on three shards.
* `multihost` — the same over a (host, chip) mesh, the backups on the
  next two hosts.
"""
from . import dense_sharded, mesh, multihost, sharded  # noqa: F401
