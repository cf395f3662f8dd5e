"""mesh.nccl_ms_per_step: device milliseconds a step in NCCL's kernels on
rank 0's card (the replication hops and the stats' sum across the
servers). Nothing on one card, or where no NCCL kernel ran."""


def read(views, ctx):
    v = views[0]
    if not v["steps"] or v["kind_s"]["nccl"] <= 0:
        return None
    return 1e3 * v["kind_s"]["nccl"] / v["steps"]
