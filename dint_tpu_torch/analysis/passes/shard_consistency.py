"""Shard-consistency pass: the mesh's collectives must agree with the
mesh (the port of `dint_tpu.analysis.passes.shard_consistency`).

The mesh paths (parallel/dense_sharded*.py, multihost*.py, sharded.py)
are correct only if the moves they emit match the mesh they run on: the
CommitBck fan-out ppermutes install records to partitions +1 and +2
along the replication axis, and the stats' vote psums over every axis. A
permutation built for the wrong partition count silently drops or
duplicates replicas; the backups diverge and recovery from a backup log
rebuilds the wrong state, with no error anywhere at run time.

Each collective is a ``dint_mesh`` node (ops/mesh_ops.py) carrying its
axis, its permutation and the mesh's shape and axis names, so the checks
read the node alone:

  * ``unknown-axis`` (ERROR): a collective names an axis the mesh it
    carries does not have;
  * perm hygiene of a ``ppermute`` against the axis's size:
    ``perm-out-of-range`` (a source or destination outside the axis),
    ``perm-duplicate-dest`` (two senders into one receiver: which one
    lands is unspecified) and ``perm-duplicate-src`` (ERROR each).

The reference's ``check-rep-disabled`` INFO has no twin: it reports a
``shard_map`` run with replication checking off, and the port has no
``shard_map`` (its mesh is one process's list of partitions), so there
is no checker to disable. ``collective-outside-mesh`` has none either:
every ``dint_mesh`` node carries its mesh.
"""
from __future__ import annotations

from ...ops import mesh_ops
from ..core import (Finding, SEV_ERROR, TargetTrace, register_pass, site_of,
                    walk)


@register_pass("shard_consistency")
def shard_consistency(trace: TargetTrace) -> list[Finding]:
    """Checks each mesh collective's axis names and permutation against
    the mesh it carries."""
    out: list[Finding] = []
    for ctx in walk(trace):
        node = ctx.node
        if not mesh_ops.is_collective(node.target):
            continue
        site, path, prim = site_of(node), "/".join(ctx.path), ctx.prim
        shape, mesh_axes = mesh_ops.node_mesh(node)
        axes = mesh_ops.node_axes(node)
        unknown = [a for a in axes if a not in mesh_axes]
        if unknown:
            out.append(Finding(
                "shard_consistency", "unknown-axis", SEV_ERROR, trace.name,
                f"collective `{prim}` names axis {unknown} but its mesh "
                f"only has {mesh_axes}",
                primitive=prim, site=site, path=path,
                suggestion="name the axis through the module's constant "
                           "(parallel/sharded.SHARD_AXIS, multihost_sb."
                           "DCN_AXIS / ICI_AXIS), never a hand-spelled "
                           "string"))
            continue
        if prim != "dint_mesh::ppermute":
            continue
        size = shape[mesh_axes.index(axes[0])]
        try:
            perm = mesh_ops.node_perm(node)
        except ValueError:
            perm = []
        srcs = [s for s, _ in perm]
        dsts = [d for _, d in perm]
        bad = [(s, d) for s, d in perm
               if not (0 <= s < size and 0 <= d < size)]
        if bad:
            out.append(Finding(
                "shard_consistency", "perm-out-of-range", SEV_ERROR,
                trace.name,
                f"ppermute perm {perm} references partitions outside the "
                f"`{axes[0]}` axis (size {size}): pairs {bad} never fire, "
                "so the replica fan-out silently drops installs",
                primitive=prim, site=site, path=path,
                suggestion="build the hops with Mesh.ppermute (the perm "
                           "from the mesh's axis size) and check n_shards "
                           "== the axis size"))
        if len(set(dsts)) != len(dsts):
            out.append(Finding(
                "shard_consistency", "perm-duplicate-dest", SEV_ERROR,
                trace.name,
                f"ppermute perm {perm} sends two sources to one "
                "destination: the receiver keeps an unspecified one — a "
                "replica-divergence race",
                primitive=prim, site=site, path=path))
        if len(set(srcs)) != len(srcs):
            out.append(Finding(
                "shard_consistency", "perm-duplicate-src", SEV_ERROR,
                trace.name,
                f"ppermute perm {perm} lists a source twice: duplicate "
                "sends race on the destination buffer",
                primitive=prim, site=site, path=path))
    return out
