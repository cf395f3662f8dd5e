"""shard_consistency on the port, and the other checks that read the
mesh's collectives, held to mutated copies of real mesh traces: an
unknown axis, a perm out of range, a duplicate destination or source (the
pass's four codes), a dropped hop (protocol's no-replication-push), a
collapsed perm and a hop moved to the ici axis (durability's
quorum-fanout); every real mesh target stays clean."""
import pytest

from dint_tpu_torch import analysis
from dint_tpu_torch.analysis import core
from dint_tpu_torch.analysis import mutate as M
from dint_tpu_torch.analysis import targets as T
from dint_tpu_torch.analysis.passes import shard_consistency as sc
from dint_tpu_torch.ops import mesh_ops

pytestmark = pytest.mark.lint

ONE_D = "dense_sharded/block"
TWO_D = "multihost_sb/block@h3"


def _hops(trace, op="dint_mesh::ppermute"):
    return [n for n in trace.graph.nodes
            if n.op == "call_function" and core.op_name(n) == op]


def _mutated(name, edit):
    """A copy of ``name``'s trace with ``edit(copy)`` applied to it."""
    mt = M.copy_trace(T.get_trace(name))
    edit(mt)
    return mt


def _set(node, i, value):
    args = list(node.args)
    args[i] = value
    node.args = tuple(args)


def _codes(findings, sev="error"):
    return {f.code for f in findings if f.severity == sev}


EDITS = {
    "unknown-axis": (ONE_D, lambda mt: _set(_hops(mt)[0], 1, "shrad")),
    "unknown-axis@all_to_all": (
        TWO_D, lambda mt: _set(_hops(mt, "dint_mesh::all_to_all")[0], 1,
                               ["host"])),
    "perm-out-of-range": (ONE_D, lambda mt: _set(_hops(mt)[0], 2,
                                                 [0, 1, 1, 2, 2, 3])),
    "perm-duplicate-dest": (ONE_D, lambda mt: _set(_hops(mt)[0], 2,
                                                   [0, 1, 1, 1, 2, 0])),
    "perm-duplicate-src": (TWO_D, lambda mt: _set(_hops(mt)[0], 2,
                                                  [0, 1, 0, 2, 2, 0])),
}


@pytest.mark.parametrize("case", sorted(EDITS))
def test_each_code_fires_on_its_mutated_trace(case):
    name, edit = EDITS[case]
    code = case.split("@")[0]
    fs = sc.shard_consistency(_mutated(name, edit))
    assert code in _codes(fs), [str(f) for f in fs]
    bad = [f for f in fs if f.code == code]
    assert all(f.primitive.startswith("dint_mesh::") for f in bad)
    assert all("parallel/mesh.py" not in f.site and f.site for f in bad)
    # the untouched trace is clean
    assert not sc.shard_consistency(T.get_trace(name))


@pytest.mark.parametrize("name", [ONE_D, TWO_D, "dense_sharded_sb/block",
                                  "sharded/smallbank"])
def test_real_mesh_targets_are_clean(name):
    assert sc.shard_consistency(T.get_trace(name)) == []


def _drop_hops(mt):
    for n in _hops(mt):
        M._drop(mt.graph, n)


def _collapse(mt):
    for n in _hops(mt):
        shape, axes = mesh_ops.node_mesh(n)
        size = shape[axes.index(n.args[1])]
        _set(n, 2, [v for s in range(size) for v in (s, (s + 1) % size)])


def _to_ici(mt):
    _set(_hops(mt)[0], 1, "ici")


@pytest.mark.parametrize("case,name,edit,pname,code", [
    ("dropped hop", ONE_D, _drop_hops, "protocol", "no-replication-push"),
    ("collapsed perm", ONE_D, _collapse, "durability", "quorum-fanout"),
    ("hop on ici", TWO_D, _to_ici, "durability", "quorum-fanout"),
])
def test_the_hop_checks_fire_on_mutated_traces(case, name, edit, pname,
                                               code):
    fs = analysis.PASSES[pname](_mutated(name, edit))
    assert code in _codes(fs), (case, [str(f) for f in fs])
    assert code not in _codes(analysis.PASSES[pname](T.get_trace(name)))


def test_no_shard_map_twin_is_documented():
    """The reference's check-rep-disabled INFO has no twin (no shard_map
    in the port) and says so."""
    doc = sc.__doc__
    assert "check-rep-disabled" in doc and "shard_map" in doc


def broken_shard_findings():
    """The canonical broken fixture (a duplicate destination), also used
    by test_torch_dintlint's every-pass parametrization."""
    _, edit = EDITS["perm-duplicate-dest"]
    return sc.shard_consistency(_mutated(ONE_D, edit))


@pytest.mark.parametrize("perms", [
    [((0, 1), (1, 2), (2, 0)), ((0, 2), (1, 0), (2, 1))],
    [((0, 1), (1, 2), (2, 0))] * 2,
    [((0, 0), (1, 1)), ((0, 1), (1, 0))],
])
def test_quorum_destinations_equal_the_references(perms):
    """Dataflow.quorum_dests over the same perms as the reference's."""
    from dint_tpu.analysis import dataflow as rdf
    from dint_tpu_torch.analysis import dataflow as df
    mine = df.Dataflow([], [], [], {}, [], perms=[
        df.PermRec(p, "shard", ("shard",), (3,), "", ()) for p in perms])
    ref = rdf.Dataflow([], [], [], [], perms=[
        rdf.PermRec(p, "shard", "", ()) for p in perms])
    assert mine.quorum_dests() == ref.quorum_dests()
