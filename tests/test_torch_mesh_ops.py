"""The mesh's collectives as ``dint_mesh`` operators (ops/mesh_ops.py):
each op against the list form it replaces and against JAX's collective in
a ``shard_map`` on the 8 virtual devices, the fakes' shapes, the refusals,
and one node a hop in the trace of each mesh target, carrying its axis,
its perm and its mesh."""
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as JP

import dint_tpu.parallel  # noqa: F401 — the shard_map shim of old jax
from dint_tpu_torch.analysis import core
from dint_tpu_torch.analysis import targets as T
from dint_tpu_torch.ops import mesh_ops
from dint_tpu_torch.parallel.mesh import Mesh

SHAPES = [((3,), ("shard",)), ((3, 2), ("dcn", "ici")),
          ((4, 2), ("dcn", "ici"))]


def _parts(n, rows=8, cols=3, seed=0, dtype=torch.int32):
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(-(1 << 31), 1 << 31, (rows, cols), generator=g,
                          dtype=torch.int64).to(dtype) for _ in range(n)]


def _list_ppermute(mesh, xs, axis, off):
    """The list form the op replaced: p reads what p - off holds."""
    return [xs[mesh.shift(p, axis, -off)] for p in range(mesh.size)]


def _list_all_to_all(mesh, xs, axis):
    """The list form the op replaced (one stack, one transposed copy)."""
    rows, *rest = xs[0].shape
    if isinstance(axis, tuple):
        shape, i = (mesh.size,), 0
    else:
        shape, i = mesh.shape, mesh.axis_names.index(axis)
    n = shape[i]
    x = torch.stack(list(xs)).reshape(*shape, n, rows // n, *rest)
    x = x.transpose(i, len(shape)).reshape(mesh.size, rows, *rest)
    return list(x.unbind(0))


@dataclasses.dataclass
class _Rec:
    mask: torch.Tensor
    rows: torch.Tensor
    tag: int


# ------------------------------------------------ against the list form


@pytest.mark.parametrize("shape,axes", SHAPES)
def test_ppermute_equals_the_list_form_and_copies(shape, axes):
    mesh = Mesh(shape, axes, device="cpu")
    xs = _parts(mesh.size)
    for axis in axes:
        for off in (1, 2):
            got = mesh.ppermute(xs, axis, off)
            want = _list_ppermute(mesh, xs, axis, off)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
            # fresh tensors: a receiver never aliases its sender
            assert not {a.untyped_storage().data_ptr() for a in got} & {
                x.untyped_storage().data_ptr() for x in xs}


def test_ppermute_moves_structured_entries():
    """Tuples, dicts and dataclasses of tensors, with None and Python
    scalars riding along with the sender's entry."""
    mesh = Mesh((3,), ("shard",), device="cpu")
    xs = [(_Rec(torch.tensor([p % 2 == 0]), torch.tensor([p, p]), p),
           {"v": torch.full((2,), 10 * p), "txn": None}) for p in range(3)]
    got = mesh.ppermute(xs, "shard", 1)
    for p in range(3):
        s = (p - 1) % 3
        rec, extra = got[p]
        assert rec.tag == s and extra["txn"] is None
        assert torch.equal(rec.rows, torch.tensor([s, s]))
        assert torch.equal(extra["v"], torch.full((2,), 10 * s))
    # an entry with no tensor is a host re-index
    assert mesh.ppermute(["a", "b", "c"], "shard", 1) == ["c", "a", "b"]


def test_explicit_perm_leaves_non_destinations_zero():
    """The op takes JAX's explicit pairs: a partition that is no
    destination receives zeros."""
    xs = _parts(4, rows=2, cols=1)
    got = mesh_ops.op("ppermute")(xs, "shard", [0, 2, 1, 3], [4],
                                  ["shard"])
    assert torch.equal(got[2], xs[0]) and torch.equal(got[3], xs[1])
    assert not got[0].any() and not got[1].any()


@pytest.mark.parametrize("shape,axes", SHAPES)
def test_all_to_all_equals_the_list_form(shape, axes):
    mesh = Mesh(shape, axes, device="cpu")
    n = mesh.size
    xs = _parts(n, rows=2 * n * 3, cols=2)
    for axis in list(axes) + [tuple(axes)]:
        got = mesh.all_to_all(xs, axis)
        want = _list_all_to_all(mesh, xs, axis)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert not {a.untyped_storage().data_ptr() for a in got} & {
            x.untyped_storage().data_ptr() for x in xs}


def test_psum_equals_the_sum_and_wraps():
    mesh = Mesh((3, 2), ("dcn", "ici"), device="cpu")
    xs = _parts(6, rows=4, cols=2)
    want = torch.stack(xs).sum(0, dtype=torch.int32)
    assert torch.equal(mesh.psum(xs), want)
    big = [torch.tensor([2 ** 31 - 1], dtype=torch.int32)] * 6
    assert mesh.psum(big).tolist() == [-6]


def test_the_ops_refuse_what_does_not_fit_the_mesh():
    mesh = Mesh((3,), ("shard",), device="cpu")
    xs = _parts(3)
    with pytest.raises(ValueError):
        mesh.ppermute(xs[:2], "shard", 1)
    with pytest.raises(ValueError):
        mesh.ppermute(xs, "dcn", 1)
    with pytest.raises(ValueError):
        mesh_ops.op("ppermute")(xs, "shard", [0, 1, 1, 1], [3], ["shard"])
    with pytest.raises(ValueError):
        mesh_ops.op("ppermute")(xs, "shard", [0, 3], [3], ["shard"])
    with pytest.raises(ValueError, match="buckets"):
        mesh.all_to_all([x[:7] for x in xs], "shard")
    with pytest.raises(ValueError):
        mesh_ops.op("psum")(xs, ["dcn"], [3], ["shard"])
    with pytest.raises(ValueError):
        mesh_ops.op("all_to_all")(xs, ["dcn"], [3], ["shard"])


def test_fakes_give_the_kernels_shapes():
    mesh = Mesh((3, 2), ("dcn", "ici"), device="cpu")
    xs = [torch.empty((12, 3), dtype=torch.int32, device="meta")
          for _ in range(6)]
    bools = [torch.empty((12,), dtype=torch.bool, device="meta")
             for _ in range(6)]
    mo = mesh_ops.op
    out = mo("ppermute")(xs + bools, "dcn", [0, 1, 1, 2, 2, 0], [3, 2],
                         ["dcn", "ici"])
    real = mo("ppermute")([torch.zeros(12, 3, dtype=torch.int32)] * 6
                          + [torch.zeros(12, dtype=torch.bool)] * 6, "dcn",
                          [0, 1, 1, 2, 2, 0], [3, 2], ["dcn", "ici"])
    assert [(t.shape, t.dtype) for t in out] == \
        [(t.shape, t.dtype) for t in real]
    for axes in (["ici"], ["dcn"], ["dcn", "ici"]):
        out = mo("all_to_all")(xs, axes, [3, 2], ["dcn", "ici"])
        assert all(o.shape == (12, 3) and o.device.type == "meta"
                   for o in out)
    s = mo("psum")(xs, ["dcn", "ici"], [3, 2], ["dcn", "ici"])
    assert s.shape == (12, 3) and s.dtype == torch.int32


# ---------------------------------------------------- against JAX's ops


def _jax_mesh(shape, axes):
    devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    return JMesh(devs, axes)


def _shard_map(fn, jmesh, axes):
    spec = JP(*axes)
    return jax.jit(jax.shard_map(fn, mesh=jmesh, in_specs=spec,
                                 out_specs=spec))


@pytest.mark.parametrize("shape,axes", [((4, 2), ("dcn", "ici")),
                                        ((8,), ("shard",))])
def test_each_op_equals_jaxs_collective_on_8_devices(shape, axes):
    mesh = Mesh(shape, axes, device="cpu")
    n = mesh.size
    rows = 2 * n
    xs = _parts(n, rows=rows, cols=3, seed=3)
    stacked = torch.stack(xs).numpy()
    # the partitions' blocks laid over the mesh, one a device
    jx = jnp.asarray(stacked.reshape(*shape, rows, 3))
    jmesh = _jax_mesh(shape, axes)

    def blocks(out):
        return np.asarray(out).reshape(n, rows, 3)

    for axis in axes:
        size = shape[axes.index(axis)]
        for off in (1, 2):
            perm = [(i, (i + off) % size) for i in range(size)]
            f = _shard_map(lambda x, a=axis, p=perm: jax.lax.ppermute(
                x, a, p), jmesh, axes)
            want = blocks(f(jx))
            got = mesh.ppermute(xs, axis, off)
            assert np.array_equal(want, torch.stack(got).numpy()), \
                (axis, off)
        f = _shard_map(lambda x, a=axis, k=size: jax.lax.all_to_all(
            x.reshape(x.shape[:-2] + (k, rows // k, 3)), a,
            x.ndim - 2, x.ndim - 2, tiled=False).reshape(x.shape),
            jmesh, axes)
        want = blocks(f(jx))
        got = mesh.all_to_all(xs, axis)
        assert np.array_equal(want, torch.stack(got).numpy()), axis
    if len(axes) > 1:
        f = _shard_map(lambda x: jax.lax.all_to_all(
            x.reshape(x.shape[:-2] + (n, rows // n, 3)), axes,
            x.ndim - 2, x.ndim - 2, tiled=False).reshape(x.shape),
            jmesh, axes)
        want = blocks(f(jx))
        got = mesh.all_to_all(xs, tuple(axes))
        assert np.array_equal(want, torch.stack(got).numpy())
    f = _shard_map(lambda x: jax.lax.psum(x, axes), jmesh, axes)
    want = blocks(f(jx))[0]
    assert np.array_equal(want, mesh.psum(xs).numpy())


# ------------------------------------------------- one node a hop

# the mesh targets: (target, {(op, axes): nodes}, the ppermute offsets)
_S, _D, _I = ("shard",), ("dcn",), ("ici",)
_CPB = T.LINT.cpb
MESH_TARGETS = {
    "dense_sharded/block": {("dint_mesh::ppermute", _S): 2 * _CPB,
                            ("dint_mesh::psum", _S): _CPB},
    "dense_sharded_sb/block": {("dint_mesh::all_to_all", _S): 3 * _CPB,
                               ("dint_mesh::ppermute", _S): 2 * _CPB,
                               ("dint_mesh::psum", _S): _CPB},
    "multihost_sb/block@h3": {
        ("dint_mesh::all_to_all", _I): 3 * _CPB,
        ("dint_mesh::all_to_all", _D): 3 * _CPB,
        ("dint_mesh::ppermute", _D): 2 * _CPB,
        ("dint_mesh::psum", _D + _I): _CPB},
    "multihost_sb/block@h3+flat": {
        ("dint_mesh::all_to_all", _D + _I): 3 * _CPB,
        ("dint_mesh::ppermute", _D): 2 * _CPB,
        ("dint_mesh::psum", _D + _I): _CPB},
    "sharded/smallbank": {("dint_mesh::ppermute", _S): 2,
                          ("dint_mesh::psum", _S): 1},
}


@pytest.mark.parametrize("name", sorted(MESH_TARGETS))
def test_one_node_a_hop_in_each_mesh_target(name):
    trace = T.get_trace(name)
    nodes = [n for n in trace.graph.nodes if n.op == "call_function"
             and mesh_ops.is_collective(n.target)]
    got = collections.Counter((core.op_name(n), mesh_ops.node_axes(n))
                              for n in nodes)
    assert dict(got) == MESH_TARGETS[name]
    offs = collections.Counter()
    for n in nodes:
        shape, axes = mesh_ops.node_mesh(n)
        assert axes in (_S, _D + _I) and len(shape) == len(axes)
        if core.op_name(n) == "dint_mesh::ppermute":
            size = shape[axes.index(n.args[1])]
            perm = mesh_ops.node_perm(n)
            off = (perm[0][1] - perm[0][0]) % size
            assert perm == [(i, (i + off) % size) for i in range(size)]
            offs[off] += 1
            # each partition's record moves in the one call
            assert len(n.args[0]) % (shape[0] * (shape[1] if len(shape)
                                                  > 1 else 1)) == 0
        # the node's site is the mesh path's line, never mesh.py's
        assert "parallel/mesh.py" not in core.site_of(n)
    # the CommitBck hops: +1 and +2, once each a step
    assert offs[1] == offs[2] == sum(offs.values()) // 2
