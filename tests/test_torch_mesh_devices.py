"""The mesh over several devices, checked on the CPU (no card needed).

* (a) `parallel.mesh.placement` pinned for 1-D and (H, C) meshes over 1,
  2, 3, 4 and 8 cards, and how `Mesh` takes ``device=``/``devices=``.
* (b) The ``dint_mesh`` collectives on fake ``cuda:i`` devices
  (FakeTensorMode): each output on its receiver's device, a ``psum`` on
  the home device, a partition whose leaves sit on two devices refused;
  on the CPU their values equal the one-device forms.
* (c) The partition audit (`testing.partitions.PartitionAudit`) over
  every mesh runner and route, the mesh serving engine, the dry run and
  the recoveries: no operator but a collective takes two partitions'
  tensors; planted mixes are caught. Every runner also takes a step with
  each partition on a fake ``cuda:i`` device of its own, where a tensor
  left on another partition's device raises.
* (d) JAX's sharded states through `convert.py` land each partition on
  the device its mesh names.

This CPU build of torch has no CUDA device guard, so a fake CUDA tensor
cannot go through the Python methods that take one (indexing,
``contiguous``, ``copy_``, ``~``, ...): `FakeCudaGuards` computes those
on meta twins and hands back fakes on the tensor's device, after checking
that every CUDA tensor of the call sits on that one device. ``nonzero``
keeps every lane (a fake holds no values).
"""
import contextlib

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.overrides import TorchFunctionMode

from dint_tpu_torch import convert, entry, recovery, timing
from dint_tpu_torch.engines import tatp_dense as td
from dint_tpu_torch.ops import library, mesh_ops
from dint_tpu_torch.parallel import dense_sharded as ds
from dint_tpu_torch.parallel import dense_sharded_sb as dsb
from dint_tpu_torch.parallel import mesh as mesh_mod
from dint_tpu_torch.parallel import multihost as mh
from dint_tpu_torch.parallel import multihost_sb as mhs
from dint_tpu_torch.parallel import sharded
from dint_tpu_torch.serve import ControllerCfg, MeshServeEngine, ServiceModel
from dint_tpu_torch.serve import VirtualClock
from dint_tpu_torch.serve.arrivals import poisson_schedule
from dint_tpu_torch.tables import log as logring
from dint_tpu_torch.parallel.mesh import leaves
from dint_tpu_torch.testing.partitions import CrossPartition, PartitionAudit

D = 3
W = 16
N_SUB = D * 64
N_ACC = 300
VW = 4
LOG_CAP = 256


def cuda(i):
    return torch.device("cuda", i)


# ------------------------------------------------------- fake CUDA devices

_NO_GUARD = "not linked with support for cuda"


def _meta(t):
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                               device="meta")


def _twin(a, index=False):
    """A fake CUDA tensor's meta twin (a bool index: every lane kept)."""
    if isinstance(a, torch.Tensor) and a.device.type == "cuda":
        if index and a.dtype == torch.bool:
            assert a.dim() == 1, "a multi-dim bool mask"
            return torch.arange(a.numel(), device="meta")
        return _meta(a)
    if isinstance(a, (tuple, list)):
        return type(a)(_twin(x, index) for x in a)
    return a


def _back(r, dev):
    if isinstance(r, torch.Tensor):
        return torch.empty_strided(r.shape, r.stride(), dtype=r.dtype,
                                   device=dev)
    if isinstance(r, (tuple, list)):
        return type(r)(_back(x, dev) for x in r)
    return r


class FakeCudaGuards(TorchFunctionMode):
    """Runs, under a FakeTensorMode, the Python tensor methods that need a
    CUDA device guard (module docstring); every other call is itself.
    With a partition ``audit``, a call it computes on meta twins is
    checked and its outputs tagged as the audit does an operator's."""

    def __init__(self, audit=None):
        super().__init__()
        self.audit = audit

    def _tag(self, args, kwargs, out):
        if self.audit is None:
            return
        parts = {p for t in leaves((args, kwargs))
                 if (p := self.audit.part(t)) is not None}
        if len(parts) > 1:
            raise CrossPartition(f"tensors of partitions {sorted(parts)}")
        if parts:
            self.audit.tag(out, parts.pop())

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if func in (torch.nonzero, torch.Tensor.nonzero) \
                and args[0].device.type == "cuda":
            x = args[0]
            return torch.empty((x.numel(), x.dim()), dtype=torch.long,
                               device=x.device)
        if func in (torch.tensor, torch.as_tensor) and \
                torch.device(kwargs.get("device") or "cpu").type == "cuda":
            dev = kwargs.pop("device")
            t = func(*args, **kwargs)
            # no constant on a fake card: its values are never read
            return torch.empty(t.shape, dtype=t.dtype, device=dev)
        try:
            return func(*args, **kwargs)
        except RuntimeError as e:
            if _NO_GUARD not in str(e):
                raise
        devs = {t.device for t in leaves((args, kwargs))
                if t.device.type == "cuda"}
        if len(devs) > 1 and func not in (torch.Tensor.copy_,
                                          torch.Tensor.to):
            raise RuntimeError(f"{func.__name__}: tensors on "
                               f"{sorted(map(str, devs))}")
        x = args[0]
        dev = x.device if isinstance(x, torch.Tensor) else devs.pop()
        index = func in (torch.Tensor.__getitem__, torch.Tensor.__setitem__)
        r = func(_twin(x), *(_twin(a, index) for a in args[1:]),
                 **{k: _twin(v) for k, v in kwargs.items()})
        name = getattr(func, "__name__", "")
        if func is torch.Tensor.__setitem__:
            self._tag(args, kwargs, x)
            return None
        if (name.endswith("_") and not name.endswith("__")) \
                or name.startswith("__i"):
            self._tag(args, kwargs, x)
            return x
        out = _back(r, dev)
        self._tag(args, kwargs, out)
        return out


@pytest.fixture
def cards(monkeypatch):
    """``cards(k)``: this process sees k CUDA devices (for `Mesh`'s
    placement and `resolve_device`; no kernel runs)."""
    def see(k):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: k)
    return see


@contextlib.contextmanager
def fake_cuda(audit=None):
    """A FakeTensorMode (real CPU inputs become fakes), the guard shim and,
    when given, a partition audit over them."""
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode, FakeCudaGuards(audit), (audit or contextlib.nullcontext()):
        yield mode


def on_devices(mode, states, mesh):
    """CPU states as fakes, partition p's on ``mesh.device_of(p)``."""
    out = []
    for p, st in enumerate(states):
        ts = [mode.from_tensor(t) for t in leaves(st)]
        with mode:
            ts = [t.to(mesh.device_of(p)) for t in ts]
        out.append(mesh_mod.rebuild(st, iter(ts)))
    return out


def on_device_of(states, mesh):
    return all(t.device == mesh.device_of(p)
               for p, st in enumerate(states) for t in leaves(st))


# ------------------------------------------------------ (a) the placement

# (shape, visible cards) -> the card of each flat partition
PLACEMENTS = {
    ((3,), 1): [0, 0, 0], ((3,), 2): [0, 0, 1], ((3,), 3): [0, 1, 2],
    ((3,), 4): [0, 1, 2], ((3,), 8): [0, 1, 2],
    ((4,), 1): [0] * 4, ((4,), 2): [0, 0, 1, 1], ((4,), 3): [0, 0, 1, 2],
    ((4,), 4): [0, 1, 2, 3], ((4,), 8): [0, 1, 2, 3],
    ((3, 2), 1): [0] * 6, ((3, 2), 2): [0, 0, 0, 0, 1, 1],
    ((3, 2), 3): [0, 0, 1, 1, 2, 2], ((3, 2), 4): [0, 0, 1, 1, 2, 2],
    ((3, 2), 8): [0, 1, 2, 3, 4, 5],
    ((4, 2), 1): [0] * 8, ((4, 2), 2): [0, 0, 0, 0, 1, 1, 1, 1],
    ((4, 2), 3): [0, 0, 0, 0, 1, 1, 2, 2],
    ((4, 2), 4): [0, 0, 1, 1, 2, 2, 3, 3], ((4, 2), 8): list(range(8)),
}


@pytest.mark.parametrize("shape,k", list(PLACEMENTS))
def test_placement_is_pinned(shape, k, cards):
    want = [cuda(i) for i in PLACEMENTS[(shape, k)]]
    assert mesh_mod.placement(shape, [cuda(i) for i in range(k)]) == want
    cards(k)
    mesh = (sharded.make_mesh(*shape) if len(shape) == 1
            else mh.make_mesh_2d(*shape))
    assert list(mesh.devices) == want
    assert mesh.device == want[0]
    assert list(mesh.cards) == list(dict.fromkeys(want))
    assert [mesh.device_of(p) for p in range(mesh.size)] == want
    if len(shape) == 2 and k < mesh.size:
        # a host's chips share a card: only "dcn" crosses cards
        assert all(mesh.device_of(p) == mesh.device_of(
            mesh.shift(p, mh.ICI_AXIS, 1)) for p in range(mesh.size))


def test_mesh_takes_device_or_devices(cards):
    one = sharded.make_mesh(3, device="cpu")
    assert one.devices == (torch.device("cpu"),) * 3
    assert one.cards == (torch.device("cpu"),)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharded.make_mesh(3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mh.make_mesh_2d(3, 2, devices=[cuda(0)] * 6)
    cards(2)
    mesh = mh.make_mesh_2d(3, 2, devices=[cuda(p % 2) for p in range(6)])
    assert mesh.devices == tuple(cuda(p % 2) for p in range(6))
    assert mesh.cards == (cuda(0), cuda(1))
    assert sharded.make_mesh(3, device=cuda(1)).devices == (cuda(1),) * 3
    with pytest.raises(ValueError, match="not both"):
        sharded.make_mesh(3, device="cpu", devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="2 devices for 3"):
        sharded.make_mesh(3, devices=[cuda(0), cuda(1)])
    with pytest.raises(ValueError, match="one device type"):
        sharded.make_mesh(3, devices=["cpu", cuda(0), cuda(1)])


# --------------------------------------------------- (b) the collectives


def _a2a_one_device(xs, grid, i):
    """The exchange's one-device form: one stack, one transposed copy."""
    rows, *rest = xs[0].shape
    n = grid[i]
    x = torch.stack(list(xs)).reshape(*grid, n, rows // n, *rest)
    x = x.transpose(i, len(grid)).reshape(len(xs), rows, *rest)
    return list(x.unbind(0))


@pytest.mark.parametrize("k", [2, 3, 6])
def test_collectives_land_on_the_receivers_devices(k, cards):
    cards(k)
    mesh = mh.make_mesh_2d(3, 2)
    with fake_cuda():
        xs = [torch.zeros((12, 3), dtype=torch.int32, device=d)
              for d in mesh.devices]
        ys = [(torch.zeros(5, device=d), torch.ones(2, device=d))
              for d in mesh.devices]
        for axis in (mh.DCN_AXIS, mh.ICI_AXIS):
            for off in (1, 2):
                out = mesh.ppermute(ys, axis, off)
                assert all(t.device == mesh.device_of(p)
                           for p, o in enumerate(out) for t in o)
            out = mesh.all_to_all(xs, axis)
            assert [t.device for t in out] == list(mesh.devices)
        out = mesh.all_to_all(xs, (mh.DCN_AXIS, mh.ICI_AXIS))
        assert [t.device for t in out] == list(mesh.devices)
        assert mesh.psum(xs).device == mesh.device
        split = [(torch.zeros(5, device=d), torch.ones(2, device=cuda(0)))
                 for d in mesh.devices]
        with pytest.raises(ValueError, match="different devices"):
            mesh.ppermute(split, mh.DCN_AXIS, 1)


def test_collective_values_equal_the_one_device_forms():
    g = torch.Generator().manual_seed(5)
    mesh = mh.make_mesh_2d(3, 2, device="cpu")
    xs = [torch.randint(-9, 9, (12, 3), generator=g, dtype=torch.int32)
          for _ in range(mesh.size)]
    for axis, grid, i in ((mh.DCN_AXIS, (3, 2), 0), (mh.ICI_AXIS, (3, 2), 1),
                          ((mh.DCN_AXIS, mh.ICI_AXIS), (6,), 0)):
        got = mesh.all_to_all(xs, axis)
        want = _a2a_one_device(xs, grid, i)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    for axis in (mh.DCN_AXIS, mh.ICI_AXIS):
        for off in (1, 2):
            got = mesh.ppermute(xs, axis, off)
            assert all(torch.equal(got[p], xs[mesh.shift(p, axis, -off)])
                       for p in range(mesh.size))
            assert all(got[p].data_ptr() != xs[q].data_ptr()
                       for p in range(6) for q in range(6))
    assert torch.equal(mesh.psum(xs), torch.stack(xs).sum(0,
                                                          dtype=torch.int32))


# the placements of (a), and two a caller may name that no rule gives
EXCHANGE_PLACEMENTS = {**{f"{shape}@{k}": (shape, cards)
                          for (shape, k), cards in PLACEMENTS.items()},
                       "(3,)@0,1,0": ((3,), [0, 1, 0]),
                       "(3, 2)@0,1,1,0,0,1": ((3, 2), [0, 1, 1, 0, 0, 1])}


@pytest.mark.parametrize("name", list(EXCHANGE_PLACEMENTS))
def test_exchange_plan_gives_the_one_device_values(name):
    """`mesh_ops._exchange_plan`'s groups, each assembled as
    `_all_to_all` does (the senders' buckets [a0, a1) stacked, the
    sender's coordinate swapped with the bucket), give every receiver on
    its own device what the one-device form gives it, on every axis."""
    shape, on = EXCHANGE_PLACEMENTS[name]
    g = torch.Generator().manual_seed(7)
    size = int(np.prod(shape))
    devs = tuple(cuda(c) for c in on)
    names = ("dcn", "ici") if len(shape) == 2 else ("shard",)
    for axes in [(a,) for a in names] + ([names] if len(shape) == 2 else []):
        grid, i = mesh_ops._exchange_axis(axes, shape, names)
        n = grid[i]
        xs = [torch.randint(-99, 99, (n * 3, 2), generator=g)
              for _ in range(size)]
        got = [None] * size
        for dev, srcs, a0, a1, dests in mesh_ops._exchange_plan(devs, grid,
                                                               i):
            assert all(devs[q] == dev for q in dests)
            x = torch.stack([xs[s][a0 * 3:a1 * 3] for s in srcs])
            x = x.reshape(len(srcs) // n, n, a1 - a0, 3, 2).transpose(1, 2)
            for q, t in zip(dests, x.reshape(len(dests), n * 3, 2)):
                assert got[q] is None
                got[q] = t
        want = _a2a_one_device(xs, grid, i)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    one = mesh_ops._exchange_plan((cuda(0),) * size, grid, i)
    assert len(one) == 1 and one[0][4] == tuple(range(size))


# ------------------------------------------------ (c) the partition audit

ROUTES = {
    "tatp default": ("tatp", {}),
    "tatp fused": ("tatp", {"use_fused": True}),
    "sb default": ("sb", {}),
    "sb hot": ("sb", {"use_hotset": True}),
    "sb fused": ("sb", {"use_fused": True}),
    "sb fused+hot": ("sb", {"use_fused": True, "use_hotset": True}),
    "2d hier": ("2d", {"hierarchical": True}),
    "2d flat": ("2d", {"hierarchical": False}),
    "2d hier trace": ("2d", {"hierarchical": True, "trace": True}),
    "2d hier serve": ("2d", {"hierarchical": True, "serve": True}),
    "2d flat serve": ("2d", {"hierarchical": False, "serve": True}),
    "2d hier overlap": ("2d", {"hierarchical": True, "serve": True,
                               "overlap": True}),
    "2d flat overlap": ("2d", {"hierarchical": False, "serve": True,
                               "overlap": True}),
}


def _runner(kind, kw, mesh, cpb):
    """(states, (run, init, drain), draws for one block, drain args)."""
    if kind == "tatp":
        states = ds.create_sharded(mesh, D, N_SUB, val_words=VW,
                                   log_capacity=LOG_CAP)
        built = ds.build_sharded_pipelined_runner(
            mesh, D, N_SUB, w=W, val_words=VW, cohorts_per_block=cpb,
            monitor=True, **kw)
        draws = (torch.randint(0, 1 << 30, (cpb, D, W, 4), dtype=torch.int32,
                               generator=torch.Generator().manual_seed(1)),
                 torch.randint(0, 1 << 16, (cpb, D, W, 2), dtype=torch.int32,
                               generator=torch.Generator().manual_seed(2)))
        drain_args = (torch.zeros((2, D, W, 2), dtype=torch.int32),)
        return states, built, draws, drain_args
    d = mesh.size
    if kind == "sb":
        states = dsb.create_sharded_sb(mesh, d, N_ACC, log_capacity=LOG_CAP)
        built = dsb.build_sharded_sb_runner(
            mesh, d, N_ACC, w=W, cohorts_per_block=cpb, monitor=True,
            trace=True, **kw)
    else:
        states = mhs.create_multihost_sb(mesh, N_ACC, log_capacity=LOG_CAP)
        built = mhs.build_multihost_sb_runner(
            mesh, N_ACC, w=W, cohorts_per_block=cpb, monitor=True, **kw)
    g = torch.Generator().manual_seed(3)
    draws = (torch.randint(0, 1 << 30, (cpb, d, W, 5), dtype=torch.int32,
                           generator=g),
             torch.randint(0, 100, (cpb, d, W), dtype=torch.int32,
                           generator=g))
    if kw.get("serve"):
        shape = (*mesh.shape, cpb)
        draws += (torch.randint(0, W + 1, shape, dtype=torch.int32,
                                generator=g),
                  torch.zeros(shape, dtype=torch.int32))
    return states, built, draws, ()


def _mesh_for(kind, device=None, devices=None):
    if kind == "2d":
        return mh.make_mesh_2d(3, 2, device, devices)
    return sharded.make_mesh(D, device, devices)


@pytest.mark.parametrize("route", list(ROUTES))
def test_partition_audit_of_every_runner(route):
    kind, kw = ROUTES[route]
    mesh = _mesh_for(kind, device="cpu")
    states, (run, init, drain), draws, drain_args = _runner(kind, kw, mesh,
                                                            2)
    audit = PartitionAudit()
    carry = init(states)
    for entry_ in carry:                 # every per-partition list
        if isinstance(entry_, list):
            audit.tag_partitions(entry_)
    with audit:
        for _ in range(2):
            carry, stats = run.run_draws(carry, *draws)
        out = drain(carry, *drain_args)
    assert audit.collectives > 0 and audit.ops > 1000
    assert audit.part(stats) is None          # the psum's, on the home
    assert all(audit.part(t) == p for p, st in enumerate(out[0])
               for t in leaves(st))


@pytest.mark.parametrize("route", list(ROUTES))
def test_a_step_with_each_partition_on_a_fake_card(route, cards):
    """One block and the drain with partition p on fake ``cuda:p`` (the
    2-D mesh: host h on ``cuda:h``, its chips sharing it): every tensor of
    every partition's state stays on its card, the stats on the home."""
    kind, kw = ROUTES[route]
    cpu_mesh = _mesh_for(kind, device="cpu")
    states, _, draws, drain_args = _runner(kind, kw, cpu_mesh, 1)
    cards(3)
    mesh = _mesh_for(kind)
    assert len(mesh.cards) == 3
    with fake_cuda() as mode:
        fakes = on_devices(mode, states, mesh)
        _, (run, init, drain), _, _ = _runner(kind, kw, mesh, 1)
        carry, stats = run.run_draws(init(fakes), *draws)
        out = drain(carry, *drain_args)
    assert stats.device == mesh.device == cuda(0)
    assert on_device_of(out[0], mesh)


def test_planted_mixes_are_caught(cards, monkeypatch):
    mesh = sharded.make_mesh(D, device="cpu")
    states = dsb.create_sharded_sb(mesh, D, N_ACC, log_capacity=LOG_CAP)
    audit = PartitionAudit()
    audit.tag_partitions(states)
    with pytest.raises(CrossPartition, match=r"partitions \[0, 1\]"):
        with audit:
            states[0].bal + states[1].bal
    # an owner arbitrating another owner's requests
    orig = dsb._Phases.arbitrate
    monkeypatch.setattr(dsb._Phases, "arbitrate",
                        lambda self, st, recv, t: orig(
                            self, st, recv[1:] + recv[:1], t))
    _, (run, init, _), draws, _ = _runner("sb", {}, mesh, 1)
    carry = init(states)
    audit = PartitionAudit()
    audit.tag_partitions(carry[0])
    with pytest.raises(CrossPartition, match="gather_rows"):
        with audit:
            run.run_draws(carry, *draws)
    monkeypatch.setattr(dsb._Phases, "arbitrate", orig)
    # a partition's entry of a collective holding another's tensor
    audit = PartitionAudit()
    audit.tag_partitions(states)
    with pytest.raises(CrossPartition, match="entry 0 carries partition 1"):
        with audit:
            mesh.ppermute([states[1].bal, states[1].bal, states[2].bal],
                          sharded.SHARD_AXIS, 1)
    # draws left on the home card: partition 1 mixes cuda:0 and cuda:1
    states, _, draws, _ = _runner("tatp", {}, mesh, 1)
    cards(3)
    spread = sharded.make_mesh(D)
    monkeypatch.setattr(mesh_mod.Mesh, "to_partition", lambda s, x, p: x)
    with fake_cuda() as mode:
        fakes = on_devices(mode, states, spread)
        _, (run, init, _), _, _ = _runner("tatp", {}, spread, 1)
        carry = init(fakes)
        with pytest.raises(Exception, match="cuda:0.*cuda:1|cuda:1.*cuda:0"):
            run.run_draws(carry, *(mode.from_tensor(x).to(cuda(0))
                                   for x in draws))


def _tag_creators(monkeypatch, audit):
    """Every mesh state the dry run creates, and each routed wave's
    batches, tagged by partition; returns the list of creators called."""
    made = []

    def tagged(mod, name):
        fn = getattr(mod, name)

        def make(*a, **k):
            out = fn(*a, **k)
            made.append(name)
            if name == "route_batches":
                for wave in out[0]:
                    audit.tag_partitions(wave)
            else:
                audit.tag_partitions(out)
            return out
        monkeypatch.setattr(mod, name, make)
    for mod, name in ((sharded, "create_sharded_state"),
                      (sharded, "create_sharded_smallbank"),
                      (sharded, "route_batches"), (ds, "create_sharded"),
                      (dsb, "create_sharded_sb")):
        tagged(mod, name)
    return made


def test_partition_audit_of_the_dry_run(monkeypatch, capsys):
    audit = PartitionAudit()
    made = _tag_creators(monkeypatch, audit)
    with audit:
        entry.dryrun_multichip(D, device="cpu")
    cards, line = capsys.readouterr().out.strip().splitlines()[-2:]
    assert line.startswith(f"dryrun_multichip ok: devices={D} ")
    assert cards == "dryrun_multichip cards: cpu"
    assert audit.collectives > 0
    assert sorted(set(made)) == ["create_sharded", "create_sharded_sb",
                                 "create_sharded_smallbank",
                                 "create_sharded_state", "route_batches"]


def test_dry_run_on_fake_cards(monkeypatch, capsys, cards):
    """The dry run over three fake cards as far as a host read: its
    creators, routed batches and sharded steps place every partition on
    its own card."""
    cards(3)
    seen = []
    orig = sharded.replicated_step

    def step(mesh, shards, batches, **kw):
        shards, replies, committed = orig(mesh, shards, batches, **kw)
        seen.append((on_device_of(batches, mesh),
                     on_device_of(shards, mesh),
                     on_device_of(replies, mesh), committed.device))
        raise StopIteration      # the vote's read needs values
    monkeypatch.setattr(sharded, "replicated_step", step)
    with fake_cuda(), pytest.raises(StopIteration):
        entry.dryrun_multichip(D)
    assert seen == [(True, True, True, cuda(0))]


def test_partition_audit_of_the_mesh_serving_engine():
    eng = MeshServeEngine(N_ACC, mesh_shape=(3, 2),
                          cfg=ControllerCfg(widths=(8, W)),
                          model=ServiceModel(), cohorts_per_block=2,
                          clock=VirtualClock(), monitor=True, seed=0,
                          overlap=True, device="cpu")
    audit = PartitionAudit()
    audit.tag_partitions(eng._db)
    with audit:
        eng.run(poisson_schedule(300_000.0, 0.002, seed=3))
        eng.close()
    rep = eng.snapshot()
    assert rep["offered"] == rep["admitted"] + rep["shed"] > 0
    assert audit.collectives > 0
    assert eng.mesh.cards == (torch.device("cpu"),)


def test_partition_audit_of_the_recoveries(cards):
    """A lost partition rebuilt from another partition's ring: TATP and
    SmallBank on the host (numpy, on the CPU under the audit: no torch op
    mixes the two), and SmallBank's torch replay with the ring on fake
    ``cuda:2`` and the lost partition's base on ``cuda:1``, which copies
    the ring to ``cuda:1`` and rebuilds there."""
    mesh = sharded.make_mesh(D, device="cpu")
    states, (run, init, drain), draws, drain_args = _runner("tatp", {}, mesh,
                                                            2)
    carry, _ = run.run_draws(init(states), *draws)
    states = drain(carry, *drain_args)[0]
    dead, holder = 1, 2
    n_loc = ds.n_sub_local(N_SUB, D)
    snap = td.populate(np.random.default_rng(dead), n_loc, val_words=VW,
                       log_replicas=1, device="cpu")
    log = states[holder].db.log
    audit = PartitionAudit()
    audit.tag_partitions(states)
    audit.tag(snap, dead)
    with audit:
        rec = recovery.recover_tatp_dense(
            snap, logring.replica_entries(log, 0), log.head,
            key_hi_filter=dead + 1)
    assert torch.equal(rec.val, states[dead].db.val)
    assert torch.equal(rec.meta, states[dead].db.meta)

    sbs, (run, init, drain), draws, _ = _runner("sb", {}, mesh, 2)
    carry, _ = run.run_draws(init(sbs), *draws)
    sbs = drain(carry)[0]
    bal0 = dsb.create_sharded_sb(mesh, D, N_ACC)[dead].bal
    log = sbs[holder].log
    audit = PartitionAudit()
    audit.tag_partitions(sbs)
    audit.tag(bal0, dead)
    with audit:
        bal = recovery.recover_sb_shard(
            N_ACC, dead, D, logring.replica_entries(log, 0), log.head,
            ring_owner=holder)
    replayed = recovery.replay_sb_shard(
        bal0, logring.replica_entries(log, 0), log.head, dead=dead,
        n_shards=D)
    assert np.array_equal(bal.view(np.int32), sbs[dead].bal.numpy())
    assert torch.equal(replayed, sbs[dead].bal)

    cards(3)
    audit = PartitionAudit(transfers=True)
    with fake_cuda(audit) as mode:
        ring = mode.from_tensor(logring.replica_entries(log, 0)).to(cuda(2))
        head = mode.from_tensor(log.head).to(cuda(2))
        base = mode.from_tensor(bal0).to(cuda(1))
        audit.tag((ring, head), holder)
        audit.tag(base, dead)
        out = recovery.replay_sb_shard(base, ring, head, dead=dead,
                                       n_shards=D)
    assert out.device == cuda(1) and audit.part(out) == dead
    # the strict audit sees the ring's copy as partition 2's data
    strict = PartitionAudit()
    with fake_cuda(strict) as mode, pytest.raises(CrossPartition):
        ring = mode.from_tensor(logring.replica_entries(log, 0)).to(cuda(2))
        head = mode.from_tensor(log.head).to(cuda(2))
        base = mode.from_tensor(bal0).to(cuda(1))
        strict.tag((ring, head), holder)
        strict.tag(base, dead)
        recovery.replay_sb_shard(base, ring, head, dead=dead, n_shards=D)


# ------------------------------------------------------ (d) the converters


def test_converters_place_jax_states_on_the_mesh(cards):
    import jax  # noqa: F401 (the JAX package's runners below)
    from dint_tpu.parallel import dense_sharded as jds
    from dint_tpu.parallel import dense_sharded_sb as jdsb
    from dint_tpu.parallel import multihost_sb as jmhs
    from dint_tpu.parallel import sharded as jsh

    import test_torch_dense_sharded as tds
    import test_torch_dense_sharded_sb as tdsb
    import test_torch_multihost_sb as tmhs
    import test_torch_sharded as tsh
    from test_torch_lock_engines import assert_same

    jd = jds.create_sharded(jds.make_mesh(D), D, N_SUB, val_words=VW,
                            log_capacity=LOG_CAP)
    jsb = jdsb.create_sharded_sb(jdsb.make_mesh(D), D, N_ACC,
                                 log_capacity=LOG_CAP)
    j2d = jmhs.create_multihost_sb(jmhs.make_mesh_2d(3, 2), N_ACC,
                                   log_capacity=LOG_CAP)
    jgen = jsh.create_sharded_state(
        jsh.make_mesh(D), D, 64, val_words=VW, cf_buckets=256,
        cf_lock_slots=256, log_capacity=1 << 12)
    cases = (
        (tds.jax_state(jd), convert.sharded_state_from_numpy, (D,),
         lambda s: convert.sharded_state_to_numpy(s, (D,))),
        (tdsb.jax_state(jsb), convert.sharded_sb_from_numpy, (D,),
         convert.sharded_sb_to_numpy),
        (tmhs.jax_state(j2d), convert.multihost_sb_from_numpy, (3, 2),
         lambda s: convert.multihost_sb_to_numpy(s, (3, 2))),
        (tsh.np_tree(jgen), convert.tatp_sharded_from_numpy, (D,),
         convert.stacked_to_numpy))
    for arrays, from_np, shape, to_np in cases:
        cpu_mesh = _mesh_for("2d" if len(shape) == 2 else "1d",
                             device="cpu")
        back = from_np(arrays, mesh=cpu_mesh)
        assert on_device_of(back, cpu_mesh)
        assert_same(arrays, to_np(back))
    cards(3)
    for arrays, from_np, shape, _ in cases:
        mesh = _mesh_for("2d" if len(shape) == 2 else "1d")
        with fake_cuda():
            back = from_np(arrays, mesh=mesh)
        assert len(mesh.cards) == 3 and on_device_of(back, mesh)
    with pytest.raises(ValueError, match="2 devices for 3"):
        convert.sharded_sb_from_numpy(
            cases[1][0], mesh=mesh_mod.Mesh((2,), ("shard",), device="cpu"))


# ---------------------------------------------- the device guard, timing


def test_a_kernel_runs_under_its_tensors_device_guard(monkeypatch, cards):
    cards(2)
    entered = []

    @contextlib.contextmanager
    def guard(dev):
        entered.append(dev)
        yield
    monkeypatch.setattr(torch.cuda, "device", guard)
    kernel = library.on_tensors_card(lambda *a: "launched")
    with fake_cuda():
        on1 = torch.zeros(4, device=cuda(1))
        assert kernel([on1], [on1], [1]) == "launched"
        assert kernel(on1, 3) == "launched"
    assert entered == [cuda(1), cuda(1)]
    assert mesh_ops.is_collective(mesh_ops.op("psum").default)


def test_timing_synchronises_every_card(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    timing.synchronize([cuda(0), cuda(2)])
    timing.synchronize()
    assert synced == [cuda(0), cuda(2), None]
