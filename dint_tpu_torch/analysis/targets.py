"""dintlint target registry: every engine step function the port lints.

A target is a named builder that makes ONE hot-path entry point and its
state at a small geometry (`Geometry`; `LINT` by default) on real tensors
and hands both to `core.trace_target`. The state comes from the
production constructors, so its shapes cannot drift from the engines';
the carry's tensors become the graph's inputs (the state the passes seed)
and the draws come from a seeded ``torch.Generator`` inside the trace, as
the reference traces ``run(carry, key)``. A block traces
``cohorts_per_block = 3`` steps, unrolled, so the grant of step t reaches
the install of step t+2 through real dataflow.

Coverage: every target of the reference registry
(dint_tpu/analysis/targets.py) whose route the port has, with the same
name and the same protocol flags, the three ``recovery/*`` replay twins
included. Left out, by design: every ``@pallas`` variant
(``tatp_dense/block@pallas``, ``@mon+pallas``, ``@hot+pallas``,
``smallbank_dense/block@pallas``, ``@hot+pallas``,
``dense_sharded/block@pallas``, ``store/block@scan+pallas``): the port
has one route per knob, its kernels are the route (plan.py drops
``use_pallas``), so the plain targets already trace them.

At the bottom: the dintcost budget ledger (``TARGET_COST``, calibrated
from the port's own derivation, never copied from the reference's TPU
table) and the dintdur replay twins (``REPLAY_TWINS``, ``REPLAY_SPECS``).

Geometry: the mesh targets run on the port's in-process mesh
(parallel/mesh.py) on one device, with 3 partitions (3 x 2 on the 2-D
mesh; the port refuses fewer than 3 hosts), where the reference used 4
(4 x 2) of its 8 virtual devices: a partition's step traces as its own
nodes, so the graph grows with the partitions.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from .core import TargetTrace, TraceCache, trace_target


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Where and how large a target is built: the lint geometry by default
    (shapes do not change the node stream, only trace time and memory);
    chip_smoke.py also traces at full width on the card."""
    device: str = "cpu"
    n_sub: int = 32
    n_acct: int = 64
    w: int = 16
    cpb: int = 3
    vw: int = 4
    logcap: int = 128
    shards: int = 3
    hosts: int = 3
    chips: int = 2
    st_nb: int = 16      # store buckets (x 4 slots = 64 entries)
    st_smax: int = 8     # store scan_max: reply slab rows per lane
    st_dcap: int = 8     # store delta overlay capacity


LINT = Geometry()

TARGETS: dict[str, Callable[[Geometry], TargetTrace]] = {}
TARGET_DOCS: dict[str, str] = {}
# protocol flags per target (core.TargetTrace.protocol; gates the checks
# in passes/protocol.py), the reference's: "certified" = the engine closes
# the lock/validate/install loop inside the trace; "occ" = installs must
# also descend from the validate compare; "replicated" = replication must
# push AND land (not checked yet, reported as INFO); "drain" = installs
# boundary cohorts certified in the block trace; "server" = the client
# owns protocol sequencing; "elected" = lock-free writer election;
# "durable" = log rings (dintdur's wal/ring/replay checks); "replay" = a
# recovery replay twin (dintdur's column checks).
TARGET_PROTOCOL: dict[str, tuple[str, ...]] = {}
# the reference targets the port leaves out, each with its reason
EXCLUDED: dict[str, str] = {}
_PALLAS = ("the port has one route per knob and its kernels are the route "
           "(plan.py drops use_pallas); the plain target traces them")
for _n in ("tatp_dense/block@pallas", "tatp_dense/block@mon+pallas",
           "tatp_dense/block@hot+pallas", "smallbank_dense/block@pallas",
           "smallbank_dense/block@hot+pallas", "dense_sharded/block@pallas",
           "store/block@scan+pallas"):
    EXCLUDED[_n] = _PALLAS
del _n


class SkipTarget(Exception):
    """Raised by a builder whose prerequisites are absent."""


def register_target(name: str, doc: str,
                    protocol: tuple[str, ...] = ("certified",)):
    def deco(fn):
        TARGETS[name] = fn
        TARGET_DOCS[name] = doc
        TARGET_PROTOCOL[name] = tuple(protocol)
        return fn
    return deco


# ------------------------------------------------------------ the carry


def leaves(obj, path: str = "") -> list[tuple[str, torch.Tensor]]:
    """The tensors of a carry (tuples, lists, dicts, dataclasses) with
    their dotted paths, each tensor once, in a fixed order."""
    out: list = []
    seen: set = set()

    def go(o, p):
        if isinstance(o, torch.Tensor):
            if id(o) not in seen:
                seen.add(id(o))
                out.append((p, o))
        elif dataclasses.is_dataclass(o) and not isinstance(o, type):
            for f in dataclasses.fields(o):
                go(getattr(o, f.name), f"{p}.{f.name}" if p else f.name)
        elif isinstance(o, (tuple, list)):
            for i, x in enumerate(o):
                go(x, f"{p}.{i}" if p else str(i))
        elif isinstance(o, dict):
            for k, x in o.items():
                go(x, f"{p}.{k}" if p else str(k))
    go(obj, path)
    return out


def trace_call(name: str, call: Callable, state, extra=(), *,
               carry_out: Callable | None = None) -> TargetTrace:
    """Trace ``call()`` with the tensors of ``state`` (the persistent
    state) and ``extra`` (per-call inputs) as the graph's inputs. The
    tensors are the very objects ``call`` uses, so the tracer maps them
    to its placeholders. ``carry_out(result)`` picks the carry the call
    returns (default: ``result[0]``); its leaves are paired with the
    state's by path, the block-to-block feedback of the dataflow."""
    st = leaves(state)
    ex = [(f"arg{i}", t) for i, t in enumerate(extra)]
    inputs = [(p, True) for p, _ in st] + [(p, False) for p, _ in ex]
    out_paths: list = []

    def fn(*_):
        res = call()
        carry = carry_out(res) if carry_out else res[0]
        outs = leaves(carry)
        rest = [t for _, t in leaves(res)
                if all(t is not o for _, o in outs)]
        out_paths[:] = [p for p, _ in outs]
        return [t for _, t in outs] + rest

    index = {p: i for i, (p, _) in enumerate(st)}
    trace = trace_target(name, fn, [t for _, t in st] + [t for _, t in ex],
                         inputs=inputs)
    trace.carry = tuple((o, index[p]) for o, p in enumerate(out_paths)
                        if p in index)
    return trace


def _gen(g: Geometry) -> torch.Generator:
    gen = torch.Generator(device=g.device)
    gen.manual_seed(0)
    return gen


def _occ(g: Geometry, shape=None):
    """The serve plane's occupancy and shed, device i32: a full cohort
    admitted, nothing shed."""
    shape = shape or (g.cpb,)
    return (torch.full(shape, g.w, dtype=torch.int32, device=g.device),
            torch.zeros(shape, dtype=torch.int32, device=g.device))


def _runner(name, g, run, carry, serve=False, occ_shape=None):
    gen = _gen(g)
    extra = _occ(g, occ_shape) if serve else ()
    return trace_call(name, lambda: run(carry, gen, *extra), carry, extra)


# ------------------------------------------------------------ dense TATP


def _tatp_dense(name: str, g: Geometry, monitor=False, use_hotset=False,
                use_fused=False, trace=False, serve=False) -> TargetTrace:
    from ..engines import tatp_dense as td
    run, init, _ = td.build_pipelined_runner(
        g.n_sub, w=g.w, val_words=g.vw, cohorts_per_block=g.cpb,
        use_hotset=use_hotset, use_fused=use_fused, monitor=monitor,
        trace=trace, serve=serve, device=g.device)
    carry = init(td.create(g.n_sub, val_words=g.vw, log_capacity=g.logcap,
                           device=g.device))
    return _runner(name, g, run, carry, serve)


_TATP = {
    "tatp_dense/block": ("flagship dense TATP fused 3-wave pipeline "
                         "(default route: B1 gather, B2 lock)", {}),
    "tatp_dense/block@mon": ("dense TATP with the dintmon counter plane "
                             "threaded", dict(monitor=True)),
    "tatp_dense/block@hot": ("dense TATP with the hot row-prefix partition "
                             "(B6 gather, B7 write-through install)",
                             dict(use_hotset=True)),
    "tatp_dense/block@fused": ("dense TATP on the fused route: B4 "
                               "lock+validate and B3 install+log, one "
                               "launch each", dict(use_fused=True)),
    "tatp_dense/block@fused+hot": ("dense TATP: fused route over the hot "
                                   "partition (the mirrors as extra B3 "
                                   "streams)",
                                   dict(use_fused=True, use_hotset=True)),
    "tatp_dense/block@fused+mon": ("dense TATP: fused route + counter "
                                   "plane", dict(use_fused=True,
                                                 monitor=True)),
    "tatp_dense/block@trace": ("dense TATP with the dinttrace flight-"
                               "recorder ring, full rate",
                               dict(trace=True)),
    "tatp_dense/serve": ("dense TATP serve-mode block: the "
                         "variable-occupancy mask", dict(serve=True)),
    "tatp_dense/serve@mon": ("dense TATP serve-mode block with the counter "
                             "plane: occupancy/padded/shed lanes",
                             dict(serve=True, monitor=True)),
}


def _reg_tatp(name, doc, kw):
    @register_target(name, doc, protocol=("certified", "occ", "durable"))
    def _t(g: Geometry = LINT) -> TargetTrace:
        return _tatp_dense(name, g, **kw)


for _name, (_doc, _kw) in _TATP.items():
    _reg_tatp(_name, _doc, _kw)


@register_target("tatp_dense/drain",
                 "dense TATP pipeline drain (the two gen_new=False tail "
                 "steps)", protocol=("drain", "durable"))
def _t_tatp_dense_drain(g: Geometry = LINT) -> TargetTrace:
    from ..engines import tatp_dense as td
    _, init, drain = td.build_pipelined_runner(
        g.n_sub, w=g.w, val_words=g.vw, cohorts_per_block=g.cpb,
        device=g.device)
    carry = init(td.create(g.n_sub, val_words=g.vw, log_capacity=g.logcap,
                           device=g.device))
    return trace_call("tatp_dense/drain", lambda: drain(carry), carry)


# ------------------------------------------------------- dense SmallBank


def _sb_dense(name: str, g: Geometry, monitor=False, use_hotset=False,
              use_fused=False, trace=False, serve=False) -> TargetTrace:
    from ..engines import smallbank_dense as sd
    run, init, _ = sd.build_pipelined_runner(
        g.n_acct, w=g.w, cohorts_per_block=g.cpb, use_hotset=use_hotset,
        use_fused=use_fused, monitor=monitor, trace=trace, serve=serve,
        device=g.device)
    # the runner's own init, so the @hot variants get their mirrors
    # attached as production does
    carry = init(sd.create(g.n_acct, log_capacity=g.logcap,
                           device=g.device))
    return _runner(name, g, run, carry, serve)


_SB = {
    "smallbank_dense/block": ("dense SmallBank fused 2-wave pipeline "
                              "(default route)", {}),
    "smallbank_dense/block@mon": ("dense SmallBank with the counter plane",
                                  dict(monitor=True)),
    "smallbank_dense/block@hot": ("dense SmallBank with the hot partition: "
                                  "lock-dominates-write through the "
                                  "write-through install",
                                  dict(use_hotset=True)),
    "smallbank_dense/block@hot+mon": ("dense SmallBank: hot partition + "
                                      "counter plane",
                                      dict(use_hotset=True, monitor=True)),
    "smallbank_dense/block@fused": ("dense SmallBank on the fused route: "
                                    "B5 gather streams, B3 install + log",
                                    dict(use_fused=True)),
    "smallbank_dense/block@fused+hot": ("dense SmallBank: fused route + "
                                        "hot mirror as a B3 stream",
                                        dict(use_fused=True,
                                             use_hotset=True)),
    "smallbank_dense/block@fused+mon": ("dense SmallBank: fused route + "
                                        "counter plane",
                                        dict(use_fused=True, monitor=True)),
    "smallbank_dense/block@trace": ("dense SmallBank with the dinttrace "
                                    "ring, full rate", dict(trace=True)),
    "smallbank_dense/serve": ("dense SmallBank serve-mode block",
                              dict(serve=True)),
    "smallbank_dense/serve@mon": ("dense SmallBank serve-mode block with "
                                  "the counter plane",
                                  dict(serve=True, monitor=True)),
}


def _reg_sb(name, doc, kw):
    @register_target(name, doc, protocol=("certified", "durable"))
    def _t(g: Geometry = LINT) -> TargetTrace:
        return _sb_dense(name, g, **kw)


for _name, (_doc, _kw) in _SB.items():
    _reg_sb(_name, _doc, _kw)


# ---------------------------------------------------- generic pipelines


def _tatp_pipeline(name: str, g: Geometry, monitor=False) -> TargetTrace:
    from ..engines import tatp
    from ..engines import tatp_pipeline as tp
    run, init, _ = tp.build_pipelined_runner(
        g.n_sub, w=g.w, val_words=g.vw, cohorts_per_block=g.cpb,
        monitor=monitor, device=g.device)
    carry = init(tp.stack_shards(
        [tatp.create(g.n_sub, val_words=g.vw, cf_buckets=256,
                     cf_lock_slots=256, log_capacity=g.logcap,
                     device=g.device) for _ in range(tp.N_SHARDS)]))
    return _runner(name, g, run, carry)


@register_target("tatp_pipeline/block",
                 "generic (sort-based) fused TATP pipeline",
                 protocol=("certified", "occ"))
def _t_tatp_pipeline(g: Geometry = LINT) -> TargetTrace:
    return _tatp_pipeline("tatp_pipeline/block", g)


@register_target("tatp_pipeline/block@mon",
                 "generic TATP pipeline with the counter plane threaded",
                 protocol=("certified", "occ"))
def _t_tatp_pipeline_mon(g: Geometry = LINT) -> TargetTrace:
    return _tatp_pipeline("tatp_pipeline/block@mon", g, monitor=True)


def _sb_pipeline(name: str, g: Geometry, monitor=False) -> TargetTrace:
    from .. import monitor as mn
    from ..engines import smallbank_pipeline as sp
    run = sp.build_runner(g.n_acct, w=g.w, cohorts_per_block=g.cpb,
                          monitor=monitor, device=g.device)
    stacked = sp.create_stacked(g.n_acct, log_capacity=g.logcap,
                                device=g.device)
    carry = (stacked, mn.create(g.device)) if monitor else stacked
    gen = _gen(g)
    return trace_call(name, lambda: run(carry, gen), carry)


@register_target("smallbank_pipeline/block",
                 "generic (sort-based) fused SmallBank pipeline",
                 protocol=("certified",))
def _t_sb_pipeline(g: Geometry = LINT) -> TargetTrace:
    return _sb_pipeline("smallbank_pipeline/block", g)


@register_target("smallbank_pipeline/block@mon",
                 "generic SmallBank pipeline with the counter plane",
                 protocol=("certified",))
def _t_sb_pipeline_mon(g: Geometry = LINT) -> TargetTrace:
    return _sb_pipeline("smallbank_pipeline/block@mon", g, monitor=True)


# ------------------------------------------------------- generic sharded


def _generic_sharded(name: str, g: Geometry, engine: str) -> TargetTrace:
    from ..engines.types import Op
    from ..parallel import sharded
    d = g.shards
    mesh = sharded.make_mesh(d, g.device)
    if engine == "tatp":
        from ..engines import tatp
        state = sharded.create_sharded_state(
            mesh, d, g.n_sub, val_words=g.vw, cf_buckets=256,
            cf_lock_slots=256, log_capacity=g.logcap)
        tbl, vw = tatp.SUBSCRIBER, g.vw
    else:
        from ..engines import smallbank
        state = sharded.create_sharded_smallbank(
            mesh, d, g.n_acct, val_words=2, log_capacity=g.logcap)
        tbl, vw = smallbank.SAVINGS, 2
    step = sharded.build_sharded_step(mesh, d, engine=engine)
    m = 8
    keys = np.arange(1, m + 1, dtype=np.int64)
    ops = np.full(m, Op.OCC_LOCK, np.int32)
    tbls = np.full(m, tbl, np.int32)
    (batches,), _ = sharded.route_batches(ops, tbls, keys, None, None, d, m,
                                          vw, device=g.device)
    return trace_call(name, lambda: step(state, batches), state,
                      [t for _, t in leaves(batches)])


@register_target("sharded/tatp",
                 "generic replicated TATP shard step (3 roles a partition)",
                 protocol=("server", "replicated"))
def _t_sharded_tatp(g: Geometry = LINT) -> TargetTrace:
    return _generic_sharded("sharded/tatp", g, "tatp")


@register_target("sharded/smallbank",
                 "generic replicated SmallBank shard step",
                 protocol=("server", "replicated"))
def _t_sharded_sb(g: Geometry = LINT) -> TargetTrace:
    return _generic_sharded("sharded/smallbank", g, "smallbank")


# --------------------------------------------------- dense mesh runners


def _dense_sharded(name: str, g: Geometry, monitor=False,
                   use_fused=False) -> TargetTrace:
    from ..parallel import dense_sharded as ds
    from ..parallel import sharded
    d = g.shards
    mesh = sharded.make_mesh(d, g.device)
    run, init, _ = ds.build_sharded_pipelined_runner(
        mesh, d, g.n_sub * d, w=g.w, val_words=g.vw,
        cohorts_per_block=g.cpb, use_fused=use_fused, monitor=monitor)
    carry = init(ds.create_sharded(mesh, d, g.n_sub * d, val_words=g.vw,
                                   log_capacity=g.logcap))
    return _runner(name, g, run, carry)


_DS = {
    "dense_sharded/block": ("mesh dense TATP: pipeline + CommitBck "
                            "fan-out to the backups", {}),
    "dense_sharded/block@mon": ("mesh dense TATP with per-partition "
                                "counter planes", dict(monitor=True)),
    "dense_sharded/block@fused": ("mesh dense TATP on the fused route",
                                  dict(use_fused=True)),
    "dense_sharded/block@fused+mon": ("mesh dense TATP: fused route + "
                                      "counter planes",
                                      dict(use_fused=True, monitor=True)),
}


def _reg_ds(name, doc, kw):
    @register_target(name, doc, protocol=("certified", "occ", "replicated",
                                          "durable"))
    def _t(g: Geometry = LINT) -> TargetTrace:
        return _dense_sharded(name, g, **kw)


for _name, (_doc, _kw) in _DS.items():
    _reg_ds(_name, _doc, _kw)


def _dense_sharded_sb(name: str, g: Geometry, monitor=False,
                      use_hotset=False, use_fused=False,
                      trace=False) -> TargetTrace:
    from ..parallel import dense_sharded_sb as dsb
    from ..parallel import sharded
    d = g.shards
    mesh = sharded.make_mesh(d, g.device)
    run, init, _ = dsb.build_sharded_sb_runner(
        mesh, d, g.n_acct * d, w=g.w, cohorts_per_block=g.cpb,
        use_hotset=use_hotset, use_fused=use_fused, monitor=monitor,
        trace=trace)
    carry = init(dsb.create_sharded_sb(mesh, d, g.n_acct * d,
                                       log_capacity=g.logcap * 8))
    return _runner(name, g, run, carry)


_DSB = {
    "dense_sharded_sb/block": ("mesh dense SmallBank: owner-routed step "
                               "over all_to_all", {}),
    "dense_sharded_sb/block@mon": ("mesh dense SmallBank with "
                                   "per-partition counter planes",
                                   dict(monitor=True)),
    "dense_sharded_sb/block@hot": ("mesh dense SmallBank with "
                                   "per-partition hot mirrors",
                                   dict(use_hotset=True)),
    "dense_sharded_sb/block@fused": ("mesh dense SmallBank on the fused "
                                     "route", dict(use_fused=True)),
    "dense_sharded_sb/block@fused+hot": ("mesh dense SmallBank: fused "
                                         "route + hot mirrors",
                                         dict(use_fused=True,
                                              use_hotset=True)),
    "dense_sharded_sb/block@fused+mon": ("mesh dense SmallBank: fused "
                                         "route + counter planes",
                                         dict(use_fused=True,
                                              monitor=True)),
    "dense_sharded_sb/block@trace": ("mesh dense SmallBank with the "
                                     "dinttrace ring", dict(trace=True)),
}


def _reg_dsb(name, doc, kw):
    @register_target(name, doc, protocol=("certified", "replicated",
                                          "durable"))
    def _t(g: Geometry = LINT) -> TargetTrace:
        return _dense_sharded_sb(name, g, **kw)


for _name, (_doc, _kw) in _DSB.items():
    _reg_dsb(_name, _doc, _kw)


def _multihost_sb(name: str, g: Geometry, hierarchical=True, monitor=False,
                  trace=False, serve=False, overlap=False) -> TargetTrace:
    from ..parallel import multihost_sb as mhs
    mesh = mhs.make_mesh_2d(g.hosts, g.chips, g.device)
    d = g.hosts * g.chips
    run, init, _ = mhs.build_multihost_sb_runner(
        mesh, g.n_acct * d, w=g.w, cohorts_per_block=g.cpb,
        hierarchical=hierarchical, monitor=monitor, trace=trace,
        serve=serve, overlap=overlap)
    carry = init(mhs.create_multihost_sb(mesh, g.n_acct * d,
                                         log_capacity=g.logcap * 8))
    return _runner(name, g, run, carry, serve,
                   occ_shape=(g.hosts, g.chips, g.cpb))


_MHSB = {
    "multihost_sb/block": ("2-D mesh SmallBank: hierarchical (ici-then-dcn) "
                           "routing, host fault-domain replication", {}),
    "multihost_sb/block@flat": ("2-D mesh SmallBank with the flat "
                                "all_to_all", dict(hierarchical=False)),
    "multihost_sb/block@mon": ("2-D mesh SmallBank with the counter plane "
                               "(the route_ici/route_dcn split)",
                               dict(monitor=True)),
    "multihost_sb/block@h3": ("2-D mesh SmallBank at the reference's "
                              "3-machine shape (3 x 2)", {}),
    "multihost_sb/block@h3+flat": ("3 x 2 mesh SmallBank with the flat "
                                   "all_to_all", dict(hierarchical=False)),
    "multihost_sb/block@trace": ("2-D mesh SmallBank with the dinttrace "
                                 "ring", dict(trace=True)),
    "multihost_sb/serve": ("2-D mesh SmallBank serve-mode block",
                           dict(serve=True)),
    "multihost_sb/serve@flat": ("2-D mesh SmallBank serve-mode block, flat "
                                "all_to_all",
                                dict(serve=True, hierarchical=False)),
    "multihost_sb/serve@mon": ("2-D mesh SmallBank serve-mode block with "
                               "the counter plane",
                               dict(serve=True, monitor=True)),
    "multihost_sb/serve@overlap": ("2-D mesh SmallBank serve-mode block, "
                                   "double-buffered exchange",
                                   dict(serve=True, overlap=True)),
    "multihost_sb/serve@overlap+mon": ("2-D mesh SmallBank overlap serve "
                                       "block with the counter plane",
                                       dict(serve=True, overlap=True,
                                            monitor=True)),
}


def _reg_mhsb(name, doc, kw):
    @register_target(name, doc, protocol=("certified", "replicated",
                                          "durable"))
    def _t(g: Geometry = LINT) -> TargetTrace:
        return _multihost_sb(name, g, **kw)


for _name, (_doc, _kw) in _MHSB.items():
    _reg_mhsb(_name, _doc, _kw)


@register_target("multihost/block",
                 "2-D mesh dense TATP: partition-local pipeline + dcn-axis "
                 "CommitBck/CommitLog fan-out (host fault domains)",
                 protocol=("certified", "occ", "replicated", "durable"))
def _t_multihost(g: Geometry = LINT) -> TargetTrace:
    from ..parallel import multihost as mhost
    mesh = mhost.make_mesh_2d(g.hosts, g.chips, g.device)
    d = g.hosts * g.chips
    run, init, _ = mhost.build_multihost_runner(
        mesh, g.n_sub * d, w=g.w, val_words=g.vw, cohorts_per_block=g.cpb)
    carry = init(mhost.create_multihost(mesh, g.n_sub * d, val_words=g.vw,
                                        log_capacity=g.logcap))
    return _runner("multihost/block", g, run, carry)


# ----------------------------------------------------------------- store


def _store_runner(name: str, g: Geometry, use_scan: bool, monitor=False,
                  serve=False) -> TargetTrace:
    from ..engines import store
    from ..tables import kv
    run, init, _ = store.build_serve_runner(
        g.n_acct, w=g.w, cohorts_per_block=g.cpb, val_words=g.vw,
        scan_frac=0.5 if use_scan else 0.0, max_scan_len=g.st_smax,
        scan_max=g.st_smax, delta_cap=g.st_dcap, use_scan=use_scan,
        monitor=monitor, serve=serve, device=g.device)
    carry = init(kv.create(g.st_nb, val_words=g.vw, device=g.device))
    return _runner(name, g, run, carry, serve)


_STORE = {
    "store/block": ("KV store block, point ops only (GET/SET mix)",
                    dict(use_scan=False)),
    "store/block@scan": ("KV store block with the ordered-run scan path: "
                         "locate + B8 window gather + run/delta merge",
                         dict(use_scan=True)),
    "store/serve@scan": ("KV store serve-mode block over the scan-enabled "
                         "step", dict(use_scan=True, serve=True)),
    "store/serve@scan+mon": ("KV store serve-mode block with the counter "
                             "plane", dict(use_scan=True, serve=True,
                                           monitor=True)),
}


def _reg_store(name, doc, kw):
    @register_target(name, doc, protocol=("server", "elected"))
    def _t(g: Geometry = LINT) -> TargetTrace:
        return _store_runner(name, g, **kw)


for _name, (_doc, _kw) in _STORE.items():
    _reg_store(_name, _doc, _kw)
del _name, _doc, _kw


@register_target("store/rebuild@scan",
                 "drain-boundary merge-compact: the delta overlay folded "
                 "back into the dense sorted run",
                 # no 'elected': the maintenance compact alone, no step
                 # loop, so no election or installs to pin
                 protocol=("server",))
def _t_store_rebuild(g: Geometry = LINT) -> TargetTrace:
    from ..engines import store
    from ..tables import kv
    from ..tables import run as run_mod
    table = kv.create(g.st_nb, val_words=g.vw, device=g.device)
    runv = run_mod.from_table(kv.create(g.st_nb, val_words=g.vw,
                                        device=g.device),
                              delta_cap=g.st_dcap)
    state = (table, runv)
    return trace_call("store/rebuild@scan",
                      lambda: (store.rebuild_run(table, runv),), state,
                      carry_out=lambda res: res[0])


# ---------------------------------------------- recovery replay targets
# The torch replay twins of recovery.py's numpy paths (the same winner-
# per-row rule), traced over a ring of the engine's layout so that
# dintdur's replay-coverage check can compare what the engines install
# with what replay rebuilds, and which entry columns replay reads with the
# layout the engines write. The 'replay' flag gates the replay-side
# checks of passes/durability.py.

# engine target -> its replay twin: the twin's entries-derived outputs
# must cover every table class the engine installs
REPLAY_TWINS: dict[str, str] = {
    "tatp_dense/block": "recovery/tatp_dense",
    "smallbank_dense/block": "recovery/smallbank_dense",
}
# the entry layout of each replay target at the lint geometry:
# ``val_words`` is the populated value-word count (columns [HDR,
# HDR+val_words) of the ring; the engines write nothing past it)
REPLAY_SPECS: dict[str, dict] = {
    "recovery/tatp_dense": dict(val_words=LINT.vw),
    "recovery/smallbank_dense": dict(val_words=2),
    "recovery/sb_shard": dict(val_words=2),
}


def _ring(g: Geometry, lanes: int, val_words: int):
    """An empty ring of the engines' layout [L, CAP, HDR+VW] and its
    heads, on the geometry's device."""
    from ..tables.log import HDR_WORDS
    return (torch.zeros((lanes, g.logcap, HDR_WORDS + val_words),
                        dtype=torch.int32, device=g.device),
            torch.zeros((lanes,), dtype=torch.int32, device=g.device))


def _replay(name: str, fn, db0, entries, heads) -> TargetTrace:
    state = (db0, entries, heads)
    return trace_call(name, lambda: (fn(db0, entries, heads),), state,
                      carry_out=lambda res: ())


@register_target("recovery/tatp_dense",
                 "replay twin of recovery.recover_tatp_dense: val and meta "
                 "rebuilt from one surviving replica ring",
                 protocol=("replay",))
def _t_recovery_tatp(g: Geometry = LINT) -> TargetTrace:
    from .. import recovery
    from ..engines import tatp_dense as td
    db0 = td.create(g.n_sub, val_words=g.vw, log_capacity=g.logcap,
                    device=g.device)
    entries, heads = _ring(g, db0.log.lanes, g.vw)
    return _replay("recovery/tatp_dense", recovery.replay_tatp_dense, db0,
                   entries, heads)


@register_target("recovery/smallbank_dense",
                 "replay twin of recovery.recover_smallbank_dense: "
                 "balances and the resumed step",
                 protocol=("replay",))
def _t_recovery_sb(g: Geometry = LINT) -> TargetTrace:
    from .. import recovery
    from ..engines import smallbank_dense as sd
    db0 = sd.create(g.n_acct, log_capacity=g.logcap, device=g.device)
    entries, heads = _ring(g, db0.log.lanes, recovery.SB_VW)
    return _replay("recovery/smallbank_dense",
                   recovery.replay_smallbank_dense, db0, entries, heads)


@register_target("recovery/sb_shard",
                 "replay twin of recovery.recover_sb_shard: a lost "
                 "partition's balances from any one ring of its stream",
                 protocol=("replay",))
def _t_recovery_sb_shard(g: Geometry = LINT) -> TargetTrace:
    import functools

    from .. import recovery
    from ..parallel.dense_sharded_sb import m1_local
    d = g.shards
    bal0 = torch.full((m1_local(g.n_acct * d, d),), 1000, dtype=torch.int32,
                      device=g.device)
    bal0[-1] = 0
    entries, heads = _ring(g, 16, recovery.SB_VW)
    fn = functools.partial(recovery.replay_sb_shard, dead=1, n_shards=d)
    return _replay("recovery/sb_shard", lambda b, e, h: fn(b, e, h), bal0,
                   entries, heads)


# ------------------------------------------------- mesh twins (dintcost)
# hierarchical 2-D targets -> their flat-exchange twin, and the overlap
# serve targets -> their unoverlapped twin. The reference holds them to
# link bytes (hier-dcn-dominance, overlap-dcn-parity), which the port's
# traces cannot show yet (parallel/mesh.py moves a list, ROADMAP §A.8.5):
# passes/cost_budget.py reports each as link-bytes-unchecked and checks
# the overlap carry's footprint.
TARGET_FLAT_TWIN: dict[str, str] = {
    "multihost_sb/serve": "multihost_sb/serve@flat",
    "multihost_sb/serve@mon": "multihost_sb/serve@flat",
    "multihost_sb/serve@overlap": "multihost_sb/serve@flat",
}
TARGET_OVERLAP_TWIN: dict[str, str] = {
    "multihost_sb/serve@overlap": "multihost_sb/serve",
    "multihost_sb/serve@overlap+mon": "multihost_sb/serve@mon",
}
# @scan store targets -> their point-op twin: scan rows must arrive
# cheaper than probe replies (cost_budget's scan-bytes-dominance)
TARGET_SCAN_TWIN: dict[str, str] = {
    "store/block@scan": "store/block",
    "store/serve@scan": "store/block",
}


# -------------------------------------------------- static cost budgets
#
# The dintcost ledger (analysis/cost.py, gated by passes/cost_budget.py),
# calibrated from the PORT's own derivation at the lint geometry
# (`python -m dint_tpu_torch.dintcost report <target>`), never copied
# from the reference's table: the port's routes merge and split launches
# differently (ROADMAP §C.14), and its mesh traces every partition. The
# geometry pins the constants the waves.py formulas assume (TATP K = 4;
# SmallBank L = 3, VW = 2; d the mesh's partitions, 3 or 3 x 2 where the
# reference used 4 and 4 x 2). Dispatches and footprint are exact
# ceilings (ANY extra dispatch or copied table regresses them); bytes
# allow 25% over the declared waves.py ledger, the band reconciliation
# uses. Where no wave carries a formula the trace can price (the generic
# pipelines and shards, the store's point route, the replay twins, and
# the mesh targets, whose routes and replication are collectives no
# trace shows), the bytes budget is an absolute ceiling 5% over the
# calibrated trace. Recalibrate with the report and justify the diff;
# silence a reviewed exception through the allowlist.

_TD_GEOM = dict(w=LINT.w, k=4, vw=LINT.vw)
_SB_GEOM = dict(w=LINT.w, l=3, vw=2)
_DS_GEOM = dict(w=LINT.w, k=4, vw=LINT.vw, d=LINT.shards)
_DSB_GEOM = dict(w=LINT.w, l=3, vw=2, d=LINT.shards)
# the 2-D mesh: d is the GLOBAL partition count hosts x chips
_MHSB_GEOM = dict(w=LINT.w, l=3, vw=2, d=LINT.hosts * LINT.chips,
                  h=LINT.hosts)
_MH_GEOM = dict(w=LINT.w, k=4, vw=LINT.vw, d=LINT.hosts * LINT.chips,
                h=LINT.hosts)
# lg = locate rounds = bit_length(cap = 16 buckets x 4 slots = 64) = 7
_ST_GEOM = dict(w=LINT.w, vw=LINT.vw, sl=LINT.st_smax, dc=LINT.st_dcap,
                lg=7)

# wave_expect: documented layout deviations of the port from the base
# formula (a number scales it, a string replaces it).
#
# TATP's meta and magic gathers are one launch (B1, or B6 on the hot
# route) in `meta_gather` on the unfused routes (ROADMAP §C.14), so the
# wave moves both; `magic_gather` prices nothing there.
_META_TD = {"dint.tatp_dense.meta_gather": "2*w*k*4 + w*k*4"}
# The monitored routes read the held stamps (one more arb pass, an
# `index_select`) before the lock kernel: 4 passes, not 3.
_MON_TD = {**_META_TD, "dint.tatp_dense.lock": "4*2*w*4"}
# B7 writes each install stream to the table and to its hot mirror: the
# table pass and the mirror pass (the reference's XLA hot route prices
# the same two masked passes).
_HOT_TD = {**_META_TD, "dint.tatp_dense.install": 2.0}
# SmallBank's held-stamp gathers of the lock wave ride `read`'s launch
# (x_step, s_step and bal: one B1 or B6 call, ROADMAP §C.14), so `read`
# moves three streams and `lock` keeps the two grant-stamp installs (its
# per-slot scatter-mins write fresh arrays, not state, as the
# reference's do).
_READ_SB = {"dint.smallbank_dense.read": "3*w*l*4",
            "dint.smallbank_dense.lock": "2*w*l*4"}
_HOT_SB = {"dint.smallbank_dense.read": "3*w*l*4",
           "dint.smallbank_dense.install": 2.0}
# The in-process mesh traces every partition's step: a mesh target's
# waves move d times the per-device formula. The 1-D TATP mesh appends
# ONE local log replica a partition (the other two ride replicate's
# hops), as the reference's _DS_EXPECT documents.
_DS = {"dint.tatp_dense.install": "d*2*w*(4 + 4*vw)",
       "dint.tatp_dense.lock": "d*3*2*w*4",
       "dint.tatp_dense.meta_gather": "d*(2*w*k*4 + w*k*4)",
       "dint.tatp_dense.log_append": "d*2*w*(20 + 4*vw)"}
_DS_MON = {**_DS, "dint.tatp_dense.lock": "d*4*2*w*4"}
_DS_FUSED = {"dint.tatp_dense.install_log":
             "d*(2*w*(4 + 4*vw) + 2*w*(20 + 4*vw))",
             "dint.tatp_dense.lock_validate": "d*(3*2*w*4 + 2*w*k*4)",
             "dint.tatp_dense.magic_gather": "d*w*k*4"}
_DS_FUSED_MON = {**_DS_FUSED, "dint.tatp_dense.lock_validate":
                 "d*(4*2*w*4 + 2*w*k*4)"}
# Sharded SmallBank's owners: d partitions of the 5-pass arbitration;
# the hot route also stamps the mirrors (7 passes). The fused owner
# install and its one-replica CommitLog append run over all 2wL routed
# slots (the reference's formula counts wL lanes and three replicas),
# with the log head read; the hot mirror is one more stream.
_DSB = {"dint.dense_sharded_sb.arbitrate": "d*5*2*w*l*4"}
_DSB_HOT = {"dint.dense_sharded_sb.arbitrate": "d*7*2*w*l*4"}
_DSB_LOG = "2*w*l*4 + 2*w*l*4 + 2*w*l*(16 + 4*vw)"
_DSB_FUSED = {"dint.dense_sharded_sb.lock_validate": "d*5*2*w*l*4",
              "dint.dense_sharded_sb.install_log": f"d*({_DSB_LOG})"}
_DSB_FUSED_HOT = {"dint.dense_sharded_sb.lock_validate": "d*7*2*w*l*4",
                  "dint.dense_sharded_sb.install_log":
                  f"d*(2*w*l*4 + {_DSB_LOG})"}
_DSB_TRACE = {**_DSB, "dint.dense_sharded_sb.trace": "d*16*(9*w*l + 2*w)"}
_MHSB = {"dint.multihost_sb.arbitrate": "d*5*2*w*l*4"}
_MHSB_TRACE = {**_MHSB, "dint.multihost_sb.trace": "d*16*(9*w*l + 2*w)"}

# the overlap serve route's in-flight cohort a partition: its draws
# (bits [w, 5] and ts_amt [w]), its occupancy, and the two exchanged
# fields over the d*cap routed slots (cap = 2*ceil(w*l/d)), i32; the
# trace holds it twice (carried in and carried out)
OVERLAP_FOOTPRINT = "2*d*(4*(6*w + 1) + 8*d*(2*((w*l+d-1)//d)))"


def _cost(geom, dispatches, footprint, *, steps=float(LINT.cpb),
          bytes_budget="1.25*ledger", wave_expect=None):
    return dict(steps=float(steps), geom=dict(geom),
                wave_expect=dict(wave_expect or {}),
                budget=dict(dispatches=dispatches, bytes=bytes_budget,
                            footprint=footprint))


TARGET_COST: dict[str, dict] = {
    # dense TATP: 6 dispatches/step on the default route (install x2, the
    # log's head read and append, B1, B2) -> 5 hot (B7 writes both
    # tables) -> 4 fused (the head read, B3, B4, B1's magic read)
    "tatp_dense/block": _cost(_TD_GEOM, 6, 220864, wave_expect=_META_TD),
    "tatp_dense/block@mon": _cost(_TD_GEOM, 11, 221156,
                                  wave_expect=_MON_TD),
    "tatp_dense/block@hot": _cost(_TD_GEOM, 5, 220884,
                                  wave_expect=_HOT_TD),
    "tatp_dense/block@fused": _cost(_TD_GEOM, 4, 220352),
    "tatp_dense/block@fused+hot": _cost(_TD_GEOM, 4, 220372),
    "tatp_dense/block@fused+mon": _cost(_TD_GEOM, 9, 220652),
    "tatp_dense/block@trace": _cost(_TD_GEOM, 8, 231108,
                                    wave_expect=_MON_TD),
    "tatp_dense/serve": _cost(_TD_GEOM, 6, 220888, wave_expect=_META_TD),
    "tatp_dense/serve@mon": _cost(_TD_GEOM, 11, 221204,
                                  wave_expect=_MON_TD),
    # the drain: the two gen_new=False tail steps
    "tatp_dense/drain": _cost(_TD_GEOM, 6, 216896, steps=2.0,
                              wave_expect=_META_TD),
    # dense SmallBank: 6 -> 5 fused (B5 + B3 for B1, the install and the
    # log's append)
    "smallbank_dense/block": _cost(_SB_GEOM, 6, 151900,
                                   wave_expect=_READ_SB),
    "smallbank_dense/block@mon": _cost(_SB_GEOM, 10, 152168,
                                       wave_expect=_READ_SB),
    "smallbank_dense/block@hot": _cost(_SB_GEOM, 8, 151948,
                                       wave_expect=_HOT_SB),
    "smallbank_dense/block@hot+mon": _cost(_SB_GEOM, 12, 152240,
                                           wave_expect=_HOT_SB),
    "smallbank_dense/block@fused": _cost(_SB_GEOM, 5, 151900),
    "smallbank_dense/block@fused+hot": _cost(_SB_GEOM, 7, 151948),
    "smallbank_dense/block@fused+mon": _cost(_SB_GEOM, 9, 152176),
    "smallbank_dense/block@trace": _cost(_SB_GEOM, 7, 159072,
                                         wave_expect=_READ_SB),
    "smallbank_dense/serve": _cost(_SB_GEOM, 6, 151924,
                                   wave_expect=_READ_SB),
    "smallbank_dense/serve@mon": _cost(_SB_GEOM, 10, 152216,
                                       wave_expect=_READ_SB),
    # generic pipelines and shards: sort-bound, no formula-backed wave
    "tatp_pipeline/block": _cost(_TD_GEOM, 162, 324046,
                                 bytes_budget=250992),
    "tatp_pipeline/block@mon": _cost(_TD_GEOM, 164, 324314,
                                     bytes_budget=251118),
    "smallbank_pipeline/block": _cost(_SB_GEOM, 108, 155592,
                                      bytes_budget=65319),
    "smallbank_pipeline/block@mon": _cost(_SB_GEOM, 110, 155836,
                                          bytes_budget=65420),
    # one engine step a trace
    "sharded/tatp": _cost(_DS_GEOM, 162, 319458, steps=1.0,
                          bytes_budget=31374),
    "sharded/smallbank": _cost(_DSB_GEOM, 54, 157596, steps=1.0,
                               bytes_budget=8165),
    # the mesh: every partition's step and replicate's local writes
    "dense_sharded/block": _cost(_DS_GEOM, 42, 356472, bytes_budget=20564,
                                 wave_expect=_DS),
    "dense_sharded/block@mon": _cost(_DS_GEOM, 69, 357396,
                                     bytes_budget=21471,
                                     wave_expect=_DS_MON),
    "dense_sharded/block@fused": _cost(_DS_GEOM, 36, 354936,
                                       bytes_budget=20564,
                                       wave_expect=_DS_FUSED),
    "dense_sharded/block@fused+mon": _cost(_DS_GEOM, 63, 355884,
                                           bytes_budget=21496,
                                           wave_expect=_DS_FUSED_MON),
    "dense_sharded_sb/block": _cost(_DSB_GEOM, 36, 1191752,
                                    bytes_budget=35079, wave_expect=_DSB),
    "dense_sharded_sb/block@mon": _cost(_DSB_GEOM, 60, 1192628,
                                        bytes_budget=35532,
                                        wave_expect=_DSB),
    "dense_sharded_sb/block@hot": _cost(_DSB_GEOM, 42, 1191968,
                                        bytes_budget=38708,
                                        wave_expect=_DSB_HOT),
    "dense_sharded_sb/block@fused": _cost(_DSB_GEOM, 33, 1191752,
                                          bytes_budget=35079,
                                          wave_expect=_DSB_FUSED),
    "dense_sharded_sb/block@fused+hot": _cost(_DSB_GEOM, 39, 1191968,
                                              bytes_budget=38708,
                                              wave_expect=_DSB_FUSED_HOT),
    "dense_sharded_sb/block@fused+mon": _cost(_DSB_GEOM, 57, 1192652,
                                              bytes_budget=35558,
                                              wave_expect=_DSB_FUSED),
    "dense_sharded_sb/block@trace": _cost(_DSB_GEOM, 39, 1280852,
                                          bytes_budget=58464,
                                          wave_expect=_DSB_TRACE),
    # the 2-D mesh: the hierarchical and flat exchanges move the same
    # lanes through the same local ops on one card (their difference is
    # the link bytes no trace shows: link-bytes-unchecked)
    "multihost_sb/block": _cost(_MHSB_GEOM, 72, 2383412, bytes_budget=70157,
                                wave_expect=_MHSB),
    "multihost_sb/block@flat": _cost(_MHSB_GEOM, 72, 2383412,
                                     bytes_budget=70157, wave_expect=_MHSB),
    "multihost_sb/block@mon": _cost(_MHSB_GEOM, 120, 2385260,
                                    bytes_budget=71165, wave_expect=_MHSB),
    "multihost_sb/block@h3": _cost(_MHSB_GEOM, 72, 2383412,
                                   bytes_budget=70157, wave_expect=_MHSB),
    "multihost_sb/block@h3+flat": _cost(_MHSB_GEOM, 72, 2383412,
                                        bytes_budget=70157,
                                        wave_expect=_MHSB),
    "multihost_sb/block@trace": _cost(_MHSB_GEOM, 78, 2561612,
                                      bytes_budget=116928,
                                      wave_expect=_MHSB_TRACE),
    "multihost_sb/serve": _cost(_MHSB_GEOM, 72, 2383624, bytes_budget=70157,
                                wave_expect=_MHSB),
    "multihost_sb/serve@flat": _cost(_MHSB_GEOM, 72, 2383624,
                                     bytes_budget=70157, wave_expect=_MHSB),
    "multihost_sb/serve@mon": _cost(_MHSB_GEOM, 120, 2385616,
                                    bytes_budget=71316, wave_expect=_MHSB),
    "multihost_sb/serve@overlap": _cost(_MHSB_GEOM, 72, 2396300,
                                        bytes_budget=70157,
                                        wave_expect=_MHSB),
    "multihost_sb/serve@overlap+mon": _cost(_MHSB_GEOM, 120, 2398340,
                                            bytes_budget=71367,
                                            wave_expect=_MHSB),
    "multihost/block": _cost(_MH_GEOM, 84, 712872, bytes_budget=41127,
                             wave_expect=_DS),
    # the store: probe and install are hash-layout-dependent (unmodeled);
    # the scan pair reconciles (scan 1.17, scan_locate 1.0)
    "store/block": _cost(_ST_GEOM, 19, 2008, bytes_budget=2638),
    "store/block@scan": _cost(_ST_GEOM, 106 / 3, 6146, bytes_budget=12360),
    "store/serve@scan": _cost(_ST_GEOM, 106 / 3, 6170, bytes_budget=12360),
    "store/serve@scan+mon": _cost(_ST_GEOM, 112 / 3, 6382,
                                  bytes_budget=12427),
    # the compact reads fresh sorted arrays only: no row traffic priced
    "store/rebuild@scan": _cost(_ST_GEOM, 0, 6122, steps=1.0,
                                bytes_budget=0),
    # the replay twins (cold path, one call a fault): the budget keeps a
    # per-entry dispatch loop from growing in
    "recovery/tatp_dense": _cost(_TD_GEOM, 2, 493840, steps=1.0,
                                 bytes_budget=43008),
    "recovery/smallbank_dense": _cost(_SB_GEOM, 1, 349384, steps=1.0,
                                      bytes_budget=8602),
    "recovery/sb_shard": _cost(_DSB_GEOM, 1, 50248, steps=1.0,
                               bytes_budget=8602),
}


# ----------------------------------------------------------------- API

# trace-once cache shared by every pass in every analysis.run() of the
# process (core.TraceCache records per-target build seconds for --time)
TRACE_CACHE = TraceCache()


def get_trace(name: str) -> TargetTrace:
    """Build and trace a registered target at the lint geometry on the
    CPU (traced once per process; every pass and every run() shares the
    cached graph)."""
    trace = TRACE_CACHE.get(name, TARGETS[name])
    trace.protocol = TARGET_PROTOCOL.get(name, trace.protocol)
    return trace


def build(name: str, geometry: Geometry) -> TargetTrace:
    """Trace a registered target at ``geometry`` (uncached): the card's
    traces of chip_smoke.py."""
    trace = TARGETS[name](geometry)
    trace.protocol = TARGET_PROTOCOL.get(name, trace.protocol)
    return trace
