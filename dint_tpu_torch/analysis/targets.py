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
name and the same protocol flags. Left out, by design:

  * every ``@pallas`` variant (``tatp_dense/block@pallas``,
    ``@mon+pallas``, ``@hot+pallas``, ``smallbank_dense/block@pallas``,
    ``@hot+pallas``, ``dense_sharded/block@pallas``,
    ``store/block@scan+pallas``): the port has one route per knob, its
    kernels are the route (plan.py drops ``use_pallas``), so the plain
    targets already trace them;
  * ``recovery/*``: they exist for dintdur's replay check, which the
    next slice ports (ROADMAP §A.8).

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
# "durable" = log rings (for dintdur, not ported yet).
TARGET_PROTOCOL: dict[str, tuple[str, ...]] = {}
# the reference targets the port leaves out, each with its reason
EXCLUDED: dict[str, str] = {}
_PALLAS = ("the port has one route per knob and its kernels are the route "
           "(plan.py drops use_pallas); the plain target traces them")
_RECOVERY = "exists for dintdur's replay check, ported in the next slice"
for _n in ("tatp_dense/block@pallas", "tatp_dense/block@mon+pallas",
           "tatp_dense/block@hot+pallas", "smallbank_dense/block@pallas",
           "smallbank_dense/block@hot+pallas", "dense_sharded/block@pallas",
           "store/block@scan+pallas"):
    EXCLUDED[_n] = _PALLAS
for _n in ("recovery/tatp_dense", "recovery/smallbank_dense",
           "recovery/sb_shard"):
    EXCLUDED[_n] = _RECOVERY
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
