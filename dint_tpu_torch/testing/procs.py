"""Rank workers: a mesh across processes run from one parent, as the
tests (gloo on the CPU) and chip_smoke.py (on the card) run it.

`launch` starts ``world`` ranks as fresh interpreters (multiprocessing's
``spawn``: the parent may have initialised CUDA, and a rank imports torch
and this package only, never JAX or the tests' conftest), each joining a
process group at a ``file://`` store in a temporary directory
(`parallel.dist.initialize`), running one job of `JOBS` and writing what
it returns there: its arrays as ``rank<r>.npz``, its record as
``rank<r>.json``, or its traceback as ``rank<r>.err``. The parent joins
every rank with a deadline, kills what overruns and raises `RankFailed`
with each rank's error when any rank fails: a failing rank fails the
caller, nothing is caught and carried on.

The jobs:

* ``collectives``: `Mesh.ppermute` along every axis (offsets 1 and 2),
  `Mesh.all_to_all` along every axis and the tuple
  of axes, `Mesh.psum` of int32 values that wrap, on inputs every rank
  makes alike from a numpy seed (`collective_inputs`);
* ``run``: a sharded runner over the ranks (`RUNNERS`: dense_sharded,
  multihost, dense_sharded_sb, multihost_sb), its state created, or JAX's
  state from the inputs, its draws from the inputs or made on the host
  from a seed (`host_draws`); it returns every block's stats, each local
  partition's state (as the `convert` dicts, or as digests of its tensors
  at full size) and counters, optionally the partition audit's counts,
  a lost host rebuilt from the next host's ring and each rank's txn/s;
* ``runs``: several ``run`` specs in turn in one launch (one spawn);
* ``sharded_step``: the generic engines' `sharded.build_sharded_step` on
  batches every rank routes alike;
* ``serve_mesh``: `serve.mesh.MeshServeEngine` over the ranks, a list of
  engine specs in turn (`serve_mesh_run`, which also runs one spec in one
  process): each rank's report, stats, counters (summed over the ranks)
  and each local partition's digests (or tables) after ``close``.
"""
from __future__ import annotations

import dataclasses
import json
import multiprocessing as mp
import os
import shutil
import tempfile
import time
import traceback

import numpy as np
import torch

DEADLINE_S = 240.0        # a launch's ranks are killed past this
GROUP_TIMEOUT_S = 60.0    # the group's own timeout, inside the deadline


class RankFailed(RuntimeError):
    """A rank raised, died or overran; ``errors`` maps each failed rank to
    its traceback (or how it ended)."""

    def __init__(self, errors: dict):
        self.errors = errors
        super().__init__("; ".join(f"rank {r}: {e.strip().splitlines()[-1]}"
                                   for r, e in sorted(errors.items())))


def launch(job: str, spec: dict, world: int, *, inputs: dict | None = None,
           device=None, backend=None, deadline_s: float = DEADLINE_S,
           timeout_s: float = GROUP_TIMEOUT_S):
    """Run ``JOBS[job](group, spec, inputs)`` on ``world`` spawned ranks
    (``device``: "cpu", or None for the card, where ranks sharing one card
    run gloo through the host and ranks with cards of their own NCCL;
    ``backend`` forces one, and raises where it cannot serve). Returns
    each rank's (arrays, record) in rank order."""
    tmp = tempfile.mkdtemp(prefix="dint_ranks_")
    try:
        with open(os.path.join(tmp, "spec.json"), "w") as f:
            json.dump(spec, f)
        if inputs:
            np.savez(os.path.join(tmp, "inputs.npz"), **inputs)
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_rank_main, name=f"dint-rank{r}", args=(
            job, r, world, f"file://{os.path.join(tmp, 'store')}", tmp,
            device, backend, timeout_s)) for r in range(world)]
        for p in procs:
            p.start()
        end = time.monotonic() + deadline_s
        for p in procs:
            p.join(max(end - time.monotonic(), 0.0))
        errors = {}
        for r, p in enumerate(procs):
            if p.is_alive():
                p.kill()
                p.join(10)
                errors[r] = f"killed past the {deadline_s} s deadline"
            elif p.exitcode != 0:
                path = os.path.join(tmp, f"rank{r}.err")
                errors[r] = (open(path).read() if os.path.exists(path)
                             else f"exited with code {p.exitcode}")
        if errors:
            raise RankFailed(errors)
        out = []
        for r in range(world):
            with np.load(os.path.join(tmp, f"rank{r}.npz")) as z:
                arrays = {k: z[k] for k in z.files}
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                out.append((arrays, json.load(f)))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _rank_main(job, rank, world, init_method, tmp, device, backend,
               timeout_s):
    """One rank: join, run the job, write its outputs; on any error its
    traceback, and a hard exit (the peers then fail at once)."""
    from ..parallel import dist
    try:
        group = dist.initialize(init_method, world, rank, backend=backend,
                                timeout_s=timeout_s, device=device,
                                local_rank=rank, local_world_size=world)
        with open(os.path.join(tmp, "spec.json")) as f:
            spec = json.load(f)
        inputs = {}
        path = os.path.join(tmp, "inputs.npz")
        if os.path.exists(path):
            with np.load(path) as z:
                inputs = {k: z[k] for k in z.files}
        if spec.get("die") == rank:
            os._exit(0)         # gone before its first collective
        arrays, record = JOBS[job](group, spec, inputs)
        record.update(rank=rank, backend=group.backend,
                      cards=[str(c) for c in group.cards])
        np.savez(os.path.join(tmp, f"rank{rank}.tmp.npz"), **arrays)
        os.replace(os.path.join(tmp, f"rank{rank}.tmp.npz"),
                   os.path.join(tmp, f"rank{rank}.npz"))
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(record, f)
        dist.shutdown()
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


# ---------------------------------------------------------------- inputs


def collective_inputs(shape, seed: int, rows: int = 12) -> dict:
    """One entry a partition of a mesh of ``shape`` for each collective
    case, made from ``seed`` with numpy (every rank makes the same):
    ``pp{p}``: a (int32 [rows, 3], bool [rows], int64 []) record;
    ``rag{p}``: an int32 [p + 1, 2] (its shape differs a partition);
    ``a2a{p}``: int32 [n_buckets * rows, 2] for each exchange, one per
    axis and the tuple; ``ps{p}``: int32 [4] near 2^31, so the sum wraps."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    out = {}
    for p in range(n):
        out[f"pp{p}.0"] = rng.integers(-2**31, 2**31, (rows, 3),
                                       dtype=np.int32)
        out[f"pp{p}.1"] = rng.integers(0, 2, rows).astype(bool)
        out[f"pp{p}.2"] = np.int64(rng.integers(0, 2**40))
        out[f"ps{p}"] = rng.integers(2**31 - 50, 2**31, 4,
                                     dtype=np.int64).astype(np.int32)
        for k in range(len(shape) + 1):
            nb = n if k == len(shape) else shape[k]
            out[f"a2a{k}.{p}"] = rng.integers(0, 1000, (nb * rows, 2),
                                              dtype=np.int32)
    return out


def collective_cases(mesh, inputs: dict, dev) -> dict:
    """Every collective case over ``mesh`` (its local partitions' entries
    taken from ``inputs``, on ``dev``): {case name: the list a partition,
    another rank's entries None}. The same on one process and on ranks."""
    def entry(p, key):
        return torch.from_numpy(np.array(inputs[key])).to(dev)

    out = {}
    for axis in mesh.axis_names:
        for off in (1, 2):
            xs = mesh.map_local(lambda p: (
                entry(p, f"pp{p}.0"), {"m": entry(p, f"pp{p}.1")},
                [entry(p, f"pp{p}.2")]))
            out[f"ppermute {axis} {off}"] = mesh.ppermute(xs, axis, off)
    for k, axis in enumerate(mesh.axis_names + (mesh.axis_names,)):
        out[f"all_to_all {axis}"] = mesh.all_to_all(
            mesh.map_local(lambda p: entry(p, f"a2a{k}.{p}")), axis)
    out["psum"] = mesh.psum(mesh.map_local(lambda p: entry(p, f"ps{p}")))
    return out


def case_arrays(cases: dict, local) -> dict:
    """The cases' local entries as flat arrays: ``<case>/<p>/<leaf>``; the
    psum's sum as ``psum``."""
    from ..parallel.mesh import leaves
    out = {}
    for name, got in cases.items():
        if isinstance(got, torch.Tensor):
            out[name] = got.cpu().numpy()
            continue
        for p in local:
            for i, t in enumerate(leaves(got[p])):
                out[f"{name}/{p}/{i}"] = t.cpu().numpy()
    return out


def host_draws(engine: str, seed: int, block: int, cpb: int, d: int,
               w: int):
    """A block's draws made on the host with numpy from ``(seed, block)``:
    TATP's (bits [cpb, d, w, 4], payload [cpb, d, w, 2]) or SmallBank's
    (bits [cpb, d, w, 5], ts_amt [cpb, d, w]), as CPU int32 tensors."""
    from ..engines.smallbank_pipeline import TS_AMT_MAX
    rng = np.random.default_rng([seed, block])
    sb = engine in ("dense_sharded_sb", "multihost_sb")
    bits = rng.integers(0, 2**32, (cpb, d, w, 5 if sb else 4),
                        dtype=np.uint32).view(np.int32)
    if sb:
        second = rng.integers(-TS_AMT_MAX, TS_AMT_MAX + 1, (cpb, d, w),
                              dtype=np.int32)
    else:
        second = rng.integers(0, 1 << 16, (cpb, d, w, 2), dtype=np.int32)
    return torch.from_numpy(bits), torch.from_numpy(second)


def digest(t: torch.Tensor) -> int:
    """A position-weighted sum of ``t``'s words mod 2^64, on its device in
    chunks (integer sums: the same on every device and in every order)."""
    x = t.reshape(-1)
    if x.dtype == torch.bool:
        x = x.to(torch.int32)
    total = torch.zeros((), dtype=torch.int64, device=x.device)
    step = 1 << 24
    for lo in range(0, x.numel(), step):
        c = x[lo:lo + step].to(torch.int64) & 0xFFFFFFFF
        wts = (torch.arange(lo, lo + c.numel(), dtype=torch.int64,
                            device=x.device) * 2654435761 + 40503) \
            & 0xFFFFFFFF
        total += (c * wts).sum()
    return int(total)


def state_digests(state) -> list:
    """The digests of a partition state's tensors (`parallel.mesh.leaves`
    order), then its host ints."""
    from ..parallel.mesh import leaves
    return [digest(t) for t in leaves(state)] + host_fields(state)


def host_fields(obj) -> list:
    """The host values (step counters, sizes) of a state, in field order."""
    out = []
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.extend(host_fields(v))
        elif isinstance(v, (int, np.integer)) and not isinstance(v, bool):
            out.append(int(v))
    return out


# ---------------------------------------------------------------- runners

TATP = ("dense_sharded", "multihost")
RUNNERS = TATP + ("dense_sharded_sb", "multihost_sb")


def make_mesh(engine: str, shape, device=None, group=None, devices=None):
    """``engine``'s mesh of ``shape``: (host, chip) for the multihost
    runners, one shard axis for the others."""
    from ..parallel import dense_sharded as ds
    from ..parallel import multihost as mh
    from ..parallel.mesh import Mesh
    if engine in ("multihost", "multihost_sb"):
        return mh.make_mesh_2d(*shape, device=device, devices=devices,
                               group=group)
    return Mesh(tuple(shape), (ds.SHARD_AXIS,), device=device,
                devices=devices, group=group)


def build(engine: str, mesh, spec: dict):
    """(run, init, drain) of ``engine`` over ``mesh`` at the spec's sizes
    and route."""
    from ..parallel import dense_sharded as ds
    from ..parallel import dense_sharded_sb as dsb
    from ..parallel import multihost as mh
    from ..parallel import multihost_sb as mhs
    route = spec.get("route", {})
    n, w, cpb = spec["n"], spec["w"], spec["cpb"]
    if engine == "dense_sharded":
        return ds.build_sharded_pipelined_runner(
            mesh, mesh.size, n, w=w, val_words=spec["vw"],
            cohorts_per_block=cpb, use_fused=route.get("use_fused", False),
            monitor=route.get("monitor", False))
    if engine == "multihost":
        return mh.build_multihost_runner(mesh, n, w=w, val_words=spec["vw"],
                                         cohorts_per_block=cpb)
    if engine == "dense_sharded_sb":
        return dsb.build_sharded_sb_runner(
            mesh, mesh.size, n, w=w, cohorts_per_block=cpb,
            use_hotset=route.get("use_hotset", False),
            use_fused=route.get("use_fused", False),
            monitor=route.get("monitor", False))
    return mhs.build_multihost_sb_runner(
        mesh, n, w=w, cohorts_per_block=cpb,
        hierarchical=route.get("hierarchical", False),
        monitor=route.get("monitor", False))


def create(engine: str, mesh, spec: dict, inputs: dict) -> list:
    """The runner's starting state: JAX's (``inputs`` under ``state.``,
    each rank placing its own partitions), made on the device at full size
    (``spec["state"] == "device"``: TATP's `populate_device` a partition,
    seeds ``seed + p``), or the module's own ``create_*``."""
    from .. import convert
    from ..engines import tatp_dense as td
    from ..parallel import dense_sharded as ds
    from ..parallel import dense_sharded_sb as dsb
    from ..parallel import multihost as mh
    from ..parallel import multihost_sb as mhs
    how = spec.get("state", "create")
    if how == "inputs":
        arrays = {k[len("state."):]: (v if v.ndim else v.item())
                  for k, v in inputs.items() if k.startswith("state.")}
        if engine in TATP:
            return convert.sharded_state_from_numpy(arrays, mesh=mesh)
        if engine == "multihost_sb":
            return convert.multihost_sb_from_numpy(arrays, mesh=mesh)
        return convert.sharded_sb_from_numpy(arrays, mesh=mesh)
    seed, log_cap = spec.get("seed", 0), spec["log_cap"]
    if engine in TATP and how == "device":
        n_loc = ds.n_sub_local(spec["n"], mesh.size)
        dbs = mesh.map_local(lambda p: td.populate_device(
            torch.Generator(device=mesh.device_of(p)).manual_seed(seed + p),
            n_loc, val_words=spec["vw"], log_replicas=1,
            device=mesh.device_of(p),
            **({} if log_cap is None else {"log_capacity": log_cap})))
        axis = mh.DCN_AXIS if engine == "multihost" else ds.SHARD_AXIS
        return ds._with_backups(mesh, axis, dbs)
    if engine == "dense_sharded":
        return ds.create_sharded(mesh, mesh.size, spec["n"],
                                 val_words=spec["vw"], seed=seed,
                                 log_capacity=log_cap)
    if engine == "multihost":
        return mh.create_multihost(mesh, spec["n"], val_words=spec["vw"],
                                   seed=seed, log_capacity=log_cap)
    if engine == "multihost_sb":
        return mhs.create_multihost_sb(mesh, spec["n"],
                                       log_capacity=log_cap)
    return dsb.create_sharded_sb(mesh, mesh.size, spec["n"],
                                 log_capacity=log_cap)


def state_arrays(engine: str, state) -> dict:
    """One partition's state as its `convert` dict (leading [1])."""
    from .. import convert
    if engine in TATP:
        return convert.sharded_state_to_numpy([state], (1,))
    return convert.sharded_sb_to_numpy([state])


def launches() -> dict:
    """Every kernel wrapper's launch count, by name."""
    from ..ops import row_kernels as rk
    from ..ops import scan_kernels as sk
    return {fn.__name__: fn.launches for fn in rk.WRAPPERS + sk.WRAPPERS}


def reset_launches():
    from ..ops import row_kernels as rk
    from ..ops import scan_kernels as sk
    for fn in rk.WRAPPERS + sk.WRAPPERS:
        fn.launches = 0


def _union_s(spans) -> float:
    """Seconds covered by the union of (start, end) µs spans."""
    total, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total * 1e-6


def device_busy(fn, cards) -> dict:
    """``fn()`` under torch.profiler, ``cards`` synchronised around it:
    for each card this process used, the seconds covered by its device
    slices (kernels, copies, fills; the union over streams) but NCCL's,
    and those covered by NCCL's kernels (which wait for their peers on
    the card as well as move bytes). A card's idle share of a block of
    ``t`` seconds is 1 minus the busy seconds of every process on it
    over ``t``."""
    from torch.profiler import ProfilerActivity, profile
    from ..monitor import attrib
    cards = [c for c in cards if c.type == "cuda"]
    for c in cards:
        torch.cuda.synchronize(c)
    with profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cards else [])) as prof:
        fn()
        for c in cards:
            torch.cuda.synchronize(c)
    with tempfile.TemporaryDirectory(prefix="dint_busy_") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        events, _ = attrib.load_trace_events(path)
    spans = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in attrib.DEVICE_CATS:
            continue
        dev = f"cuda:{e.get('args', {}).get('device', e.get('pid'))}"
        kind = "nccl_s" if e.get("name", "").startswith("nccl") \
            else "busy_s"
        spans.setdefault(dev, {"busy_s": [], "nccl_s": []})[kind].append(
            (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))))
    return {dev: {k: _union_s(v) for k, v in by.items()}
            for dev, by in spans.items()}


def drive(engine: str, mesh, spec: dict, inputs: dict, states=None,
          sync=None):
    """The spec's blocks on ``mesh`` (draws from ``inputs`` as
    ``bits<i>``/``second<i>``, else `host_draws` from ``spec["seed"]``),
    then the drain (TATP's payload ``drain`` from the inputs where given).
    ``sync()`` runs after each block (the cards' synchronise); with
    ``spec["profile"]`` the last block runs under `device_busy`. Returns
    (states, stats of the blocks and the drain [steps, N], counters list
    or None, the unprofiled blocks' seconds, the profiled block's busy
    seconds by card or None)."""
    states = create(engine, mesh, spec, inputs) if states is None \
        else states
    run, init, drain = build(engine, mesh, spec)
    cpb, blocks = spec["cpb"], spec["blocks"]
    carry = init(states)
    stats, block_s, busy = [], [], None
    for i in range(blocks):
        if f"bits{i}" in inputs:
            draws = (torch.from_numpy(inputs[f"bits{i}"]),
                     torch.from_numpy(inputs[f"second{i}"]))
        else:
            draws = host_draws(engine, spec.get("draw_seed", 0), i, cpb,
                               mesh.size, spec["w"])
        if spec.get("profile") and i == blocks - 1:
            box = []
            busy = device_busy(lambda: box.append(run.run_draws(
                carry, *draws)), mesh.cards)
            carry, s = box[0]
            stats.append(s)
            continue
        t0 = time.perf_counter()
        carry, s = run.run_draws(carry, *draws)
        if sync is not None:
            sync()
        block_s.append(time.perf_counter() - t0)
        stats.append(s)
    if engine in TATP and "drain" in inputs:
        out = drain(carry, payload=torch.from_numpy(inputs["drain"]))
    else:
        out = drain(carry)
    monitor = spec.get("route", {}).get("monitor", False)
    stats = torch.cat(stats + [out[1]]).cpu().numpy()
    return out[0], stats, (out[-1] if monitor else None), block_s, busy


def _run_job(group, spec, inputs):
    """One runner over the ranks (the module docstring's ``run``)."""
    from .. import timing
    from ..ops import u32
    from .partitions import PartitionAudit
    engine = spec["engine"]
    device = spec.get("device")
    mesh = make_mesh(engine, spec["shape"], device=device, group=group)
    sync = None if mesh.device.type == "cpu" else \
        (lambda: timing.synchronize(mesh.cards))
    record, arrays = {"mesh_cards": [str(c) for c in mesh.cards],
                      "local": list(mesh.local)}, {}
    reset_launches()
    if spec.get("audit"):
        states = create(engine, mesh, spec, inputs)
        audit = PartitionAudit(local=mesh.local)
        audit.tag_partitions(states)
        with audit:
            states, stats, cnts, block_s, busy = drive(
                engine, mesh, spec, inputs, states=states)
        record.update(audit_ops=audit.ops,
                      audit_collectives=audit.collectives)
    else:
        states, stats, cnts, block_s, busy = drive(engine, mesh, spec,
                                                   inputs, sync=sync)
    arrays["stats"] = stats
    record.update(block_s=block_s, busy_s=busy, launches=launches())
    if engine not in TATP:
        from ..parallel import dense_sharded_sb as dsb
        arrays["total_balance"] = np.array(
            dsb.total_balance_global(states, mesh))
    for p in mesh.local:
        if spec.get("outputs") == "digest":
            arrays[f"p{p}/digest"] = np.array(state_digests(states[p]),
                                              dtype=np.int64)
        else:
            for k, v in state_arrays(engine, states[p]).items():
                arrays[f"p{p}/{k}"] = np.asarray(v)
        if cnts is not None:
            arrays[f"p{p}/counters"] = u32.to_numpy(cnts[p].buf)
    if cnts is not None:
        # the mesh's counters: this rank's partitions, summed over the ranks
        from ..monitor import counters as mon
        record["counters"] = mon.sum_over(group, mon.snapshot(cnts))
    for dead_h in spec.get("recover", ()):
        # the lost host's partitions rebuilt on their rank from the ring
        # of host dead_h + 1 (one ppermute along "dcn", across ranks)
        arrays.update(_recover(engine, mesh, spec, states, dead_h))
    return arrays, record


def _recover(engine, mesh, spec, states, dead_h) -> dict:
    from .. import recovery
    from ..engines import tatp_dense as td
    from ..ops import u32
    from ..parallel import dense_sharded as ds
    from ..parallel import multihost as mh
    from ..tables import log as logring
    logs = [None if st is None else (st.db.log if engine in TATP
                                     else st.log) for st in states]
    rings = mh.rings_from(mesh, logs, 1)
    out = {}
    n_hosts, n_ici = mesh.shape
    for c in range(n_ici):
        dead = mesh.flat((dead_h, c))
        if dead not in mesh.local:
            continue
        log = rings[dead]
        holder = mesh.flat(((dead_h + 1) % n_hosts, c))
        if engine in TATP:
            n_loc = ds.n_sub_local(spec["n"], mesh.size)
            snap = td.populate(np.random.default_rng(
                spec.get("seed", 0) + dead), n_loc, val_words=spec["vw"],
                log_replicas=1, log_capacity=spec["log_cap"],
                device=mesh.device_of(dead))
            rec = recovery.recover_tatp_dense(
                snap, logring.replica_entries(log, 0), log.head,
                key_hi_filter=dead + 1)
            out[f"rec{dead}/val"] = u32.to_numpy(rec.val)
            out[f"rec{dead}/meta"] = u32.to_numpy(rec.meta)
        else:
            out[f"rec{dead}/bal"] = recovery.recover_sb_shard(
                spec["n"], dead, mesh.size, logring.replica_entries(log, 0),
                log.head, ring_owner=holder)
    return out


def _runs_job(group, spec, inputs):
    """``spec["runs"]``: ``run`` specs in turn; run i's arrays under
    ``<i>/`` and its record at ``runs[i]``."""
    arrays, records = {}, []
    for i, one in enumerate(spec["runs"]):
        a, rec = _run_job(group, one, inputs)
        arrays.update({f"{i}/{k}": v for k, v in a.items()})
        records.append(rec)
        del a
    return arrays, {"runs": records}


def _collectives_job(group, spec, inputs):
    from ..parallel.mesh import Mesh
    dev = torch.device(spec.get("device") or "cpu")
    shape = tuple(spec["shape"])
    mesh = Mesh(shape, tuple(spec["axes"]), device=dev, group=group)
    ins = collective_inputs(shape, spec["seed"])
    return case_arrays(collective_cases(mesh, ins, dev), mesh.local), \
        {"local": list(mesh.local)}


def sharded_batches(spec: dict, devices):
    """The generic step's waves: ``spec["waves"]`` TATP request draws over
    all five tables (reads, locks, prim commits, inserts, deletes, aborts,
    log appends) made from ``spec["seed"]`` on the host and routed by owner
    (`sharded.route_batches`, a skewed draw spilling into further waves);
    shard d's batch on ``devices[d]`` (None: another rank's, left None)."""
    from ..engines import tatp
    from ..engines.types import Op
    from ..parallel import sharded
    ops_set = np.array([Op.OCC_READ, Op.OCC_LOCK, Op.COMMIT_PRIM,
                        Op.INSERT_PRIM, Op.DELETE_PRIM, Op.ABORT,
                        Op.COMMIT_LOG, Op.DELETE_LOG], np.int32)
    rng = np.random.default_rng(spec["seed"])
    n_sub, vw, out = spec["n"], spec["vw"], []
    for m in spec["waves"]:
        tbls = rng.integers(0, 5, m).astype(np.int32)
        s_id = rng.integers(1, n_sub + 1, m)
        sub_t = rng.integers(0, 4, m)
        keys = np.where(tbls < 2, s_id, s_id * 4 + sub_t)
        keys = np.where(tbls == tatp.CALL_FORWARDING,
                        tatp.cf_key(s_id, sub_t + 1,
                                    8 * rng.integers(0, 3, m)),
                        keys).astype(np.int64)
        ops = rng.choice(ops_set, m)
        vals = rng.integers(0, 1 << 32, (m, vw), dtype=np.uint64).astype(
            np.uint32)
        vers = rng.integers(0, 5, m).astype(np.uint32)
        waves, _ = sharded.route_batches(ops, tbls, keys, vals, vers,
                                         len(devices), spec["w"], vw,
                                         devices=devices)
        out.extend(waves)
    return out


def _sharded_step_job(group, spec, inputs):
    from ..parallel import sharded
    mesh = sharded.make_mesh(spec["shards"],
                             device=spec.get("device") or "cpu", group=group)
    return sharded_step_arrays(mesh, spec), {"local": list(mesh.local)}


def sharded_step_arrays(mesh, spec: dict) -> dict:
    """The generic TATP step over ``mesh`` on `sharded_batches`: each local
    shard's replies and the vote a wave, and each local shard's final
    tensors (`leaves` order), as ``w<i>/<p>/<j>``, ``w<i>/committed`` and
    ``s/<p>/<j>``."""
    from ..parallel import sharded
    from ..parallel.mesh import leaves
    shards = sharded.create_sharded_state(
        mesh, mesh.size, spec["n"], val_words=spec["vw"], cf_buckets=256,
        cf_lock_slots=256, log_capacity=spec["log_cap"])
    step = sharded.build_sharded_step(mesh, mesh.size, "tatp")
    out = {}
    for i, wave in enumerate(sharded_batches(spec, mesh.devices)):
        shards, replies, committed = step(shards, wave)
        for p in mesh.local:
            for j, t in enumerate(leaves(replies[p])):
                out[f"w{i}/{p}/{j}"] = t.cpu().numpy()
        out[f"w{i}/committed"] = committed.cpu().numpy()
    for p in mesh.local:
        for j, t in enumerate(leaves(shards[p])):
            out[f"s/{p}/{j}"] = t.cpu().numpy()
    return out


# ------------------------------------------------------------- serving


def serve_draws(spec: dict, inputs: dict):
    """The engine's ``draws=`` for ``spec["draws"]``: None (the engine's
    own generator), ``"host"`` (`host_draws` from ``spec["draw_seed"]``,
    the block index and the width) or ``"inputs"`` (``bits<i>.<w>`` and
    ``amt<i>.<w>``, e.g. JAX's draws)."""
    how = spec.get("draws")
    if how is None:
        return None
    h, c = spec["shape"]
    cpb = spec["cpb"]

    def draws(i, w):
        if i is None:
            return ()
        if how == "host":
            return host_draws("multihost_sb", spec.get("draw_seed", 0), i,
                              cpb, h * c, w)
        return (torch.from_numpy(inputs[f"bits{i}.{w}"]),
                torch.from_numpy(inputs[f"amt{i}.{w}"]))
    return draws


def serve_engine(spec: dict, inputs: dict, group=None):
    """The spec's `MeshServeEngine` (over ``group``, or in one process):
    ``n`` accounts over ``shape``, the width menu ``widths`` (and
    ``slo_us``), ``model`` (base_us, per_lane_ns) or the plan's,
    ``cpb``, ``depth``, ``overlap``, ``hierarchical``, ``seed``,
    ``idle_poll_us``, ``clock`` ("virtual" or "real"), ``plan`` ("auto", None or a plan
    document), ``device`` and the draws of `serve_draws`."""
    from ..serve import (ControllerCfg, MeshServeEngine, RealClock,
                         ServiceModel, VirtualClock)
    cfg = ControllerCfg(widths=tuple(spec["widths"]),
                        **({"slo_us": spec["slo_us"]}
                           if spec.get("slo_us") is not None else {}))
    model = spec.get("model")
    return MeshServeEngine(
        spec["n"], mesh_shape=tuple(spec["shape"]), cfg=cfg,
        model=None if model is None else ServiceModel(*model),
        cohorts_per_block=spec["cpb"], depth=spec.get("depth", 2),
        clock=VirtualClock() if spec.get("clock") == "virtual"
        else RealClock(), monitor=spec.get("monitor", True),
        seed=spec.get("seed", 0), overlap=spec.get("overlap", False),
        idle_poll_us=spec.get("idle_poll_us", 50_000.0),
        hierarchical=spec.get("hierarchical"), plan=spec.get("plan"),
        draws=serve_draws(spec, inputs), device=spec.get("device"),
        group=group)


def serve_mesh_run(spec: dict, inputs: dict, group=None):
    """One engine spec (`serve_engine`): warm up (``spec["warmup"]``),
    serve the schedule ``inputs[spec["schedule"]]``, close. Returns
    (arrays: ``stats`` (the summed stats) and each local partition's
    ``p<p>/digest`` (`state_digests`) or, with ``outputs="arrays"``, its
    `state_arrays`; record: ``report`` (``run``'s), ``closed`` (the
    snapshot after ``close``), ``counters``, ``launches`` (counted from
    0 just before ``run``), ``seconds`` of ``run`` and ``close``,
    ``local``). ``spec["die"]`` = [rank, blocks]: that rank exits once it
    has launched that many blocks (a rank lost mid-run)."""
    from .. import timing
    eng = serve_engine(spec, inputs, group)
    if spec.get("warmup"):
        eng.warmup()
    die = spec.get("die")
    if die is not None and group is not None and group.rank == die[0]:
        launch = eng._launch

        def launch_then_die(occ, shed):
            launch(occ, shed)
            if eng.blocks >= die[1]:
                os._exit(0)
        eng._launch = launch_then_die
    sched = inputs[spec["schedule"]]
    reset_launches()
    t0 = time.perf_counter()
    report = eng.run(sched)
    eng.close()
    if eng.dev.type == "cuda":
        timing.synchronize(eng.mesh.cards)
    secs = time.perf_counter() - t0
    record = {"report": report, "closed": eng.snapshot(),
              "counters": dict(eng.counters_total), "launches": launches(),
              "seconds": secs, "local": list(eng.mesh.local)}
    arrays = {"stats": np.asarray(eng.stats_total)}
    for p in eng.mesh.local:
        if spec.get("outputs") == "arrays":
            for k, v in state_arrays("multihost_sb", eng._db[p]).items():
                arrays[f"p{p}/{k}"] = np.asarray(v)
        else:
            arrays[f"p{p}/digest"] = np.array(state_digests(eng._db[p]),
                                              dtype=np.int64)
    del eng
    return arrays, json.loads(json.dumps(record))


def _serve_mesh_job(group, spec, inputs):
    """``spec["engines"]`` in turn (`serve_mesh_run`); engine i's arrays
    under ``<i>/`` and its record at ``runs[i]``."""
    arrays, records = {}, []
    for i, one in enumerate(spec["engines"]):
        a, rec = serve_mesh_run(one, inputs, group)
        arrays.update({f"{i}/{k}": v for k, v in a.items()})
        records.append(rec)
    return arrays, {"runs": records}


JOBS = {"collectives": _collectives_job, "run": _run_job,
        "runs": _runs_job, "sharded_step": _sharded_step_job,
        "serve_mesh": _serve_mesh_job}
