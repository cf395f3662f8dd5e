"""Cross-shard SmallBank over the 2-D (host, chip) mesh (the port of
`dint_tpu.parallel.multihost_sb`).

`dense_sharded_sb` runs DINT's distributed SmallBank (lock/read fan-out,
owner arbitration, install, CommitBck x2 + CommitLog x3) over one flat
axis; this module runs the same step over a mesh whose major axis is the
data-center network ("dcn", hosts) and whose minor axis is the chips of a
host ("ici"), partition (h, c) primary for global shard ``h * C + c`` of
the round-robin account partition:

* **Two exchanges, one permutation.** ``hierarchical=True`` exchanges a
  routed [D*cap] bucket array, seen as [H, C, cap], in two stages: along
  "ici" inside each host (JAX splits the chip dim; the port moves it first
  and hands `Mesh.all_to_all` C buckets of H*cap rows), then along "dcn"
  over the [H, C*cap] view. ``hierarchical=False`` is one exchange over the
  tuple axis ("dcn", "ici"), dcn-major. Both land partition s's bucket d
  in partition d's slot s: the 1-D runner's permutation exactly, so the
  stats and the primaries equal `dense_sharded_sb`'s at D = H*C.
* **Host fault domains.** The replication fan-out is `Mesh.ppermute` along
  "dcn": partition (h, c)'s installs go to (h+1, c) and (h+2, c), tagged
  ``key_hi = ((h-off) % H)*C + c + 1`` there, so the three copies of a row
  sit on three hosts. Needs n_hosts >= 3 (with 2 the +2 hop would alias
  the source host).
* **Per-axis routing counters.** ``monitor`` counts at the source each
  valid lock and install lane whose owner is on its own host
  (``route_ici_lanes``) or another (``route_dcn_lanes``): their sum is
  lock_requests + install_writes; the recorder's ROUTE events carry
  ``txnevents.ROUTE_DCN`` when the owner is on another host.
* **Serving.** ``serve=True`` takes per-partition occupancies and shed
  tallies [H, C, cpb]: the lock slots of the lanes past a partition's
  occupancy are zeroed after the full-width draw, so ``occ == w`` is the
  closed loop. ``overlap=True`` (needs ``serve``, refuses ``trace``) is
  the double-buffered route: each step routes and exchanges the NEXT
  cohort (the ``route_prefetch`` wave) and carries its draws, occupancy
  and two exchanged bucket fields to the next step, which regenerates the
  cohort's source-side locals from the carried draws; init starts one step
  early and the drain runs two flush steps, so cohort j is arbitrated at
  step 2+j and installed at 3+j on both routes and the final state is the
  unoverlapped serve route's.

The step is `dense_sharded_sb._Phases`, the 1-D runner's, with this
module's exchange and replication axis: every partition generates and
routes, every owner arbitrates and reads (B1 `gather_rows`, one launch of
three streams a partition), the replies, the install routing, every owner
installs and logs, hop 1, hop 2. JAX's runner has no ``use_hotset``,
``use_fused`` or ``use_pallas``, and neither has this one.

The partitions sit one a card where there are cards enough, else a
host's chips share one card (`mesh.placement`): an "ici" exchange then
stays on its card and the "dcn" hops are the copies between cards. On one
card (``device=``) every exchange is a copy on one stream, so no byte
crosses a link, the hierarchical route costs a second exchange, and the
overlap route reorders work and overlaps nothing. Draws come in from
outside: partition p's step i takes ``bits[i, p]``, copied to its card,
where JAX draws from ``fold_in(split(block_key, cpb)[i], p)``.
"""
from __future__ import annotations

import dataclasses

import torch

from ..engines.smallbank_dense import BIG
from ..engines.smallbank_pipeline import L, draw_step
from ..monitor import counters as mon
from ..monitor import txnevents as txe
from ..monitor import waves
from ..ops import u32
from .dense_sharded_sb import (  # noqa: F401 (re-exported)
    N_STATS, STAT_AB_LOCK, STAT_AB_LOGIC, STAT_ATTEMPTED, STAT_BAL_DELTA,
    STAT_COMMITTED, STAT_MAGIC_BAD, STAT_OVERFLOW, SBShard, m1_local,
    n_acct_local, total_balance_global)
from .dense_sharded_sb import (_Phases, _check_placement, _empty_sb_ctx,
                               _n_step_events, _stats_of, create_sharded_sb)
from .mesh import Mesh
from .multihost import (  # noqa: F401 (re-exported)
    DCN_AXIS, ICI_AXIS, make_mesh_2d, mesh_shape_from_env)
from .multihost import _check_hosts

I32 = torch.int32

_ENGINE = "multihost_sb"
_HOSTS = ("multihost replication needs >= 3 hosts (reference topology: 3 "
          "server machines; with 2 the +2 dcn hop aliases the source)")


def _mesh_hosts(mesh: Mesh) -> tuple[int, int]:
    n_hosts, n_ici = _check_hosts(mesh)
    if n_hosts < 3:
        raise ValueError(_HOSTS)
    return n_hosts, n_ici


def create_multihost_sb(mesh: Mesh, n_accounts: int,
                        init_balance: int = 1000, log_lanes: int = 16,
                        log_capacity: int = 1 << 16) -> list:
    """One `SBShard` a partition, in flat order ``h * C + c``, on its
    partition's device: partition (h, c) is primary for global shard
    h*C + c (the partition of `create_sharded_sb` at D = H*C); each has
    storage of its own, its backups a fresh copy of ``[bal, bal]``."""
    _mesh_hosts(mesh)
    return create_sharded_sb(mesh, mesh.size, n_accounts,
                             init_balance=init_balance, log_lanes=log_lanes,
                             log_capacity=log_capacity)


def exchange(mesh: Mesh, xs: list, cap: int, hierarchical: bool) -> list:
    """The runner's exchange of the partitions' [D*cap, ...] bucket arrays:
    hierarchical, along "ici" over the [H, C, cap] view (the chip dim
    moved first, so `Mesh.all_to_all` takes C buckets of H*cap rows) and
    then along "dcn" over the [H, C*cap] view; else flat, along the tuple
    of both axes. Both are the 1-D permutation: partition s's bucket d
    lands in partition d's slot s."""
    if not hierarchical:
        return mesh.all_to_all(xs, (DCN_AXIS, ICI_AXIS))
    n_hosts, n_ici = mesh.shape
    d = mesh.size
    rest = tuple(xs[0].shape[1:])
    ys = [x.view(n_hosts, n_ici, cap, *rest).transpose(0, 1)
          .reshape(d * cap, *rest) for x in xs]
    ys = mesh.all_to_all(ys, ICI_AXIS)
    ys = [y.view(n_ici, n_hosts, cap, *rest).transpose(0, 1)
          .reshape(d * cap, *rest) for y in ys]
    return mesh.all_to_all(ys, DCN_AXIS)


def build_multihost_sb_runner(mesh: Mesh, n_accounts: int, w: int = 2048,
                              cohorts_per_block: int = 8, hot_frac=None,
                              hot_prob=None, mix=None,
                              hierarchical: bool = False,
                              monitor: bool = False, trace=None,
                              trace_rate=None, trace_cap=None,
                              serve: bool = False, overlap: bool = False):
    """(run, init, drain) over the 2-D mesh, with the contract of
    `dense_sharded_sb.build_sharded_sb_runner` (flat partition order
    ``h * C + c`` in the draws, the states and the counts):

    * ``run(carry, gen[, occ, shed])`` draws a block's bits [cpb, H*C, w,
      5] and amounts [cpb, H*C, w] with ``gen`` on the mesh's home device
      and
      calls ``run.run_draws(carry, bits, ts_amt[, occ, shed])``, which
      returns (carry, stats i32 [cpb, N_STATS] summed over the mesh);
      ``occ`` and ``shed`` (``serve`` only) are device i32 [H, C, cpb];
    * ``init(states)`` -> carry (states, ctxs[, prefetch][, rings][,
      counters]); ``init.trace_cfg`` is the recorder's `TraceCfg` or None;
    * ``drain(carry)`` -> (states, stats [1 or 2, N_STATS][, rings][,
      counters]): one flush step, two on the overlap route.

    ``hierarchical`` picks the ici-then-dcn exchange or the flat one (the
    outputs are identical); ``serve``/``overlap`` as the module docstring
    says; ``monitor``/``trace`` as the 1-D runner's, with the per-axis
    route split, the serve trio at the dispatch step,
    ``route_prefetch_lanes`` and the ROUTE_DCN aux bit."""
    n_hosts, n_ici = _mesh_hosts(mesh)
    if w * L >= BIG:
        raise ValueError(f"w={w} exceeds the lane field of the scatter-mins")
    if overlap and not serve:
        raise ValueError("overlap=True requires serve=True: the double-"
                         "buffered route is defined over admitted serving "
                         "cohorts (occ rides the prefetch carry)")
    trace_on = txe.trace_enabled(trace)
    if overlap and trace_on:
        raise ValueError("overlap=True is incompatible with trace: the "
                         "txn ids are stamped with the generation step, "
                         "which the double buffer shifts by one")
    home, devs = mesh.device, mesh.devices
    d, cpb = mesh.size, cohorts_per_block
    cap = 2 * ((w * L + d - 1) // d)

    ph = _Phases(mesh, n_accounts, w, engine=_ENGINE,
                 exchange=lambda xs: exchange(mesh, xs, cap, hierarchical),
                 repl_axis=DCN_AXIS, mix=mix, hot_frac=hot_frac,
                 hot_prob=hot_prob, trace_on=trace_on)
    n_step = _n_step_events(w, ph.dc)
    tcfg = None
    if trace_on:
        rcap = int(trace_cap) if trace_cap else n_step * cpb
        tcfg = txe.TraceCfg(rate=txe.trace_rate(trace_rate), cap=rcap,
                            wave=waves.full_name(_ENGINE, "trace"))
    host = [mesh.axis_index(p, DCN_AXIS) for p in range(d)]
    # the attempted count of a full and an empty cohort, a partition
    n_att = {g: mesh.per_partition(
        lambda dv, g=g: torch.full((), w if g else 0, dtype=I32, device=dv))
        for g in (False, True)}
    # the empty prefetch: the bootstrap step's and the flush steps' cohort,
    # one a card
    empty_pf = mesh.per_partition(lambda dv: (
        torch.zeros((w, 5), dtype=I32, device=dv),
        torch.zeros((w,), dtype=I32, device=dv),
        torch.zeros((), dtype=I32, device=dv),
        torch.zeros((ph.dc, 2), dtype=I32, device=dv)))

    def route_aux(p, dest):
        return dest | torch.where(dest // n_ici != host[p], txe.ROUTE_DCN, 0)

    def step(carry, bits, ts_amt, occ=None, shed=None, gen_new=True):
        states, c1s = carry[0], carry[1]
        pf = carry[2] if overlap else None
        rings = carry[2 + int(overlap)] if trace_on else [None] * d
        cnts = carry[-1] if monitor else [None] * d
        t = states[0].step

        # ---- wave 1: generate + route the lock/read requests
        pf_next = p_valid = None
        if overlap:
            if gen_new:
                # the next cohort: drawn, masked and exchanged now, its
                # draws and buckets carried to the next step
                nxt = ph.gen(bits, ts_amt, True, t, occ=occ)
                with waves.scope(_ENGINE, "route_prefetch"):
                    routed = ph.route(nxt)
                pf_next = [(mesh.to_partition(bits[p], p),
                            mesh.to_partition(ts_amt[p], p), occ[p],
                            routed[p]) for p in range(d)]
                p_valid = [s["valid"] for s in nxt]
            else:
                pf_next = empty_pf
            # the in-flight cohort's source-side locals, regenerated from
            # its carried draws: no exchange
            src = ph.gen([f[0] for f in pf], [f[1] for f in pf], True, t,
                         occ=[f[2] for f in pf])
            for s in src:
                ph.plan_route(s)
            recv = [f[3] for f in pf]
            attempted = [f[2] for f in pf]
        else:
            src = ph.gen(bits, ts_amt, gen_new, t, occ=occ)
            with waves.scope(_ENGINE, "route"):
                recv = ph.route(src)
            if serve and gen_new:
                attempted = occ
            else:
                attempted = n_att[gen_new]

        # ---- owner side, replies, then wave 2 of c1 and the backups
        own = ph.arbitrate(states, recv, t)
        with waves.scope(_ENGINE, "reply"):
            ctxs = ph.reply(src, own, attempted)
        with waves.scope(_ENGINE, "install_route"):
            inst = ph.install_route(c1s, src)
        stepv, zero = ph.step_consts(t)
        recs = ph.install(states, own, inst, stepv, zero)
        # the backups of (h, c) at hosts h+1 and h+2, the same chip
        with waves.scope(_ENGINE, "replicate"):
            ph.replicate(states, own, recs, cnts, t, stepv, zero)

        for st in states:
            st.step = t + 1

        if monitor:
            for p, (st, cnt, upd) in enumerate(zip(states, cnts,
                                                   ph.counts(own, c1s))):
                # a valid lane whose owner is on this host crosses only
                # ICI, otherwise it pays the DCN hop (counted at the
                # source)
                s, h = src[p], host[p]
                near = s["dest"] // n_ici == h
                wnear = s["wdest"] // n_ici == h
                upd[mon.CTR_ROUTE_ICI_LANES] = (
                    (s["valid"] & near).sum(dtype=I32)
                    + (s["wvalid"] & wnear).sum(dtype=I32))
                upd[mon.CTR_ROUTE_DCN_LANES] = (
                    (s["valid"] & ~near).sum(dtype=I32)
                    + (s["wvalid"] & ~wnear).sum(dtype=I32))
                if serve and gen_new:
                    # admission accounting at the dispatch step
                    upd[mon.CTR_SERVE_OCC_LANES] = occ[p]
                    upd[mon.CTR_SERVE_PAD_LANES] = w - occ[p]
                    upd[mon.CTR_SERVE_SHED_LANES] = shed[p]
                if overlap and gen_new:
                    upd[mon.CTR_ROUTE_PREFETCH_LANES] = \
                        p_valid[p].sum(dtype=I32)
                mon.bump(cnt, upd)
                mon.gauge_max(cnt, {
                    mon.CTR_RING_HWM: u32.to_u64(st.log.head).max()})

        if trace_on:
            ph.trace(rings, cnts, tcfg, src, own, t, route_aux)

        stats = mesh.psum([_stats_of(c) for c in c1s])
        rest = tuple(carry[2 + int(overlap):])
        return ((states, ctxs) + ((pf_next,) if overlap else ()) + rest,
                stats)

    def _reset_rings(carry):
        if trace_on:            # each drained window is self-contained
            for r in carry[2 + int(overlap)]:
                txe.reset(r)

    def run_draws(carry, bits, ts_amt, occ=None, shed=None):
        want_b, want_a = (cpb, d, w, 5), (cpb, d, w)
        if tuple(bits.shape) != want_b or tuple(ts_amt.shape) != want_a:
            raise ValueError(f"expected bits {list(want_b)} and ts_amt "
                             f"{list(want_a)}, got {tuple(bits.shape)} and "
                             f"{tuple(ts_amt.shape)}")
        if serve != (occ is not None and shed is not None):
            raise ValueError("a serve runner takes occ and shed [H, C, "
                             "cpb]; a closed-loop runner takes neither")
        if serve:
            want_o = (n_hosts, n_ici, cpb)
            if tuple(occ.shape) != want_o or tuple(shed.shape) != want_o:
                raise ValueError(f"expected occ and shed {list(want_o)}, "
                                 f"got {tuple(occ.shape)} and "
                                 f"{tuple(shed.shape)}")
            # copies: a cohort's occupancy is read when it completes,
            # after the caller may have refilled its buffers; partition
            # p's [cpb] on its card
            occ = occ.to(I32, copy=True).reshape(d, cpb)
            shed = shed.to(I32, copy=True).reshape(d, cpb)
            occ = [mesh.to_partition(occ[p], p) for p in range(d)]
            shed = [mesh.to_partition(shed[p], p) for p in range(d)]
        _reset_rings(carry)
        stats = []
        for i in range(cpb):
            carry, s = step(carry, bits[i], ts_amt[i],
                            *(([o[i] for o in occ], [h[i] for h in shed])
                              if serve else ()))
            stats.append(s)
        return carry, torch.stack(stats)

    def run(carry, gen: torch.Generator, occ=None, shed=None):
        with waves.scope(_ENGINE, "gen"):
            draws = draw_step(gen, (cpb, d, w), home)
        return run_draws(carry, *draws, occ, shed)

    run.run_draws = run_draws

    def init(states: list):
        if len(states) != d:
            raise ValueError(f"{len(states)} states for {d} partitions")
        _check_placement(mesh, states)
        states = list(states)
        if overlap:
            # one step early: the bootstrap step arbitrates the empty
            # prefetch, so cohort j is arbitrated at step 2+j and
            # installed at 3+j, as on the unoverlapped route
            states = [dataclasses.replace(st, step=st.step - 1)
                      for st in states]
        return ((states, [_empty_sb_ctx(w, dv) for dv in devs])
                + ((list(empty_pf),) if overlap else ())
                + (([txe.create_ring(tcfg.cap, dv, spill=n_step)
                     for dv in devs],) if trace_on else ())
                + (([mon.create(dv) for dv in devs],) if monitor else ()))

    init.trace_cfg = tcfg

    def drain(carry):
        _reset_rings(carry)
        carry, s = step(carry, None, None, gen_new=False)
        stats = [s]
        if overlap:
            # the second flush installs the last prefetched cohort
            carry, s = step(carry, None, None, gen_new=False)
            stats.append(s)
        return ((carry[0], torch.stack(stats))
                + ((carry[2 + int(overlap)],) if trace_on else ())
                + ((carry[-1],) if monitor else ()))

    return run, init, drain
