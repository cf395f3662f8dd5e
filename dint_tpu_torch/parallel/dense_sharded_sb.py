"""Sharded dense SmallBank: cross-device transactions over `all_to_all`
(the port of `dint_tpu.parallel.dense_sharded_sb`).

Unlike TATP, SmallBank's Amalgamate and SendPayment touch TWO accounts,
which land on different shards however the keyspace is cut
(smallbank/caladan/client_ebpf_shard.cc:255, 830); the reference's
coordinator fans each transaction's lock and commit messages out to the
servers that own them. Here a step of the mesh is that structure as
collectives:

  wave 1 of step T (cohort t):
    * every partition generates w txns over the GLOBAL keyspace (accounts
      round-robin partitioned: owner = account % D, local index account //
      D, so the 4% hot set spreads over every partition);
    * its lock+read requests are compacted per owner and exchanged with
      one `Mesh.all_to_all` (the reference's per-shard request batches,
      client_ebpf_shard.cc:287-325);
    * owners arbitrate no-wait S/X grants against their step-stamp tables
      (the closed form of engines/smallbank_dense.py, on exact tables:
      slot == local row) and read the balances; the replies come back with
      a second `all_to_all`;
    * the source classifies the outcomes and runs `compute_phase`.

  wave 2 of step T+1 (cohort t installs):
    * committed writes are routed to their owners the same way, installed
      and logged there;
    * each owner's applied installs go to partitions owner+1 and owner+2
      (`Mesh.ppermute`), which write their backup copies and append them to
      their own logs, tagged ``key_hi = source + 1`` (CommitBck x2 +
      CommitLog x3, client_ebpf_shard.cc:779-860);
    * the stats are summed over the mesh (`Mesh.psum`): the 2PC vote.

A destination bucket holds ``cap = 2 * ceil(w*L / D)`` lanes; a lane past
it is a lock reject, counted in STAT_OVERFLOW too (zero at real widths:
round-robin keeps the destinations near uniform under the 90/4 skew).
Balance conservation holds globally: the summed STAT_BAL_DELTA equals the
change of `total_balance_global`.

Routes, each bit-identical to JAX's XLA route:

* default: the held-stamp reads and the balance read are the three streams
  of one `gather_rows` launch (only the stamp writes come between them in
  JAX's order, and those never write ``bal``); the install is a plain
  torch write;
* ``use_hotset``: the three reads are one `gather_rows_hot` launch against
  the stamp and balance mirrors of the local hot prefix (`SBShard`); the
  install is `scatter_rows_hot`, the write-through;
* ``use_fused``: the three reads are one `gather_streams` launch over the
  main arrays; the install, the owner's log append and (hot tier) the
  mirror write-through are the streams of one `scatter_streams` launch.

The routing, the replies, the backups and the forwarded log appends are
plain torch work on every route, as JAX's are XLA outside its kernels.

The mesh is a list of partitions, each on its own device (`mesh.py`: one
card a partition, or several sharing one), driven from one thread, so a
step runs phase by phase over all partitions, never partition by
partition (`_Phases`,
which `multihost_sb` runs too, with its 2-D exchange and replication
axis): every partition generates and routes, one `all_to_all`; every
owner arbitrates and reads; the replies; every source classifies; every
partition routes its previous cohort's installs, one `all_to_all`; every
owner installs and logs; hop 1 on every partition, then hop 2. Each log
holds its own appends, then hop 1's, then hop 2's, as on JAX's devices.
A partition's data reaches another card only inside the collectives; each
partition's constants live on its own card.

What differs from JAX:

* Tables are int32 tensors of u32 bit patterns (ops/u32.py), updated in
  place; the step counter is a host int a partition (all partitions
  advance in lockstep; it starts at 2 and, as in JAX, is never rebased).
* JAX's ``mode="drop"`` scatters have no torch form. `_route` sends a
  lane that routes nowhere to a spill row of its own past the ``D*cap``
  buckets (one unique-index copy, no host sync); the scatter-mins
  ``first_x``/``first_s`` get one drop slot; the stamp, install and backup
  writes keep their masked-in lanes (one ``nonzero`` each, unique by the
  arbitration).
* `_positions` ranks along the inner dimension of a [D, wL] one-hot
  (JAX's cumsum runs along the outer dimension of [wL, D]): the same
  integers.
* Draws come in from outside (``run.run_draws``, on any device: partition
  p's slice is copied to its card); ``use_pallas`` has no
  twin (CUDA tensors launch the kernels, CPU tensors run their plain
  versions).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..clients import workloads as wl
from ..engines.smallbank_dense import BIG, _stamp
from ..engines.smallbank_pipeline import (L, VW, compute_phase, draw_step,
                                          gen_cohort_from_bits, mix_thresh,
                                          _lock_slots)
from ..engines.smallbank_pipeline import (STAT_ATTEMPTED, STAT_COMMITTED,  # noqa: F401 (re-exported)
                                          STAT_AB_LOCK, STAT_AB_LOGIC,
                                          STAT_MAGIC_BAD, STAT_BAL_DELTA)
from ..engines.smallbank_pipeline import N_STATS as _SB_N_STATS
from ..engines.types import Op
from ..monitor import counters as mon
from ..monitor import txnevents as txe
from ..monitor import waves
from ..ops import u32
from ..ops.row_kernels import (gather_rows, gather_rows_hot, gather_streams,
                               scatter_rows_hot, scatter_streams)
from ..tables import log as logring
from .mesh import Mesh
from .sharded import SHARD_AXIS, make_mesh  # noqa: F401 (re-exported)

I32 = torch.int32

N_BCK = 2      # backup copies of each balance range
AXIS = SHARD_AXIS

# the sharded stats append a routing-overflow counter to the shared layout
STAT_OVERFLOW = _SB_N_STATS
N_STATS = _SB_N_STATS + 1

_ENGINE = "dense_sharded_sb"


@dataclass
class SBShard:
    """One partition: primary balances of its account range (sentinel
    last), backup copies of the two predecessors' ranges (slot 0 = d-1's,
    slot 1 = d-2's), step-stamp lock tables and a ``replicas=1`` log (the
    three copies live on three partitions).

    The ``hot_*`` leaves are the partition's hot tier: global hot account
    ``a < hot_n`` lives at partition ``a % D``, local index ``a // D``, so
    each partition's hot set is its local prefix ``q < hot_loc``; mirror
    index ``tbl * hot_loc + q``. The lock tables are exact (slot == local
    row), so the stamps are always mirrored."""
    bal: torch.Tensor        # i32 [m1_loc]
    bck_bal: torch.Tensor    # i32 [N_BCK * m1_loc]
    x_step: torch.Tensor     # i32 [m1_loc]
    s_step: torch.Tensor     # i32 [m1_loc]
    step: int                # host counter, starts at 2
    log: logring.RepLog
    hot_bal: torch.Tensor | None = None   # i32 [2 * hot_loc]
    hot_x: torch.Tensor | None = None     # i32 [2 * hot_loc]
    hot_s: torch.Tensor | None = None     # i32 [2 * hot_loc]
    hot_loc: int = 0


def n_acct_local(n_accounts: int, d: int) -> int:
    return (n_accounts + d - 1) // d


def m1_local(n_accounts: int, d: int) -> int:
    return 2 * n_acct_local(n_accounts, d) + 1


def _check_mesh(mesh: Mesh, n_shards: int):
    if n_shards != mesh.size:
        raise ValueError(f"n_shards={n_shards} on a mesh of {mesh.size}")


def _check_placement(mesh: Mesh, states: list):
    """Each partition's state on its own mesh device."""
    if len(states) != mesh.size:
        raise ValueError(f"{len(states)} states for {mesh.size} partitions")
    for p, st in enumerate(states):
        if st.bal.device != mesh.device_of(p):
            raise ValueError(f"partition {p}'s tables on {st.bal.device}, "
                             f"its mesh device {mesh.device_of(p)}")


def attach_hotset_sb(mesh: Mesh, states: list, hot_loc: int) -> list:
    """The partitions with hot mirrors of their local prefix ``[0,
    hot_loc)`` (clamped to [1, n_loc]) built from their current tables;
    the mirrors are fresh tensors, never views."""
    _check_mesh(mesh, len(states))
    n_loc = states[0].bal.shape[0] // 2
    hot_loc = int(min(max(int(hot_loc), 1), n_loc))
    out = []
    for st in states:
        ar = torch.arange(hot_loc, device=st.bal.device)
        idx = torch.cat([ar, n_loc + ar])
        out.append(dataclasses.replace(
            st, hot_bal=st.bal[idx], hot_x=st.x_step[idx],
            hot_s=st.s_step[idx], hot_loc=hot_loc))
    return out


def create_sharded_sb(mesh: Mesh, n_shards: int, n_accounts: int,
                      init_balance: int = 1000, log_lanes: int = 16,
                      log_capacity: int = 1 << 16) -> list:
    """One `SBShard` a partition on its partition's device, each with
    storage of its own: every balance ``init_balance`` (reference:
    smallbank/ebpf/shard_user.c:74-77), the sentinel 0, the backups copies
    of the same, no stamp, an empty ring of ``log_lanes`` x
    ``log_capacity``."""
    _check_mesh(mesh, n_shards)
    m1 = m1_local(n_accounts, n_shards)
    if N_BCK * m1 >= (1 << 31):
        raise ValueError(f"{n_accounts} accounts over {n_shards} shards "
                         f"overflow int32 row ids")
    def one(dev):
        bal = torch.full((m1,), u32.i32_bits(init_balance), dtype=I32,
                         device=dev)
        bal[-1] = 0
        return SBShard(
            bal=bal, bck_bal=torch.cat([bal, bal]),
            x_step=torch.zeros((m1,), dtype=I32, device=dev),
            s_step=torch.zeros((m1,), dtype=I32, device=dev),
            step=2,
            log=logring.create_rep(log_lanes, log_capacity, VW, replicas=1,
                                   device=dev))

    return [one(mesh.device_of(p)) for p in range(n_shards)]


def total_balance_global(states: list) -> int:
    """The balance sum over every primary, sentinels excluded, as the
    signed i32 that wraps mod 2^32 (STAT_BAL_DELTA's accounting)."""
    return u32.i32_bits(sum(int(st.bal[:-1].sum(dtype=torch.int64))
                            for st in states))


def _route(dest, pos, valid, cap: int, n_shards: int, fields) -> torch.Tensor:
    """The per-lane int32 ``fields`` scattered into ``n_shards`` buckets of
    ``cap`` slots (slot ``dest * cap + pos``): an i32 [D*cap, F] tensor,
    zero where no lane landed. An invalid lane goes to a spill row of its
    own past the buckets, so one unique-index copy lands every lane."""
    n = dest.shape[0]
    dev = dest.device
    top = n_shards * cap
    idx = torch.where(valid, dest * cap + pos,
                      top + torch.arange(n, dtype=dest.dtype, device=dev))
    out = torch.zeros((top + n, len(fields)), dtype=I32, device=dev)
    out.index_copy_(0, idx.long(), torch.stack(list(fields), dim=1))
    return out[:top]


def _a2a(mesh: Mesh, xs: list) -> list:
    """Exchange the partitions' [D*cap, ...] buckets: partition s's bucket
    d lands at partition d's slot s."""
    return mesh.all_to_all(xs, AXIS)


def _positions(dest, active, n_shards: int) -> torch.Tensor:
    """Per-destination arrival ranks: pos[i] = #{j < i : dest[j] == dest[i],
    active j}, from the exclusive cumsum of a [D, wL] one-hot along its
    inner dimension (no sort)."""
    ids = torch.arange(n_shards, dtype=dest.dtype, device=dest.device)
    oh = ((dest[None, :] == ids[:, None]) & active[None, :]).to(I32)
    excl = torch.cumsum(oh, dim=1, dtype=I32) - oh
    return excl.gather(0, dest[None, :].long())[0]


@dataclass
class SBCtx:
    """A cohort between cross-device lock+compute and install."""
    acc: torch.Tensor        # i32 [w, L] global accounts
    tbl: torch.Tensor        # i32 [w, L]
    do_write: torch.Tensor   # bool [w, L]
    nw: torch.Tensor         # i32 [w, L]
    attempted: torch.Tensor  # i32 scalars from here on
    committed: torch.Tensor
    ab_lock: torch.Tensor
    ab_logic: torch.Tensor
    magic_bad: torch.Tensor
    bal_delta: torch.Tensor
    overflow: torch.Tensor   # lanes dropped by destination-bucket overflow


def _empty_sb_ctx(w: int, device) -> SBCtx:
    dev = torch.device(device)

    def z(shape, dt=I32):
        return torch.zeros(shape, dtype=dt, device=dev)

    return SBCtx(acc=z((w, L)), tbl=z((w, L)),
                 do_write=z((w, L), torch.bool), nw=z((w, L)),
                 attempted=z(()), committed=z(()), ab_lock=z(()),
                 ab_logic=z(()), magic_bad=z(()), bal_delta=z(()),
                 overflow=z(()))


def _stats_of(c: SBCtx) -> torch.Tensor:
    return torch.stack([c.attempted, c.committed, c.ab_lock, c.ab_logic,
                        c.magic_bad, c.bal_delta, c.overflow])


def _txn_ids(step: int, n_shards: int, dev: int, w: int,
             lane: torch.Tensor) -> torch.Tensor:
    """The txn id ``(step * D + dev) * w + lane`` in u32 arithmetic, as
    int32 bit patterns: the same id on every partition the txn touches."""
    base = ((step * n_shards + dev) * w) & u32.MASK32
    return u32.wrap_i32(base + lane)


def _columns(x):
    """A routed [D*cap, F] tensor as F contiguous [D*cap] columns."""
    return x.t().contiguous().unbind(0)


class _Phases:
    """The phases of one mesh step of sharded SmallBank, each over every
    partition before the next (a collective is a barrier, ROADMAP §C):
    generate, route the lock requests, arbitrate at the owners, reply and
    classify, route the previous cohort's installs, install and log at the
    owners, replicate, then count and trace. The exchange and the
    replication axis are parameters, so `multihost_sb` runs the same step
    over its 2-D mesh: ``exchange(list of [D*cap, F]) -> list`` lands
    partition s's bucket d in partition d's slot s; the backups of
    partition p sit at ``mesh.shift(p, repl_axis, 1)`` and ``2``.
    ``engine`` names the waves."""

    def __init__(self, mesh: Mesh, n_accounts: int, w: int, *, engine: str,
                 exchange, repl_axis: str, mix=None, hot_frac=None,
                 hot_prob=None, use_hotset: bool = False,
                 use_fused: bool = False, trace_on: bool = False):
        d = mesh.size
        self.mesh, self.d, self.w, self.devs = mesh, d, w, mesh.devices
        self.n_accounts = n_accounts
        self.engine, self.exchange, self.axis = engine, exchange, repl_axis
        self.use_hotset, self.use_fused = use_hotset, use_fused
        self.trace_on = trace_on
        self.n_loc = n_acct_local(n_accounts, d)
        self.m1 = m1_local(n_accounts, d)
        self.sent = self.m1 - 1
        self.cap = 2 * ((w * L + d - 1) // d)
        self.dc = d * self.cap
        self.hot_loc = 0
        if use_hotset:
            frac = wl.SB_HOT_FRAC if hot_frac is None else float(hot_frac)
            hot_n = max(1, min(int(n_accounts * frac), n_accounts))
            self.hot_loc = min((hot_n + d - 1) // d, self.n_loc)
        self.skew = {k: v for k, v in (("hot_frac", hot_frac),
                                       ("hot_prob", hot_prob))
                     if v is not None}
        # device constants, made once a card (a host-to-device copy
        # synchronises), then listed a partition
        self.thresh, self.lane_dc, self.lane_w, self.zero_ctx = map(
            list, zip(*mesh.per_partition(lambda dv: (
                mix_thresh(mix, dv),
                torch.arange(self.dc, dtype=I32, device=dv),
                torch.arange(w, dtype=torch.int64, device=dv),
                torch.zeros((), dtype=I32, device=dv)))))

    def mirror_idx(self, rr, mask):
        """Local row -> hot mirror index (tbl * hot_loc + q), -1 when cold;
        the sentinel row (q == n_loc) is never hot: hot_loc <= n_loc."""
        tb = (rr >= self.n_loc).to(I32)
        q = rr - tb * self.n_loc
        return torch.where(mask & (q < self.hot_loc),
                           tb * self.hot_loc + q, -1)

    def step_consts(self, t: int):
        """The step's stamp column and zero column over the D*cap slots,
        one of each a partition on its device."""
        stamps, zeros = zip(*self.mesh.per_partition(lambda dv: (
            torch.full((self.dc,), u32.i32_bits(t), dtype=I32, device=dv),
            torch.zeros((self.dc,), dtype=I32, device=dv))))
        return list(stamps), list(zeros)

    def gen(self, bits, ts_amt, gen_new: bool, t: int, occ=None) -> list:
        """Each partition's cohort from its draws (``bits[p]``,
        ``ts_amt[p]``), or an empty one; with ``occ`` (serve), the lock
        slots of the lanes past partition p's ``occ[p]`` are zeroed after
        the full-width draw."""
        w = self.w
        src = [{} for _ in range(self.d)]
        with waves.scope(self.engine, "gen"):
            for p, s in enumerate(src):
                dev = self.devs[p]
                if gen_new:
                    ttype, a1, a2 = gen_cohort_from_bits(
                        self.mesh.to_partition(bits[p], p), w,
                        self.n_accounts, thresh=self.thresh[p], **self.skew)
                    s["l_op"], s["l_tb"], s["l_ac"] = _lock_slots(ttype,
                                                                  a1, a2)
                    s["amt"] = self.mesh.to_partition(ts_amt[p], p)
                else:
                    ttype = torch.zeros((w,), dtype=I32, device=dev)
                    s["l_op"], s["l_tb"], s["l_ac"] = (
                        torch.zeros((w, L), dtype=I32, device=dev)
                        for _ in range(3))
                    s["amt"] = ttype
                s["ttype"] = ttype
                if self.trace_on:
                    s["txn_new"] = _txn_ids(t, self.d, p, w, self.lane_w[p])
                    s["txn_c1"] = _txn_ids(t - 1, self.d, p, w,
                                           self.lane_w[p])
        if occ is not None and gen_new:
            with waves.scope(self.engine, "serve"):
                for p, s in enumerate(src):
                    lane_ok = self.lane_w[p] < occ[p]
                    s["l_op"] = torch.where(lane_ok[:, None], s["l_op"], 0)
        return src

    def plan_route(self, s: dict):
        """Destination, bucket position and validity of each lock slot of
        one source partition (the source half of the route; no exchange)."""
        l_op, l_tb, l_ac = s["l_op"], s["l_tb"], s["l_ac"]
        d = self.d
        active = (l_op != 0).reshape(-1)
        dest = l_ac.reshape(-1) % d
        row_loc = l_tb.reshape(-1) * self.n_loc + l_ac.reshape(-1) // d
        pos = _positions(dest, active, d)
        valid = active & (pos < self.cap)
        s.update(active=active, dest=dest, pos=pos, valid=valid,
                 row_loc=row_loc)

    def route(self, src: list) -> list:
        """Every partition's lock+read requests to their owners, one
        exchange; returns each owner's routed [D*cap, F] requests."""
        sends = []
        for s in src:
            self.plan_route(s)
            fields = [s["l_op"].reshape(-1), s["row_loc"]]
            if self.trace_on:
                fields.append(s["txn_new"].repeat_interleave(L))
            sends.append(_route(s["dest"], s["pos"], s["valid"], self.cap,
                                self.d, fields))
        return self.exchange(sends)

    def arbitrate(self, states: list, recv: list, t: int) -> list:
        """Every owner: no-wait S/X arbitration + the balance read."""
        eng, m1 = self.engine, self.m1
        use_hotset, use_fused = self.use_hotset, self.use_fused
        t_now, t_held = u32.i32_bits(t), u32.i32_bits(t - 1)
        own = []
        for p, (st, rv) in enumerate(zip(states, recv)):
            dev, lane_dc = self.devs[p], self.lane_dc[p]
            r_op, r_row, *r_txn = _columns(rv)
            req = r_op != 0
            is_x = r_op == Op.ACQ_X_READ
            is_s = r_op == Op.ACQ_S_READ
            rows = torch.where(req, r_row, self.sent)
            if use_fused:
                # the held stamps and the balances, over the main arrays,
                # as the streams of one launch
                with waves.scope(eng, "lock_validate"):
                    hx, hs, raw_bal = gather_streams(
                        (st.x_step, st.s_step, st.bal), (rows, rows, rows),
                        (1, 1, 1))
            with waves.scope(eng, "arbitrate"):
                midx = self.mirror_idx(rows, req) if use_hotset else None
                # one launch: only the stamp writes below come between
                # these reads in JAX's order, and they never write bal
                if use_hotset and not use_fused:
                    hx, hs, raw_bal = gather_rows_hot(
                        (st.x_step, st.s_step, st.bal),
                        (st.hot_x, st.hot_s, st.hot_bal),
                        (rows, rows, rows), (midx, midx, midx), (1, 1, 1))
                elif not use_fused:
                    hx, hs, raw_bal = gather_rows(
                        (st.x_step, st.s_step, st.bal), (rows, rows, rows),
                        (1, 1, 1))
                # per row, the first X lane and the first S lane; lanes
                # without such a request go to the drop slot m1
                first_x = torch.full((m1 + 1,), BIG, dtype=I32, device=dev)
                first_x.scatter_reduce_(
                    0, torch.where(is_x, rows, m1).long(), lane_dc, "amin")
                first_s = torch.full((m1 + 1,), BIG, dtype=I32, device=dev)
                first_s.scatter_reduce_(
                    0, torch.where(is_s, rows, m1).long(), lane_dc, "amin")
                rows_l = rows.long()
                fx, fs = first_x[rows_l], first_s[rows_l]
                held_x, held_s = hx == t_held, hs == t_held
                x_wins = (fx < fs) & ~held_x & ~held_s
                grant_x = is_x & x_wins & (fx == lane_dc)
                grant_s = is_s & ~held_x & ~x_wins
                s_writer = grant_s & (fs == lane_dc)
                _stamp(st.x_step, rows, grant_x, t_now)
                _stamp(st.s_step, rows, s_writer, t_now)
                if use_hotset:
                    # one writer a row, so one a mirror index
                    _stamp(st.hot_x, midx, grant_x & (midx >= 0), t_now)
                    _stamp(st.hot_s, midx, s_writer & (midx >= 0), t_now)
                grant = grant_x | grant_s
                own.append(dict(
                    req=req, grant=grant, held=held_x | held_s, midx=midx,
                    r_txn=r_txn[0] if r_txn else None,
                    reply=torch.stack([grant.to(I32),
                                       torch.where(grant, raw_bal, 0)],
                                      dim=1)))
        return own

    def reply(self, src: list, own: list, attempted: list) -> list:
        """The replies back to the sources, one exchange; every source
        classifies its cohort and runs `compute_phase`. Returns the
        cohorts' `SBCtx`, partition p's attempted count ``attempted[p]``."""
        w, cap = self.w, self.cap
        replies = self.exchange([o["reply"] for o in own])
        ctxs = []
        for p, s in enumerate(src):
            l_op, valid = s["l_op"], s["valid"]
            back = torch.where(valid, s["dest"] * cap + s["pos"], 0)
            rep = replies[p][back.long()]
            granted = (valid & (rep[:, 0] != 0)).view(w, L)
            bal = torch.where(granted, rep[:, 1].view(w, L), 0)
            # an overflowed lane is not valid, so not granted: the
            # no-wait reject covers it
            lock_rejected = ((l_op != 0) & ~granted).any(dim=1)
            lead = l_op[:, 0] != 0
            alive = ~lock_rejected & lead
            nw, do, logic_abort, commit, committed = compute_phase(
                s["ttype"], bal, alive, s["amt"])
            do_write = do & commit[:, None] & (l_op != 0)
            bal_delta = u32.wrap_i32(torch.where(
                do_write, nw.long() - bal.long(), 0).sum())
            ab_lock_m = lock_rejected & lead
            s.update(lead=lead, commit=commit, committed=committed,
                     logic_abort=logic_abort, ab_lock_m=ab_lock_m)
            ctxs.append(SBCtx(
                acc=s["l_ac"], tbl=s["l_tb"], do_write=do_write, nw=nw,
                attempted=attempted[p],
                committed=committed.sum(dtype=I32),
                ab_lock=ab_lock_m.sum(dtype=I32),
                ab_logic=logic_abort.sum(dtype=I32),
                magic_bad=self.zero_ctx[p],
                bal_delta=bal_delta,
                overflow=(s["active"] & ~valid).sum(dtype=I32)))
        return ctxs

    def install_route(self, c1s: list, src: list) -> list:
        """Every partition routes its previous cohort's installs to their
        owners, one exchange (``src[p]`` keeps ``wdest``/``wvalid``)."""
        d, n_loc, cap = self.d, self.n_loc, self.cap
        isends = []
        for p, c1 in enumerate(c1s):
            wmask = c1.do_write.reshape(-1)
            acc = c1.acc.reshape(-1)
            wdest = acc % d
            wrow = c1.tbl.reshape(-1) * n_loc + acc // d
            wpos = _positions(wdest, wmask, d)
            wvalid = wmask & (wpos < cap)    # writes <= locks: no overflow
            fields = [wmask.to(I32), wrow, c1.nw.reshape(-1),
                      c1.tbl.reshape(-1), acc]
            if self.trace_on:
                fields.append(src[p]["txn_c1"].repeat_interleave(L))
            src[p].update(wdest=wdest, wvalid=wvalid)
            isends.append(_route(wdest, wpos, wvalid, cap, d, fields))
        return self.exchange(isends)

    def install(self, states: list, own: list, inst: list, stepv,
                zero) -> list:
        """Every owner installs its routed writes and logs them (CommitLog
        at the primary); returns each owner's applied records. ``stepv``
        and ``zero``: `step_consts`, one a partition."""
        eng, use_hotset = self.engine, self.use_hotset
        recs = []
        for st, o, ins, sv, zv in zip(states, own, inst, stepv, zero):
            i_m, i_row, i_bal, i_tbl, i_acc, *i_txn = _columns(ins)
            i_mask = i_m != 0
            newval = torch.stack([i_bal, zv], dim=1)
            i_midx = self.mirror_idx(i_row, i_mask) if use_hotset else None
            if self.use_fused:
                # the install, the log append and (hot tier) the mirror
                # write-through as the streams of one launch; the log plan
                # routes masked lanes to -1
                with waves.scope(eng, "install_log"):
                    lflat, entry, lane_counts = logring.plan_rep(
                        st.log, i_mask, i_tbl, zv, zv, i_acc, sv,
                        newval)
                    tabs = [st.bal, st.log.entries.view(-1)]
                    idxs = [torch.where(i_mask, i_row, -1), lflat.to(I32)]
                    vals = [i_bal, entry.reshape(-1)]
                    vws = [1, st.log.entries.shape[1]]
                    if use_hotset:
                        tabs.append(st.hot_bal)
                        idxs.append(i_midx)
                        vals.append(i_bal)
                        vws.append(1)
                    scatter_streams(tabs, idxs, vals, vws)
                    st.log.head = u32.wrap_i32(u32.to_u64(st.log.head)
                                               + lane_counts)
            else:
                with waves.scope(eng, "install_route"):
                    if use_hotset:
                        scatter_rows_hot(st.bal, st.hot_bal, i_row, i_midx,
                                         i_mask, i_bal, 1)
                    else:
                        keep = torch.nonzero(i_mask).squeeze(1)
                        st.bal[i_row[keep].long()] = i_bal[keep]
                    logring.append_rep(st.log, i_mask, i_tbl, zv, zv,
                                       i_acc, sv, newval)
            i_txn = i_txn[0] if i_txn else None
            o.update(i_mask=i_mask, i_txn=i_txn, repl=[])
            recs.append((i_mask, i_row, i_bal, i_tbl, i_acc, i_txn))
        return recs

    def replicate(self, states: list, own: list, recs: list, cnts: list,
                  t: int, stepv, zero):
        """CommitBck x2 + CommitLog at the backups: hop 1 on every
        partition, then hop 2, each along the replication axis."""
        mesh, axis, m1 = self.mesh, self.axis, self.m1
        for off in (1, 2):
            fwd = mesh.ppermute(recs, axis, off)
            hop = (mon.CTR_REPL_PUSH_HOP1 if off == 1
                   else mon.CTR_REPL_PUSH_HOP2)
            for p, (st, o) in enumerate(zip(states, own)):
                f_mask, f_row, f_bal, f_tbl, f_acc, f_txn = fwd[p]
                zp = zero[p]
                # counted where they are applied
                mon.bump(cnts[p], {hop: f_mask.sum(dtype=I32)})
                if self.trace_on:
                    # the forwarded id joins the backup's event to the
                    # txn; shard = the applying partition
                    o["repl"].append(txe.ev(
                        f_mask, f_txn, txe.EV_REPL,
                        waves.full_name(self.engine, "replicate"),
                        shard=p, aux=off, step=t))
                keep = torch.nonzero(f_mask).squeeze(1)
                st.bck_bal[(off - 1) * m1 + f_row[keep].long()] = \
                    f_bal[keep]
                # key_hi = source + 1 (own entries log 0), so recovery
                # can check a ring's streams against acct % D
                tag = mesh.shift(p, axis, -off) + 1
                logring.append_rep(
                    st.log, f_mask, f_tbl, zp,
                    torch.full_like(zp, tag), f_acc, stepv[p],
                    torch.stack([f_bal, zp], dim=1))

    def counts(self, own: list, c1s: list) -> list:
        """Each partition's counter increments of the step (txn outcomes
        and routing overflow at the source, lock arbitration and installs
        at the owner; the replication pushes are counted in `replicate`)."""
        use_hotset, dc, hot_loc = self.use_hotset, self.dc, self.hot_loc
        out = []
        for o, c1 in zip(own, c1s):
            upd = {}
            if use_hotset:
                # three partitioned gathers a step, each serving its hot
                # lanes from the mirrors; the fused route reads the main
                # arrays, so none of its gathers is partitioned. Refresh
                # bytes are what JAX's kernel route counts
                n_g = 0 if self.use_fused else 3
                hits = (o["midx"] >= 0).sum(dtype=I32)
                upd.update({mon.CTR_HOT_HITS: n_g * hits,
                            mon.CTR_HOT_COLD_ROWS: n_g * dc - n_g * hits,
                            mon.CTR_HOT_REFRESH_BYTES:
                                n_g * 2 * hot_loc * 4})
            rej = o["req"] & ~o["grant"]
            n_inst = o["i_mask"].sum(dtype=I32)
            upd.update({
                mon.CTR_STEPS: 1,
                mon.CTR_TXN_ATTEMPTED: c1.attempted,
                mon.CTR_TXN_COMMITTED: c1.committed,
                mon.CTR_AB_LOCK: c1.ab_lock,
                mon.CTR_AB_LOGIC: c1.ab_logic,
                mon.CTR_MAGIC_BAD: c1.magic_bad,
                mon.CTR_ROUTE_OVERFLOW: c1.overflow,
                mon.CTR_LOCK_REQUESTS: o["req"].sum(dtype=I32),
                mon.CTR_LOCK_GRANTED: o["grant"].sum(dtype=I32),
                mon.CTR_LOCK_REJECTED: rej.sum(dtype=I32),
                mon.CTR_LOCK_REJECT_HELD: (rej & o["held"]).sum(dtype=I32),
                mon.CTR_LOCK_REJECT_ARB: (rej & ~o["held"]).sum(dtype=I32),
                mon.CTR_INSTALL_WRITES: n_inst,
                mon.CTR_LOG_APPENDS: n_inst,
                mon.CTR_DISPATCH_PALLAS: 1,   # the kernel route
                **({mon.CTR_FUSED_DISPATCH: 1} if self.use_fused else {}),
            })
            out.append(upd)
        return out

    def trace(self, rings: list, cnts: list, tcfg, src: list, own: list,
              t: int, route_aux=None):
        """Each event lands on one partition: ROUTE, VOTE and OUTCOME at
        the source, LOCK and INSTALL at the owner, REPL at the applying
        backup, as the counters are attributed. A ROUTE event's aux is its
        destination, or ``route_aux(p, dest)``."""
        eng = self.engine
        with waves.scope(eng, "trace"):
            for p, (s, o) in enumerate(zip(src, own)):
                lock_aux = (torch.where(o["grant"], txe.LOCK_GRANTED, 0)
                            | torch.where(o["held"], txe.LOCK_HELD, 0))
                cause = torch.where(
                    s["ab_lock_m"], txe.CAUSE_LOCK,
                    torch.where(s["logic_abort"], txe.CAUSE_LOGIC,
                                txe.CAUSE_COMMIT))
                out_mask = (s["committed"] | s["ab_lock_m"]
                            | s["logic_abort"])
                aux = (s["dest"] if route_aux is None
                       else route_aux(p, s["dest"]))
                groups = (
                    txe.ev(s["valid"], s["txn_new"].repeat_interleave(L),
                           txe.EV_ROUTE, waves.full_name(eng, "route"),
                           shard=p, aux=aux, step=t),
                    txe.ev(o["req"], o["r_txn"], txe.EV_LOCK,
                           waves.full_name(eng, "arbitrate"),
                           shard=p, aux=lock_aux, step=t),
                    txe.ev(s["lead"], s["txn_new"], txe.EV_VOTE,
                           waves.full_name(eng, "reply"),
                           shard=p, aux=s["commit"], step=t),
                    txe.ev(o["i_mask"], o["i_txn"], txe.EV_INSTALL,
                           waves.full_name(eng, "install_route"),
                           shard=p, step=t),
                    *o["repl"],
                    txe.ev(out_mask, s["txn_new"], txe.EV_OUTCOME,
                           waves.full_name(eng, "reply"),
                           shard=p, aux=cause, step=t),
                )
                txe.emit(rings[p], tcfg, groups, cnts[p])


def _n_step_events(w: int, dc: int) -> int:
    """Candidate events a partition a step: ROUTE wL + owner LOCK D*cap +
    VOTE w + owner INSTALL D*cap + REPL x2 2*D*cap + OUTCOME w."""
    return w * L + 4 * dc + 2 * w


def build_sharded_sb_runner(mesh: Mesh, n_shards: int, n_accounts: int,
                            w: int = 2048, cohorts_per_block: int = 8,
                            hot_frac=None, hot_prob=None, mix=None,
                            use_hotset: bool = False,
                            use_fused: bool = False, monitor: bool = False,
                            trace=None, trace_rate=None, trace_cap=None):
    """A loop of mesh steps over lists, one entry a partition; the contract
    of the JAX runner:

    * ``run(carry, gen)`` draws a block's bits [cpb, D, w, 5] and
      transact_saving amounts [cpb, D, w] with the torch generator ``gen``
      on the mesh's home device (`smallbank_pipeline.draw_step`) and calls
      ``run.run_draws``;
    * ``run.run_draws(carry, bits, ts_amt)`` runs ``cohorts_per_block``
      steps on the given draws (partition d's step i takes ``bits[i, d]``,
      copied to its card, where JAX's draws from ``fold_in(split(
      block_key, cpb)[i], d)``) and returns (carry, stats i32 [cpb,
      N_STATS] summed over the partitions on the home device);
    * ``init(states)`` -> carry (states, ctxs[, rings][, counters]) with an
      empty in-flight cohort a partition; with ``use_hotset`` it first
      attaches the hot mirrors to partitions that have none;
    * ``drain(carry)`` runs the flush step, which draws nothing, and
      returns (states, stats [1, N_STATS][, rings][, counters]).

    ``use_hotset``/``use_fused``: the route (module docstring); the hot set
    is the workload's (``hot_frac``, else SB_HOT_FRAC), ``hot_loc =
    min(ceil(hot_n / D), n_loc)`` accounts a partition. ``monitor``: a
    `monitor.counters.Counters` a partition, last in the carry: txn
    outcomes and routing overflow count at the source, lock arbitration
    and installs at the owner, replication pushes at the receiving backup,
    so their sums over the partitions reconcile with the stats.
    ``trace``/``trace_rate``/``trace_cap``: the flight recorder, one
    `TxnRing` a partition before the counters (None = DINT_TRACE /
    DINT_TRACE_RATE; ``trace_cap`` defaults to a block of candidates,
    ``(wL + 4*D*cap + 2w) * cpb``). The txn id ``(step*D + source)*w +
    lane`` rides the lock route and the install route as one more field
    and the replication hops forward it, so the source's ROUTE, VOTE and
    OUTCOME, the owner's LOCK and INSTALL and the backups' REPL events of
    one transaction join into one span tree; ``init.trace_cfg`` is the
    `TraceCfg` (None when off)."""
    _check_mesh(mesh, n_shards)
    if w * L >= BIG:
        raise ValueError(f"w={w} exceeds the lane field of the scatter-mins")
    home, devs = mesh.device, mesh.devices
    d, cpb = n_shards, cohorts_per_block
    trace_on = txe.trace_enabled(trace)
    ph = _Phases(mesh, n_accounts, w, engine=_ENGINE,
                 exchange=lambda xs: _a2a(mesh, xs), repl_axis=AXIS,
                 mix=mix, hot_frac=hot_frac, hot_prob=hot_prob,
                 use_hotset=use_hotset, use_fused=use_fused,
                 trace_on=trace_on)
    n_step = _n_step_events(w, ph.dc)
    tcfg = None
    if trace_on:
        rcap = int(trace_cap) if trace_cap else n_step * cpb
        tcfg = txe.TraceCfg(rate=txe.trace_rate(trace_rate), cap=rcap,
                            wave=waves.full_name(_ENGINE, "trace"))
    # the attempted count of a full and an empty cohort, a partition
    n_att = {g: mesh.per_partition(
        lambda dv, g=g: torch.full((), w if g else 0, dtype=I32, device=dv))
        for g in (False, True)}

    def step(carry, bits, ts_amt, gen_new=True):
        states, c1s = carry[0], carry[1]
        rings = carry[2] if trace_on else [None] * d
        cnts = carry[-1] if monitor else [None] * d
        t = states[0].step

        # ---- wave 1: every partition generates its cohort and routes its
        # lock+read requests to their owners; every owner arbitrates and
        # reads; the replies go back and every source classifies
        src = ph.gen(bits, ts_amt, gen_new, t)
        with waves.scope(_ENGINE, "route"):
            recv = ph.route(src)
        own = ph.arbitrate(states, recv, t)
        with waves.scope(_ENGINE, "reply"):
            ctxs = ph.reply(src, own, n_att[gen_new])

        # ---- wave 2 of c1: every partition routes its installs, every
        # owner installs and logs them, then the backups
        with waves.scope(_ENGINE, "install_route"):
            inst = ph.install_route(c1s, src)
        stepv, zero = ph.step_consts(t)
        recs = ph.install(states, own, inst, stepv, zero)
        with waves.scope(_ENGINE, "replicate"):
            ph.replicate(states, own, recs, cnts, t, stepv, zero)

        for st in states:
            st.step = t + 1

        if monitor:
            for st, cnt, upd in zip(states, cnts, ph.counts(own, c1s)):
                mon.bump(cnt, upd)
                mon.gauge_max(cnt, {
                    mon.CTR_RING_HWM: u32.to_u64(st.log.head).max()})

        if trace_on:
            ph.trace(rings, cnts, tcfg, src, own, t)

        stats = mesh.psum([_stats_of(c) for c in c1s])
        return (states, ctxs) + tuple(carry[2:]), stats

    def run_draws(carry, bits, ts_amt):
        want_b, want_a = (cpb, d, w, 5), (cpb, d, w)
        if tuple(bits.shape) != want_b or tuple(ts_amt.shape) != want_a:
            raise ValueError(f"expected bits {list(want_b)} and ts_amt "
                             f"{list(want_a)}, got {tuple(bits.shape)} and "
                             f"{tuple(ts_amt.shape)}")
        if trace_on:            # each drained window is self-contained
            for r in carry[2]:
                txe.reset(r)
        stats = []
        for i in range(cpb):
            carry, s = step(carry, bits[i], ts_amt[i])
            stats.append(s)
        return carry, torch.stack(stats)

    def run(carry, gen: torch.Generator):
        with waves.scope(_ENGINE, "gen"):
            draws = draw_step(gen, (cpb, d, w), home)
        return run_draws(carry, *draws)

    run.run_draws = run_draws

    def init(states: list):
        if len(states) != d:
            raise ValueError(f"{len(states)} states for {d} partitions")
        _check_placement(mesh, states)
        states = list(states)
        if use_hotset and states[0].hot_loc == 0:
            states = attach_hotset_sb(mesh, states, ph.hot_loc)
        return ((states, [_empty_sb_ctx(w, dv) for dv in devs])
                + (([txe.create_ring(tcfg.cap, dv, spill=n_step)
                     for dv in devs],) if trace_on else ())
                + (([mon.create(dv) for dv in devs],) if monitor else ()))

    init.trace_cfg = tcfg

    def drain(carry):
        if trace_on:
            for r in carry[2]:
                txe.reset(r)
        carry, s = step(carry, None, None, gen_new=False)
        return (carry[0], s[None]) + tuple(carry[2:])

    return run, init, drain
