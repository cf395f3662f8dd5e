"""The SmallBank transaction pipeline over three replicated shard servers
(the port of `dint_tpu.engines.smallbank_pipeline`): cohort generation,
lock sets and balance logic, which the dense engine shares, and the
generic engine's runner over `smallbank.step`.

A cohort of w txns runs two waves against the three replicas, each a
`smallbank.step` per replica (smallbank/caladan/client_ebpf_shard.cc:
389-560): wave 1 takes up to three fused X/S lock+reads a txn at each
account's owner shard (account % 3); after the balance logic, wave 2
appends the log on all shards, installs at the owner (PRIM) and the
backups (BCK), and releases every granted lock at its owner. Stats carry
the signed sum of the committed balance deltas, so a window checks
balance conservation without reading the tables.

What differs from JAX: draws are fed, not made. A cohort consumes
``bits`` [w, 5] (`gen_cohort_from_bits`) and ``ts_amt`` [w] (the
transact_saving amounts); the runner draws both with a `torch.Generator`
(`draw_step`) or takes them as given (``run.run_draws``), so the tests
replay JAX's draws. The three replicas are a list of three
`smallbank.Shard`s with storage of their own (JAX stacks them and vmaps
`smallbank.step`); a step updates each in place, in turn.
"""
from __future__ import annotations

import torch

from ..clients import workloads as wl
from ..device import resolve_device
from ..monitor import counters as mon
from ..monitor import waves
from ..ops.u32 import to_u64, wrap_i32
from . import smallbank
from .tatp_pipeline import (PAD32, _broadcast_batch, _merge, _step_all,
                            draw_bits)
from .types import Op, Reply

I32 = torch.int32

N_SHARDS = 3
L = 3                  # lock slots per txn
AMT = 5                # fixed amount for deposit/send_payment/write_check
TS_AMT_MAX = 20        # transact_saving draws a SIGNED amount in
#                        [-TS_AMT_MAX, TS_AMT_MAX]: withdrawals can overdraw
MAGIC = wl.SB_MAGIC
VW = 2                 # log value words: word0 = balance, word1 = magic

# stats vector layout
STAT_ATTEMPTED = 0
STAT_COMMITTED = 1
STAT_AB_LOCK = 2
STAT_AB_LOGIC = 3
STAT_MAGIC_BAD = 4
STAT_BAL_DELTA = 5     # signed; sums the window's committed balance deltas
N_STATS = 6


def mix_thresh(mix, device) -> torch.Tensor:
    """The cumulative u32 txn-mix thresholds as int64 on ``device``; made
    once per runner, since a host-to-device copy synchronises the stream."""
    return torch.as_tensor(
        wl.mix_thresholds(wl.SB_MIX if mix is None else mix)
        .astype("int64"), device=device)


def draw_step(gen: torch.Generator, shape, device):
    """One cohort's draws for ``shape`` = (..., w): ``bits`` [..., w, 5]
    (u32 patterns) and ``ts_amt`` [..., w] i32 in [-TS_AMT_MAX,
    TS_AMT_MAX], drawn with ``gen`` on ``device``."""
    shape = tuple(shape)
    bits = draw_bits(gen, shape + (5,), device)
    ts_amt = torch.randint(-TS_AMT_MAX, TS_AMT_MAX + 1, shape, dtype=I32,
                           generator=gen, device=device)
    return bits, ts_amt


def gen_cohort_from_bits(bits: torch.Tensor, w: int, n_accounts: int,
                         hot_frac: float = wl.SB_HOT_FRAC,
                         hot_prob: float = wl.SB_HOT_PROB, mix=None,
                         thresh: torch.Tensor | None = None):
    """Workload generation (smallbank/caladan/smallbank.h:29-50) from one
    [w, 5] u32 draw: word 0 picks the txn type by searchsorted over the
    cumulative mix (side="right", clamped to 5); words 1-2 are the two
    accounts, each reduced into the hot set (the first ``hot_frac`` of the
    keyspace) when its coin (words 3-4) is below ``hot_prob`` and into the
    whole keyspace otherwise. Every reduction is unsigned (int64 here). A
    second account equal to the first moves to the next account.

    ``thresh`` (`mix_thresh` of ``mix``) may be passed in so that a loop of
    steps copies it to the device once. Returns (ttype, a1, a2) i32 [w]."""
    if thresh is None:
        thresh = mix_thresh(mix, bits.device)
    b = to_u64(bits)
    ttype = torch.searchsorted(thresh, b[:, 0].contiguous(),
                               right=True).clamp(max=5)
    hot_n = max(int(n_accounts * hot_frac), 1)
    hot_cut = min(int(hot_prob * 2.0**32), 0xFFFFFFFF)

    def sample(word, coin):
        return torch.where(coin < hot_cut, word % hot_n, word % n_accounts)

    a1 = sample(b[:, 1], b[:, 3])
    a2 = sample(b[:, 2], b[:, 4])
    a2 = torch.where(a1 == a2, (a2 + 1) % n_accounts, a2)
    return ttype.to(I32), a1.to(I32), a2.to(I32)


def _lock_slots(ttype, a1, a2):
    """Per-txn lock set [w, L]: (op, table, acct), the reference's per-txn
    lock lists (client_ebpf_shard.cc TxnAmalgamate:255 etc.):

    slot 0: amalgamate/transact X SAV, balance/write_check S SAV,
            deposit/send_payment X CHK (of a1)
    slot 1: amalgamate/send_payment/write_check X CHK, balance S CHK
            (of a2 for send_payment, else a1)
    slot 2: amalgamate X CHK of a2."""
    sav, chk = smallbank.SAVINGS, smallbank.CHECKING
    x, s = Op.ACQ_X_READ, Op.ACQ_S_READ
    t = ttype
    is_am = t == wl.SB_AMALGAMATE
    is_ba = t == wl.SB_BALANCE
    is_de = t == wl.SB_DEPOSIT
    is_sp = t == wl.SB_SEND_PAYMENT
    is_ts = t == wl.SB_TRANSACT_SAVING
    is_wc = t == wl.SB_WRITE_CHECK

    def sel(x_cond, s_cond):
        return torch.where(x_cond, x, torch.where(s_cond, s, 0))

    op0 = sel(is_am | is_de | is_sp | is_ts, is_ba | is_wc)
    op1 = sel(is_am | is_sp | is_wc, is_ba)
    op2 = torch.where(is_am, x, 0)
    tb0 = torch.where(is_de | is_sp, chk, sav)
    tb12 = torch.full_like(t, chk)
    ops = torch.stack([op0, op1, op2], dim=1).to(I32)
    tbl = torch.stack([tb0, tb12, tb12], dim=1).to(I32)
    acc = torch.stack([a1, torch.where(is_sp, a2, a1), a2], dim=1).to(I32)
    return ops, tbl, acc


def compute_phase(ttype, bal, alive, ts_amt):
    """Per-txn-type balance logic (client_ebpf_shard.cc TxnAmalgamate:255 /
    TxnSendPayment:830 / TxnTransactSaving:1116 / TxnWriteCheck:1241).

    ``bal`` [w, L] i32 are the fused-read balances of the txn's lock slots;
    all sums are i32 and wrap, as in JAX. Returns (nw [w, L] new balances,
    do [w, L] slots written, logic_abort [w], commit [w] writes install,
    committed [w])."""
    t = ttype
    b0, b1, b2 = bal.unbind(1)
    am = alive & (t == wl.SB_AMALGAMATE)
    de = alive & (t == wl.SB_DEPOSIT)
    sp = alive & (t == wl.SB_SEND_PAYMENT)
    ts = alive & (t == wl.SB_TRANSACT_SAVING)
    wc = alive & (t == wl.SB_WRITE_CHECK)
    insufficient = b0 < AMT
    sp_ok = sp & ~insufficient
    neg = (b0 + ts_amt) < 0
    ts_ok = ts & ~neg
    overdraw = (b0 + b1) < AMT
    logic_abort = (sp & insufficient) | (ts & neg)

    zero = torch.zeros_like(b0)
    nw0 = torch.where(de, b0 + AMT, torch.where(
        sp_ok, b0 - AMT, torch.where(ts_ok, b0 + ts_amt, zero)))
    nw1 = torch.where(wc, b1 - AMT - overdraw.to(I32),
                      torch.where(sp_ok, b1 + AMT, zero))
    nw2 = torch.where(am, b2 + b0 + b1, zero)
    nw = torch.stack([nw0, nw1, nw2], dim=1)
    do = torch.stack([am | de | sp_ok | ts_ok, am | sp_ok | wc, am], dim=1)

    commit = alive & ~logic_abort & (t != wl.SB_BALANCE)
    committed = commit | (alive & (t == wl.SB_BALANCE))
    return nw, do, logic_abort, commit, committed


# ------------------------------------------------ the generic engine's runner


def create_stacked(n_accounts: int, init_balance: int = 1000,
                   log_capacity: int = 1 << 20, device=None) -> list:
    """Three identically populated replicas (the reference populates every
    record on all 3 servers, smallbank/ebpf/shard_user.c:74-77): balance
    ``init_balance`` and the magic word in every account, version 1, and
    16-lane logs of ``log_capacity`` entries a lane (JAX's takes the
    default 2^20). Built on ``device`` (None = CUDA), each replica with
    storage of its own."""
    dev = resolve_device(device)

    def one():
        s = smallbank.create(n_accounts, val_words=VW,
                             log_capacity=log_capacity, device=dev)
        for t in (s.sav, s.chk):
            val = t.val.view(n_accounts, VW)
            val[:, 0].fill_(init_balance)
            val[:, 1].fill_(MAGIC)
            t.ver.fill_(1)
        return s

    return [one() for _ in range(N_SHARDS)]


def total_balance(stacked, replica: int = 0) -> torch.Tensor:
    """The balance sum of one replica as an i32 that wraps mod 2^32, as
    JAX's i32 accumulate does; conservation compares deltas under the same
    wrap."""
    s = stacked[replica]
    vw = s.sav.val_words
    return wrap_i32(s.sav.val[0::vw].sum(dtype=torch.int64)
                    + s.chk.val[0::vw].sum(dtype=torch.int64))


def cohort_step(stacked, bits, ts_amt, *, w: int, n_accounts: int,
                counters: mon.Counters | None = None,
                thresh: torch.Tensor | None = None):
    """One full cohort of w txns (``bits`` [w, 5], ``ts_amt`` [w]) against
    the three replicas, in place. Returns (stacked, stats [N_STATS] i32),
    plus the counters (bumped in place) when ``counters`` is given."""
    dev = bits.device
    with waves.scope("smallbank_pipeline", "gen"):
        ttype, a1, a2 = gen_cohort_from_bits(bits, w, n_accounts,
                                             thresh=thresh)
        l_op, l_tb, l_ac = _lock_slots(ttype, a1, a2)       # [w, L]
    r = w * L
    lane_op = l_op.reshape(r)
    lane_tbl = l_tb.reshape(r)
    lane_acc = l_ac.reshape(r)
    used = lane_op != Op.NOP
    lane_key = torch.where(used, lane_acc, PAD32)
    owner = lane_acc % N_SHARDS
    sid = torch.arange(N_SHARDS, dtype=I32, device=dev)
    at_owner = owner[None] == sid[:, None]               # [S, r]
    zval = torch.zeros((r, VW), dtype=I32, device=dev)
    zver = torch.zeros((r,), dtype=I32, device=dev)

    # ---- wave 1: fused lock+read at owners
    with waves.scope("smallbank_pipeline", "wave1"):
        op_s = torch.where(at_owner & used[None], lane_op[None], Op.NOP)
        rep1 = _step_all(smallbank.step, stacked, _broadcast_batch(
            op_s, lane_tbl, lane_key, zval, zver))
        rt1 = _merge(owner, rep1.rtype).view(w, L)
        rv1 = _merge(owner, rep1.val)                       # [r, VW]
        rver1 = _merge(owner, rep1.ver).view(w, L)

        active = l_op != Op.NOP
        granted = active & (rt1 == Reply.GRANT)
        magic_bad = (granted.reshape(r) & (rv1[:, 1] != MAGIC)).sum(dtype=I32)
        lock_rejected = (active & (rt1 == Reply.REJECT)).any(dim=1)
        alive = ~lock_rejected
        bal = torch.where(granted, rv1[:, 0].view(w, L), 0)  # [w, L] i32

    with waves.scope("smallbank_pipeline", "compute"):
        nw, do, logic_abort, commit, committed = compute_phase(
            ttype, bal, alive, ts_amt)
        do_write = do & commit[:, None] & active             # [w, L]
        bal_delta = wrap_i32(torch.where(do_write, nw.long() - bal.long(), 0)
                             .sum())

    # ---- wave 2: log x3 + role (prim/bck) + release
    with waves.scope("smallbank_pipeline", "wave2"):
        dwf = do_write.reshape(r)
        c_val = torch.zeros((r, VW), dtype=I32, device=dev)
        c_val[:, 0] = nw.reshape(r)
        c_val[:, 1] = torch.where(dwf, MAGIC, 0)
        c_ver = wrap_i32(torch.where(do_write, to_u64(rver1) + 1,
                                     0)).reshape(r)
        c_key = torch.where(dwf, lane_acc, PAD32)
        log_op = torch.where(dwf, Op.COMMIT_LOG, Op.NOP)    # all shards
        role_s = torch.where(dwf[None], torch.where(at_owner, Op.COMMIT_PRIM,
                                                    Op.COMMIT_BCK), Op.NOP)
        relf = granted.reshape(r)
        rel_op = torch.where(lane_op == Op.ACQ_X_READ, Op.REL_X, Op.REL_S)
        rel_s = torch.where(relf[None] & at_owner, rel_op[None], Op.NOP)
        rel_key = torch.where(relf, lane_acc, PAD32)
        op2_s = torch.cat([log_op[None].expand(N_SHARDS, r), role_s, rel_s],
                          dim=1).to(I32)
        _step_all(smallbank.step, stacked, _broadcast_batch(
            op2_s, torch.cat([lane_tbl, lane_tbl, lane_tbl]),
            torch.cat([c_key, c_key, rel_key]),
            torch.cat([c_val, c_val, zval]),
            torch.cat([c_ver, c_ver, zver])))

    stats = torch.stack([
        torch.full((), w, dtype=I32, device=dev), committed.sum(dtype=I32),
        lock_rejected.sum(dtype=I32), logic_abort.sum(dtype=I32), magic_bad,
        bal_delta])
    if counters is None:
        return stacked, stats
    n_writes = do_write.sum(dtype=I32)
    mon.bump(counters, {
        mon.CTR_STEPS: 1,
        mon.CTR_TXN_ATTEMPTED: stats[STAT_ATTEMPTED],
        mon.CTR_TXN_COMMITTED: stats[STAT_COMMITTED],
        mon.CTR_AB_LOCK: stats[STAT_AB_LOCK],
        mon.CTR_AB_LOGIC: stats[STAT_AB_LOGIC],
        mon.CTR_MAGIC_BAD: magic_bad,
        mon.CTR_LOCK_REQUESTS: active.sum(dtype=I32),
        mon.CTR_LOCK_GRANTED: granted.sum(dtype=I32),
        mon.CTR_LOCK_REJECTED: (active & ~granted).sum(dtype=I32),
        mon.CTR_INSTALL_WRITES: n_writes,
        mon.CTR_LOG_APPENDS: n_writes,
        mon.CTR_DISPATCH_XLA: 1,    # the plain route, JAX's XLA one
    })
    return stacked, stats, counters


def build_runner(n_accounts: int, w: int = 4096, cohorts_per_block: int = 8,
                 monitor: bool = False, device=None):
    """A loop of `cohort_step`: ``run(carry, gen)`` draws a block's bits
    [cpb, w, 5] and amounts [cpb, w] with the torch generator ``gen`` and
    runs ``cohorts_per_block`` cohorts, in place; ``run.run_draws(carry,
    bits, ts_amt)`` takes the draws as given. Both return (carry, stats
    [cpb, N_STATS]). The carry is the replica list, or (replicas,
    counters) with ``monitor`` (`monitor.counters.create` on the device)."""
    dev = resolve_device(device)
    cpb = cohorts_per_block
    thresh = mix_thresh(None, dev)

    def run_draws(carry, bits, ts_amt):
        if tuple(bits.shape) != (cpb, w, 5) or \
                tuple(ts_amt.shape) != (cpb, w):
            raise ValueError(f"expected bits [{cpb}, {w}, 5] and ts_amt "
                             f"[{cpb}, {w}], got {tuple(bits.shape)} and "
                             f"{tuple(ts_amt.shape)}")
        stacked, cnt = carry if monitor else (carry, None)
        if len(stacked) != N_SHARDS or \
                stacked[0].sav.ver.device.type != dev.type:
            raise ValueError(f"expected {N_SHARDS} replicas on {dev}")
        stats = []
        for i in range(cpb):
            out = cohort_step(stacked, bits[i], ts_amt[i], w=w,
                              n_accounts=n_accounts, counters=cnt,
                              thresh=thresh)
            stats.append(out[1])
        return (stacked, cnt) if monitor else stacked, torch.stack(stats)

    def run(carry, gen: torch.Generator):
        return run_draws(carry, *draw_step(gen, (cpb, w), dev))

    run.run_draws = run_draws
    return run
