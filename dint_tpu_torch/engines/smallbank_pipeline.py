"""SmallBank cohort generation, lock sets and balance logic (the dense
engine's part of `dint_tpu.engines.smallbank_pipeline`).

`gen_cohort_from_bits` is the pure function of one ``[w, 5]`` u32 draw; the
JAX `gen_cohort` makes that draw itself with `jax.random.bits`. The port
draws with a `torch.Generator` instead (`draw_step`), so it gives other
cohorts than JAX from the same seed, and the tests feed both the same bits.
"""
from __future__ import annotations

import torch

from ..clients import workloads as wl
from ..ops.u32 import to_u64
from . import smallbank
from .tatp_pipeline import draw_bits
from .types import Op

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
