"""The plain reference of the SmallBank cells: SmallBank under no-wait
two-phase locking over hashed lock slots, in plain PyTorch.

It imports nothing of the measured package and takes nothing it made: it
decodes the benchmark's draws itself and starts from the benchmark's
balances. A step is the pipeline the configuration states (DINT
smallbank/caladan/client_ebpf_shard.cc:389-560, the balance logic of
TxnAmalgamate, TxnSendPayment, TxnTransactSaving and TxnWriteCheck):

1. a new cohort takes its locks, in the cohort's order, against the locks
   granted in the previous step: a lock slot held exclusively refuses
   everything, one held shared grants shared requests and refuses
   exclusive ones, and a free slot goes to its first request: to that one
   request when it is exclusive, to every shared request when it is
   shared. A transaction refused any lock aborts; the others read their
   balances and run their logic (send payment and a withdrawal that would
   leave savings below zero abort); all arithmetic is 32-bit and wraps;
2. the previous cohort installs its writes and appends them to the log,
   version = the step's number (the first step is number 2).

Rows are savings [0, n) then checking [n, 2n); a row's lock slot is the
row itself while the 2n + 1 rows fit the lock table, else the
multiply-shift hash ``(row * 0x9E3779B1 mod 2^32) >> (32 - log2 slots)``
(DINT smallbank/ebpf/utils.h:16-17 hashes locks into a fixed space).

``control``: "log-2-replicas" (the third log copy never written) breaks
the durability the configuration states.
"""
from __future__ import annotations

import torch

from .. import inputs
from .tatp import HDR, I32, I64, M32, i32, u32

SAV, CHK = 0, 1
AM, BA, DE, SP, TS, WC = range(6)
AMT = 5
MAGIC = 0x5B5B
VW = 2
N_STATS = 6    # attempted, committed, lock aborts, logic aborts, 0,
#                the committed balance change (i32, wraps)


class BankCohort:
    """A cohort between its lock wave and its install."""


class SmallBankReference:
    def __init__(self, *, n_accounts: int, init_balance: int, w: int, mix,
                 hot_frac: float, hot_prob: float, lock_slots: int,
                 log_lanes: int, log_capacity: int, device, control=()):
        """Starts from the benchmark's balances (`inputs.
        smallbank_balances`); every array has one slot past its end that
        takes the writes of masked lanes, so no write waits on the host."""
        self.dev = torch.device(device)
        self.n, self.w = n_accounts, w
        self.dump = 2 * n_accounts + 1
        self.bal = torch.cat([inputs.smallbank_balances(
            n_accounts, init_balance, self.dev),
            torch.zeros(1, dtype=I32, device=self.dev)])
        self.h = lock_slots
        self.xs = torch.zeros(lock_slots + 1, dtype=I32, device=self.dev)
        self.ss = torch.zeros(lock_slots + 1, dtype=I32, device=self.dev)
        self.thresh = torch.as_tensor(inputs.mix_thresholds(mix),
                                      device=self.dev)
        self.hot_n = max(int(n_accounts * hot_frac), 1)
        self.hot_cut = min(int(hot_prob * 2.0**32), M32)
        self.L, self.cap = log_lanes, log_capacity
        self.ring = torch.zeros((log_lanes * log_capacity + 1, HDR + VW),
                                dtype=I32, device=self.dev)
        self.head = torch.zeros(log_lanes, dtype=I64, device=self.dev)
        self.control = frozenset(control)
        self.t = 2
        self.c1 = None

    def slot(self, rows: torch.Tensor) -> torch.Tensor:
        if self.h >= 2 * self.n + 1:
            return rows
        shift = 32 - (self.h.bit_length() - 1)
        return ((rows * 0x9E3779B1) & M32) >> shift

    def step(self, bits, amt) -> torch.Tensor:
        """One step: ``bits`` i32 [w, 5] and ``amt`` i32 [w] (None: no
        new cohort, the drain). Returns the installing cohort's counts,
        i64 [N_STATS]."""
        new = None if bits is None else self._lock_wave(bits, amt)
        stats = self._stats(self.c1)
        self._install(self.c1)
        self.c1 = new
        self.t += 1
        return stats

    def _stats(self, c) -> torch.Tensor:
        if c is None:
            return torch.zeros(N_STATS, dtype=I64, device=self.dev)
        z = torch.zeros((), dtype=I64, device=self.dev)
        return torch.stack([z + self.w, c.committed, c.ab_lock, c.ab_logic,
                            z, c.delta])

    def _lock_wave(self, bits, amt) -> BankCohort:
        w, n, dev = self.w, self.n, self.dev
        b = u32(bits)
        ttype = (self.thresh[None] <= b[:, 0:1]).sum(1).clamp(max=5)

        def account(word, coin):
            return torch.where(coin < self.hot_cut, word % self.hot_n,
                               word % n)

        a1 = account(b[:, 1], b[:, 3])
        a2 = account(b[:, 2], b[:, 4])
        a2 = torch.where(a1 == a2, (a2 + 1) % n, a2)

        # lock sets: 0 none, 1 shared, 2 exclusive; (kind, table, account)
        t = ttype
        zero = torch.zeros_like(t)
        k0 = torch.where((t == BA) | (t == WC), 1, 2)
        k1 = torch.where((t == AM) | (t == SP) | (t == WC), 2,
                         torch.where(t == BA, 1, 0))
        k2 = torch.where(t == AM, 2, 0)
        tb0 = torch.where((t == DE) | (t == SP), CHK, SAV)
        acc1 = torch.where(t == SP, a2, a1)
        kind = torch.stack([k0, k1, k2], 1)
        tbl = torch.stack([tb0, zero + CHK, zero + CHK], 1)
        acc = torch.stack([a1, acc1, a2], 1)
        active = kind != 0
        rows = tbl * n + acc
        slot = self.slot(rows).reshape(-1)
        kf, af = kind.reshape(-1), active.reshape(-1)

        # each slot's requests in the cohort's order
        pos = torch.arange(3 * w, device=dev)
        key = torch.where(af, slot * (3 * w) + pos, torch.iinfo(I64).max)
        order = torch.argsort(key)
        s_slot, s_kind, s_act = slot[order], kf[order], af[order]
        head = s_act & torch.cat([torch.ones(1, dtype=torch.bool,
                                             device=dev),
                                  s_slot[1:] != s_slot[:-1]])
        # the kind of each slot's first request, at every request of it
        start = torch.cummax(torch.where(head, pos, 0), 0).values
        first_kind = s_kind[start]
        held_x = self.xs[s_slot] == self.t - 1
        held_s = self.ss[s_slot] == self.t - 1
        s_grant = s_act & ~held_x & torch.where(
            held_s, s_kind == 1,
            torch.where(first_kind == 2, head, s_kind == 1))
        grant = torch.zeros_like(af)
        grant[order] = s_grant
        gx = grant & (kf == 2)
        gs = grant & (kf == 1)
        stamp = torch.full_like(slot, self.t, dtype=I32)
        self.xs.index_put_((torch.where(gx, slot, self.h),), stamp)
        self.ss.index_put_((torch.where(gs, slot, self.h),), stamp)
        grant = grant.view(w, 3)
        alive = ~(active & ~grant).any(1)

        # the balance logic, on 32-bit wrapping balances
        bal = torch.where(grant, self.bal[rows], 0).to(I64)
        b0, b1, b2 = bal.unbind(1)
        a = amt.to(I64)

        def wrap(x):
            return i32(x).to(I64)

        am, de = alive & (t == AM), alive & (t == DE)
        sp, ts, wc = alive & (t == SP), alive & (t == TS), alive & (t == WC)
        sp_fail = sp & (b0 < AMT)
        ts_fail = ts & (wrap(b0 + a) < 0)
        logic = sp_fail | ts_fail
        sp_ok, ts_ok = sp & ~sp_fail, ts & ~ts_fail
        over = (wrap(b0 + b1) < AMT).to(I64)
        nw0 = torch.where(de, wrap(b0 + AMT), torch.where(
            sp_ok, wrap(b0 - AMT), torch.where(ts_ok, wrap(b0 + a), 0)))
        nw1 = torch.where(wc, wrap(b1 - AMT - over),
                          torch.where(sp_ok, wrap(b1 + AMT), 0))
        nw2 = torch.where(am, wrap(b2 + b0 + b1), 0)
        do = torch.stack([am | de | sp_ok | ts_ok, am | sp_ok | wc, am], 1)
        nw = torch.stack([nw0, nw1, nw2], 1)

        c = BankCohort()
        c.rows, c.tbl, c.acc, c.do, c.nw = rows, tbl, acc, do, nw
        c.committed = (alive & ~logic).sum()
        c.ab_lock = (~alive).sum()
        c.ab_logic = logic.sum()
        c.delta = i32(torch.where(do, nw - bal, 0).sum()).to(I64)
        return c

    def _install(self, c):
        if c is None:
            return
        m = c.do.reshape(-1)
        self.bal.index_put_((torch.where(m, c.rows.reshape(-1), self.dump),),
                            i32(c.nw.reshape(-1)))
        r = m.numel()
        pos = torch.arange(r, device=self.dev)
        lane = pos % self.L
        pad = (-r) % self.L
        # a write's rank among its lane's writes of the step
        mi = torch.nn.functional.pad(m.to(I64), (0, pad)).view(
            -1, self.L).t().contiguous()
        rank = (torch.cumsum(mi, 1) - mi).t().reshape(-1)[:r]
        slot = (self.head[lane] + rank) % self.cap
        flat = torch.where(m, lane * self.cap + slot, self.L * self.cap)
        entry = torch.stack([
            i32(u32(c.tbl.reshape(-1)) << 8),
            torch.zeros_like(lane, dtype=I32),
            c.acc.reshape(-1).to(I32),
            torch.full((r,), self.t, dtype=I32, device=self.dev),
            i32(c.nw.reshape(-1)),
            torch.full((r,), MAGIC, dtype=I32, device=self.dev)], 1)
        self.ring.index_put_((flat,), entry)
        self.head += mi.sum(1)

    # -------------------------------------------------------- outputs
    def log(self):
        """The ring i32 [lanes * capacity, HDR + 2] and its heads, u32 i64
        [lanes]."""
        return self.ring[:-1], self.head & M32

    def locks_held(self) -> int:
        """Lock slots granted in the last step (none after a drain)."""
        last = self.t - 1
        return int(((self.xs[:-1] == last) | (self.ss[:-1] == last)).sum())
