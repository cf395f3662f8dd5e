"""Every input of a run, made from ``--seed`` by the benchmark itself and
handed the same to the system under test and to the plain reference: the
initial tables, each block's draws and each block's install payloads.

Nothing here imports the measured package: the system and the reference
both read these tensors, and the reference makes them again from the seed
after the window. Each stream (tables of partition d, block b's draws, the
drain's payloads) has a generator of its own, seeded from a 64-bit mix of
(seed, stream, index), so a seed gives the same inputs on every run and a
block's draws do not depend on how many blocks came before.

Words are int32 tensors holding u32 bit patterns.
"""
from __future__ import annotations

import numpy as np
import torch

I32 = torch.int32
MASK64 = (1 << 64) - 1

# generator streams
TABLES, BLOCK, DRAIN = 1, 2, 3

# TATP (tatp/caladan/tatp.h): the populate magic of value word 1
TATP_MAGIC = 0x7A79


def mix64(*parts: int) -> int:
    """A 64-bit seed from integers of any size: splitmix64 over the
    parts, so (seed, stream, index) triples give unrelated streams."""
    z = 0x9E3779B97F4A7C15
    for p in parts:
        z = (z ^ (int(p) & MASK64)) & MASK64
        z = (z + 0x9E3779B97F4A7C15) & MASK64
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
        z ^= z >> 31
    return z


def generator(device, *parts: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(mix64(*parts))
    return g


def u32_words(g: torch.Generator, shape, device) -> torch.Tensor:
    """Uniform u32 words as int32 bit patterns."""
    x = torch.randint(0, 1 << 32, tuple(shape), dtype=torch.int64,
                      generator=g, device=device)
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(I32)


# ------------------------------------------------------------------- TATP


def tatp_bases(n_sub: int) -> list:
    """Flat row base of each TATP table: subscriber, secondary subscriber,
    access info (4 a subscriber), special facility (4), call forwarding
    (12: 4 sf types x 3 start times); row 22 * (n_sub + 1) is a sentinel
    that no transaction touches."""
    p1 = n_sub + 1
    return [0, p1, 2 * p1, 6 * p1, 10 * p1]


def tatp_rows(n_sub: int) -> int:
    """Rows of the flat TATP tables, sentinel included."""
    return 22 * (n_sub + 1) + 1


def tatp_tables(seed: int, part: int, n_sub: int, val_words: int,
                device) -> tuple:
    """The populated TATP tables of partition ``part``: ``meta`` i32
    [rows] (version << 1 | exists) and ``val`` i32 [rows * val_words]
    (row-major words; word 0 the row's index within its table, word 1 the
    magic word, the rest zero).

    Population (TATP spec, DINT client_ebpf_shard.cc:96-341): every
    subscriber 1..n_sub and its secondary row exist; each of the 4
    access-info and special-facility types exists with probability 0.625,
    at least one of each a subscriber; each call-forwarding row (sf type,
    start time 0/8/16) exists with probability 0.25 where its special
    facility exists. Every existing row starts at version 1."""
    g = generator(device, seed, TABLES, part)
    p1 = n_sub + 1
    rows = tatp_rows(n_sub)
    sub = torch.arange(p1, device=device) >= 1

    def present():
        pr = (torch.rand(p1 * 4, generator=g, device=device) < 0.625)
        pr4 = pr.view(p1, 4)
        pr4[:, 0] |= ~pr4.any(dim=1)
        return pr & sub.repeat_interleave(4)

    ai = present()
    sf = present()
    cf = sf.repeat_interleave(3) & (
        torch.rand(p1 * 12, generator=g, device=device) < 0.25)
    exists = torch.cat([sub, sub, ai, sf, cf,
                        torch.zeros(1, dtype=torch.bool, device=device)])
    meta = exists.to(I32) * 3
    val = torch.zeros((rows, val_words), dtype=I32, device=device)
    bases = tatp_bases(n_sub) + [rows - 1]
    for lo, hi in zip(bases[:-1], bases[1:]):
        ex = exists[lo:hi]
        val[lo:hi, 0] = torch.where(
            ex, torch.arange(hi - lo, dtype=I32, device=device), 0)
        val[lo:hi, 1] = torch.where(ex, TATP_MAGIC, 0)
    return meta, val.view(-1)


def tatp_block(seed: int, block: int, cpb: int, parts: int, w: int,
               device) -> tuple:
    """Block ``block``'s draws: ``bits`` i32 [cpb, parts, w, 4] (a
    transaction's type, subscriber and sub-keys are decoded from its four
    u32 words) and ``payload`` i32 [cpb, parts, w, 2] in [0, 2^16) (word 0
    of the rows the step installs)."""
    g = generator(device, seed, BLOCK, block)
    bits = u32_words(g, (cpb, parts, w, 4), device)
    payload = torch.randint(0, 1 << 16, (cpb, parts, w, 2), dtype=I32,
                            generator=g, device=device)
    return bits, payload


def tatp_drain(seed: int, parts: int, w: int, device) -> torch.Tensor:
    """The drain's install payloads, i32 [2, parts, w, 2]."""
    g = generator(device, seed, DRAIN, 0)
    return torch.randint(0, 1 << 16, (2, parts, w, 2), dtype=I32,
                         generator=g, device=device)


# -------------------------------------------------------------- SmallBank

SB_TS_AMT_MAX = 20    # transact_saving's signed amount, [-20, 20]


def smallbank_balances(n_accounts: int, init_balance: int,
                       device) -> torch.Tensor:
    """Savings rows [0, n) then checking rows [n, 2n), every balance
    ``init_balance`` (DINT smallbank/ebpf/shard_user.c:74-77), and a zero
    sentinel row 2n."""
    bal = torch.full((2 * n_accounts + 1,), int(init_balance), dtype=I32,
                     device=device)
    bal[-1] = 0
    return bal


def smallbank_block(seed: int, block: int, cpb: int, w: int,
                    device) -> tuple:
    """Block ``block``'s draws: ``bits`` i32 [cpb, w, 5] (type, the two
    accounts, their hot-set coins) and ``ts_amt`` i32 [cpb, w] in
    [-20, 20]."""
    g = generator(device, seed, BLOCK, block)
    bits = u32_words(g, (cpb, w, 5), device)
    amt = torch.randint(-SB_TS_AMT_MAX, SB_TS_AMT_MAX + 1, (cpb, w),
                        dtype=I32, generator=g, device=device)
    return bits, amt


def mix_thresholds(mix) -> np.ndarray:
    """Cumulative u32 thresholds of a transaction mix: a u32 word ``x``
    picks the type ``#{thresholds <= x}``, capped at the last type."""
    m = np.asarray(mix, np.float64)
    c = np.cumsum(m / m.sum())
    return (c * 2.0**32).astype(np.uint64).clip(0, 0xFFFFFFFF) \
        .astype(np.int64)
