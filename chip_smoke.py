#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dint_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py            # from the repo root; needs one CUDA card

Phases, each of which fails the run (non-zero exit, no result line) on any
mismatch or error:

1. The card: name and power limit (nvidia-smi), and the nvcc build of every
   kernel in dint_tpu_torch/csrc (all sources compiled at once).
2. Each kernel against its plain PyTorch version on the card, at the shapes
   the main path gives it, exact equality: gather_rows over a meta-sized
   [154,000,023] table (K = 65,536) and a val-sized table (K = 32,768 word
   offsets); lock_arbitrate over an [n1] arb array (M = 16,384) prefilled
   with t-1, t-2 and 0 stamps, with heavy duplicates and inactive lanes.
   Times: kernel, plain version, yardstick (one torch call where one
   computes the same function), and the bytes bound at 3.35 TB/s.
3. The port on the CPU against the port on the card, end to end
   (n_sub=2000, w=256, 4 cohorts/block, contention mix, the same host-made
   draws): tables, log and stats bit-identical.
4. The main path at full width: populate_device at 7,000,000 subscribers,
   build_pipelined_runner(w=8192, cohorts_per_block=16, val_words=10), one
   warm block, 8 timed blocks, drain; TATP invariants and launch counts.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM published peak
N_SUB = 7_000_000
W = 8192
CPB = 16
VW = 10
TIMED_BLOCKS = 8


class SmokeFailure(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)
    print(f"  ok: {what}")


def device_ms(fn, n=20, groups=5):
    """Median over ``groups`` of the mean device time of ``n`` back-to-back
    calls of ``fn``, by CUDA events. Each group is queued behind a ~5 ms
    sleep kernel, so the host has enqueued all ``n`` calls before the card
    reaches the first event and the span holds no launch latency (a call
    that synchronises inside, as the plain versions do, is timed with its
    host gaps, which are part of its cost)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(groups):
        torch.cuda._sleep(10_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return float(np.median(times))


def bound_ms(n_bytes):
    return n_bytes / HBM_BYTES_PER_S * 1e3


def sectors(word_idx):
    """Distinct 32-byte sectors holding the given int32 word offsets."""
    return int(torch.unique(word_idx.to(torch.int64) // 8).numel())


def max_abs_err(a, b):
    from dint_tpu_torch.ops.u32 import to_u64
    if a.numel() == 0:
        return 0
    return int((to_u64(a) - to_u64(b)).abs().max())


# ------------------------------------------------------------------ phases


def phase_card():
    print("== phase 1: card and kernel build")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    from dint_tpu_torch.ops import _build
    secs = _build.build_all()
    print(f"kernel build: {secs:.3f} s for {_build.sources()}")
    for name, log in sorted(_build.build_log.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  [{name}] {line.strip()}")
    return card


def phase_kernels(dev):
    print("== phase 2: kernels against their plain versions, main-path shapes")
    from dint_tpu_torch.engines import tatp_dense as td
    from dint_tpu_torch.ops import row_kernels as rk
    gen = torch.Generator(device=dev).manual_seed(2)
    n1 = td.n_rows(N_SUB) + 1
    sent = n1 - 1
    rec = {}

    def rand_rows(k):
        """Random rows with 1/8 sentinel lanes and 1/4 duplicates."""
        r = torch.randint(0, n1 - 1, (k,), generator=gen, device=dev)
        r[::8] = sent
        dup = torch.randint(0, 64, (k // 4,), generator=gen, device=dev)
        r[1::4] = r[dup]
        return r.to(torch.int32)

    # -- gather_rows: the meta gather and the magic-word gather of a step
    g_ms = g_plain = g_lib = g_bound = 0.0
    g_err = 0
    for label, n_words, k, scale in (("meta", n1, 2 * W * 4, 1),
                                     ("magic", n1 * VW, W * 4, VW)):
        tab = torch.empty(n_words, dtype=torch.int32,
                          device=dev).random_(generator=gen)
        idx = rand_rows(k) * scale + (1 if scale > 1 else 0)
        got = rk.gather_rows(tab, idx, 1)
        want = rk.gather_rows_ref(tab, idx, 1)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        check(torch.equal(got, want) and err == 0,
              f"gather_rows[{label}] K={k} over [{n_words}] equals the plain "
              f"version")
        ms = device_ms(lambda: rk.gather_rows(tab, idx, 1))
        plain = device_ms(lambda: rk.gather_rows_ref(tab, idx, 1))
        lib = device_ms(lambda: torch.index_select(tab, 0, idx))
        nbytes = 32 * sectors(idx) + 4 * k + 4 * k
        bnd = bound_ms(nbytes)
        print(f"  gather_rows[{label}] K={k}: kernel {ms:.6f} ms, plain "
              f"{plain:.6f} ms, index_select {lib:.6f} ms, bound {bnd:.6f} ms "
              f"({nbytes} B)")
        g_ms, g_plain, g_lib, g_bound = (g_ms + ms, g_plain + plain,
                                         g_lib + lib, g_bound + bnd)
        g_err = max(g_err, err)
        del tab, got, want
        torch.cuda.empty_cache()
    rec["gather_rows"] = dict(ms=g_ms, plain_ms=g_plain, library_ms=g_lib,
                              bound_ms=g_bound, max_abs_err=g_err)

    # -- lock_arbitrate: the lock pass of a step (M = 2w write slots)
    m = 2 * W
    pool = torch.randint(0, n1 - 1, (m // 4,), generator=gen, device=dev)
    rows = pool[torch.randint(0, pool.numel(), (m,), generator=gen,
                              device=dev)]
    active = torch.rand(m, generator=gen, device=dev) < 0.75
    rows = torch.where(active, rows, sent).to(torch.int32)
    l_err = 0
    timing = None
    for t in (5, td.REBASE_AT - 1):       # the second puts stamps >= 2^31
        from dint_tpu_torch.ops.u32 import wrap_i32
        arb0 = torch.zeros(n1, dtype=torch.int32, device=dev)
        third = pool.numel() // 3
        arb0[pool[:third]] = wrap_i32(torch.full((third,), (t - 1) << td.K_ARB,
                                                 device=dev) + 7)
        arb0[pool[third:2 * third]] = wrap_i32(
            torch.full((third,), (t - 2) << td.K_ARB, device=dev) + 9)
        a_k, g_k = rk.lock_arbitrate(arb0.clone(), rows, active, t, td.K_ARB)
        a_r, g_r = rk.lock_arbitrate_ref(arb0.clone(), rows, active, t,
                                         td.K_ARB)
        torch.cuda.synchronize()
        err = max(max_abs_err(a_k, a_r), max_abs_err(g_k.int(), g_r.int()))
        check(torch.equal(a_k, a_r) and torch.equal(g_k, g_r) and err == 0,
              f"lock_arbitrate M={m} t={t} equals the plain version "
              f"(arb [{n1}] and grants; {int(g_k.sum())} granted)")
        l_err = max(l_err, err)
        if timing is None:
            timing = (t, arb0, a_k, g_k)
        else:
            del arb0, a_k, a_r
    t, arb0, a_k, g_k = timing
    arb = arb0.clone()

    def chain():
        # the XLA chain in three torch calls (gather, scatter_reduce amax,
        # gather-back); signed amax is right here because t << 18 < 2^31
        old = arb[rows]
        held = ((old >> td.K_ARB) & ((1 << (32 - td.K_ARB)) - 1)) == t - 1
        cand = active & ~held
        packed = (t << td.K_ARB) | (m - 1 - torch.arange(m, device=dev,
                                                         dtype=torch.int32))
        arb.scatter_reduce_(0, rows.long(), torch.where(cand, packed, 0),
                            "amax")
        return cand & (arb[rows] == packed)

    check(torch.equal(chain(), g_k) and torch.equal(arb, a_k),
          "the torch-chain yardstick computes the same function (t=5)")
    # repeated passes at the same step do the same work as the first: the
    # rows the first pass stamped are not held (their step field is t, not
    # t-1), so every candidate arbitrates again and wins or loses as before
    ms = device_ms(lambda: rk.lock_arbitrate(arb, rows, active, t, td.K_ARB))
    plain = device_ms(lambda: rk.lock_arbitrate_ref(arb, rows, active, t,
                                                    td.K_ARB))
    chain_ms = device_ms(chain)
    check(torch.equal(arb, a_k), "repeated passes leave arb unchanged")
    cand_rows = rows[g_k]      # every row a candidate won keeps one stamp
    nbytes = (32 * sectors(rows[active]) + 32 * sectors(cand_rows)
              + m * (4 + 1 + 1))
    bnd = bound_ms(nbytes)
    print(f"  lock_arbitrate M={m}: kernel {ms:.6f} ms, plain {plain:.6f} ms, "
          f"torch chain (3 calls, yardstick) {chain_ms:.6f} ms, bound "
          f"{bnd:.6f} ms ({nbytes} B)")
    rec["lock_arbitrate"] = dict(ms=ms, plain_ms=plain, library_ms=None,
                                 chain_ms=chain_ms, bound_ms=bnd,
                                 max_abs_err=l_err)
    del arb, arb0, a_k
    torch.cuda.empty_cache()
    return rec


def phase_cpu_vs_card(dev):
    print("== phase 3: the port on the CPU against the port on the card")
    from dint_tpu_torch import convert
    from dint_tpu_torch.engines import tatp_dense as td
    from dint_tpu_torch.ops import u32
    n_sub, w, cpb, blocks = 2000, 256, 4, 3
    mix = np.array([0, 0, 0, 50, 0, 50, 0], np.float64) / 100.0
    db = td.populate(np.random.default_rng(0), n_sub, val_words=VW,
                     device="cpu", log_capacity=1 << 10)
    arrays = convert.dense_db_to_numpy(db)
    out = []
    rng = np.random.default_rng(1)
    draws = [(rng.integers(0, 1 << 32, (cpb, w, 4), dtype=np.uint64)
              .astype(np.uint32),
              rng.integers(0, 1 << 16, (cpb, w, 2)).astype(np.int32))
             for _ in range(blocks + 1)]
    for where in ("cpu", dev):
        run, init, drain = td.build_pipelined_runner(
            n_sub, w=w, val_words=VW, cohorts_per_block=cpb, mix=mix,
            device=where)
        carry = init(convert.dense_db_from_numpy(arrays, where))
        stats = []
        for bits, payload in draws[:blocks]:
            carry, s = run.run_draws(carry, u32.from_numpy(bits, where),
                                     torch.from_numpy(payload).to(where))
            stats.append(s.cpu())
        db_end, tail = drain(carry, torch.from_numpy(draws[-1][1][:2])
                             .to(where))
        stats.append(tail.cpu())
        out.append((convert.dense_db_to_numpy(db_end),
                    torch.cat(stats).numpy()))
    (a_db, a_st), (b_db, b_st) = out
    check(np.array_equal(a_st, b_st), "per-step stats bit-identical")
    for k in a_db:
        check(np.array_equal(np.asarray(a_db[k]), np.asarray(b_db[k])),
              f"{k} bit-identical")
    tot = a_st.sum(axis=0)
    check(tot[td.STAT_AB_LOCK] > 0 and tot[td.STAT_AB_VALIDATE] > 0,
          f"contention fired (stats total {tot.tolist()})")


def phase_main_path(dev):
    print(f"== phase 4: main path, n_sub={N_SUB:,}, w={W}, "
          f"{CPB} cohorts/block")
    from dint_tpu_torch.engines import tatp_dense as td
    from dint_tpu_torch.ops import row_kernels as rk
    from dint_tpu_torch.tables import log as logring
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    db = td.populate_device(torch.Generator(device=dev).manual_seed(0),
                            N_SUB, val_words=VW, device=dev)
    torch.cuda.synchronize()
    print(f"  populate_device: {time.perf_counter() - t0:.3f} s, "
          f"{db.meta.numel()} rows, val {db.val.numel() * 4} B")
    run, init, drain = td.build_pipelined_runner(
        N_SUB, w=W, val_words=VW, cohorts_per_block=CPB, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)

    rk.reset_launches()
    carry = init(db)
    t0 = time.perf_counter()
    carry, s_warm = run(carry, gen)
    torch.cuda.synchronize()
    print(f"  warm block: {time.perf_counter() - t0:.3f} s")
    block_s, timed = [], []
    for _ in range(TIMED_BLOCKS):
        t0 = time.perf_counter()
        carry, s = run(carry, gen)
        torch.cuda.synchronize()
        block_s.append(time.perf_counter() - t0)
        timed.append(s)
    db, tail = drain(carry)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in rk.WRAPPERS}

    timed = torch.cat(timed).cpu().numpy().astype(np.int64)
    total = (timed.sum(axis=0) + s_warm.cpu().numpy().sum(axis=0)
             + tail.cpu().numpy().sum(axis=0))
    steps = (TIMED_BLOCKS + 1) * CPB + 2
    committed_timed = int(timed[:, td.STAT_COMMITTED].sum())
    secs = float(sum(block_s))
    print(f"  committed txn/s: {committed_timed / secs:.1f} "
          f"({committed_timed} committed in {secs:.6f} s, "
          f"{TIMED_BLOCKS} blocks x {CPB} steps x w={W})")
    print(f"  ms/step: {secs / (TIMED_BLOCKS * CPB) * 1e3:.6f}; per block "
          f"{[round(b * 1e3, 3) for b in block_s]} ms")
    print(f"  max_memory_allocated: {torch.cuda.max_memory_allocated(dev)} B")
    print(f"  stats total (warm+timed+drain): {total.tolist()}")

    attempted = int(total[td.STAT_ATTEMPTED])
    check(attempted == (TIMED_BLOCKS + 1) * CPB * W, "every txn attempted")
    check(int(total[td.STAT_COMMITTED] + total[td.STAT_AB_LOCK]
              + total[td.STAT_AB_MISSING] + total[td.STAT_AB_VALIDATE])
          == attempted, "accounting closes, drain included")
    check(int(total[td.STAT_MAGIC_BAD]) == 0, "magic_bad == 0")
    check(not bool(db.locked.any()), "no row locked after the drain")
    r0 = logring.replica_entries(db.log, 0)
    check(all(torch.equal(r0, logring.replica_entries(db.log, r))
              for r in (1, 2)), "the three log replicas are identical")
    check(int(db.meta[-1]) == 0 and int(db.arb[-1]) == 0
          and not bool(db.val[-VW:].any()), "sentinel row untouched")
    p_sf = 0.625 + 0.375 ** 4 / 4
    p_cf = p_sf * 0.25
    expected = (0.35 * (1 - p_sf) + 0.10 * (1 - p_cf) + 0.02 * (1 - p_sf)
                + 0.02 * (1 - p_sf * 0.75) + 0.02 * (1 - p_cf))
    observed = int(total[td.STAT_AB_MISSING]) / attempted
    check(abs(observed - expected) < 0.01,
          f"ab_missing rate {observed:.6f} within 0.01 of analytic "
          f"{expected:.6f}")
    check(launches == {"gather_rows": 2 * steps, "lock_arbitrate": steps},
          f"launches {launches} == 2 gather_rows + 1 lock_arbitrate per step "
          f"over {steps} steps")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import dint_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the dint_tpu_torch package is missing ({e}); "
              f"run from the repository root", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = phase_card()
    rec = phase_kernels(dev)
    phase_cpu_vs_card(dev)
    launches = phase_main_path(dev)

    sources = {"gather_rows": ("dint_tpu_torch/csrc/gather_rows.cu",
                               "dint_tpu/ops/pallas_gather.py:212"),
               "lock_arbitrate": ("dint_tpu_torch/csrc/lock_arbitrate.cu",
                                  "dint_tpu/ops/pallas_gather.py:780")}
    kernels = []
    for name, (src, replaces) in sources.items():
        r = rec[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes", "library_ms": r["library_ms"]})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
