"""Where a dense TATP, SmallBank or store step's time goes on the card:
one block under torch.profiler.

    python -m dint_tpu_torch.profile_step [--n-sub 7000000] [--w 8192]
        [--cpb 16] [--route default|hotset|fused|fused+hotset]
        [--trace step_trace.json]
    python -m dint_tpu_torch.profile_step --engine smallbank
        [--n-accounts 24000000] [--route default|hotset|fused|fused+hotset]
    python -m dint_tpu_torch.profile_step --engine store
        [--n-keys 24000000] [--scan | --no-scan]
    python -m dint_tpu_torch.profile_step --engine cache
        [--n-keys 24000000] [--policy wb_bloom|wb_nobloom|wt] [--hot]
    python -m dint_tpu_torch.profile_step --engine tatp_generic
        [--n-sub 7000000] [--w 4096] [--cpb 8]
    python -m dint_tpu_torch.profile_step --engine smallbank_generic
        [--n-accounts 24000000] [--w 4096] [--cpb 8]

The store runs YCSB-E over the reference store's keyspace: w=4096, 2
cohorts a block, 95% scans of 1-100 rows (scan_max 100, delta_cap 256),
the rest half GET, half SET (``--no-scan``: the point runner); its
profiled block includes the block-end rebuild of the ordered run.

The cache tier runs `CachedStore` (a 2^23 x 4 device cache over a backing
store of ``--n-keys`` keys, w=4096) on `clients.micro.cache_stream`, the
traffic of chip_smoke.py phase 8: a GET sweep of the hot 4% prefix, one
warm block, then one profiled block of 16 rounds of 50/50 GET/SET, 90% of
keys from the prefix; ``--hot`` attaches the hot mirror of the prefix. A
round is the step here.

The generic engines run their 3-replica runners (chip_smoke.py phase 11's
configuration): TATP's `build_pipelined_runner` over `populate_shards`
(a step is one `pipe_step`, three `tatp.step` calls) and SmallBank's
`build_runner` over `create_stacked` (a step is one cohort, six
`smallbank.step` calls), w=4096 and 8 cohorts a block by default.

Builds the tables on the device, runs one warm block, then profiles one
block (CPU and CUDA activity) and prints: wall ms/step, device-busy
ms/step (the sum of kernel and copy time on the card), the device's idle
share, torch ops and kernels launched and host syncs (``nonzero``, scalar
reads and device-to-host copies) per step, and the top operators by host
time and by device time. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .clients import micro, tatp_client
from .clients import workloads as wl
from .engines import smallbank_dense as sd
from .engines import smallbank_pipeline as sp
from .engines import store
from .engines import store_cache
from .engines import tatp_dense as td
from .engines import tatp_pipeline as tp
from .engines.types import ROUTES
from .shim.host_kvs import CachedStore


def _cache_block(args, dev):
    """A CachedStore warmed by the sweep, and (block, finish, size label):
    each call of ``block`` serves the next ``args.cpb`` rounds of
    `micro.cache_stream`."""
    n = args.n_keys
    hot_n = int(n * wl.SB_HOT_FRAC)
    srv = CachedStore(1 << 23, val_words=args.val_words, policy=args.policy,
                      width=args.w, hot_keys=hot_n + 1 if args.hot else 0,
                      device=dev)
    keys = np.arange(1, n + 1, dtype=np.uint64)
    vals = np.zeros((n, args.val_words), np.uint32)
    vals[:, 0] = keys.astype(np.uint32)
    vals[:, 1] = micro.STORE_MAGIC
    srv.populate(keys, vals)
    del keys, vals
    # the sweep, then the warm block and the profiled one
    rounds = micro.cache_stream(np.random.default_rng(1), n, args.w,
                                2 * args.cpb, args.val_words)
    for ops, keys, vals in rounds[:-2 * args.cpb]:
        srv.serve(ops, keys, vals)
    stream = iter(rounds[-2 * args.cpb:])

    def block():
        for _ in range(args.cpb):
            srv.serve(*next(stream))
    return block, lambda: None, (f"n_keys={n}, cache 2^23 x 4, policy "
                                 f"{args.policy}"
                                 f"{', hot mirror' if args.hot else ''}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--engine", choices=("tatp", "smallbank", "store",
                                         "cache", "tatp_generic",
                                         "smallbank_generic"),
                    default="tatp")
    ap.add_argument("--n-sub", type=int, default=7_000_000)
    ap.add_argument("--n-accounts", type=int, default=24_000_000)
    ap.add_argument("--n-keys", type=int, default=24_000_000)
    ap.add_argument("--scan", action=argparse.BooleanOptionalAction,
                    default=True, help="store: the scan runner (default) "
                    "or the point runner")
    ap.add_argument("--policy", choices=store_cache.POLICIES,
                    default=store_cache.WB_BLOOM, help="cache: the policy")
    ap.add_argument("--hot", action="store_true",
                    help="cache: attach the hot mirror of the 4%% prefix")
    ap.add_argument("--route", choices=tuple(ROUTES), default="default",
                    help="kernel route (use_hotset, use_fused) of either "
                         "engine")
    ap.add_argument("--w", type=int, default=None,
                    help="lanes a step (8192; the store and the generic "
                         "engines 4096)")
    ap.add_argument("--cpb", type=int, default=None,
                    help="cohorts a block (16; the store 2; the generic "
                         "engines 8; the cache's rounds a block 16)")
    ap.add_argument("--val-words", type=int, default=10)
    ap.add_argument("--trace", default=None,
                    help="write the Chrome trace of the profiled block here")
    ap.add_argument("--rows", type=int, default=25)
    args = ap.parse_args(argv)

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    use_hotset, use_fused = ROUTES[args.route]
    store_engine = args.engine == "store"
    generic = args.engine.endswith("_generic")
    if args.w is None:
        args.w = 4096 if args.engine in ("store", "cache") or generic \
            else 8192
    if args.cpb is None:
        args.cpb = 2 if store_engine else 8 if generic else 16
    if args.engine == "cache":
        block, finish, size = _cache_block(args, dev)
    elif store_engine:
        db = micro.make_store_table(args.n_keys, val_words=args.val_words,
                                    device=dev)
        run, init, drain = store.build_serve_runner(
            args.n_keys, w=args.w, cohorts_per_block=args.cpb,
            val_words=args.val_words, read_frac=0.5,
            scan_frac=wl.YCSB_E_SCAN_FRAC, max_scan_len=wl.YCSB_E_MAX_SCAN,
            scan_max=wl.YCSB_E_MAX_SCAN, delta_cap=256, use_scan=args.scan,
            device=dev)
        size = f"n_keys={args.n_keys}, {'scan' if args.scan else 'point'}"
    elif args.engine == "tatp_generic":
        db, _ = tatp_client.populate_shards(
            np.random.default_rng(0), args.n_sub, val_words=args.val_words,
            device=dev)
        run, init, drain = tp.build_pipelined_runner(
            args.n_sub, w=args.w, val_words=args.val_words,
            cohorts_per_block=args.cpb, device=dev)
        size = f"n_sub={args.n_sub}, 3 replicas"
    elif args.engine == "smallbank_generic":
        db = sp.create_stacked(args.n_accounts, device=dev)
        run = sp.build_runner(args.n_accounts, w=args.w,
                              cohorts_per_block=args.cpb, device=dev)

        def init(stacked):
            return stacked

        def drain(carry):
            return carry
        size = f"n_accounts={args.n_accounts}, 3 replicas"
    elif args.engine == "tatp":
        db = td.populate_device(torch.Generator(device=dev).manual_seed(0),
                                args.n_sub, val_words=args.val_words,
                                device=dev)
        run, init, drain = td.build_pipelined_runner(
            args.n_sub, w=args.w, val_words=args.val_words,
            cohorts_per_block=args.cpb, use_hotset=use_hotset,
            use_fused=use_fused, device=dev)
        size = f"n_sub={args.n_sub}, route {args.route}"
    else:
        db = sd.create(args.n_accounts, device=dev)
        run, init, drain = sd.build_pipelined_runner(
            args.n_accounts, w=args.w, cohorts_per_block=args.cpb,
            use_hotset=use_hotset, use_fused=use_fused, device=dev)
        size = f"n_accounts={args.n_accounts}, route {args.route}"
    if args.engine != "cache":
        gen = torch.Generator(device=dev).manual_seed(1)
        carry = [init(db)]

        def block():
            carry[0] = run(carry[0], gen)[0]

        def finish():
            drain(carry[0])
    block()
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        block()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finish()
    torch.cuda.synchronize()

    ka = prof.key_averages()
    # kernel and copy events only: the aten op rows repeat their kernels'
    # device time
    device_us = sum(e.self_device_time_total for e in ka
                    if e.device_type == DeviceType.CUDA)
    aten_calls = sum(e.count for e in ka if e.key.startswith("aten::"))
    kernels = sum(e.count for e in ka if e.device_type == DeviceType.CUDA
                  and not e.key.startswith(("Memcpy", "Memset")))
    syncs = {k: sum(e.count for e in ka if e.key == k)
             for k in ("aten::nonzero", "aten::_local_scalar_dense")}
    syncs["DtoH copies"] = sum(e.count for e in ka
                               if e.key.startswith("Memcpy DtoH"))
    steps = args.cpb
    print(f"profiled block: {args.engine}, {steps} steps, w={args.w}, "
          f"{size}")
    print(f"wall ms/step: {wall / steps * 1e3:.6f}")
    print(f"device-busy ms/step: {device_us / steps / 1e3:.6f}")
    print(f"device idle share: {1 - device_us / 1e6 / wall:.6f}")
    print(f"aten ops per step (incl. nested): {aten_calls / steps:.1f}")
    print(f"kernels per step: {kernels / steps:.1f}")
    print("host syncs per step: " + ", ".join(
        f"{k} {n / steps:.1f}" for k, n in syncs.items()))
    print(ka.table(sort_by="self_cpu_time_total", row_limit=args.rows))
    print(ka.table(sort_by="self_device_time_total", row_limit=args.rows))
    if args.trace:
        prof.export_chrome_trace(args.trace)
        print(f"trace: {args.trace}")


if __name__ == "__main__":
    main()

