"""Where a dense TATP or SmallBank step's time goes on the card: one block
under torch.profiler.

    python -m dint_tpu_torch.profile_step [--n-sub 7000000] [--w 8192]
        [--cpb 16] [--route default|hotset|fused|fused+hotset]
        [--trace step_trace.json]
    python -m dint_tpu_torch.profile_step --engine smallbank
        [--n-accounts 24000000] [--route default|hotset|fused|fused+hotset]

Builds the tables on the device, runs one warm block, then profiles one
block (CPU and CUDA activity) and prints: wall ms/step, device-busy
ms/step (the sum of kernel and copy time on the card), the device's idle
share, torch ops launched and host syncs (``nonzero``) per step, and the
top operators by host time and by device time. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .engines import smallbank_dense as sd
from .engines import tatp_dense as td
from .engines.types import ROUTES


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--engine", choices=("tatp", "smallbank"),
                    default="tatp")
    ap.add_argument("--n-sub", type=int, default=7_000_000)
    ap.add_argument("--n-accounts", type=int, default=24_000_000)
    ap.add_argument("--route", choices=tuple(ROUTES), default="default",
                    help="kernel route (use_hotset, use_fused) of either "
                         "engine")
    ap.add_argument("--w", type=int, default=8192)
    ap.add_argument("--cpb", type=int, default=16)
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
    if args.engine == "tatp":
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
    gen = torch.Generator(device=dev).manual_seed(1)
    carry, _ = run(init(db), gen)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        carry, stats = run(carry, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    drain(carry)
    torch.cuda.synchronize()

    ka = prof.key_averages()
    # kernel and copy events only: the aten op rows repeat their kernels'
    # device time
    device_us = sum(e.self_device_time_total for e in ka
                    if e.device_type == DeviceType.CUDA)
    aten_calls = sum(e.count for e in ka if e.key.startswith("aten::"))
    syncs = sum(e.count for e in ka if e.key == "aten::nonzero")
    steps = args.cpb
    print(f"profiled block: {args.engine}, {steps} steps, w={args.w}, "
          f"{size}")
    print(f"wall ms/step: {wall / steps * 1e3:.6f}")
    print(f"device-busy ms/step: {device_us / steps / 1e3:.6f}")
    print(f"device idle share: {1 - device_us / 1e6 / wall:.6f}")
    print(f"aten ops per step (incl. nested): {aten_calls / steps:.1f}")
    print(f"host syncs (aten::nonzero) per step: {syncs / steps:.1f}")
    print(ka.table(sort_by="self_cpu_time_total", row_limit=args.rows))
    print(ka.table(sort_by="self_device_time_total", row_limit=args.rows))
    if args.trace:
        prof.export_chrome_trace(args.trace)
        print(f"trace: {args.trace}")


if __name__ == "__main__":
    main()
