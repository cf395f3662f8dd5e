"""The scalar-scatter probe on the card: the counterpart of
`tools/profile_pallas.py`, with its shapes and seed.

    python -m dint_tpu_torch.profile_scalar_scatter

A u32 table of N = 2,200,064 words (folded to [N / 512, 512]) takes
K = 16,384 scalar stores at unique random indices (numpy seed 0), 8 chained
iterations a timing, best of 3, timed by CUDA events. It prints the card's
name and power limit first, then ms/iter for the hand-written kernel
(`ops.row_kernels.scalar_scatter`, where the tool printed ``pallas scalar
scatter``) and for the PyTorch form ``tab.clone()`` +
``view(-1).index_put_`` on the flat table (the tool's ``xla 1-D
scatter``). It exits non-zero if the two tables differ, or if either
differs from `scalar_scatter_ref`. Needs a CUDA device.
"""
from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch

from .device import resolve_device
from .ops import row_kernels as rk
from .ops.u32 import from_numpy

N = 2_200_064          # meta-table rows (tatp bench scale), 128-aligned
K = 16_384             # lane ops per step
ITERS = 8
C = 512                # the tool folds the table to [N // C, C]


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def inputs(device):
    """The tool's inputs: a zero [N // C, C] table, K unique indices and
    values below 2^30, [K, 1] each, from numpy's seed 0."""
    rng = np.random.default_rng(0)
    idx = rng.choice(N, K, replace=False).astype(np.int32).reshape(K, 1)
    val = (rng.integers(0, 1 << 30, K, dtype=np.int64).astype(np.uint32)
           .reshape(K, 1))
    tab = torch.zeros((N // C, C), dtype=torch.int32, device=device)
    return tab, torch.from_numpy(idx).to(device), from_numpy(val, device)


def index_put_form(tab, idx, val):
    """The library form: a copy, then one ``index_put_`` on the flat view
    (the same function as `scalar_scatter` for unique indices only)."""
    out = tab.clone()
    out.view(-1).index_put_((idx.view(-1).long(),), val.view(-1))
    return out


def best_ms_per_iter(fn, tab, idx, val):
    """Best of 3 timings of ITERS chained calls, after one warm chain;
    returns (ms per iteration, the last chain's table)."""
    def chain(t):
        for _ in range(ITERS):
            t = fn(t, idx, val)
        return t

    t = chain(tab)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        t = chain(t)
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b) / ITERS)
    return best, t


def run(device=None) -> dict:
    """Time both forms and check them; returns {"kernel_ms", "index_put_ms",
    "equal"}."""
    dev = resolve_device(device)
    tab, idx, val = inputs(dev)
    k_ms, k_out = best_ms_per_iter(rk.scalar_scatter, tab, idx, val)
    l_ms, l_out = best_ms_per_iter(index_put_form, tab, idx, val)
    want = rk.scalar_scatter_ref(tab, idx, val)
    equal = torch.equal(k_out, l_out) and torch.equal(k_out, want)
    return {"kernel_ms": k_ms, "index_put_ms": l_ms, "equal": equal}


def main(argv=None) -> int:
    print(card(), flush=True)
    res = run()
    print(f"{'cuda scalar scatter':28s} {res['kernel_ms']:9.6f} ms/iter")
    print(f"{'torch 1-D index_put_':28s} {res['index_put_ms']:9.6f} ms/iter")
    if not res["equal"]:
        print("the kernel's table differs from index_put_'s or the plain "
              "version's", file=sys.stderr)
        return 1
    print("tables equal")
    return 0


if __name__ == "__main__":
    sys.exit(main())
