"""Time the store table's two-choice placement at the reference keyspace:
the JAX package's numpy rounds (each round's ranking ``lexsort`` on the
host) against the port's `tables/kv.assign_two_choice`, which runs each
round's ranking sort on the card.

    python -m dint_tpu_torch.time_placement [--n-keys 24000000]

Keys 1..n into `clients/micro.make_store_table`'s buckets
(2^ceil(log2(n/2)) buckets of 4 slots), the placement `kv.populate` runs.
Checks that both place every key alike, and prints each one's seconds and
the number of rounds. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from .ops import hashing
from .tables import kv


def numpy_placement(keys: np.ndarray, n_buckets: int, slots: int,
                    max_iters: int = 200):
    """The JAX package's `assign_two_choice`, all numpy: returns (bkt,
    slot, rounds)."""
    n = len(keys)
    b1, b2 = hashing.bucket_pair_np(keys, n_buckets)
    rng = np.random.default_rng(0xD1A7)
    choice = np.zeros(n, bool)
    idx = np.arange(n)
    for rounds in range(1, max_iters + 1):
        cur = np.where(choice, b2, b1)
        order = np.lexsort((rng.random(n), cur))
        sorted_bkt = cur[order]
        start = np.concatenate([[True], sorted_bkt[1:] != sorted_bkt[:-1]])
        within = np.empty(n, np.int64)
        within[order] = idx - np.maximum.accumulate(np.where(start, idx, 0))
        over = within >= slots
        if not over.any():
            return cur, within, rounds
        choice ^= over & (rng.random(n) < 0.7)
    raise ValueError("two-choice placement did not converge")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-keys", type=int, default=24_000_000)
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])

    n = args.n_keys
    nb = max(16, 1 << int(np.ceil(np.log2(n / 2))))
    keys = np.arange(1, n + 1, dtype=np.uint64)
    print(f"{n} keys into {nb} buckets x 4 slots "
          f"(load {n / (nb * 4):.4f})", flush=True)

    t0 = time.perf_counter()
    card = kv.assign_two_choice(keys, nb, 4, device=torch.device("cuda"))
    card_s = time.perf_counter() - t0
    print(f"card sorts (kv.assign_two_choice): {card_s:.3f} s", flush=True)

    t0 = time.perf_counter()
    bkt, slot, rounds = numpy_placement(keys, nb, 4)
    numpy_s = time.perf_counter() - t0
    print(f"numpy lexsort rounds: {numpy_s:.3f} s, {rounds} rounds")
    if not (np.array_equal(card[0], bkt) and np.array_equal(card[1], slot)):
        raise SystemExit("FAIL: the two placements differ")
    print("ok: both placements are identical")


if __name__ == "__main__":
    main()
