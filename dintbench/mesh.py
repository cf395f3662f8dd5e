"""The sharded cell across processes: one process a shard server, each on
its own card (NCCL), joined by `dint_tpu_torch.parallel.dist` over a TCP
rendezvous on a free local port. The run's own process is rank 0: it
spawns the other ranks, drives its shard like them, gathers every rank's
digests and views, waits for them to exit, and then judges. The
reference runs after the ranks are gone, on the card no server uses
where there is one (so no server card's peak includes it)."""
from __future__ import annotations

import multiprocessing as mp
import os
import socket
import sys
import threading
import time

import torch

from . import cell

TIMEOUT_S = 300.0


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank(rank: int, world: int, init: str, job: dict) -> dict | None:
    from dint_tpu_torch.parallel import dist
    from .sut import TatpSharded
    dev = "cpu" if job["device"] == "cpu" else None
    # NCCL's shared-memory transport would write under /dev/shm; the
    # ranks' cards talk over NVLink (or, on the CPU, gloo over TCP)
    os.environ["NCCL_SHM_DISABLE"] = "1"
    group = dist.initialize(init, world_size=world, rank=rank, device=dev,
                            local_rank=rank, local_world_size=world,
                            timeout_s=TIMEOUT_S)
    try:
        sys = TatpSharded(job["cfg"], job["mix"], job["seed"], group=group,
                          device=dev)
        run = cell.drive(sys, job["cfg"], job["mix"], job["seconds"],
                         job["trace"],
                         agree=lambda f: dist.all_agree(group, f))
        card = sys.dev
        mine = {"rank": rank, "digests": run["digests"],
                "locks": run["locks"], "peak": run["peak"],
                "view": run["view"], "card": str(card)}
        everyone = dist.gather_objects(group, mine)
        dist.barrier(group)
    finally:
        dist.shutdown()
    if rank != 0:
        return None
    run.pop("digests")
    run["ranks"] = everyone
    return run


def _watch(procs):
    """End this process when a server rank fails: the others would wait
    on it until the group's timeout."""
    while True:
        for p in procs:
            if p.exitcode not in (None, 0):
                print(f"dintbench: server rank {procs.index(p) + 1} exited "
                      f"with {p.exitcode}", file=sys.stderr, flush=True)
                for q in procs:
                    if q.is_alive():
                        q.kill()
                os._exit(1)
        if all(p.exitcode == 0 for p in procs):
            return
        time.sleep(0.5)


def run_ranks(job: dict) -> dict:
    """Rank 0 here, ranks 1.. spawned; returns rank 0's record with every
    rank's digests, locks, peaks and views under ``ranks``."""
    world = job["cfg"]["servers"]
    init = f"tcp://127.0.0.1:{free_port()}"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, world, init, job),
                         daemon=False) for r in range(1, world)]
    for p in procs:
        p.start()
    threading.Thread(target=_watch, args=(procs,), daemon=True).start()
    ok = False
    try:
        run = _rank(0, world, init, job)
        ok = True
    finally:
        # after a failure here the other ranks wait on this one: end them
        for p in procs:
            p.join(TIMEOUT_S if ok else 5)
            if p.is_alive():
                p.kill()
                p.join()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"a server rank exited with {bad}")
    return run


def reference_device(servers: int):
    """The card after the servers' where the machine has one, else the
    first."""
    n = torch.cuda.device_count()
    return torch.device("cuda", servers if n > servers else 0)
