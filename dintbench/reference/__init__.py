"""The plain references of the benchmark's configurations, in plain
PyTorch, and the reference as a system: it takes the same inputs as the
measured one (made again from the seed by `dintbench.inputs`) and gives
outputs under the same names, so the comparison reads both alike and the
control (the reference with a guarantee broken) can stand in the
program's place. Nothing here imports the measured package."""
from __future__ import annotations

import torch

from .. import inputs
from .smallbank import SmallBankReference
from .tatp import TatpReference

# Steps from a cohort's draws to the stats row that reports it (TATP's
# commit wave comes two steps after its reads, SmallBank's install one),
# and where a stats row holds attempted, committed and the conflict
# aborts (TATP: lock and validation; SmallBank: lock).
LAG = {"tatp_dense": 2, "smallbank_dense": 1, "tatp_sharded": 2}
STATS_COLS = {"tatp_dense": (0, 1, (2, 4)), "smallbank_dense": (0, 1, (2,)),
              "tatp_sharded": (0, 1, (2, 4))}


class ReferenceSystem:
    """The reference of configuration ``cfg`` under traffic ``mix``, run
    block by block on the benchmark's inputs from ``seed``; ``control``
    names the guarantees it breaks (see the reference modules)."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device,
                 control=()):
        self.system = cfg["system"]
        self.seed, self.dev = seed, torch.device(device)
        self.cfg, self.control = cfg, frozenset(control)
        self.w, self.cpb = mix["width"], mix["cohorts_per_block"]
        if self.system == "smallbank_dense":
            self.ref = SmallBankReference(
                n_accounts=cfg["accounts"], init_balance=cfg["init_balance"],
                w=self.w, mix=cfg["mix"],
                hot_frac=mix["hot_frac"], hot_prob=mix["hot_prob"],
                lock_slots=cfg["lock_slots"], log_lanes=cfg["log_lanes"],
                log_capacity=cfg["log_capacity"], device=self.dev,
                control=control)
            self.parts = 1
            return
        self.parts = cfg.get("servers", 1)
        n = cfg["subscribers"]
        self.n_sub = -(-n // self.parts)
        self.ref = TatpReference(
            seed, parts=self.parts, n_sub=self.n_sub, w=self.w,
            val_words=cfg["val_words"], mix=cfg["mix"],
            nurand_a=cfg["nurand_a"], log_lanes=cfg["log_lanes"],
            log_capacity=cfg["log_capacity"], device=self.dev,
            control=control)

    def draws(self, block: int):
        if self.system == "smallbank_dense":
            return inputs.smallbank_block(self.seed, block, self.cpb,
                                          self.w, self.dev)
        return inputs.tatp_block(self.seed, block, self.cpb, self.parts,
                                 self.w, self.dev)

    def _row(self, s):
        return s if s.dim() == 1 else s.sum(0)

    def hand_in(self, draws):
        a, b = draws
        rows = []
        for i in range(self.cpb):
            s = self.ref.step(a[i], b[i])
            rows.append(self._row(s))
        return torch.stack(rows)

    def drain(self):
        if self.system == "smallbank_dense":
            return self.ref.step(None, None)[None]
        pay = inputs.tatp_drain(self.seed, self.parts, self.w, self.dev)
        return torch.stack([self._row(self.ref.step(None, pay[i]))
                            for i in range(2)])

    def outputs(self) -> dict:
        r, broken = self.ref, "log-2-replicas" in self.control
        if self.system == "smallbank_dense":
            ring, head = r.log()
            out = {"bal": r.bal[:r.dump], "heads": head}
            for k in range(3):
                out[f"log{k}"] = (torch.zeros_like(ring) if k == 2 and broken
                                  else ring)
            return out
        meta, val = r.tables()
        ring, head = r.log()
        if self.parts == 1:
            out = {"meta": meta[0], "val": val[0], "heads": head[0]}
            for k in range(3):
                out[f"log{k}"] = (torch.zeros_like(ring[0])
                                  if k == 2 and broken else ring[0])
            return out
        out = {}
        D = self.parts
        for p in range(D):
            out[f"meta.{p}"], out[f"val.{p}"] = meta[p], val[p]
            out[f"log.{p}"], out[f"heads.{p}"] = ring[p], head[p]
            for off in (1, 2):
                q = (p - off) % D
                out[f"bck{off}meta.{p}"] = meta[q]
                out[f"bck{off}val.{p}"] = val[q]
        return out

    def locks_held(self) -> int:
        return self.ref.locks_held()
