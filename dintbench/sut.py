"""The systems under test: the measured package's runners, fed the
benchmark's inputs through ``run.run_draws`` and read back through their
outputs. The route is the one the package's own plan pins for the
workload (`dint_tpu_torch.plan.resolve_for`, read with an empty
environment so that no flag of the caller's changes it).

A system is built from a configuration (its file under configs/) and a
traffic mix (its file under traffic/). Each gives:

* ``draws(block)``: the block's draws, made by `inputs` from the seed;
* ``hand_in(draws)``: one block through the runner; the stats tensor
  (one row a step: the counts of the cohort that step completed);
* ``drain()``: the flush steps' stats;
* ``outputs()``: the tensors the comparison judges, by name, and
  ``locks_held()``: lock words still held after the drain.

The measured package is imported inside the constructors only: the
reference and the comparison never load it.
"""
from __future__ import annotations

import torch

from . import inputs

I32 = torch.int32
M32 = 0xFFFFFFFF


def _route(workload: str) -> dict:
    from dint_tpu_torch import plan
    knobs, _ = plan.resolve_for(workload, environ={})
    return knobs


def _heads(head: torch.Tensor) -> torch.Tensor:
    return head.to(torch.int64) & M32


class TatpDense:
    """TATP on one card: `engines.tatp_dense`'s pipelined runner over the
    whole subscriber range, its three log replicas packed a slot."""
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        from dint_tpu_torch.engines import tatp_dense as td
        from dint_tpu_torch.tables import log as logring
        self.td, self.seed, self.dev = td, seed, torch.device(device)
        self.n, self.vw = cfg["subscribers"], cfg["val_words"]
        self.w, self.cpb = mix["width"], mix["cohorts_per_block"]
        self.replicas = cfg["log_replicas"]
        knobs = _route("tatp_uniform")
        self.route = knobs
        meta, val = inputs.tatp_tables(seed, 0, self.n, self.vw, self.dev)
        db = td.DenseDB(
            val=val, meta=meta, arb=torch.zeros_like(meta), step=2,
            log=logring.create_rep(cfg["log_lanes"], cfg["log_capacity"],
                                   self.vw, replicas=self.replicas,
                                   device=self.dev),
            val_words=self.vw)
        run, init, self._drain = td.build_pipelined_runner(
            self.n, w=self.w, val_words=self.vw, cohorts_per_block=self.cpb,
            mix=cfg["mix"], use_hotset=bool(knobs.get("use_hotset")),
            use_fused=bool(knobs.get("use_fused")), device=self.dev)
        self._run = run.run_draws
        self.carry = init(db)

    def draws(self, block: int):
        bits, payload = inputs.tatp_block(self.seed, block, self.cpb, 1,
                                          self.w, self.dev)
        return bits[:, 0], payload[:, 0]

    def hand_in(self, draws):
        self.carry, stats = self._run(self.carry, *draws)
        return stats

    def drain(self):
        pay = inputs.tatp_drain(self.seed, 1, self.w, self.dev)[:, 0]
        out = self._drain(self.carry, pay)
        self.db = out[0]
        self.carry = None
        return out[1]

    def outputs(self) -> dict:
        db = self.db
        e = db.log.entries
        ew = e.shape[1] // self.replicas
        out = {"meta": db.meta, "val": db.val, "heads": _heads(db.log.head)}
        for r in range(self.replicas):
            out[f"log{r}"] = e[:, r * ew:(r + 1) * ew]
        return out

    def locks_held(self) -> int:
        db = self.db
        return int((((db.arb >> self.td.K_ARB)
                     & ((1 << (32 - self.td.K_ARB)) - 1))
                    == db.step - 1).sum())


class SmallBankDense:
    """SmallBank on one card: `engines.smallbank_dense`'s pipelined runner
    over every account, its three log replicas packed a slot."""
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        from dint_tpu_torch.engines import smallbank_dense as sd
        from dint_tpu_torch.tables import log as logring
        self.seed, self.dev = seed, torch.device(device)
        self.n = cfg["accounts"]
        self.w, self.cpb = mix["width"], mix["cohorts_per_block"]
        self.replicas = cfg["log_replicas"]
        knobs = _route("smallbank_skewed")
        self.route = knobs
        slots = sd.lock_slots_for(2 * self.n + 1)
        if slots != cfg["lock_slots"]:
            raise ValueError(f"the engine sizes {slots} lock slots, the "
                             f"configuration states {cfg['lock_slots']}")
        bal = inputs.smallbank_balances(self.n, cfg["init_balance"],
                                        self.dev)
        h = cfg["lock_slots"]
        db = sd.DenseBank(
            bal=bal, x_step=torch.zeros(h, dtype=I32, device=self.dev),
            s_step=torch.zeros(h, dtype=I32, device=self.dev), step=2,
            log=logring.create_rep(cfg["log_lanes"], cfg["log_capacity"],
                                   2, replicas=self.replicas,
                                   device=self.dev))
        run, init, self._drain = sd.build_pipelined_runner(
            self.n, w=self.w, cohorts_per_block=self.cpb,
            hot_frac=mix["hot_frac"], hot_prob=mix["hot_prob"],
            mix=cfg["mix"], use_hotset=bool(knobs.get("use_hotset")),
            use_fused=bool(knobs.get("use_fused")), device=self.dev)
        self._run = run.run_draws
        self.carry = init(db)

    def draws(self, block: int):
        return inputs.smallbank_block(self.seed, block, self.cpb, self.w,
                                      self.dev)

    def hand_in(self, draws):
        self.carry, stats = self._run(self.carry, *draws)
        return stats

    def drain(self):
        out = self._drain(self.carry)
        self.db = out[0]
        self.carry = None
        return out[1]

    def outputs(self) -> dict:
        db = self.db
        e = db.log.entries
        ew = e.shape[1] // self.replicas
        out = {"bal": db.bal, "heads": _heads(db.log.head)}
        for r in range(self.replicas):
            out[f"log{r}"] = e[:, r * ew:(r + 1) * ew]
        return out

    def locks_held(self) -> int:
        db = self.db
        last = db.step - 1
        return int(((db.x_step == last) | (db.s_step == last)).sum())


class TatpSharded:
    """TATP as D shard servers, one a process (this one is rank
    ``group.rank``): `parallel.dense_sharded`'s runner over a mesh across
    the ranks, each shard's writes installed on its two successors'
    backups and logged on all three. Every rank makes the whole block
    from the seed; the runner keeps the rank's slice."""
    def __init__(self, cfg: dict, mix: dict, seed: int, group=None,
                 device=None):
        from dint_tpu_torch.engines import tatp_dense as td
        from dint_tpu_torch.parallel import dense_sharded as ds
        from dint_tpu_torch.tables import log as logring
        self.td, self.seed = td, seed
        self.D = cfg["servers"]
        self.n, self.vw = cfg["subscribers"], cfg["val_words"]
        self.n_loc = ds.n_sub_local(self.n, self.D)
        self.w, self.cpb = mix["width"], mix["cohorts_per_block"]
        knobs = _route("tatp_sharded")
        self.route = knobs
        # across ranks: the rank's shard on its card; in one process
        # (group None): every shard on ``device``
        self.mesh = ds.make_mesh(self.D, device=device, group=group)
        self.dev = self.mesh.device
        self.local = list(self.mesh.local)
        dbs = [None] * self.D
        for p in self.local:
            dev = self.mesh.devices[p]
            meta, val = inputs.tatp_tables(seed, p, self.n_loc, self.vw, dev)
            dbs[p] = td.DenseDB(
                val=val, meta=meta, arb=torch.zeros_like(meta), step=2,
                log=logring.create_rep(cfg["log_lanes"], cfg["log_capacity"],
                                       self.vw, replicas=1, device=dev),
                val_words=self.vw)
        states = ds._with_backups(self.mesh, ds.SHARD_AXIS, dbs)
        run, init, self._drain = ds.build_sharded_pipelined_runner(
            self.mesh, self.D, self.n, w=self.w, val_words=self.vw,
            cohorts_per_block=self.cpb, mix=cfg["mix"],
            use_fused=bool(knobs.get("use_fused")))
        self._run = run.run_draws
        self.carry = init(states)

    def draws(self, block: int):
        return inputs.tatp_block(self.seed, block, self.cpb, self.D,
                                 self.w, self.dev)

    def hand_in(self, draws):
        self.carry, stats = self._run(self.carry, *draws)
        return stats

    def drain(self):
        pay = inputs.tatp_drain(self.seed, self.D, self.w, self.dev)
        out = self._drain(self.carry, pay)
        self.states = out[0]
        self.carry = None
        return out[1]

    def outputs(self) -> dict:
        out = {}
        for p in self.local:
            s = self.states[p]
            db = s.db
            n1 = db.meta.shape[0]
            out.update({f"meta.{p}": db.meta, f"val.{p}": db.val,
                        f"log.{p}": db.log.entries,
                        f"heads.{p}": _heads(db.log.head)})
            for off in (1, 2):
                k = off - 1
                out[f"bck{off}meta.{p}"] = s.bck_meta[k * n1:(k + 1) * n1]
                out[f"bck{off}val.{p}"] = s.bck_val[k * n1 * self.vw:
                                                    (k + 1) * n1 * self.vw]
        return out

    def locks_held(self) -> int:
        k = self.td.K_ARB
        return sum(int((((self.states[p].db.arb >> k) & ((1 << (32 - k)) - 1))
                        == self.states[p].db.step - 1).sum())
                   for p in self.local)


SYSTEMS = {"tatp_dense": TatpDense, "smallbank_dense": SmallBankDense,
           "tatp_sharded": TatpSharded}
