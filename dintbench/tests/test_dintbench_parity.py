"""At tiny sizes on the CPU, the plain reference and the port give the
same per-step counts, tables, backups, logs and balances from the same
benchmark-made inputs, on every route of each system."""
from __future__ import annotations

import pytest
import torch

from dintbench import reference, sut

TATP_MIX = [0.35, 0.35, 0.10, 0.02, 0.14, 0.02, 0.02]
SB_MIX = [0.15, 0.15, 0.15, 0.25, 0.15, 0.15]
ROUTES = [{}, {"use_hotset": True}, {"use_fused": True},
          {"use_fused": True, "use_hotset": True}]


def tatp_cfg(n=800, **kw):
    cfg = {"system": "tatp_dense", "subscribers": n, "val_words": 10,
           "nurand_a": 1048575, "mix": TATP_MIX, "log_lanes": 16,
           "log_capacity": 1024, "log_replicas": 3, "backups": 0}
    cfg.update(kw)
    return cfg


def sb_cfg(n=512, slots=2048):
    return {"system": "smallbank_dense", "accounts": n, "init_balance": 1000,
            "mix": SB_MIX, "lock_slots": slots, "log_lanes": 16,
            "log_capacity": 2048, "log_replicas": 3, "backups": 0}


def drive(system, blocks):
    rows = [system.hand_in(system.draws(b)).to(torch.int64)
            for b in range(blocks)]
    rows.append(system.drain().to(torch.int64))
    return torch.cat(rows), system.outputs(), system.locks_held()


def same(port, ref):
    sp, op, lp = port
    sr, orr, lr = ref
    assert torch.equal(sp, sr)
    assert set(op) == set(orr)
    for k in op:
        assert torch.equal(op[k].reshape(orr[k].shape), orr[k]), k
    assert lp == lr == 0
    return sp.sum(0)


@pytest.mark.parametrize("route", ROUTES, ids=["default", "hotset", "fused",
                                               "fused+hotset"])
@pytest.mark.parametrize("n", [800, 60], ids=["spec_mix", "contention"])
def test_tatp_port_equals_reference(monkeypatch, route, n):
    monkeypatch.setattr(sut, "_route", lambda wl: route)
    # at 60 subscribers, a mix of the writing transactions only: locks
    # collide and installs change rows that others have read
    cfg = tatp_cfg(n) if n == 800 else tatp_cfg(
        n, mix=[0.1, 0.0, 0.1, 0.3, 0.1, 0.3, 0.1])
    mix = {"width": 64, "cohorts_per_block": 4}
    seed = 2**40 + 17
    tot = same(drive(sut.TatpDense(cfg, mix, seed, "cpu"), 12),
               drive(reference.ReferenceSystem(cfg, mix, seed, "cpu"), 12))
    assert tot[1] > 0 and tot[3] > 0          # commits and missing rows
    if n == 60:
        assert tot[2] > 0 and tot[4] > 0      # lock and validation aborts


@pytest.mark.parametrize("route", ROUTES, ids=["default", "hotset", "fused",
                                               "fused+hotset"])
@pytest.mark.parametrize("slots", [2048, 256], ids=["exact", "hashed"])
def test_smallbank_port_equals_reference(monkeypatch, route, slots):
    from dint_tpu_torch.engines import smallbank_dense as sd
    monkeypatch.setattr(sut, "_route", lambda wl: route)
    monkeypatch.setattr(sd, "MAX_LOCK_SLOTS", slots)
    cfg = sb_cfg(slots=slots)
    mix = {"width": 32, "cohorts_per_block": 4, "hot_frac": 0.04,
           "hot_prob": 0.9}
    seed = 3**30
    tot = same(drive(sut.SmallBankDense(cfg, mix, seed, "cpu"), 12),
               drive(reference.ReferenceSystem(cfg, mix, seed, "cpu"), 12))
    assert tot[1] > 0 and tot[2] > 0 and tot[3] > 0


@pytest.mark.parametrize("route", [{}, {"use_fused": True}],
                         ids=["default", "fused"])
def test_three_shard_mesh_equals_reference(monkeypatch, route):
    monkeypatch.setattr(sut, "_route", lambda wl: route)
    cfg = tatp_cfg(900, system="tatp_sharded", servers=3, backups=2)
    mix = {"width": 64, "cohorts_per_block": 4}
    tot = same(drive(sut.TatpSharded(cfg, mix, 99, device="cpu"), 8),
               drive(reference.ReferenceSystem(cfg, mix, 99, "cpu"), 8))
    assert tot[1] > 0
