"""``correct`` comes out false when the timed path is broken underneath
and the rest of a run goes on (the look for a card skipped: the cells at
their tiny sizes on the CPU), for each fault a cell can have: a step that
leaves its state unchanged, half of each cohort left out, an answer or an
installed word altered where it is produced, the exchange between the
servers left out; for outputs corrupted after the drain (a log replica
dropped, an installed word flipped); for a log ring that wraps, on which
both sides agree; and for the controls, the reference
with a guarantee broken standing in the program's place."""
from __future__ import annotations

import copy
import json

import pytest
import torch

from dintbench import cell, compare, registry, sut
from dintbench import run as bench_run
from dintbench.tests.tiny import make_root

TATP, SB, SRV = ("tatp-7m.closed-w128k", "smallbank-24m.closed-w64k",
                 "tatp-7m-3srv.closed-w32k")
ENGINE = {TATP: "tatp_dense", SB: "smallbank_dense", SRV: "tatp_dense"}


def verdict(root, workload, control="") -> dict:
    """A run of ``workload`` in this process; the sharded cell's servers
    as one process's mesh (no spawn, so the faults below reach them)."""
    if workload != SRV or control:
        args = bench_run.parse(["--workload", workload, "--seed", "77",
                                "--seconds", "0.3", "--trace", "0",
                                "--device", "cpu", "--control", control])
        return bench_run.run(args, root)["result"]
    c = registry.cell(registry.load(root), workload, root)
    system = sut.TatpSharded(c["cfg"], c["mix"], 77, device="cpu")
    run = cell.drive(system, c["cfg"], c["mix"], 0.3, False)
    cell.free(system)
    v = cell.judge(c["cfg"], c["mix"], 77, "cpu", run, run["digests"],
                   run["locks"])
    return {"correct": compare.verdict(v["counts"]),
            "checks": compare.report(v["counts"])}


def engine(workload):
    from dint_tpu_torch.engines import smallbank_dense, tatp_dense
    return tatp_dense if ENGINE[workload] == "tatp_dense" else smallbank_dense


def unchanged(orig):
    """The step runs on a copy of the tables: the real ones stay as they
    were."""
    def step(db, *a, **kw):
        out = orig(copy.deepcopy(db), *a, **kw)
        return (db,) + tuple(out[1:])
    return step


def half(orig):
    """Every new cohort's lanes past the first half left out."""
    def step(db, *a, **kw):
        if kw.get("occupancy") is None:
            kw["occupancy"] = torch.tensor(kw["w"] // 2, dtype=torch.int32)
        return orig(db, *a, **kw)
    return step


def answer(orig, pos):
    """One more commit in every step's counts."""
    def step(db, *a, **kw):
        out = list(orig(db, *a, **kw))
        out[pos] = out[pos] + torch.tensor([0, 1, 0, 0, 0, 0],
                                           dtype=out[pos].dtype)
        return tuple(out)
    return step


def flipped_word(orig):
    """A bit of a table word set in every step, where the step writes."""
    def step(db, *a, **kw):
        out = orig(db, *a, **kw)
        tab = db.bal if hasattr(db, "bal") else db.val
        tab[1] |= 1 << 7
        return out
    return step


@pytest.fixture
def root(tmp_path):
    return make_root(tmp_path)


@pytest.mark.parametrize("workload", [TATP, SB, SRV])
def test_sound_runs_are_correct(root, workload):
    assert verdict(root, workload)["correct"] is True


@pytest.mark.parametrize("fault", ["unchanged", "half", "answer", "word"])
@pytest.mark.parametrize("workload", [TATP, SB, SRV])
def test_a_broken_step_is_not_correct(root, monkeypatch, workload, fault):
    mod = engine(workload)
    orig = mod.pipe_step
    stats_pos = 3 if mod.__name__.endswith("tatp_dense") else 2
    broken = {"unchanged": unchanged, "half": half,
              "answer": lambda o: answer(o, stats_pos),
              "word": flipped_word}[fault](orig)
    monkeypatch.setattr(mod, "pipe_step", broken)
    assert verdict(root, workload)["correct"] is False


def test_the_exchange_left_out_is_not_correct(root, monkeypatch):
    from dint_tpu_torch.parallel import dense_sharded as ds
    monkeypatch.setattr(ds, "_apply_backup", lambda state, *a, **k: state)
    v = verdict(root, SRV)
    assert v["correct"] is False
    assert v["checks"]["backups"][0] > 0 and v["checks"]["log"][0] > 0


@pytest.mark.parametrize("output", ["log", "word"])
@pytest.mark.parametrize("workload", [TATP, SB, SRV])
def test_corrupted_outputs_are_not_correct(root, monkeypatch, workload,
                                           output):
    cls = {TATP: sut.TatpDense, SB: sut.SmallBankDense,
           SRV: sut.TatpSharded}[workload]
    orig = cls.outputs

    def corrupt(self):
        out = dict(orig(self))
        if output == "log":
            k = sorted(x for x in out if x.startswith("log"))[-1]
            out[k] = torch.zeros_like(out[k])
        else:
            k = sorted(x for x in out if x.split(".")[0] in ("val", "bal"))[0]
            out[k] = out[k].clone()
            out[k][3] ^= 1
        return out

    monkeypatch.setattr(cls, "outputs", corrupt)
    v = verdict(root, workload)
    assert v["correct"] is False
    assert v["checks"]["log" if output == "log" else "tables"][0] > 0


@pytest.mark.parametrize("workload", [TATP, SB, SRV])
def test_a_log_that_wraps_is_not_correct(root, workload):
    # rings of 4 entries a lane: both sides overwrite the same slots and
    # agree, but acknowledged writes are gone
    cfg_edit = {n: {"log_capacity": 4}
                for n in ("tatp-7m", "smallbank-24m", "tatp-7m-3srv")}
    v = verdict(make_root(root / "small_log", cfg_edit), workload)
    assert v["correct"] is False
    assert v["checks"]["wrapped"][0] > 0
    assert v["checks"]["log"][0] == 0 and v["checks"]["heads"][0] == 0


@pytest.mark.parametrize("workload,control", [
    (TATP, "no-validate"), (TATP, "log-2-replicas"), (SB, "log-2-replicas"),
    (SRV, "no-validate"), (SRV, "log-2-replicas")])
def test_the_control_is_not_correct(root, workload, control):
    # the TATP controls need transactions that conflict: a contention mix
    # at the tiny size
    cfg_edit = None
    if control == "no-validate":
        cfg_edit = {n: {"subscribers": 30,
                        "mix": [0.1, 0.0, 0.1, 0.3, 0.1, 0.3, 0.1]}
                    for n in ("tatp-7m", "tatp-7m-3srv")}
        root = make_root(root / "contention", cfg_edit)
    v = verdict(root, workload, control)
    assert v["correct"] is False
    json.dumps(v)
