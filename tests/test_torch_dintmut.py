"""dintmut on the port: the mutation-coverage plane proven on the pinned
MUTCOV_TORCH.json, case for case with tests/test_dintmut.py.

  * the operator registry and the quick sample are deterministic,
  * discovery on a live trace reproduces the pinned anchor cells, and
    every discovered mutant builds a walkable copy (the cached trace is
    never edited),
  * the pinned matrix clears the policy bar and every operator kills
    within its expected family, every required family attributes a kill,
  * survivor triage is an allowlist entry pinned to the cell id; an
    untriaged survivor, stale provenance, summary drift, a forged quick
    sample, the floor, a dormant operator, an attribution gap, a crashed
    mutant and missing or mis-schemaed artifacts each fail closed,
  * the ring cells cite the standing durability/no-ring-truncation
    entries,
  * a quick cell re-runs bit for bit, and the CLI round-trips.

The whole matrix re-run is the slow tier."""
import copy
import json
import os

import pytest

from dint_tpu_torch import analysis, dintmut
from dint_tpu_torch.analysis import allowlist as al
from dint_tpu_torch.analysis import mutate as M
from dint_tpu_torch.analysis import targets as T
from dint_tpu_torch.analysis.passes import mut_check as MC

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MUTCOV_PINNED = os.path.join(REPO, "MUTCOV_TORCH.json")
ANCHOR = "tatp_dense/block"
REGEN = "dint_tpu_torch.dintmut run"

pytestmark = pytest.mark.mut

_DOC = None


def _doc() -> dict:
    """A fresh deep copy of the pinned MUTCOV_TORCH.json (loaded once)."""
    global _DOC
    if _DOC is None:
        _DOC = M.load_mutcov(MUTCOV_PINNED)
    return copy.deepcopy(_DOC)


def _repin(doc: dict) -> dict:
    """Re-derive summary, quick sample and provenance after a cell edit,
    so ONLY the policy checks see the edit."""
    doc["summary"] = M._summary(doc["cells"])
    doc["quick"] = {"seed": M.QUICK_SEED,
                    "cells": M.quick_sample(doc["cells"], M.QUICK_SEED)}
    doc["provenance"] = {"registry": M.registry_hash(),
                         "matrix": M.matrix_hash(),
                         "cells": M._digest(doc["cells"])}
    return doc


def codes(findings):
    return {f.code for f in findings}


def _entries():
    return al.load(analysis.DEFAULT_ALLOWLIST)


# ------------------------------------------------------------ determinism


def test_registry_and_matrix_hashes_are_deterministic():
    assert M.registry_hash() == M.registry_hash()
    assert M.matrix_hash() == M.matrix_hash()
    assert M._digest({"a": 1, "b": 2}) == M._digest({"b": 2, "a": 1})
    assert M._digest([1, 2]) != M._digest([2, 1])
    # the reference's six targets with its operator sets, the donation
    # operator under its port name
    assert set(T.MUT_TARGETS) == {
        "tatp_dense/block", "smallbank_dense/block", "dense_sharded/block",
        "dense_sharded_sb/block", "multihost_sb/block", "store/block@scan"}
    assert M.OPERATORS["out-of-place-write"].stands_for == "drop-donation"


def test_quick_sample_is_deterministic_and_pinned():
    doc = _doc()
    cells = doc["cells"]
    seed = doc["quick"]["seed"]
    draw1 = M.quick_sample(cells, seed)
    draw2 = M.quick_sample(cells, seed)
    assert draw1 == draw2 == doc["quick"]["cells"]
    ids = {c["id"] for c in cells}
    assert set(draw1) <= ids
    assert len({i.split("|")[1] for i in draw1}) == len(draw1)


def test_discovery_reproduces_the_pinned_anchor_cells():
    trace = T.get_trace(ANCHOR)
    ops = _doc()["targets"][ANCHOR]["operators"]
    muts1 = M.discover(trace, ops)
    muts2 = M.discover(trace, ops)
    assert [m.cell_id for m in muts1] == [m.cell_id for m in muts2]
    assert [(m.site, m.note) for m in muts1] \
        == [(m.site, m.note) for m in muts2]
    pinned = [(c["id"], c["site"], c["note"]) for c in _doc()["cells"]
              if c["target"] == ANCHOR]
    assert [(m.cell_id, m.site, m.note) for m in muts1] == pinned


def test_every_discovered_mutant_builds():
    """Each mutant is a walkable copy: a new graph whose every node has a
    meta value where the base had one; the cached trace is untouched."""
    trace = T.get_trace(ANCHOR)
    before = [(n.name, n.target, n.args) for n in trace.graph.nodes]
    muts = M.discover(trace, _doc()["targets"][ANCHOR]["operators"])
    assert muts, "anchor target produced no mutants"
    for m in muts:
        mt = m.build(trace)
        assert mt.graph is not trace.graph
        assert mt.gm is not trace.gm
        mt.graph.lint()
        for n in mt.graph.nodes:
            if n.op == "placeholder" and n.name.startswith("mut_"):
                assert n.meta.get("val") is not None, (m.cell_id, n.name)
    assert [(n.name, n.target, n.args)
            for n in trace.graph.nodes] == before


# ------------------------------------------------- pinned-evidence policy


def test_pinned_matrix_clears_the_policy_bar():
    doc = _doc()
    s = doc["summary"]
    assert s["kill_rate"] >= doc["kill_rate_floor"] >= M.KILL_RATE_FLOOR
    assert s["n_cells"] == len(doc["cells"])
    fs = MC.check_mutcov(doc, ANCHOR)
    assert codes(fs) <= {"survivor"}
    fs = al.apply(fs, _entries(), check_unused=False)
    assert not analysis.has_errors(fs)


def test_every_operator_kills_within_its_expected_family():
    doc = _doc()
    by_op: dict[str, list[dict]] = {}
    for c in doc["cells"]:
        by_op.setdefault(c["operator"], []).append(c)
    assert set(by_op) == set(M.OPERATORS), "matrix lost an operator"
    for name, cells in by_op.items():
        killed = [c for c in cells if c["verdict"] == "killed"]
        assert killed, f"operator {name} killed nothing"
        expect = {e.split("/", 1)[0] for e in M.OPERATORS[name].expect}
        for c in killed:
            assert c["killer"].split("/", 1)[0] in expect, c["id"]


def test_required_families_each_attribute_a_kill():
    killers = set(_doc()["summary"]["killer_passes"])
    assert {"protocol", "durability", "cost_budget"} <= killers
    assert killers & MC._CORE_PASSES, "no core dintlint pass kills"


# ------------------------------------------------------- survivor triage


def test_survivor_triage_is_pinned_to_the_cell_id():
    doc = _repin(_doc())
    survivors = [c for c in doc["cells"] if c["verdict"] == "survived"]
    assert survivors, "pinned matrix lost its documented survivor"
    cid = survivors[0]["id"]
    fs = MC.check_mutcov(doc, ANCHOR)
    assert len([f for f in fs if f.code == "survivor"
                and f.site == cid]) == 1
    scoped = [{"pass": "mut_check", "code": "survivor", "site": cid,
               "reason": "documented non-goal (test)"}]
    fs = al.apply(MC.check_mutcov(doc, ANCHOR), scoped, check_unused=False)
    assert not any(f.site == cid and not f.suppressed for f in fs
                   if f.code == "survivor")
    elsewhere = [{"pass": "mut_check", "code": "survivor",
                  "site": "some/other|cell|9", "reason": "mis-scoped"}]
    fs = al.apply(MC.check_mutcov(doc, ANCHOR), elsewhere,
                  check_unused=False)
    assert any(f.site == cid and not f.suppressed for f in fs)
    # every survivor of the pinned matrix is triaged in the port's file
    fs = al.apply(MC.check_mutcov(_doc(), ANCHOR), _entries(),
                  check_unused=False)
    assert all(f.suppressed and f.allowed_by.strip() for f in fs
               if f.code == "survivor")


def test_untriaged_survivor_fails_the_gate():
    doc = _doc()
    victim = next(c for c in doc["cells"] if c["verdict"] == "killed")
    victim["verdict"], victim["killer"] = "survived", ""
    victim["new_errors"] = []
    _repin(doc)
    fs = MC.check_mutcov(doc, ANCHOR)
    assert any(f.code == "survivor" and f.site == victim["id"] for f in fs)
    fs = al.apply(fs, _entries(), check_unused=False)
    assert analysis.has_errors(fs)


def test_a_crashed_mutant_is_no_kill():
    doc = _doc()
    victim = next(c for c in doc["cells"] if c["verdict"] == "killed")
    victim["verdict"], victim["killer"] = "crashed", ""
    victim["new_errors"] = ["cost_budget/pass-crash"]
    _repin(doc)
    assert doc["summary"]["n_killed"] == _doc()["summary"]["n_killed"] - 1
    fs = MC.check_mutcov(doc, ANCHOR)
    assert any(f.code == "mutant-crashed" and f.site == victim["id"]
               for f in fs)


# ------------------------------------------------------------ drift guard


def test_edited_cells_trip_stale_provenance_with_regen_hint():
    doc = _doc()
    doc["cells"][0]["verdict"] = "survived"
    fs = MC.check_mutcov(doc, ANCHOR)
    stale = [f for f in fs if f.code == "stale-provenance"]
    assert any(f.site == "cells" for f in stale)
    assert all(REGEN in f.suggestion for f in stale)


def test_edited_summary_trips_summary_drift():
    doc = _doc()
    doc["summary"]["kill_rate"] = 1.0
    doc["summary"]["n_survived"] = 0
    fs = MC.check_mutcov(doc, ANCHOR)
    assert any(f.code == "summary-drift" and f.site == "summary"
               for f in fs)


def test_forged_quick_sample_trips_summary_drift():
    doc = _doc()
    doc["quick"]["cells"] = doc["quick"]["cells"][:-1]
    fs = MC.check_mutcov(doc, ANCHOR)
    assert any(f.code == "summary-drift" and f.site == "quick"
               for f in fs)


def test_kill_rate_floor_and_dormant_operator_fire():
    doc = _doc()
    for c in doc["cells"]:
        if c["operator"] == "drop-eqn":
            c["verdict"], c["killer"] = "survived", ""
            c["new_errors"] = []
    _repin(doc)
    assert "kill-rate-floor" in codes(MC.check_mutcov(doc, ANCHOR))
    # a document that claims a lower floor is held to the standing one
    doc["kill_rate_floor"] = 0.5
    assert "kill-rate-floor" in codes(MC.check_mutcov(doc, ANCHOR))

    doc = _doc()
    doc["cells"] = [c for c in doc["cells"]
                    if c["operator"] != "out-of-place-write"]
    _repin(doc)
    fs = MC.check_mutcov(doc, ANCHOR)
    assert any(f.code == "operator-dormant"
               and f.site == "out-of-place-write" for f in fs)


def test_attribution_gap_fires_when_a_family_stops_killing():
    doc = _doc()
    for c in doc["cells"]:
        if c["killer"].startswith("cost_budget/"):
            c["killer"] = "protocol/unlocked-install"
    _repin(doc)
    fs = MC.check_mutcov(doc, ANCHOR)
    assert any(f.code == "attribution-gap" and f.site == "cost_budget"
               for f in fs)


def test_missing_and_mis_schemaed_artifacts_fail_closed(tmp_path):
    doc, fs = MC.load_mutcov_findings(ANCHOR, str(tmp_path / "no.json"))
    assert doc is None and codes(fs) == {"missing-mutcov"}
    assert REGEN in fs[0].suggestion
    bad = tmp_path / "old.json"
    old = _doc()
    old["schema"] = M.SCHEMA + 1
    bad.write_text(json.dumps(old))
    with pytest.raises(ValueError, match=REGEN):
        M.load_mutcov(str(bad))
    doc, fs = MC.load_mutcov_findings(ANCHOR, str(bad))
    assert doc is None and codes(fs) == {"malformed-mutcov"}
    # the reference's MUTCOV.json is never the port's artifact
    assert M.mutcov_path().name == "MUTCOV_TORCH.json"


def test_structure_findings_short_circuit():
    doc = _doc()
    del doc["summary"]
    del doc["cells"][0]["killer"]
    assert codes(MC.check_mutcov(doc, ANCHOR)) == {"malformed-mutcov"}


# ------------------------------------------------------------ ring hygiene


def test_ring_cells_cite_the_standing_truncation_entry(tmp_path):
    doc = _doc()
    ring = [c for c in doc["cells"] if c["operator"] == "ring-shrink"]
    assert ring, "matrix lost its ring-shrink cells"
    for c in ring:
        assert MC._RING_ENTRY in c["suppressed"]
    ring[0]["suppressed"] = [s for s in ring[0]["suppressed"]
                             if s != MC._RING_ENTRY]
    _repin(doc)
    fs = MC.check_mutcov(doc, ANCHOR)
    assert any(f.code == "ring-triage-drift" and f.site == ring[0]["id"]
               for f in fs)
    bare = tmp_path / "allow.json"
    bare.write_text(json.dumps([]))
    fs = MC.check_mutcov(_doc(), ANCHOR, allow_path=str(bare))
    assert any(f.code == "ring-triage-drift" and f.site == MC._RING_ENTRY
               for f in fs)


# --------------------------------------------------- re-execution tiers


def test_quick_cell_reexecutes_bit_for_bit():
    doc = _doc()
    ids = [i for i in doc["quick"]["cells"] if i.split("|")[0] == ANCHOR]
    assert ids, "quick sample no longer covers the anchor"
    fresh = M.run_cells(ids)
    pinned = {c["id"]: c for c in doc["cells"]}
    for cell in fresh:
        want = pinned[cell["id"]]
        for k in ("verdict", "killer", "site", "note", "new_errors",
                  "suppressed"):
            assert cell[k] == want[k], (cell["id"], k)


@pytest.mark.slow
def test_full_matrix_reproduces_pinned_rows():
    fresh = M.run_matrix()
    pinned = _doc()
    assert fresh["cells"] == pinned["cells"]
    assert fresh["summary"] == pinned["summary"]
    assert fresh["quick"] == pinned["quick"]
    assert fresh["provenance"] == pinned["provenance"]


# ------------------------------------------------------------------- CLI


def test_cli_report_round_trip(capsys):
    assert dintmut.main(["report", "--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["metric"] == "mutation-coverage"
    assert payload["mode"] == "report" and payload["ok"] is True
    assert payload["summary"] == _doc()["summary"]
    assert payload["quick"] == _doc()["quick"]
    assert dintmut.main(["report"]) == 0
    out = capsys.readouterr().out
    assert "killed" in out and "quick sample" in out
    for cid in (c["id"] for c in _doc()["cells"]
                if c["verdict"] == "survived"):
        assert cid in out


def test_cli_describe_lists_every_operator(capsys):
    assert dintmut.main(["describe"]) == 0
    out = capsys.readouterr().out
    for name in M.OPERATORS:
        assert name in out
    assert "drop-donation" in out
    assert "survivor" in out and "kill-rate-floor" in out


def test_cli_check_fails_on_stale_artifact(tmp_path, capsys, monkeypatch):
    doc = _doc()
    doc["cells"][0]["verdict"] = "survived"
    path = tmp_path / "MUTCOV_TORCH.json"
    path.write_text(json.dumps(doc))
    monkeypatch.setenv(M.ENV_MUTCOV, str(path))
    assert dintmut.main(["check", "--quick"]) == 1
    assert "stale-provenance" in capsys.readouterr().out


def test_cli_check_names_a_drifted_cell(tmp_path, capsys, monkeypatch):
    """A pinned quick cell whose recorded killer no longer matches its
    re-run fails with cell-drift (hashes re-pinned, so only the re-run
    tier sees it)."""
    doc = _doc()
    cid = next(i for i in doc["quick"]["cells"]
               if i.split("|")[0] == ANCHOR)
    cell = next(c for c in doc["cells"] if c["id"] == cid)
    cell["new_errors"] = sorted(cell["new_errors"] + ["purity/forged"])
    _repin(doc)
    path = tmp_path / "MUTCOV_TORCH.json"
    path.write_text(json.dumps(doc))
    monkeypatch.setenv(M.ENV_MUTCOV, str(path))
    monkeypatch.setattr(M, "run_cells", lambda ids, **kw: [
        c for c in _doc()["cells"] if c["id"] in ids])
    assert dintmut.main(["check", "--quick"]) == 1
    out = capsys.readouterr().out
    assert "cell-drift" in out and cid in out


def test_cli_report_missing_artifact_exits_2(tmp_path, capsys,
                                             monkeypatch):
    monkeypatch.setenv(M.ENV_MUTCOV, str(tmp_path / "nope.json"))
    assert dintmut.main(["report"]) == 2
    assert "dintmut:" in capsys.readouterr().err


def test_cli_check_quick_passes_on_pinned_artifact(capsys):
    """The dintgate tier end to end: every quick cell re-run."""
    assert dintmut.main(["check", "--quick", "--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["mode"] == "quick" and payload["ok"] is True
    assert payload["n_errors"] == 0 and payload["n_suppressed"] >= 1


# ------------------------------------------------------- lint integration


def broken_mutcov_findings():
    """The canonical broken fixture (a killed cell flipped to survived:
    stale-provenance + survivor), also imported by test_torch_dintlint's
    every-pass parametrization."""
    doc = _doc()
    victim = next(c for c in doc["cells"] if c["verdict"] == "killed")
    victim["verdict"], victim["killer"] = "survived", ""
    return MC.check_mutcov(doc, "fixture/mut_check")


def test_mut_check_broken_fixture_fires():
    fs = broken_mutcov_findings()
    assert {"stale-provenance", "survivor"} <= codes(fs)


def test_mut_check_anchors_to_one_target(monkeypatch):
    from dint_tpu_torch.analysis.core import TargetTrace
    off = TargetTrace("smallbank_dense/block", None)
    assert MC.mut_check(off) == []
    monkeypatch.setenv(MC.ENV_MUT_ANCHOR, "smallbank_dense/block")
    assert MC._anchor() == "smallbank_dense/block"


def test_pure_parts_equal_the_references():
    """The summary, the quick draw and the digest are the reference's
    functions, on the port's pinned cells."""
    from dint_tpu.analysis import mutate as RM
    cells = _doc()["cells"]
    assert M._summary(cells) == RM._summary(cells)
    for seed in (M.QUICK_SEED, 7):
        assert M.quick_sample(cells, seed) == RM.quick_sample(cells, seed)
    assert M._digest(cells) == RM._digest(cells)
    assert (M.KILL_RATE_FLOOR, M.QUICK_SEED, M.MAX_SITES) == (
        RM.KILL_RATE_FLOOR, RM.QUICK_SEED, RM.MAX_SITES)
