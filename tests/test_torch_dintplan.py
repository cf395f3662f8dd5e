"""The port's planner (dint_tpu_torch.analysis.plan), its gate
(passes/plan_check.py) and its CLI (python -m dint_tpu_torch.dintplan),
against the reference's planner on the CPU.

The reference's pricing needs its cost derivation, which is red on this
jax (ROADMAP §C.5), so the port's frontier is held to its own dintcost
and to mutated documents; the pure parts (the registry's resolution, the
dominance rule, the choice key, the per-workload ranking, check_plan's
pure-document codes) are held to the reference's on the same documents.
"""
import copy
import io
import json
import os
from contextlib import redirect_stdout
from pathlib import Path

import pytest

from dint_tpu.analysis import plan as jplan
from dint_tpu.analysis.passes import plan_check as jpc
from dint_tpu_torch import analysis
from dint_tpu_torch import dintplan
from dint_tpu_torch import plan as cplan
from dint_tpu_torch.analysis import allowlist as al
from dint_tpu_torch.analysis import plan as P
from dint_tpu_torch.analysis import targets as T
from dint_tpu_torch.analysis.passes import plan_check as pc
from dint_tpu_torch.monitor import calib as CAL

REPO = Path(__file__).resolve().parents[1]
H100 = REPO / "PLAN_H100.json"
ANCHOR = P.DEFAULT_ANCHOR
ENV_VARS = ("DINT_PLAN_PATH", "DINT_PLAN_STATIC", "DINT_PLAN_ANCHOR",
            "DINT_PLAN_OVERRIDE", "DINT_USE_HOTSET", "DINT_USE_FUSED",
            "DINT_CALIB_PATH")


@pytest.fixture(autouse=True)
def _clean_env():
    """Unset the plan's variables for the test and put back what was
    there after it (the CLI sets DINT_PLAN_STATIC and DINT_PLAN_PATH in
    os.environ, as the reference's does)."""
    saved = {k: os.environ.pop(k, None) for k in ENV_VARS}
    yield
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def _h100():
    return json.loads(H100.read_text())


def _ref():
    return json.loads((REPO / "PLAN.json").read_text())


def _recorded_pricer(doc):
    """The plan's own recorded prices as a pricer (no tracing)."""
    rows = {r["target"]: copy.deepcopy(r) for r in doc["frontier"]}
    return lambda t: {k: copy.deepcopy(rows[t][k])
                      for k in pc._DRIFT_KEYS}


def broken_plan_findings():
    """plan_check's canonical broken fixture: PLAN_H100.json with a pin
    moved onto a dominated candidate and its override reasons dropped."""
    doc = _h100()
    doc["workloads"]["tatp_uniform"]["target"] = "tatp_dense/block@hot"
    doc["workloads"]["smallbank_skewed"]["overrides"] = []
    return pc.check_plan(doc, ANCHOR, static=True, environ={})


# ------------------------------------------------------------ the registry


def test_registry_is_the_ports_knobs_and_maps_to_registered_targets():
    assert not {"use_pallas", "pallas_interpret", "trace_cap"} & set(P.KNOBS)
    assert set(P.KNOBS) == set(jplan.KNOBS) - {"use_pallas",
                                                "pallas_interpret",
                                                "trace_cap"}
    assert not hasattr(P, "env_knob_signature")
    for k in P.KNOBS.values():
        if k.planned:
            # each planned knob's token names at least one port target
            assert any(f"@{k.token}" in n or f"+{k.token}" in n
                       for n in T.TARGETS), k.name
    for wl in P.WORKLOADS:
        assert "use_pallas" not in wl.knobs
        for c in P.enumerate_candidates(wl):
            assert "@pallas" not in c["target"] and "+pallas" not in \
                c["target"]
            assert c["feasible"] == (c["target"] in T.TARGETS)
    # one source of truth: the consumers' module re-exports the registry
    assert cplan.KNOBS is P.KNOBS and cplan.resolve_for is P.resolve_for
    assert cplan.SERVE_WORKLOADS is P.SERVE_WORKLOADS
    assert cplan.plan_path is P.plan_path
    assert cplan.WORKLOAD_KNOBS == {w.name: w.knobs for w in P.WORKLOADS}


def test_a_combination_with_no_target_is_infeasible(monkeypatch):
    wl = P.WORKLOADS_BY_NAME["multihost_serve"]
    cands = {c["target"]: c["feasible"] for c in P.enumerate_candidates(wl)}
    assert cands == {"multihost_sb/serve": True,
                     "multihost_sb/serve@flat": True,
                     "multihost_sb/serve@overlap": True,
                     "multihost_sb/serve@overlap+flat": False}
    # drop a registered target: its combination turns infeasible and is
    # never priced
    monkeypatch.delitem(T.TARGETS, "tatp_dense/block@fused+hot")
    doc = _h100()
    priced = []
    rec = _recorded_pricer(doc)

    def pricer(t):
        priced.append(t)
        return rec(t)
    rows = P.price_frontier(pricer)
    assert "tatp_dense/block@fused+hot" not in priced
    assert {r["target"] for r in rows["tatp_uniform"]} == {
        "tatp_dense/block", "tatp_dense/block@hot",
        "tatp_dense/block@fused"}


def test_workload_mesh_is_the_geometry_its_targets_trace_at():
    g = {w.name: w for w in P.WORKLOADS}
    assert g["multihost_4x2"].mesh == "4x2" and T.MH4_HOSTS == 4
    assert T.TARGET_COST["multihost_sb/block"]["geom"]["d"] == 8
    assert T.TARGET_COST["multihost_sb/block@flat"]["geom"]["h"] == 4
    assert g["multihost_3x2"].mesh == "3x2"
    assert T.TARGET_COST["multihost_sb/block@h3"]["geom"]["d"] == 6
    assert g["multihost_serve"].mesh == "3x2"
    assert g["multihost_serve"].lanes_scale == 6
    assert T.TARGET_COST["multihost_sb/serve"]["geom"]["d"] == 6
    assert g["tatp_sharded"].mesh == g["smallbank_sharded"].mesh == \
        f"d={T.LINT.shards}"


ENVS = [
    {},
    {"DINT_USE_FUSED": "0", "DINT_USE_HOTSET": "0", "DINT_MONITOR": "0",
     "DINT_TRACE": "0", "DINT_TRACE_RATE": "0", "DINT_BENCH_HOT_FRAC": "0"},
    {"DINT_USE_FUSED": "1", "DINT_USE_HOTSET": "1", "DINT_MONITOR": "1",
     "DINT_TRACE": "1", "DINT_TRACE_RATE": "0.25",
     "DINT_BENCH_HOT_FRAC": "0.5", "DINT_USE_SCAN": "1"},
    {"DINT_PLAN_OVERRIDE": "1", "DINT_USE_FUSED": "1"},
    {"DINT_PLAN_OVERRIDE": "1", "DINT_USE_HOTSET": "yes",
     "DINT_USE_FUSED": "", "DINT_TRACE_RATE": "bad"},
]


@pytest.mark.parametrize("env", ENVS)
def test_resolve_knobs_and_resolve_for_equal_the_reference(env):
    pk, jk = P.resolve_knobs(env), jplan.resolve_knobs(env)
    assert pk == {k: v for k, v in jk.items() if k in P.KNOBS}
    for doc in (_h100(), _ref(), None):
        for w in P.WORKLOADS:
            if doc is None:
                pk, pm = P.resolve_for(w.name, environ=env, plan={})
                jk, jm = jplan.resolve_for(w.name, environ=env, plan={})
            else:
                pk, pm = P.resolve_for(w.name, environ=env, plan=doc)
                jk, jm = jplan.resolve_for(w.name, environ=env, plan=doc)
            assert pk == {k: v for k, v in jk.items() if k in P.KNOBS}, \
                w.name
            if doc is None or w.name not in doc["workloads"]:
                assert pm == jm == {"source": None, "hash": None,
                                    "overridden": []}
                continue
            assert pm.pop("source") == P.DOCUMENT_SOURCE
            jm.pop("source")
            dropped = sorted(k for k in doc["workloads"][w.name]["pinned"]
                             if k not in P.KNOBS)
            assert pm.pop("dropped", []) == dropped
            assert pm == jm


def test_resolve_for_source_names_the_file_it_read(monkeypatch, tmp_path):
    """The default plan's path when resolve_for reads it, the caller's
    ``source`` beside a document, "<document>" for a bare document, None
    without a readable plan."""
    meta = lambda **kw: P.resolve_for("tatp_serve", environ={}, **kw)[1]
    assert meta()["source"] == str(H100)
    assert meta(plan=_ref())["source"] == "<document>"
    assert meta(plan=_ref(), source="PLAN.json")["source"] == "PLAN.json"
    monkeypatch.setenv("DINT_PLAN_PATH", str(tmp_path / "missing.json"))
    assert meta()["source"] is None


def test_plan_path_is_plan_h100_never_plan_json(monkeypatch, tmp_path):
    assert P.plan_path() == H100
    assert P.plan_path().name != "PLAN.json"
    assert P.load_plan() == _h100()
    other = tmp_path / "p.json"
    monkeypatch.setenv("DINT_PLAN_PATH", str(other))
    assert P.plan_path() == other == cplan.plan_path()


# ------------------------------------------------------ dominance, ranking


def _per_workload(frontier):
    out = {}
    for r in frontier:
        row = {k: v for k, v in r.items()
               if k not in ("rank", "dominated", "dominated_by")}
        out.setdefault(r["workload"], []).append(row)
    return out


@pytest.mark.parametrize("which", ["PLAN.json", "PLAN_H100.json"])
def test_dominance_choice_and_ranking_equal_the_reference(which):
    doc = _ref() if which == "PLAN.json" else _h100()
    for wname, rows in _per_workload(doc["frontier"]).items():
        for a in rows:
            assert P.decision_key(a) == jplan.decision_key(a)
            for b in rows:
                assert P.dominates(a, b) == jplan.dominates(a, b)
        mine, theirs = copy.deepcopy(rows), copy.deepcopy(rows)
        P.rank_rows(mine)
        jplan.rank_rows(theirs)
        assert mine == theirs, wname
        # and both reproduce the pinned ranks
        pinned = {r["target"]: (r["rank"], r["dominated"], r["dominated_by"])
                  for r in doc["frontier"] if r["workload"] == wname}
        assert {r["target"]: (r["rank"], r["dominated"], r["dominated_by"])
                for r in mine} == pinned
    assert P.DECISION_RULE == jplan.DECISION_RULE
    assert P.frontier_hash(doc["frontier"]) == \
        jplan.frontier_hash(doc["frontier"]) == \
        doc["provenance"]["cost_model_hash"]


# --------------------------------------------------------- PLAN_H100.json


def test_plan_h100_pins_the_defaults_and_the_cards_priors():
    doc = _h100()
    calib = CAL.load_calib()
    assert set(doc["workloads"]) == {w.name for w in P.WORKLOADS}
    for w in P.WORKLOADS:
        e = doc["workloads"][w.name]
        assert e["pinned"] == P.pinned_knobs(w)
        assert e["mesh"] == w.mesh
        if w.serve:
            m = e["serve"]["model"]
            assert m["source"] == "calib"
            assert m["hash"] == calib["provenance"]["calib_hash"]
            assert (m["base_us"], m["per_lane_ns"]) == (
                calib["model"]["base_us"], calib["model"]["per_lane_ns"])
        for o in e["overrides"]:
            assert o["reason"] == P.MEASURED_OVERRIDES[o["knob"]]
    assert doc["provenance"]["knobs_hash"] == P.knobs_hash()
    assert doc["provenance"]["calibration_hash"] == P.calibration_hash()
    # every collective wave is priced; a mesh row's link bytes sit on
    # its axes: dcn on the 2-D mesh, ici on the 1-D mesh and on the
    # hierarchical exchange's first stage, none off the mesh
    for r in doc["frontier"]:
        mesh = P.WORKLOADS_BY_NAME[r["workload"]].mesh
        assert r["unpriced_waves"] == []
        two_d = r["target"].startswith("multihost_sb/")
        assert (r["dcn_bytes_per_step"] > 0) == two_d
        assert (r["ici_bytes_per_step"] > 0) == (
            bool(mesh) and "@flat" not in r["target"]
            and "+flat" not in r["target"])
    # the hierarchical exchange wins each 2-D workload on dcn bytes
    for name in ("multihost_4x2", "multihost_3x2", "multihost_serve"):
        e = doc["workloads"][name]
        assert e["predicted"]["hierarchical"] is True and not e["overrides"]


def test_plan_from_recorded_prices_reproduces_plan_h100(monkeypatch,
                                                      tmp_path):
    """`build_plan` over the pinned rows' prices (no tracing) reproduces
    the committed file byte for byte: its choices, overrides, serve priors
    and provenance all follow from the registry, the calibration and the
    frontier."""
    monkeypatch.setattr(P, "_price_target", _recorded_pricer(_h100()))
    out = tmp_path / "plan.json"
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert dintplan.main(["plan", "-o", str(out), "--json"]) == 0
    rec = json.loads(buf.getvalue())
    assert rec["n_frontier"] == 23 and rec["out"] == str(out)
    assert out.read_text() == H100.read_text()


def test_the_committed_plan_is_clean_in_static_mode():
    assert pc.check_plan(_h100(), ANCHOR, static=True, environ={}) == []


def test_full_mode_on_single_device_rows_and_a_nudged_price():
    """Full mode with the real CPU derivation, on the plan's single-device
    TATP workloads (five traces): clean as pinned; a nudged price is
    priced-drift naming its row."""
    doc = _h100()
    keep = ("tatp_uniform", "tatp_serve")
    doc["workloads"] = {k: v for k, v in doc["workloads"].items()
                        if k in keep}
    doc["frontier"] = [r for r in doc["frontier"] if r["workload"] in keep]
    doc["provenance"]["cost_model_hash"] = P.frontier_hash(doc["frontier"])
    assert pc.check_plan(doc, ANCHOR, static=False, environ={}) == []
    row = next(r for r in doc["frontier"]
               if r["target"] == "tatp_dense/block@hot")
    row["bytes_per_step"] += 64
    doc["provenance"]["cost_model_hash"] = P.frontier_hash(doc["frontier"])
    fs = pc.check_plan(doc, ANCHOR, static=False, environ={})
    assert [(f.code, f.site) for f in fs] == [
        ("priced-drift", "tatp_dense/block@hot")]


# ---------------------------------------------------------- the eleven codes


def _mutate(code, tmp_path):
    """(findings, environ) of one mutated copy of PLAN_H100.json."""
    doc = _h100()
    env = {}
    if code == "missing-plan":
        return pc.load_plan_findings(ANCHOR, tmp_path / "none.json")[1]
    if code == "malformed-plan":
        del doc["frontier"]
    elif code == "stale-provenance":
        doc["provenance"]["knobs_hash"] = "0" * 16
    elif code == "unknown-workload":
        doc["workloads"]["bogus"] = copy.deepcopy(
            doc["workloads"]["tatp_serve"])
    elif code == "unregistered-target":
        doc["workloads"]["tatp_uniform"]["target"] = \
            "tatp_dense/block@pallas"
    elif code == "unregistered-knob":
        doc["workloads"]["tatp_uniform"]["pinned"]["use_pallas"] = False
    elif code == "flipped-ordering":
        rows = [r for r in doc["frontier"] if r["workload"] == "tatp_uniform"]
        a = next(r for r in rows if r["rank"] == 0)
        b = next(r for r in rows if r["rank"] == 1)
        a["rank"], b["rank"] = 1, 0
    elif code == "dominated-pin":
        doc["workloads"]["tatp_uniform"]["target"] = "tatp_dense/block@hot"
    elif code == "unjustified-pin":
        doc["workloads"]["tatp_uniform"]["overrides"] = []
    elif code == "priced-drift":
        pricer = _recorded_pricer(doc)
        row = next(r for r in doc["frontier"]
                   if r["target"] == "tatp_dense/serve")
        row["footprint_bytes"] += 4
        return pc.check_plan(doc, ANCHOR, static=False, environ={},
                             pricer=pricer)
    elif code == "env-override":
        env = {"DINT_USE_FUSED": "1"}
    return pc.check_plan(doc, ANCHOR, static=True, environ=env)


CODES = ("missing-plan", "malformed-plan", "stale-provenance",
         "unknown-workload", "unregistered-target", "unregistered-knob",
         "flipped-ordering", "dominated-pin", "unjustified-pin",
         "priced-drift", "env-override")


@pytest.mark.parametrize("code", CODES)
def test_each_code_fires_and_is_allowlist_silenceable(code, tmp_path):
    fs = _mutate(code, tmp_path)
    hits = [f for f in fs if f.code == code]
    assert hits and all(f.pass_name == "plan_check" and f.target == ANCHOR
                        and f.severity == "error" for f in hits), fs
    assert analysis.has_errors(hits)
    entry = {"pass": "plan_check", "code": code, "target": ANCHOR,
             "reason": "test"}
    out = al.apply(hits, [entry], check_unused=False)
    assert all(f.suppressed for f in out) and not analysis.has_errors(out)


def _pure_mutations():
    """Pure-document mutations of PLAN.json and the env each is read
    under (the four codes both planners judge from the document alone)."""
    base = _ref()
    out = []
    doc = copy.deepcopy(base)
    rows = [r for r in doc["frontier"] if r["workload"] == "tatp_uniform"]
    a = next(r for r in rows if r["rank"] == 0)
    b = next(r for r in rows if r["rank"] == 1)
    a["rank"], b["rank"] = 1, 0
    out.append(("flipped-ordering", doc, {}))
    doc = copy.deepcopy(base)
    dom = next(r for r in doc["frontier"] if r["dominated"])
    doc["workloads"][dom["workload"]]["target"] = dom["target"]
    out.append(("dominated-pin", doc, {}))
    doc = copy.deepcopy(base)
    for e in doc["workloads"].values():
        e["overrides"] = []
    out.append(("unjustified-pin", doc, {}))
    out.append(("env-override", copy.deepcopy(base),
                {"DINT_USE_FUSED": "1", "DINT_USE_HOTSET": "1"}))
    return out


SHARED = ("flipped-ordering", "dominated-pin", "unjustified-pin",
          "env-override")


@pytest.mark.parametrize("i", range(4))
def test_pure_document_codes_equal_the_reference(i):
    code, doc, env = _pure_mutations()[i]
    mine = {(f.code, f.site) for f in pc.check_plan(
        doc, ANCHOR, static=True, environ=env) if f.code in SHARED}
    theirs = {(f.code, f.site) for f in jpc.check_plan(
        doc, ANCHOR, static=True, environ=env) if f.code in SHARED}
    assert mine == theirs and any(c == code for c, _ in mine)


def test_the_anchor_lands_the_findings_once(monkeypatch, tmp_path):
    monkeypatch.setenv("DINT_PLAN_PATH", str(tmp_path / "none.json"))
    fs = analysis.run(targets=[ANCHOR, "smallbank_dense/serve"],
                      passes=["plan_check"])
    assert [(f.code, f.target) for f in fs] == [("missing-plan", ANCHOR)]
    monkeypatch.setenv("DINT_PLAN_ANCHOR", "smallbank_dense/serve")
    fs = analysis.run(targets=[ANCHOR, "smallbank_dense/serve"],
                      passes=["plan_check"])
    assert [(f.code, f.target) for f in fs] == [
        ("missing-plan", "smallbank_dense/serve")]


# ------------------------------------------------------------------ the CLI


def _cli(argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = dintplan.main(argv)
    return rc, buf.getvalue()


def test_cli_check_static_json_sarif_and_describe(tmp_path):
    rc, out = _cli(["check", "--static", "--json"])
    rec = json.loads(out.strip().splitlines()[-1])
    assert rc == 0 and rec["ok"] and rec["n_findings"] == 0
    assert rec["plan"] == str(H100) and rec["static"] is True
    assert os.environ["DINT_PLAN_STATIC"] == "1"
    sarif = tmp_path / "p.sarif"
    rc, _ = _cli(["check", "--static", "--sarif", str(sarif)])
    doc = json.loads(sarif.read_text())
    assert rc == 0 and doc["version"] == "2.1.0"
    assert doc["runs"][0]["results"] == []
    rc, out = _cli(["describe", "--json"])
    d = json.loads(out)
    assert rc == 0 and set(d["knobs"]) == set(P.KNOBS)
    assert d["workloads"]["multihost_4x2"]["mesh"] == "4x2"
    assert d["plan_path"] == str(H100)
    rc, out = _cli(["describe"])
    assert rc == 0 and "use_pallas" in out and "not registered" in out


def test_cli_exit_codes_on_a_bad_plan(tmp_path):
    bad = tmp_path / "bad.json"
    doc = _h100()
    doc["workloads"]["bogus"] = copy.deepcopy(doc["workloads"]["tatp_serve"])
    bad.write_text(json.dumps(doc))
    rc, out = _cli(["check", "--static", "--plan", str(bad)])
    assert rc == 1 and "unknown-workload" in out and "FAIL" in out
    bad.write_text("{not json")
    rc, out = _cli(["check", "--static", "--plan", str(bad), "--json"])
    rec = json.loads(out.strip().splitlines()[-1])
    assert rc == 1 and [f["code"] for f in rec["findings"]] == [
        "malformed-plan"]
    rc, out = _cli(["check", "--static", "--plan", str(tmp_path / "no")])
    assert rc == 1 and "missing-plan" in out
    with pytest.raises(SystemExit) as e:
        dintplan.main(["check", "--check"])
    assert e.value.code == 2
    with pytest.raises(SystemExit) as e:
        dintplan.main(["frobnicate"])
    assert e.value.code == 2
    # an env flag that contradicts a pin fails the gate unless overridden
    os.environ.pop("DINT_PLAN_PATH")
    os.environ["DINT_USE_FUSED"] = "1"
    assert _cli(["check", "--static"])[0] == 1
    os.environ["DINT_PLAN_OVERRIDE"] = "1"
    assert _cli(["check", "--static"])[0] == 0


def test_cli_prune_check_finds_no_stale_plan_check_entry():
    rc, out = _cli(["check", "--static", "--prune-allowlist", "--check"])
    assert rc == 0 and "plan_check" in out and "nothing to prune" in out


@pytest.mark.slow
def test_cli_full_check_on_the_committed_plan():
    """The full gate: every frontier row re-derived from its CPU trace
    (23 targets, past a minute on the CPU)."""
    rc, out = _cli(["check", "--json"])
    rec = json.loads(out.strip().splitlines()[-1])
    assert rc == 0 and rec["ok"] and rec["static"] is False
