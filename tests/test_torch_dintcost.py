"""The port's dintcost (dint_tpu_torch/analysis/cost.py and
passes/cost_budget.py): the static cost model and its CPU gate.

Liveness: mutated mini steps, torch twins of tests/test_dintcost.py's
fixtures (an extra scatter dispatch, a doubled gather, a table cloned
where it should be written in place, a fused twin that loses) prove each
cost_budget check fires, naming the offending wave or target, and is
silenced by a scoped allowlist entry. The byte rule of each of the nine
``dint::`` kernels is held to its formula on small tensors; the model
does not depend on the draws (the nonzero rule) or on the block's length
(per-step division); the CLI's report/check/diff/describe, an unknown
target and the gate-scoped prune dry run; and the pure parts (the budget
formula, reconciliation of a hand-built model, the artifact diff) equal
the reference's on the same inputs. The real targets' matrix runs in
tests/test_torch_dintlint_matrix*.py.
"""
import contextlib
import copy
import json
import os

import pytest
import torch

from dint_tpu_torch import analysis, dintcost
from dint_tpu_torch.analysis import core, cost
from dint_tpu_torch.analysis import targets as T
from dint_tpu_torch.monitor import waves
from dint_tpu_torch.ops import library
from dint_tpu_torch.ops import row_kernels as rk
from dint_tpu_torch.ops import scan_kernels as sk

pytestmark = pytest.mark.cost

I32 = torch.int32

# ------------------------------------------------- mini-step fixtures
#
# One table, one wave-scoped gather whose traffic equals the registered
# magic_gather formula EXACTLY at this geometry (so the clean fixture
# reconciles at ratio 1.0), one unattributed install scatter written in
# place. Budgets are calibrated from the clean fixture's own derived
# model, then each mutation regresses exactly one number.

WAVE = "dint.tatp_dense.magic_gather"
GEOM = dict(w=8, k=4, vw=2)
DECL = waves.wave_bytes(WAVE, **GEOM)          # = w*k*4 = 128 B
NE = DECL // 4                                  # gather lanes (int32)
N = 512


def _mini_step(wide=False, extra=False, clone=False):
    ne = NE * (2 if wide else 1)

    def fn(tab, idx, vals):
        with waves.scope("tatp_dense", "magic_gather"):
            got = tab[idx.long()]               # ne rows * 4 B
        s = got.sum(dtype=I32)
        dst = tab.clone() if clone else tab     # the regression: a copy
        dst[idx[:NE].long()] = vals + s
        if extra:                               # an unfused second write
            dst[idx[:NE].long()] = vals ^ s
        return [dst]

    def args():
        g = torch.Generator().manual_seed(1)
        return (torch.zeros(N, dtype=I32),
                torch.randperm(N, generator=g)[:ne].to(I32),
                torch.randint(0, 9, (NE,), dtype=I32, generator=g))
    return fn, args


@contextlib.contextmanager
def _registered(name, fn, args, meta):
    """Temporarily add a fixture target (and its cost meta) to the
    registry, so the real analysis.run plumbing (pass, dedup, allowlist)
    applies."""
    T.TARGETS[name] = lambda g=None: core.trace_target(name, fn, args())
    T.TARGET_DOCS[name] = "dintcost test fixture"
    T.TARGET_PROTOCOL[name] = ()
    if meta is not None:
        T.TARGET_COST[name] = meta
    try:
        yield
    finally:
        for d in (T.TARGETS, T.TARGET_DOCS, T.TARGET_PROTOCOL,
                  T.TARGET_COST):
            d.pop(name, None)
        T.TRACE_CACHE._traces.pop(name, None)


def _meta(budget):
    return {"steps": 1.0, "geom": dict(GEOM), "wave_expect": {},
            "budget": budget}


def _derive(fn, args, steps=1.0):
    return cost.derive(core.trace_target("fixture_cost/_probe", fn, args()),
                       steps=steps, geom=GEOM)


def _clean_numbers():
    """The clean fixture's numbers calibrate every mutated fixture's
    budget."""
    m = _derive(*_mini_step())
    return m.dispatches_per_step, m.bytes_per_step, m.footprint_bytes


def _run(name, allowlist_entries=None):
    return analysis.run(targets=[name], passes=["cost_budget"],
                        allowlist_entries=allowlist_entries)


def _err_codes(findings):
    return {f.code for f in findings
            if f.severity == "error" and not f.suppressed}


def test_clean_mini_engine_passes_gate():
    disp, nbytes, fp = _clean_numbers()
    assert (disp, nbytes) == (2.0, 2.0 * DECL)
    fn, args = _mini_step()
    name = "fixture_cost/clean"
    with _registered(name, fn, args, _meta(
            {"dispatches": disp, "bytes": nbytes, "footprint": fp})):
        fs = _run(name)
        assert not _err_codes(fs), [str(f) for f in fs]
        model = cost.model_for(name)
        checks = cost.reconcile_for(name, model)
        assert [c.wave for c in checks] == [WAVE]
        assert checks[0].ratio == pytest.approx(1.0)
        # the table is written in place: no output adds to the footprint
        assert model.footprint_bytes == model.input_bytes
        assert model.donated_bytes == N * 4


def test_extra_scatter_fires_dispatch_budget_and_is_silenceable():
    disp, _, fp = _clean_numbers()
    fn, args = _mini_step(extra=True)
    name = "fixture_cost/extra-dispatch"
    meta = _meta({"dispatches": disp, "bytes": None, "footprint": fp})
    fs = over_budget_findings()
    assert _err_codes(fs) == {"over-dispatch-budget"}, [str(f) for f in fs]
    hit = [f for f in fs if f.code == "over-dispatch-budget"]
    assert hit[0].target == name           # the offender is named
    with _registered(name, fn, args, meta):
        fs2 = _run(name, allowlist_entries=[
            {"pass": "cost_budget", "code": "over-dispatch-budget",
             "target": name, "reason": "fixture: regression on purpose"}])
        assert not analysis.has_errors(fs2)
        assert any(f.suppressed for f in fs2)


def over_budget_findings():
    """An extra unfused scatter over the clean fixture's budget: the
    canonical broken cost fixture (also test_torch_dintlint's every-pass
    liveness)."""
    disp, _, fp = _clean_numbers()
    fn, args = _mini_step(extra=True)
    name = "fixture_cost/extra-dispatch"
    with _registered(name, fn, args, _meta(
            {"dispatches": disp, "bytes": None, "footprint": fp})):
        return _run(name)


def test_doubled_gather_fires_formula_and_bytes_budget():
    disp, nbytes, _ = _clean_numbers()
    fn, args = _mini_step(wide=True)
    name = "fixture_cost/wide-gather"
    # footprint unbudgeted: the wider idx input grows it too, and this
    # test isolates the byte checks
    meta = _meta({"dispatches": disp, "bytes": nbytes, "footprint": None})
    with _registered(name, fn, args, meta):
        fs = _run(name)
        assert _err_codes(fs) == {"formula-mismatch", "over-bytes-budget"}
        mism = [f for f in fs if f.code == "formula-mismatch"]
        assert mism[0].site == WAVE        # the offending WAVE is named
        assert "2.00" in mism[0].message   # derived = 2x declared
        fs2 = _run(name, allowlist_entries=[
            {"pass": "cost_budget", "code": "formula-mismatch",
             "target": name, "reason": "fixture: doubled on purpose"},
            {"pass": "cost_budget", "code": "over-bytes-budget",
             "target": name, "reason": "fixture: doubled on purpose"}])
        assert not analysis.has_errors(fs2)


def test_cloned_table_fires_footprint_budget():
    disp, nbytes, fp = _clean_numbers()
    fn, args = _mini_step(clone=True)
    name = "fixture_cost/clone"
    meta = _meta({"dispatches": disp, "bytes": nbytes, "footprint": fp})
    with _registered(name, fn, args, meta):
        fs = _run(name)
        assert _err_codes(fs) == {"over-footprint-budget"}, \
            [str(f) for f in fs]
        # the copy is a fresh table the step keeps: the footprint grows by
        # the table's bytes
        model = cost.model_for(name)
        assert model.footprint_bytes == fp + N * 4
        assert model.donated_bytes == 0
        fs2 = _run(name, allowlist_entries=[
            {"pass": "cost_budget", "code": "over-footprint-budget",
             "target": name, "reason": "fixture: a copy on purpose"}])
        assert not analysis.has_errors(fs2)


def test_fused_dominance_fires_when_fused_loses():
    _, _, fp = _clean_numbers()
    twin_fn, twin_args = _mini_step()               # 2 dispatches
    fused_fn, fused_args = _mini_step(extra=True)   # 3 dispatches: WORSE
    twin, fused = "fixture_cost/mini", "fixture_cost/mini@fused"
    fused_model = _derive(fused_fn, fused_args)
    meta = _meta({"dispatches": fused_model.dispatches_per_step,
                  "bytes": None, "footprint": fp})
    with _registered(twin, twin_fn, twin_args, None), \
            _registered(fused, fused_fn, fused_args, meta):
        fs = _run(fused)
        assert {"fused-dispatch-dominance",
                "fused-bytes-dominance"} == _err_codes(fs), \
            [str(f) for f in fs]
        dom = [f for f in fs if f.code == "fused-dispatch-dominance"]
        assert dom[0].site == twin         # the twin is named
        fs2 = _run(fused, allowlist_entries=[
            {"pass": "cost_budget", "code": "fused-dispatch-dominance",
             "target": fused, "reason": "fixture: regression on purpose"},
            {"pass": "cost_budget", "code": "fused-bytes-dominance",
             "target": fused, "reason": "fixture: regression on purpose"}])
        assert not analysis.has_errors(fs2)


def test_fused_dominance_clean_when_fused_wins():
    _, nbytes, fp = _clean_numbers()
    fused_fn, fused_args = _mini_step()             # 2 dispatches: wins
    twin_fn, twin_args = _mini_step(extra=True)     # 3 dispatches
    twin, fused = "fixture_cost/mini2", "fixture_cost/mini2@fused"
    meta = _meta({"dispatches": 2, "bytes": nbytes, "footprint": fp})
    with _registered(twin, twin_fn, twin_args, None), \
            _registered(fused, fused_fn, fused_args, meta):
        assert not _err_codes(_run(fused))


def test_unbudgeted_target_warns():
    fn, args = _mini_step()
    name = "fixture_cost/nobudget"
    with _registered(name, fn, args, None):
        fs = _run(name)
        assert {f.code for f in fs} == {"no-budget"}
        assert fs[0].severity == "warning"


# --------------------------------------------- the kernels' byte rules


def _kernel_access(fn, args):
    m = cost.derive(core.trace_target("fixture_cost/_kernel", fn, args))
    ks = [a for a in m.accesses if a.kind == "kernel"]
    assert len(ks) == 1 and m.dispatches_per_step == 1.0, m.accesses
    return ks[0]


def test_each_kernel_is_priced_by_its_schema_rule():
    g = torch.Generator().manual_seed(3)
    tab = torch.randint(0, 1 << 20, (400,), dtype=I32, generator=g)
    mir = tab[:40].clone()
    idx = torch.randint(0, 100, (30,), dtype=I32, generator=g)
    midx = torch.where(idx < 10, idx, -1).to(I32)
    rows = torch.randint(0, 50, (24,), dtype=I32, generator=g)
    act = torch.rand(24, generator=g) < 0.8
    meta = torch.randint(0, 99, (51,), dtype=I32, generator=g)
    vv1 = torch.randint(0, 99, (10,), dtype=I32, generator=g)
    sidx = torch.randperm(100, generator=g)[:30].to(I32)
    sidx[::3] = -1
    hidx = torch.where(sidx < 10, sidx, -1).to(I32)
    vals = torch.randint(0, 9, (120,), dtype=I32, generator=g)
    run = [torch.arange(64, dtype=I32) for _ in range(3)]
    off = torch.tensor([0, 5, 60], dtype=I32)
    cases = {
        # the rows a gather returns
        "gather_rows": (lambda t, i: list(rk.gather_rows((t, t), (i, i),
                                                         (4, 1))),
                        (tab, idx), 30 * 5 * 4),
        "gather_streams": (lambda t, i: list(rk.gather_streams(
            [t, t], [i, i], [2, 1])), (tab, idx), 30 * 3 * 4),
        "gather_rows_hot": (lambda t, m, i, h: list(rk.gather_rows_hot(
            (t,), (m,), (i,), (h,), (4,))), (tab, mir, idx, midx),
            30 * 4 * 4),
        # the 3-pass RMW over m lanes
        "lock_arbitrate": (lambda a, r, s: [rk.lock_arbitrate(
            a, r, s, 5, 18)[1]], (torch.zeros(51, dtype=I32), rows, act),
            4 * 3 * 24),
        # + the validate read (v) and the fresh meta read (r)
        "lock_validate": (lambda a, mt, r, s, v1: list(rk.lock_validate(
            a, mt, r[:10], v1, r[:7], r, s, 6, 18))[1:],
            (torch.zeros(51, dtype=I32), meta, rows, act, vv1),
            4 * (3 * 24 + 10 + 7)),
        # every vals stream, masked lanes counted
        "scatter_streams": (lambda t, i, v: rk.scatter_streams(
            [t], [i], [v], [4]) or [t], (tab.clone(), sidx, vals),
            120 * 4),
        # the table pass and the mirror pass
        "scatter_rows_hot": (lambda t, m, i, h, v: rk.scatter_rows_hot(
            (t,), (m,), (i,), (h,), (i >= 0,), (v,), (4,)) or [t, m],
            (tab.clone(), mir.clone(), sidx, hidx, vals), 2 * 120 * 4),
        # its four outputs: K windows of lg rows of hi, lo, ver, val
        "scan_rows": (lambda a, b, c, v, o: list(sk.scan_rows(
            a, b, c, v, o, 4, 2)), (*run, torch.arange(128, dtype=I32),
            off), 3 * 4 * (3 + 2) * 4),
        # the value it stores
        "scalar_scatter": (lambda t, i, v: [rk.scalar_scatter(t, i, v)],
                           (tab, torch.tensor([3, 7, 3, 0], dtype=I32),
                            torch.tensor([1, 2, 3, 4], dtype=I32)), 4 * 4),
    }
    assert sorted(cases) == sorted(library.SCHEMAS)
    for name, (fn, args, want) in cases.items():
        a = _kernel_access(fn, args)
        assert a.prim == f"dint::{name}", (name, a.prim)
        assert a.bytes == want, (name, a.bytes, want)


# ------------------------------------------- draws and block length


def _model(name, seed=0, cpb=3):
    """A fresh trace of ``name`` at the lint geometry with ``cpb`` steps a
    block and the generator seeded ``seed``, derived."""
    import dataclasses
    orig = T._gen

    def gen(g):
        out = torch.Generator(device=g.device)
        out.manual_seed(seed)
        return out
    T._gen = gen
    try:
        tr = T.build(name, dataclasses.replace(T.LINT, cpb=cpb))
    finally:
        T._gen = orig
    return cost.derive(tr, steps=float(cpb),
                       geom=T.TARGET_COST[name]["geom"])


@pytest.mark.parametrize("name", ["tatp_dense/block",
                                  "smallbank_dense/block@hot",
                                  "dense_sharded_sb/block"])
def test_the_nonzero_rule_makes_the_model_independent_of_the_draws(name):
    a, b = _model(name, seed=0), _model(name, seed=11)
    assert a.to_dict() == b.to_dict()
    # behind the filters every install and append is priced at its mask's
    # lanes, never at the lanes the draws kept
    behind = [x for x in a.accesses if x.lanes]
    assert behind and all(x.lanes % T.LINT.w == 0 for x in behind)


@pytest.mark.parametrize("name", ["tatp_dense/block",
                                  "smallbank_dense/block@fused"])
def test_per_step_division(name):
    a, b = _model(name, cpb=3), _model(name, cpb=4)
    assert a.wave_bytes_per_step() == b.wave_bytes_per_step()
    assert a.wave_dispatches_per_step() == b.wave_dispatches_per_step()
    assert a.bytes_per_step == b.bytes_per_step


# --------------------------------------------------------------- the CLI


def test_cli_report_check_and_diff(tmp_path, capsys):
    """One CLI round trip: report -o artifact + --json schema, check exit
    0, and diff catching an injected regression by name."""
    main = dintcost.main
    art = tmp_path / "cost.json"
    assert main(["report", "tatp_dense/block", "tatp_dense/block@fused",
                 "--json", "-o", str(art)]) == 0
    payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert payload["metric"] == "dintcost"
    assert payload["schema"] == dintcost.JSON_SCHEMA == 3
    e = payload["targets"]["tatp_dense/block@fused"]
    for k in ("bytes_per_step", "dispatches_per_step", "footprint_bytes",
              "waves", "reconcile", "budget", "ledger_bytes",
              "unpriced_waves"):
        assert k in e
    assert e["fused_twin"] == "tatp_dense/block"
    assert all(c["ok"] for c in e["reconcile"])
    # the text report
    assert main(["report", "tatp_dense/block"]) == 0
    assert "dint.tatp_dense.install" in capsys.readouterr().out

    assert main(["check", "--target", "tatp_dense/block@fused",
                 "--json"]) == 0
    out = capsys.readouterr().out
    assert json.loads(out.strip().splitlines()[-1])["ok"] is True

    mutated = json.loads(art.read_text())
    t = mutated["targets"]["tatp_dense/block"]
    t["dispatches_per_step"] += 1
    wave = "dint.tatp_dense.install"
    t["waves"][wave]["bytes_per_step"] *= 2
    mut = tmp_path / "mutated.json"
    mut.write_text(json.dumps(mutated))
    assert main(["diff", str(art), str(mut), "--json"]) == 1
    d = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    kinds = {(r["kind"], r.get("wave")) for r in d["regressions"]}
    assert ("dispatches", None) in kinds
    assert ("wave-bytes", wave) in kinds
    # and A vs A is clean
    assert main(["diff", str(art), str(art)]) == 0
    capsys.readouterr()
    # an artifact that is none exits 2 with a message, no traceback
    bad = tmp_path / "bad.json"
    bad.write_text("{}")
    assert main(["diff", str(art), str(bad)]) == 2
    assert "not a dintcost report" in capsys.readouterr().err


def test_cli_describe(capsys):
    assert dintcost.main(["describe", "--json"]) == 0
    d = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert d["default_tol"] == cost.DEFAULT_TOL
    assert sorted(d["targets"]) == sorted(T.TARGETS)
    assert dintcost.main(["describe"]) == 0
    assert "budget ledger" in capsys.readouterr().out


def test_cli_unknown_target_exits_2(capsys):
    with pytest.raises(SystemExit) as exc:
        dintcost.main(["report", "nope/bad"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "unknown" in err and "tatp_dense/block" in err


def test_prune_check_is_a_gate_scoped_dry_run(tmp_path, capsys,
                                              monkeypatch):
    """The stale-entry contract, scoped to cost_budget: the dry run fails
    without rewriting; the real prune drops ONLY the stale cost_budget
    entry, never another gate's entries. The matrix is cut to two
    targets here (the full one is the CLI's, in the slow matrix test)."""
    names = ["tatp_dense/block", "tatp_dense/block@fused"]
    real_run = analysis.run

    def two_targets(targets=None, **kw):
        return real_run(targets=targets or names, **kw)
    monkeypatch.setattr(analysis, "run", two_targets)
    entries = json.loads(open(analysis.DEFAULT_ALLOWLIST).read())
    n_repo = len(entries)
    assert not [e for e in entries if e["pass"] == "cost_budget"]
    entries.append({"pass": "cost_budget", "code": "no-such-code",
                    "reason": "stale on purpose"})
    path = tmp_path / "allow.json"
    path.write_text(json.dumps(entries))
    before = path.read_text()
    main = dintcost.main
    assert main(["check", "--prune-allowlist", "--check",
                 "--allowlist", str(path)]) == 1
    assert path.read_text() == before
    out = capsys.readouterr().out
    assert "NOT rewritten" in out and "cost_budget/no-such-code" in out
    assert main(["check", "--prune-allowlist",
                 "--allowlist", str(path)]) == 0
    capsys.readouterr()
    pruned = json.loads(path.read_text())
    assert len(pruned) == n_repo
    assert not any(e["code"] == "no-such-code" for e in pruned)
    # another gate's entries survive (their findings were not traced)
    assert any(e["pass"] == "durability" for e in pruned)
    assert any(e["pass"] == "scatter_race" for e in pruned)
    with pytest.raises(SystemExit):      # --check without the prune
        main(["check", "--all", "--check"])
    with pytest.raises(SystemExit):      # the prune refuses a subset
        main(["check", "--prune-allowlist", "--target", names[0]])


# ------------------------------------- the pure parts vs the reference


_FORMULAS = [("1.25*ledger", dict(w=16, k=4, vw=4), 4000.0),
             ("2*w*k*4 + ledger", dict(w=16, k=4), 10.0),
             (256000, {}, 1.0), (None, {}, 3.0), ("nope(", {}, 1.0),
             ("d*(8*d*(2*((w*l+d-1)//d)) + 12)", dict(w=16, l=3, d=4),
              0.0)]


def test_eval_budget_bytes_equals_the_reference():
    from dint_tpu.analysis import cost as ref
    for formula, geom, ledger in _FORMULAS:
        assert cost.eval_budget_bytes(formula, geom, ledger) == \
            ref.eval_budget_bytes(formula, geom, ledger), formula


def _hand_model(mod):
    """The same hand-built model in either package's classes."""
    accs = [("dint.tatp_dense.lock", 384.0), ("dint.tatp_dense.meta_gather",
                                              700.0),
            ("dint.tatp_dense.lock_validate", 896.0),
            ("dint.tatp_dense.install", 2000.0),
            ("dint.tatp_dense.gen", 50.0), (None, 12.0),
            ("dint.smallbank_dense.read", 192.0)]
    return mod.CostModel("hand", 2.0, dict(w=16, k=4, vw=4, l=3),
                         [mod.Access("gather", "g", w, b, 1.0)
                          for w, b in accs], 100, 100, 0)


def test_reconcile_equals_the_reference_on_a_hand_built_model():
    from dint_tpu.analysis import cost as ref
    expect = {"dint.tatp_dense.install": 2.0,
              "dint.smallbank_dense.read": "3*w*l*4"}
    for kw in ({}, dict(wave_expect=expect),
               dict(wave_expect=expect,
                    tol_overrides={"dint.tatp_dense.install": 0.5})):
        mine = cost.reconcile(_hand_model(cost), **kw)
        theirs = ref.reconcile(_hand_model(ref), **kw)
        assert [dict(vars(c)) for c in mine] == \
            [dict(vars(c)) for c in theirs]
        assert [c.ok for c in mine] == [c.ok for c in theirs]
    assert cost.ledger_bytes(_hand_model(cost), expect) == \
        ref.ledger_bytes(_hand_model(ref), expect)
    for name in ("tatp_dense/block@fused", "x@fused+hot", "x@fused+mon",
                 "tatp_dense/block"):
        assert cost.fused_twin(name) == ref.fused_twin(name)


def test_diff_equals_the_reference_cli(tmp_path, capsys):
    """The artifact diff against tools/dintcost.py's on the same two
    artifacts (run in-process through its main)."""
    import importlib.util
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "_ref_dintcost", os.path.join(repo, "tools", "dintcost.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    a = {"targets": {"t": {"dispatches_per_step": 3, "bytes_per_step": 10,
                           "footprint_bytes": 5,
                           "waves": {"w1": {"bytes_per_step": 10.0}}},
                     "u": {"dispatches_per_step": 1, "bytes_per_step": 1,
                           "footprint_bytes": 1, "waves": {}}}}
    b = copy.deepcopy(a)
    b["targets"]["t"]["dispatches_per_step"] = 4
    b["targets"]["t"]["waves"]["w1"]["bytes_per_step"] = 11.5
    b["targets"]["t"]["waves"]["w2"] = {"bytes_per_step": 1.0}
    b["targets"]["u"]["footprint_bytes"] = 2
    pa, pb = tmp_path / "a.json", tmp_path / "b.json"
    pa.write_text(json.dumps(a))
    pb.write_text(json.dumps(b))
    for pct in ("10", "20"):
        args = ["diff", str(pa), str(pb), "--bytes-pct", pct, "--json"]
        rc_ref = ref.main(args)
        want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        rc = dintcost.main(args)
        got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rc == rc_ref and got == want
