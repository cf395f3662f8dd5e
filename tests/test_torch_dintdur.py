"""The port's dintdur (dint_tpu_torch/analysis/passes/durability.py and the
durability facts of analysis/dataflow.py): every check proven live on a
deliberately broken mini engine, silent on the safe idiom and on the
real targets, and silenced by a scoped allowlist entry; the recovery
targets registered and traced; the CLI's JSON, SARIF, prune and exit
codes; and `in_doubt_violations` equal to the reference's on the same
sources.

The broken fixtures are the durability bug classes the pass exists for,
torch twins of tests/test_dintdur.py's:
  * an engine that installs certified writes without a log append
    (wal-order),
  * a ring whose appends in one trace exceed its slots (unbounded-ring),
    and appends with no watermark advance (no-ring-truncation),
  * a replay that skips a header column or reads past the populated
    entry prefix, and a twin that rebuilds another table
    (replay-coverage),
  * a coordinator whose TIMEOUT handling is cut out (in-doubt-totality).
The appends go through the real tables/log.py, so the LOG_SLOT and
TRUNCATED facts seed at its slot math and watermark clamp, as in the
engines.
"""
import json
import os

import pytest
import torch

from dint_tpu_torch import analysis, dintdur
from dint_tpu_torch.analysis import allowlist as al
from dint_tpu_torch.analysis import core
from dint_tpu_torch.analysis import dataflow as df
from dint_tpu_torch.analysis import targets as T
from dint_tpu_torch.analysis.passes import durability as dur
from dint_tpu_torch.tables import log as tlog

pytestmark = pytest.mark.lint

I32 = torch.int32
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

W, N = 4, 32            # mini-engine geometry: 4 lanes, 32 rows
NAME = "fixture/durability"


def run_pass(fn, args, protocol=("certified", "durable")):
    tr = core.trace_target(NAME, fn, args, protocol=protocol)
    return analysis.PASSES["durability"](tr)


def codes(findings, severity=None):
    return {f.code for f in findings
            if severity is None or f.severity == severity}


# ------------------------------------------------- mini durable engine
#
# A miniature validate-then-install engine over two unrolled steps whose
# appends go through the REAL tables/log.py. Variants sever one
# durability edge each.


def _mini_durable(variant, lanes=2, capacity=8, steps=2):
    vw = 1

    def fn(tab, meta, entries, head, rows, snap, vals):
        ring = tlog.RepLog(entries=entries, head=head, lanes=lanes,
                           replicas=3)
        zero = torch.zeros(W, dtype=I32)
        counted = []
        for _ in range(steps):
            cur = meta[rows.long()]
            mask = cur == snap                      # VALIDATED seed
            if variant != "nolog":
                tlog.append_rep(ring, mask, zero, zero, zero, rows, cur,
                                vals)
            keep = torch.nonzero(mask).squeeze(1)
            r = rows[keep].long()
            tab[r] = vals[keep, 0]
            meta[r] = cur[keep] + 1
            snap = meta[rows.long()]
            counted.append(mask.sum())
        out = [tab, meta, ring.entries, ring.head]
        if variant == "ok":
            # the checkpoint the real engines still lack (the allowlisted
            # ROADMAP gap): a watermark advance is what no-ring-truncation
            # wants to reach
            consumed = torch.stack(counted).sum().expand(lanes).to(I32)
            out.append(tlog.advance_watermark(
                ring, torch.zeros(lanes, dtype=I32), consumed))
        return out

    g = torch.Generator().manual_seed(5)
    args = (torch.zeros(N + 1, dtype=I32), torch.zeros(N + 1, dtype=I32),
            torch.zeros((lanes * capacity, 3 * (tlog.HDR_WORDS + vw)),
                        dtype=I32),
            torch.zeros(lanes, dtype=I32),
            torch.randperm(N, generator=g)[:W].to(I32),
            torch.zeros(W, dtype=I32), torch.ones((W, vw), dtype=I32))
    return fn, args


def broken_wal_order_findings():
    """Certified installs, zero log appends."""
    return run_pass(*_mini_durable("nolog"))


def test_wal_order_fires_on_dropped_append():
    fs = broken_wal_order_findings()
    assert "wal-order" in codes(fs, "error"), [str(f) for f in fs]
    assert "VALIDATED" in [f for f in fs if f.code == "wal-order"][0].message
    # no appends at all: the ring checks have nothing to bound
    assert "no-ring-truncation" not in codes(fs)
    assert "unbounded-ring" not in codes(fs)


def test_ring_truncation_fires_without_watermark_and_not_with_it():
    fs = run_pass(*_mini_durable("notrunc"))
    assert "no-ring-truncation" in codes(fs, "error"), [str(f) for f in fs]
    # the append rides the same certified mask: wal-order is satisfied
    assert "wal-order" not in codes(fs)
    assert "no-ring-truncation" not in codes(run_pass(*_mini_durable("ok")))


def test_unbounded_ring_fires_on_tiny_capacity():
    # 2 lanes x 2 slots = 4 rows; appends = W(4) lanes x 2 steps = 8 > 4
    fs = run_pass(*_mini_durable("notrunc", capacity=2))
    assert "unbounded-ring" in codes(fs, "error"), [str(f) for f in fs]
    msg = [f for f in fs if f.code == "unbounded-ring"][0].message
    assert "(8, the lanes" in msg and "4 slots" in msg


def test_safe_durable_engine_clean():
    """Append under the certified mask and a watermark advance: every
    durability check passes through genuine dataflow."""
    fs = run_pass(*_mini_durable("ok"))
    assert not codes(fs, "error"), [str(f) for f in fs]


def test_durability_facts_seed_at_the_log_module():
    tr = core.trace_target(NAME, *_mini_durable("ok"),
                           protocol=("certified", "durable"))
    flow = df.analyze(tr)
    assert {s.site.rsplit(":", 1)[0] for s in flow.seeded(df.TRUNCATED)} \
        == {"dint_tpu_torch/tables/log.py"}
    appends = flow.log_appends()
    assert len(appends) == 2 and all(a.idx_rows == W for a in appends)
    assert {s.prim for s in flow.seeded(df.LOGGED)} == {"index_put_"}


def test_fused_log_stream_is_the_only_append_of_its_call():
    """On dint::scatter_streams the facts are per stream: the ring's
    stream is LOGGED, the meta and val streams of the same call are
    installs."""
    flow = df.analyze(T.get_trace("tatp_dense/block@fused"))
    recs = [r for r in flow.scatters if r.prim == "dint::scatter_streams"]
    logged = [r for r in recs if df.LOG_SLOT in r.index_facts]
    installs = [r for r in recs if df.LOG_SLOT not in r.index_facts]
    assert len(logged) == T.LINT.cpb and len(installs) == 2 * T.LINT.cpb
    assert all(r.fused and r.idx_rows == 2 * T.LINT.w for r in recs)
    assert {tuple(r.root.meta["val"].shape) for r in logged} == \
        {tuple(r.root.meta["val"].shape) for r in flow.log_appends()}


def test_quorum_fanout_is_reported_unchecked_on_replicated_targets():
    fs = run_pass(*_mini_durable("ok"),
                  protocol=("certified", "durable", "replicated"))
    info = [f for f in fs if f.code == "quorum-fanout-unchecked"]
    assert len(info) == 1 and info[0].severity == "info"
    assert not codes(run_pass(*_mini_durable("ok")), "info")


# ------------------------------------------------------- replay-coverage


def _mini_replay(variant):
    """A replay-shaped function over a [L, CAP, words] ring; variants
    drop a required header read or read past the populated prefix."""
    L, CAP, WORDS = 2, 4, 8

    def fn(db, entries, heads):
        key_lo = entries[:, :, 2].reshape(-1)
        ver = entries[:, :, 3].reshape(-1)
        acc = key_lo + ver
        if variant != "nohdr":
            acc = acc + entries[:, :, 0].reshape(-1)     # flags
        vcol = 7 if variant == "overread" else 4
        acc = acc + entries[:, :, vcol].reshape(-1)
        rows = torch.clamp(key_lo, 0, db.shape[0] - 1).long()
        out = db.clone()
        out.scatter_reduce_(0, rows, acc, "amax")
        return [out]

    return fn, (torch.zeros(16, dtype=I32),
                torch.zeros((L, CAP, WORDS), dtype=I32),
                torch.zeros(L, dtype=I32))


def test_replay_missing_header_read_fires():
    fs = run_pass(*_mini_replay("nohdr"), protocol=("replay",))
    assert "replay-coverage" in codes(fs, "error"), [str(f) for f in fs]
    assert any("flags" in f.message for f in fs)


def test_replay_overread_fires_with_spec(monkeypatch):
    monkeypatch.setitem(T.REPLAY_SPECS, NAME, dict(val_words=2))
    fs = run_pass(*_mini_replay("overread"), protocol=("replay",))
    msgs = [f.message for f in fs if f.code == "replay-coverage"]
    assert any("past the populated prefix" in m for m in msgs), msgs


def test_replay_in_prefix_reads_clean(monkeypatch):
    monkeypatch.setitem(T.REPLAY_SPECS, NAME, dict(val_words=2))
    fs = run_pass(*_mini_replay("ok"), protocol=("replay",))
    assert not codes(fs, "error"), [str(f) for f in fs]


def test_replay_twin_arm_fires_on_uncovered_table(monkeypatch):
    """Engine side: point the mini durable engine at a twin that does NOT
    rebuild its (33,) tables: the coverage diff must name them."""
    monkeypatch.setitem(T.REPLAY_TWINS, NAME, "recovery/smallbank_dense")
    fs = run_pass(*_mini_durable("ok"))
    msgs = [f.message for f in fs if f.code == "replay-coverage"]
    assert any("(33,)" in m and "never reconstructs" in m for m in msgs), \
        [str(f) for f in fs]


def test_the_real_twins_cover_their_engines():
    """The real arms, with what they compared: TATP's val and meta, and
    SmallBank's balances (its stamps expire and are left out)."""
    for eng, twin in T.REPLAY_TWINS.items():
        need = dur._install_classes(df.analyze(T.get_trace(eng)))
        got = dur._entries_tainted_classes(T.get_trace(twin))
        assert need and need <= got, (eng, need, got)
    tatp = dur._install_classes(df.analyze(T.get_trace("tatp_dense/block")))
    assert len(tatp) == 2
    fs = analysis.run(targets=sorted(set(T.REPLAY_TWINS.values())),
                      passes=["durability"])
    assert not fs, [str(f) for f in fs]


# ---------------------------------------------------- in-doubt totality


def _src(pkg):
    with open(os.path.join(REPO, pkg, "clients", "tatp_client.py")) as f:
        return f.read()


_MUTATIONS = [
    # never compares against Reply.TIMEOUT at all
    lambda s: s.replace("Reply.TIMEOUT", "Reply.VAL"),
    # detects timeouts but never folds them out of the survivor mask
    lambda s: s.replace(" & ~timed", "").replace(" & ~tmo2", "")
               .replace(" & ~in_doubt", ""),
    # no lock-release wave for dead/doubted txns
    lambda s: s.replace("Op.ABORT", "Op.OCC_READ"),
]


@pytest.mark.parametrize("pkg", ["dint_tpu", "dint_tpu_torch"])
def test_in_doubt_violations_equal_the_reference(pkg):
    from dint_tpu.analysis.passes import durability as ref
    src = _src(pkg)
    assert dur.in_doubt_violations(src) == ref.in_doubt_violations(src) \
        == []
    for mutate in _MUTATIONS:
        got = dur.in_doubt_violations(mutate(src))
        assert got and got == ref.in_doubt_violations(mutate(src))


def test_in_doubt_runs_through_the_pass(tmp_path, monkeypatch):
    """Pass-level wiring: a registered client source with a severed
    TIMEOUT path gives an in-doubt-totality ERROR on its target; the
    port's own client gives none on sharded/tatp."""
    bad = tmp_path / "client.py"
    bad.write_text(_src("dint_tpu_torch").replace("Op.ABORT", "Op.OCC_READ"))
    monkeypatch.setitem(dur._CLIENT_SOURCES, NAME, str(bad))
    fs = run_pass(lambda x: [x + 1], (torch.zeros(8, dtype=I32),),
                  protocol=())
    assert "in-doubt-totality" in codes(fs, "error"), [str(f) for f in fs]
    assert not dur._in_doubt_totality(
        core.TargetTrace("sharded/tatp", None))


# --------------------------------------------------- allowlist coverage


def _findings_for(code, tmp_path, monkeypatch):
    if code == "wal-order":
        return broken_wal_order_findings()
    if code == "no-ring-truncation":
        return run_pass(*_mini_durable("notrunc"))
    if code == "unbounded-ring":
        return run_pass(*_mini_durable("notrunc", capacity=2))
    if code == "replay-coverage":
        return run_pass(*_mini_replay("nohdr"), protocol=("replay",))
    if code == "in-doubt-totality":
        bad = tmp_path / "client.py"
        bad.write_text(_src("dint_tpu_torch").replace("Op.ABORT",
                                                      "Op.OCC_READ"))
        monkeypatch.setitem(dur._CLIENT_SOURCES, NAME, str(bad))
        return run_pass(lambda x: [x + 1], (torch.zeros(8, dtype=I32),),
                        protocol=())
    raise AssertionError(code)


@pytest.mark.parametrize("code", ["wal-order", "unbounded-ring",
                                  "no-ring-truncation", "replay-coverage",
                                  "in-doubt-totality"])
def test_each_check_fires_and_is_allowlist_silenceable(code, tmp_path,
                                                       monkeypatch):
    findings = _findings_for(code, tmp_path, monkeypatch)
    assert code in codes(findings, "error"), \
        f"{code} fixture did not fire: " + str([str(f) for f in findings])
    path = tmp_path / "allow.json"
    path.write_text(json.dumps([
        {"pass": "durability", "code": code, "target": NAME,
         "reason": "test fixture: violation is constructed on purpose"}]))
    fs = al.apply(_findings_for(code, tmp_path, monkeypatch),
                  al.load(str(path)), check_unused=False)
    assert not any(f.severity == "error" and not f.suppressed
                   and f.code == code for f in fs)
    assert any(f.suppressed for f in fs)


def test_allowlist_holds_one_truncation_entry_a_durable_target():
    entries = al.load(analysis.DEFAULT_ALLOWLIST)
    dur_entries = [e for e in entries if e["pass"] == "durability"]
    assert {e["code"] for e in dur_entries} == {"no-ring-truncation"}
    durable = sorted(n for n, p in T.TARGET_PROTOCOL.items()
                     if "durable" in p)
    assert sorted(e["target"] for e in dur_entries) == durable
    assert all("log-truncation" in e["reason"] for e in dur_entries)


# ------------------------------------------------ targets and the CLI


def test_recovery_targets_are_registered_and_traced():
    """The replay twins are first-class targets with cost rows: dintcost
    and dintdur both see them."""
    for name in ("recovery/tatp_dense", "recovery/smallbank_dense",
                 "recovery/sb_shard"):
        assert name in analysis.TARGETS and name not in T.EXCLUDED
        assert analysis.TARGET_PROTOCOL[name] == ("replay",)
        assert name in T.TARGET_COST and name in T.REPLAY_SPECS
        tr = analysis.get_trace(name)
        assert tr.gm is not None and len(dur._entry_inputs(tr)) == 1
    for eng, twin in T.REPLAY_TWINS.items():
        assert eng in analysis.TARGETS and twin in analysis.TARGETS


def test_dintdur_cli_json_and_sarif(tmp_path, capsys):
    sarif_path = tmp_path / "out.sarif"
    assert dintdur.main(["check", "--target", "tatp_dense/block",
                         "--target", "recovery/tatp_dense", "--json",
                         "--sarif", str(sarif_path)]) == 0
    payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert payload["metric"] == "dintdur" and payload["ok"] is True
    assert payload["schema"] == dintdur.JSON_SCHEMA == 2
    for k in ("mode", "targets", "n_findings", "n_errors",
              "n_suppressed", "stale_allowlist", "findings"):
        assert k in payload
    assert payload["n_errors"] == 0 and payload["n_suppressed"] >= 1
    sarif = json.loads(sarif_path.read_text())
    assert sarif["version"] == "2.1.0"
    run0 = sarif["runs"][0]
    assert run0["tool"]["driver"]["name"] == "dintdur"
    assert any(r["ruleId"] == "durability/no-ring-truncation"
               and r.get("suppressions") for r in run0["results"])
    loc = run0["results"][0]["locations"][0]["physicalLocation"]
    assert loc["artifactLocation"]["uri"].endswith(".py")
    assert loc["region"]["startLine"] > 0
    # report informs and never gates; describe lists the checks
    assert dintdur.main(["report", "--target", "tatp_dense/block"]) == 0
    assert "no-ring-truncation" in capsys.readouterr().out
    assert dintdur.main(["describe", "--json"]) == 0
    d = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "wal-order" in d["checks"]
    assert "recovery/tatp_dense" in d["durable_targets"]


def test_dintdur_cli_unknown_target_exits_2(capsys):
    with pytest.raises(SystemExit) as exc:
        dintdur.main(["check", "--target", "nope/bad"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "unknown target" in err and "tatp_dense/block" in err


def test_prune_check_is_a_gate_scoped_dry_run(tmp_path, capsys,
                                              monkeypatch):
    """The stale-entry contract scoped to the durability pass, over a
    matrix cut to two targets (and the durability entries of those two):
    the dry run fails without rewriting; the real prune drops ONLY the
    stale durability entry, never another gate's entries."""
    names = ["tatp_dense/block", "smallbank_dense/block"]
    real_run = analysis.run

    def two_targets(targets=None, **kw):
        return real_run(targets=targets or names, **kw)
    monkeypatch.setattr(analysis, "run", two_targets)
    entries = [e for e in json.loads(open(analysis.DEFAULT_ALLOWLIST).read())
               if e["pass"] != "durability" or e["target"] in names]
    n_kept = len(entries)
    entries.append({"pass": "durability", "code": "no-such-code",
                    "reason": "stale on purpose"})
    path = tmp_path / "allow.json"
    path.write_text(json.dumps(entries))
    before = path.read_text()
    assert dintdur.main(["check", "--prune-allowlist", "--check",
                         "--allowlist", str(path)]) == 1
    assert path.read_text() == before
    out = capsys.readouterr().out
    assert "NOT rewritten" in out and "durability/no-such-code" in out
    assert dintdur.main(["check", "--prune-allowlist",
                         "--allowlist", str(path)]) == 0
    capsys.readouterr()
    pruned = json.loads(path.read_text())
    assert len(pruned) == n_kept
    assert not any(e["code"] == "no-such-code" for e in pruned)
    assert sum(e["pass"] == "durability" for e in pruned) == 2
    assert any(e["pass"] == "scatter_race" for e in pruned)
    with pytest.raises(SystemExit):      # --check without the prune
        dintdur.main(["check", "--all", "--check"])
    with pytest.raises(SystemExit):      # prune is check-mode only
        dintdur.main(["report", "--all", "--prune-allowlist"])
