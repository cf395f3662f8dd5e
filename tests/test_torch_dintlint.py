"""The port's dintlint (dint_tpu_torch/analysis): each pass proven live on
a deliberately broken mini step, silent on its safe twin, and silenced by
an allowlist entry; the allowlist and SARIF results identical to the
reference's on the same findings; the target registry equal to the
reference's minus its listed exclusions; the CLI's exit codes; and the
nine kernels as ``torch.ops.dint`` operators on the CPU.

The fixtures are torch twins of tests/test_dintlint.py's and expect the
same finding codes where a code carries over. The reference's own gate
cannot run on this jax (ROADMAP §C.5), so its codes are read from its
tests. The real engines' matrix is in tests/test_torch_dintlint_matrix*.py.
"""
import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dint_tpu_torch import analysis
from dint_tpu_torch import dintlint
from dint_tpu_torch.analysis import allowlist as al
from dint_tpu_torch.analysis import core
from dint_tpu_torch.analysis import dataflow as df
from dint_tpu_torch.analysis import targets as T
from dint_tpu_torch.ops import library, segments, u32
from dint_tpu_torch.ops import row_kernels as rk
from dint_tpu_torch.ops import scan_kernels as sk

I32 = torch.int32
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_pass(name, fn, args, protocol=("certified",), inputs=(), carry=()):
    tr = core.trace_target(f"fixture/{name}", fn, args, protocol=protocol,
                           inputs=inputs, carry=carry)
    return analysis.PASSES[name](tr)


def codes(findings, severity=None):
    return {f.code for f in findings
            if severity is None or f.severity == severity}


def i32(*shape, hi=32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, hi, shape, dtype=I32, generator=g)


# ------------------------------------------------------------ scatter_race


def _colliding(tab, idx, v):
    tab[idx.long()] = v         # arbitrary idx: a duplicate is a race
    return [tab]


def _broken_scatter_findings():
    return run_pass("scatter_race", _colliding, (i32(64), i32(8), i32(8)))


def test_scatter_race_fires_on_colliding_index_put():
    fs = _broken_scatter_findings()
    assert "nonunique-index_put_" in codes(fs, "error")


def test_scatter_race_accepts_segment_masked_and_kernel_scatter():
    def ok_segmented(tab, kh, kl, v):
        sb = segments.sort_batch(kh, kl)
        return [segments.scatter_rows(tab, sb.key_lo, v[sb.perm], sb.last)]

    def ok_kernel(tab, idx, v):
        # dint::scatter_streams: unique rows among kept lanes by contract
        rk.scatter_streams([tab], [idx], [v], [1])
        return [tab]

    def ok_mask(tab, m, v):
        tab[m] = v[m]           # a boolean mask writes each row once
        return [tab]

    kh = torch.zeros(8, dtype=I32)
    assert not codes(run_pass("scatter_race", ok_segmented,
                              (i32(64), kh, i32(8), i32(8))), "error")
    assert not codes(run_pass("scatter_race", ok_kernel,
                              (i32(64), torch.arange(8, dtype=I32), i32(8))),
                     "error")
    assert not codes(run_pass("scatter_race", ok_mask,
                              (i32(8), i32(8) > 10, i32(8))), "error")


def test_scatter_race_float_reducer_errors_int_reducer_info():
    def float_add(tab, idx, v):
        return [tab.index_add_(0, idx.long(), v)]

    def int_max(tab, idx, v):
        return [tab.scatter_reduce_(0, idx.long(), v, "amax")]

    fs = run_pass("scatter_race", float_add,
                  (torch.zeros(64), i32(8), torch.ones(8)))
    assert "nonunique-index_add_" in codes(fs, "error")
    fs = run_pass("scatter_race", int_max, (i32(64), i32(8), i32(8)))
    assert codes(fs) == {"reducer-dup"} and not codes(fs, "error")


# ---------------------------------------------------------------- aliasing


def test_aliasing_view_aliased_mirror():
    tab = i32(64)

    def step(tab, mirror, idx, v):
        tab[idx.long()] = v             # the write-through of a hot row
        mirror[idx.long()] = v
        return [tab, mirror]

    idx = torch.arange(4, dtype=I32)
    bad = run_pass("aliasing", step, (tab, tab[:8], idx, i32(4)))
    assert "shared-state-storage" in codes(bad, "error")
    tab = i32(64)
    ok = run_pass("aliasing", step, (tab, tab[:8].clone(), idx, i32(4)))
    assert not codes(ok, "error")


def test_aliasing_kernel_argument_shares_the_written_buffer():
    def bad(arb, active):
        # rows read through a view of the very array the kernel writes
        _, grant = rk.lock_arbitrate(arb, arb[56:], active, 3, 18)
        return [arb, grant]

    def ok(arb, rows, active):
        _, grant = rk.lock_arbitrate(arb, rows, active, 3, 18)
        return [arb, grant]

    act = torch.ones(8, dtype=torch.bool)
    fs = run_pass("aliasing", bad, (torch.zeros(64, dtype=I32), act))
    assert "donated-operand-duplicated" in codes(fs, "error")
    assert not codes(run_pass("aliasing", ok, (torch.zeros(64, dtype=I32),
                                               i32(8), act)), "error")


def _stale_view(tab, idx, v):
    old = tab.view(-1, 1)           # taken before the kernel rewrites tab
    rk.scatter_streams([tab], [idx], [v], [1])
    return [old + 1]                # reads the new contents by the old name


def test_used_after_names_the_first_later_read():
    tr = core.trace_target("fixture/used_after", _stale_view,
                           (i32(64), torch.arange(8, dtype=I32), i32(8)))
    view = next(n for n in tr.graph.nodes if core.op_name(n) == "view")
    kernel = next(n for n in tr.graph.nodes
                  if core.op_name(n) == "dint::scatter_streams")
    assert core.used_after(view, kernel).startswith("read by `add`")
    add = next(n for n in tr.graph.nodes if core.op_name(n) == "add")
    assert core.used_after(add, kernel) == "escapes as a graph output"


def test_aliasing_use_after_donate():
    def ok(tab, idx, v):
        rk.scatter_streams([tab], [idx], [v], [1])
        return [tab.view(-1, 1) + 1]    # a view taken after the write

    args = (i32(64), torch.arange(8, dtype=I32), i32(8))
    assert "use-after-donate" in codes(run_pass("aliasing", _stale_view,
                                                args), "error")
    assert not codes(run_pass("aliasing", ok, (i32(64), torch.arange(
        8, dtype=I32), i32(8))), "error")


# ------------------------------------------------------------------ purity


def test_purity_flags_item_branch_and_host_syncs():
    def bad(x, m):
        if x.sum().item() > 0:          # a host read decides the branch
            x = x + 1
        return [x[m], torch.nonzero(m), torch.unique(x)]

    fs = run_pass("purity", bad, (i32(8), i32(8) > 10))
    assert {"_local_scalar_dense", "index-bool-mask", "nonzero",
            "unique"} <= codes(fs, "warning")
    assert not codes(fs, "error")

    def ok(x, m):
        return [torch.where(m, x, 0)]

    assert not run_pass("purity", ok, (i32(8), i32(8) > 10))


def _untraceable(x):
    raise ValueError("the step refuses its own arguments")


def test_purity_flags_untraceable_step():
    assert "untraceable" in codes(run_pass("purity", _untraceable, (i32(8),)),
                                  "error")


def test_purity_host_scalar_step_counter():
    def steps(arb, rows, active):
        for t in (2, 3, 4):             # the host step counter, by value
            rk.lock_arbitrate(arb, rows, active, t, 18)
        return [arb]

    def fixed(arb, rows, active):
        for _ in range(3):
            rk.lock_arbitrate(arb, rows, active, 2, 18)
        return [arb]

    args = (torch.zeros(64, dtype=I32), i32(8), torch.ones(8, dtype=bool))
    fs = run_pass("purity", steps, args)
    assert codes(fs, "info") == {"host-scalar"}
    assert "host-scalar" not in codes(run_pass("purity", fixed, (
        torch.zeros(64, dtype=I32), i32(8), torch.ones(8, dtype=bool))))


# ------------------------------------------------------------ u64_overflow

_WORDS = (("db.arb", True), ("lane", True))


def _signed_words(arb, lane):
    return [arb < lane, arb >> 18, torch.remainder(arb, 7)]


def test_u64_flags_signed_word_compare_shift_and_division():
    fs = run_pass("u64_overflow", _signed_words, (i32(8), i32(8)),
                  inputs=_WORDS)
    assert {"signed-stamp-compare", "signed-word-shift",
            "signed-word-division"} <= codes(fs, "error")


def test_u64_accepts_widened_words():
    def ok(arb, lane):
        wide = u32.to_u64(arb)          # the masked widening
        return [wide < u32.to_u64(lane), u32.shr(arb, 18),
                torch.remainder(wide, 7),
                u32.wrap_i32(wide + 1) < lane]

    assert not run_pass("u64_overflow", ok, (i32(8), i32(8)), inputs=_WORDS)
    # the same compares on values that are not words pass too
    assert not run_pass("u64_overflow", _signed_words, (i32(8), i32(8)),
                        inputs=(("rows", True), ("lane", True)))


# ---------------------------------------------------------------- protocol
#
# Mutated-engine fixtures for the dataflow pass: a miniature step-stamped
# OCC engine (three steps, unrolled; its carry fed back as a block's is)
# with one protocol edge severed per variant, and a mini 2PL engine.

W, N, KB = 8, 32, 8
_OCC_INPUTS = tuple((f"s{i}", True) for i in range(6)) + (("xs", False),)
_OCC_CARRY = tuple((i, i) for i in range(6))


def _mini_occ_args():
    return (i32(N + 1), torch.zeros(N + 1, dtype=I32),
            torch.zeros(N + 1, dtype=I32), i32(W), i32(W),
            torch.zeros(W, dtype=torch.bool), i32(3, W, seed=1))


def _mini_occ(variant: str):
    """Step-stamped OCC: acquire (scatter-max of step<<K), validate (meta
    re-read vs snapshot), install (mask alive & ~changed, like the real
    pipelines). "drop_lock" installs on validation alone, "drop_validate"
    on the grant alone."""
    def fn(tab, meta, arb, c_rows, c_snap, c_alive, xs):
        for t in range(3):
            step = 2 + t
            cur = meta[c_rows.long()]
            valid = cur == c_snap                       # VALIDATED seed
            changed = (~valid)[:, None].any(dim=1)      # ABORT_MASK seed
            if variant == "drop_lock":
                mask = ~changed
            elif variant == "drop_validate":
                mask = c_alive
            else:
                mask = c_alive & ~changed
            keep = torch.nonzero(mask).squeeze(1)
            rows_w = c_rows[keep].long()
            meta[rows_w] = cur[keep] + 1
            tab[rows_w] = c_rows[keep]
            rows = xs[t]
            lane = torch.arange(W, dtype=I32)
            packed = (step << KB) | (W - lane)
            held = (arb[rows.long()] >> KB) == step - 1
            cand = torch.nonzero(~held).squeeze(1)
            arb.scatter_reduce_(0, rows[cand].long(), packed[cand], "amax")
            grant = ~held & (arb[rows.long()] == packed)   # LOCK_WIN seed
            rejected = (~grant)[:, None].any(dim=1)        # ABORT_MASK
            c_rows, c_snap, c_alive = rows, meta[rows.long()], \
                grant & ~rejected
        return [tab, meta, arb, c_rows, c_snap, c_alive]
    return fn


def _occ_findings(variant):
    return run_pass("protocol", _mini_occ(variant), _mini_occ_args(),
                    protocol=("certified", "occ"), inputs=_OCC_INPUTS,
                    carry=_OCC_CARRY)


@pytest.mark.parametrize("variant,code", [
    ("drop_lock", "unlocked-install"),
    ("drop_validate", "unvalidated-install"),
])
def test_protocol_occ_fixtures_fire(variant, code):
    fs = _occ_findings(variant)
    assert code in codes(fs, "error"), [str(f) for f in fs]
    other = ({"unlocked-install", "unvalidated-install"} - {code}).pop()
    assert other not in codes(fs, "error")


def test_protocol_safe_occ_engine_clean():
    fs = _occ_findings("safe")
    assert not codes(fs, "error"), [str(f) for f in fs]


def _mini_2pl(release: bool, kernel: bool = False):
    """Explicit-release 2PL: first-lane-wins arbitration over a bool lock
    array (no stamp: locks are sticky), validation, install. release=False
    models "return early past the unlock wave". ``kernel``: the grant
    comes from dint::lock_arbitrate (expiring stamps; the witness)."""
    def fn(tab, lock, arb, c_rows, c_snap, c_grant, xs):
        for t in range(3):
            cur = tab[c_rows.long()]
            valid = cur == c_snap
            changed = (~valid)[:, None].any(dim=1)
            commit = c_grant & ~changed
            segments.scatter_rows(tab, c_rows, cur + 1, commit)
            if release:
                segments.scatter_rows(lock, c_rows,
                                      torch.zeros(W, dtype=torch.bool),
                                      c_grant)
            rows = xs[t]
            lane = torch.arange(W, dtype=I32)
            if kernel:
                _, grant = rk.lock_arbitrate(arb, rows, ~lock[rows.long()],
                                             2 + t, KB)
            else:
                first = torch.full((N + 1,), 1 << 30, dtype=I32)
                first.scatter_reduce_(0, rows.long(), lane, "amin")
                grant = ~lock[rows.long()] & (first[rows.long()] == lane)
            segments.scatter_rows(lock, rows, torch.ones(W, dtype=torch.bool),
                                  grant)
            c_rows, c_snap, c_grant = rows, tab[rows.long()], grant
        return [tab, lock, arb, c_rows, c_snap, c_grant]
    return fn


def _2pl_findings(release, kernel=False):
    args = (i32(N + 1), torch.zeros(N + 1, dtype=torch.bool),
            torch.zeros(N + 1, dtype=I32), i32(W), i32(W),
            torch.zeros(W, dtype=torch.bool), i32(3, W, seed=1))
    return run_pass("protocol", _mini_2pl(release, kernel), args,
                    inputs=_OCC_INPUTS, carry=_OCC_CARRY)


def test_protocol_abort_unlock_fixture():
    broken = _2pl_findings(release=False)
    assert "abort-leaks-lock" in codes(broken, "error"), \
        [str(f) for f in broken]
    safe = _2pl_findings(release=True)
    assert "abort-leaks-lock" not in codes(safe, "error"), \
        [str(f) for f in safe]
    # the lock kernel is the expiring-stamp witness, as lock_arbitrate's
    # Pallas kernel is the reference's
    assert "abort-leaks-lock" not in codes(_2pl_findings(False, True),
                                           "error")


def _mini_store(variant: str):
    """Lock-free writer election (engines/store.step's shape): sort the
    batch's keys, elect the last writer a key with a segment reduction,
    install the elected lanes. "no_election" installs every lane."""
    def fn(tab, kh, kl, vals):
        for _ in range(3):
            sb = segments.sort_batch(kh, kl)
            lane = torch.arange(kh.shape[0], dtype=I32)
            if variant == "no_election":
                win = torch.ones_like(kh, dtype=torch.bool)
                rows = kl
            else:
                last = segments.seg_max_where(sb, torch.ones_like(
                    sb.last), lane[sb.perm], -1)
                win = segments.unsort(sb, last == lane[sb.perm])
                rows = torch.where(win, kl, -1)
            if variant == "uncertified":
                segments.scatter_rows(tab, kl, vals, win)
            else:
                rk.scatter_streams([tab], [rows], [vals], [1])
        return [tab]
    return fn


@pytest.mark.parametrize("variant,want", [
    ("no_election", {"no-writer-election", "unelected-install"}),
    ("uncertified", {"uncertified-install"}),
    ("safe", set()),
])
def test_protocol_writer_election_fixture(variant, want):
    kl = torch.tensor([3, 1, 3, 5, 1, 7, 3, 2], dtype=I32)
    fs = run_pass("protocol", _mini_store(variant),
                  (i32(16), torch.zeros(8, dtype=I32), kl, i32(8)),
                  protocol=("server", "elected"),
                  inputs=(("tab", True), ("kh", False), ("kl", False),
                          ("vals", False)))
    assert codes(fs, "error") == want, [str(f) for f in fs]


def _replicated(variant):
    """A 3-partition step: each partition installs its write, then the
    records hop to p+1 and p+2 (Mesh.ppermute) and are applied to the
    backup table, or discarded ("discard"), or never pushed ("nohop")."""
    from dint_tpu_torch.parallel import mesh as pmesh
    mesh = pmesh.Mesh((3,), ("shard",), device="cpu")

    def fn(t0, t1, t2, b0, b1, b2, rows):
        tabs, bcks = [t0, t1, t2], [b0, b1, b2]
        recs = []
        for t in tabs:
            t[rows.long()] = rows + 1
            recs.append((rows, rows + 1))
        if variant == "nohop":
            return tabs + bcks
        for off in (1, 2):
            fwd = mesh.ppermute(recs, "shard", off)
            for b, (r, v) in zip(bcks, fwd):
                if variant != "discard":
                    b[(off - 1) * 8 + r.long()] = v
        return tabs + bcks
    args = tuple(i32(8) for _ in range(3)) + tuple(i32(16)
                                                   for _ in range(3))
    return fn, args + (torch.arange(4, dtype=I32),)


@pytest.mark.parametrize("variant,want", [
    ("nohop", {"no-replication-push"}),
    ("discard", {"push-not-applied"}),
    ("ok", set()),
])
def test_protocol_replicated_flag_is_never_silent(variant, want):
    fn, args = _replicated(variant)
    fs = run_pass("protocol", fn, args, protocol=("replicated",),
                  inputs=tuple((f"a{i}", i < 6) for i in range(7)))
    assert codes(fs, "error") == want, [str(f) for f in fs]
    assert not codes(fs, "info")


# --------------------------------------------------------------- allowlist


def test_allowlist_suppresses_matched_finding(tmp_path):
    path = tmp_path / "allow.json"
    path.write_text(json.dumps([
        {"pass": "scatter_race", "code": "nonunique-index_put_",
         "target": "fixture/scatter_race",
         "reason": "fixture: uniqueness proven by the test harness"}]))
    fs = al.apply(_broken_scatter_findings(), al.load(str(path)))
    assert not analysis.has_errors(fs)
    assert any(f.suppressed for f in fs)


def test_allowlist_requires_reason_and_reports_stale_entries(tmp_path):
    bad = tmp_path / "noreason.json"
    bad.write_text(json.dumps([{"pass": "x", "code": "y"}]))
    with pytest.raises(al.AllowlistError):
        al.load(str(bad))
    stale = tmp_path / "stale.json"
    stale.write_text(json.dumps([
        {"pass": "scatter_race", "code": "no-such-code",
         "reason": "matches nothing"}]))
    fs = al.apply(_broken_scatter_findings(), al.load(str(stale)))
    assert "unused-entry" in codes(fs, "warning")
    assert analysis.has_errors(fs)


def _broken_findings(pname):
    """Fresh findings from the canonical broken fixture of each pass."""
    if pname == "scatter_race":
        return _broken_scatter_findings()
    if pname == "aliasing":
        return run_pass("aliasing", _stale_view,
                        (i32(64), torch.arange(8, dtype=I32), i32(8)))
    if pname == "purity":
        return run_pass("purity", _untraceable, (i32(8),))
    if pname == "u64_overflow":
        return run_pass("u64_overflow", _signed_words, (i32(8), i32(8)),
                        inputs=_WORDS)
    if pname == "protocol":
        return _occ_findings("drop_lock")
    if pname == "cost_budget":
        from test_torch_dintcost import over_budget_findings
        return over_budget_findings()
    if pname == "durability":
        from test_torch_dintdur import broken_wal_order_findings
        return broken_wal_order_findings()
    if pname == "plan_check":
        from test_torch_dintplan import broken_plan_findings
        return broken_plan_findings()
    if pname == "calib_check":
        from test_torch_calib_check import broken_calib_findings
        return broken_calib_findings()
    if pname == "mut_check":
        from test_torch_dintmut import broken_mutcov_findings
        return broken_mutcov_findings()
    if pname == "shard_consistency":
        from test_torch_shard_consistency import broken_shard_findings
        return broken_shard_findings()
    raise AssertionError(pname)


@pytest.mark.parametrize("pname", sorted(analysis.PASSES))
def test_every_pass_fires_and_is_suppressible(pname):
    fs = _broken_findings(pname)
    errs = [f for f in fs if f.severity == "error"]
    assert errs, f"{pname}: broken fixture produced no error"
    entries = [{"pass": pname, "code": f.code, "target": f.target,
                "reason": "fixture suppression"} for f in errs]
    fs2 = al.apply(copy.deepcopy(fs), entries)
    assert not analysis.has_errors(fs2)


def test_port_allowlist_entries_have_reasons():
    entries = al.load(analysis.DEFAULT_ALLOWLIST)
    assert entries
    for e in entries:
        assert len(e["reason"].strip()) > 40, e
        assert e.get("target") in analysis.TARGETS, e
        assert e["pass"] in analysis.PASSES, e


# ------------------------------------------ parity with the reference's


_DICTS = [
    dict(pass_name="scatter_race", code="nonunique-scatter",
         severity="error", target="tatp_dense/block", message="m1",
         primitive="scatter", site="dint_tpu_torch/engines/x.py:12",
         path="dint.tatp_dense.install", suggestion="fix it"),
    dict(pass_name="protocol", code="unlocked-install", severity="error",
         target="smallbank_dense/block", message="m2", site="y.py:3"),
    dict(pass_name="scatter_race", code="reducer-dup", severity="info",
         target="store/block", message="m3", site="nowhere", count=3),
    dict(pass_name="harness", code="target-skipped", severity="info",
         target="sharded/tatp", message="m4"),
    dict(pass_name="protocol", code="abort-leaks-lock", severity="error",
         target="tatp_dense/block@fused", message="m5",
         site="engines/tatp_dense.py:99"),
]
_ENTRIES = [
    {"pass": "scatter_race", "code": "nonunique-scatter",
     "target": "tatp_dense/block", "site": "engines/x.py",
     "reason": "a reviewed exception"},
    {"pass": "protocol", "code": "*", "target": "*", "site": "y.py",
     "reason": "wildcards"},
    {"pass": "purity", "code": "nonzero", "reason": "stale"},
]


def test_allowlist_and_sarif_match_the_reference():
    from dint_tpu.analysis import allowlist as ref_al
    from dint_tpu.analysis import core as ref_core
    ref = ref_al.apply([ref_core.Finding(**d) for d in _DICTS],
                       copy.deepcopy(_ENTRIES))
    port = al.apply([core.Finding(**d) for d in _DICTS],
                    copy.deepcopy(_ENTRIES))
    assert [f.to_dict() for f in port] == [f.to_dict() for f in ref]
    assert core.to_sarif(port, "dintlint") == \
        ref_core.to_sarif(ref, "dintlint")
    for check in (False, True):
        r = ref_al.apply([ref_core.Finding(**d) for d in _DICTS],
                         copy.deepcopy(_ENTRIES), check_unused=check)
        p = al.apply([core.Finding(**d) for d in _DICTS],
                     copy.deepcopy(_ENTRIES), check_unused=check)
        assert [f.to_dict() for f in p] == [f.to_dict() for f in r]


def test_prune_and_save_match_the_reference(tmp_path):
    from dint_tpu.analysis import allowlist as ref_al
    e1, e2 = copy.deepcopy(_ENTRIES), copy.deepcopy(_ENTRIES)
    ref_al.apply([core.Finding(**d) for d in _DICTS], e1)
    al.apply([core.Finding(**d) for d in _DICTS], e2)
    assert ref_al.prune_entries(e1) == al.prune_entries(e2)
    for pname in ("scatter_race", "protocol", "purity"):
        assert ref_al.prune_scoped(e1, pname) == al.prune_scoped(e2, pname)
    ref_al.save(str(tmp_path / "r.json"), e1)
    al.save(str(tmp_path / "p.json"), e2)
    assert (tmp_path / "r.json").read_text() == \
        (tmp_path / "p.json").read_text()


def test_target_registry_is_the_reference_minus_the_exclusions():
    from dint_tpu.analysis import targets as ref_t
    ref = set(ref_t.TARGETS)
    assert set(T.EXCLUDED) <= ref
    # only the @pallas variants are left out: the recovery/* replay twins
    # are registered (dintdur's replay-coverage reads them)
    assert all("@pallas" in n or "+pallas" in n for n in T.EXCLUDED)
    assert {n for n in ref if n.startswith("recovery/")} <= set(T.TARGETS)
    assert set(T.TARGETS) == ref - set(T.EXCLUDED)
    for name in T.TARGETS:
        assert T.TARGET_PROTOCOL[name] == ref_t.TARGET_PROTOCOL[name], name
        assert T.TARGET_DOCS[name]


# --------------------------------------------------------------------- CLI


def test_cli_exit_codes(tmp_path, capsys):
    assert dintlint.main(["--target", "tatp_dense/drain"]) == 0
    empty = tmp_path / "empty.json"
    empty.write_text("[]")
    assert dintlint.main(["--target", "tatp_dense/drain", "--allowlist",
                          str(empty)]) == 1
    for argv in (["--target", "no/such-target"], ["--pass", "nope", "--all"],
                 [], ["--check", "--all"],
                 ["--prune-allowlist", "--target", "tatp_dense/drain"]):
        with pytest.raises(SystemExit) as e:
            dintlint.main(argv)
        assert e.value.code == 2, argv
    err = capsys.readouterr().err
    assert "registered targets:" in err and "tatp_dense/block" in err


def test_cli_json_sarif_and_host_syncs(tmp_path, capsys):
    sarif = tmp_path / "out.sarif"
    assert dintlint.main(["--target", "tatp_dense/drain", "--json",
                          "--sarif", str(sarif)]) == 0
    payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert payload["ok"] and payload["n_errors"] == 0
    # scatter_race's drain entry, two purity ones, and dintdur's
    # no-ring-truncation
    assert payload["n_suppressed"] == 4
    syncs = payload["host_syncs"]["tatp_dense/drain"]
    assert {s["code"] for s in syncs} == {"nonzero", "host-scalar"}
    log = json.loads(sarif.read_text())
    assert log["version"] == "2.1.0" and log["runs"][0]["results"]


def test_cli_module_lists_the_registry():
    out = subprocess.run([sys.executable, "-m", "dint_tpu_torch.dintlint",
                          "--list"], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    for name in ("tatp_dense/block@fused", "store/rebuild@scan", "protocol",
                 "u64_overflow"):
        assert name in out.stdout


# ---------------------------------------------- the kernels as dint:: ops


def test_the_nine_kernels_are_dint_ops_with_their_writes_declared():
    assert sorted(library.SCHEMAS) == sorted(
        ["gather_rows", "lock_arbitrate", "lock_validate", "gather_streams",
         "scatter_streams", "gather_rows_hot", "scatter_rows_hot",
         "scan_rows", "scalar_scatter"])
    writes = {n: library.mutated_args(library.op(n).default)
              for n in library.SCHEMAS}
    assert writes == {"gather_rows": [], "lock_arbitrate": ["arb"],
                      "lock_validate": ["arb"], "gather_streams": [],
                      "scatter_streams": ["tabs"], "gather_rows_hot": [],
                      "scatter_rows_hot": ["tabs", "mirrors"],
                      "scan_rows": [], "scalar_scatter": []}


def test_dint_ops_on_the_cpu_equal_the_plain_versions():
    g = torch.Generator().manual_seed(3)
    tab = torch.randint(-2**31, 2**31 - 1, (400,), dtype=I32, generator=g)
    mir = tab[:40].clone()
    idx = torch.randint(0, 100, (30,), dtype=I32, generator=g)
    midx = torch.where(idx < 10, idx, -1).to(I32)
    ops = torch.ops.dint
    got = ops.gather_rows([tab, tab], [idx, idx], [4, 1])
    want = rk.gather_rows_ref((tab, tab), (idx, idx), (4, 1))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    got = ops.gather_streams([tab], [idx], [2])
    assert torch.equal(got[0], rk.gather_streams_ref([tab], [idx], [2])[0])
    got = ops.gather_rows_hot([tab], [mir], [idx], [midx], [4])
    assert torch.equal(got[0], rk.gather_rows_hot_ref(tab, mir, idx, midx, 4))
    rows = torch.randint(0, 50, (24,), dtype=I32, generator=g)
    act = torch.rand(24, generator=g) < 0.8
    a1, a2 = torch.zeros(51, dtype=I32), torch.zeros(51, dtype=I32)
    grant = ops.lock_arbitrate(a1, rows, act, 5, 18)
    _, want = rk.lock_arbitrate_ref(a2, rows, act, 5, 18)
    assert torch.equal(grant, want) and torch.equal(a1, a2)
    meta = torch.randint(0, 99, (51,), dtype=I32, generator=g)
    vidx, vv1 = rows[:10], torch.randint(0, 99, (10,), dtype=I32, generator=g)
    out = ops.lock_validate(a1, meta, vidx, vv1, rows, rows, act, 6, 18)
    ref = rk.lock_validate_ref(a2, meta, vidx, vv1, rows, rows, act, 6, 18)
    assert all(torch.equal(x, y) for x, y in zip(out, ref[1:]))
    assert torch.equal(a1, a2)
    t1, t2 = tab.clone(), tab.clone()
    sidx = torch.randperm(100, generator=g)[:30].to(I32)
    sidx[::3] = -1
    vals = torch.randint(0, 9, (120,), dtype=I32, generator=g)
    ops.scatter_streams([t1], [sidx], [vals], [4])
    rk.scatter_streams_ref([t2], [sidx], [vals], [4])
    assert torch.equal(t1, t2)
    t1, t2, m1, m2 = tab.clone(), tab.clone(), mir.clone(), mir.clone()
    hidx = torch.where(sidx < 10, sidx, -1).to(I32)
    mask = sidx >= 0
    ops.scatter_rows_hot([t1], [m1], [sidx], [hidx], [mask], [vals], [4])
    rk.scatter_rows_hot_ref(t2, m2, sidx, hidx, mask, vals, 4)
    assert torch.equal(t1, t2) and torch.equal(m1, m2)
    run = [torch.arange(64, dtype=I32) for _ in range(3)]
    rval = torch.arange(64 * 2, dtype=I32)
    off = torch.tensor([0, 5, 60], dtype=I32)
    out = ops.scan_rows(*run, rval, off, 4, 2)
    ref = sk.scan_rows_ref(*run, rval, off, 4, 2)
    assert all(torch.equal(x, y) for x, y in zip(out, ref))
    dup = torch.tensor([3, 7, 3, 0], dtype=I32)
    v = torch.tensor([1, 2, 3, 4], dtype=I32)
    assert torch.equal(ops.scalar_scatter(tab, dup, v),
                       rk.scalar_scatter_ref(tab, dup, v))


def test_dint_ops_fake_shapes():
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        tab = torch.empty(400, dtype=I32)
        idx = torch.empty(30, dtype=I32)
        act = torch.empty(30, dtype=torch.bool)
        assert torch.ops.dint.gather_rows([tab], [idx], [4])[0].shape == (120,)
        assert torch.ops.dint.lock_arbitrate(tab, idx, act, 2, 18).dtype \
            == torch.bool
        g, v, r = torch.ops.dint.lock_validate(tab, tab[:5].clone(), idx, idx,
                                               idx[:7], idx, act, 2, 18)
        assert (g.shape, v.shape, r.shape) == ((30,), (30,), (7,))
        out = torch.ops.dint.scan_rows(tab, tab, tab, tab, idx[:3], 4, 1)
        assert [o.shape[0] for o in out] == [12, 12, 12, 12]


def test_a_trace_shows_one_node_per_kernel_call():
    trace = T.get_trace("tatp_dense/block@fused")
    kernels = [c for c in core.walk(trace) if c.in_kernel]
    names = sorted({c.prim for c in kernels})
    assert names == ["dint::gather_rows", "dint::lock_validate",
                     "dint::scatter_streams"]
    assert len(kernels) == 3 * T.LINT.cpb
    # every kernel node has its site in the engine and its wave path
    for c in kernels:
        assert c.node.meta["dint_site"].startswith(
            "dint_tpu_torch/engines/tatp_dense.py:"), c.node.meta
        assert c.path and c.path[-1].startswith("dint.tatp_dense."), c.path


def test_protocol_dense_installs_prove_lock_and_validate():
    """The interprocedural claim: the flagship engine's install scatters
    carry LOCK_WIN *and* VALIDATED, seeded at the lock kernel and the
    validate compare, flowed through two steps, without the segment-sort
    rung."""
    for name in ("tatp_dense/block", "tatp_dense/block@hot",
                 "tatp_dense/block@fused", "tatp_dense/block@fused+hot"):
        flow = df.analyze(T.get_trace(name))
        installs = [r for r in flow.scatters
                    if r.kind == "overwrite" and r.is_state]
        assert installs, name
        for r in installs:
            assert df.LOCK_WIN in r.write_facts, (name, r.site)
            assert df.VALIDATED in r.write_facts, (name, r.site)
            assert df.SORTED not in r.write_facts, (name, r.site)
        assert flow.kernel_locks, name
