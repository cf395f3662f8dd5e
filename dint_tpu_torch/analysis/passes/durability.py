"""Durability pass (dintdur): static proofs of the recovery contract, the
port of `dint_tpu.analysis.passes.durability`.

The engines' durability story is write-ahead: every certified mutation
is appended to the replicated log rings BEFORE the commit is visible,
the three log copies land on distinct fault domains, and a dead replica
rebuilds from any one surviving ring (recovery.py; the reference's
CommitLog x3, client_ebpf_shard.cc:779-810, over per-CPU rings,
ls_kern.c:63-77). No port test kills a replica but chip_smoke's recovery
phases, so a dropped log append would show only in an actual fault.

The pass consumes the durability facts of analysis/dataflow.py
(LOG_SLOT / LOGGED / TRUNCATED) and runs five ERROR checks, gated by the
``durable`` / ``replay`` protocol flags of analysis/targets.py:

  wal-order           ["durable"]  every certified commit-visible
      install (an overwrite scatter into persistent state whose write
      facts carry lock, validate or sort certification) is matched by a
      log append carrying the SAME certification facts: the append's
      mask descends from the same grant chain, so a lane cannot install
      without logging.

  unbounded-ring      ["durable"]  the appends a trace makes (each
      append's lanes as if every filter kept them all, summed over the
      unrolled steps) against the ring's slot count from its root's
      shape ([L*CAP, S*words] RepLog, [L, CAP, words] LogRing): a trace
      that provably wraps its ring within one block loses entries
      recovery can never replay.

  no-ring-truncation  ["durable"]  a trace that appends but never reaches
      a TRUNCATED seed (the tables/log.advance_watermark clamp) has an
      unbounded ring in the wall-clock sense. It fires on EVERY engine by
      design: the allowlist carries one reasoned entry a durable target,
      pointing at the ROADMAP log-truncation item.

  replay-coverage     ["durable" via REPLAY_TWINS; "replay" targets]  two
      arms. Engine side: the replay twin (recovery.replay_*) must
      produce entries-derived outputs covering every table class the
      engine installs (install roots, less lock, arbitration and stamp
      state and the ring itself). Replay side: the static columns of
      each ``select``/``slice`` over the [L, CAP, words] ring input must
      read the header words the winner rule needs (flags 0, key_lo 2,
      ver 3), at least one value word, and nothing past the populated
      prefix (HDR_WORDS + val_words, targets.REPLAY_SPECS).

  in-doubt-totality   [clients in _CLIENT_SOURCES]  the wire
      coordinator's host-numpy loop is untraceable, so this is a source
      (AST) check of the port's own client: TIMEOUT replies must be
      detected, must reach the alive mask (directly or through the
      in-doubt fold), and an Op.ABORT wave must release the doubted
      txns' locks.

Not checked yet: ``quorum-fanout`` proves from the replication perms
that every source reaches two distinct fault domains. The port's mesh
re-indexes a Python list (parallel/mesh.py), so its perms do not show in
a trace; every ``durable`` + ``replicated`` target gets one INFO
``quorum-fanout-unchecked`` until the collectives are visible (ROADMAP
§A.8.5).

Fixtures in tests/test_torch_dintdur.py prove each check fires on a
mutated mini-engine and stays silent on every real target.
"""
from __future__ import annotations

import ast
import os

import torch

from .. import dataflow as df
from ..core import (Finding, SEV_ERROR, SEV_INFO, TargetTrace, flat_nodes,
                    node_inputs, op_name, register_pass, walk)

# protocol flags read here (besides protocol.py's)
FLAG_DURABLE = "durable"
FLAG_REPLAY = "replay"

# certification facts an install mask can carry; wal-order requires a
# log append whose write facts carry the same set
_CERT = frozenset({df.LOCK_WIN, df.VALIDATED, df.SORTED})

# header columns every replay must read: flags (0), key_lo (2), ver (3)
# (key_hi (1) is a routing tag only the sharded paths filter on)
_REQUIRED_COLS = frozenset({0, 2, 3})

# targets whose protocol sequencing lives in an untraceable host client:
# target name -> client source relative to the dint_tpu_torch package
_CLIENT_SOURCES = {"sharded/tatp": "clients/tatp_client.py"}


def _val(node):
    v = node.meta.get("val") if isinstance(node, torch.fx.Node) else None
    return v if isinstance(v, torch.Tensor) else None


# ----------------------------------------------------------- wal-order


def _wal_order(trace: TargetTrace, flow: df.Dataflow) -> list[Finding]:
    appends = flow.log_appends()
    out = []
    for r in flow.scatters:
        if r.kind != "overwrite" or not r.is_state \
                or df.LOG_SLOT in r.index_facts:
            continue
        cert = r.write_facts & _CERT
        if not cert:
            continue                 # protocol.py owns uncertified installs
        if any(cert <= a.write_facts for a in appends):
            continue
        out.append(Finding(
            "durability", "wal-order", SEV_ERROR, trace.name,
            "commit-visible install with no dominating log append: the "
            "write mask carries " + "+".join(sorted(cert)) + " but no "
            "log-ring scatter (LOGGED) carries the same certification "
            "facts, so a lane can install before (or without) its WAL "
            "entry — unrecoverable after the primary dies",
            primitive=r.prim, site=r.site, path="/".join(r.path),
            suggestion="append the write to the replicated ring under "
                       "the SAME mask before the install wave "
                       "(tables/log.append_rep with do_append=wmask, as "
                       "engines/tatp_dense.pipe_step does)"))
    return out


# ----------------------------------------------------- quorum-fanout


def _quorum_unchecked(trace: TargetTrace, flags: set) -> list[Finding]:
    if "replicated" not in flags:
        return []
    return [Finding(
        "durability", "quorum-fanout-unchecked", SEV_INFO, trace.name,
        "quorum-fanout not checked: the replication hops of the "
        "in-process mesh re-index a Python list (parallel/mesh.py), so "
        "their perms do not show in the trace",
        suggestion="make the mesh's moves visible to the trace "
                   "(ROADMAP §A.8.5)")]


# --------------------------------------------------------- ring bounds


def _ring_slots(root) -> int | None:
    """Slot count of a ring from its root's shape: LogRing entries are
    [L, CAP, words] (slots = L*CAP), RepLog entries [L*CAP, S*words]
    (slots = rows)."""
    v = _val(root)
    if v is None:
        return None
    if v.dim() == 3:
        return int(v.shape[0]) * int(v.shape[1])
    if v.dim() == 2:
        return int(v.shape[0])
    return None


def _ring_bounds(trace: TargetTrace, flow: df.Dataflow) -> list[Finding]:
    appends = flow.log_appends()
    if not appends:
        return []
    out = []
    if not flow.seeded(df.TRUNCATED):
        out.append(Finding(
            "durability", "no-ring-truncation", SEV_ERROR, trace.name,
            "this trace appends to a log ring but never advances a "
            "durability watermark (no tables/log.advance_watermark "
            "reachable): the ring wraps unconditionally, so entries "
            "older than `capacity` appends are silently lost and "
            "recovery refuses the ring — bounded durability with no "
            "bound-keeper (the ROADMAP log-truncation item)",
            primitive=appends[0].prim, site=appends[0].site,
            path="/".join(appends[0].path),
            suggestion="checkpoint tables periodically and advance a "
                       "caller-owned watermark with "
                       "tables/log.advance_watermark; until then this "
                       "class is allowlisted with the ROADMAP pointer"))
    by_root: dict = {}
    for r in appends:
        if r.root is not None:
            by_root.setdefault(r.root, []).append(r)
    for root, recs in by_root.items():
        slots = _ring_slots(root)
        if slots is None:
            continue
        rows = sum(r.idx_rows for r in recs)
        if rows > slots:
            worst = max(recs, key=lambda r: r.idx_rows)
            out.append(Finding(
                "durability", "unbounded-ring", SEV_ERROR, trace.name,
                f"appends a trace makes ({rows}, the lanes of each append "
                "summed over the traced steps) exceed the ring's "
                f"{slots} slots: the ring provably wraps WITHIN one "
                "traced block, overwriting entries no recovery can "
                "replay",
                primitive=worst.prim, site=worst.site,
                path="/".join(worst.path),
                suggestion="grow log_capacity past the per-block append "
                           "bound or split the block (capacity must "
                           "cover at least one full recovery window)"))
    return out


# ------------------------------------------------- replay-coverage (2x)


def _install_classes(flow: df.Dataflow) -> set:
    """(shape, dtype) classes of the persistent tables the engine's
    install waves write: the roots replay must rebuild. Volatile state is
    left out: arbitration arrays (any scatter-max/min), the ring itself
    (LOG_SLOT appends), expiring stamp tables (every overwrite's update
    carries STAMP and none a table read) and counters (adds only)."""
    by_root: dict = {}
    for r in flow.scatters:
        if r.is_state and r.root is not None:
            by_root.setdefault(r.root, []).append(r)
    classes = set()
    for root, recs in by_root.items():
        if any(rec.kind in ("max", "min") for rec in recs):
            continue
        if any(df.LOG_SLOT in rec.index_facts for rec in recs):
            continue
        overwrites = [rec for rec in recs if rec.kind == "overwrite"]
        if not overwrites:
            continue
        if all(df.STAMP in rec.update_facts
               and df.TBL_READ not in rec.update_facts
               for rec in overwrites):
            continue
        v = _val(root)
        if v is None or not v.dim():
            continue
        classes.add((tuple(v.shape), str(v.dtype)))
    return classes


def _entry_inputs(trace: TargetTrace) -> list:
    """The ring-entries input of a replay trace: its unique rank-3
    placeholder ([L, CAP, words]; the db's leaves are 1-D or 2-D)."""
    return [n for n in trace.graph.nodes if n.op == "placeholder"
            and _val(n) is not None and _val(n).dim() == 3]


def _entries_tainted_classes(trace: TargetTrace) -> set | None:
    """(shape, dtype) classes of the replay trace's outputs whose value
    derives from the ring entries: a forward taint in node order, where
    an in-place write taints its alias root."""
    ent = _entry_inputs(trace)
    if len(ent) != 1:
        return None
    roots = df.analyze(trace).roots
    tainted = {ent[0]}
    for n in trace.graph.nodes:
        if n.op != "call_function":
            continue
        if any(i in tainted or roots.get(i, i) in tainted
               for i in node_inputs(n)):
            tainted.add(n)
            if df.is_inplace(n) or op_name(n).startswith("dint::"):
                tainted.add(roots.get(n, n))
    last = list(trace.graph.nodes)[-1]
    outs = flat_nodes(last.args[0]) if last.op == "output" else []
    got = set()
    for o in outs:
        if o in tainted or roots.get(o, o) in tainted:
            v = _val(o)
            if v is not None:
                got.add((tuple(v.shape), str(v.dtype)))
    return got


def _replay_twin_coverage(trace: TargetTrace,
                          flow: df.Dataflow) -> list[Finding]:
    from .. import targets as T
    twin = T.REPLAY_TWINS.get(trace.name)
    if not twin:
        return []
    ttrace = T.get_trace(twin)
    if ttrace.gm is None:
        return [Finding(
            "durability", "replay-coverage", SEV_ERROR, trace.name,
            f"replay twin {twin} failed to trace "
            f"({ttrace.trace_error!r}): recoverability of this engine "
            "is unverifiable",
            suggestion="fix the recovery.replay_* twin so it traces "
                       "(see its registration in analysis/targets.py)")]
    need = _install_classes(flow)
    got = _entries_tainted_classes(ttrace)
    if got is None:
        return [Finding(
            "durability", "replay-coverage", SEV_ERROR, trace.name,
            f"replay twin {twin} has no unique [L, CAP, words] entries "
            "input — the coverage comparison cannot identify the ring",
            suggestion="keep the twin's signature (db0, entries, heads) "
                       "with entries as the only rank-3 argument")]
    missing = sorted(need - got)
    if not missing:
        return []
    return [Finding(
        "durability", "replay-coverage", SEV_ERROR, trace.name,
        "install waves write table class(es) "
        + ", ".join(f"{s} {d}" for s, d in missing)
        + f" that replay twin {twin} never reconstructs from the log "
        "entries: those tables are silently lost on the first fault",
        suggestion="extend the recovery.replay_* twin (and its numpy "
                   "original) to rebuild the missing table from the "
                   "logged entries, or log the table's writes")]


def _columns(node, words: int) -> range | None:
    """The static entry columns a ``select``/``slice`` along the last dim
    of an [L, CAP, words] value reads, or None for another dim."""
    name = op_name(node)
    args = list(node.args)
    dim = args[1] if len(args) > 1 else node.kwargs.get("dim", 0)
    if not isinstance(dim, int) or dim not in (2, -1):
        return None
    if name == "select":
        c = args[2] if len(args) > 2 else node.kwargs.get("index")
        c = c + words if isinstance(c, int) and c < 0 else c
        return range(c, c + 1) if isinstance(c, int) else None
    start = args[2] if len(args) > 2 else node.kwargs.get("start")
    end = args[3] if len(args) > 3 else node.kwargs.get("end")
    start = 0 if start is None else start
    end = words if end is None else min(end, words)
    if not isinstance(start, int) or not isinstance(end, int):
        return None
    return range(start, end)


def _replay_side(trace: TargetTrace) -> list[Finding]:
    from .. import targets as T
    from ...tables.log import HDR_WORDS
    ent = _entry_inputs(trace)
    if len(ent) != 1:
        return [Finding(
            "durability", "replay-coverage", SEV_ERROR, trace.name,
            "replay target has no unique [L, CAP, words] entries input; "
            "its column reads cannot be checked against the entry "
            "layout",
            suggestion="pass the ring entries as the only rank-3 "
                       "argument")]
    lanes, cap, words = _val(ent[0]).shape
    roots = df.analyze(trace).roots
    cols: set[int] = set()
    for ctx in walk(trace):
        if ctx.prim not in ("select", "slice"):
            continue
        src = ctx.node.args[0]
        v = _val(src)
        if v is None or v.dim() != 3 or roots.get(src, src) is not ent[0] \
                or tuple(v.shape[:2]) != (lanes, cap):
            continue
        got = _columns(ctx.node, int(v.shape[2]))
        if got is not None:
            cols.update(got)
    out = []
    missing = sorted(_REQUIRED_COLS - cols)
    if missing:
        names = {0: "flags", 2: "key_lo", 3: "ver"}
        out.append(Finding(
            "durability", "replay-coverage", SEV_ERROR, trace.name,
            "replay never reads entry column(s) "
            + ", ".join(f"{c} ({names[c]})" for c in missing)
            + ": the winner-per-row rule cannot identify rows/versions "
            "without them, so replay reconstructs the wrong state",
            suggestion="read the header words with basic slicing "
                       "(entries[:, :, c]) as recovery._replay_columns "
                       "does"))
    spec = T.REPLAY_SPECS.get(trace.name) or {}
    vw = spec.get("val_words")
    if vw is not None:
        lo, hi = HDR_WORDS, HDR_WORDS + int(vw)
        if not any(lo <= c < hi for c in cols):
            out.append(Finding(
                "durability", "replay-coverage", SEV_ERROR, trace.name,
                f"replay reads no value word (columns [{lo}, {hi})): "
                "it can place winners but never installs their payload",
                suggestion="slice the value words "
                           f"entries[:, :, {lo}:{hi}]"))
        over = sorted(c for c in cols if c >= hi)
        if over:
            out.append(Finding(
                "durability", "replay-coverage", SEV_ERROR, trace.name,
                f"replay reads entry column(s) {over} past the "
                f"populated prefix [0, {hi}) (targets.REPLAY_SPECS "
                f"val_words={vw}): the engines never write those "
                "words, so replay reconstructs from zeros",
                suggestion="restrict value reads to "
                           f"entries[:, :, {lo}:{hi}] or fix "
                           "REPLAY_SPECS if the layout grew"))
    return out


# --------------------------------------------------- in-doubt totality


def _names_in(node) -> set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _mentions_timeout(node) -> bool:
    return any(isinstance(n, ast.Attribute) and n.attr == "TIMEOUT"
               and isinstance(n.value, ast.Name) and n.value.id == "Reply"
               for n in ast.walk(node))


def _target_names(t) -> set[str]:
    """Base name(s) a statement assigns through (x, x[i], (a, b))."""
    if isinstance(t, ast.Name):
        return {t.id}
    if isinstance(t, (ast.Subscript, ast.Starred)):
        return _target_names(t.value)
    # NOT ast.Attribute: `self.stats = <tainted>` must not taint every
    # later read through `self`
    if isinstance(t, (ast.Tuple, ast.List)):
        out: set[str] = set()
        for e in t.elts:
            out |= _target_names(e)
        return out
    return set()


def _outer_funcs(tree) -> list:
    """Functions not nested inside another function (methods included);
    each is one taint scope, its nested defs are closures within it."""
    out: list = []

    def visit(node, in_func):
        for child in ast.iter_child_nodes(node):
            is_fn = isinstance(child, (ast.FunctionDef,
                                       ast.AsyncFunctionDef))
            if is_fn and not in_func:
                out.append(child)
            visit(child, in_func or is_fn)

    visit(tree, False)
    return out


def _tainted_names(func) -> set[str]:
    """Names within one function scope whose value derives from a
    Reply.TIMEOUT comparison, via assignments, |= folds, and
    np.logical_or.at(dst, idx, src) accumulations."""
    stmts = [n for n in ast.walk(func)
             if isinstance(n, (ast.Assign, ast.AugAssign, ast.Expr))]
    stmts.sort(key=lambda n: n.lineno)
    tainted: set[str] = set()

    def _expr_tainted(e) -> bool:
        return _mentions_timeout(e) or bool(_names_in(e) & tainted)

    for _ in range(4):
        before = len(tainted)
        for st in stmts:
            if isinstance(st, ast.Assign):
                if _expr_tainted(st.value):
                    for t in st.targets:
                        tainted |= _target_names(t)
            elif isinstance(st, ast.AugAssign):
                if _expr_tainted(st.value):
                    tainted |= _target_names(st.target)
            elif isinstance(st.value, ast.Call):
                call = st.value
                fn = call.func
                if isinstance(fn, ast.Attribute) and fn.attr == "at" \
                        and call.args \
                        and any(_expr_tainted(a) for a in call.args[1:]):
                    tainted |= _target_names(call.args[0])
        if len(tainted) == before:
            break
    return tainted


def in_doubt_violations(src: str) -> list[tuple[str, int]]:
    """The three in-doubt obligations of a wire-coordinator source, as
    (message, lineno) violations (the reference's function, whose tests
    mutate a client source and expect the same answers).

    (a) TIMEOUT outcomes are detected: some Compare involves
        Reply.TIMEOUT.
    (b) they flow into the survivor mask: taint from Reply.TIMEOUT
        reaches the name `alive` through assignments, |= folds, and
        np.logical_or.at(dst, idx, src) accumulations.
    (c) an Op.ABORT wave exists to release the dead/doubted txns' locks.
    """
    tree = ast.parse(src)
    out: list[tuple[str, int]] = []

    has_cmp = any(isinstance(n, ast.Compare)
                  and (_mentions_timeout(n))
                  for n in ast.walk(tree))
    if not has_cmp:
        out.append(("TIMEOUT replies are never tested for (no compare "
                    "against Reply.TIMEOUT): lost commit acks are "
                    "indistinguishable from successes", 1))

    # per-function statement-order taint to a fixpoint: local names
    # collide across unrelated functions, so each outermost function is
    # its own scope (nested defs are closures and share the enclosing
    # names); source loops are textual, a few rounds close them
    alive_tainted = any("alive" in _tainted_names(fn)
                        for fn in _outer_funcs(tree))

    if has_cmp and not alive_tainted:
        out.append(("TIMEOUT outcomes never reach the `alive` survivor "
                    "mask (directly or via the in-doubt fold): a txn "
                    "with a lost commit ack is counted committed — the "
                    "silent-commit path in-doubt handling exists to "
                    "close", 1))

    has_abort = any(isinstance(n, ast.Attribute) and n.attr == "ABORT"
                    and isinstance(n.value, ast.Name)
                    and n.value.id == "Op"
                    for n in ast.walk(tree))
    if not has_abort:
        out.append(("no Op.ABORT wave in the coordinator: dead and "
                    "in-doubt txns' granted locks are never released",
                    1))
    return out


def _in_doubt_totality(trace: TargetTrace) -> list[Finding]:
    rel = _CLIENT_SOURCES.get(trace.name)
    if not rel:
        return []
    pkg = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.path.join(pkg, rel)
    try:
        with open(path) as f:
            src = f.read()
    except OSError as e:
        return [Finding(
            "durability", "in-doubt-totality", SEV_ERROR, trace.name,
            f"coordinator source {rel} unreadable ({e}): the in-doubt "
            "contract cannot be checked",
            suggestion="update _CLIENT_SOURCES in passes/durability.py "
                       "if the client moved")]
    return [Finding(
        "durability", "in-doubt-totality", SEV_ERROR, trace.name, msg,
        site=f"dint_tpu_torch/{rel}:{ln}",
        suggestion="classify Reply.TIMEOUT lanes first, fold them into "
                   "the in-doubt set (np.logical_or.at over the txn "
                   "ids), drop doubted txns from alive, and release "
                   "their locks with an Op.ABORT wave — "
                   "clients/tatp_client.py's commit-wave block is the "
                   "reference shape")
        for msg, ln in in_doubt_violations(src)]


# ---------------------------------------------------------------- pass


@register_pass("durability")
def durability(trace: TargetTrace) -> list[Finding]:
    """Proves log-before-visible, ring bounds, replay coverage and in-doubt
    totality (the dintdur gate)."""
    out = _in_doubt_totality(trace)
    if trace.gm is None:
        return out                   # the purity pass owns trace failures
    flags = set(getattr(trace, "protocol", None) or ())
    if FLAG_REPLAY in flags:
        out += _replay_side(trace)
    if FLAG_DURABLE not in flags:
        return out
    flow = df.analyze(trace)
    out += _wal_order(trace, flow)
    out += _quorum_unchecked(trace, flags)
    out += _ring_bounds(trace, flow)
    out += _replay_twin_coverage(trace, flow)
    return out
