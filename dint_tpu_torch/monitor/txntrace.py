"""dinttrace assembler: join drained event rings into per-txn span trees
(a copy of `dint_tpu.monitor.txntrace` over the port's `txnevents` and
`waves`).

The device half (monitor/txnevents.py) lands fixed-width u32 records in an
event ring; TxnMonitor drains them to JSONL. This module is the host half
that makes the stream narrate: it decodes the packed words, groups events
by transaction id across windows, devices, and shards, and nests them into
a span tree — route -> owner-side lock -> vote -> install -> replication
hops -> outcome. It reads the same JSONL as the JAX module, so streams of
either package decode alike.

Join key discipline: a txn id is a pure function of (generation step,
source device, lane), identical on every shard that touches the txn. Ids
recycle only across stamp-rebase epochs (~16k steps on tatp_dense): a
window never spans a rebase.

``python -m dint_tpu_torch.dinttrace`` is the CLI (summarize / show /
slowest / aborts / export / synth); the Perfetto export lands the spans on
their own pid row so a dintmon export and a dinttrace export load into ONE
timeline view.
"""
from __future__ import annotations

import json

from . import txnevents as txe
from . import waves

# nesting rank: parents sort before children at equal step
_KIND_RANK = {
    txe.EV_ROUTE: 0, txe.EV_LOCK: 1, txe.EV_VALIDATE: 2, txe.EV_VOTE: 3,
    txe.EV_INSTALL: 4, txe.EV_REPL: 5, txe.EV_OUTCOME: 6,
}

# the dinttrace export's process row: distinct from the dintmon wave row
# (pid 1000) and profiler device rows, so merged views never interleave
EXPORT_PID = 2000


def read_trace(path: str) -> tuple[dict, list[dict]]:
    """Parse a TxnMonitor JSONL stream -> (meta, txnevents records).
    Unknown record types are skipped (forward compatibility)."""
    meta: dict = {}
    records: list[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if rec.get("type") == "txnmeta":
                meta = rec
            elif rec.get("type") == "txnevents":
                records.append(rec)
    return meta, records


def decode_records(meta: dict, records: list[dict]) -> list[dict]:
    """Flatten txnevents records into decoded event dicts."""
    wave_names = meta.get("waves") or list(waves.ALL_WAVES)
    out = []
    for rec in records:
        for w0, w1, w2, w3 in rec.get("events", []):
            kind, wave_ord, shard, aux = txe.unpack_w1(w1)
            out.append({
                "txn": int(w0), "kind": kind,
                "kind_name": txe.KIND_NAMES.get(kind, f"kind{kind}"),
                "wave": (wave_names[wave_ord]
                         if wave_ord < len(wave_names) else f"w{wave_ord}"),
                "shard": shard, "aux": aux, "step": int(w2),
                "lane": int(w3), "window": rec.get("window", 0),
                "device": rec.get("device", 0),
            })
    return out


def by_txn(events: list[dict]) -> dict[int, list[dict]]:
    """Group decoded events by txn id, each group in journey order."""
    groups: dict[int, list[dict]] = {}
    for e in events:
        groups.setdefault(e["txn"], []).append(e)
    for g in groups.values():
        g.sort(key=lambda e: (e["window"], e["step"],
                              _KIND_RANK.get(e["kind"], 9), e["device"],
                              e["lane"]))
    return groups


def _outcome_of(group: list[dict]) -> str | None:
    causes = [e["aux"] for e in group if e["kind"] == txe.EV_OUTCOME]
    if not causes:
        return None
    # the LAST classification wins (tatp classifies twice: wave-1 lock/
    # missing verdicts, wave-2 validate verdict — an id that survives
    # wave 1 is re-classified at wave 2)
    return txe.CAUSE_NAMES.get(causes[-1], f"cause{causes[-1]}")


def _label(e: dict) -> str:
    k, aux = e["kind"], e["aux"]
    base = f"{e['kind_name']} step={e['step']} shard={e['shard']}"
    if k == txe.EV_ROUTE:
        dest = aux & ~txe.ROUTE_DCN
        return base + f" dest={dest}" + (
            " [dcn]" if aux & txe.ROUTE_DCN else "")
    if k == txe.EV_LOCK:
        if aux & txe.LOCK_GRANTED:
            return base + " granted"
        return base + (" rejected(held)" if aux & txe.LOCK_HELD
                       else " rejected(arb)")
    if k == txe.EV_VALIDATE:
        return base + (" failed" if aux else " ok")
    if k == txe.EV_VOTE:
        return base + (" commit" if aux else " abort")
    if k == txe.EV_REPL:
        return f"repl hop={aux} step={e['step']} shard={e['shard']}"
    if k == txe.EV_OUTCOME:
        return base + " " + txe.CAUSE_NAMES.get(aux, f"cause{aux}")
    return base


def span_tree(txn: int, group: list[dict]) -> dict:
    """Nest one txn's events: ROUTE spans parent the owner-side work
    (lock/validate/vote/install), REPL hops hang off their install (or
    route), OUTCOME classifications stay top-level. Single-shard engines
    have no ROUTE, so their spans are a flat chronology."""
    spans: list[dict] = []
    last_route: dict | None = None
    last_install: dict | None = None
    for e in group:
        node = {**e, "label": _label(e), "children": []}
        k = e["kind"]
        if k == txe.EV_ROUTE:
            last_route = node
            spans.append(node)
        elif k == txe.EV_REPL:
            (last_install or last_route or {"children": spans})[
                "children"].append(node)
        elif k == txe.EV_OUTCOME or last_route is None:
            spans.append(node)
        else:
            if k == txe.EV_INSTALL:
                last_install = node
            last_route["children"].append(node)
    return {"txn": txn, "outcome": _outcome_of(group),
            "events": len(group), "spans": spans}


def format_tree(tree: dict) -> str:
    """Render a span tree as indented text (the `show` subcommand)."""
    lines = [f"txn {tree['txn']}"
             + (f"  [{tree['outcome']}]" if tree["outcome"] else "")]

    def walk(nodes: list[dict], prefix: str):
        for i, n in enumerate(nodes):
            last = i == len(nodes) - 1
            branch = "└─ " if last else "├─ "
            lines.append(prefix + branch + n["label"])
            walk(n["children"], prefix + ("   " if last else "│  "))

    walk(tree["spans"], "")
    return "\n".join(lines)


def summarize(meta: dict, records: list[dict]) -> dict:
    """Stream-level rollup: event totals by kind, outcome totals by
    cause, and the overflow report (windows that dropped events)."""
    events = decode_records(meta, records)
    by_kind: dict[str, int] = {}
    outcomes: dict[str, int] = {}
    for e in events:
        by_kind[e["kind_name"]] = by_kind.get(e["kind_name"], 0) + 1
        if e["kind"] == txe.EV_OUTCOME:
            name = txe.CAUSE_NAMES.get(e["aux"], f"cause{e['aux']}")
            outcomes[name] = outcomes.get(name, 0) + 1
    dropped = sum(r.get("dropped", 0) for r in records)
    drop_windows = sorted({r["window"] for r in records
                           if r.get("dropped")})
    return {
        "schema": meta.get("schema", txe.SCHEMA),
        "rate": meta.get("rate"), "cap": meta.get("cap"),
        "windows": len({r["window"] for r in records}),
        "devices": len({r["device"] for r in records}),
        "events": len(events), "txns": len({e["txn"] for e in events}),
        "by_kind": dict(sorted(by_kind.items())),
        "outcomes": dict(sorted(outcomes.items())),
        "dropped": dropped, "dropped_windows": drop_windows,
    }


def slowest(groups: dict[int, list[dict]], n: int = 10) -> list[dict]:
    """Txns ranked by step span (last event step - first), the wave-clock
    proxy for latency: a span > the pipeline depth means the txn's
    effects (installs, replication) trailed its classification."""
    rows = []
    for txn, g in groups.items():
        steps = [e["step"] for e in g]
        rows.append({"txn": txn, "span": max(steps) - min(steps),
                     "first_step": min(steps), "last_step": max(steps),
                     "events": len(g), "outcome": _outcome_of(g)})
    rows.sort(key=lambda r: (-r["span"], -r["events"], r["txn"]))
    return rows[:n]


def aborts(groups: dict[int, list[dict]],
           by_cause: bool = False) -> dict:
    """Aborted txns (final classification != commit); ``by_cause`` folds
    them into the dintmon ab_* taxonomy with example txn ids."""
    rows = [{"txn": txn, "cause": oc,
             "events": len(g),
             "step": max(e["step"] for e in g
                         if e["kind"] == txe.EV_OUTCOME)}
            for txn, g in groups.items()
            for oc in [_outcome_of(g)]
            if oc not in (None, "commit")]
    rows.sort(key=lambda r: (r["cause"], r["txn"]))
    if not by_cause:
        return {"aborted": len(rows), "txns": rows}
    causes: dict[str, dict] = {}
    for r in rows:
        c = causes.setdefault(r["cause"], {"count": 0, "examples": []})
        c["count"] += 1
        if len(c["examples"]) < 5:
            c["examples"].append(r["txn"])
    return {"aborted": len(rows), "by_cause": causes}


# ------------------------------------------------------------ perfetto


def export_trace_events(meta: dict, records: list[dict], out_path: str,
                        merge: str | None = None,
                        offset_us: float | None = None) -> int:
    """Write the event stream as Chrome trace-event JSON: one complete
    ("X") slice per event on pid EXPORT_PID, one tid row per shard, with
    a synthetic wave clock (1 ms per step, events at a step spread by
    nesting rank) — the step axis IS the engine's notion of time.

    ``merge``: another Chrome trace (a `dintmon export-trace [--merge]`
    output, or a raw profiler trace/dir) whose events are copied into the
    same file; our clock is shifted so the first span lands at the merged
    stream's earliest slice, which pins the two step-0 origins together
    (override with ``offset_us``). The distinct pid keeps the txn spans
    on their own Perfetto row group."""
    events = decode_records(meta, records)
    shift = 0.0
    merged: list[dict] = []
    if merge is not None:
        from . import attrib

        merged, _src = attrib.load_trace_events(merge)
        ts0 = min((float(e["ts"]) for e in merged
                   if e.get("ph") == "X" and "ts" in e), default=0.0)
        if offset_us is not None:
            shift = float(offset_us)
        elif events:
            first = min(e["step"] for e in events)
            shift = ts0 - first * 1000.0
    out = [{"name": "process_name", "ph": "M", "pid": EXPORT_PID,
            "args": {"name": "dinttrace txn spans"}}]
    for shard in sorted({e["shard"] for e in events}):
        out.append({"name": "thread_name", "ph": "M", "pid": EXPORT_PID,
                    "tid": shard, "args": {"name": f"shard {shard}"}})
    for e in events:
        ts = e["step"] * 1000.0 + _KIND_RANK.get(e["kind"], 9) * 100.0
        out.append({
            "name": f"txn {e['txn']} {e['kind_name']}", "ph": "X",
            "pid": EXPORT_PID, "tid": e["shard"],
            "ts": round(ts + shift, 3), "dur": 90.0,
            "args": {"txn": e["txn"], "label": _label(e),
                     "wave": e["wave"], "window": e["window"],
                     "device": e["device"], "lane": e["lane"]}})
    out.extend(merged)
    with open(out_path, "w") as f:
        json.dump({"traceEvents": out, "displayTimeUnit": "ms"}, f)
    return len(out)


# ------------------------------------------------------------- fixture


def _pack(kind: int, wave: str, shard: int, aux: int, waves_list) -> int:
    return ((kind << 24) | (waves_list.index(wave) << 16)
            | ((shard & 0xFF) << 8) | (aux & 0xFF))


def synthesize_events(out_path: str) -> int:
    """Write a deterministic synthetic dinttrace stream: three txn
    journeys over a 2-shard mesh — a cross-shard commit (route -> owner
    lock -> vote -> install -> both replication hops), a lock abort, and
    a validate abort — plus a second window that overflowed (dropped=3).
    No clocks, no randomness: the JAX package's copy built the checked-in
    fixture (tests/fixtures/dinttrace_events.jsonl), which this one
    reproduces record for record. Returns the number of JSONL records
    written."""
    wl = list(waves.ALL_WAVES)
    rt = "dint.dense_sharded_sb.route"
    arb = "dint.dense_sharded_sb.arbitrate"
    rep = "dint.dense_sharded_sb.reply"
    ins = "dint.dense_sharded_sb.install_route"
    rpl = "dint.dense_sharded_sb.replicate"

    def e(txn, kind, wave, shard, aux, step, lane):
        return [txn, _pack(kind, wave, shard, aux, wl), step, lane]

    win0_dev0 = [  # source-side view of txn 101 (commit) and 103
        e(101, txe.EV_ROUTE, rt, 0, 1, 5, 0),
        e(101, txe.EV_VOTE, rep, 0, 1, 5, 0),
        e(101, txe.EV_OUTCOME, rep, 0, txe.CAUSE_COMMIT, 5, 0),
        e(103, txe.EV_ROUTE, rt, 0, 1 | txe.ROUTE_DCN, 5, 2),
        e(103, txe.EV_VOTE, rep, 0, 0, 5, 2),
        e(103, txe.EV_OUTCOME, rep, 0, txe.CAUSE_LOCK, 5, 2),
    ]
    win0_dev1 = [  # owner-side view: locks, install, replication hops
        e(101, txe.EV_LOCK, arb, 1, txe.LOCK_GRANTED, 5, 0),
        e(103, txe.EV_LOCK, arb, 1, txe.LOCK_HELD, 5, 2),
        e(101, txe.EV_INSTALL, ins, 1, 0, 6, 0),
        e(101, txe.EV_REPL, rpl, 0, 1, 6, 0),
        e(101, txe.EV_REPL, rpl, 1, 2, 6, 0),
    ]
    win1_dev0 = [  # a dense-engine validate abort in the next window
        e(205, txe.EV_LOCK, "dint.tatp_dense.lock", 0,
          txe.LOCK_GRANTED, 9, 1),
        e(205, txe.EV_VALIDATE, "dint.tatp_dense.meta_gather", 0, 1,
          10, 1),
        e(205, txe.EV_OUTCOME, "dint.tatp_dense.meta_gather", 0,
          txe.CAUSE_VALIDATE, 10, 1),
    ]
    cap = 8
    recs = [
        {"type": "txnmeta", "schema": txe.SCHEMA, "rate": 1.0,
         "cap": cap, "waves": wl, "name": "synthetic"},
        {"type": "txnevents", "window": 0, "device": 0,
         "head": len(win0_dev0), "cap": cap, "dropped": 0,
         "events": win0_dev0},
        {"type": "txnevents", "window": 0, "device": 1,
         "head": len(win0_dev1), "cap": cap, "dropped": 0,
         "events": win0_dev1},
        {"type": "txnevents", "window": 1, "device": 0,
         "head": len(win1_dev0) + 3, "cap": cap, "dropped": 3,
         "events": win1_dev0},
    ]
    with open(out_path, "w") as f:
        for rec in recs:
            f.write(json.dumps(rec) + "\n")
    return len(recs)
