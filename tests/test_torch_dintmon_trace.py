"""The port's host trace layer (dint_tpu_torch.monitor.trace), its span
assembler (monitor.txntrace) and the dintmon / dinttrace CLIs against
`dint_tpu.monitor.trace`, `.txntrace` and tools/dinttrace.py's logic on
the CPU, and the bench's dinttrace knob.

The wave-event stream of a monitored run is written by both packages'
`TraceWriter`/`Monitor` from the same counter snapshots and read back
alike; the deferred drain gives the synchronous deltas. The span
assembler and the dinttrace CLI give JAX's answers on JAX's checked-in
fixture tests/fixtures/dinttrace_events.jsonl (read, never written).
`profiler_session` is a no-op with no directory, writes one
``*.pt.trace.json`` the attribution finds, and raises when it cannot."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from dint_tpu.monitor import trace as jtr
from dint_tpu.monitor import txntrace as jtt
from dint_tpu_torch import bench, dintmon, dinttrace
from dint_tpu_torch.engines import smallbank_dense as sd
from dint_tpu_torch.monitor import (Monitor, TraceWriter, attrib,
                                    export_chrome_trace, profiler_session,
                                    read_events)
from dint_tpu_torch.monitor import counters as ctr
from dint_tpu_torch.monitor import trace as tr
from dint_tpu_torch.monitor import txntrace as tt

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "fixtures" / "dinttrace_events.jsonl"
TINY = {"DINT_BENCH_SUBSCRIBERS": "2000", "DINT_BENCH_WIDTH": "256",
        "DINT_BENCH_BLOCK": "4", "DINT_BENCH_WINDOW_S": "0.2",
        "DINT_BENCH_SKIP_SB": "1"}


@pytest.fixture(scope="module")
def counter_blocks():
    """The counter buffers after each of 4 blocks of a monitored
    SmallBank runner (clones), and the blocks' batch size."""
    run, init, _ = sd.build_pipelined_runner(
        400, w=64, cohorts_per_block=2, monitor=True, device="cpu")
    carry = init(sd.create(400, device="cpu"))
    bufs = []
    for i in range(4):
        carry, _ = run(carry, torch.Generator().manual_seed(i))
        bufs.append(carry[-1].buf.clone())
    return bufs, 64 * 2


def test_monitor_stream_matches_jax(counter_blocks, tmp_path):
    bufs, batch = counter_blocks
    paths = {}
    for name, pkg in (("port", tr), ("jax", jtr)):
        paths[name] = tmp_path / f"{name}.jsonl"
        writer = pkg.TraceWriter(str(paths[name]), meta={"name": "t"})
        mon = pkg.Monitor(writer)
        for b in bufs:
            mon.observe(b.numpy() if pkg is jtr else b, batch=batch,
                        dur_s=0.5)
        writer.close()
        paths[name + "_totals"] = mon.totals
    assert paths["port_totals"] == paths["jax_totals"]
    pm, pw = read_events(str(paths["port"]))
    jm, jw = jtr.read_events(str(paths["jax"]))
    assert pm == jm and len(pw) == len(jw) == 4
    strip = [{k: v for k, v in w.items() if k != "t"} for w in pw]
    assert strip == [{k: v for k, v in w.items() if k != "t"} for w in jw]
    assert tr.summarize_events(pm, pw) == jtr.summarize_events(jm, jw)
    assert pw[-1]["counters"]["txn_attempted"] > 0


def test_deferred_deltas_equal_the_synchronous_ones(counter_blocks):
    bufs, batch = counter_blocks
    sync, deferred = Monitor(), Monitor()
    sync_d, def_d = [], []
    for b in bufs:
        live = b.clone()
        sync_d.append(sync.observe(ctr.Counters(buf=live), batch=batch))
        d = deferred.observe(ctr.Counters(buf=live), batch=batch,
                             defer=True)
        live.fill_(7)     # the carry's buffer moves on; the copy does not
        if d is not None:
            def_d.append(d)
    def_d.append(deferred.flush())
    assert deferred.flush() is None
    assert def_d == sync_d and sync.totals == deferred.totals


def test_export_chrome_trace_matches_jax(counter_blocks, tmp_path):
    bufs, batch = counter_blocks
    path = tmp_path / "run.jsonl"
    with TraceWriter(str(path), meta={"name": "t"}) as w:
        mon = Monitor(w)
        for b in bufs:
            mon.observe(b, batch=batch, dur_s=0.25)
    synth = tmp_path / "synth.pt.trace.json"
    attrib.synthesize_trace(str(synth), steps=1)
    for merge in (None, str(synth)):
        a, b = tmp_path / "a.json", tmp_path / "b.json"
        n = export_chrome_trace(str(path), str(a), merge_trace=merge)
        assert n == jtr.export_chrome_trace(str(path), str(b),
                                            merge_trace=merge)
        assert json.loads(a.read_text()) == json.loads(b.read_text())


def test_profiler_session(tmp_path):
    with profiler_session(None) as info:
        torch.ones(3).add_(1)
    assert info == {"trace_dir": None, "trace": None}
    with profiler_session(str(tmp_path / "prof")) as info:
        torch.ones(3).add_(1)
    assert info["trace"].endswith(".pt.trace.json")
    assert attrib.find_trace_file(str(tmp_path / "prof")) == info["trace"]
    events, _ = attrib.load_trace_events(info["trace"])
    assert any(e.get("cat") == "cpu_op" for e in events)
    # a directory that cannot be made: the session raises, nothing is
    # swallowed into the record
    blocker = tmp_path / "file"
    blocker.write_text("x")
    with pytest.raises(OSError):
        with profiler_session(str(blocker / "sub")):
            pass


# ------------------------------------------------- txntrace and its CLI


def _stream():
    return tt.read_trace(str(FIXTURE)), jtt.read_trace(str(FIXTURE))


def test_txntrace_gives_jax_results_on_the_fixture(tmp_path):
    (meta, recs), (jmeta, jrecs) = _stream()
    assert (meta, recs) == (jmeta, jrecs)
    events = tt.decode_records(meta, recs)
    assert events == jtt.decode_records(jmeta, jrecs)
    groups, jgroups = tt.by_txn(events), jtt.by_txn(events)
    assert groups == jgroups
    for txn, g in groups.items():
        tree = tt.span_tree(txn, g)
        assert tree == jtt.span_tree(txn, g)
        assert tt.format_tree(tree) == jtt.format_tree(tree)
    assert tt.summarize(meta, recs) == jtt.summarize(meta, recs)
    assert tt.slowest(groups, n=5) == jtt.slowest(groups, n=5)
    for by_cause in (False, True):
        assert tt.aborts(groups, by_cause) == jtt.aborts(groups, by_cause)
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    assert tt.export_trace_events(meta, recs, str(a)) == \
        jtt.export_trace_events(meta, recs, str(b))
    assert a.read_text() == b.read_text()
    fresh = tmp_path / "synth.jsonl"
    tt.synthesize_events(str(fresh))
    assert fresh.read_text() == FIXTURE.read_text()


def test_dinttrace_cli_gives_jax_results(tmp_path, capsys):
    (meta, recs), _ = _stream()
    groups = jtt.by_txn(jtt.decode_records(meta, recs))

    def run(*argv):
        rc = dinttrace.main(list(argv))
        return rc, capsys.readouterr().out

    rc, out = run("summarize", str(FIXTURE), "--json")
    assert rc == 0 and json.loads(out) == jtt.summarize(meta, recs)
    rc, out = run("show", str(FIXTURE), "101", "--json")
    assert rc == 0 and json.loads(out) == jtt.span_tree(101, groups[101])
    rc, out = run("show", str(FIXTURE), "101")
    assert rc == 0 and out.strip() == jtt.format_tree(
        jtt.span_tree(101, groups[101]))
    assert run("show", str(FIXTURE), "999")[0] == 1
    rc, out = run("slowest", str(FIXTURE), "-n", "2", "--json")
    assert json.loads(out) == {"slowest": jtt.slowest(groups, n=2)}
    rc, out = run("aborts", str(FIXTURE), "--by-cause", "--json")
    assert json.loads(out) == jtt.aborts(groups, by_cause=True)
    rc, out = run("export", str(FIXTURE), "-o", str(tmp_path / "x.json"),
                  "--json")
    assert rc == 0 and json.loads(out)["events"] > 0
    rc, out = run("summarize", str(FIXTURE))
    assert rc == 0 and "OVERFLOW: 3 event(s)" in out
    assert run("synth", "-o", str(tmp_path / "s.jsonl"))[0] == 0
    assert run("summarize", str(tmp_path / "missing.jsonl"))[0] == 2


def test_dintmon_cli_subcommands(counter_blocks, tmp_path, capsys):
    bufs, batch = counter_blocks
    a, b = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    for path, blocks in ((a, bufs), (b, bufs[:2])):
        with TraceWriter(str(path)) as w:
            mon = Monitor(w)
            for buf in blocks:
                mon.observe(buf, batch=batch, dur_s=0.5)
    art = tmp_path / "bench.json"
    art.write_text(json.dumps({"counters": ctr.snapshot(bufs[-1]),
                               "window_s": 2.0, "throughput": 10.0}))

    def run(*argv):
        rc = dintmon.main(list(argv))
        return rc, capsys.readouterr().out

    rc, out = run("summarize", str(a), "--json")
    s = json.loads(out)
    assert rc == 0 and s["source"] == "jsonl" and s["waves"] == 4
    m, w = jtr.read_events(str(a))
    assert s["counters"] == jtr.summarize_events(m, w)["counters"]
    rc, out = run("summarize", str(art), "--json")
    assert rc == 0 and json.loads(out)["counters"] == ctr.snapshot(bufs[-1])
    assert run("summarize", str(a))[0] == 0
    rc, out = run("diff", str(b), str(a), "--json")
    assert rc == 0 and any(r["counter"] == "txn_attempted"
                           for r in json.loads(out)["rows"])
    rc, out = run("export-trace", str(a), "-o", str(tmp_path / "t.json"),
                  "--json")
    assert rc == 0 and json.loads(out)["events"] > 4
    rc, out = run("describe", "--json")
    assert rc == 0 and [c["name"] for c in json.loads(out)["counters"]] \
        == list(ctr.ALL_NAMES)
    assert run("summarize", str(tmp_path / "missing.jsonl"))[0] == 2


# ------------------------------------------------------- the bench knobs


def test_bench_prints_a_dinttrace_object(tmp_path, capsys):
    jsonl = tmp_path / "trace.jsonl"
    waves_jsonl = tmp_path / "waves.jsonl"
    line = bench.measure(env=dict(
        TINY, DINT_TRACE="1", DINT_TRACE_RATE="0.5",
        DINT_TRACE_JSONL=str(jsonl), DINT_MONITOR="1",
        DINT_MONITOR_JSONL=str(waves_jsonl)), device="cpu")
    d = line["dinttrace"]
    assert set(d) == {"schema", "rate", "cap", "windows", "events",
                      "dropped", "dropped_windows"}
    assert d["rate"] == 0.5 and d["windows"] == line["blocks"]
    assert d["events"] > 0 and d["dropped"] == 0
    assert line["counters"]["trace_dropped"] == 0
    assert line["breakdown"] is None
    assert dinttrace.main(["summarize", str(jsonl), "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["events"] == d["events"]
    _, wave_events = read_events(str(waves_jsonl))
    assert len(wave_events) == line["blocks"]


def test_bench_breakdown_raises_on_a_trace_with_no_device_event(tmp_path):
    # on the CPU the profiled block holds no kernel: the attribution
    # raises rather than print a breakdown of no device time
    with pytest.raises(ValueError, match="no device event"):
        bench.measure(env=dict(TINY, DINT_BENCH_PROFILE="1",
                               DINT_BENCH_TRACE_DIR=str(tmp_path / "t")),
                      device="cpu")
    assert list((tmp_path / "t").glob("*.pt.trace.json"))
