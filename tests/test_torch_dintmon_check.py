"""``python -m dint_tpu_torch.dintmon check``: the counter plane's four
ledger identities (the port of tools/dintmon.py's ``check``) on CPU
monitored snapshots of every engine family with a counter plane, and the
reference's rows on the same artifacts.

The generic pipelines split ``lock_rejected`` into ``lock_reject_held``
and ``lock_reject_arb`` (`monitor.counters.reject_split`); the
reference's leave both at 0, so its ledger identity fails on them."""
import contextlib
import importlib.util
import io
import json
from pathlib import Path

import pytest
import torch

from dint_tpu_torch import dintmon
from dint_tpu_torch import monitor as mn
from dint_tpu_torch.analysis import targets as T
from dint_tpu_torch.monitor import counters as ctr

REPO = Path(__file__).resolve().parents[1]
G = T.LINT


def _ref_cli():
    spec = importlib.util.spec_from_file_location(
        "dintmon_cli_ref", REPO / "tools" / "dintmon.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _gen():
    return torch.Generator().manual_seed(0)


def _occ(shape):
    return (torch.full(shape, G.w, dtype=torch.int32),
            torch.zeros(shape, dtype=torch.int32))


def _drained(run, init, drain, state, serve_shape=None):
    extra = _occ(serve_shape) if serve_shape else ()
    carry, _ = run(init(state), _gen(), *extra)
    return ctr.snapshot(drain(carry)[-1])


def _dense(engine, hot, fused, serve):
    from dint_tpu_torch.engines import smallbank_dense as sd
    from dint_tpu_torch.engines import tatp_dense as td
    if engine == "tatp_dense":
        r = td.build_pipelined_runner(
            G.n_sub, w=G.w, val_words=G.vw, cohorts_per_block=G.cpb,
            use_hotset=hot, use_fused=fused, monitor=True, serve=serve,
            device="cpu")
        db = td.create(G.n_sub, val_words=G.vw, log_capacity=G.logcap,
                       device="cpu")
    else:
        r = sd.build_pipelined_runner(
            G.n_acct, w=G.w, cohorts_per_block=G.cpb, use_hotset=hot,
            use_fused=fused, monitor=True, serve=serve, device="cpu")
        db = sd.create(G.n_acct, log_capacity=G.logcap, device="cpu")
    return _drained(*r, db, (G.cpb,) if serve else None)


def _store(scan):
    from dint_tpu_torch.engines import store
    from dint_tpu_torch.tables import kv
    r = store.build_serve_runner(
        G.n_acct, w=G.w, cohorts_per_block=G.cpb, val_words=G.vw,
        scan_frac=0.5 if scan else 0.0, max_scan_len=G.st_smax,
        scan_max=G.st_smax, delta_cap=G.st_dcap, use_scan=scan,
        monitor=True, device="cpu")
    return _drained(*r, kv.create(G.st_nb, val_words=G.vw, device="cpu"))


def _tatp_pipeline():
    from dint_tpu_torch.engines import tatp
    from dint_tpu_torch.engines import tatp_pipeline as tp
    from test_torch_tatp_generic_pipe import CONTENTION
    r = tp.build_pipelined_runner(G.n_sub, w=G.w, val_words=G.vw,
                                  cohorts_per_block=G.cpb, mix=CONTENTION[3],
                                  monitor=True, device="cpu")
    return _drained(*r, tp.stack_shards([tatp.create(
        G.n_sub, val_words=G.vw, cf_buckets=256, cf_lock_slots=256,
        log_capacity=G.logcap, device="cpu") for _ in range(tp.N_SHARDS)]))


def _sb_pipeline():
    from dint_tpu_torch.engines import smallbank_pipeline as sp
    run = sp.build_runner(G.n_acct, w=G.w, cohorts_per_block=G.cpb,
                          monitor=True, device="cpu")
    (_, cnt), _ = run((sp.create_stacked(G.n_acct, log_capacity=G.logcap,
                                         device="cpu"), mn.create("cpu")),
                      _gen())
    return ctr.snapshot(cnt)


def _sharded(engine, hot=False, fused=False):
    from dint_tpu_torch.parallel import dense_sharded as ds
    from dint_tpu_torch.parallel import dense_sharded_sb as dsb
    from dint_tpu_torch.parallel import sharded
    d = G.shards
    mesh = sharded.make_mesh(d, "cpu")
    if engine == "dense_sharded":
        r = ds.build_sharded_pipelined_runner(
            mesh, d, G.n_sub * d, w=G.w, val_words=G.vw,
            cohorts_per_block=G.cpb, use_fused=fused, monitor=True)
        st = ds.create_sharded(mesh, d, G.n_sub * d, val_words=G.vw,
                               log_capacity=G.logcap)
    else:
        r = dsb.build_sharded_sb_runner(
            mesh, d, G.n_acct * d, w=G.w, cohorts_per_block=G.cpb,
            use_hotset=hot, use_fused=fused, monitor=True)
        st = dsb.create_sharded_sb(mesh, d, G.n_acct * d,
                                   log_capacity=G.logcap * 8)
    return _drained(*r, st)


def _multihost(hier, serve, overlap):
    from dint_tpu_torch.parallel import multihost_sb as mhs
    mesh = mhs.make_mesh_2d(G.hosts, G.chips, "cpu")
    n = G.n_acct * G.hosts * G.chips
    r = mhs.build_multihost_sb_runner(
        mesh, n, w=G.w, cohorts_per_block=G.cpb, hierarchical=hier,
        monitor=True, serve=serve, overlap=overlap)
    return _drained(*r, mhs.create_multihost_sb(mesh, n,
                                                log_capacity=G.logcap * 8),
                    (G.hosts, G.chips, G.cpb) if serve else None)


def _serve(engine):
    from dint_tpu_torch import serve
    if engine == "mesh":
        eng = serve.MeshServeEngine(
            G.n_acct * 6, mesh_shape=(3, 2),
            cfg=serve.ControllerCfg(widths=(8, G.w)),
            cohorts_per_block=2, clock=serve.VirtualClock(), monitor=True,
            device="cpu")
    else:
        eng = serve.ServeEngine(
            engine, 400, cfg=serve.ControllerCfg(widths=(8, G.w)),
            cohorts_per_block=2, clock=serve.VirtualClock(), monitor=True,
            device="cpu")
    eng.run(serve.poisson_schedule(200_000.0, 0.004, seed=1))
    eng.close()
    return eng.snapshot()["counters"]


FAMILIES = {
    **{f"{e} hot={h} fused={f}": (lambda e=e, h=h, f=f: _dense(e, h, f,
                                                               False))
       for e in ("tatp_dense", "smallbank_dense")
       for h in (False, True) for f in (False, True)},
    "tatp_dense serve": lambda: _dense("tatp_dense", False, False, True),
    "smallbank_dense serve": lambda: _dense("smallbank_dense", False, True,
                                            True),
    "store point": lambda: _store(False),
    "store scan": lambda: _store(True),
    "tatp_pipeline": _tatp_pipeline,
    "smallbank_pipeline": _sb_pipeline,
    "dense_sharded": lambda: _sharded("dense_sharded"),
    "dense_sharded fused": lambda: _sharded("dense_sharded", fused=True),
    "dense_sharded_sb": lambda: _sharded("dense_sharded_sb"),
    "dense_sharded_sb fused+hot": lambda: _sharded("dense_sharded_sb",
                                                   hot=True, fused=True),
    "multihost_sb hierarchical": lambda: _multihost(True, False, False),
    "multihost_sb flat": lambda: _multihost(False, False, False),
    "multihost_sb serve overlap": lambda: _multihost(True, True, True),
    "serve tatp_dense": lambda: _serve("tatp_dense"),
    "serve smallbank_dense": lambda: _serve("smallbank_dense"),
    "serve store": lambda: _serve("store"),
    "serve mesh": lambda: _serve("mesh"),
}
MESH = ("multihost_sb", "serve mesh")


@pytest.fixture(scope="module")
def snaps():
    return {name: fn() for name, fn in FAMILIES.items()}


def _cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _artifact(tmp_path, name, counters):
    p = tmp_path / f"{name.replace(' ', '_')}.json"
    p.write_text(json.dumps({"counters": counters, "window_s": 1.0}))
    return str(p)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_identities_hold_on_every_family(snaps, name, tmp_path):
    c = snaps[name]
    ok, rows = dintmon.check_identities(c)
    assert ok and c["steps"] > 0, rows
    status = {r["identity"].split(" ")[0]: r["status"] for r in rows}
    # the route split exists only on the 2-D mesh
    assert (status["route_ici_lanes"] == "ok") == name.startswith(MESH)
    # the store takes no locks: its lock identities hold at 0
    assert (c["lock_requests"] > 0) == ("store" not in name)
    rc, out = _cli(dintmon.main, ["check", _artifact(tmp_path, name, c)])
    assert rc == 0 and out.strip().endswith("dintmon check: ok")


def test_the_generic_pipelines_split_their_rejects(snaps):
    for name in ("tatp_pipeline", "smallbank_pipeline"):
        c = snaps[name]
        assert c["lock_rejected"] > 0
        assert c["lock_reject_held"] + c["lock_reject_arb"] == \
            c["lock_rejected"]
        assert c["dispatch_xla"] == c["steps"] and c["dispatch_pallas"] == 0
    # a rejected lane whose key a lane of the batch won lost arbitration;
    # any other found the lock held
    rej = torch.tensor([True, True, False, True])
    won = torch.tensor([False, False, True, False])
    tbl = torch.tensor([0, 1, 0, 1], dtype=torch.int32)
    key = torch.tensor([7, 7, 7, -1], dtype=torch.int32)
    held, arb = ctr.reject_split(rej, won, tbl, key)
    assert (int(held), int(arb)) == (2, 1)


MUTATIONS = {
    "lock_requests == lock_granted + lock_rejected": ("lock_granted", 1),
    "lock_rejected == lock_reject_held + lock_reject_arb":
        ("lock_reject_arb", 1),
    "steps == dispatch_xla + dispatch_pallas": ("dispatch_pallas", 1),
    "route_ici_lanes + route_dcn_lanes == lock_requests + install_writes":
        ("route_dcn_lanes", 1),
}


@pytest.mark.parametrize("identity", list(MUTATIONS))
def test_a_mutated_snapshot_fails_naming_its_identity(snaps, identity,
                                                      tmp_path):
    c = dict(snaps["multihost_sb hierarchical"])
    name, bump = MUTATIONS[identity]
    c[name] += bump
    ok, rows = dintmon.check_identities(c)
    assert not ok
    assert [r["identity"] for r in rows if r["status"] == "violated"] == \
        [identity]
    rc, out = _cli(dintmon.main, ["check", _artifact(tmp_path, "bad", c)])
    assert rc == 1 and out.strip().endswith(f"violated: {identity}")


def test_rows_equal_the_references_on_the_same_artifacts(snaps, tmp_path):
    ref = _ref_cli()
    c = dict(snaps["smallbank_dense hot=False fused=False"])
    bad = dict(c, steps=c["steps"] + 1)
    for name, counters in (("good", c), ("bad", bad),
                           ("mesh", snaps["multihost_sb flat"])):
        path = _artifact(tmp_path, name, counters)
        for extra in ([], ["--json"]):
            rc, out = _cli(dintmon.main, ["check", path, *extra])
            jrc, jout = _cli(ref.main, ["check", path, *extra])
            assert rc == jrc and out == jout, name
    # monitoring off: exit 1 on both, no rows
    off = tmp_path / "off.json"
    off.write_text(json.dumps({"counters": None}))
    (rc, out), (jrc, jout) = (_cli(dintmon.main, ["check", str(off),
                                                  "--json"]),
                              _cli(ref.main, ["check", str(off), "--json"]))
    assert rc == jrc == 1 and json.loads(out) == json.loads(jout)
