"""The port's host shim (dint_tpu_torch.shim: the native build, the wire
profiles, EnginePump) against `dint_tpu.shim` on the CPU.

* The profile tables and their maps equal JAX's over every wire code, and
  the Op/Reply codes they index equal JAX's.
* The library is built from native/shim.cc into dint_tpu_torch/_build,
  once, and nothing under native/ is written.
* A stub in place of the C++ server (chip_smoke.py's, with its script)
  feeds both packages' pumps the same scripted batches as views of a ring
  slot that the reply scribbles over (as the C++ ring reuses a slot):
  the wire replies, the final state and
  the occupancy counts are bit-identical on all six profiles, through
  `serve_one` and through a depth-2 `serve_forever` whose batch i+1 writes
  what batch i read.
* The twins of tests/test_shim.py's loopback cases and of
  test_dintserve.py's pump-knob case, over UDP on 127.0.0.1."""
import time
from pathlib import Path

import jax
import numpy as np
import pytest

from dint_tpu.clients import tatp_client as jtc
from dint_tpu.engines import fasst as jfasst
from dint_tpu.engines import lock2pl as jlock2pl
from dint_tpu.engines import logsrv as jlogsrv
from dint_tpu.engines import smallbank as jsmallbank
from dint_tpu.engines import store as jstore
from dint_tpu.engines import tatp as jtatp
from dint_tpu.engines import types as jtypes
from dint_tpu.shim import pump as jpump
from dint_tpu.shim import wire as jwire
from dint_tpu.tables import kv as jkv
from dint_tpu.tables import locks as jlocks
from dint_tpu.tables import log as jlog
from dint_tpu_torch import convert
from dint_tpu_torch.clients import tatp_client as tc
from dint_tpu_torch.engines import (fasst, lock2pl, logsrv, smallbank, store,
                                    tatp)
from dint_tpu_torch.engines import types as ptypes
from dint_tpu_torch.shim import (FASST, FMT_FASST9, FMT_LOCK6, FMT_LOG53,
                                 LOCK2PL, LOG, PROFILES, SMALLBANK, STORE,
                                 TATP, EnginePump, ShimClient, native)
from dint_tpu_torch.shim import pump as ppump
from dint_tpu_torch.shim import wire
from dint_tpu_torch.tables import kv, locks
from dint_tpu_torch.tables import log as plog

from chip_smoke import WIRE_W as W
from chip_smoke import StubServer, wire_script
from test_torch_lock_engines import assert_same, np_tree

REPO = Path(__file__).resolve().parents[1]


# ------------------------------------------------------- codes and profiles


def _codes(cls):
    return {k: v for k, v in vars(cls).items()
            if k.isupper() and isinstance(v, int)}


def test_op_and_reply_codes_equal_jax():
    assert _codes(ptypes.Reply) == _codes(jtypes.Reply)
    pops, jops = _codes(ptypes.Op), _codes(jtypes.Op)
    assert pops == {k: jops[k] for k in pops}
    # every op a profile maps to exists in the port
    used = {int(o) for p in jwire.PROFILES.values() for o in p.req_map}
    used |= {jtypes.Op.ACQ_S, jtypes.Op.ACQ_X, jtypes.Op.REL_S,
             jtypes.Op.REL_X}
    assert used <= set(pops.values())


@pytest.mark.parametrize("name", sorted(jwire.PROFILES))
def test_profile_equals_jax(name):
    jp, pp = jwire.PROFILES[name], PROFILES[name]
    assert pp.name == jp.name and pp.fmt == jp.fmt
    assert pp.req_map.dtype == jp.req_map.dtype
    assert np.array_equal(pp.req_map, jp.req_map)
    assert pp.rep_map.dtype == jp.rep_map.dtype
    assert np.array_equal(pp.rep_map, jp.rep_map)
    wt = np.repeat(np.arange(256, dtype=np.uint8), 4)
    tb = np.tile(np.array([0, 1, 2, 255], np.uint8), 256)
    a, b = jp.to_ops(wt, tb), pp.to_ops(wt, tb)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    wr = np.repeat(np.arange(256, dtype=np.uint8), wire.N_REPLY)
    rc = np.tile(np.arange(wire.N_REPLY), 256)
    a, b = jp.to_wire(wr, rc), pp.to_wire(wr, rc)
    assert a.dtype == b.dtype == np.uint8 and np.array_equal(a, b)
    assert (b[np.isin(rc, [ptypes.Reply.NONE])] == 255).all()


def test_profile_exports_equal_jax():
    import dint_tpu.shim as jshim
    import dint_tpu_torch.shim as pshim
    assert pshim.__all__ == jshim.__all__
    for k in ("VAL_SIZE", "FMT_MSG55", "FMT_LOCK6", "FMT_FASST9",
              "FMT_LOG53"):
        assert getattr(pshim, k) == getattr(jshim, k)
    assert native.VAL_WORDS == 10
    assert (STORE, LOCK2PL, FASST, LOG, SMALLBANK, TATP) == tuple(
        PROFILES[k] for k in ("store", "lock_2pl", "lock_fasst",
                              "log_server", "smallbank", "tatp"))


# ----------------------------------------------------------- native build


def _snapshot(d: Path) -> dict:
    return {p.name: (p.read_bytes(), p.stat().st_mtime_ns)
            for p in sorted(d.iterdir())}


def test_native_build_in_build_dir_once_and_native_untouched(
        monkeypatch, tmp_path):
    assert native.target().parent == REPO / "dint_tpu_torch" / "_build"
    assert native.target().name.startswith("libdintshim_")
    assert native.SRC == REPO / "native" / "shim.cc"
    before = _snapshot(REPO / "native")
    calls = []
    real_run = native.subprocess.run

    def run(cmd, **kw):
        calls.append(cmd)
        return real_run(cmd, **kw)

    monkeypatch.setattr(native.subprocess, "run", run)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    lib = native.load()
    assert len(calls) == 1
    cmd = calls[0]
    assert cmd[cmd.index("-o") + 1].startswith(str(tmp_path / "_build"))
    assert cmd[-1] == str(native.SRC)
    for flag in ("-O2", "-std=c++17", "-Wall", "-Wextra", "-fPIC",
                 "-shared", "-pthread"):
        assert flag in cmd
    built = native.target()
    assert built.parent == tmp_path / "_build" and built.exists()
    assert [p.name for p in built.parent.iterdir()] == [built.name]
    stamp = built.stat().st_mtime_ns
    assert lib.shim_server_create is not None
    monkeypatch.setattr(native, "_lib", None)
    native.load()
    assert len(calls) == 1 and built.stat().st_mtime_ns == stamp
    assert _snapshot(REPO / "native") == before


def test_native_build_failure_raises_with_compiler_output(monkeypatch,
                                                          tmp_path):
    bad = tmp_path / "shim.cc"
    bad.write_text("int main( {\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="error"):
        native.build()
    assert not list((tmp_path / "_build").iterdir())


def test_entry_points_need_a_card_by_default():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EnginePump(STORE, store.step, None)


# ------------------------------------------------------------ stub server


def _script(name, seed):
    return wire_script(name, PROFILES[name].fmt, seed)


def _states(name):
    """(JAX state, its port copy on the CPU, JAX step, port step, VW)."""
    rng = np.random.default_rng(7)
    if name == "store":
        keys = np.arange(1, 41, dtype=np.uint64)
        vals = rng.integers(0, 1 << 32, (40, 10), dtype=np.uint64)
        js = jkv.populate(jkv.create(1 << 5, val_words=10), keys,
                          vals.astype(np.uint32))
        return (js, convert.kv_table_from_numpy(np_tree(js), "cpu"),
                jstore.step, store.step, 10)
    if name == "lock_2pl":
        js = jlocks.create_sx(1 << 4)
        return (js, convert.sx_lock_table_from_numpy(np_tree(js), "cpu"),
                jlock2pl.step, lock2pl.step, 10)
    if name == "lock_fasst":
        js = jlocks.create_occ(1 << 6)
        return (js, convert.occ_table_from_numpy(np_tree(js), "cpu"),
                jfasst.step, fasst.step, 10)
    if name == "log_server":
        js = jlog.create(4, 1 << 6, val_words=10)
        return (js, convert.log_ring_from_numpy(np_tree(js), "cpu"),
                jlogsrv.step, logsrv.step, 10)
    if name == "smallbank":
        js = jsmallbank.create(64, val_words=2, log_lanes=4,
                               log_capacity=1 << 8)
        vals = rng.integers(0, 1 << 32, 128, dtype=np.uint64)
        js = js.replace(
            sav=js.sav.replace(val=jax.numpy.asarray(vals.astype(np.uint32)),
                               ver=jax.numpy.ones(64, jax.numpy.uint32)),
            chk=js.chk.replace(ver=jax.numpy.ones(64, jax.numpy.uint32)))
        return (js, convert.smallbank_shard_from_numpy(np_tree(js), "cpu"),
                jsmallbank.step, smallbank.step, 2)
    js = jtc.populate_shards(np.random.default_rng(0), 40, val_words=10,
                             log_lanes=4, log_capacity=1 << 8)[0][0]
    return (js, convert.tatp_shard_from_numpy(np_tree(js), "cpu"),
            jtatp.step, tatp.step, 10)


def _stub_pump(mod, monkeypatch, *args, **kw):
    monkeypatch.setattr(mod, "ShimServer", StubServer)
    pump = mod.EnginePump(*args, **kw)
    pump.server.pump = pump
    return pump


def _serve(name, monkeypatch, depth):
    """Both packages' pumps over one script: serve_one a batch (depth
    None) or serve_forever at ``depth``. Returns both pumps."""
    js, ps, jstep, pstep, vw = _states(name)
    out = []
    for mod, state, step, kw in ((jpump, js, jstep, {}),
                                 (ppump, ps, pstep, {"device": "cpu"})):
        prof = (jwire if mod is jpump else wire).PROFILES[name]
        p = _stub_pump(mod, monkeypatch, prof, step, state, width=W,
                       val_words=vw, depth=depth or 1, **kw)
        p.server.script = _script(name, seed=len(name))
        if depth is None:
            while p.server.script:
                assert p.serve_one(0)
        else:
            p.serve_forever()
        out.append(p)
    return out


def _same_wire(a, b):
    assert len(a.server.replies) == len(b.server.replies)
    for x, y in zip(a.server.replies, b.server.replies):
        for u, v in zip(x, y):
            assert u.dtype == v.dtype and np.array_equal(u, v)


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_stub_pump_bit_identical_to_jax(name, monkeypatch):
    """serve_one batch by batch, then a depth-2 serve_forever over the
    same script from the same state: the wire replies equal JAX's batch
    by batch and the serial run's; the final states are equal."""
    jp, pp = _serve(name, monkeypatch, None)
    _same_wire(jp, pp)
    assert_same(np_tree(jp.state), convert.tree_to_numpy(pp.state))
    replies = [r[0] for r in pp.server.replies]
    # the script reached the engine: some lanes answered, unknown codes
    # went out as 255 (or, where a NOP lane's reply is defined, as that)
    assert any((r != 255).any() for r in replies)
    js, jd = jp.latency_snapshot(), pp.latency_snapshot()
    for k in ("batches", "width", "depth", "occupancy_lanes",
              "padded_lanes", "shed"):
        assert js[k] == jd[k], k
    assert jd["occupancy_lanes"] + jd["padded_lanes"] \
        == W * jd["batches"] == W * len(_script(name, seed=len(name)))

    jd2, pd2 = _serve(name, monkeypatch, 2)
    assert pd2.depth == 2
    _same_wire(jd2, pd2)
    _same_wire(pp, pd2)
    assert_same(np_tree(jd2.state), convert.tree_to_numpy(pd2.state))
    assert_same(convert.tree_to_numpy(pp.state),
                convert.tree_to_numpy(pd2.state))


def test_depth2_replies_do_not_alias_the_state(monkeypatch):
    """A read whose reply is taken after the next batch wrote the same
    keys still carries the values and versions it read."""
    _, pd2 = _serve("store", monkeypatch, 2)
    rt, rv, rver = pd2.server.replies[-2]      # the GETs of keys 100..107
    assert (rt == 3).all()
    first = _script("store", seed=len("store"))[-3]   # their INSERT
    assert np.array_equal(rv, first["val"])
    assert (rver == pd2.server.replies[-1][2] - 1).all()


def test_pump_depth_and_occupancy_knobs():
    """The twin of test_dintserve.py's case: depth and the idle poll are
    knobs, and latency_snapshot() holds the occupancy identity and the
    C++ side's shed count."""
    table = kv.create(1 << 8, val_words=10, device="cpu")
    with pytest.raises(ValueError):
        EnginePump(STORE, store.step, table, width=64, depth=0,
                   device="cpu")
    with EnginePump(STORE, store.step, table, width=64, flush_us=2000,
                    depth=3, idle_poll_us=1000, device="cpu").start() as p:
        _warm(p)
        for _ in range(500):
            if p.batches_served >= 1:
                break
            time.sleep(0.01)
        snap = p.latency_snapshot()
    assert snap["width"] == 64 and snap["depth"] == 3
    assert snap["batches"] >= 1
    assert snap["occupancy_lanes"] >= 1
    assert snap["occupancy_lanes"] + snap["padded_lanes"] == \
        64 * snap["batches"]
    assert snap["shed"] == 0
    assert {"p50_us", "p99_us", "hist"} <= set(snap["queue"])
    assert {"p50_us", "p99_us", "hist"} <= set(snap["service"])


# ------------------------------------------------------- loopback twins


def _warm(pump, fmt=None):
    kw = {} if fmt is None else {"fmt": fmt}
    with ShimClient("127.0.0.1", pump.port, **kw) as c:
        for _ in range(12):
            r = c.exchange(np.zeros(1, np.uint8),
                           np.array([1], np.uint64), timeout_ms=10_000)
            if r["n"] == 1:
                return
    raise RuntimeError("pump did not answer warmup exchanges")


@pytest.fixture
def store_pump():
    table = kv.create(1 << 8, val_words=10, device="cpu")
    with EnginePump(STORE, store.step, table, width=256, flush_us=2000,
                    device="cpu").start() as p:
        _warm(p)
        yield p


def test_store_wire_roundtrip(store_pump):
    with ShimClient("127.0.0.1", store_pump.port) as c:
        n = 32
        keys = np.arange(1, n + 1, dtype=np.uint64)
        vals = np.zeros((n, 40), np.uint8)
        vals[:, 0] = np.arange(n)
        vals[:, 1] = 0xAB
        r = c.exchange(np.full(n, 2, np.uint8), keys, vals=vals,
                       timeout_ms=5000)                    # INSERT
        assert r["n"] == n and (r["type"] == 8).all()      # INSERT_ACK
        r = c.exchange(np.zeros(n, np.uint8), keys, timeout_ms=5000)
        assert r["n"] == n and (r["type"] == 3).all()      # GRANT_READ
        got = {int(k): (v[0], v[1]) for k, v in zip(r["key"], r["val"])}
        for i, k in enumerate(keys):
            assert got[int(k)] == (i, 0xAB)
        r = c.exchange(np.zeros(1, np.uint8), np.array([999], np.uint64),
                       timeout_ms=5000)
        assert r["n"] == 1 and r["type"][0] == 7           # NOT_EXIST


def test_store_set_bumps_version(store_pump):
    with ShimClient("127.0.0.1", store_pump.port) as c:
        key = np.array([7], np.uint64)
        c.exchange(np.array([2], np.uint8), key, timeout_ms=5000)
        r1 = c.exchange(np.array([1], np.uint8), key, timeout_ms=5000)
        assert r1["type"][0] == 5                          # SET_ACK
        r2 = c.exchange(np.array([0], np.uint8), key, timeout_ms=5000)
        assert r2["ver"][0] == r1["ver"][0] >= 1


def test_lock2pl_wire():
    with EnginePump(LOCK2PL, lock2pl.step, locks.create_sx(1 << 10, "cpu"),
                    width=64, flush_us=2000, device="cpu").start() as p:
        with ShimClient("127.0.0.1", p.port, fmt=FMT_LOCK6) as c:
            lid = np.array([42], np.uint64)
            x = np.ones(1, np.uint8)
            r = c.exchange(np.zeros(1, np.uint8), lid, timeout_ms=5000)
            assert r["n"] == 1 and r["type"][0] == 2       # S: GRANT
            r = c.exchange(np.zeros(1, np.uint8), lid, tables=x,
                           timeout_ms=5000)
            assert r["type"][0] == 3                       # X: REJECT
            r = c.exchange(np.ones(1, np.uint8), lid, timeout_ms=5000)
            assert r["type"][0] == 5                       # RELEASE_ACK
            r = c.exchange(np.zeros(1, np.uint8), lid, tables=x,
                           timeout_ms=5000)
            assert r["type"][0] == 2


def test_log_wire():
    rng = np.random.default_rng(0)
    ring = plog.create(4, 1 << 8, val_words=10, device="cpu")
    with EnginePump(LOG, logsrv.step, ring, width=64, flush_us=2000,
                    device="cpu").start() as p:
        with ShimClient("127.0.0.1", p.port, fmt=FMT_LOG53) as c:
            n = 16
            keys = rng.integers(0, 1000, n).astype(np.uint64)
            vals = rng.integers(0, 256, (n, 40)).astype(np.uint8)
            r = c.exchange(np.zeros(n, np.uint8), keys, vals=vals,
                           vers=np.arange(n, dtype=np.uint32),
                           timeout_ms=5000)
            assert r["n"] == n and (r["type"] == 1).all()  # ACK
    assert int(p.state.head.sum()) == n


def test_pump_batches_full_width():
    """One exchange of the pump's whole width round-trips."""
    table = kv.create(1 << 10, val_words=10, device="cpu")
    with EnginePump(STORE, store.step, table, width=512, flush_us=1000,
                    device="cpu").start() as p:
        with ShimClient("127.0.0.1", p.port) as c:
            n = 512
            keys = np.arange(1, n + 1, dtype=np.uint64)
            r = c.exchange(np.full(n, 2, np.uint8), keys, timeout_ms=10000)
            assert r["n"] == n and (r["type"] == 8).all()
        assert p.server.stats()["pkts_rx"] >= n


def test_smallbank_wire_lock_commit_roundtrip():
    from dint_tpu_torch.clients import smallbank_client as sbc
    from dint_tpu_torch.clients import workloads as wl

    shard = sbc.init_shards(64, init_balance=100, device="cpu",
                            log_capacity=1 << 8)[0]
    sav = np.array([smallbank.SAVINGS], np.uint8)
    k7 = np.array([7], np.uint64)
    with EnginePump(SMALLBANK, smallbank.step, shard, width=128,
                    flush_us=2000, val_words=2, device="cpu").start() as p:
        _warm(p)
        with ShimClient("127.0.0.1", p.port) as c:
            r = c.exchange(np.array([1], np.uint8), k7, tables=sav,
                           timeout_ms=5000)
            assert r["n"] == 1 and r["type"][0] == 9      # kGrantExclusive
            assert int(r["val"][0][:4].view(np.uint32)[0]) == 100
            nv = np.zeros((1, 40), np.uint8)
            nv[0, :4] = np.frombuffer(np.uint32(250).tobytes(), np.uint8)
            nv[0, 4:8] = np.frombuffer(np.uint32(wl.SB_MAGIC).tobytes(),
                                       np.uint8)
            r = c.exchange(np.array([4], np.uint8), k7, vals=nv,
                           vers=np.array([2], np.uint32), tables=sav,
                           timeout_ms=5000)
            assert r["n"] == 1 and r["type"][0] == 13     # kCommitPrimAck
            r = c.exchange(np.array([1], np.uint8), k7, tables=sav,
                           timeout_ms=5000)
            assert r["n"] == 1 and r["type"][0] == 10     # still X-held
            r = c.exchange(np.array([3], np.uint8), k7, tables=sav,
                           timeout_ms=5000)
            assert r["n"] == 1 and r["type"][0] == 12     # release ack
            r = c.exchange(np.array([1], np.uint8), k7, tables=sav,
                           timeout_ms=5000)
            assert r["n"] == 1 and r["type"][0] == 9
            assert int(r["val"][0][:4].view(np.uint32)[0]) == 250


def test_tatp_wire_occ_roundtrip():
    shard = tc.populate_shards(np.random.default_rng(0), 64, val_words=10,
                               log_capacity=1 << 12, device="cpu")[0][0]
    sub = np.array([tatp.SUBSCRIBER], np.uint8)
    k5 = np.array([5], np.uint64)
    with EnginePump(TATP, tatp.step, shard, width=128, flush_us=2000,
                    device="cpu").start() as p:
        _warm(p)
        with ShimClient("127.0.0.1", p.port) as c:
            r = c.exchange(np.zeros(1, np.uint8), k5, tables=sub,
                           timeout_ms=5000)
            assert r["n"] == 1 and r["type"][0] == 4      # kGrantRead
            assert int(r["val"][0][:4].view(np.uint32)[0]) == 5
            ver1 = int(r["ver"][0])
            assert ver1 >= 1
            r = c.exchange(np.zeros(1, np.uint8),
                           np.array([tatp.cf_key(9, 1, 0)], np.uint64),
                           tables=np.array([tatp.CALL_FORWARDING],
                                           np.uint8), timeout_ms=5000)
            assert r["n"] == 1 and r["type"][0] == 6      # kNotExist
            r = c.exchange(np.ones(1, np.uint8), k5, tables=sub,
                           timeout_ms=5000)
            assert r["n"] == 1 and r["type"][0] == 7      # kGrantLock
            r = c.exchange(np.ones(1, np.uint8), k5, tables=sub,
                           timeout_ms=5000)
            assert r["n"] == 1 and r["type"][0] == 8      # kRejectLock
            nv = np.zeros((1, 40), np.uint8)
            nv[0, :4] = np.frombuffer(np.uint32(777).tobytes(), np.uint8)
            r = c.exchange(np.array([12], np.uint8), k5, vals=nv,
                           vers=np.array([ver1 + 1], np.uint32),
                           tables=sub, timeout_ms=5000)
            assert r["n"] == 1 and r["type"][0] == 15     # kCommitPrimAck
            r = c.exchange(np.zeros(1, np.uint8), k5, tables=sub,
                           timeout_ms=5000)
            assert r["n"] == 1 and r["type"][0] == 4
            assert int(r["val"][0][:4].view(np.uint32)[0]) == 777
            assert int(r["ver"][0]) == ver1 + 1
            r = c.exchange(np.ones(1, np.uint8), k5, tables=sub,
                           timeout_ms=5000)
            assert r["n"] == 1 and r["type"][0] == 7
            r = c.exchange(np.array([2], np.uint8), k5, tables=sub,
                           timeout_ms=5000)
            assert r["n"] == 1 and r["type"][0] == 9      # kAbortAck


def test_fasst_wire_occ_roundtrip():
    lid = np.array([17], np.uint64)
    with EnginePump(FASST, fasst.step, locks.create_occ(1 << 10, "cpu"),
                    width=64, flush_us=2000, device="cpu").start() as p:
        _warm(p, fmt=FMT_FASST9)
        with ShimClient("127.0.0.1", p.port, fmt=FMT_FASST9) as c:
            def one(t):
                r = c.exchange(np.array([t], np.uint8), lid,
                               timeout_ms=5000)
                assert r["n"] == 1
                return int(r["type"][0]), int(r["ver"][0])
            assert one(0) == (4, 0)            # READ -> GRANT_READ, ver 0
            assert one(1)[0] == 5              # ACQUIRE -> GRANT_LOCK
            assert one(1)[0] == 6              # -> REJECT_LOCK
            assert one(3)[0] == 8              # COMMIT: ver++, unlock
            assert one(0) == (4, 1)
            assert one(1)[0] == 5
            assert one(2)[0] == 7              # ABORT -> ABORT_ACK
            assert one(1)[0] == 5              # free again after the abort
