"""The microbenchmark sweep (the port of exp.py's `sweep_micro` and the
benches it runs): each point writes a JSON metric block to
``<out>/<name>.json`` and the run ends with ``<out>/summary.json``.

    python -m dint_tpu_torch.exp                  # needs one CUDA card
    python -m dint_tpu_torch.exp --quick          # small sizes, 1 s windows
    python -m dint_tpu_torch.exp --only store_wire --out DIR --window 5

The points, with exp.py's names, sizes and artifact keys:

* ``store_{contention,parallel}_w{1024,4096,16384}``: `StoreClient` over 1M
  keys, 50/50 GET/SET or all GET;
* ``store_zipf_w*``: the same under Zipfian keys;
* ``store_scan_f{0,5,50,95}``: YCSB-B to YCSB-E, the scan share of the mix
  over the ordered run, w=4096, scans of up to 100 rows;
* ``lock_2pl``, ``lock_fasst``, ``lock_fasst_attr``: the trace clients on
  a 20,000-txn trace, cohorts of 512; ``log_server``: appends, w=8192;
* ``store_wire``, ``tatp_wire``: the store and one TATP shard served over
  loopback UDP through the native shim, pkt/s from two clients;
  ``tatp_wire_txn``: whole TATP transactions from `WireCoordinator` over
  three shard servers, txn/s; ``tatp_colocate_c{1,2,4}``: ``tatp_wire``
  with the process pinned to 1, 2 or 4 cores;
* ``store_cached_{wb_bloom,wb_nobloom,wt}``: `CachedStore` on each policy.

Every artifact carries ``plan``: {source, hash, overridden} of PLAN.json
(`dint_tpu_torch.plan`), null where no plan is readable or
``DINT_BENCH_PLAN=0``. ``--skip-done`` skips points whose artifact is
already in ``--out``.

What differs from exp.py: only `sweep_micro` is here (the pipeline, serve
and mesh sweeps are not ported). A point that raises ends the run: there is
no retry, no error artifact and no summary. ``use_hotset`` (None:
``DINT_USE_HOTSET``, as JAX's `StoreClient` reads it) is an argument of
`sweep_micro`, since the port's `StoreClient` reads no environment; the
point-op rows take no ordered run (JAX's reads ``DINT_USE_SCAN``). The
port has no ``use_pallas``: its kernels are its only route, so that key
is null. A wire bench snapshots its pump after stopping it, so the last
batch's tally is in (occupancy + padded == width * batches). Entry points
run on the card (``device`` None) unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

import argparse
import json
import os
import threading
import time

import numpy as np

from . import plan as dplan
from .clients import micro
from .clients import tatp_client as tc
from .clients import tatp_wire as tw
from .clients import workloads as wl
from .device import resolve_device
from .engines import store, store_cache, tatp
from .engines.types import Op
from .shim import STORE, TATP, EnginePump, ShimClient
from .shim.host_kvs import CachedStore
from .stats import CpuMonitor, LatencyReservoir, MetricBlock, Recorder

WIRE_WARM_TRIES = 8


def plan_meta():
    """The artifact's ``plan`` field: {source, hash, overridden} of the
    readable PLAN.json, None without one or under ``DINT_BENCH_PLAN=0``.
    The sweep resolves no planned knob, so nothing is overridden."""
    if os.environ.get("DINT_BENCH_PLAN", "1") == "0":
        return None
    try:
        doc = dplan.load_plan()
    except (OSError, ValueError):
        return None
    return {"source": str(dplan.plan_path()),
            "hash": doc.get("provenance", {}).get("cost_model_hash"),
            "overridden": []}


def run_point(results, name, fn):
    """Run one point and store its artifact; a point already done (under
    ``--skip-done``) is skipped. A raising point raises."""
    if getattr(results, "already_done", lambda n: False)(name):
        print(f"point {name}: skipped (already done)", flush=True)
        return
    out = fn()
    out.setdefault("plan", plan_meta())
    results[name] = out


def _timed_client(client, go, window_s):
    go()                             # the warm round
    client.rec.reset()
    t0 = time.time()
    while time.time() - t0 < window_s:
        go()
    return client.rec.block(time.time() - t0).to_dict()


def sweep_micro(window_s, quick, results, want=lambda name: True,
                use_hotset=None, device=None):
    """store / lock_2pl / lock_fasst (+ attribution) / log_server and the
    wire points through their clients. ``want`` gates each point before it
    runs. ``use_hotset`` None reads ``DINT_USE_HOTSET``; ``device`` None is
    the card."""
    dev = resolve_device(device)
    if use_hotset is None:
        use_hotset = os.environ.get("DINT_USE_HOTSET", "0") not in ("", "0")
    rng = np.random.default_rng(0)
    n_keys = 10_000 if quick else 1_000_000
    widths = [1024] if quick else [1024, 4096, 16384]

    def store_client(w, **kw):
        return micro.StoreClient.populated(n_keys, width=w, device=dev,
                                           use_hotset=use_hotset, **kw)

    def timed(name, client, go):
        run_point(results, name,
                  lambda: _timed_client(client, go, window_s))

    for read_frac, tag in ((0.5, "contention"), (1.0, "parallel")):
        for w in widths:
            name = f"store_{tag}_w{w}"
            if not want(name):
                continue

            def store_fn(w=w, read_frac=read_frac):
                c = store_client(w, read_frac=read_frac)
                return _timed_client(c, lambda: c.run_wave(rng),
                                     window_s) | {"width": w, "scan": None}

            run_point(results, name, store_fn)

    # the skewed store: Zipfian keys whose hot head is the hot mirror's
    # prefix when use_hotset is on
    for w in widths:
        name = f"store_zipf_w{w}"
        if not want(name):
            continue

        def zipf_fn(w=w):
            c = store_client(w, read_frac=0.5, key_dist="zipfian")
            return _timed_client(c, lambda: c.run_wave(rng), window_s) | {
                "width": w, "key_dist": "zipfian",
                "zipf_theta": wl.ZIPF_THETA,
                "use_hotset": c.use_hotset, "use_pallas": None,
                "scan": None}

        run_point(results, name, zipf_fn)

    # the scan-share ladder over the ordered run: YCSB-B (0%) to YCSB-E
    # (95% scans) at one width, Zipfian start keys, uniform lengths
    scan_w = 1024 if quick else 4096
    scan_max = 16 if quick else wl.YCSB_E_MAX_SCAN
    for frac in (0.0, 0.05, 0.5, 0.95):
        name = f"store_scan_f{int(frac * 100)}"
        if not want(name):
            continue

        def scan_fn(frac=frac, w=scan_w, scan_max=scan_max):
            c = store_client(w, read_frac=0.5, key_dist="zipfian",
                             use_scan=True, scan_frac=frac,
                             scan_max=scan_max, rebuild_every=1)
            return _timed_client(c, lambda: c.run_wave(rng),
                                 window_s) | {
                "width": w, "key_dist": "zipfian",
                "zipf_theta": wl.ZIPF_THETA,
                "scan": {"use_scan": c.use_scan, "scan_frac": frac,
                         "scan_max": scan_max,
                         "max_scan_len": c.max_scan_len,
                         "delta_cap": c.delta_cap,
                         "rebuild_every": c.rebuild_every,
                         "use_pallas": None}}

        run_point(results, name, scan_fn)

    if any(want(n) for n in ("lock_2pl", "lock_fasst", "lock_fasst_attr")):
        trace = wl.lock_trace(rng, n_txns=200 if quick else 20_000,
                              key_range=4800)
        for cls, name, kw in ((micro.Lock2PLClient, "lock_2pl", {}),
                              (micro.FasstClient, "lock_fasst", {}),
                              (micro.FasstClient, "lock_fasst_attr",
                               {"attribute": True})):
            if not want(name):
                continue
            c = cls(trace, cohort=64 if quick else 512, device=dev, **kw)
            timed(name, c, c.run_round)

    if want("log_server"):
        c = micro.LogClient(width=1024 if quick else 8192, device=dev)
        timed("log_server", c, lambda: c.run_wave(rng))

    if want("store_wire"):
        run_point(results, "store_wire",
                  lambda: _store_wire_bench(window_s, quick, dev))

    if want("tatp_wire"):
        run_point(results, "tatp_wire",
                  lambda: _tatp_wire_bench(window_s, quick, dev))

    if want("tatp_wire_txn"):
        run_point(results, "tatp_wire_txn",
                  lambda: _tatp_wire_txn_bench(window_s, quick, dev))

    # the colocated servers (exp/run_tatp_colocate.sh:27 shares 8 cores):
    # the whole process pinned to n cores, the wire bench again
    for n in (1, 2, 4):
        name = f"tatp_colocate_c{n}"
        if want(name):
            run_point(results, name,
                      lambda n=n: _colocate_bench(n, window_s, quick, dev))

    for tag in ("wb_bloom", "wb_nobloom", "wt"):
        name = f"store_cached_{tag}"
        if want(name):
            run_point(results, name,
                      lambda tag=tag: _store_cached_bench(tag, window_s,
                                                          quick, dev))


def _store_cached_bench(tag, window_s, quick, dev):
    """The two-tier store (device cache + host KVS) on one policy, the
    reference's store-server ablation (store/ebpf/store_kern.c,
    store_wb_kern.c, store_wt_kern.c): a keyspace of ~2x the cache's
    capacity keeps the miss and refill path live; the extras give the hit,
    miss and bloom split."""
    policy = {"wb_bloom": store_cache.WB_BLOOM,
              "wb_nobloom": store_cache.WB_NOBLOOM,
              "wt": store_cache.WT}[tag]
    cache_buckets = 1 << (10 if quick else 16)
    n_keys = cache_buckets * 8           # the cache holds ~half the keys
    width = 1_024 if quick else 4_096

    srv = CachedStore(cache_buckets, val_words=10, policy=policy,
                      width=width, device=dev)
    keys_all = np.arange(1, n_keys + 1, dtype=np.uint64)
    vals = np.zeros((n_keys, 10), np.uint32)
    vals[:, 0] = keys_all.astype(np.uint32)
    vals[:, 1] = micro.STORE_MAGIC
    srv.populate(keys_all, vals)

    rng = np.random.default_rng(0)
    wv = np.zeros((width, 10), np.uint32)
    wv[:, 1] = micro.STORE_MAGIC
    rec = Recorder()

    def wave():
        k = rng.integers(1, int(n_keys * 1.1), width).astype(np.uint64)
        is_read = rng.random(width) < 0.5
        ops = np.where(is_read, Op.GET, Op.SET).astype(np.int32)
        t0 = time.monotonic()
        srv.serve(ops, k, wv)
        rec.record(width, width, np.full(width,
                                         (time.monotonic() - t0) * 1e6))

    wave()     # queues refills for its misses
    wave()     # runs the refill path (pending is non-empty now)
    rec.reset()
    srv.stats = type(srv.stats)()
    t0 = time.time()
    while time.time() - t0 < window_s:
        wave()
    block = rec.block(time.time() - t0)
    st = srv.stats
    block.extra.update(policy=tag, hits=st.hits, misses=st.misses,
                       bloom_negatives=st.bloom_negatives,
                       writebacks=st.writebacks,
                       hit_rate=round(st.hits / max(st.hits + st.misses, 1),
                                      4))
    return block.to_dict()


def _warm_pump(pump, label):
    """One answered single-request exchange, so the window starts past the
    pump's first step; raises when no exchange is answered."""
    with ShimClient("127.0.0.1", pump.port) as c:
        for _ in range(WIRE_WARM_TRIES):
            if c.exchange(np.zeros(1, np.uint8), np.array([1], np.uint64),
                          timeout_ms=20_000)["n"] == 1:
                return
    raise RuntimeError(f"{label}: the pump answered no warm-up exchange in "
                       f"{WIRE_WARM_TRIES} tries")


def _wire_clients(pump, n_clients, window_s, wave_fn):
    """``n_clients`` threads, each with its own ShimClient, calling
    ``wave_fn(i, client, rng, stop_at)`` until the window ends. Returns
    (sent, answered, latency reservoirs, seconds)."""
    stop_at = time.time() + window_s
    sent = np.zeros(n_clients, np.int64)
    answered = np.zeros(n_clients, np.int64)
    lats = [LatencyReservoir(seed=i) for i in range(n_clients)]
    errs = []

    def worker(i):
        try:
            rng = np.random.default_rng(i)
            with ShimClient("127.0.0.1", pump.port) as c:
                wave_fn(i, c, rng, stop_at, sent, answered, lats[i])
        except Exception as e:          # raised after the join
            errs.append(e)

    t0 = time.time()
    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    return sent, answered, lats, time.time() - t0


def _wire_block(sent, answered, lats, dt, extra):
    """The clients' metric block: the reservoirs re-added (approximate past
    their cap), the histograms merged exactly."""
    agg = LatencyReservoir()
    for lr in lats:
        agg.add(lr.samples[:lr.n_kept])
        if lr is not lats[0]:
            lats[0].hist.merge(lr.hist)
    p = agg.percentiles()
    return MetricBlock(
        throughput=float(sent.sum()) / dt,
        goodput=float(answered.sum()) / dt,
        avg_us=p["avg"], p50_us=p["p50"], p99_us=p["p99"],
        p999_us=p["p999"],
        extra={**extra, "lat_hist": lats[0].hist.to_dict()}).to_dict()


def _store_wire_bench(window_s, quick, dev):
    """The store served over the wire: reference-format UDP datagrams
    through the native pump (recvmmsg batch -> store.step -> sendmmsg
    scatter), pkt/s from two loopback clients at 50/50 GET/SET, the
    reference's store server benchmark (store/udp/server.cc:50-98; its pps
    counter, store/ebpf/store_user.c:58-65)."""
    n_keys = 4_096 if quick else 200_000
    width = 1_024 if quick else 4_096
    n_clients = 2
    wave = width // n_clients

    table = micro.make_store_table(n_keys, device=dev)

    def waves(i, c, rng, stop_at, sent, answered, lat):
        while time.time() < stop_at:
            k = rng.integers(1, n_keys + 1, size=wave).astype(np.uint64)
            is_read = rng.random(wave) < 0.5     # the contention mix
            t0 = time.monotonic()
            r = c.exchange(np.where(is_read, 0, 1).astype(np.uint8), k,
                           timeout_ms=10_000)
            dt = time.monotonic() - t0
            sent[i] += wave
            answered[i] += r["n"]
            lat.add(np.full(r["n"], dt * 1e6))

    with EnginePump(STORE, store.step, table, width=width, flush_us=500,
                    device=dev).start() as pump:
        _warm_pump(pump, "store_wire")
        sent, answered, lats, dt = _wire_clients(pump, n_clients, window_s,
                                                 waves)
        pump.stop()       # the last batch's tally lands before the snapshot
        pump_lat = pump.latency_snapshot()
    return _wire_block(sent, answered, lats, dt, {
        "unit": "pkt/s", "clients": n_clients, "wave": wave,
        "transport": "udp_loopback_shim", "pump": pump_lat})


def _tatp_wire_bench(window_s, quick, dev):
    """One TATP shard served over the wire (tatp/udp/server_shard.cc, wire
    codes tatp/ebpf/utils.h:38-73): two loopback clients send 80% kRead
    over the five tables and a kAcquireLock/kAbort slice (each wave aborts
    the last wave's grants, so lock occupancy holds steady); pkt/s like
    the reference's server counter."""
    n_sub = 2_000 if quick else 100_000
    width = 512 if quick else 4_096
    n_clients = 2
    wave = width // n_clients
    n_lock = wave // 10

    shard = tc.populate_shards(np.random.default_rng(0), n_sub, val_words=10,
                               log_capacity=1 << 14 if quick else 1 << 20,
                               device=dev)[0][0]
    grants = np.zeros(n_clients, np.int64)

    def waves(i, c, rng, stop_at, sent, answered, lat):
        # a client's lock keys are its own half of the subscribers, so an
        # abort always releases a row this client locked
        lo = 1 + i * (n_sub // n_clients)
        hi = lo + n_sub // n_clients
        prev_locks = np.zeros(0, np.uint64)
        while time.time() < stop_at:
            n_ab = len(prev_locks)
            n_rd = wave - n_lock - n_ab
            rd_tbl = rng.integers(0, 5, n_rd).astype(np.uint8)
            rd_key = rng.integers(1, n_sub + 1, n_rd)
            rd_key = np.where(rd_tbl >= tatp.ACCESS_INFO,
                              rd_key * 4 + rng.integers(0, 4, n_rd), rd_key)
            rd_key = np.where(
                rd_tbl == tatp.CALL_FORWARDING,
                np.asarray(tatp.cf_key(rng.integers(1, n_sub + 1, n_rd),
                                       rng.integers(1, 5, n_rd),
                                       rng.integers(0, 3, n_rd) * 8)),
                rd_key)
            lk_key = rng.choice(hi - lo, n_lock, replace=False) + lo
            types = np.concatenate([np.zeros(n_rd, np.uint8),
                                    np.ones(n_lock, np.uint8),
                                    np.full(n_ab, 2, np.uint8)])
            tbls = np.concatenate([rd_tbl,
                                   np.zeros(n_lock + n_ab, np.uint8)])
            keys = np.concatenate([rd_key.astype(np.uint64),
                                   lk_key.astype(np.uint64), prev_locks])
            t0 = time.monotonic()
            r = c.exchange(types, keys, tables=tbls, timeout_ms=10_000)
            dt = time.monotonic() - t0
            sent[i] += len(types)
            answered[i] += r["n"]
            lat.add(np.full(r["n"], dt * 1e6))
            granted = r["key"][r["type"] == 7]   # kGrantLock
            grants[i] += len(granted)
            prev_locks = granted.astype(np.uint64)
        # release what is still held, so the run ends clean
        if len(prev_locks):
            c.exchange(np.full(len(prev_locks), 2, np.uint8), prev_locks,
                       timeout_ms=10_000)

    with EnginePump(TATP, tatp.step, shard, width=width, flush_us=500,
                    device=dev).start() as pump:
        _warm_pump(pump, "tatp_wire")
        sent, answered, lats, dt = _wire_clients(pump, n_clients, window_s,
                                                 waves)
        pump.stop()       # the last batch's tally lands before the snapshot
        pump_lat = pump.latency_snapshot()
    return _wire_block(sent, answered, lats, dt, {
        "unit": "pkt/s", "clients": n_clients, "wave": wave,
        "lock_grants": int(grants.sum()), "n_subscribers": n_sub,
        "transport": "udp_loopback_shim", "pump": pump_lat})


def _tatp_wire_txn_bench(window_s, quick, dev):
    """Whole TATP transactions over the wire: three UDP shard servers and
    the wave coordinator fanning each shard's datagrams out, the
    reference's serving topology (3 servers and a Caladan client,
    client_ebpf_shard.cc:636-677); txn/s with the abort taxonomy."""
    n_sub = 2_000 if quick else 100_000
    # w = 2048 puts ~2.7k lanes on a shard in wave 1: ~11 chunks over 8
    # sockets a shard, more than 256 in flight (the reference's uthread
    # re-send loops, client_ebpf_shard.cc:643-677)
    w = 128 if quick else 2048

    lat = LatencyReservoir()
    with tw.serve_shards(n_sub, width=4 * w, flush_us=500,
                         device=dev) as ports:
        with tw.WireCoordinator(ports, n_sub, width=4 * w,
                                n_socks=8) as coord:
            rng = np.random.default_rng(0)
            coord.run_cohort(rng, w)            # the warm cohort
            coord.stats = type(coord.stats)()
            t0 = time.time()
            while time.time() - t0 < window_s:
                c0 = time.monotonic()
                coord.run_cohort(rng, w)
                # closed loop: a txn's latency is its cohort's whole span
                lat.add(np.full(w, (time.monotonic() - c0) * 1e6))
            dt = time.time() - t0
            st = coord.stats

    p = lat.percentiles()
    return MetricBlock(
        throughput=st.attempted / dt, goodput=st.committed / dt,
        avg_us=p["avg"], p50_us=p["p50"], p99_us=p["p99"],
        p999_us=p["p999"],
        extra={"unit": "txn/s", "width": w, "n_subscribers": n_sub,
               "ab_lock": st.aborted_lock, "ab_missing": st.aborted_missing,
               "ab_validate": st.aborted_validate,
               "ab_timeout": st.aborted_timeout,
               "timeout_lanes": st.timeout_lanes,
               "transport": "udp_loopback_3shard"}).to_dict()


def _colocate_bench(n_cores, window_s, quick, dev):
    """The reference's colocated experiment (exp/run_tatp_colocate.sh:27
    pins the servers to 8 shared cores): the whole process, the C++ RX
    thread, torch's threads, the wire parse, the reply scatter and the
    dispatch, pinned to ``n_cores``, and the TATP wire bench again.
    Threads started inside inherit the affinity."""
    all_cpus = os.sched_getaffinity(0)
    cpu = CpuMonitor()
    try:
        # inside the try: a raise after narrowing must not leave the
        # process pinned
        os.sched_setaffinity(0, set(sorted(all_cpus)[:n_cores]))
        out = _tatp_wire_bench(window_s, quick, dev)
    finally:
        os.sched_setaffinity(0, all_cpus)
    out.update(cpu.cores())
    out["host_cores_pinned"] = n_cores
    return out


class _ResultSink(dict):
    """Results that write each point to ``<out>/<name>.json`` as it lands,
    so a run cut short keeps every finished point."""

    def __init__(self, out: str, skip_done: bool = False):
        super().__init__()
        self.out = out
        self.skip_done = skip_done

    def __setitem__(self, name, block):
        super().__setitem__(name, block)
        with open(os.path.join(self.out, f"{name}.json"), "w") as f:
            json.dump(block, f, indent=1)

    def already_done(self, name) -> bool:
        """Under ``--skip-done``: the point's artifact is in ``out`` (an
        error artifact of exp.py's does not count); it is loaded for the
        summary."""
        if not self.skip_done:
            return False
        try:
            with open(os.path.join(self.out, f"{name}.json")) as f:
                block = json.load(f)
        except (OSError, ValueError):
            return False
        if "error" in block:
            return False
        super().__setitem__(name, block)
        return True


def run(out: str, window_s: float = 10.0, quick: bool = False,
        only: str | None = None, skip_done: bool = False,
        use_hotset=None, device=None) -> dict:
    """`sweep_micro` into ``out``, then ``out/summary.json``."""
    os.makedirs(out, exist_ok=True)
    results = _ResultSink(out, skip_done=skip_done)

    def want(name):
        # both ways: --only store matches store_zipf_w1024, and
        # --only store_zipf_w1024 passes a coarser gate
        return only is None or only in name or name in only

    sweep_micro(window_s, quick, results, want=want, use_hotset=use_hotset,
                device=device)
    summary = {"configs": sorted(results), "window_s": window_s,
               "quick": quick}
    with open(os.path.join(out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="The microbenchmark sweep of the PyTorch port.")
    ap.add_argument("--out", default="exp_results")
    ap.add_argument("--window", type=float, default=10.0)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--only", default=None)
    ap.add_argument("--skip-done", action="store_true",
                    help="skip points whose artifact already exists")
    args = ap.parse_args(argv)
    if args.quick and args.window == 10.0:
        args.window = 1.0
    results = run(args.out, window_s=args.window, quick=args.quick,
                  only=args.only, skip_done=args.skip_done)
    for name in sorted(results):
        r = results[name]
        print(f"{name}: goodput={r['goodput']:.0f}/s "
              f"abort={r['abort_rate']:.4f} p99={r['p99_us']:.0f}us")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
