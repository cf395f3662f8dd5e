"""End-to-end drive of the port's public API (the port of tools/drive.py).

    python -m dint_tpu_torch.drive           # on the CUDA card
    python -m dint_tpu_torch.drive --cpu     # the plain path on the CPU

Six sections, each a run of checks that prints PASS or FAIL; the first
FAIL ends the run with exit code 1. (1) the store over a populated KV
table: GET magic, same-key INSERT versions, NOP and missing DELETE
replies; (1b) scans over the ordered run: dense key ranges, the delta
overlay, the stale contract, and scan replies bit-identical between the
`scan_rows` kernel, its plain version (the same step on CPU copies) and
the step after a rebuild; on ``--cpu`` the kernel is absent, so plain
against post-rebuild; (2) lock_2pl, lock_fasst and the log server; (3)
dense TATP (host populate): accounting, magic, aborts, locks, the three
log replicas; (4) `populate_device`; (5) SmallBank balance conservation;
(6) TATP transactions over the wire. It ends with the launches of every
kernel wrapper as one JSON line.

Without a card and without ``--cpu`` it raises: nothing falls back.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from .device import resolve_device
from .engines import fasst, lock2pl, logsrv, store
from .engines import smallbank_dense as sd
from .engines import tatp_dense as td
from .engines.types import Op, Reply, make_batch
from .ops import row_kernels, scan_kernels
from .tables import kv, locks
from .tables import log as logring
from .tables import run as run_mod

R = 4096
MAGIC = 0x5A5A
_WRAPPERS = row_kernels.WRAPPERS + scan_kernels.WRAPPERS


class DriveFailure(Exception):
    pass


def check(name, ok):
    print(f"{'PASS' if ok else 'FAIL'}  {name}", flush=True)
    if not ok:
        raise DriveFailure(name)


def _np(x) -> np.ndarray:
    return x.cpu().numpy()


def _to(x, dev):
    """A dataclass of tensors (nested) on ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: _to(getattr(x, f.name), dev)
            for f in dataclasses.fields(x) if f.init})
    return x


def _srep(r):
    return tuple(_np(x) for x in (r.count, r.key_hi, r.key_lo, r.ver, r.val))


def drive_store(dev, rng):
    """Sections 1 and 1b."""
    n_keys = 200_000
    table = kv.create(1 << 16, slots=16, val_words=10, device=dev)
    keys_all = np.arange(1, n_keys + 1, dtype=np.uint64)
    vals = np.zeros((n_keys, 10), np.uint32)
    vals[:, 0] = keys_all.astype(np.uint32)
    vals[:, 1] = MAGIC
    table = kv.populate(table, keys_all, vals)

    def batch(ops, keys, vals=None, vers=None, width=R):
        return make_batch(ops, keys, vals, vers=vers, width=width,
                          val_words=10, device=dev)

    k = rng.integers(1, n_keys + 1, R).astype(np.uint64)
    ops = np.where(rng.random(R) < 0.5, Op.GET, Op.SET).astype(np.int32)
    wv = np.zeros((R, 10), np.uint32)
    wv[:, 1] = MAGIC
    table, rep = store.step(table, batch(ops, k, wv))
    rt, rv = _np(rep.rtype), _np(rep.val)
    isval = rt == Reply.VAL
    check("store GET replies carry populate magic",
          isval.any() and (rv[isval, 1] == MAGIC).all())

    # all lanes INSERT one fresh key: the versions are 1..R in some order
    fresh = np.uint64(n_keys + 77)
    table, rep = store.step(table, batch(np.full(R, Op.INSERT, np.int32),
                                         np.full(R, fresh, np.uint64), wv))
    check("same-key INSERT serializes ver 1..R",
          np.array_equal(np.sort(_np(rep.ver)), np.arange(1, R + 1)))

    table, rep = store.step(table, batch(np.zeros(4, np.int32),
                                         np.zeros(4, np.uint64), width=4))
    check("NOP batch replies NONE", (_np(rep.rtype) == Reply.NONE).all())
    table, rep = store.step(table, batch(np.full(4, Op.DELETE, np.int32),
                                         np.full(4, np.uint64(10**9)),
                                         width=4))
    check("delete of nonexistent NOT_EXIST",
          (_np(rep.rtype)[:1] == Reply.NOT_EXIST).all())

    # ---- 1b: Op.SCAN over the ordered run (run union delta)
    smax = 8
    srun = run_mod.from_table(table, delta_cap=64)
    n_scan = 64
    s_ops = np.full(R, Op.NOP, np.int32)
    s_ops[:n_scan] = Op.SCAN
    s_keys = np.zeros(R, np.uint64)
    s_keys[:n_scan] = rng.integers(1, n_keys - smax, n_scan)
    s_lens = np.zeros(R, np.uint32)
    s_lens[:n_scan] = rng.integers(1, smax + 1, n_scan)
    sb_scan = batch(s_ops, s_keys, wv, vers=s_lens)
    launched0 = scan_kernels.scan_rows.launches
    _, rep, srun, srep = store.step(table, sb_scan, run=srun, scan_max=smax)
    scan_launches = scan_kernels.scan_rows.launches - launched0
    rt = _np(rep.rtype)[:n_scan]
    cnt = _np(srep.count)[:n_scan]
    khi = _np(srep.key_hi).view(np.uint32).astype(np.uint64)
    klo = _np(srep.key_lo).view(np.uint32).astype(np.uint64)
    sval = _np(srep.val)
    ok_rows = True
    for i in range(n_scan):
        n = int(s_lens[i])
        got = ((khi[i] << np.uint64(32)) | klo[i])[:cnt[i]]
        # keys 1..n_keys are dense, so an n-row scan from k is k..k+n-1
        want = np.arange(s_keys[i], s_keys[i] + n, dtype=np.uint64)
        ok_rows &= bool(cnt[i] == n and np.array_equal(got, want)
                        and (sval[i, :n, 1] == MAGIC).all())
    check("scan lanes return the dense key range with populate magic",
          ok_rows and (rt == Reply.VAL).all()
          and np.array_equal(_np(rep.ver)[:n_scan], cnt))

    # route identity: the kernel (the card's step) against its plain
    # version (the same step on CPU copies), then the step after a
    # merge-compact rebuild of the run
    if dev.type == "cuda":
        cpu = torch.device("cpu")
        _, _, _, srep_plain = store.step(
            _to(table, cpu), _to(sb_scan, cpu), run=_to(srun, cpu),
            scan_max=smax)
        check("the scan kernel ran in the card's step",
              scan_launches == 1)
    srun_rb = store.rebuild_run(table, srun)
    _, _, _, srep_rb = store.step(table, sb_scan, run=srun_rb, scan_max=smax)
    if dev.type == "cuda":
        check("scan replies bit-identical: kernel vs plain vs post-rebuild",
              all(np.array_equal(a, b) and np.array_equal(a, c)
                  for a, b, c in zip(_srep(srep), _srep(srep_plain),
                                     _srep(srep_rb))))
    else:
        check("scan replies bit-identical: plain vs post-rebuild",
              all(np.array_equal(a, c)
                  for a, c in zip(_srep(srep), _srep(srep_rb))))
    srun = srun_rb

    # write-through overlay: a SET in one batch is visible to the next
    # batch's scan without a rebuild
    probe = np.uint64(s_keys[0])
    w_ops = np.full(R, Op.NOP, np.int32)
    w_ops[0] = Op.SET
    w_keys = np.zeros(R, np.uint64)
    w_keys[0] = probe
    w_vals = np.zeros((R, 10), np.uint32)
    w_vals[0, 2] = 0xBEEF
    table, _, srun, _ = store.step(table, batch(w_ops, w_keys, w_vals),
                                   run=srun, scan_max=smax)
    _, _, srun, srep_d = store.step(table, sb_scan, run=srun, scan_max=smax)
    check("scan sees prior-batch SET through the delta overlay",
          int(_np(srep_d.count)[0]) >= 1
          and int(_np(srep_d.val)[0, 0, 2]) == 0xBEEF
          and int(_np(srep_d.delta_hits)[0]) >= 1)

    # the stale contract: overflow the 64-row overlay, scans answer RETRY
    # with no rows; a rebuild re-snapshots and the same scans answer VAL
    ov_keys = rng.choice(np.arange(1, n_keys + 1, dtype=np.uint64), 512,
                         replace=False)
    table, _, srun, _ = store.step(
        table, batch(np.full(512, Op.SET, np.int32), ov_keys, wv[:512],
                     width=512), run=srun, scan_max=smax)
    _, rep_st, srun, srep_st = store.step(table, sb_scan, run=srun,
                                          scan_max=smax)
    srun = store.rebuild_run(table, srun)
    _, rep_ok, _, _ = store.step(table, sb_scan, run=srun, scan_max=smax)
    check("stale overlay -> RETRY, rebuild_run -> VAL",
          not bool(srun.stale)
          and (_np(rep_st.rtype)[:n_scan] == Reply.RETRY).all()
          and (_np(srep_st.count)[:n_scan] == 0).all()
          and (_np(rep_ok.rtype)[:n_scan] == Reply.VAL).all())


def drive_locks(dev, rng):
    """Section 2."""
    wv = np.zeros((R, 10), np.uint32)
    lt = locks.create_sx(1 << 16, device=dev)
    lk = rng.integers(0, 1 << 14, R).astype(np.uint64)
    lops = np.where(rng.random(R) < 0.7, Op.ACQ_S, Op.ACQ_X).astype(np.int32)
    lt, lrep = lock2pl.step(lt, make_batch(lops, lk, width=R, val_words=1,
                                           device=dev))
    lrt = _np(lrep.rtype)
    check("lock2pl grants+rejects partition",
          ((lrt == Reply.GRANT) | (lrt == Reply.REJECT)).all()
          and (lrt == Reply.GRANT).any() and (lrt == Reply.REJECT).any())

    ft = locks.create_occ(1 << 16, device=dev)
    fk = np.arange(100, 100 + R // 4, dtype=np.uint64)
    ft, frep = fasst.step(ft, make_batch(np.full(len(fk), Op.LOCK, np.int32),
                                         fk, width=R, val_words=1,
                                         device=dev))
    granted = _np(frep.rtype)[:len(fk)] == Reply.GRANT
    # commit only granted lanes (a rejected lock is never committed)
    c_ops = np.where(granted, Op.COMMIT_VER, Op.NOP).astype(np.int32)
    ft, _ = fasst.step(ft, make_batch(c_ops, fk, width=R, val_words=1,
                                      device=dev))
    ft, frep3 = fasst.step(ft, make_batch(
        np.full(len(fk), Op.READ_VER, np.int32), fk, width=R, val_words=1,
        device=dev))
    v_after = _np(frep3.ver)[:len(fk)]
    # distinct keys can share a slot (REJECT, the no-wait contract);
    # granted rows read ver 1 after the commit
    check("fasst lock->commit bumps version",
          granted.mean() > 0.9 and (v_after[granted] == 1).all())

    lg = logring.create(16, 1 << 12, val_words=10, device=dev)
    lg, grep = logsrv.step(lg, make_batch(
        np.full(R, Op.LOG_APPEND, np.int32),
        rng.integers(0, 1 << 20, R).astype(np.uint64), wv, width=R,
        val_words=10, device=dev))
    check("log append acks all and heads sum to R",
          (_np(grep.rtype) == Reply.ACK).all()
          and int(_np(lg.head).astype(np.int64).sum()) == R)


def drive_tatp(dev):
    """Sections 3 and 4."""
    n_sub, w, cpb = 20_000, 1024, 8
    db = td.populate(np.random.default_rng(0), n_sub, val_words=10,
                     device=dev)
    run, init, drain = td.build_pipelined_runner(
        n_sub, w=w, cohorts_per_block=cpb, device=dev)
    carry = init(db)
    total = np.zeros(td.N_STATS, np.int64)
    t0 = time.time()
    for i in range(4):
        gen = torch.Generator(device=dev)
        gen.manual_seed(i)
        carry, s = run(carry, gen)
        total += _np(s).astype(np.int64).sum(axis=0)
    dt = time.time() - t0
    db, tail = drain(carry)
    total += _np(tail).astype(np.int64).sum(axis=0)
    att, com = int(total[td.STAT_ATTEMPTED]), int(total[td.STAT_COMMITTED])
    closes = com + int(total[td.STAT_AB_LOCK]) + \
        int(total[td.STAT_AB_MISSING]) + int(total[td.STAT_AB_VALIDATE])
    check("tatp accounting closes", closes == att == 4 * cpb * w)
    check("tatp magic_bad == 0", int(total[td.STAT_MAGIC_BAD]) == 0)
    check("tatp abort floor ~25%", 0.15 < 1 - com / att < 0.40)
    check("tatp all locks expired after drain", not bool(db.locked.any()))
    reps = [_np(logring.replica_entries(db.log, r)) for r in range(3)]
    check("tatp log x3 replicas identical",
          all(np.array_equal(reps[0], r) for r in reps[1:]))
    print(f"      tatp drive: {att / dt:.0f} attempted/s (w={w}, 4 blocks)")

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    db2 = td.populate_device(gen, 5_000, val_words=10, device=dev)
    ex = (_np(db2.meta) & 1).astype(bool)
    check("populate_device: subs all exist, cf partial",
          bool(ex[1:5001].all())
          and 0.10 < ex[10 * 5001:22 * 5001].mean() < 0.20)


def drive_smallbank(dev):
    """Section 5."""
    n_acc = 100_000
    bank = sd.create(n_acc, device=dev)
    base = int(sd.total_balance(bank))
    run, init, drain = sd.build_pipelined_runner(n_acc, w=1024,
                                                 cohorts_per_block=8,
                                                 device=dev)
    carry = init(bank)
    tot = np.zeros(sd.N_STATS, np.int64)
    for i in range(4):
        gen = torch.Generator(device=dev)
        gen.manual_seed(7 + i)
        carry, s = run(carry, gen)
        tot += _np(s).astype(np.int64).sum(axis=0)
    bank, tail = drain(carry)
    tot += _np(tail).astype(np.int64).sum(axis=0)
    final = int(sd.total_balance(bank))
    check("smallbank balance conservation",
          (final - base) % (1 << 32)
          == int(tot[sd.STAT_BAL_DELTA]) % (1 << 32))
    check("smallbank committed > 0", int(tot[sd.STAT_COMMITTED]) > 0)


def drive_wire(dev):
    """Section 6: three UDP shard servers and the wire coordinator."""
    from .clients import tatp_wire as tw
    with tw.serve_shards(500, width=256, flush_us=1000, device=dev) as ports:
        with tw.WireCoordinator(ports, 500, width=256, n_socks=2) as coord:
            st = coord.run_cohort(np.random.default_rng(1), 64)
    check("wire txns commit over UDP", st.committed > 0
          and st.committed + st.aborted_lock + st.aborted_validate
          + st.aborted_missing + st.aborted_timeout == st.attempted)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="End-to-end drive of the PyTorch port's public API.")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain path on the CPU")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    for fn in _WRAPPERS:
        fn.launches = 0
    rng = np.random.default_rng(0)
    try:
        drive_store(dev, rng)
        drive_locks(dev, rng)
        drive_tatp(dev)
        drive_smallbank(dev)
        drive_wire(dev)
    except DriveFailure:
        return 1
    print(json.dumps({"launches": {fn.__name__: fn.launches
                                   for fn in _WRAPPERS}}))
    print("ALL CHECKS PASSED on", torch.cuda.get_device_name(dev)
          if dev.type == "cuda" else "cpu", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
