"""Random-access row kernels of the dense TATP and SmallBank steps and the
store's cache tier (the counterparts of `dint_tpu/ops/pallas_gather.py`'s
`gather_rows`, `lock_arbitrate`, `lock_validate`, `gather_streams`,
`scatter_streams`, `gather_rows_hot` and `scatter_rows_hot`), and the
scalar scatter of the feasibility probe `tools/profile_pallas.py`.

Each wrapper checks its arguments and calls its operator
``torch.ops.dint.<name>`` (ops/library.py), whose implementation launches
the hand-written CUDA kernel (``csrc/<name>.cu``, built for sm_90a at
first use) when given CUDA tensors, and runs its plain PyTorch version
(``*_ref``) only when given CPU tensors. There is no fallback: on a CUDA
tensor the operator launches the kernel or raises. The launch runs under
the device guard of its tensors' card (`library.on_tensors_card`), so
the kernel, its stream and its build and grid queries belong to that
card whichever one is current. The checks a trace
cannot see (which storages the tensors share) run inside the
implementations. Each wrapper counts its kernel launches in
``<wrapper>.launches``.

Tables and words are int32 tensors holding u32 bit patterns (ops/u32.py);
the kernels read them as ``uint32_t``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build, library
from .u32 import pack_stamp, shr, to_u64, wrap_i32

I32 = torch.int32

_SIGNATURES = {
    "gather_rows": ("dint_gather_rows",
                    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]),
    "lock_arbitrate": ("dint_lock_arbitrate",
                       [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                        ctypes.c_uint32, ctypes.c_int, ctypes.c_int,
                        ctypes.c_void_p]),
    "lock_arbitrate_grid": ("dint_lock_arbitrate_grid",
                            [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]),
    "lock_validate": ("dint_lock_validate",
                      [ctypes.c_void_p] * 5 + [ctypes.c_int64]
                      + [ctypes.c_void_p] * 2 + [ctypes.c_int64]
                      + [ctypes.c_void_p] * 3
                      + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                         ctypes.c_uint32, ctypes.c_int, ctypes.c_int,
                         ctypes.c_void_p]),
    "lock_validate_grid": ("dint_lock_validate_grid",
                           [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]),
    "gather_streams": ("dint_gather_streams",
                       [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]),
    "scatter_streams": ("dint_scatter_streams",
                        [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]),
    "gather_rows_hot": ("dint_gather_rows_hot",
                        [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]),
    "scatter_rows_hot": ("dint_scatter_rows_hot",
                         [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]),
    "scan_rows": ("dint_scan_rows",
                  [ctypes.c_void_p] * 9
                  + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                     ctypes.c_void_p]),
    "scalar_scatter": ("dint_scalar_scatter",
                       [ctypes.c_void_p] * 5
                       + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                          ctypes.c_void_p]),
    "scalar_scatter_grid": ("dint_scalar_scatter_grid",
                            [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]),
}


def _kernel(name: str, device: torch.device, lib: str | None = None):
    """The C entry ``name`` of ``csrc/<lib or name>.cu``, with its ctypes
    signature set."""
    major, minor = torch.cuda.get_device_capability(device)
    if (major, minor) != (9, 0):
        raise RuntimeError(f"dint_tpu_torch kernels are built for sm_90a; "
                           f"{torch.cuda.get_device_name(device)} is "
                           f"sm_{major}{minor}")
    sym, argtypes = _SIGNATURES[name]
    fn = getattr(_build.load(lib or name), sym)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check(x: torch.Tensor, what: str, dtype=I32):
    if x.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {x.dtype}")
    if x.dim() != 1:
        raise ValueError(f"{what}: expected a 1-D tensor, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: tensor is not contiguous")


def _launched(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA kernel launch failed "
                           f"(cudaError {err})")


def _rows(tab: torch.Tensor, vw: int, what: str) -> int:
    """Rows of ``vw`` words in the flat table ``tab``."""
    if vw < 1 or tab.numel() % vw:
        raise ValueError(f"{what}: table of {tab.numel()} words is not rows "
                         f"of vw={vw}")
    return tab.numel() // vw


def _same_device(*xs: torch.Tensor) -> torch.device:
    dev = xs[0].device
    if any(x.device != dev for x in xs):
        raise ValueError("tensors are on different devices: "
                         + ", ".join(str(x.device) for x in xs))
    if dev.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _cooperative_grid(cache: dict, name: str, lib: str,
                      device: torch.device) -> int:
    """The most blocks a cooperative launch of kernel library ``lib`` may
    have on ``device`` (its SM count times the blocks an SM holds at once),
    queried through its C entry ``name`` once per device and kept in
    ``cache``; raises where the device has no cooperative launch."""
    blocks = cache.get(device.index)
    if blocks is None:
        fn = _kernel(name, device, lib)
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            _launched(fn(device.index, ctypes.byref(out)),
                      f"{lib} grid query")
        blocks = cache[device.index] = out.value
    return blocks


# --------------------------------------------------------------- row passes
#
# gather_rows (B1), gather_rows_hot (B6) and gather_streams (B5) share one
# device pass, csrc/gather_pass.cuh; scatter_streams (B3) and
# scatter_rows_hot (B7) share another, csrc/scatter_pass.cuh. Both are
# launched over a plan made here (`gather_plan`, `scatter_plan`): one flat
# grid in which each stream owns its own blocks, up to MAX_STREAMS streams
# a launch. gather_rows, gather_rows_hot and scatter_rows_hot take one
# stream (tensors) or a tuple of streams, one launch either way.

MAX_STREAMS = 8
# The stream capacities of both passes' launch arguments: a call takes the
# smallest that holds its streams (a smaller parameter block launches
# faster).
CAPACITIES = (1, 2, 4, MAX_STREAMS)
# Threads a block of csrc/gather_pass.cuh (its kThreads). With 2 lanes a
# thread at vw = 1, the fastest of {128, 256} threads x {1, 2, 4} lanes
# summed over the main paths' calls on the H100 (PERF.md §6).
GATHER_THREADS = 128
GATHER_MAX_GROUP = 16       # most threads that share a row at vw > 1
SCATTER_THREADS = 128       # threads a block of csrc/scatter_pass.cuh
# Most threads that share a row. Measured on the H100 at TATP's install_log
# (42-word log rows, 21 eight-byte stores): 16 a row ~1% faster than 32,
# 8 and 4 slower by ~6% and ~20% (PERF.md §6).
SCATTER_MAX_GROUP = 16


def _plan_struct(cap: int, pointers):
    """The by-value launch argument of a row pass for ``cap`` streams:
    per stream the named ``pointers``, the table's and the mirror's rows,
    K, vw, the vector width, log2 of the threads that share a row; the
    streams' first blocks and their number."""
    class _Plan(ctypes.Structure):
        _fields_ = ([(p, ctypes.c_void_p * cap) for p in pointers]
                    + [(f, ctypes.c_int64 * cap)
                       for f in ("n_rows", "n_mirror_rows")]
                    + [(f, ctypes.c_int32 * cap)
                       for f in ("k", "vw", "vec", "tpr_log2")]
                    + [("first_block", ctypes.c_uint32 * (cap + 1)),
                       ("n_streams", ctypes.c_int32)])
    return _Plan


# csrc/gather_pass.cuh's GatherPlan<cap>: 88, 160, 312 or 616 bytes
_GATHER_STRUCTS = {cap: _plan_struct(cap, ("tab", "mirror", "idx", "midx",
                                           "out"))
                   for cap in CAPACITIES}
# csrc/scatter_pass.cuh's ScatterPlan<cap>: 96, 176, 344 or 680 bytes
_SCATTER_STRUCTS = {cap: _plan_struct(cap, ("tab", "mirror", "idx", "midx",
                                            "mask", "vals"))
                    for cap in CAPACITIES}


class RowPlan(NamedTuple):
    """The launch plan of a row pass, per stream: ``vec`` (at vw = 1 the
    lanes a thread takes, 2 or 1, else the words a load or store moves, 4,
    2 or 1), ``group`` threads that share a row (1 at vw = 1), ``blocks``,
    and the exclusive prefix ``first_block`` of the blocks (one entry more
    than the streams; the last is the launch's total)."""
    vec: tuple
    group: tuple
    blocks: tuple
    first_block: tuple

    @property
    def total(self) -> int:
        return self.first_block[-1]


def alignment(*ptrs: int) -> int:
    """The largest of 16, 8 and 4 bytes that divides every pointer (16 for
    none or for null pointers only)."""
    bits = 0
    for p in ptrs:
        bits |= p
    return 16 if bits == 0 else min(16, bits & -bits)


def _row_plan(what, ks, vws, aligns, threads_a_block, max_group) -> RowPlan:
    n = len(ks)
    if not 1 <= n <= MAX_STREAMS or len(vws) != n or len(aligns) != n:
        raise ValueError(f"{what}: {n} streams ({len(vws)} vws, "
                         f"{len(aligns)} aligns); 1 to {MAX_STREAMS} "
                         f"allowed")
    vec, group, blocks = [], [], []
    for k, vw, al in zip(ks, vws, aligns):
        if k * vw >= 1 << 31:
            raise ValueError(f"{what}: {k} lanes of vw={vw} reach 2^31 "
                             f"words")
        if vw == 1:
            v = 2 if al % 8 == 0 else 1
            g = 1
            threads = -(-k // v)
        else:
            v = 4 if vw % 4 == 0 and al % 16 == 0 else (
                2 if vw % 2 == 0 and al % 8 == 0 else 1)
            g = min(1 << max(0, (vw // v - 1).bit_length()), max_group)
            threads = k * g
        if threads >= 1 << 31:
            raise ValueError(f"{what}: {k} lanes of vw={vw} need "
                             f"{threads} threads")
        vec.append(v)
        group.append(g)
        blocks.append(-(-threads // threads_a_block))
    first = [0]
    for b in blocks:
        first.append(first[-1] + b)
    return RowPlan(tuple(vec), tuple(group), tuple(blocks), tuple(first))


def gather_plan(ks, vws, aligns) -> RowPlan:
    """Plan the gather pass's one launch for streams of ``ks[s]`` lanes of
    ``vws[s]``-word rows. ``aligns[s]``: the bytes to which the pointers
    the stream's vector accesses touch are aligned (`gather_alignment`).

    vw = 1: a thread takes 2 lanes where the pointers are 8-byte aligned,
    else 1; stream s gets ceil(ceil(K_s / lanes) / GATHER_THREADS)
    blocks. vw > 1: a load moves 4 words where vw % 4 == 0 and the
    pointers are 16-byte aligned, 2 where vw is even and they are 8-byte
    aligned, else 1; a row is taken by the smallest power of two of
    threads, at most GATHER_MAX_GROUP, that covers its loads;
    ceil(K_s * group / GATHER_THREADS) blocks. An empty stream gets none.
    Raises for no or more than MAX_STREAMS streams, and where K * vw or
    the stream's threads reach 2^31 (the kernel's 32-bit index
    arithmetic)."""
    return _row_plan("gather_plan", ks, vws, aligns, GATHER_THREADS,
                     GATHER_MAX_GROUP)


def scatter_plan(ks, vws, aligns) -> RowPlan:
    """Plan the scatter pass's one launch, as `gather_plan` plans the
    gather pass's, with SCATTER_THREADS threads a block and at most
    SCATTER_MAX_GROUP threads a row (a group loops over the stores of a
    longer row). ``aligns[s]``: see `scatter_alignment`."""
    return _row_plan("scatter_plan", ks, vws, aligns, SCATTER_THREADS,
                     SCATTER_MAX_GROUP)


def gather_alignment(vw: int, tab, mirror, idx, midx, out) -> int:
    """The alignment (`alignment`) of the pointers a stream's vector
    accesses touch: at vw = 1 the index, mirror index and output arrays
    (a thread's lanes), at vw > 1 the table, mirror and output rows.
    ``mirror``/``midx`` may be None."""
    if vw == 1:
        ts = (idx, midx, out)
    else:
        ts = (tab, mirror, out)
    return alignment(*(t.data_ptr() for t in ts if t is not None))


def scatter_alignment(vw: int, tab, mirror, idx, midx, mask, vals) -> int:
    """The alignment of the pointers a scatter stream's vector accesses
    touch: at vw = 1 a thread's lanes of the index, mirror index and value
    arrays and of the one-byte mask (a mask aligned to b bytes holds lane
    pairs as a word array aligned to 4b does), at vw > 1 the table, mirror
    and value rows. ``mirror``, ``midx`` and ``mask`` may be None."""
    if vw == 1:
        ptrs = [t.data_ptr() for t in (idx, midx, vals) if t is not None]
        if mask is not None:
            ptrs.append(4 * mask.data_ptr())
        return alignment(*ptrs)
    return alignment(*(t.data_ptr() for t in (tab, mirror, vals)
                       if t is not None))


def _check_rows(what, tabs, mirrors, idxs, midxs, vws):
    """Check the tables, mirrors and indices of a row-pass call; returns
    (the tables' rows, the mirrors' rows or None)."""
    n = len(vws)
    if not 1 <= n <= MAX_STREAMS:
        raise ValueError(f"{what}: {n} streams; 1 to {MAX_STREAMS} allowed")
    if len(tabs) != n or len(idxs) != n or (
            mirrors is not None and (len(mirrors) != n or len(midxs) != n)):
        raise ValueError(f"{what}: streams disagree in number")
    n_rows, n_mirror = [], []
    for s in range(n):
        _check(tabs[s], f"{what} tabs[{s}]")
        _check(idxs[s], f"{what} idxs[{s}]")
        n_rows.append(_rows(tabs[s], vws[s], f"{what} stream {s}"))
        if mirrors is not None:
            _check(mirrors[s], f"{what} mirrors[{s}]")
            _check(midxs[s], f"{what} midxs[{s}]")
            if midxs[s].numel() != idxs[s].numel():
                raise ValueError(f"{what} stream {s}: {idxs[s].numel()} idx "
                                 f"but {midxs[s].numel()} midx lanes")
            n_mirror.append(_rows(mirrors[s], vws[s],
                                  f"{what} stream {s} mirror"))
    return n_rows, (n_mirror if mirrors is not None else None)


def _launch_plan(fn, structs, plan, dev, pointers, n_rows, n_mirror, ks,
                 vws):
    """Fill the launch argument of ``plan`` (the smallest capacity of
    ``structs`` that holds the streams; ``pointers``: field -> per-stream
    tensors, or None for null) and launch ``fn``'s kernel, counted on
    ``fn``."""
    n = len(vws)
    cap = next(c for c in CAPACITIES if c >= n)
    a = structs[cap]()
    for field, ts in pointers.items():
        if ts is not None:
            getattr(a, field)[:n] = [t.data_ptr() for t in ts]
    a.n_rows[:n] = n_rows
    if n_mirror is not None:
        a.n_mirror_rows[:n] = n_mirror
    a.k[:n] = ks
    a.vw[:n] = vws
    a.vec[:n] = plan.vec
    a.tpr_log2[:n] = [g.bit_length() - 1 for g in plan.group]
    a.first_block[:n + 1] = plan.first_block
    a.n_streams = n
    what = fn.__name__
    _launched(_kernel(what, dev)(ctypes.addressof(a), cap, _stream(dev)),
              what)
    fn.launches += 1


def _gather(fn, tabs, mirrors, idxs, midxs, vws):
    """Check a gather pass call and run it through ``fn``'s operator.
    Returns the tuple of outputs."""
    _check_rows(fn.__name__, tabs, mirrors, idxs, midxs, vws)
    _same_device(*tabs, *idxs, *(mirrors or ()), *(midxs or ()))
    op = library.op(fn.__name__)
    if mirrors is None:
        return tuple(op(list(tabs), list(idxs), list(vws)))
    return tuple(op(list(tabs), list(mirrors), list(idxs), list(midxs),
                    list(vws)))


def _gather_dev(fn, tabs, mirrors, idxs, midxs, vws):
    """The gather pass: the plain version on the CPU, on the card one
    launch of `gather_plan` over the streams (none when every stream is
    empty), counted on ``fn``. Returns the list of outputs."""
    n_rows, n_mirror = _check_rows(fn.__name__, tabs, mirrors, idxs, midxs,
                                   vws)
    dev = _same_device(*tabs, *idxs, *(mirrors or ()), *(midxs or ()))
    if dev.type == "cpu":
        return list(_gather_ref(tabs, mirrors, idxs, midxs, vws))
    ks = [i.numel() for i in idxs]
    outs = [torch.empty(k * vw, dtype=I32, device=dev)
            for k, vw in zip(ks, vws)]
    hot = mirrors is not None
    plan = gather_plan(ks, vws, [
        gather_alignment(vw, tab, mirrors[s] if hot else None, idx,
                         midxs[s] if hot else None, out)
        for s, (tab, idx, out, vw) in enumerate(zip(tabs, idxs, outs, vws))])
    if plan.total:
        _launch_plan(fn, _GATHER_STRUCTS, plan, dev,
                     {"tab": tabs, "mirror": mirrors, "idx": idxs,
                      "midx": midxs, "out": outs},
                     n_rows, n_mirror, ks, vws)
    return outs


def _gather_fake(tabs, idxs, vws):
    return [t.new_empty(i.numel() * vw) for t, i, vw in zip(tabs, idxs, vws)]


def _gather_ref(tabs, mirrors, idxs, midxs, vws):
    if mirrors is None:
        return tuple(tab.view(-1, vw).index_select(0, idx).reshape(-1)
                     for tab, idx, vw in zip(tabs, idxs, vws))
    return tuple(_hot_ref(*z) for z in zip(tabs, mirrors, idxs, midxs, vws))


def _scatter(fn, tabs, mirrors, idxs, midxs, masks, vals, vws):
    """Check a scatter pass call and run it through ``fn``'s operator;
    tables and mirrors are updated in place."""
    what = fn.__name__
    _check_rows(what, tabs, mirrors, idxs, midxs, vws)
    hot = mirrors is not None
    if len(vals) != len(vws) or (hot and len(masks) != len(vws)):
        raise ValueError(f"{what}: streams disagree in number")
    for s, (idx, val, vw) in enumerate(zip(idxs, vals, vws)):
        _check(val, f"{what} vals[{s}]")
        k = idx.numel()
        if val.numel() != k * vw:
            raise ValueError(f"{what} stream {s}: {val.numel()} values for "
                             f"{k} lanes of vw={vw}")
        if hot:
            _check(masks[s], f"{what} masks[{s}]", torch.bool)
            if masks[s].numel() != k:
                raise ValueError(f"{what} stream {s}: {k} lanes but "
                                 f"{masks[s].numel()} mask flags")
    _same_device(*tabs, *(mirrors or ()), *idxs, *vals, *(midxs or ()),
                 *(masks or ()))
    op = library.op(what)
    if hot:
        op(list(tabs), list(mirrors), list(idxs), list(midxs), list(masks),
           list(vals), list(vws))
    else:
        op(list(tabs), list(idxs), list(vals), list(vws))


def _scatter_dev(fn, tabs, mirrors, idxs, midxs, masks, vals, vws):
    """The scatter pass: the plain version on the CPU, on the card one
    launch of `scatter_plan` over the streams (none when every stream is
    empty), counted on ``fn``; tables and mirrors are updated in place.
    Raises where two tables or mirrors of the call share a storage, or
    values share one with them."""
    what = fn.__name__
    n_rows, n_mirror = _check_rows(what, tabs, mirrors, idxs, midxs, vws)
    hot = mirrors is not None
    written = tuple(tabs) + tuple(mirrors or ())
    stores = {t.untyped_storage().data_ptr() for t in written}
    if len(stores) != len(written):
        raise ValueError(f"{what}: the streams' tables and mirrors must be "
                         f"distinct arrays")
    # the kernel loads values through the read-only path (ld.global.nc),
    # which may not see the launch's own stores
    if any(v.numel() and v.untyped_storage().data_ptr() in stores
           for v in vals):
        raise ValueError(f"{what}: the values must not share memory with "
                         f"a table or mirror of the call")
    dev = _same_device(*written, *idxs, *vals, *(midxs or ()),
                       *(masks or ()))
    if dev.type == "cpu":
        _scatter_ref(tabs, mirrors, idxs, midxs, masks, vals, vws)
        return
    ks = [i.numel() for i in idxs]
    plan = scatter_plan(ks, vws, [
        scatter_alignment(vw, tabs[s], mirrors[s] if hot else None, idxs[s],
                          midxs[s] if hot else None, masks[s] if hot else None,
                          vals[s])
        for s, vw in enumerate(vws)])
    if plan.total:
        _launch_plan(fn, _SCATTER_STRUCTS, plan, dev,
                     {"tab": tabs, "mirror": mirrors, "idx": idxs,
                      "midx": midxs, "mask": masks, "vals": vals},
                     n_rows, n_mirror, ks, vws)


def _scatter_ref(tabs, mirrors, idxs, midxs, masks, vals, vws):
    """Plain version of the scatter pass: per stream, the masked-in lanes'
    rows copied in with ``index_copy_`` (their indices are unique, so no
    result depends on the order of duplicate writes); with a mirror, the
    hot ones among them into the mirror too."""
    for s, (tab, idx, val, vw) in enumerate(zip(tabs, idxs, vals, vws)):
        v = val.view(-1, vw)
        on = idx >= 0 if mirrors is None else masks[s]
        keep = torch.nonzero(on).squeeze(1)
        tab.view(-1, vw).index_copy_(0, idx[keep].long(), v[keep])
        if mirrors is not None:
            hot = torch.nonzero(on & (midxs[s] >= 0)).squeeze(1)
            mirrors[s].view(-1, vw).index_copy_(0, midxs[s][hot].long(),
                                                v[hot])


def _streams(tab, idx, vw, *rest):
    """(single call?, the arguments as tuples of streams)."""
    if isinstance(tab, torch.Tensor):
        return True, ((tab,), (idx,), (int(vw),), *((r,) for r in rest))
    return False, (tuple(tab), tuple(idx), tuple(int(v) for v in vw),
                   *(tuple(r) for r in rest))


def gather_rows_ref(tab, idx, vw=1):
    """Plain version: ``tab.view(-1, vw)[idx].reshape(-1)`` per stream, in
    `gather_rows`' forms; raises on an out-of-range index."""
    single, (tabs, idxs, vws) = _streams(tab, idx, vw)
    out = _gather_ref(tabs, None, idxs, None, vws)
    return out[0] if single else out


def gather_rows(tab, idx, vw=1):
    """K rows of ``vw`` words from the flat table ``tab`` (row r at
    [r*vw, (r+1)*vw)): returns i32 [K*vw]. Indices must lie in
    [0, len(tab)/vw); the kernel asserts it on the device. Callers that
    need one word at an offset inside wider rows pass pre-scaled flat word
    indices with vw=1 (the magic check's ``rows*VW + 1``).

    Several streams: ``gather_rows(tabs, idxs, vws)`` with tuples of up to
    MAX_STREAMS tables, index arrays and row widths returns the tuple of
    each stream's gather. One kernel launch a call either way."""
    single, (tabs, idxs, vws) = _streams(tab, idx, vw)
    out = _gather(gather_rows, tabs, None, idxs, None, vws)
    return out[0] if single else out


gather_rows.launches = 0


# ------------------------------------------------------- lock arbitration


def _check_lock_args(arb, rows, active, step, k_arb,
                     what="lock_arbitrate"):
    _check(arb, f"{what} arb")
    _check(rows, f"{what} rows")
    _check(active, f"{what} active", torch.bool)
    m = rows.numel()
    if active.numel() != m:
        raise ValueError(f"{what}: {m} rows but {active.numel()} "
                         f"active flags")
    if m > (1 << k_arb):
        raise ValueError(f"{what}: {m} lanes exceed the "
                         f"{k_arb}-bit slot field")
    if not 0 <= int(step) < (1 << (32 - k_arb)):
        raise ValueError(f"{what}: step {step} exceeds the "
                         f"{32 - k_arb}-bit step field")
    return _same_device(arb, rows, active)


def lock_arbitrate_ref(arb, rows, active, step: int, k_arb: int):
    """Plain version of the XLA chain (tatp_dense.py:728-735), arb updated
    in place. Returns (arb, grant bool [M])."""
    m = rows.numel()
    old = arb[rows]
    held = to_u64(shr(old, k_arb)) == ((int(step) - 1) & 0xFFFFFFFF)
    lane = torch.arange(m, device=rows.device)
    packed = pack_stamp(step, (m - 1) - lane, k_arb)
    cand = active & ~held
    rc = rows[cand].to(torch.int64)
    uniq, inv = torch.unique(rc, return_inverse=True)
    best = to_u64(arb[uniq])
    best.scatter_reduce_(0, inv, to_u64(packed[cand]), "amax")  # u32 max
    arb[uniq] = wrap_i32(best)
    grant = cand & (arb[rows] == packed)
    return arb, grant


# Threads a block of the lock pass (csrc/lock_pass.cuh), shared by
# lock_arbitrate and lock_validate.
LOCK_VALIDATE_THREADS = 256
# lane positions of each job a thread takes before the grid grows: the
# grid barrier costs ~5 ns a block on the H100, so blocks without lanes
# only slow the launch (PERF.md §6)
LOCK_VALIDATE_LANES_PER_THREAD = 1
# lock lanes one thread can own at most (the bits of its `cand` word)
LOCK_VALIDATE_MAX_LOCK_LANES = 64


class LockPlan(NamedTuple):
    """The cooperative launch of the lock pass: ``blocks`` of ``threads``
    (0 blocks: no launch). Thread tid takes lane positions tid, tid + G,
    ... of each job, G = blocks * threads."""
    blocks: int
    threads: int


def lock_pass_plan(lanes: int, m: int, k_arb: int, max_blocks: int,
                   what: str = "lock_arbitrate") -> LockPlan:
    """Plan the lock pass over jobs of at most ``lanes`` lanes, ``m`` of
    them lock lanes: the blocks the lanes need at one position a thread,
    at most ``max_blocks`` (the cooperative grid the card holds at once),
    none for no lanes. Raises where M exceeds the ``k_arb``-bit slot field
    or the lock lanes a thread may own."""
    if m > (1 << k_arb):
        raise ValueError(f"{what}: {m} lanes exceed the {k_arb}-bit slot "
                         f"field")
    if lanes == 0:
        return LockPlan(0, LOCK_VALIDATE_THREADS)
    per_block = LOCK_VALIDATE_THREADS * LOCK_VALIDATE_LANES_PER_THREAD
    blocks = min(max_blocks, -(-lanes // per_block))
    threads = blocks * LOCK_VALIDATE_THREADS
    if m > LOCK_VALIDATE_MAX_LOCK_LANES * threads:
        raise ValueError(f"{what}: {m} lock lanes exceed the "
                         f"{LOCK_VALIDATE_MAX_LOCK_LANES * threads} a "
                         f"{blocks}-block grid holds")
    return LockPlan(blocks, LOCK_VALIDATE_THREADS)


# the most blocks csrc/lock_arbitrate.cu's cooperative grid may have, per
# device index
_lock_arbitrate_grid: dict[int, int] = {}


def lock_arbitrate_grid(device: torch.device) -> int:
    """The most blocks lock_arbitrate's cooperative launch may have on
    ``device``, queried once per device."""
    return _cooperative_grid(_lock_arbitrate_grid, "lock_arbitrate_grid",
                             "lock_arbitrate", device)


def lock_arbitrate(arb, rows, active, step: int, k_arb: int):
    """First-lane-wins lock arbitration over the step-stamped arb array
    (stamp = ``step << k_arb | (M-1 - lane)``), arb updated in place.
    Returns (arb, grant bool [M]), equal to the XLA chain

        old  = arb[rows]; held = (old >> k_arb) == step - 1
        cand = active & ~held
        arb  = arb.at[rows[cand]].max(packed)
        grant = cand & (arb[rows] == packed)

    Rows must lie in [0, len(arb)); inactive lanes carry a valid sentinel
    row, as the engine's do. On the card it is one cooperative launch
    (`lock_pass_plan`; none when M = 0); a refused launch raises."""
    _check_lock_args(arb, rows, active, step, k_arb)
    return arb, library.op("lock_arbitrate")(arb, rows, active, int(step),
                                             int(k_arb))


def _lock_arbitrate_dev(arb, rows, active, step, k_arb):
    dev = _same_device(arb, rows, active)
    if dev.type == "cpu":
        return lock_arbitrate_ref(arb, rows, active, step, k_arb)[1]
    m = rows.numel()
    grant = torch.empty(m, dtype=torch.bool, device=dev)
    plan = lock_pass_plan(m, m, k_arb, lock_arbitrate_grid(dev))
    if plan.blocks == 0:
        return grant
    fn = _kernel("lock_arbitrate", dev)
    _launched(fn(arb.data_ptr(), rows.data_ptr(), active.data_ptr(),
                 grant.data_ptr(), m, arb.numel(), int(step), k_arb,
                 plan.blocks, _stream(dev)), "lock_arbitrate")
    lock_arbitrate.launches += 1
    return grant


def _lock_arbitrate_fake(arb, rows, active, step, k_arb):
    return rows.new_empty(rows.shape, dtype=torch.bool)


lock_arbitrate.launches = 0


# ------------------------------------------------- lock + validate (fused)


def lock_validate_ref(arb, meta, vidx, vv1, ridx, rows, active, step: int,
                      k_arb: int):
    """Plain version: the unfused composition, arb updated in place."""
    vbad = gather_rows_ref(meta, vidx) != vv1
    rmeta = gather_rows_ref(meta, ridx)
    arb, grant = lock_arbitrate_ref(arb, rows, active, step, k_arb)
    return arb, grant, vbad, rmeta


# the most blocks csrc/lock_validate.cu's cooperative grid may have, per
# device index
_lock_validate_grid: dict[int, int] = {}


def lock_validate_grid(device: torch.device) -> int:
    """The most blocks lock_validate's cooperative launch may have on
    ``device``: its SM count times the blocks an SM holds at once.
    Queried once per device; raises where the device has no cooperative
    launch."""
    return _cooperative_grid(_lock_validate_grid, "lock_validate_grid",
                             "lock_validate", device)


def lock_validate(arb, meta, vidx, vv1, ridx, rows, active, step: int,
                  k_arb: int):
    """The fused route's lock + validate pass, arb updated in place.
    Returns (arb, grant bool [M], vbad bool [V], rmeta i32 [R]) with

        (arb, grant) = lock_arbitrate(arb, rows, active, step, k_arb)
        vbad[i]      = meta[vidx[i]] != vv1[i]
        rmeta        = meta[ridx]

    ``meta`` and ``arb`` must be distinct arrays, and every index in
    bounds (asserted on the device). On the card it is one cooperative
    launch (none when V = R = M = 0); a refused launch raises."""
    _check_lock_args(arb, rows, active, step, k_arb, "lock_validate")
    for x, what in ((meta, "meta"), (vidx, "vidx"), (vv1, "vv1"),
                    (ridx, "ridx")):
        _check(x, f"lock_validate {what}")
    if vv1.numel() != vidx.numel():
        raise ValueError(f"lock_validate: {vidx.numel()} vidx but "
                         f"{vv1.numel()} vv1 lanes")
    _same_device(arb, meta, vidx, vv1, ridx)
    grant, vbad, rmeta = library.op("lock_validate")(
        arb, meta, vidx, vv1, ridx, rows, active, int(step), int(k_arb))
    return arb, grant, vbad, rmeta


def _lock_validate_dev(arb, meta, vidx, vv1, ridx, rows, active, step,
                       k_arb):
    if meta.untyped_storage().data_ptr() == arb.untyped_storage().data_ptr():
        raise ValueError("lock_validate: meta and arb must be distinct arrays")
    dev = _same_device(arb, meta, vidx, vv1, ridx, rows, active)
    if dev.type == "cpu":
        return lock_validate_ref(arb, meta, vidx, vv1, ridx, rows, active,
                                 step, k_arb)[1:]
    v, r, m = vidx.numel(), ridx.numel(), rows.numel()
    vbad = torch.empty(v, dtype=torch.bool, device=dev)
    rmeta = torch.empty(r, dtype=I32, device=dev)
    grant = torch.empty(m, dtype=torch.bool, device=dev)
    plan = lock_pass_plan(max(v, r, m), m, k_arb, lock_validate_grid(dev),
                          "lock_validate")
    if plan.blocks == 0:
        return grant, vbad, rmeta
    fn = _kernel("lock_validate", dev)
    _launched(fn(arb.data_ptr(), meta.data_ptr(), vidx.data_ptr(),
                 vv1.data_ptr(), vbad.data_ptr(), v, ridx.data_ptr(),
                 rmeta.data_ptr(), r, rows.data_ptr(), active.data_ptr(),
                 grant.data_ptr(), m, meta.numel(), arb.numel(), int(step),
                 k_arb, plan.blocks, _stream(dev)), "lock_validate")
    lock_validate.launches += 1
    return grant, vbad, rmeta


def _lock_validate_fake(arb, meta, vidx, vv1, ridx, rows, active, step,
                        k_arb):
    b = torch.bool
    return (rows.new_empty(rows.shape, dtype=b),
            vidx.new_empty(vidx.shape, dtype=b), ridx.new_empty(ridx.shape))


lock_validate.launches = 0


# ------------------------------------------------------------ row streams


def gather_streams_ref(tabs, idxs, vws):
    """Plain version: `gather_rows_ref`'s tuple form."""
    return gather_rows_ref(tuple(tabs), tuple(idxs), tuple(vws))


def gather_streams(tabs, idxs, vws):
    """N independent row gathers in one launch: stream s gathers
    ``idxs[s]`` rows of ``vws[s]`` words from ``tabs[s]``, each stream equal
    to ``gather_rows(tabs[s], idxs[s], vws[s])``. Returns a tuple of i32
    [K_s * vws[s]]. At most MAX_STREAMS streams; indices must be in
    bounds (asserted on the device). The launch is `gather_rows`' tuple
    form's, counted here."""
    return _gather(gather_streams, tuple(tabs), None, tuple(idxs), None,
                   tuple(int(v) for v in vws))


gather_streams.launches = 0


def scatter_streams_ref(tabs, idxs, vals, vws):
    """Plain version: per stream, the lanes with ``idx >= 0`` are kept and
    their rows copied in with ``index_copy_`` (kept indices are unique, so
    no result depends on the order of duplicate writes)."""
    tabs = tuple(tabs)
    _scatter_ref(tabs, None, tuple(idxs), None, None, tuple(vals),
                 tuple(int(v) for v in vws))
    return tabs


def scatter_streams(tabs, idxs, vals, vws):
    """N independent masked row scatters in one launch, tables updated in
    place: stream s writes ``vals[s]`` row i into row ``idxs[s][i]`` of
    ``tabs[s]`` wherever that index is >= 0, and lanes with a negative
    index write nothing. The streams' tables must be distinct arrays, and
    the masked-in indices of a stream unique (the engines' one-writer-per-
    row certification). Returns the tuple of tables."""
    tabs = tuple(tabs)
    _scatter(scatter_streams, tabs, None, tuple(idxs), None, None,
             tuple(vals), tuple(int(v) for v in vws))
    return tabs


scatter_streams.launches = 0


# ---------------------------------------------------------------- hot tier


def _hot_ref(tab, mirror, idx, midx, vw):
    hot = midx >= 0
    cold = tab.view(-1, vw).index_select(0, torch.where(hot, 0, idx))
    warm = mirror.view(-1, vw).index_select(0, midx.clamp(min=0))
    return torch.where(hot[:, None], warm, cold).reshape(-1)


def gather_rows_hot_ref(tab, mirror, idx, midx, vw=1):
    """Plain version, in `gather_rows_hot`'s forms: the mirror row where
    ``midx >= 0``, else the table row (a hot lane's ``idx`` is not read)."""
    single, (tabs, idxs, vws, mirrors, midxs) = _streams(tab, idx, vw,
                                                         mirror, midx)
    out = _gather_ref(tabs, mirrors, idxs, midxs, vws)
    return out[0] if single else out


def gather_rows_hot(tab, mirror, idx, midx, vw=1):
    """The hot tier's partitioned gather: row ``midx[i]`` of ``mirror``
    where ``midx[i] >= 0``, else row ``idx[i]`` of ``tab`` (rows of ``vw``
    words). Returns i32 [K*vw], equal to ``gather_rows(tab, idx, vw)``
    whenever the mirror mirrors the table. A hot lane's ``idx`` addresses
    nothing and may hold anything.

    Several streams: ``gather_rows_hot(tabs, mirrors, idxs, midxs, vws)``
    with tuples of up to MAX_STREAMS of each returns the tuple of each
    stream's gather. One kernel launch a call either way."""
    single, (tabs, idxs, vws, mirrors, midxs) = _streams(tab, idx, vw,
                                                         mirror, midx)
    out = _gather(gather_rows_hot, tabs, mirrors, idxs, midxs, vws)
    return out[0] if single else out


gather_rows_hot.launches = 0


def scatter_rows_hot_ref(tab, mirror, idx, midx, mask, vals, vw=1):
    """Plain version, in `scatter_rows_hot`'s forms: the masked-in lanes'
    rows copied into the table, and the hot ones among them into the
    mirror (``index_copy_`` of unique rows); both updated in place. A
    masked-out lane's ``idx`` and ``midx`` are not read."""
    single, (tabs, idxs, vws, mirrors, midxs, masks, vals) = _streams(
        tab, idx, vw, mirror, midx, mask, vals)
    _scatter_ref(tabs, mirrors, idxs, midxs, masks, vals, vws)
    return (tab, mirror) if single else (tabs, mirrors)


def scatter_rows_hot(tab, mirror, idx, midx, mask, vals, vw=1):
    """The hot tier's write-through install, in place: every lane with
    ``mask`` set writes ``vals`` row i into row ``idx[i]`` of ``tab`` and,
    where ``midx[i] >= 0``, into row ``midx[i]`` of ``mirror``. Indices
    among masked-in lanes must be unique; a masked-out lane's ``idx`` and
    ``midx`` address nothing and may hold anything. Returns (tab, mirror).

    Several streams: ``scatter_rows_hot(tabs, mirrors, idxs, midxs, masks,
    vals, vws)`` with tuples of up to MAX_STREAMS of each returns (tabs,
    mirrors); streams may share their ``idx``, ``midx`` and ``mask``
    tensors, and every table and mirror must be a distinct array. One
    kernel launch a call either way."""
    single, (tabs, idxs, vws, mirrors, midxs, masks, vals) = _streams(
        tab, idx, vw, mirror, midx, mask, vals)
    _scatter(scatter_rows_hot, tabs, mirrors, idxs, midxs, masks, vals, vws)
    return (tab, mirror) if single else (tabs, mirrors)


scatter_rows_hot.launches = 0


# ---------------------------------------------------------- scalar scatter


def _check_scalar_scatter(tab, idx, val):
    for x, what in ((tab, "tab"), (idx, "idx"), (val, "val")):
        if x.dtype != I32:
            raise TypeError(f"scalar_scatter {what}: expected {I32}, got "
                            f"{x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"scalar_scatter {what}: tensor is not "
                             f"contiguous")
    if idx.numel() != val.numel():
        raise ValueError(f"scalar_scatter: {idx.numel()} indices but "
                         f"{val.numel()} values")
    if tab.numel() >= (1 << 31):
        raise ValueError("scalar_scatter: the table exceeds i32 indices")
    return _same_device(tab, idx, val)


def scalar_scatter_ref(tab, idx, val):
    """Plain version: each index keeps its last lane (a stable sort by
    index, the last lane of each run), then one indexed write of unique
    indices into a copy of ``tab``. Raises on an index outside
    [0, tab.numel())."""
    i = idx.reshape(-1).to(torch.int64)
    v = val.reshape(-1)
    if bool(((i < 0) | (i >= tab.numel())).any()):
        raise IndexError(f"scalar_scatter: an index lies outside "
                         f"[0, {tab.numel()})")
    order = torch.sort(i, stable=True).indices
    s = i[order]
    last = torch.ones_like(s, dtype=torch.bool)
    last[:-1] = s[1:] != s[:-1]
    keep = order[last]
    out = tab.clone()
    out.view(-1)[i[keep]] = v[keep]
    return out


SCALAR_SCATTER_THREADS = 512     # threads a block of csrc/scalar_scatter.cu


class ScalarScatterPlan(NamedTuple):
    """The launch of csrc/scalar_scatter.cu: ``blocks`` (0: no launch) and
    the words of the claim table ``win`` it needs (0 when K = 0: no lane
    claims)."""
    blocks: int
    win_words: int


def scalar_scatter_plan(n: int, k: int, max_blocks: int) -> ScalarScatterPlan:
    """Plan scalar_scatter over a table of ``n`` words and ``k`` lanes:
    ``max_blocks`` (`scalar_scatter_grid`: one block an SM), but no more
    blocks than one 16-byte word or one lane a thread needs, at least one
    (none for an empty table); a claim table of one word per table word,
    rounded up to a power of two so that a stream's table is regrown
    seldom."""
    if n == 0:
        return ScalarScatterPlan(0, 0)
    work = -(-max(-(-n // 4), k) // SCALAR_SCATTER_THREADS)
    blocks = max(1, min(max_blocks, work))
    return ScalarScatterPlan(blocks, 1 << (n - 1).bit_length() if k else 0)


# the most blocks csrc/scalar_scatter.cu's cooperative grid may have, per
# device index (SMs times blocks an SM holds)
_scalar_scatter_grid: dict[int, int] = {}
# the claim table of each (device index, stream) that has called
# scalar_scatter: all -1 between calls (each call leaves it as it found it)
_claim_tables: dict[tuple[int, int], torch.Tensor] = {}
# the tables captured CUDA graphs use, by address: kept when their stream's
# table is outgrown, since a graph replays the table it captured
_graph_claim_tables: dict[int, torch.Tensor] = {}


def scalar_scatter_grid(device: torch.device) -> int:
    """scalar_scatter's grid on ``device``: one block an SM, at most the
    blocks its cooperative launch may have (queried once per device).
    Measured on the H100 at the probe's shape, this beats the cooperative
    maximum of three blocks an SM, its half and its quarter: the grid
    barrier costs more the more blocks it joins, and one block of 512
    threads an SM keeps enough of the copy's loads in flight (PERF.md
    §6)."""
    most = _cooperative_grid(_scalar_scatter_grid, "scalar_scatter_grid",
                             "scalar_scatter", device)
    return min(most, torch.cuda.get_device_properties(
        device).multi_processor_count)


def _claim_table(dev: torch.device, stream: int, words: int):
    """The stream's claim table of at least ``words`` words, allocated
    cleared (-1) at the first call on the stream and when a call needs a
    larger one (the smaller is then dropped, unless a graph uses it).

    Never allocated while the stream is being captured into a CUDA graph:
    the fill would run only inside the graph. A capture therefore needs an
    eager call on the capture stream first, at this size or larger, and
    raises without one. Every graph captured on a stream uses that stream's
    one table, as do the stream's eager calls: replay them one at a time,
    never two at once."""
    key = (dev.index, stream)
    table = _claim_tables.get(key)
    capturing = dev.type == "cuda" and torch.cuda.is_current_stream_capturing()
    if table is None or table.numel() < words:
        if capturing:
            raise RuntimeError(
                f"scalar_scatter: no claim table of {words} words for the "
                f"stream being captured; call scalar_scatter once on that "
                f"stream, outside the capture, at this table size or larger")
        table = torch.full((words,), -1, dtype=I32, device=dev)
        _claim_tables[key] = table
    if capturing:
        _graph_claim_tables[table.data_ptr()] = table
    return table


def scalar_scatter(tab, idx, val):
    """The probe's scalar scatter: a new table of ``tab``'s shape, equal
    to ``tab`` with ``val[i]`` stored at flat word ``idx[i]`` for i = 0 ..
    K-1 in order, so that where lanes share an index the last one wins.
    ``idx`` and ``val`` hold K words in any contiguous shape ([K] or the
    probe's [K, 1]); indices must lie in [0, tab.numel()) (asserted on the
    device). On the card it is one cooperative launch and nothing else on
    the stream (`scalar_scatter_plan`); a refused launch raises. To capture
    it in a CUDA graph, call it once on the capture stream first (see
    `_claim_table`)."""
    _check_scalar_scatter(tab, idx, val)
    return library.op("scalar_scatter")(tab, idx, val)


def _scalar_scatter_dev(tab, idx, val):
    dev = _same_device(tab, idx, val)
    if dev.type == "cpu":
        return scalar_scatter_ref(tab, idx, val)
    n, k = tab.numel(), idx.numel()
    if n == 0:
        if k:
            raise IndexError("scalar_scatter: indices into an empty table")
        return torch.empty_like(tab)
    stream = _stream(dev)
    plan = scalar_scatter_plan(n, k, scalar_scatter_grid(dev))
    win = (_claim_table(dev, stream, plan.win_words).data_ptr()
           if plan.win_words else None)
    out = torch.empty_like(tab)
    fn = _kernel("scalar_scatter", dev)
    _launched(fn(tab.data_ptr(), out.data_ptr(), idx.data_ptr(),
                 val.data_ptr(), win, n, k, plan.blocks, stream),
              "scalar_scatter")
    scalar_scatter.launches += 1
    return out


scalar_scatter.launches = 0


WRAPPERS = (gather_rows, lock_arbitrate, lock_validate, gather_streams,
            scatter_streams, gather_rows_hot, scatter_rows_hot,
            scalar_scatter)


def reset_launches():
    for fn in WRAPPERS:
        fn.launches = 0


# ------------------------------------------------- the operators' kernels


def _scatter_streams_fake(tabs, idxs, vals, vws):
    return None


def _scatter_rows_hot_fake(tabs, mirrors, idxs, midxs, masks, vals, vws):
    return None


def _gather_hot_fake(tabs, mirrors, idxs, midxs, vws):
    return _gather_fake(tabs, idxs, vws)


library.impl("gather_rows",
             lambda tabs, idxs, vws: _gather_dev(gather_rows, tabs, None,
                                                 idxs, None, vws),
             _gather_fake)
library.impl("gather_streams",
             lambda tabs, idxs, vws: _gather_dev(gather_streams, tabs, None,
                                                 idxs, None, vws),
             _gather_fake)
library.impl("gather_rows_hot",
             lambda tabs, mirrors, idxs, midxs, vws: _gather_dev(
                 gather_rows_hot, tabs, mirrors, idxs, midxs, vws),
             _gather_hot_fake)
library.impl("scatter_streams",
             lambda tabs, idxs, vals, vws: _scatter_dev(
                 scatter_streams, tabs, None, idxs, None, None, vals, vws),
             _scatter_streams_fake)
library.impl("scatter_rows_hot",
             lambda tabs, mirrors, idxs, midxs, masks, vals, vws:
             _scatter_dev(scatter_rows_hot, tabs, mirrors, idxs, midxs, masks,
                          vals, vws),
             _scatter_rows_hot_fake)
library.impl("lock_arbitrate", lambda *a: _lock_arbitrate_dev(*a),
             _lock_arbitrate_fake)
library.impl("lock_validate", lambda *a: _lock_validate_dev(*a),
             _lock_validate_fake)
library.impl("scalar_scatter", lambda *a: _scalar_scatter_dev(*a),
             lambda tab, idx, val: torch.empty_like(tab))
