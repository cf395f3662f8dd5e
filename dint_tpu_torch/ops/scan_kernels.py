"""The range-scan window gather of the store engine (the counterpart of
`dint_tpu/ops/pallas_gather.py`'s `scan_rows` and its dispatcher
`scan_slab`).

`scan_rows` checks its arguments and calls ``torch.ops.dint.scan_rows``
(ops/library.py), which launches the hand-written CUDA kernel
``csrc/scan_rows.cu`` (built for sm_90a at first use) on CUDA tensors, and
runs its plain PyTorch version `scan_rows_ref` only on CPU tensors; on a
CUDA tensor it launches the kernel or raises. It counts its launches in
``scan_rows.launches``. Words are int32 tensors holding u32 bit patterns.

Unlike the Pallas kernel, `scan_rows` takes no lane walk order: the TPU
kernel walks lanes in ascending offset so that consecutive DMAs of its one
sequential program touch adjacent memory, and its output does not depend
on that order. On the card every lane is an independent thread block.
"""
from __future__ import annotations

import torch

from . import library
from .row_kernels import _check, _kernel, _launched, _same_device, _stream

I32 = torch.int32


def _check_scan(run_hi, run_lo, run_ver, run_val, off, lg, vw):
    for x, what in ((run_hi, "run_hi"), (run_lo, "run_lo"),
                    (run_ver, "run_ver"), (run_val, "run_val"),
                    (off, "off")):
        _check(x, f"scan_rows {what}")
    cap = run_hi.numel()
    if run_lo.numel() != cap or run_ver.numel() != cap \
            or run_val.numel() != cap * vw:
        raise ValueError(f"scan_rows: run arrays disagree with cap={cap}, "
                         f"vw={vw}")
    if not 1 <= lg <= cap:
        raise ValueError(f"scan_rows: window of {lg} rows over {cap}")
    return _same_device(run_hi, run_lo, run_ver, run_val, off), cap


def scan_rows_ref(run_hi, run_lo, run_ver, run_val, off, lg: int, vw: int):
    """Plain version, the index form of the XLA slab gather
    (`_xla_scan_slab`): rows ``off[:, None] + arange(lg)`` of each array.
    Raises on an offset outside [0, cap - lg]."""
    cap = run_hi.numel()
    if bool(((off < 0) | (off > cap - lg)).any()):
        raise IndexError(f"scan_rows: an offset lies outside [0, {cap - lg}]")
    idx = (off.to(torch.int64)[:, None]
           + torch.arange(lg, device=off.device)[None, :])
    widx = (idx * vw)[:, :, None] + torch.arange(vw, device=off.device)
    return (run_hi[idx].reshape(-1), run_lo[idx].reshape(-1),
            run_ver[idx].reshape(-1), run_val[widx].reshape(-1))


def scan_rows(run_hi, run_lo, run_ver, run_val, off, lg: int, vw: int):
    """K windows of ``lg`` consecutive rows of the ordered run: lane i
    copies rows [off[i], off[i] + lg) of run_hi, run_lo and run_ver and
    their ``lg * vw`` val words. Returns flat (hi, lo, ver [K*lg], val
    [K*lg*vw]) i32. Every offset must lie in [0, cap - lg] (the engine
    clamps them); the kernel asserts it on the device."""
    lg, vw = int(lg), int(vw)
    _check_scan(run_hi, run_lo, run_ver, run_val, off, lg, vw)
    return tuple(library.op("scan_rows")(run_hi, run_lo, run_ver, run_val,
                                         off, lg, vw))


def _scan_rows_dev(run_hi, run_lo, run_ver, run_val, off, lg, vw):
    dev, cap = _check_scan(run_hi, run_lo, run_ver, run_val, off, lg, vw)
    if dev.type == "cpu":
        return scan_rows_ref(run_hi, run_lo, run_ver, run_val, off, lg, vw)
    k = off.numel()
    outs = [torch.empty(k * lg, dtype=I32, device=dev) for _ in range(3)]
    outs.append(torch.empty(k * lg * vw, dtype=I32, device=dev))
    fn = _kernel("scan_rows", dev)
    _launched(fn(run_hi.data_ptr(), run_lo.data_ptr(), run_ver.data_ptr(),
                 run_val.data_ptr(), off.data_ptr(),
                 *(o.data_ptr() for o in outs), k, cap, lg, vw,
                 _stream(dev)), "scan_rows")
    scan_rows.launches += 1
    return tuple(outs)


def _scan_rows_fake(run_hi, run_lo, run_ver, run_val, off, lg, vw):
    n = off.numel() * lg
    return (*(run_hi.new_empty(n) for _ in range(3)),
            run_hi.new_empty(n * vw))


scan_rows.launches = 0


def scan_slab(run_hi, run_lo, run_ver, run_val, off, lg: int, vw: int):
    """The engine's entry point for the scan window gather: `scan_rows`
    reshaped to (hi, lo, ver [K, lg], val [K, lg, vw])."""
    off = off.to(I32).contiguous()
    k = off.numel()
    hi, lo, ver, val = scan_rows(run_hi, run_lo, run_ver, run_val, off, lg,
                                 vw)
    return (hi.view(k, lg), lo.view(k, lg), ver.view(k, lg),
            val.view(k, lg, vw))


WRAPPERS = (scan_rows,)

library.impl("scan_rows", lambda *a: _scan_rows_dev(*a), _scan_rows_fake)
