"""Random-access row kernels of the dense TATP step (the counterpart of
`dint_tpu/ops/pallas_gather.py`'s `gather_rows` and `lock_arbitrate`).

Each wrapper launches its hand-written CUDA kernel (``csrc/<name>.cu``,
built for sm_90a at first use) when given CUDA tensors, and runs its plain
PyTorch version (``*_ref``) only when given CPU tensors. There is no
fallback: on a CUDA tensor the wrapper launches the kernel or raises. Each
wrapper counts its kernel launches in ``<wrapper>.launches``.

Tables and words are int32 tensors holding u32 bit patterns (ops/u32.py);
the kernels read them as ``uint32_t``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .u32 import pack_stamp, shr, to_u64, wrap_i32

I32 = torch.int32

_SIGNATURES = {
    "gather_rows": ("dint_gather_rows",
                    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                     ctypes.c_void_p]),
    "lock_arbitrate": ("dint_lock_arbitrate",
                       [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                        ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p]),
}


def _kernel(name: str, device: torch.device):
    """The C entry of ``csrc/<name>.cu``, with its ctypes signature set."""
    major, minor = torch.cuda.get_device_capability(device)
    if (major, minor) != (9, 0):
        raise RuntimeError(f"dint_tpu_torch kernels are built for sm_90a; "
                           f"{torch.cuda.get_device_name(device)} is "
                           f"sm_{major}{minor}")
    sym, argtypes = _SIGNATURES[name]
    fn = getattr(_build.load(name), sym)
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


def _same_device(*xs: torch.Tensor) -> torch.device:
    dev = xs[0].device
    if any(x.device != dev for x in xs):
        raise ValueError("tensors are on different devices: "
                         + ", ".join(str(x.device) for x in xs))
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


# ------------------------------------------------------------- row gather


def gather_rows_ref(tab: torch.Tensor, idx: torch.Tensor, vw: int = 1):
    """Plain version: ``tab.view(-1, vw)[idx].reshape(-1)``; raises on an
    out-of-range index."""
    return tab.view(-1, vw).index_select(0, idx).reshape(-1)


def gather_rows(tab: torch.Tensor, idx: torch.Tensor, vw: int = 1):
    """K rows of ``vw`` words from the flat table ``tab`` (row r at
    [r*vw, (r+1)*vw)): returns i32 [K*vw]. Indices must lie in
    [0, len(tab)/vw); the kernel asserts it on the device. Callers that
    need one word at an offset inside wider rows pass pre-scaled flat word
    indices with vw=1 (the magic check's ``rows*VW + 1``)."""
    _check(tab, "gather_rows tab")
    _check(idx, "gather_rows idx")
    if vw < 1 or tab.numel() % vw:
        raise ValueError(f"gather_rows: table of {tab.numel()} words is not "
                         f"rows of vw={vw}")
    dev = _same_device(tab, idx)
    if dev.type == "cpu":
        return gather_rows_ref(tab, idx, vw)
    k = idx.numel()
    out = torch.empty(k * vw, dtype=I32, device=dev)
    fn = _kernel("gather_rows", dev)
    _launched(fn(tab.data_ptr(), idx.data_ptr(), out.data_ptr(), k,
                 tab.numel() // vw, vw, _stream(dev)), "gather_rows")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


# ------------------------------------------------------- lock arbitration


def _check_lock_args(arb, rows, active, step, k_arb):
    _check(arb, "lock_arbitrate arb")
    _check(rows, "lock_arbitrate rows")
    _check(active, "lock_arbitrate active", torch.bool)
    m = rows.numel()
    if active.numel() != m:
        raise ValueError(f"lock_arbitrate: {m} rows but {active.numel()} "
                         f"active flags")
    if m > (1 << k_arb):
        raise ValueError(f"lock_arbitrate: {m} lanes exceed the "
                         f"{k_arb}-bit slot field")
    if not 0 <= int(step) < (1 << (32 - k_arb)):
        raise ValueError(f"lock_arbitrate: step {step} exceeds the "
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


def lock_arbitrate(arb, rows, active, step: int, k_arb: int):
    """First-lane-wins lock arbitration over the step-stamped arb array
    (stamp = ``step << k_arb | (M-1 - lane)``), arb updated in place.
    Returns (arb, grant bool [M]), equal to the XLA chain

        old  = arb[rows]; held = (old >> k_arb) == step - 1
        cand = active & ~held
        arb  = arb.at[rows[cand]].max(packed)
        grant = cand & (arb[rows] == packed)

    Rows must lie in [0, len(arb)); inactive lanes carry a valid sentinel
    row, as the engine's do."""
    dev = _check_lock_args(arb, rows, active, step, k_arb)
    if dev.type == "cpu":
        return lock_arbitrate_ref(arb, rows, active, step, k_arb)
    m = rows.numel()
    grant = torch.empty(m, dtype=torch.bool, device=dev)
    fn = _kernel("lock_arbitrate", dev)
    _launched(fn(arb.data_ptr(), rows.data_ptr(), active.data_ptr(),
                 grant.data_ptr(), m, arb.numel(), int(step), k_arb,
                 _stream(dev)), "lock_arbitrate")
    lock_arbitrate.launches += 1
    return arb, grant


lock_arbitrate.launches = 0


WRAPPERS = (gather_rows, lock_arbitrate)


def reset_launches():
    for fn in WRAPPERS:
        fn.launches = 0
