"""ctypes bindings for the native host shim, `native/shim.cc` (the port of
`dint_tpu.shim.native`).

The shim is a C++ UDP pump: an RX thread drains the socket with recvmmsg
into fixed-width struct-of-arrays batches, `ShimServer.poll` hands one
batch to Python as numpy views over the C++ ring, and `ShimServer.reply`
serialises the reply codes into the request packets and scatters them with
sendmmsg. `ShimClient.exchange` is the synthetic client: one batched send,
then the replies of the same count.

What differs from JAX: the library is compiled from ``native/shim.cc`` as
the repository holds it, with ``$CXX`` (g++ unless set) and the flags of
``native/Makefile``, into the git-ignored ``dint_tpu_torch/_build/`` under a
name hashed from the compiler, the flags and the source, so an unchanged
source is not rebuilt. The build runs at first use, never at import, and
writes a temporary file that `os.replace` moves into place, so concurrent
processes each see a whole library. A failed build raises with the
compiler's output. Nothing under ``native/`` is written or loaded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..ops._build import BUILD_DIR

VAL_SIZE = 40           # bytes, store/ebpf/utils.h:11
VAL_WORDS = VAL_SIZE // 4

# wire formats (native/shim.cc)
FMT_MSG55 = 0
FMT_LOCK6 = 1
FMT_FASST9 = 2
FMT_LOG53 = 3

SRC = Path(__file__).resolve().parents[2] / "native" / "shim.cc"
CXX_FLAGS = ["-O2", "-std=c++17", "-Wall", "-Wextra", "-fPIC", "-shared",
             "-pthread"]


class _View(ctypes.Structure):
    _fields_ = [
        ("count", ctypes.c_uint32),
        ("slot", ctypes.c_uint32),
        ("ord", ctypes.POINTER(ctypes.c_uint8)),
        ("type", ctypes.POINTER(ctypes.c_uint8)),
        ("table", ctypes.POINTER(ctypes.c_uint8)),
        ("key", ctypes.POINTER(ctypes.c_uint64)),
        ("val", ctypes.POINTER(ctypes.c_uint8)),
        ("ver", ctypes.POINTER(ctypes.c_uint32)),
    ]


_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _compiler() -> str:
    return os.environ.get("CXX") or "g++"


def target() -> Path:
    """The library's path: ``_build/libdintshim_<hash>.so``, the hash over
    the compiler, its flags and the source."""
    tag = hashlib.sha256(
        " ".join([_compiler(), *CXX_FLAGS]).encode() + b"\0"
        + SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libdintshim_{tag}.so"


def build() -> Path:
    """Compile the library unless it is built; returns its path. Raises
    RuntimeError with the compiler's output when the build fails."""
    out = target()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_compiler(), *CXX_FLAGS, "-o", str(tmp), str(SRC)]
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        raise RuntimeError(f"dint_tpu_torch: cannot run {cmd[0]} to build "
                           f"the host shim: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"dint_tpu_torch: the host shim's build failed ({' '.join(cmd)}, "
            f"exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded shim library, built at first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.shim_server_create.restype = ctypes.c_void_p
        lib.shim_server_create.argtypes = [ctypes.c_char_p, ctypes.c_uint16,
                                           ctypes.c_uint32, ctypes.c_uint32,
                                           ctypes.c_uint32, ctypes.c_int]
        lib.shim_server_port.restype = ctypes.c_uint16
        lib.shim_server_port.argtypes = [ctypes.c_void_p]
        lib.shim_server_poll.restype = ctypes.c_int
        lib.shim_server_poll.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                         ctypes.POINTER(_View)]
        lib.shim_server_reply.restype = ctypes.c_int
        lib.shim_server_reply.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                          u8p, u8p, u32p]
        lib.shim_server_stats.restype = None
        lib.shim_server_stats.argtypes = [ctypes.c_void_p, u64p]
        lib.shim_server_destroy.restype = None
        lib.shim_server_destroy.argtypes = [ctypes.c_void_p]
        lib.shim_client_create.restype = ctypes.c_void_p
        lib.shim_client_create.argtypes = [ctypes.c_char_p, ctypes.c_uint16,
                                           ctypes.c_int]
        lib.shim_client_exchange.restype = ctypes.c_int
        lib.shim_client_exchange.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                             u8p, u8p, u8p, u64p, u8p, u32p,
                                             u8p, u8p, u8p, u64p, u8p, u32p,
                                             ctypes.c_uint32]
        lib.shim_client_destroy.restype = None
        lib.shim_client_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def _as_np(ptr, n, dtype):
    return np.ctypeslib.as_array(ptr, shape=(n,)).view(dtype)


_U8P = ctypes.POINTER(ctypes.c_uint8)
_U32P = ctypes.POINTER(ctypes.c_uint32)
_U64P = ctypes.POINTER(ctypes.c_uint64)


class ShimServer:
    """The batching UDP pump. poll() -> (slot, dict of numpy views);
    reply() sends."""

    def __init__(self, port: int = 0, width: int = 4096, flush_us: int = 200,
                 nrings: int = 8, fmt: int = FMT_MSG55, ip: str = "127.0.0.1"):
        self._lib = load()
        self._h = self._lib.shim_server_create(ip.encode(), port, width,
                                               flush_us, nrings, fmt)
        if not self._h:
            raise OSError(f"shim: cannot bind UDP {ip}:{port}")
        self.width = width
        self.port = self._lib.shim_server_port(self._h)
        self._pending: dict[int, int] = {}   # slot -> polled batch count

    def poll(self, timeout_us: int = 100_000):
        """(slot, batch dict of numpy views), or None on timeout. The views
        alias C++ memory and are invalid after reply(slot)."""
        v = _View()
        if not self._lib.shim_server_poll(self._h, timeout_us,
                                          ctypes.byref(v)):
            return None
        n = v.count
        self._pending[v.slot] = n
        return v.slot, {
            "ord": _as_np(v.ord, n, np.uint8),
            "type": _as_np(v.type, n, np.uint8),
            "table": _as_np(v.table, n, np.uint8),
            "key": _as_np(v.key, n, np.uint64),
            "val": np.ctypeslib.as_array(v.val, shape=(n, VAL_SIZE)),
            "ver": _as_np(v.ver, n, np.uint32),
        }

    def reply(self, slot: int, rtype, rval=None, rver=None):
        """Send the replies of a polled batch: one per lane it had."""
        n = len(rtype)
        expect = self._pending.pop(slot, None)
        if expect is not None and n != expect:
            raise ValueError(
                f"reply() got {n} lanes for slot {slot}, poll() returned "
                f"{expect}: the C++ side reads the whole polled count")
        rtype = np.ascontiguousarray(rtype, np.uint8)
        if rval is None:
            rval = np.zeros((n, VAL_SIZE), np.uint8)
        rval = np.ascontiguousarray(rval, np.uint8)
        rver = np.ascontiguousarray(
            rver if rver is not None else np.zeros(n), np.uint32)
        if rval.shape != (n, VAL_SIZE) or rver.shape != (n,):
            raise ValueError(f"reply(): rval {rval.shape} and rver "
                             f"{rver.shape} for {n} lanes")
        return self._lib.shim_server_reply(
            self._h, slot, rtype.ctypes.data_as(_U8P),
            rval.ctypes.data_as(_U8P), rver.ctypes.data_as(_U32P))

    def stats(self) -> dict:
        out = (ctypes.c_uint64 * 4)()
        self._lib.shim_server_stats(self._h, out)
        return {"pkts_rx": out[0], "pkts_tx": out[1], "batches": out[2],
                "dropped": out[3]}

    def close(self):
        if self._h:
            self._lib.shim_server_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class ShimClient:
    """Native synthetic client: one batched exchange a call."""

    def __init__(self, ip: str, port: int, fmt: int = FMT_MSG55):
        self._lib = load()
        self._h = self._lib.shim_client_create(ip.encode(), port, fmt)
        if not self._h:
            raise OSError(f"shim: cannot open a UDP client to {ip}:{port}")

    def exchange(self, types, keys, tables=None, vals=None, vers=None,
                 ords=None, timeout_ms: int = 1000) -> dict:
        """Send n requests and wait for n replies. Returns the reply arrays;
        ``n`` is how many came back (fewer on a timeout)."""
        n = len(types)

        def u8(x, default=None):
            if x is None:
                x = default if default is not None else np.zeros(n, np.uint8)
            return np.ascontiguousarray(x, np.uint8)

        types = u8(types)
        ords = u8(ords, np.arange(n, dtype=np.uint8))
        tables = u8(tables)
        keys = np.ascontiguousarray(keys, np.uint64)
        if vals is None:
            vals = np.zeros((n, VAL_SIZE), np.uint8)
        vals = np.ascontiguousarray(vals, np.uint8)
        vers = np.ascontiguousarray(
            vers if vers is not None else np.zeros(n), np.uint32)
        if not (len(ords) == len(tables) == len(keys) == len(vers) == n
                and vals.shape == (n, VAL_SIZE)):
            raise ValueError(f"exchange(): the request arrays must all hold "
                             f"{n} lanes, vals [{n}, {VAL_SIZE}] bytes")

        r_ord = np.zeros(n, np.uint8)
        r_type = np.zeros(n, np.uint8)
        r_table = np.zeros(n, np.uint8)
        r_key = np.zeros(n, np.uint64)
        r_val = np.zeros((n, VAL_SIZE), np.uint8)
        r_ver = np.zeros(n, np.uint32)
        got = self._lib.shim_client_exchange(
            self._h, n, ords.ctypes.data_as(_U8P), types.ctypes.data_as(_U8P),
            tables.ctypes.data_as(_U8P), keys.ctypes.data_as(_U64P),
            vals.ctypes.data_as(_U8P), vers.ctypes.data_as(_U32P),
            r_ord.ctypes.data_as(_U8P), r_type.ctypes.data_as(_U8P),
            r_table.ctypes.data_as(_U8P), r_key.ctypes.data_as(_U64P),
            r_val.ctypes.data_as(_U8P), r_ver.ctypes.data_as(_U32P),
            timeout_ms)
        return {"n": got, "ord": r_ord[:got], "type": r_type[:got],
                "table": r_table[:got], "key": r_key[:got],
                "val": r_val[:got], "ver": r_ver[:got]}

    def close(self):
        if self._h:
            self._lib.shim_client_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
