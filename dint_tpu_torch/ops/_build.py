"""Build and load the hand-written CUDA kernels of `dint_tpu_torch/csrc`.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by nvcc
for Hopper (``sm_90a``) into its own shared library, loaded with ctypes;
``csrc/*.cuh`` are headers they share. No PyTorch header is included, so a
build takes seconds. The libraries go to
``dint_tpu_torch/_build/`` (listed in .gitignore), named by a hash of the
source, the ``csrc`` headers it includes and the flags, so an unchanged
source is not rebuilt. The build runs at
first use, never at import; `build_all` starts one nvcc per source, all at
once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-lineinfo", "-shared",
                           "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}     # name -> nvcc's output (ptxas -v lines)
_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("dint_tpu_torch: nvcc not found (set CUDA_HOME or put "
                       "nvcc on PATH); the CUDA kernels cannot be built")


def _local_headers(src: bytes, seen: list[str]) -> list[str]:
    """The ``csrc/*.cuh`` headers ``src`` includes, directly or through
    another such header, in the order first met."""
    for head in _INCLUDE.findall(src):
        name = head.decode()
        if name not in seen and (CSRC_DIR / name).exists():
            seen.append(name)
            _local_headers((CSRC_DIR / name).read_bytes(), seen)
    return seen


def _target(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    # the local headers it includes too: a change to one rebuilds only its
    # includers
    heads = b"".join((CSRC_DIR / h).read_bytes()
                     for h in _local_headers(src, []))
    tag = hashlib.sha256(src + heads
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{tag}.so"


def _start(name: str):
    """Start nvcc for one source unless its library is built; returns
    (target, process or None, temp output path)."""
    out = _target(name)
    if out.exists():
        return out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, proc, tmp


def build_all(names=None) -> float:
    """Build every kernel library not yet built, one nvcc per source, all
    started together. Returns the wall seconds spent; raises on a failed
    build with nvcc's output."""
    names = sources() if names is None else list(names)
    t0 = time.perf_counter()
    with _lock:
        started = [(n, *_start(n)) for n in names]
        failed = []
        for name, out, proc, tmp in started:
            if proc is None:
                continue
            log, _ = proc.communicate()
            build_log[name] = log
            if proc.returncode != 0:
                failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("dint_tpu_torch: kernel build failed:\n"
                               + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(_target(name)))
                _libs[name] = lib
    return lib
