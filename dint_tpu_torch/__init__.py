"""dint_tpu_torch — the dense TATP and SmallBank engines, the store engine
with range scans and its cache tier, in PyTorch, with their random-access
kernels written by hand in CUDA C++ for Hopper (sm_90a).

The package mirrors `dint_tpu`'s module layout so each function's JAX
counterpart is easy to find, but imports neither JAX nor anything of
`dint_tpu`. Device tables are `torch.int32` tensors holding u32 bit
patterns (see `ops/u32.py`).

Entry points take ``device=None``, which means ``"cuda"`` and raises when
no CUDA device is present; pass ``device="cpu"`` to run the plain PyTorch
versions of the kernels on the CPU (what the tests do).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
