"""The nine kernels as operators of the ``dint`` namespace in
``torch.library``.

A kernel wrapper (ops/row_kernels.py, ops/scan_kernels.py) checks its
arguments and calls ``torch.ops.dint.<name>``. The dispatcher then picks
the implementation by the tensors' device: on CPU tensors the plain
PyTorch version, on CUDA tensors the ctypes launch of the hand-written
kernel (which raises where it cannot launch; there is no fallback), and
under a fake or meta tensor mode a shapes-only version. So a trace of a
step (``torch.fx.experimental.proxy_tensor.make_fx``) shows one node per
kernel call on either device, with the arguments the kernel writes
declared by the schema's alias annotations (``Tensor(a!)``), which is
what a ``pallas_call`` with ``input_output_aliases`` is to a jaxpr. The
static analysis (dint_tpu_torch/analysis) reads those annotations.

The schemas are defined here, once; each kernel module registers its
implementations with `impl` when it is imported. The ops are defined
with the low-level ``Library.define``/``impl`` API: a Python kernel
behind the dispatcher costs a few microseconds a call on the host
(chip_smoke.py phase 20 times it against the direct ctypes launch).
"""
from __future__ import annotations

import torch

NAMESPACE = "dint"

# name -> schema (without the name). Tensor lists are the streams of a
# row pass; ``(a!)`` marks what the kernel writes in place.
SCHEMAS = {
    "gather_rows": "(Tensor[] tabs, Tensor[] idxs, int[] vws) -> Tensor[]",
    "lock_arbitrate": ("(Tensor(a!) arb, Tensor rows, Tensor active, "
                       "int step, int k_arb) -> Tensor"),
    "lock_validate": ("(Tensor(a!) arb, Tensor meta, Tensor vidx, "
                      "Tensor vv1, Tensor ridx, Tensor rows, Tensor active, "
                      "int step, int k_arb) -> (Tensor, Tensor, Tensor)"),
    "gather_streams": ("(Tensor[] tabs, Tensor[] idxs, int[] vws) "
                       "-> Tensor[]"),
    "scatter_streams": ("(Tensor(a!)[] tabs, Tensor[] idxs, Tensor[] vals, "
                        "int[] vws) -> ()"),
    "gather_rows_hot": ("(Tensor[] tabs, Tensor[] mirrors, Tensor[] idxs, "
                        "Tensor[] midxs, int[] vws) -> Tensor[]"),
    "scatter_rows_hot": ("(Tensor(a!)[] tabs, Tensor(b!)[] mirrors, "
                         "Tensor[] idxs, Tensor[] midxs, Tensor[] masks, "
                         "Tensor[] vals, int[] vws) -> ()"),
    "scan_rows": ("(Tensor run_hi, Tensor run_lo, Tensor run_ver, "
                  "Tensor run_val, Tensor off, int lg, int vw) "
                  "-> (Tensor, Tensor, Tensor, Tensor)"),
    "scalar_scatter": "(Tensor tab, Tensor idx, Tensor val) -> Tensor",
}

LIB = torch.library.Library(NAMESPACE, "DEF")
for _name, _schema in SCHEMAS.items():
    LIB.define(_name + _schema)

_IMPL = torch.library.Library(NAMESPACE, "IMPL")


def impl(name: str, kernel, fake):
    """Register ``kernel`` for CPU and CUDA tensors (it tells the two
    apart itself: the plain version on the CPU, the launch on the card)
    and ``fake`` (shapes only) for meta tensors and fake tensor modes."""
    _IMPL.impl(name, kernel, "CPU")
    _IMPL.impl(name, kernel, "CUDA")
    # the fake also serves meta tensors
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_IMPL)


def op(name: str):
    """The overload packet ``torch.ops.dint.<name>``."""
    return getattr(getattr(torch.ops, NAMESPACE), name)


def is_dint(target) -> bool:
    """True for an fx node target that is one of the ``dint`` ops."""
    return getattr(target, "namespace", None) == NAMESPACE


def mutated_args(target) -> list[str]:
    """The names of the arguments an op writes in place (its schema's
    ``(a!)`` annotations)."""
    schema = getattr(target, "_schema", None)
    if schema is None:
        return []
    return [a.name for a in schema.arguments
            if a.alias_info is not None and a.alias_info.is_write]
