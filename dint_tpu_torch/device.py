"""Default-device resolution: the port runs on the card unless the caller
asks for the CPU, and never moves to the CPU on its own."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``. Raises RuntimeError when a CUDA device is
    asked for (explicitly or by default) and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "dint_tpu_torch: no CUDA device is available; pass device='cpu' "
            "to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"dint_tpu_torch: unsupported device {dev}")
    return dev
