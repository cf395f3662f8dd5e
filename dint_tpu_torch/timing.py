"""Device timing of the port's kernels on the card, used by chip_smoke.py
and the card tests: back-to-back time by CUDA events, and what one call
puts on the stream by torch.profiler."""
from __future__ import annotations

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


def device_ms(fn, n=20, groups=5):
    """Median over ``groups`` of the mean device time of ``n`` back-to-back
    calls of ``fn``, by CUDA events. Each group is queued behind a ~5 ms
    sleep kernel, so the host has enqueued all ``n`` calls before the card
    reaches the first event and the span holds no launch latency (a call
    that synchronises inside, as the plain versions do, is timed with its
    host gaps, which are part of its cost)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(groups):
        torch.cuda._sleep(10_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return float(np.median(times))


def device_events(fn) -> dict:
    """What one call of ``fn`` (after a warm call) puts on the card, under
    torch.profiler: ``kernels`` launched, ``memsets`` and ``copies``, their
    names, and ``kernel_us``, the kernels' device time summed."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    memsets = [e for e in ev if e.name.startswith("Memset")]
    copies = [e for e in ev if e.name.startswith("Memcpy")]
    kernels = [e for e in ev if e not in memsets and e not in copies]
    return {"kernels": len(kernels), "memsets": len(memsets),
            "copies": len(copies), "names": [e.name for e in ev],
            "kernel_us": float(sum(e.device_time_total for e in kernels))}
