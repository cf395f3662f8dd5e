"""Device timing of the port's kernels on the card, used by chip_smoke.py
and the card tests: back-to-back time by CUDA events, and what one call
puts on the stream, by torch.profiler and by a CUDA graph capture. A
mesh spread over several cards is synchronised, timed (`device_ms`) and
has its peak memory read on every card it uses (``devices``:
`parallel.mesh.Mesh.cards`)."""
from __future__ import annotations

import ctypes
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


def synchronize(devices=None):
    """``torch.cuda.synchronize`` on each of ``devices`` (None: the
    current card)."""
    for d in devices or (None,):
        torch.cuda.synchronize(d)


def peak_memory(devices) -> dict:
    """``torch.cuda.max_memory_allocated`` of each of ``devices``, by its
    name."""
    return {str(d): torch.cuda.max_memory_allocated(d) for d in devices}


def reset_peak_memory(devices):
    for d in devices:
        torch.cuda.reset_peak_memory_stats(d)


def device_ms(fn, n=20, groups=5, devices=None):
    """Median over ``groups`` of the mean device time of ``n`` back-to-back
    calls of ``fn``, by CUDA events. Each group is queued behind a ~5 ms
    sleep kernel, so the host has enqueued all ``n`` calls before the card
    reaches the first event and the span holds no launch latency (a call
    that synchronises inside, as the plain versions do, is timed with its
    host gaps, which are part of its cost). ``devices``: the cards ``fn``
    works on (None: the current one); each gets its sleep and its two
    events on its current stream, and a group's time is the longest of
    their spans."""
    cards = list(devices or (torch.device("cuda",
                                          torch.cuda.current_device()),))
    fn()
    synchronize(cards)
    times = []
    for _ in range(groups):
        marks = []
        for d in cards:
            with torch.cuda.device(d):
                torch.cuda._sleep(10_000_000)
                a = torch.cuda.Event(enable_timing=True)
                a.record()
                marks.append(a)
        for _ in range(n):
            fn()
        spans = []
        for d, a in zip(cards, marks):
            with torch.cuda.device(d):
                b = torch.cuda.Event(enable_timing=True)
                b.record()
            b.synchronize()
            spans.append(a.elapsed_time(b))
        times.append(max(spans) / n)
    return float(np.median(times))


def profiled_device_events(fn, tries: int = 3, pad_s: float = 0.2):
    """The device events (kernels, memsets, copies) of one call of ``fn``
    under torch.profiler.

    On the H100 machine a profile of a call of a few µs sometimes comes
    back holding no device event at all, three times in a row in one
    process (PERF.md §7). The cause is not known; one guess is that the
    profiler drops device events whose timestamps fall outside its
    host-clock window, which such a call leaves narrow. So the window is
    padded with ``pad_s`` seconds of host sleep on either side of the
    call, and a profile that still holds no device event says nothing
    about the call: it is taken again with twice the padding, at most
    ``tries`` times. A call that puts nothing on the card gives no event
    every time."""
    for i in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(pad_s * 2 ** i)
            fn()
            torch.cuda.synchronize()
            time.sleep(pad_s * 2 ** i)
        ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if ev:
            break
    return ev


def device_events(fn) -> dict:
    """What one call of ``fn`` (after a warm call) puts on the card, under
    torch.profiler (`profiled_device_events`): ``kernels`` launched,
    ``memsets`` and ``copies``, their names, and ``kernel_us``, the
    kernels' device time summed."""
    fn()
    torch.cuda.synchronize()
    ev = profiled_device_events(fn)
    memsets = [e for e in ev if e.name.startswith("Memset")]
    copies = [e for e in ev if e.name.startswith("Memcpy")]
    kernels = [e for e in ev if e not in memsets and e not in copies]
    return {"kernels": len(kernels), "memsets": len(memsets),
            "copies": len(copies), "names": [e.name for e in ev],
            "kernel_us": float(sum(e.device_time_total for e in kernels))}


# CUgraphNodeType (cuda.h)
_NODE_KERNEL, _NODE_MEMCPY, _NODE_MEMSET = 0, 1, 2


def graph_nodes(graph) -> dict:
    """The nodes of ``graph``, a torch.cuda.CUDAGraph captured with
    ``keep_graph=True``: its ``kernels``, ``memsets``, ``copies`` and
    ``other`` nodes, counted through the driver (cuGraphGetNodes,
    cuGraphNodeGetType)."""
    cuda = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)

    def ok(err, what):
        if err != 0:
            raise RuntimeError(f"{what} failed (CUresult {err})")
    ok(cuda.cuGraphGetNodes(handle, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * max(n.value, 1))()
    ok(cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    types = []
    for i in range(n.value):
        t = ctypes.c_int(-1)
        ok(cuda.cuGraphNodeGetType(ctypes.c_void_p(nodes[i]),
                                   ctypes.byref(t)), "cuGraphNodeGetType")
        types.append(t.value)
    counts = {"kernels": types.count(_NODE_KERNEL),
              "memsets": types.count(_NODE_MEMSET),
              "copies": types.count(_NODE_MEMCPY)}
    counts["other"] = len(types) - sum(counts.values())
    return counts


def captured_nodes(fn) -> dict:
    """What one call of ``fn`` puts on the stream, read from a CUDA graph
    capture of the call (`graph_nodes`; the call runs once eagerly on the
    capture stream first, and the captured work itself never runs).
    Unlike a profile, a capture cannot drop what the call enqueues."""
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=stream):
        fn()
    return graph_nodes(graph)
