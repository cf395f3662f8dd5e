"""The traced window's device view: torch.profiler's CUDA activity (the
kernels, copies and fills the card ran) over the benchmark's own host
spans, reduced to what the per-layer readers read.

Only CUDA activity is recorded, so the host pays no recording of its
own operator calls; the host side is the benchmark's spans around each
call into the program (`window.Spans`), on the same wall clock as the
profiler's events. A device event is one of three kinds:

* ``kernels``: a kernel of the program's own CUDA sources (its
  ``__global__`` functions, read from ``dint_tpu_torch/csrc``);
* ``nccl``: a collective's kernel (the name starts with ``nccl``);
* ``glue``: everything else: PyTorch's own kernels, copies and fills.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np

# a kernel's argument list: the first "(" that opens no anonymous namespace
_ARGS = re.compile(r"\((?!anonymous namespace\))")
_GLOBAL = re.compile(r"__global__\s+(?:void\s+)?"
                     r"(?:__launch_bounds__\([^)]*\)\s*)?"
                     r"(?:void\s+)?(\w+)\s*\(")


def program_kernels(root: Path) -> tuple:
    """The names of the program's hand-written kernels: every
    ``__global__`` function in its CUDA sources."""
    names = set()
    for p in sorted((root / "dint_tpu_torch" / "csrc").glob("*.cu*")):
        names.update(_GLOBAL.findall(p.read_text()))
    return tuple(sorted(names))


def start():
    """The profiler, recording the card's activity (on a machine with no
    card, the host's, which holds no device event)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    prof = profile(activities=[ProfilerActivity.CUDA if cuda
                               else ProfilerActivity.CPU])
    prof.start()
    if cuda:
        torch.cuda.synchronize()
    return prof


def stop(prof) -> list:
    """(name, start_ns, end_ns) of every device event, in start order."""
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    cuda = torch.autograd.DeviceType.CUDA
    evs = [(e.name(), e.start_ns(), e.end_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == cuda and e.end_ns() > e.start_ns()]
    evs.sort(key=lambda e: e[1])
    return evs


def kind_of(name: str, kernels: tuple) -> str:
    if name.lower().startswith("nccl"):
        return "nccl"
    for k in kernels:
        if re.search(rf"\b{k}\b", name):
            return "kernels"
    return "glue"


def union(iv: np.ndarray) -> np.ndarray:
    """Disjoint [start, end) intervals covering the rows of ``iv``."""
    if len(iv) == 0:
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    end = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > end[:-1]
    starts = iv[new, 0]
    idx = np.flatnonzero(new)
    ends = end[np.append(idx[1:] - 1, len(iv) - 1)]
    return np.stack([starts, ends], 1)


class CardView:
    """One card's traced window: ``window_s`` from the first hand-in to
    the last fetch, ``busy_s`` the union of its device events in it, the
    device seconds of each kind, the host spans and the steps run."""

    def __init__(self, events: list, spans: list, t0: int, t1: int,
                 steps: int, kernels: tuple):
        self.t0, self.t1, self.steps = t0, t1, steps
        self.window_s = (t1 - t0) / 1e9
        evs = [e for e in events if e[2] > t0 and e[1] < t1]
        self.n_events = len(evs)
        iv = np.asarray([(max(s, t0), min(e, t1)) for _, s, e in evs],
                        np.int64).reshape(-1, 2)
        self.busy = union(iv)
        self.busy_s = float((self.busy[:, 1] - self.busy[:, 0]).sum()) / 1e9
        self.kind_s = {"kernels": 0.0, "nccl": 0.0, "glue": 0.0}
        iv_s = (iv[:, 1] - iv[:, 0]).tolist()
        by_name = {}
        for (name, _, _), d in zip(evs, iv_s):
            d = d / 1e9
            self.kind_s[kind_of(name, kernels)] += d
            by_name[name] = by_name.get(name, 0.0) + d
        self.by_name = by_name
        self.spans = [s for s in spans if s[2] > t0 and s[1] < t1]
        self.host_s = {}
        for name, a, b in self.spans:
            self.host_s[name] = self.host_s.get(name, 0.0) + (b - a) / 1e9
        self.gaps = self._gaps()

    def _gaps(self) -> dict:
        """Idle seconds of the card by what the host was doing meanwhile:
        each idle stretch split over the benchmark's host spans it
        overlaps, the rest charged to the loop between them."""
        edges = np.concatenate([[self.t0], self.busy.reshape(-1),
                                [self.t1]]).reshape(-1, 2)
        idle = edges[edges[:, 1] > edges[:, 0]]
        out = {"host_loop": float((idle[:, 1] - idle[:, 0]).sum()) / 1e9}
        for name, a, b in self.spans:
            lo = np.maximum(idle[:, 0], a)
            hi = np.minimum(idle[:, 1], b)
            d = float(np.clip(hi - lo, 0, None).sum()) / 1e9
            out[name] = out.get(name, 0.0) + d
            out["host_loop"] -= d
        return out

    def breakdown(self) -> dict:
        """The ten device operations that took most time (by name, the
        argument list cut off) and the ten largest idle causes."""
        ops = {}
        for k, v in self.by_name.items():
            name = _ARGS.split(k, maxsplit=1)[0].removeprefix("void ")
            ops[name] = ops.get(name, 0.0) + v
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in gaps]}

    def summary(self) -> dict:
        """The plain numbers a reader needs (what crosses ranks)."""
        return {"window_s": self.window_s, "busy_s": self.busy_s,
                "steps": self.steps, "kind_s": dict(self.kind_s),
                "host_s": dict(self.host_s), "n_events": self.n_events,
                "breakdown": self.breakdown()}
