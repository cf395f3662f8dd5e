"""The port's twin of `__graft_entry__.entry()`: one dense TATP pipeline
step with example arguments, for a quick check that the step runs."""
from __future__ import annotations

import functools

import numpy as np
import torch

from .device import resolve_device
from .engines import tatp_dense as td
from .engines.tatp_pipeline import draw_bits


def entry(device=None):
    """``(fn, args)``: ``fn(*args)`` is one `tatp_dense.pipe_step` (wave 1
    of a new cohort + validate + commit of the in-flight cohorts, all five
    tables, locks and the log x3) at n_sub=256, w=64, vw=10, on tables
    made by `populate` from ``np.random.default_rng(0)`` (the numpy draws
    JAX's `populate` makes). In place of JAX's ``PRNGKey(0)`` the step
    takes its draws, ``bits`` [64, 4] and ``payload`` [64, 2], from a torch
    generator seeded 0. ``device`` None means CUDA."""
    dev = resolve_device(device)
    n_sub, w, vw = 256, 64, 10
    db = td.populate(np.random.default_rng(0), n_sub, val_words=vw,
                     device=dev)
    fn = functools.partial(td.pipe_step, w=w, n_sub=n_sub, val_words=vw)
    gen = torch.Generator(device=dev).manual_seed(0)
    bits = draw_bits(gen, (w, 4), dev)
    payload = torch.randint(0, 1 << 16, (w, 2), dtype=torch.int32,
                            generator=gen, device=dev)
    return fn, (db, td.empty_ctx(w, dev), td.empty_ctx(w, dev), bits,
                payload)
