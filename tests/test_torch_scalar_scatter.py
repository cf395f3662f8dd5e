"""The port's scalar scatter (`dint_tpu_torch.ops.row_kernels.scalar_scatter`,
the counterpart of `tools/profile_pallas.py`'s `pallas_scatter`) on the CPU.

`scalar_scatter_ref` is held against the tool's own kernel body run by
`pl.pallas_call(..., interpret=True)`: the tool is loaded by path and its
`K` and `C` globals are set small on the loaded module (the file is not
changed). Covered: unique and duplicate indices (the kernel's serial loop
makes the last lane win), tables of several rows, and the wrapper on CPU
tensors running the plain version. Tolerance: exact."""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from dint_tpu_torch import profile_scalar_scatter as pss
from dint_tpu_torch.ops import row_kernels as rk
from dint_tpu_torch.ops.u32 import from_numpy, to_numpy

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def tool():
    spec = importlib.util.spec_from_file_location(
        "_profile_pallas_probe", REPO / "tools" / "profile_pallas.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pallas(tool, tab, idx, val):
    """The tool's kernel body over [K, 1] SMEM idx/val and a [N/C, C]
    VMEM table, in interpret mode, at the module's K and C."""
    tool.K, tool.C = idx.shape[0], tab.shape[1]
    out = pl.pallas_call(
        tool.kernel,
        out_shape=jax.ShapeDtypeStruct(tab.shape, jnp.uint32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM),
                  pl.BlockSpec(memory_space=pltpu.SMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True)(jnp.asarray(idx), jnp.asarray(val), jnp.asarray(tab))
    return np.asarray(out)


def _case(seed, rows, c, k, dup):
    r = np.random.default_rng(seed)
    n = rows * c
    tab = r.integers(0, 1 << 32, (rows, c), dtype=np.uint64).astype(np.uint32)
    if dup:
        idx = r.integers(0, n, k)
        idx[1::3] = idx[0]                      # one index, many lanes
        idx[-1] = n - 1
        idx[-2] = n - 1
    else:
        idx = r.choice(n, k, replace=False)
    val = r.integers(0, 1 << 32, k, dtype=np.uint64).astype(np.uint32)
    return tab, idx.astype(np.int32).reshape(k, 1), val.reshape(k, 1)


@pytest.mark.parametrize("rows,c,k,dup", [(2, 128, 64, False),
                                          (4, 128, 64, True),
                                          (3, 256, 96, True),
                                          (1, 128, 32, False)])
def test_scalar_scatter_ref_matches_pallas_interpret(tool, rows, c, k, dup):
    tab, idx, val = _case(rows * 7 + k, rows, c, k, dup)
    want = _pallas(tool, tab, idx, val)
    got = rk.scalar_scatter(from_numpy(tab, "cpu").view(rows, c),
                            torch.from_numpy(idx),
                            from_numpy(val, "cpu").view(k, 1))
    assert tuple(got.shape) == (rows, c)
    assert np.array_equal(to_numpy(got).reshape(rows, c), want)
    if dup:       # the last lane won where lanes collide
        first = int(idx[0, 0])
        last = max(i for i in range(k) if idx[i, 0] == first)
        assert want.reshape(-1)[first] == val[last, 0]


@pytest.mark.parametrize("case", ["one_index", "one_lane", "last_word",
                                  "one_lane_last_word"])
def test_scalar_scatter_ref_matches_pallas_at_edges(tool, case):
    """Every lane on one index (the last lane wins), K = 1, and lanes on
    the table's last word."""
    r = np.random.default_rng(len(case))
    rows, c = 2, 128
    n = rows * c
    tab = r.integers(0, 1 << 32, (rows, c), dtype=np.uint64).astype(np.uint32)
    k = 1 if case.startswith("one_lane") else 48
    idx = {"one_index": np.full(k, 77),
           "one_lane": np.array([5]),
           "last_word": np.where(np.arange(k) % 3 == 0, n - 1,
                                 r.integers(0, n, k)),
           "one_lane_last_word": np.array([n - 1])}[case]
    idx = idx.astype(np.int32).reshape(k, 1)
    val = r.integers(0, 1 << 32, (k, 1), dtype=np.uint64).astype(np.uint32)
    want = _pallas(tool, tab, idx, val)
    got = rk.scalar_scatter(from_numpy(tab, "cpu").view(rows, c),
                            torch.from_numpy(idx),
                            from_numpy(val, "cpu").view(k, 1))
    assert np.array_equal(to_numpy(got).reshape(rows, c), want)
    last = max(i for i in range(k) if idx[i, 0] == idx[-1, 0])
    assert want.reshape(-1)[idx[-1, 0]] == val[last, 0]


def test_scalar_scatter_on_cpu_runs_the_plain_version(monkeypatch):
    tab, idx, val = _case(3, 2, 128, 40, True)
    t = from_numpy(tab, "cpu").view(2, 128)
    i, v = torch.from_numpy(idx.reshape(-1)), from_numpy(val.reshape(-1),
                                                         "cpu")
    before = rk.scalar_scatter.launches
    calls = []
    real = rk.scalar_scatter_ref
    monkeypatch.setattr(rk, "scalar_scatter_ref",
                        lambda *a: calls.append(1) or real(*a))
    got = rk.scalar_scatter(t, i, v)
    assert calls and rk.scalar_scatter.launches == before
    assert torch.equal(got, real(t, i, v))
    assert not torch.equal(got, t)            # a new table; tab untouched
    assert np.array_equal(to_numpy(t).reshape(2, 128), tab)


def test_scalar_scatter_argument_checks():
    t = torch.zeros(256, dtype=torch.int32)
    i = torch.tensor([0, 256], dtype=torch.int32)
    v = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(IndexError):
        rk.scalar_scatter(t, i, v)
    with pytest.raises(IndexError):
        rk.scalar_scatter(t, torch.tensor([-1, 0], dtype=torch.int32), v)
    with pytest.raises(ValueError, match="values"):
        rk.scalar_scatter(t, i[:1], v)
    with pytest.raises(TypeError):
        rk.scalar_scatter(t, i.long(), v)
    empty = rk.scalar_scatter(t, i[:0], v[:0])
    assert torch.equal(empty, t)


def test_probe_inputs_are_the_tools(monkeypatch):
    """The entry point's inputs are tools/profile_pallas.py's: its shapes,
    its seed, its draws."""
    assert (pss.N, pss.K, pss.ITERS, pss.C) == (2_200_064, 16_384, 8, 512)
    tab, idx, val = pss.inputs("cpu")
    rng = np.random.default_rng(0)
    want_idx = rng.choice(pss.N, pss.K, replace=False).astype(np.int32)
    want_val = rng.integers(0, 1 << 30, pss.K, dtype=np.int64)
    assert tuple(tab.shape) == (pss.N // pss.C, pss.C) and not tab.any()
    assert np.array_equal(idx.numpy().reshape(-1), want_idx)
    assert np.array_equal(to_numpy(val).reshape(-1), want_val)
    assert torch.equal(pss.index_put_form(tab, idx, val),
                       rk.scalar_scatter(tab, idx, val))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pss.run()
