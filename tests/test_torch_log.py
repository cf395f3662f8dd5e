"""The port's replicated log ring (dint_tpu_torch/tables/log.py) against
`dint_tpu.tables.log`: the same appends from the same state give the same
slots, entries and heads, bit for bit, through ring wraps and a u32 head
wrapping past 2^32."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dint_tpu.tables import log as jlog
from dint_tpu_torch.ops import u32
from dint_tpu_torch.tables import log as plog

LANES, CAP, VW = 4, 8, 3


def _batch(r, n):
    return dict(
        do_append=r.random(n) < 0.6,
        table_id=r.integers(0, 5, n).astype(np.int32),
        is_del=r.integers(0, 2, n).astype(np.int32),
        key_hi=np.zeros(n, np.uint32),
        key_lo=r.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32),
        ver=r.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32),
        val=r.integers(0, 1 << 32, (n, VW), dtype=np.uint64)
        .astype(np.uint32))


def _jax_args(b):
    return [jnp.asarray(b[k]) for k in ("do_append", "table_id", "is_del",
                                        "key_hi", "key_lo", "ver", "val")]


def _torch_args(b):
    return [torch.from_numpy(b["do_append"])] + [
        u32.from_numpy(b[k], "cpu")
        for k in ("table_id", "is_del", "key_hi", "key_lo", "ver", "val")]


@pytest.mark.parametrize("head0", [
    [0, 0, 0, 0],
    [2**32 - 3, 2**32 - 1, 5, 2**31 - 1],    # heads wrap past 2^32 / 2^31
])
def test_append_rep_matches_jax(head0):
    r = np.random.default_rng(sum(head0) % 97)
    jring = jlog.create_rep(LANES, CAP, VW)
    jring = jring.replace(head=jnp.asarray(np.asarray(head0, np.uint32)))
    pring = plog.create_rep(LANES, CAP, VW, device="cpu")
    pring.head = u32.from_numpy(np.asarray(head0, np.uint32), "cpu")
    for i in range(7):          # ~4 appends/lane/batch: wraps CAP=8 often
        b = _batch(r, 22)       # 22 % LANES != 0: the padded rank path
        if i == 0:
            jf, je, jc = jlog.plan_rep(jring, *_jax_args(b))
            pf, pe, pc = plog.plan_rep(pring, *_torch_args(b))
            assert np.array_equal(np.asarray(jf), pf.numpy())
            assert np.array_equal(np.asarray(je), u32.to_numpy(pe))
            assert np.array_equal(np.asarray(jc), pc.numpy())
        jring = jlog.append_rep(jring, *_jax_args(b))
        plog.append_rep(pring, *_torch_args(b))
        assert np.array_equal(np.asarray(jring.entries),
                              u32.to_numpy(pring.entries)), i
        assert np.array_equal(np.asarray(jring.head),
                              u32.to_numpy(pring.head)), i
    for rep in range(3):
        assert np.array_equal(np.asarray(jlog.replica_entries(jring, rep)),
                              u32.to_numpy(plog.replica_entries(pring, rep)))


def test_create_rep_rejects_non_power_of_two():
    with pytest.raises(ValueError):
        plog.create_rep(4, 12, 3, device="cpu")


def test_create_rep_without_device_raises_without_cuda(monkeypatch):
    """``device=None`` means CUDA, as for every entry point of the port."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        plog.create_rep(LANES, CAP, VW)
    ring = plog.create_rep(LANES, CAP, VW, device="cpu")
    assert ring.entries.device.type == "cpu"
    assert ring.entries.shape == (LANES * CAP, 3 * (plog.HDR_WORDS + VW))
