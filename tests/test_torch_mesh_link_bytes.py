"""The port's per-axis link bytes held against the reference's derivation
(dint_tpu/analysis/cost.py) on the mesh targets, behind the three shims
of tests/test_torch_dintcost_vs_jax.py (applied here with monkeypatch and
nowhere else).

The reference's jaxpr is one device's shard_map body, the port's trace
every partition's step, so the port's figure is the mesh's: it equals d
times the reference's per-device one, wave by wave and axis by axis. One
wave differs by layout: the port's reply carries the grant and the
balance as two i32 words a routed slot (8 B), the reference's a grant
byte and a balance word (5 B)."""
import collections
import types

import pytest

from dint_tpu_torch.analysis import cost
from dint_tpu_torch.analysis import targets as T

pytestmark = pytest.mark.cost

# the reference traces dense_sharded/block at 4 partitions, the port at
# 3; the record a hop moves is the same a partition
NAMES = ("multihost_sb/block", "multihost_sb/block@flat",
         "dense_sharded/block")
REPLY_BYTES = {"dint.multihost_sb.reply": 8 / 5}


@pytest.fixture(scope="module")
def jax_links():
    """{target: {(wave, axis): link bytes a step a device}} of JAX's cost
    models, traced fresh behind the shims."""
    from dint_tpu.analysis import core as rcore
    from dint_tpu.analysis import cost as rcost
    from dint_tpu.analysis import targets as RT
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(rcore._lu, "cache_clearing_funs", [], raising=False)
        mp.setattr(rcore._pjit, "_infer_params_cached",
                   types.SimpleNamespace(cache_clear=lambda: None),
                   raising=False)
        mp.setattr(rcost, "_CALL_PRIMS", rcost._CALL_PRIMS | {"jit"})
        out = {}
        for name in NAMES:
            meta = RT.TARGET_COST[name]
            m = rcost.derive(RT.TARGETS[name](), steps=meta["steps"],
                             geom=meta["geom"])
            assert not m.error, m.error
            out[name] = _by_wave(m)
        return out
    finally:
        mp.undo()


def _by_wave(model):
    agg = collections.defaultdict(float)
    for a in model.accesses:
        if a.axis:
            agg[(a.wave, a.axis)] += a.link_bytes / model.steps
    return dict(agg)


@pytest.mark.parametrize("name", NAMES)
def test_link_bytes_are_d_times_jaxs_per_device(name, jax_links):
    port = _by_wave(cost.model_for(name))
    d = T.TARGET_COST[name]["geom"]["d"]
    ref = jax_links[name]
    assert set(port) == set(ref)
    for (wave, axis), v in ref.items():
        assert port[(wave, axis)] == pytest.approx(
            d * v * REPLY_BYTES.get(wave, 1.0)), (wave, axis)


def test_the_hierarchical_route_saves_dcn_bytes_in_both(jax_links):
    """The planner's choice holds in both: the hierarchical exchange
    moves strictly fewer dcn bytes than @flat, per device and per
    mesh."""
    def dcn(links):
        return sum(v for (_, a), v in links.items() if a == "dcn")
    hier, flat = "multihost_sb/block", "multihost_sb/block@flat"
    assert dcn(jax_links[hier]) < dcn(jax_links[flat])
    assert cost.model_for(hier).dcn_bytes_per_step \
        < cost.model_for(flat).dcn_bytes_per_step
