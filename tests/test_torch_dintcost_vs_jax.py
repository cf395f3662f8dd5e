"""The port's cost model held against the reference's derivation
(dint_tpu/analysis/cost.py) on the same targets at the same geometry.

The reference's gate does not run on this jax (ROADMAP §C.5); its byte
derivation does behind three shims, applied here with monkeypatch and
nowhere else (nothing in dint_tpu/ changes):
  (i)   `core._lu.cache_clearing_funs` is gone on this jax (read at
        dint_tpu/analysis/core.py:132): an empty list;
  (ii)  `core._pjit._infer_params_cached` is gone too (:134): a stub
        whose cache_clear does nothing;
  (iii) the `pjit` primitive is named `jit` on this jax: added to
        cost._CALL_PRIMS, so the walker enters the jitted body.
The reference's kernel pricing and footprint do not work on this jax
(`_kernel_name` reads no name; `_footprint` finds no `pjit`), so the
anchor is the default (XLA) routes' bytes, which hold no kernel there.

What must hold: the port's bytes/step equal JAX's (4992 for TATP, 4800
for SmallBank); its per-wave bytes equal JAX's once the launches the
port merges are folded (ROADMAP §C.14); and its dispatches equal JAX's
less those merged launches, each listed below with its reason.
"""
import types

import pytest

from dint_tpu_torch.analysis import cost
from dint_tpu_torch.analysis import targets as T

pytestmark = pytest.mark.cost

TD, SB = "tatp_dense/block", "smallbank_dense/block"

# the port's merges of JAX's memory ops: (JAX wave, JAX access kind) ->
# the port's wave that carries its bytes
FOLD = {
    TD: {
        # the magic-word gather rides meta_gather's B1 launch (one call of
        # two streams, ROADMAP §C.14)
        ("dint.tatp_dense.magic_gather", "gather"):
            "dint.tatp_dense.meta_gather",
    },
    SB: {
        # the lock wave's held-stamp gathers (x_step, s_step) ride the
        # read wave's B1 launch with the balances (ROADMAP §C.14)
        ("dint.smallbank_dense.lock", "gather"): "dint.smallbank_dense.read",
    },
}
# dispatches a step JAX makes that the port merges: (port wave, JAX's
# dispatches there after the fold, the port's, why)
MERGED = {
    TD: [
        ("dint.tatp_dense.lock", 3, 1,
         "B2 lock_arbitrate: JAX's stamp gather, masked scatter-max and "
         "grant read-back are one cooperative launch"),
        ("dint.tatp_dense.meta_gather", 2, 1,
         "the meta and magic gathers are the two streams of one B1 launch"),
    ],
    SB: [
        ("dint.smallbank_dense.read", 3, 1,
         "the two held-stamp gathers and the balance gather are the three "
         "streams of one B1 launch"),
    ],
}
JAX_TOTALS = {TD: (4992.0, 9.0), SB: (4800.0, 8.0)}


@pytest.fixture(scope="module")
def jax_models():
    """JAX's cost models of the two targets, traced fresh behind the
    shims (the reference's trace cache is left alone)."""
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
        for name in (TD, SB):
            trace = RT.TARGETS[name]()
            assert trace.jaxpr is not None, trace.trace_error
            meta = RT.TARGET_COST[name]
            out[name] = rcost.derive(trace, steps=meta["steps"],
                                     geom=meta["geom"])
    finally:
        mp.undo()
    return out


def _folded(name, model):
    """JAX's per-wave bytes and dispatches a step with the port's merges
    folded in."""
    fold = FOLD[name]
    b, d = {}, {}
    for a in model.accesses:
        w = fold.get((a.wave, a.kind), a.wave)
        b[w] = b.get(w, 0.0) + a.bytes / model.steps
        d[w] = d.get(w, 0.0) + a.dispatches / model.steps
    return b, d


@pytest.mark.parametrize("name", [TD, SB])
def test_the_anchor_is_the_documented_derivation(name, jax_models):
    m = jax_models[name]
    assert not m.error
    assert (m.bytes_per_step, m.dispatches_per_step) == JAX_TOTALS[name]


@pytest.mark.parametrize("name", [TD, SB])
def test_bytes_per_step_equal_jax(name, jax_models):
    port = cost.model_for(name)
    assert port.bytes_per_step == jax_models[name].bytes_per_step \
        == JAX_TOTALS[name][0]


@pytest.mark.parametrize("name", [TD, SB])
def test_wave_bytes_equal_jax_after_the_merges(name, jax_models):
    port = cost.model_for(name)
    want, _ = _folded(name, jax_models[name])
    assert port.wave_bytes_per_step() == want


@pytest.mark.parametrize("name", [TD, SB])
def test_dispatches_are_jax_less_the_merged_launches(name, jax_models):
    port = cost.model_for(name)
    _, jax_disp = _folded(name, jax_models[name])
    got = port.wave_dispatches_per_step()
    saved = 0
    for wave, before, after, why in MERGED[name]:
        assert jax_disp[wave] == before and got[wave] == after, (wave, why)
        saved += before - after
    others = {w for w in jax_disp} - {w for w, *_ in MERGED[name]}
    assert {w: got[w] for w in others} == {w: jax_disp[w] for w in others}
    assert port.dispatches_per_step == \
        jax_models[name].dispatches_per_step - saved
    # and the port's kernels are the merged launches
    assert port.kernel_dispatches_per_step() == (
        {"gather_rows": 1.0, "lock_arbitrate": 1.0} if name == TD
        else {"gather_rows": 1.0})


def test_the_geometries_agree(jax_models):
    """Both models at the same per-step geometry: the port traces three
    steps a block where JAX traces two, and the model is per step."""
    for name in (TD, SB):
        assert jax_models[name].geom == T.TARGET_COST[name]["geom"]
        assert T.TARGET_COST[name]["steps"] == T.LINT.cpb == 3
