"""Shared body of the port's dintlint matrix tests
(tests/test_torch_dintlint_matrix*.py): one family of registered targets a
file, so that each file stays within a minute on one worker and shares
one trace cache (analysis/targets.TRACE_CACHE) across its tests.

Together the families are ``python -m dint_tpu_torch.dintlint --all``:
every target traced at the lint geometry, every pass run, the port's
allowlist applied; no unsuppressed error may remain, and every allowlist
entry of the family must still match a finding (the family's share of
``--prune-allowlist --check``). The mesh families also hold each
target's per-axis link bytes to a hand count from its shapes."""
import copy
import math

from dint_tpu_torch import analysis
from dint_tpu_torch.analysis import allowlist as al
from dint_tpu_torch.analysis import cost
from dint_tpu_torch.analysis import targets as T

ENTRIES = al.load(analysis.DEFAULT_ALLOWLIST)


def family(*prefixes):
    return [n for n in analysis.TARGETS if n.startswith(prefixes)]


def check_target(name):
    """No unsuppressed error on ``name``; no trace failure either."""
    fs = analysis.run(targets=[name], allowlist_entries=copy.deepcopy(
        ENTRIES))
    errs = [str(f) for f in fs if f.severity == "error" and not f.suppressed]
    assert not errs, "\n".join(errs)
    assert not [f for f in fs if f.code in ("untraceable",
                                            "target-build-failed")]
    return fs


def check_family_allowlist(names):
    """Every allowlist entry scoped to a target of ``names`` matches a
    finding of that target."""
    entries = copy.deepcopy(ENTRIES)
    analysis.run(targets=names, allowlist_entries=entries)
    stale = [e for e in entries if e.get("target") in names
             and not e.get("_used")]
    assert not stale, stale


def hand_link_bytes(name) -> dict:
    """The link bytes a step of a mesh target by axis, counted by hand
    from its geometry: every collective node moves all d partitions'
    operands; a ppermute prices its operand, an all_to_all (n-1)/n of it
    along an axis of n (a tuple axis: n = d, priced dcn).

      TATP mesh    2 hops of the Installs record: 2w lanes of six i32
                   words, the write mask and vw value words
      sharded/*    2 hops of the routed Batch: 8 lanes of five i32
                   fields and vw value words
      SmallBank    three exchanges of the [d*cap] routed slots (cap =
                   2*ceil(w*l/d)): the route (key, op; + the txn id when
                   traced), the reply (grant, balance) and the install
                   route (5 fields; 6 traced), then 2 hops of the applied
                   record: 2wL lanes of the mask and 4 i32 words (5
                   traced); the 2-D exchange runs an ici and a dcn stage
                   over the same slots, the flat one one tuple-axis stage
    """
    g = T.TARGET_COST[name]["geom"]
    w, d = g["w"], g["d"]
    if name.startswith(("dense_sharded/", "multihost/")):
        axis = "dcn" if name.startswith("multihost/") else "ici"
        return {axis: d * 2 * 2 * w * (25 + 4 * g["vw"])}
    if name.startswith("sharded/"):
        vw = 4 if "tatp" in name else 2
        return {"ici": 2 * d * 8 * (20 + 4 * vw)}
    traced = "@trace" in name
    rows = d * 2 * math.ceil(w * g["l"] / d)
    ops = d * rows * 4 * ((3 if traced else 2) + 2 + (6 if traced else 5))
    repl = d * 2 * 2 * w * g["l"] * (1 + 4 * (5 if traced else 4))
    if name.startswith("dense_sharded_sb/"):
        return {"ici": ops * (d - 1) / d + repl}
    h = g["h"]
    if "flat" in name:
        return {"dcn": ops * (d - 1) / d + repl}
    c = d // h
    return {"ici": ops * (c - 1) / c, "dcn": ops * (h - 1) / h + repl}


def check_link_bytes(name):
    """The cost model's per-axis link bytes equal the hand count, and no
    collective wave is left unpriced."""
    model = cost.model_for(name)
    got = {k: v for k, v in model.axis_bytes_per_step().items() if v}
    assert got == hand_link_bytes(name), name
    assert model.unpriced_waves == []
