"""Shared body of the port's dintlint matrix tests
(tests/test_torch_dintlint_matrix*.py): one family of registered targets a
file, so that each file stays within a minute on one worker and shares
one trace cache (analysis/targets.TRACE_CACHE) across its tests.

Together the families are ``python -m dint_tpu_torch.dintlint --all``:
every target traced at the lint geometry, every pass run, the port's
allowlist applied; no unsuppressed error may remain, and every allowlist
entry of the family must still match a finding (the family's share of
``--prune-allowlist --check``)."""
import copy

from dint_tpu_torch import analysis
from dint_tpu_torch.analysis import allowlist as al

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
