"""dintscope wave-name registry: the timing half's schema (the port of
`dint_tpu.monitor.waves`).

Every wave of every hot path is wrapped in `scope(engine, wave)`, which
names the region ``dint.<engine>.<wave>`` in a profile, and
`monitor/attrib.py` charges the card's time back to those names. The
registry below is the JAX module's, row for row and in order: it is
append-only schema, keyed on by breakdown artifacts and the regression
gate, and a wave's ordinal (its index in `ALL_WAVES`) is packed into
every dinttrace record (monitor/txnevents.py), so the two packages'
records decode alike only while the two lists are equal.

How a wave reaches a profile differs from JAX. There, a
``jax.named_scope`` pushes the name stack at trace time and the name
survives jit into the metadata of every XLA op, so each device slice
carries its wave. Here a scope is a ``torch.profiler.record_function``
range of the full name: torch.profiler records it as a host
``user_annotation`` slice (and projects it onto the card's stream as a
``gpu_user_annotation``), while the kernels a wave launches carry no
name at all. attrib.py therefore joins each kernel to the annotation
around its launch through the launch's correlation id.

A range costs host time to enter and leave, and every path of the port
is bound by its host, so `scope` returns a null context unless a
profiler is running: with no profiler attached a scope costs one
registry lookup and one flag read. ``DINT_SCOPE=0`` turns the ranges off
even under a profiler (the A/B knob). Scopes never change an engine's
outputs.

Bytes formulas are declared, not measured: each wave may carry an
expected-bytes-per-step formula (a string evaluated against the run's
geometry: w, k, l, vw, d, ...), which attribution divides measured time
into to report an effective bandwidth per wave; ``None`` marks
compute-only waves.
"""
from __future__ import annotations

import contextlib
import os

import torch

PREFIX = "dint"

# ------------------------------------------------------------ the registry
# (engine, wave, doc, bytes-per-step formula | None). APPEND ONLY.
# Formula variables: w = cohort width, k = TATP wave-1 lanes per txn,
# l = SmallBank lock lanes per txn, vw = val words, d = mesh devices.
# Log-entry estimate: ~20 B header + 4*vw payload, x3 replicas.
_REGISTRY: tuple[tuple[str, str, str, str | None], ...] = (
    # --- dense TATP (engines/tatp_dense.py): 3-wave fused step ---------
    ("tatp_dense", "gen",
     "on-device cohort generation (txn mix, NURand, lane layout) — "
     "compute-only", None),
    ("tatp_dense", "install",
     "wave-3 install: meta + interleaved-val scatters of cohort t-2's "
     "certified writes (2w write slots)", "2*w*(4 + 4*vw)"),
    ("tatp_dense", "log_append",
     "log x3 append of cohort t-2's installs (RepLog packed entries)",
     "2*w*3*(20 + 4*vw)"),
    ("tatp_dense", "meta_gather",
     "fused meta gather serving c1's validate re-read AND the new "
     "cohort's reads (2wK random lanes over the meta array)",
     "2*w*k*4"),
    ("tatp_dense", "magic_gather",
     "magic-word integrity gather over the val array (wK random "
     "single-word lanes; absent when check_magic=False)", "w*k*4"),
    ("tatp_dense", "lock",
     "lock arbitration on the arb array: stamp gather + masked "
     "scatter-max + winner gather-back (2w write slots; ONE fused kernel "
     "pass on the pallas route)", "3*2*w*4"),
    ("tatp_dense", "rebase",
     "arb stamp rebase (full elementwise pass, once per ~16k steps — "
     "amortizes to noise; bytes unmodeled: streaming elementwise, not "
     "row traffic)", None),
    # --- dense SmallBank (engines/smallbank_dense.py): 2-wave step -----
    ("smallbank_dense", "gen",
     "on-device cohort generation (mix + hot-set skew) — compute-only",
     None),
    ("smallbank_dense", "lock",
     "no-wait S/X arbitration: held-stamp gathers + per-slot "
     "scatter-mins + grant stamp installs (wL lanes)", "5*w*l*4"),
    ("smallbank_dense", "read",
     "fused balance gather (wL random single-word lanes)", "w*l*4"),
    ("smallbank_dense", "compute",
     "shared per-txn balance logic (compute_phase) — compute-only", None),
    ("smallbank_dense", "install",
     "wave-2 balance install scatter of cohort t-1 (wL rows, plus the "
     "hot-mirror write-through when the dintcache tier is on)",
     "w*l*4"),
    ("smallbank_dense", "log_append",
     "log x3 append of cohort t-1's installs", "w*l*3*(20 + 4*vw)"),
    # --- generic TATP pipeline (engines/tatp_pipeline.py) --------------
    ("tatp_pipeline", "gen",
     "cohort generation (shared gen_cohort) — compute-only", None),
    ("tatp_pipeline", "assemble",
     "combined 12w-lane batch assembly (wave-1 + validate + wave-3 "
     "slices) — compute-only", None),
    ("tatp_pipeline", "engine_step",
     "vmapped sort-based engine step over the 3 stacked shard replicas "
     "(the sorts + segmented reductions + table ops; bytes unmodeled: "
     "sort-bound, no closed-form row-traffic formula)", None),
    ("tatp_pipeline", "classify",
     "per-wave outcome classification + stats emission — compute-only",
     None),
    # --- generic SmallBank pipeline (engines/smallbank_pipeline.py) ----
    ("smallbank_pipeline", "gen",
     "cohort generation + lock-slot layout — compute-only", None),
    ("smallbank_pipeline", "wave1",
     "fused lock+read at owners: vmapped engine step over the 3 stacked "
     "replicas (bytes unmodeled: sort-bound)", None),
    ("smallbank_pipeline", "compute",
     "shared per-txn balance logic (compute_phase) — compute-only", None),
    ("smallbank_pipeline", "wave2",
     "log x3 + prim/bck install + release: second vmapped engine step "
     "(bytes unmodeled: sort-bound)", None),
    # --- multi-chip dense TATP (parallel/dense_sharded.py); the local
    # --- step re-uses the tatp_dense wave scopes ------------------------
    ("dense_sharded", "replicate",
     "CommitBck x2 + CommitLog fan-out: ppermute the install record to "
     "devices +1/+2 and apply to backup tables + local logs (2 hops x "
     "2w records of meta+val plus a log append each)",
     "2*(2*w*(4 + 4*vw) + 2*w*(20 + 4*vw))"),
    # --- multi-chip dense SmallBank (parallel/dense_sharded_sb.py) -----
    ("dense_sharded_sb", "gen",
     "per-device cohort generation over the global keyspace — "
     "compute-only", None),
    ("dense_sharded_sb", "route",
     "wave-1 request routing: per-owner compaction + all_to_all "
     "exchange of lock/read requests (wL lanes of key+op)", "2*w*l*8"),
    # NOTE (dintcost audit): the owner-side formulas below were amended
    # when analysis/cost.py started deriving the same numbers from the
    # jaxpr — the originals pre-dated the 2x routed-slot capacity (the
    # factor route's own formula already carried) and install_route's
    # formula omitted the install + CommitLog bytes its doc always
    # described. Names are append-only; formulas are declared estimates
    # and reconciliation exists precisely so they cannot rot.
    ("dense_sharded_sb", "arbitrate",
     "owner-side no-wait S/X arbitration + fused balance read over the "
     "2wL routed request slots (5 passes, like the dense lock wave)",
     "5*2*w*l*4"),
    ("dense_sharded_sb", "reply",
     "grant/balance replies all_to_all back to sources + outcome "
     "classification + compute_phase (grant byte + balance word per "
     "lane)", "w*l*(2 + 8)"),
    ("dense_sharded_sb", "install_route",
     "wave-2 install routing to owners (all_to_all over the 2wL slots) "
     "+ primary balance install + the owner's CommitLog x3 append",
     "2*w*l*8 + 2*w*l*4 + w*l*3*(20 + 4*vw)"),
    ("dense_sharded_sb", "replicate",
     "backup fan-out: ppermute applied installs to owner+1/+2, apply to "
     "backup copies + append local logs (2 hops x wL balance rows + a "
     "log append each)", "2*(w*l*4 + w*l*3*(20 + 4*vw))"),
    # --- round-12 fused megakernels (ops/pallas_gather.lock_validate +
    # --- scatter_streams); each swallows a PAIR of the waves above.
    # --- tools/dintscope.py maps the swallowed constituents onto these
    # --- successors in fused-vs-unfused A/Bs (WAVE_ALIASES, attrib.py) --
    ("tatp_dense", "lock_validate",
     "megakernel: c1's validate ring-read + verdict, the new cohort's "
     "fresh meta gather, and the whole lock-arbitration RMW in ONE "
     "dispatch (swallows meta_gather + lock)", "3*2*w*4 + 2*w*k*4"),
    ("tatp_dense", "install_log",
     "megakernel: meta + val installs, the replicated log append, and "
     "the hot-mirror write-through as N masked row-scatter streams of "
     "ONE dispatch (swallows install + log_append)",
     "2*w*(4 + 4*vw) + 2*w*3*(20 + 4*vw)"),
    ("smallbank_dense", "lock_validate",
     "megakernel: the lock wave's held-stamp gathers + the balance read "
     "as gather streams of ONE dispatch (swallows lock's gathers + "
     "read; the scatter-mins and grant compare stay XLA)", "6*w*l*4"),
    ("smallbank_dense", "install_log",
     "megakernel: balance install + log x3 append (+ hot-mirror "
     "write-through) as scatter streams of ONE dispatch (swallows "
     "install + log_append)", "w*l*4 + w*l*3*(20 + 4*vw)"),
    ("dense_sharded_sb", "lock_validate",
     "owner-side megakernel: arbitration stamp/balance gathers as "
     "gather streams of ONE dispatch (swallows arbitrate's gathers; "
     "5 passes over the 2wL routed slots, like arbitrate)",
     "5*2*w*l*4"),
    ("dense_sharded_sb", "install_log",
     "owner-side megakernel: primary balance install + owner CommitLog "
     "append as scatter streams of ONE dispatch (swallows "
     "install_route's writes; routing stays all_to_all)",
     "w*l*8 + w*l*3*(20 + 4*vw)"),
    # --- 2-D multi-host SmallBank (parallel/multihost_sb.py): the same
    # --- cross-shard step over the (dcn x ici) mesh. Hierarchical
    # --- routing runs each exchange TWICE (ici stage + host-aggregated
    # --- dcn stage over the full 2wL bucket array), so the collective
    # --- terms double vs dense_sharded_sb; the @flat twins replace them
    # --- back via wave_expect in targets.TARGET_COST ------------------
    ("multihost_sb", "gen",
     "per-device cohort generation over the global keyspace — "
     "compute-only", None),
    ("multihost_sb", "route",
     "wave-1 request routing: per-owner compaction + hierarchical "
     "(ici-then-dcn) all_to_all of lock/read requests (2 exchange "
     "stages x 2wL slots of key+op)", "2*2*w*l*8"),
    ("multihost_sb", "arbitrate",
     "owner-side no-wait S/X arbitration + fused balance read over the "
     "2wL routed request slots (5 passes, like dense_sharded_sb)",
     "5*2*w*l*4"),
    ("multihost_sb", "reply",
     "grant/balance replies hierarchically back to sources + outcome "
     "classification + compute_phase (2 stages x grant byte + balance "
     "word per lane)", "2*w*l*(2 + 8)"),
    ("multihost_sb", "install_route",
     "wave-2 install routing to owners (2 exchange stages over the 2wL "
     "slots) + primary balance install + the owner's CommitLog append",
     "2*(2*w*l*8 + 2*w*l*4) + w*l*3*(20 + 4*vw)"),
    ("multihost_sb", "replicate",
     "host fault-domain fan-out: ppermute applied installs to hosts "
     "h+1/h+2 at the same chip (axis=dcn), apply to backup copies + "
     "append local logs (2 hops x wL balance rows + a log append each)",
     "2*(w*l*4 + w*l*3*(20 + 4*vw))"),
    # --- dinttrace flight recorder (monitor/txnevents.py): one
    # --- concatenated 16-byte-record scatter-add into the per-device
    # --- event ring per step, covering every instrumented wave of the
    # --- engine. Formula = 16 B x candidate event lanes per step
    # --- (sampling masks lanes out of the scatter but the update
    # --- operand — what dintcost prices — stays full-width) ------------
    ("tatp_dense", "trace",
     "flight-recorder event scatter: LOCK (2w) + VALIDATE (wK) + "
     "INSTALL (2w) + OUTCOME x2 (2w) candidate records per step",
     "16*(w*(k+6))"),
    ("smallbank_dense", "trace",
     "flight-recorder event scatter: LOCK (wL) + INSTALL (wL) + "
     "OUTCOME (w) candidate records per step", "16*(w*(2*l+1))"),
    ("dense_sharded_sb", "trace",
     "flight-recorder event scatter: ROUTE (wL) + owner LOCK (2wL) + "
     "VOTE (w) + owner INSTALL (2wL) + REPL x2 hops (4wL) + OUTCOME "
     "(w) candidate records per step", "16*(9*w*l + 2*w)"),
    ("multihost_sb", "trace",
     "flight-recorder event scatter: ROUTE (wL) + owner LOCK (2wL) + "
     "VOTE (w) + owner INSTALL (2wL) + REPL x2 hops (4wL) + OUTCOME "
     "(w) candidate records per step", "16*(9*w*l + 2*w)"),
    # --- dintserve variable-occupancy serving (dint_tpu/serve): the
    # --- lane mask + padding/shed accounting applied before gen hands
    # --- the cohort to the waves above. Compute-only: the mask is an
    # --- elementwise compare against a device scalar, no row traffic ----
    ("tatp_dense", "serve",
     "serving-plane occupancy mask: lanes past the cohort's admitted "
     "occupancy forced to no-ops + serve counter bumps — compute-only",
     None),
    ("smallbank_dense", "serve",
     "serving-plane occupancy mask: lock slots past the cohort's "
     "admitted occupancy zeroed + serve counter bumps — compute-only",
     None),
    # --- dintmesh (round 18): the 2-D mesh as one open-loop service.
    # --- serve is the same compute-only admission mask as the dense
    # --- engines; route_prefetch is the double-buffered route — the SAME
    # --- 2wL bucket exchange as `route`, issued one step EARLY so the
    # --- host-aggregated DCN all_to_all of cohort i+1 rides under cohort
    # --- i's arbitrate/reply waves (an overlap regression shows up as
    # --- this wave's wall-clock time growing back toward `route`'s) -----
    ("multihost_sb", "serve",
     "mesh serving-plane occupancy mask: lock slots past the cohort's "
     "per-device admitted occupancy zeroed + serve counter bumps — "
     "compute-only", None),
    ("multihost_sb", "route_prefetch",
     "double-buffered lock/read routing: cohort i+1's 2wL bucket "
     "exchange (ICI then host-aggregated DCN, same bytes as route) "
     "issued under cohort i's owner waves", "2*2*w*l*8"),
    # --- dintscan (round 20): the store KV engine's waves. probe/install
    # --- bytes are hash-layout-dependent (two-choice bucket walks,
    # --- slot-scan gathers) — unmodeled, attribution-only. The scan pair
    # --- IS modeled: locate is 2 u32 point gathers per lane per binary-
    # --- search round (lg = ceil(log2 cap)); scan is the sequential slab
    # --- — ROWS x ROW-BYTES (sl+dc window rows of 12+4vw B each), NOT
    # --- lanes x point-gather bytes: that rows-not-probes shape is the
    # --- scan's bandwidth claim, CI-gated by cost_budget's
    # --- scan-dominance check ------------------------------------------
    ("store", "probe",
     "two-choice bucket probe: key compare over both candidate buckets' "
     "slots + hit val/ver gathers — bytes hash-layout-dependent, "
     "unmodeled", None),
    ("store", "install",
     "writer-election install/delete scatters (valid/key/val/ver) — "
     "bytes hash-layout-dependent, unmodeled", None),
    ("store", "scan_locate",
     "ordered-run lower-bound: branchless meta binary search, 2 u32 "
     "point gathers per lane per round over lg rounds", "w*lg*8"),
    ("store", "scan",
     "sequential window slab over the ordered run: per lane sl+dc "
     "contiguous rows of (key_hi,key_lo,ver,val[vw]) = 12+4vw B/row, "
     "one DMA stream per lane on the pallas route", "w*(sl+dc)*(12+4*vw)"),
    ("store", "delta_append",
     "write-through overlay append + latest-wins re-sort of the dc-row "
     "delta — sort-bound, bytes unmodeled", None),
    ("store", "run_rebuild",
     "drain-boundary merge-compact of run∪delta back into a dense "
     "sorted run (two stable sorts + gathers over cap+dc rows) — "
     "sort-bound, bytes unmodeled", None),
)


def full_name(engine: str, wave: str) -> str:
    return f"{PREFIX}.{engine}.{wave}"


ALL_WAVES: tuple[str, ...] = tuple(
    full_name(e, wv) for e, wv, _, _ in _REGISTRY)
WAVE_DOCS: dict[str, str] = {
    full_name(e, wv): doc for e, wv, doc, _ in _REGISTRY}
WAVE_BYTES: dict[str, str | None] = {
    full_name(e, wv): f for e, wv, _, f in _REGISTRY}
ENGINES: tuple[str, ...] = tuple(dict.fromkeys(e for e, _, _, _ in _REGISTRY))
WAVES_BY_ENGINE: dict[str, tuple[str, ...]] = {
    eng: tuple(full_name(e, wv) for e, wv, _, _ in _REGISTRY if e == eng)
    for eng in ENGINES}
N_WAVES = len(ALL_WAVES)
assert N_WAVES == len(set(ALL_WAVES)), "duplicate wave name in registry"


def wave_bytes(name: str, **geometry) -> int | None:
    """Evaluate a wave's expected-bytes-per-step formula against run
    geometry (w=, k=, l=, vw=, d=, lg=, sl=, dc=...). Returns None for
    compute-only waves and for formulas whose variables the caller did
    not supply — attribution then reports time without a bandwidth
    figure instead of inventing one."""
    formula = WAVE_BYTES.get(name)
    if formula is None:
        return None
    try:
        v = eval(formula, {"__builtins__": {}},   # noqa: S307 — registry
                 {k: v for k, v in geometry.items() if v is not None})
    except NameError:
        return None
    try:
        return int(v)
    except (TypeError, ValueError):
        return None


def scopes_enabled() -> bool:
    """DINT_SCOPE=0 disables the annotations; default on."""
    return os.environ.get("DINT_SCOPE", "1") != "0"


def profiler_running() -> bool:
    """True while a torch.profiler (or autograd profiler) session records
    on this thread."""
    return bool(torch._C._autograd._profiler_enabled())


_NULL = contextlib.nullcontext()


def scope(engine: str, wave: str):
    """A ``torch.profiler.record_function`` range named
    ``dint.<engine>.<wave>`` for a REGISTERED wave (an unregistered name
    raises KeyError, so the registry and the annotations cannot drift
    apart). A null context when scopes are disabled or no profiler is
    running, so an unprofiled step pays no range."""
    name = full_name(engine, wave)
    if name not in WAVE_DOCS:
        raise KeyError(
            f"wave {name!r} is not in the dintscope registry "
            "(monitor/waves.py); append it there first")
    if not (scopes_enabled() and profiler_running()):
        return _NULL
    return torch.profiler.record_function(name)
