"""dintcal: the calibration and prediction-audit plane (the port of
`dint_tpu.monitor.calib`, plain Python and the port's own modules).

It turns what the counter, timing and narration planes measured into a
machine-checked update of the serving plane's `ServiceModel`:

* **Evidence** (``dintcal_evidence``, EVIDENCE_SCHEMA): (width,
  block-service-time) samples from serve controller snapshots and decision
  journals, per-wave ``ms_per_step``/``bytes_per_step``/``gbps`` rows from
  dintscope breakdowns, and the serve counter totals. `gather_evidence`
  walks any artifact shape (bench lines, exp points, snapshots); it copies
  only those three keys of a wave, so a port breakdown's ``host_ms``
  changes nothing.
* **The calibration** (``dintcal``, CALIB_SCHEMA): the coefficients
  (base_us, per_lane_ns) fit by closed-form least squares over the
  samples, the per-wave implied GB/s, the residuals, a tolerance band, and
  the provenance hashes (sha256 over sorted-keys JSON, 16 hex chars):
  ``evidence_hash`` pins the evidence, ``calib_hash`` the fitted content.
  Refitting the embedded samples reproduces the coefficients bit for bit.
* **Decision journal** (``dintcal_journal``, controller.JOURNAL_SCHEMA):
  written by `serve.controller.WidthController`; `audit_journal` replays
  every width/shed/hot_frac decision through the policy functions.

The fit is closed form in plain Python floats (no numpy, no torch), so
the same samples give bit-identical coefficients and hashes on any host,
and equal the JAX package's.

What differs from JAX: `calib_path` never resolves to ``CALIB.json``,
which is a TPU's calibration. It is ``$DINT_CALIB_PATH``, else
``CALIB_H100.json`` at the repository's root, the port's own file fitted
on an H100; without it `resolve_service_model` returns the `ServiceModel`
defaults and says so (``source: defaults``).
``python -m dint_tpu_torch.dintcal`` is the CLI.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
from pathlib import Path

EVIDENCE_SCHEMA = 1
CALIB_SCHEMA = 1

ENV_CALIB_PATH = "DINT_CALIB_PATH"        # override the pinned calib file

# drift tolerance bands pinned INTO the calibration (so a check is judged by
# the bands the fit was published with, not whatever the checker's tree
# says): rel_coeff bounds refit-vs-pinned coefficient drift, rel_gbps
# bounds per-wave implied-bandwidth drift
DEFAULT_TOLERANCE = {"rel_coeff": 0.05, "rel_gbps": 0.25}

_SERVE_COUNTERS = ("serve_occupancy_lanes", "serve_padded_lanes",
                   "serve_shed_lanes")


def calib_path() -> Path:
    """The port's calibration: $DINT_CALIB_PATH, else CALIB_H100.json at
    the repository's root (never CALIB.json, a TPU's)."""
    env = os.environ.get(ENV_CALIB_PATH)
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "CALIB_H100.json"


def _digest(obj) -> str:
    """PLAN.json's provenance-hash discipline."""
    blob = json.dumps(obj, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def calib_hash(doc: dict) -> str:
    """Digest of the pinned content (model + fit + samples + waves +
    tolerance): editing any fitted row without re-pinning changes it,
    exactly like PLAN.json rows."""
    return _digest({k: doc.get(k) for k in
                    ("model", "fit", "samples", "waves", "tolerance")})


def implied_gbps(ms_per_step: float, bytes_per_step: float) -> float:
    """The reconciliation unit: dintcost-predicted bytes over measured
    wave time. A wave whose implied GB/s walks out of the pinned band
    means the byte ledger and the measured time no longer describe the
    same machine — recalibrate or find the regression."""
    return bytes_per_step / (ms_per_step * 1e-3) / 1e9


# ---------------------------------------------------------------- evidence


def _empty_evidence() -> dict:
    return {"kind": "dintcal_evidence", "schema": EVIDENCE_SCHEMA,
            "samples": [], "waves": {}, "counters": {}, "sources": []}


def _merge_node(ev: dict, node) -> None:
    """Deep-walk one artifact node, folding anything evidence-shaped
    into `ev`: controller snapshots contribute (width, service_us)
    samples, dintscope breakdown blocks contribute wave rows, counter
    dicts contribute serve_* totals."""
    if isinstance(node, list):
        for item in node:
            _merge_node(ev, item)
        return
    if not isinstance(node, dict):
        return
    if node.get("kind") == "dintcal_evidence":
        ev["samples"].extend([int(w), float(us)]
                             for w, us in node.get("samples", []))
        for name, row in (node.get("waves") or {}).items():
            ev["waves"][name] = dict(row)
        for k, v in (node.get("counters") or {}).items():
            ev["counters"][k] = ev["counters"].get(k, 0) + int(v)
        return
    ss = node.get("service_samples")
    if isinstance(ss, dict):
        ev["samples"].extend([int(w), float(us)]
                             for w, us in ss.get("samples", []))
    if node.get("kind") == "dintscope_breakdown":
        for name, row in (node.get("waves") or {}).items():
            if not isinstance(row, dict) or "ms_per_step" not in row:
                continue
            ev["waves"][name] = {
                "ms_per_step": row["ms_per_step"],
                "bytes_per_step": row.get("bytes_per_step"),
                "gbps": row.get("gbps")}
    for key in ("counters", "serve_counters"):
        c = node.get(key)
        if isinstance(c, dict):
            for k in _SERVE_COUNTERS:
                if isinstance(c.get(k), (int, float)):
                    ev["counters"][k] = (ev["counters"].get(k, 0)
                                         + int(c[k]))
    for k, v in node.items():
        if k in ("service_samples", "counters", "serve_counters"):
            continue
        if isinstance(v, (dict, list)):
            _merge_node(ev, v)


def gather_evidence(docs, sources=None) -> dict:
    """Normalize any mix of artifacts (bench dicts, exp point lists,
    serve snapshots, prior evidence docs) into ONE evidence document.
    Purely structural — no clocks, no RNG — so gathering the same
    artifacts always yields the same evidence (and the same
    evidence_hash)."""
    ev = _empty_evidence()
    for doc in docs:
        _merge_node(ev, doc)
    ev["sources"] = [str(s) for s in (sources or [])]
    return ev


def load_evidence(path) -> dict:
    with open(path) as fh:
        doc = json.load(fh)
    if isinstance(doc, dict) and doc.get("kind") == "dintcal_evidence":
        if doc.get("schema") != EVIDENCE_SCHEMA:
            raise ValueError(
                f"{path}: evidence schema {doc.get('schema')!r}, "
                f"expected {EVIDENCE_SCHEMA}")
        return doc
    # any other artifact shape: normalize on the way in
    return gather_evidence([doc], sources=[str(path)])


# -------------------------------------------------------------------- fit


def fit_service_model(samples) -> dict:
    """Closed-form least squares of service_us ~ base_us + width *
    per_lane_ns * 1e-3 over (width, service_us) samples. Pure python
    float arithmetic (normal equations) — deterministic across hosts,
    so fitted coefficients can be pinned by equality. Requires >= 2
    distinct widths (one width cannot separate floor from slope)."""
    pts = [(float(w), float(us)) for w, us in samples]
    n = len(pts)
    if n < 2 or len({w for w, _ in pts}) < 2:
        raise ValueError(
            "fit needs samples at >= 2 distinct widths to separate "
            "base_us from per_lane_ns")
    sw = sum(w for w, _ in pts)
    sw2 = sum(w * w for w, _ in pts)
    sy = sum(us for _, us in pts)
    swy = sum(w * us for w, us in pts)
    den = n * sw2 - sw * sw
    m = (n * swy - sw * sy) / den            # us per lane
    b = (sy - m * sw) / n
    resid = [us - (b + m * w) for w, us in pts]
    return {
        "base_us": round(b, 6),
        "per_lane_ns": round(m * 1e3, 6),
        "n": n,
        "widths": sorted({int(w) for w, _ in pts}),
        "rms_us": round(math.sqrt(sum(r * r for r in resid) / n), 6),
        "max_abs_us": round(max(abs(r) for r in resid), 6),
    }


def fit_calib(evidence: dict, source: str | None = None) -> dict:
    """Fit + pin: the full calibration document for an evidence doc.
    Wave rows keep only reconcilable waves (a bytes formula exists), and
    the implied GB/s is recomputed here from (ms, bytes) — the pinned
    figure is the reconciliation, not whatever the breakdown rounded."""
    from ..serve.controller import ServiceModel
    fit = fit_service_model(evidence.get("samples", []))
    waves = {}
    for name, row in sorted((evidence.get("waves") or {}).items()):
        ms = row.get("ms_per_step")
        by = row.get("bytes_per_step")
        if not ms or not by:
            continue                       # compute-only / unmeasured
        waves[name] = {"ms_per_step": ms, "bytes_per_step": by,
                       "gbps": round(implied_gbps(ms, by), 6)}
    prior = ServiceModel()
    doc = {
        "kind": "dintcal", "schema": CALIB_SCHEMA,
        "model": {"base_us": fit["base_us"],
                  "per_lane_ns": fit["per_lane_ns"]},
        "prior": {"base_us": prior.base_us,
                  "per_lane_ns": prior.per_lane_ns},
        "fit": {k: fit[k] for k in ("n", "widths", "rms_us",
                                    "max_abs_us")},
        "samples": [[int(w), float(us)]
                    for w, us in evidence.get("samples", [])],
        "waves": waves,
        "tolerance": dict(DEFAULT_TOLERANCE),
        "source": source,
    }
    doc["provenance"] = {"evidence_hash": _digest(evidence),
                         "calib_hash": calib_hash(doc)}
    return doc


def save_calib(calib: dict, path=None) -> Path:
    path = Path(path) if path else calib_path()
    path.write_text(json.dumps(calib, indent=1, sort_keys=True) + "\n")
    return path


def load_calib(path=None) -> dict:
    """Parse + validate the pinned calibration. Raises FileNotFoundError
    / ValueError — soft-fail consumers use resolve_service_model."""
    path = Path(path) if path else calib_path()
    doc = json.loads(path.read_text())
    if not isinstance(doc, dict) or doc.get("kind") != "dintcal" \
            or doc.get("schema") != CALIB_SCHEMA:
        raise ValueError(f"{path}: not a schema-{CALIB_SCHEMA} "
                         "dintcal calibration")
    for key in ("model", "fit", "samples", "waves", "tolerance",
                "provenance"):
        if key not in doc:
            raise ValueError(f"{path}: calib is missing its {key!r} "
                             "section")
    m = doc["model"]
    for coeff in ("base_us", "per_lane_ns"):
        v = m.get(coeff)
        if not isinstance(v, (int, float)) or not math.isfinite(v):
            raise ValueError(f"{path}: model.{coeff} is {v!r}")
    return doc


def resolve_service_model(path=None) -> tuple:
    """The ServiceModel resolver: the calibration at `calib_path` (or
    ``path``) when it loads, else the ServiceModel defaults, and always
    which -> (model, meta) with meta = {"source": "calib"|"defaults",
    "path", "hash"}, which the dintserve simulate report records."""
    from ..serve.controller import ServiceModel
    p = Path(path) if path else calib_path()
    try:
        calib = load_calib(p)
    except (OSError, ValueError):
        return ServiceModel(), {"source": "defaults", "path": None,
                                "hash": None}
    m = calib["model"]
    model = ServiceModel(base_us=float(m["base_us"]),
                         per_lane_ns=float(m["per_lane_ns"]))
    return model, {"source": "calib", "path": str(p),
                   "hash": calib["provenance"].get("calib_hash")}


# ------------------------------------------------------------------ check


def check_calib(calib: dict, evidence: dict) -> list[dict]:
    """Tolerance-banded drift check of a pinned calibration against an
    evidence doc: refit the evidence and compare coefficients, then
    compare each reconcilable wave's implied GB/s. Every drift record
    NAMES the drifted coefficient or wave. (Equality-grade
    self-consistency, whether the EMBEDDED samples reproduce the pinned
    model, is not checked here: fresh hardware evidence legitimately
    differs by noise.)"""
    out: list[dict] = []
    tol = calib.get("tolerance") or DEFAULT_TOLERANCE
    rel_c = float(tol.get("rel_coeff", DEFAULT_TOLERANCE["rel_coeff"]))
    rel_g = float(tol.get("rel_gbps", DEFAULT_TOLERANCE["rel_gbps"]))
    try:
        refit = fit_service_model(evidence.get("samples", []))
    except ValueError as e:
        out.append({"what": "coefficient", "name": "(fit)",
                    "pinned": None, "measured": None,
                    "message": f"evidence is unfittable: {e}"})
        refit = None
    if refit is not None:
        for coeff in ("base_us", "per_lane_ns"):
            pin = float(calib["model"][coeff])
            got = float(refit[coeff])
            if abs(got - pin) > rel_c * max(abs(pin), 1e-9):
                out.append({
                    "what": "coefficient", "name": coeff,
                    "pinned": pin, "measured": got,
                    "message": f"coefficient {coeff} drifted: pinned "
                               f"{pin} vs refit {got} "
                               f"(tolerance {rel_c:.0%})"})
    ev_waves = evidence.get("waves") or {}
    for name, row in sorted((calib.get("waves") or {}).items()):
        pin = row.get("gbps")
        erow = ev_waves.get(name)
        if pin is None or not isinstance(erow, dict):
            continue
        ms, by = erow.get("ms_per_step"), erow.get("bytes_per_step")
        if not ms or not by:
            continue
        got = implied_gbps(ms, by)
        if abs(got - float(pin)) > rel_g * max(abs(float(pin)), 1e-12):
            out.append({
                "what": "wave", "name": name,
                "pinned": pin, "measured": round(got, 6),
                "message": f"wave {name} drifted: pinned implied "
                           f"{pin} GB/s vs measured {round(got, 6)} "
                           f"GB/s (tolerance {rel_g:.0%})"})
    return out


# ------------------------------------------------------------------ audit


def audit_journal(doc: dict) -> list[dict]:
    """Replay a decision journal through the pure policy functions
    (choose_width / max_backlog / recommend_hot_frac) and return every
    entry whose recorded decision the replay does not reproduce
    bit-for-bit. [] == the journal is exactly what the policy would
    have decided on the recorded inputs."""
    from ..serve import controller as C
    if doc.get("kind") != "dintcal_journal":
        raise ValueError("not a dintcal_journal document")
    if doc.get("schema") != C.JOURNAL_SCHEMA:
        raise ValueError(f"journal schema {doc.get('schema')!r}, this "
                         f"auditor replays schema {C.JOURNAL_SCHEMA}")
    c = doc["cfg"]
    cfg = C.ControllerCfg(
        widths=tuple(int(w) for w in c["widths"]),
        slo_us=float(c["slo_us"]), headroom=float(c["headroom"]),
        slo_fraction=float(c["slo_fraction"]),
        rate_alpha=float(c["rate_alpha"]),
        service_alpha=float(c["service_alpha"]),
        hysteresis_blocks=int(c["hysteresis_blocks"]))
    out: list[dict] = []

    def bad(i, e, msg):
        out.append({"index": i, "block": e.get("block"),
                    "kind": e.get("kind"),
                    "message": f"entry {i} (block {e.get('block')}): "
                               f"{msg}"})

    for i, e in enumerate(doc.get("entries", [])):
        kind = e.get("kind")
        try:
            if kind == "width":
                svc = {int(k): float(v)
                       for k, v in e["inputs"]["service_us"].items()}
                want, sat = C.choose_width(
                    float(e["inputs"]["offered_rate"]), svc, cfg)
                got = (e["decision"]["width"],
                       e["decision"]["saturated"])
                if (want, sat) != got:
                    bad(i, e, f"recorded width decision {got} but "
                              f"choose_width reproduces "
                              f"({want}, {sat})")
            elif kind == "shed":
                inp = e["inputs"]
                bound = C.max_backlog(int(inp["width"]),
                                      float(inp["service_us_w"]),
                                      cfg) * int(inp["scale"])
                shed = max(int(inp["backlog"]) - bound, 0)
                got = (e["decision"]["bound"], e["decision"]["shed"])
                if (bound, shed) != got:
                    bad(i, e, f"recorded shed decision (bound, shed) "
                              f"= {got} but max_backlog reproduces "
                              f"({bound}, {shed})")
            elif kind == "hot_frac":
                inp = e["inputs"]
                rec = C.recommend_hot_frac(float(inp["cur"]),
                                           int(inp["hot_hits"]),
                                           int(inp["hot_cold_rows"]))
                if rec != e["decision"]["hot_frac"]:
                    bad(i, e, f"recorded hot_frac "
                              f"{e['decision']['hot_frac']} but "
                              f"recommend_hot_frac reproduces {rec}")
            else:
                bad(i, e, f"unknown journal entry kind {kind!r}")
        except (KeyError, TypeError, ValueError) as exc:
            bad(i, e, f"malformed entry: {exc!r}")
    return out


def load_journal(path) -> dict:
    """Read a journal: either one JSON document with "entries", or the
    JSONL stream dintserve --journal writes (header line, then one
    entry per line)."""
    text = Path(path).read_text()
    stripped = text.lstrip()
    if stripped.startswith("{") and "\n{" not in text.strip():
        doc = json.loads(text)
        if "entries" not in doc:
            doc["entries"] = []
        return doc
    lines = [ln for ln in text.splitlines() if ln.strip()]
    if not lines:
        raise ValueError(f"{path}: empty journal")
    head = json.loads(lines[0])
    head["entries"] = [json.loads(ln) for ln in lines[1:]]
    return head


def dump_journal_jsonl(doc: dict, path) -> Path:
    """Write header + entries as JSONL (the streamable on-disk form)."""
    head = {k: v for k, v in doc.items() if k != "entries"}
    path = Path(path)
    with open(path, "w") as fh:
        fh.write(json.dumps(head, sort_keys=True) + "\n")
        for e in doc.get("entries", []):
            fh.write(json.dumps(e, sort_keys=True) + "\n")
    return path


# ------------------------------------------------------ fixture synthesis


def synthesize_evidence() -> dict:
    """Deterministic evidence, the JAX package's fixture (same pattern
    as attrib.synthesize_trace): service samples drawn from a 'measured'
    ServiceModel (base 162us, 38ns/lane — deliberately off the 150/40
    prior so the fitted-vs-prior delta is visible end to end) with a
    fixed residual pattern, and per-wave rows for every reconcilable
    tatp_dense wave at a synthetic 'measured' bandwidth ladder. Pure
    arithmetic — no clock, no RNG — so regeneration is bit-stable."""
    from ..serve.controller import ServiceModel
    from . import waves as W
    true = ServiceModel(base_us=162.0, per_lane_ns=38.0)
    widths = (256, 1024, 4096, 8192)
    reps = 6
    samples = []
    i = 0
    for w in widths:
        for _ in range(reps):
            resid = 0.25 * ((i * 7) % 5 - 2)     # in [-0.5, +0.5]
            samples.append([w, round(true.service_us(w) + resid, 6)])
            i += 1
    geometry = {"w": 1024, "k": 2, "vw": 4}
    ev_waves = {}
    idx = 0
    for name in W.WAVES_BY_ENGINE["tatp_dense"]:
        by = W.wave_bytes(name, **geometry)
        if by is None:
            continue
        gbps = 120.0 - 9.0 * idx                 # synthetic ladder
        ms = round(by / (gbps * 1e9) * 1e3, 9)
        ev_waves[name] = {"ms_per_step": ms, "bytes_per_step": by,
                          "gbps": round(implied_gbps(ms, by), 6)}
        idx += 1
    ev = _empty_evidence()
    ev["samples"] = samples
    ev["waves"] = ev_waves
    ev["counters"] = {"serve_occupancy_lanes": 48_000,
                      "serve_padded_lanes": 2_000,
                      "serve_shed_lanes": 1_500}
    ev["sources"] = ["synthesize_evidence()"]
    return ev


def synthesize_journal() -> dict:
    """Deterministic decision journal, the JAX package's fixture: drive
    a real WidthController (no engine, no clock) through a rate ramp
    into saturation and back, with synthetic backlog shedding and one
    hot_frac evaluation — every entry produced by the same code paths
    the serving plane journals through, so the fixture exercises the
    real producer, and audit replay is clean by construction."""
    from ..serve import controller as C
    cfg = C.ControllerCfg()
    model = C.ServiceModel()
    ctl = C.WidthController(cfg, model)
    rates = [2e4, 8e4, 3e5, 9e5, 5e6, 5e6, 2e6, 4e5, 1e5, 2e4, 2e4]
    for r in rates:
        for _ in range(cfg.hysteresis_blocks):
            w = ctl.width()
            ctl.observe_rate(r)
            ctl.observe_service(w, model.service_us(w))
            backlog = int(r * 0.01)              # 10 ms of offered work
            bound = ctl.max_backlog()
            if backlog > bound:
                ctl.journal_shed(backlog, backlog - bound)
    ctl.journal_hot_frac(0.0625, 900, 100,
                         C.recommend_hot_frac(0.0625, 900, 100))
    return ctl.journal_doc()
