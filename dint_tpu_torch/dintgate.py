"""dintgate: one entry point for the port's eight standing static gates
(the counterpart of tools/dintgate.sh, in its order).

    python -m dint_tpu_torch.dintgate [--quick] [--sarif PATH]
                                      [--timings PATH]

The gates, each a subprocess of this interpreter run from the repo root:

  1. dintlint --prune-allowlist --check   every pass over every target
                              (plan_check, calib_check and mut_check in
                              static form) plus the allowlist staleness
                              dry-run
  2. dintcost check --prune-allowlist --check   the cost budgets, twins
                              and link bytes
  3. dintdur check --prune-allowlist --check    durability and quorum
  4. dintplan check           the full planner gate (``--static`` under
                              --quick)
  5. dintmon check            the counter identities on the checked-in
                              counters fixture
  6. dintcal check            the calibration ledger against its evidence
  7. dintcal audit            the checked-in decision journal replayed
                              through the policy
  8. dintmut check --quick    the pinned mutant sample re-run bit for bit

Every gate runs, whatever an earlier one did: one call reports all the
damage. ``--sarif PATH`` merges the finding gates' SARIF logs into one
multi-run SARIF 2.1.0 document (dintmon and dintcal audit are identity
checks and report by exit code only). Each gate's wall seconds are
printed as one JSON line ({"metric": "dintgate", ...}) and written to
``--timings PATH`` when given.

Exit 0 iff every gate passed; otherwise 1, naming each gate that failed.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

PROG = "dintgate"
REPO = Path(__file__).resolve().parents[1]

DINTMON_FIXTURE = "tests/fixtures/dintmon_counters.json"
DINTCAL_JOURNAL = "tests/fixtures/dintcal_journal.jsonl"


def gates(quick: bool, tmp: str) -> list[tuple[str, list[str], str | None]]:
    """(name, argv, SARIF path or None) of the eight gates, in order."""
    def mod(name, *args):
        return [sys.executable, "-m", f"dint_tpu_torch.{name}", *args]

    def sarif(name):
        return os.path.join(tmp, f"{name}.sarif")
    prune = ("--prune-allowlist", "--check")
    plan = ("--static",) if quick else ()
    return [
        ("dintlint", mod("dintlint", *prune, "--sarif", sarif("lint")),
         sarif("lint")),
        ("dintcost", mod("dintcost", "check", *prune, "--sarif",
                         sarif("cost")), sarif("cost")),
        ("dintdur", mod("dintdur", "check", *prune, "--sarif",
                        sarif("dur")), sarif("dur")),
        ("dintplan", mod("dintplan", "check", *plan, "--sarif",
                         sarif("plan")), sarif("plan")),
        ("dintmon", mod("dintmon", "check", DINTMON_FIXTURE), None),
        ("dintcal", mod("dintcal", "check", "--sarif", sarif("cal")),
         sarif("cal")),
        ("dintcal-audit", mod("dintcal", "audit", DINTCAL_JOURNAL), None),
        ("dintmut", mod("dintmut", "check", "--quick", "--sarif",
                        sarif("mut")), sarif("mut")),
    ]


def run_gates(gate_list, cwd=REPO) -> list[dict]:
    """Run every gate in order (never stopping early); one record a gate:
    its name, exit code, wall seconds and ok."""
    stages = []
    for name, argv, _ in gate_list:
        print(f"=== {name}: {' '.join(argv[1:])}", flush=True)
        t0 = time.perf_counter()
        rc = subprocess.run(argv, cwd=cwd).returncode
        dt = time.perf_counter() - t0
        ok = rc == 0
        print(f"--- {name}: {'ok' if ok else f'FAIL (exit {rc}'}"
              f"{'' if ok else ')'} ({dt:.3f}s)", flush=True)
        stages.append({"gate": name, "rc": rc, "wall_s": round(dt, 3),
                       "ok": ok})
    return stages


def merge_sarif(paths, dest: str) -> int:
    """One SARIF 2.1.0 document with every readable log's runs; returns
    the number of runs merged (a gate that died before writing its log
    is named on stderr)."""
    runs = []
    for p in paths:
        try:
            with open(p) as fh:
                runs.extend(json.load(fh).get("runs", []))
        except (OSError, ValueError) as e:
            print(f"{PROG}: skipping unreadable {p}: {e}", file=sys.stderr)
    doc = {"$schema": "https://json.schemastore.org/sarif-2.1.0.json",
           "version": "2.1.0", "runs": runs}
    with open(dest, "w") as fh:
        json.dump(doc, fh, indent=1)
        fh.write("\n")
    return len(runs)


def main(argv=None, gate_list=None) -> int:
    """``gate_list`` (tests): (name, argv, sarif path) triples in place of
    the eight gates."""
    ap = argparse.ArgumentParser(prog=PROG,
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="dintplan check --static (the other gates as "
                         "always)")
    ap.add_argument("--sarif", metavar="PATH",
                    help="merge the finding gates' SARIF logs here")
    ap.add_argument("--timings", metavar="PATH",
                    help="write the per-gate wall seconds (one JSON line)")
    args = ap.parse_args(argv)
    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="dintgate_") as tmp:
        todo = gate_list if gate_list is not None else gates(args.quick,
                                                             tmp)
        stages = run_gates(todo)
        if args.sarif:
            n = merge_sarif([s for _, _, s in todo if s], args.sarif)
            print(f"{PROG}: merged SARIF ({n} runs) -> {args.sarif}")
    line = json.dumps({"metric": PROG, "schema": 1, "quick": args.quick,
                       "stages": stages,
                       "total_s": round(time.perf_counter() - t_all, 3)})
    print(line)
    if args.timings:
        with open(args.timings, "w") as fh:
            fh.write(line + "\n")
        print(f"{PROG}: stage timings -> {args.timings}")
    failed = [s["gate"] for s in stages if not s["ok"]]
    if not failed:
        print(f"{PROG}: all {len(stages)} gates ok")
        return 0
    print(f"{PROG}: FAIL — {' '.join(failed)}")
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
