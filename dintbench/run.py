"""The benchmark of the PyTorch port (`dint_tpu_torch`): one run of one
cell, from the root of a checkout.

    python3 -m dintbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

It builds the cell's tables on the device from the seed, warms the
cell's own shapes, measures for ``--seconds`` (``--trace 1``: a fixed
number of blocks under torch.profiler instead), drains, replays the plain
reference over the same inputs, compares, and prints the result as the
last line of standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or traced its per-layer
ones), ``device``, traced ``breakdown``, and last ``checks``: each
number compared with its limit, also the last lines of standard error.

It exits non-zero with no result without the cards the cell asks for,
and when ``jax``, ``jaxlib``, ``flax`` or ``dint_tpu`` is loaded once the
window has closed. ``--control NAME[,NAME]`` puts the reference with
those guarantees broken in the program's place (the control that must
come out not correct); ``--device cpu`` runs on the CPU for the tests,
with no look for a card.
"""
from __future__ import annotations

import os
import time
from pathlib import Path


def _process_start() -> float:
    """This process's start on the wall clock (from /proc; the import of
    this module where /proc is missing)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


T_START = _process_start()
ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".dintbench_cache"
# every build cache of the run inside the checkout, at a fixed path
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["USE_FLAX"] = "0"

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "dint_tpu")


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def card_power() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "not read"


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m dintbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", default="")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p.parse_args(argv)


def run(args, root: Path = ROOT) -> dict:
    """One run of the cell ``args.workload`` of ``root``'s
    BENCHMARK.json; the result's fields, and ``lines`` to print first."""
    import torch
    from . import cell, compare, hbm, mesh, registry
    from .reference import ReferenceSystem
    from .sut import SYSTEMS

    c = registry.cell(registry.load(root), args.workload, root)
    cfg, mix = c["cfg"], c["mix"]
    control = [x for x in args.control.split(",") if x]
    # a control runs in one process on one card, whatever the cell asks
    chips = 1 if control else c["workload"]["chips"]
    on_cpu = args.device == "cpu"
    if not on_cpu:
        if not torch.cuda.is_available():
            raise SystemExit("dintbench: no CUDA card (torch.cuda."
                             "is_available() is false)")
        if torch.cuda.device_count() < chips:
            raise SystemExit(f"dintbench: the cell asks for {chips} cards, "
                             f"{torch.cuda.device_count()} visible")
    trace = bool(args.trace)
    servers = cfg.get("servers", 1)
    lines = []
    if servers > 1 and not control:
        job = {"cfg": cfg, "mix": mix, "seed": args.seed,
               "seconds": args.seconds, "trace": trace,
               "device": args.device}
        run_ = mesh.run_ranks(job)
        ranks = sorted(run_["ranks"], key=lambda r: r["rank"])
        digests, locks = {}, 0
        for r in ranks:
            digests.update(r["digests"])
            locks += r["locks"]
        peak = max(r["peak"] for r in ranks)
        views = [r["view"] for r in ranks]
        cards = {r["card"] for r in ranks}
        ref_dev = torch.device("cpu") if on_cpu else \
            mesh.reference_device(servers)
    else:
        dev = torch.device("cpu" if on_cpu else "cuda:0")
        sys_ = (ReferenceSystem(cfg, mix, args.seed, dev, control=control)
                if control else
                SYSTEMS[cfg["system"]](cfg, mix, args.seed, dev))
        run_ = cell.drive(sys_, cfg, mix, args.seconds, trace)
        digests, locks, peak = run_["digests"], run_["locks"], run_["peak"]
        views = [run_["view"]]
        cards = {str(dev)}
        cell.free(sys_)
        ref_dev = dev
    setup_s = run_["t0"] / 1e9 - T_START
    cards.add(str(ref_dev))
    verdict = cell.judge(cfg, mix, args.seed, ref_dev, run_, digests, locks)
    counts = verdict["counts"]
    vals, attempted, failed, extra = cell.e2e(cfg, mix, run_, setup_s)
    kind = "cpu" if on_cpu else torch.cuda.get_device_name(0)
    device = {"platform": "cpu" if on_cpu else "gpu", "kind": kind,
              "count": len(cards), "memory_peak_bytes": peak}
    result = {"correct": compare.verdict(counts), "attempted": attempted,
              "failed": failed}
    metrics = {}
    if trace:
        ctx = {"cfg": cfg, "mix": mix, "card": kind,
               "step_bytes": hbm.step_bytes(cfg, mix),
               "peak_bytes_s": hbm.peak(kind)}
        for m in c["per_layer"]:
            read = registry.reader(m["name"])
            if len(views) > 1:
                for i, v in enumerate(views):
                    one = read([v], ctx)
                    lines.append(f"rank {i} {m['name']} = {one}")
            v = read(views, ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device["busy_s"] = sum(v["busy_s"] for v in views) / len(views)
        device["window_s"] = sum(v["window_s"] for v in views) / len(views)
        result["breakdown"] = views[0]["breakdown"]
        for i, v in enumerate(views):
            lines.append(f"rank {i} traced: steps {v['steps']} events "
                         f"{v['n_events']} window_s {v['window_s']} "
                         f"busy_s {v['busy_s']} kinds {v['kind_s']} "
                         f"host {v['host_s']}")
    else:
        for m in c["end_to_end"]:
            metrics[m["name"]] = {"value": vals[m["name"]],
                                  "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = device
    result["checks"] = compare.report(counts)
    lines.append(f"route {run_['route']} control {control or None} "
                 f"window {extra} reference_s {verdict['ref_s']:.3f} "
                 f"blocks {run_['blocks']} log_fill {verdict['log_fill']}")
    if not on_cpu:
        lines.append(f"card {card_power()}")
    return {"result": result, "lines": lines}


def main(argv=None, root: Path = ROOT) -> int:
    args = parse(argv)
    out = run(args, root)
    found = forbidden_modules()
    if found:
        print(f"dintbench: loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for line in out["lines"]:
        print(line, file=sys.stderr)
    for name, (num, lim) in out["result"]["checks"].items():
        print(f"check {name} {num} limit {lim}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["result"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
