"""dintserve CLI: drive the serving plane (the port of tools/dintserve.py,
over `dint_tpu_torch.serve`).

Subcommands
-----------
run       serve one open-loop arrival schedule end to end and print the
          report (offered vs achieved rate, queue/service percentile
          split, shed count, width trajectory, SLO verdict). --virtual
          runs under the deterministic VirtualClock + ServiceModel; the
          default RealClock measures wall time. --journal streams the
          controller's decision journal as JSONL (`dintcal audit` replays
          it). --mesh HxC serves SmallBank over the whole 2-D (dcn x
          ici) mesh instead (`MeshServeEngine`: per-host admission, one
          global controller, width switches drained on every
          partition); add --overlap for the double-buffered route.
          Under torchrun (``python -m torch.distributed.run
          --standalone --nproc-per-node P -m dint_tpu_torch.dintserve
          run --mesh HxC``) the mesh spans the P ranks, one a host or a
          block of hosts: rank 0 admits and leads, every rank runs its
          partitions, and rank 0 prints and writes --json/--journal.
          Exit 0 when the SLO is met (or --no-gate), 1 otherwise.
simulate  controller-only rehearsal: the width trajectory the controller
          would take for a schedule under the service-time model (flags,
          else `calib.resolve_service_model`: the port's calibration or
          the defaults, and the report says which); --mesh HxC rehearses
          per-partition rates (lanes_scale = H*C). No engine, no device.
describe  the serving-plane contract: serve counters, serve waves, the
          serve targets the static gates check (with their dintcost
          budgets), and the controller's defaults.

Examples
--------
  python -m dint_tpu_torch.dintserve run --engine tatp_dense \\
      --size 7000000 --rate 500000 --window 2 --journal journal.jsonl
  python -m dint_tpu_torch.dintserve run --size 2000 --virtual \\
      --device cpu --json
  python -m dint_tpu_torch.dintserve run --mesh 3x2 --size 24000000 \\
      --rate 400000 --window 2
  python -m torch.distributed.run --standalone --nproc-per-node 3 \\
      -m dint_tpu_torch.dintserve run --mesh 3x2 --size 24000000 \\
      --rate 400000 --window 2
  python -m dint_tpu_torch.dintserve simulate --rate 200000 --window 1
  python -m dint_tpu_torch.dintserve describe

What differs from tools/dintserve.py: ``run`` serves on the card unless
``--device cpu``; ``--mesh`` without ``--device`` spreads the partitions
over the visible cards (`parallel.mesh.placement`), and a ``--device``
puts them all on that one device; the report names the ``cards`` used;
``describe`` lists each serve target with its `TARGET_COST` dispatches a
step and its bytes budget a step (a number, or the formula over the
waves.py ledger) at the lint geometry.
"""
from __future__ import annotations

import argparse
import json
import re
import sys

DEFAULT_WIDTHS = "256,1024,4096,8192"


def _widths(s: str) -> tuple[int, ...]:
    return tuple(sorted(int(x) for x in s.split(",")))


def _schedule(args):
    from .serve import arrivals as arr
    kw = {}
    if args.kind == "burst":
        kw = dict(burst_lanes=args.burst_lanes,
                  burst_every_s=args.burst_every_s)
    return arr.make_schedule(args.kind, args.rate, args.window,
                             seed=args.seed, **kw)


def _mesh_shape(s: str) -> tuple[int, int]:
    m = re.fullmatch(r"(\d+)\s*[xX*]\s*(\d+)", s.strip())
    if not m:
        raise SystemExit(f"--mesh wants HxC (e.g. 4x2), got {s!r}")
    return int(m.group(1)), int(m.group(2))


def _plan_arg(spec: str):
    """--plan auto|off|PATH -> the ServeEngine plan parameter."""
    if spec == "auto":
        return "auto"
    if spec == "off":
        return None
    with open(spec) as fh:
        return json.load(fh)


def _flag_model(args):
    """The ServiceModel the flags give, or None when neither is set."""
    from .serve import ServiceModel
    if args.model_base_us is None and args.model_per_lane_ns is None:
        return None
    return ServiceModel(
        base_us=args.model_base_us if args.model_base_us is not None
        else 150.0,
        per_lane_ns=args.model_per_lane_ns
        if args.model_per_lane_ns is not None else 40.0)


def cmd_run(args) -> int:
    """``run``; under torchrun (`dist.from_env`) the ranks join a group
    first, and leave it however the run ends."""
    from .parallel import dist
    group = dist.initialize(device=args.device) if dist.from_env() else None
    try:
        return _run(args, group)
    finally:
        if group is not None:
            dist.shutdown()


def _run(args, group) -> int:
    from .serve import (ControllerCfg, MeshServeEngine, ServeEngine,
                        VirtualClock)
    # flags win; left unset, the width menu, SLO and service prior come
    # from the plan's serve priors inside ServeEngine
    cfg = None
    if args.widths is not None or args.slo_us is not None:
        cfg = ControllerCfg(
            widths=_widths(args.widths or DEFAULT_WIDTHS),
            slo_us=args.slo_us if args.slo_us is not None else 5_000.0)
    common = dict(cfg=cfg, model=_flag_model(args),
                  cohorts_per_block=args.cpb, depth=args.depth,
                  clock=VirtualClock() if args.virtual else None,
                  monitor=not args.no_monitor, seed=args.seed,
                  plan=_plan_arg(args.plan), device=args.device)
    if args.mesh:
        eng = MeshServeEngine(args.size, mesh_shape=_mesh_shape(args.mesh),
                              overlap=args.overlap, group=group, **common)
        label = f"mesh {args.mesh} multihost_sb"
    else:
        if args.overlap:
            raise SystemExit("--overlap needs --mesh")
        eng = ServeEngine(args.engine, args.size, **common)
        label = args.engine
    cfg = eng.cfg
    if not args.virtual:
        eng.warmup()          # build the kernels outside the window
    eng.run(_schedule(args))
    eng.close()
    rep = eng.snapshot()          # across ranks: rank 0's, on every rank
    if args.mesh:
        # the placement: the distinct devices the partitions live on
        rep["cards"] = [str(d) for d in eng.mesh.cards] if group is None \
            else sorted({c for cs in rep["rank_cards"] for c in cs})
    if group is not None and group.rank:
        return 0                  # rank 0 prints and writes
    if args.journal:
        from .monitor import calib as CAL
        CAL.dump_journal_jsonl(eng.ctl.journal_doc(), args.journal)
    if args.json:
        print(json.dumps(rep))
        return 0 if rep["slo_met"] or args.no_gate else 1
    print(f"dintserve {label} size={args.size} "
          f"widths={list(cfg.widths)} slo={cfg.slo_us:.0f}us "
          f"{'virtual' if args.virtual else 'real'} clock")
    print(f"  offered  {rep['offered']} arrivals "
          f"({rep['offered_rate']:.0f}/s) -> admitted {rep['admitted']}, "
          f"shed {rep['shed']}")
    print(f"  achieved {rep['achieved_rate']:.0f} committed/s over "
          f"{rep['blocks']} blocks ({rep['elapsed_s']:.3f}s)")
    q, s = rep["queue"], rep["service"]
    print(f"  queue    p50={q['p50']:.0f}us p99={q['p99']:.0f}us "
          f"p999={q['p999']:.0f}us")
    print(f"  service  p50={s['p50']:.0f}us p99={s['p99']:.0f}us "
          f"p999={s['p999']:.0f}us")
    print(f"  slo      {'MET' if rep['slo_met'] else 'MISSED'} "
          f"(queue p99 vs {rep['slo_us']:.0f}us)")
    ctl = rep["controller"]
    print(f"  width    final={ctl['width']} switches={ctl['switches']} "
          f"saturated={ctl['saturated']}")
    pl = rep.get("plan")
    if pl:
        over = (" env-overridden: " + ",".join(pl["overridden"])
                if pl["overridden"] else "")
        print(f"  plan     {pl['source']} (cost_model {pl['hash']}){over}")
    else:
        print("  plan     (none)")
    c = rep["counters"]
    if c:
        print(f"  lanes    occupancy={c.get('serve_occupancy_lanes', 0)} "
              f"padded={c.get('serve_padded_lanes', 0)} "
              f"shed={c.get('serve_shed_lanes', 0)}")
    if "mesh" in rep:
        m = rep["mesh"]
        print(f"  mesh     {m['n_hosts']}x{m['n_ici']} "
              f"hierarchical={m['hierarchical']} overlap={m['overlap']} "
              f"cards={','.join(rep['cards'])}")
        for hrep in rep["per_host"]:
            print(f"    host {hrep['host']}: admitted={hrep['admitted']} "
                  f"shed={hrep['shed']}")
    return 0 if rep["slo_met"] or args.no_gate else 1


def cmd_simulate(args) -> int:
    from .monitor.calib import resolve_service_model
    from .serve import ControllerCfg, simulate_widths
    cfg = ControllerCfg(
        widths=_widths(args.widths or DEFAULT_WIDTHS),
        slo_us=args.slo_us if args.slo_us is not None else 5_000.0)
    model = _flag_model(args)
    if model is not None:
        model_meta = {"source": "flags", "path": None, "hash": None}
    else:
        model, model_meta = resolve_service_model()
    shape = _mesh_shape(args.mesh) if args.mesh else None
    widths = simulate_widths(_schedule(args), cfg, model,
                             cohorts_per_block=args.cpb,
                             lanes_scale=shape[0] * shape[1] if shape
                             else 1)
    out = {"widths": sorted(set(widths)), "blocks": len(widths),
           "trajectory": widths if args.json else None,
           "final_width": widths[-1] if widths else None,
           "mesh": list(shape) if shape else None,
           "model": {"base_us": model.base_us,
                     "per_lane_ns": model.per_lane_ns, **model_meta}}
    if args.json:
        print(json.dumps(out))
        return 0
    src = model_meta["source"].upper()
    if src == "DEFAULTS":
        src = "DEFAULTS (no calibration)"
    elif model_meta["hash"]:
        src += f" {model_meta['path']} ({model_meta['hash']})"
    print(f"simulate: {len(widths)} blocks; final width "
          f"{out['final_width']}")
    print(f"  model: base_us={model.base_us} "
          f"per_lane_ns={model.per_lane_ns} source={src}")
    runs, prev = [], None
    for w in widths:
        if prev is not None and w == prev[0]:
            prev[1] += 1
        else:
            prev = [w, 1]
            runs.append(prev)
    print("  trajectory:",
          " -> ".join(f"{w}x{n}" for w, n in runs) or "(no blocks)")
    return 0


def cmd_describe(args) -> int:
    from .monitor import counters as mon
    from .monitor import waves
    from .serve import ControllerCfg

    print("serve counters (dintmon; identity: occupancy + padded == "
          "width x serving steps, shed mirrored host==device):")
    for n in mon.ALL_NAMES:
        if n.startswith("serve_"):
            print(f"  {n:24s} {mon.COUNTER_DOCS[n].splitlines()[0]}")
    print("serve waves (dintscope; the mesh route_prefetch wave prices "
          "the double-buffered exchange):")
    for eng, wv in (("tatp_dense", "serve"), ("smallbank_dense", "serve"),
                    ("multihost_sb", "serve"),
                    ("multihost_sb", "route_prefetch")):
        nm = waves.full_name(eng, wv)
        print(f"  {nm}: {waves.WAVE_DOCS[nm].splitlines()[0]}")
    from .analysis import targets as tg
    print("serve targets (dintlint/dintcost/dintdur gated; TARGET_COST "
          "at the lint geometry):")
    for n in sorted(tg.TARGETS):
        if "/serve" in n:
            bud = tg.TARGET_COST[n]["budget"]
            print(f"  {n:32s} {bud['dispatches']:g} dispatches/step, "
                  f"bytes/step budget {bud['bytes']}; "
                  f"{tg.TARGET_DOCS[n].splitlines()[0]}")
    d = ControllerCfg()
    print("controller defaults: widths=%s slo_us=%.0f headroom=%.2f "
          "slo_fraction=%.2f hysteresis_blocks=%d"
          % (list(d.widths), d.slo_us, d.headroom, d.slo_fraction,
             d.hysteresis_blocks))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="dintserve", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p, engine=False):
        p.add_argument("--rate", type=float, default=50_000.0,
                       help="offered arrival rate (txn/s)")
        p.add_argument("--window", type=float, default=1.0,
                       help="schedule window (s)")
        p.add_argument("--kind", default="poisson",
                       choices=("poisson", "constant", "burst"))
        p.add_argument("--burst-lanes", type=int, default=4096)
        p.add_argument("--burst-every-s", type=float, default=0.01)
        p.add_argument("--widths", default=None,
                       help="width menu (default: the pinned plan's "
                            f"serve priors, else {DEFAULT_WIDTHS})")
        p.add_argument("--slo-us", type=float, default=None)
        p.add_argument("--cpb", type=int, default=4,
                       help="cohorts per dispatched block")
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--model-base-us", type=float, default=None)
        p.add_argument("--model-per-lane-ns", type=float, default=None)
        p.add_argument("--json", action="store_true")
        p.add_argument("--mesh", default=None, metavar="HxC",
                       help="serve over the whole 2-D mesh (e.g. 3x2): "
                            "run drives MeshServeEngine, simulate "
                            "rehearses per-partition rates (lanes_scale "
                            "= H*C)")
        if engine:
            p.add_argument("--engine", default="tatp_dense",
                           choices=("tatp_dense", "smallbank_dense"))
            p.add_argument("--overlap", action="store_true", default=None,
                           help="mesh only: serve through the double-"
                                "buffered route; unset = the plan's "
                                "choice")
            p.add_argument("--plan", default="auto", metavar="auto|off|PATH",
                           help="the plan: 'auto' reads the pinned plan "
                                "(PLAN_H100.json), "
                                "'off' none (the report records \"plan\": "
                                "null), a path that plan file")
            p.add_argument("--size", type=int, default=100_000,
                           help="n_sub / n_accounts")
            p.add_argument("--depth", type=int, default=2,
                           help="host->device pump depth")
            p.add_argument("--virtual", action="store_true",
                           help="deterministic VirtualClock + model")
            p.add_argument("--no-monitor", action="store_true")
            p.add_argument("--no-gate", action="store_true",
                           help="exit 0 even when the SLO is missed")
            p.add_argument("--journal", metavar="PATH", default=None,
                           help="stream the controller decision journal "
                                "as JSONL (replayable bit for bit with "
                                "`dintcal audit`)")
            p.add_argument("--device", default=None,
                           help="torch device of the tables (default: "
                                "the CUDA card, with --mesh the visible "
                                "cards; 'cpu' for the plain path)")

    common(sub.add_parser("run", help="serve a schedule"), engine=True)
    common(sub.add_parser("simulate",
                          help="controller-only width trajectory"))
    sub.add_parser("describe", help="serving-plane contract")

    args = ap.parse_args(argv)
    from .parallel import dist
    if dist.from_env() and not (args.cmd == "run" and args.mesh):
        raise SystemExit("across processes dintserve runs only `run --mesh "
                         "HxC` (the mesh serving plane over the ranks)")
    return {"run": cmd_run, "simulate": cmd_simulate,
            "describe": cmd_describe}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
