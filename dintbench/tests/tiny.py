"""A checkout root with the benchmark's cells cut to CPU sizes (TATP at
800 subscribers, SmallBank at 512 accounts, the three-shard mesh at 900
subscribers), for the tests: the same BENCHMARK.json entries and metric
readers, tiny configuration and traffic files.

SmallBank's cell and the three-server cell have their configuration,
mix, system and reference in the benchmark, but BENCHMARK.json leaves
them for later: their runs spread too widely for a bound. `with_later`
adds their entries, so that the tests keep their paths held to the
reference."""
from __future__ import annotations

import json
from pathlib import Path

from dintbench.registry import ROOT

TINY_CFG = {
    "tatp-7m": {"subscribers": 800, "log_capacity": 16384},
    "smallbank-24m": {"accounts": 512, "lock_slots": 2048,
                      "log_capacity": 16384},
    "tatp-7m-3srv": {"subscribers": 900, "log_capacity": 16384},
}
LATER = {
    "configs": [{
        "name": "smallbank-24m",
        "source": "https://github.com/DINT-NSDI24/DINT (smallbank/caladan/"
                  "smallbank.h:16-18,63-69); H-Store SmallBank",
        "file": "dintbench/configs/smallbank-24m.json", "reduced": [],
        "why": "SmallBank at the reference's 24M accounts under no-wait 2PL"
               " over 2^25 hashed lock slots with three log replicas, on one"
               " card"}, {
        "name": "tatp-7m-3srv",
        "source": "https://github.com/DINT-NSDI24/DINT (tatp/caladan/"
                  "client_ebpf_shard.cc:779-900: 3 shard servers, 2 backups,"
                  " 3 logs); TATP spec 1.0",
        "file": "dintbench/configs/tatp-7m-3srv.json", "reduced": [],
        "why": "TATP at 7M subscribers as the reference deploys it: three"
               " shard servers, each a card, every write on a primary, two"
               " backups and three logs"}],
    "workloads": [{
        "name": "smallbank-24m.closed-w64k", "config": "smallbank-24m",
        "traffic": "closed-w64k", "chips": 1,
        "why": "closed loop, cohorts of 65,536, 16 a block, 90% on 4% of 24M"
               " accounts: 2PL's hashed S/X lock wave under skew"}, {
        "name": "tatp-7m-3srv.closed-w32k", "config": "tatp-7m-3srv",
        "traffic": "closed-w32k", "chips": 4,
        "why": "3 servers on 3 cards over NCCL, 32,768 a server, 16 a block:"
               " the only path with the replicate hops and the block barrier"
               " across cards; a 4th card judges"}],
    "per_layer": [{
        "name": "mesh.nccl_ms_per_step", "unit": "ms", "better": "lower",
        "source": "device_trace", "layer": "mesh",
        "moves": "committed_txn_per_s",
        "workloads": ["tatp-7m-3srv.closed-w32k"]}],
}
TINY_MIX = {"closed-w128k": {"width": 64, "cohorts_per_block": 4,
                             "trace_blocks": 3},
            "closed-w32k": {"width": 64, "cohorts_per_block": 4,
                            "trace_blocks": 3},
            "closed-w64k": {"width": 32, "cohorts_per_block": 4,
                            "trace_blocks": 3}}


def with_later(bench: dict) -> dict:
    """``bench`` with the entries of the cells left for later added."""
    out = json.loads(json.dumps(bench))
    for key, entries in LATER.items():
        have = {x["name"] for x in out[key]}
        out[key] += [x for x in entries if x["name"] not in have]
    return out


def make_root(tmp: Path, cfg_edit=None) -> Path:
    """``tmp`` laid out as a checkout: BENCHMARK.json as the repo's (with
    the cells left for later), each
    configuration and mix cut to its tiny size (``cfg_edit``: more keys a
    configuration), and the real metric readers looked up in place."""
    bench = with_later(json.loads((ROOT / "BENCHMARK.json").read_text()))
    (tmp / "dintbench" / "configs").mkdir(parents=True)
    (tmp / "dintbench" / "traffic").mkdir(parents=True)
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg.update(TINY_CFG[c["name"]])
        cfg.update((cfg_edit or {}).get(c["name"], {}))
        (tmp / c["file"]).write_text(json.dumps(cfg))
    for name, edit in TINY_MIX.items():
        mix = json.loads((ROOT / "dintbench" / "traffic"
                          / f"{name}.json").read_text())
        mix.update(edit)
        (tmp / "dintbench" / "traffic" / f"{name}.json").write_text(
            json.dumps(mix))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
