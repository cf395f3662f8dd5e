#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dint_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py            # from the repo root; needs one CUDA card
    python3 chip_smoke.py --calibrate 3   # phase 1, then phase 22 (c)
                                          # alone 3 times: the fits' spread
    python3 chip_smoke.py --mesh-cards [N]  # phase 1, then phase 24
                                          # alone (the mesh over every
                                          # card), N spread/one-card
                                          # pairs a route in turns
    python3 chip_smoke.py --mesh-procs [N]  # phase 1, then phases 25
                                          # and 26 alone (the mesh and
                                          # its serving plane across
                                          # processes), N pairs of ranks
                                          # and one-process runs in turns
                                          # in phase 25
    python3 chip_smoke.py --turns DIR     # this tree against the tree at
                                          # DIR (e.g. the parent commit's
                                          # `git archive`) on one card, in
                                          # turns DIR, here, here, DIR

Phases, each of which fails the run (non-zero exit, no result line) on any
mismatch or error:

1. The card: name and power limit (nvidia-smi), and the nvcc build of every
   kernel in dint_tpu_torch/csrc (all sources compiled at once), with what
   `ptxas -v` reported for each: registers, barriers, spills.
2. Each kernel against its plain PyTorch version on the card, at the shapes
   the main paths give it, exact equality. TATP: gather_rows over a
   meta-sized [154,000,023] table (K = 65,536) and a val-sized table
   (K = 32,768 word offsets), each alone and as the two streams of one
   launch, the step's call: timed beside the two single-stream launches in
   turns and beside two index_select, and one call in a CUDA graph
   capture and under torch.profiler, which must show one kernel and
   nothing else on the stream (the profiler where its trace holds any
   device event);
   lock_arbitrate over an [n1] arb array
   (M = 16,384) prefilled with t-1, t-2 and 0 stamps, with heavy duplicates
   and inactive lanes, and one call checked the same way. SmallBank at 24M accounts
   (K = 3w = 24,576 lanes, 90% of them on the 4% hot set): gather_streams
   (the gather pass, as gather_rows' tuple form) over x_step/s_step [2^25]
   and bal [48,000,001], and the default route's three-stream gather_rows
   on the same inputs, timed in turns beside three single-stream launches
   and gather_streams (one kernel a call; B5's time is its first timing
   on these inputs, and the mean of its two turns is kept beside it);
   scatter_streams into bal, a log-sized [1,048,576 x 18] table and the
   [1,920,000] mirror with ~30% of lanes masked; gather_rows_hot and
   scatter_rows_hot over bal with the mirror.
   TATP's other routes: lock_validate (V = R = 32,768, M = 16,384) over the
   meta and arb tables, and at TATP's shapes the hot route's gathers
   (meta K = 65,536, magic K = 32,768; each alone, beside gather_rows on
   the same lanes, and the two as the streams of one launch, timed in turns
   beside two single-stream launches, one kernel a call) and installs
   (meta and val, 16,384 lanes) through the 280,000-row mirrors, each alone
   and as the two streams of one scatter_rows_hot launch on the same lanes
   (the step's call, one kernel a call), timed in turns beside the two
   single-stream launches and beside four index_copy_ of the kept rows,
   and the fused install_log scatter_streams (val, meta, log x3
   [1,048,576 x 42], and the two mirrors). Times: kernel, plain version,
   yardstick (torch calls that compute the same function), the bytes
   bound at 3.35 TB/s, and the
   kernel's time over the yardstick's, taken in the same call (the
   figure that compares across calls and cards). The
   store's scan_rows (K = 4096 windows of lg = 356 rows over the
   67,108,864-row ordered run, offsets located from the runner's key draws,
   edge and duplicate windows) runs inside phase 7, which builds that run.
   The probe's scalar_scatter over its [4297 x 512] table, K = 16,384, on
   unique indices and two duplicate patterns in a row (the last lane wins),
   timed beside clone + index_put_, and one call checked the same way (one
   kernel, no memset or copy); then the probe's entry point
   (`python -m dint_tpu_torch.profile_scalar_scatter`), counted.
3. The port on the CPU against the port on the card, end to end, the same
   host-made draws: TATP on all four routes (n_sub=2000, w=256, 4
   cohorts/block, contention mix; the routes also equal each other) and
   SmallBank on all four routes (n=300, w=256, 4 cohorts/block): tables,
   mirrors, log and stats bit-identical. The store: explicit steps (a
   same-key GET/SET/INSERT/DELETE chain, maintain_bloom, the hot route, a
   spill after an alternate-bucket insert, scans over a stale overlay that
   answer RETRY until the refresh), then the runner (n_keys=2000, w=256, 2
   cohorts/block, scan_max=16, delta_cap=32) with use_scan off and on:
   tables, runs, mirrors, replies, scan replies, stats and counters
   bit-identical. The cache tier: CachedStore on every policy, with and
   without the hot mirror, at tests/test_store_cache.py's sizes (12 rounds
   of 96 lanes with scans over 60 keys and 8 buckets; 20 rounds over 120
   keys and 4 buckets): replies, stats, cache and backing store
   bit-identical.
4. The TATP main path at full width: populate_device at 7,000,000
   subscribers, build_pipelined_runner(w=8192, cohorts_per_block=16,
   val_words=10), one warm block, 8 timed blocks, drain; TATP invariants
   and launch counts (one gather_rows launch of two streams and one
   lock_arbitrate a step). Its final state is kept for phase 6.
5. The SmallBank main path at full width: create(24,000,000), w=8192, 16
   cohorts/block, 90/4 skew, on the four routes (default, use_hotset,
   use_fused, both) from identical tables and generator seeds: one warm
   block, 8 timed blocks, drain each; SmallBank invariants, launch counts
   per route, and the routes identical to each other.
6. TATP's other routes at full width (use_hotset, use_fused, both), each
   from the same populate_device seed and generator seeds as phase 4: the
   TATP invariants, mirror coherence, launch counts per route, and the
   final tables, arb, log and stats identical to phase 4's. Then one serve
   block (occupancy 8192 - 512*i at step i) with monitor=True on the fused
   route, whose counters must reconcile with its stats.
7. The store main path: YCSB-E over the reference store's 24,000,000 keys
   (make_store_table: 2^24 buckets x 4 slots, VW=10), build_serve_runner
   (w=4096, 2 cohorts/block, 95% scans of 1-100 rows, scan_max=100,
   delta_cap=256, use_scan, monitor): one warm block and 8 timed blocks;
   committed == attempted in every step, the scan counters reconcile with
   the draws, then one explicit step whose every GET, SET and scan lane is
   checked (scans against the pre-step versions), and refresh(run) ==
   from_table(table) leaf for leaf, and the drain. Then the point runner
   (use_scan=False) on a clone of the table, and one serve block at
   occupancy 4096 - 256*i.
8. The cache tier at full width: CachedStore over a 2^23-bucket x 4-slot
   device cache (the reference's 9M-entry cache rounded down to a power of
   two) and a backing store of the reference store's 24,000,000 keys, VW=10,
   w=4096. One request stream: a GET sweep of the hot prefix [1, 960,000],
   then one warm block and 8 timed blocks of 16 rounds of 50/50 GET/SET,
   keys 90% from the prefix and 10% uniform over [1, 26,400,000). It runs
   on WB_BLOOM, WB_NOBLOOM, WT and WB_BLOOM with the hot mirror of keys
   [0, 960,001), each from a copy of one populated backing store: ms a
   round, answered ops/s, hits, misses, bloom negatives, writebacks, the
   split of a round, launches a round, peak memory. Every round's replies
   must equal the store engine's replay of the stream (rtype and ver on
   every lane, val on VAL lanes), the hot run's the WB_BLOOM run's, and
   after a flush every cached entry the backing store's record. The hot
   run also holds its kernel calls against their plain versions on its
   warm block's own arguments and times them: the one two-stream
   gather_rows_hot call a round and the two two-stream scatter_rows_hot
   calls (write-back and refill), each one kernel a call and beside its two
   single-stream launches in turns.
9. The bench entry: `python -m dint_tpu_torch.bench` in a process
   of its own with 3 s windows (DINT_BENCH_WINDOW_S=3) and its profile
   block on, after `torch.cuda.empty_cache()`, the kernels already built:
   TATP at 7,000,000 subscribers, w=8192, then SmallBank at 24,000,000
   accounts, w=8192 and 16384. Its one stdout line must parse and hold
   every key of the bench line, with committed txn/s > 0, SmallBank's
   balance conserved, the route PLAN.json pins and the card's name and
   power limit; each leg must launch its route's kernels once a step
   (counted in the bench's process).
10. Recovery at full size (run after phases 6 and 5). TATP: phase 4's
   final tables, every log head below the 65,536 slots of a lane, rebuilt
   from phase 4's base tables (populate_device from the same seed) and
   each of the three replicas with `replay_tatp_dense` on the card, and
   from replica 0 with the numpy `recover_tatp_dense`: val, ver and
   exists equal the live tables on every row, no row locked, and the run
   changed ver. SmallBank: create(24,000,000), w=8192, one warm block and
   at most 4 more blocks of 16 cohorts that keep every head below
   capacity, the drain; each replica replayed and replica 0 recovered:
   bal and total_balance equal the live tables. The run then goes on until
   a lane wraps, and recovery must refuse the ring.
11. The generic engines. First the CPU against the card at a small
   size, the same inputs: lock2pl, fasst (and step_attr), logsrv,
   smallbank.step and tatp.step (both CF lock flavours) over 8 contended
   batches each; one generic TATP pipelined block + drain and one serial
   block (n_sub=2000, w=64; n_sub=32, w=256 on the US/IC contention mix
   with the counters); one generic SmallBank block with the counters
   (n=64, w=128); the three trace clients and the log client: replies,
   tables, stats and counters bit-identical. Then, at exp.py sweep_micro's
   settings, each microbenchmark for a 1.5 s window after a warm round:
   lock_2pl and lock_fasst (plain and attributed) over 2^26-slot tables
   (the reference's 36M locks rounded up to a power of two) on a
   20,000-txn trace of 5-10 keys among 4,800, cohort 512, width 8192;
   log_server at width 8192 into 16 x 2^20 entries of 10 value words
   (rounds or waves a second, committed a second, abort rate, p50/p99).
   lock_2pl's table is checked after one acquire wave (no slot S and X,
   counts == grants) and after every release (all 0); no OCC lock is held
   after the window; the ring heads sum to the appends. Then generic TATP
   at 7,000,000 subscribers, 3 replicas of tatp.create's defaults
   (populate_shards: numpy draws, the CF table placed once and cloned),
   w=4096, 8 cohorts a block: build_pipelined_runner, one warm and 3 timed
   blocks, drain; then build_runner(validate=True), one block; each with
   accounting closed, magic_bad 0, no lock held and the replicas
   identical. Then generic SmallBank at 24,000,000 accounts
   (create_stacked on the card), build_runner, one warm and 3 timed
   blocks: accounting, each replica's balance delta == the stats', the
   replicas identical, every lock released. None of the nine kernels is
   launched: the counts must read 0. The TATP replicas go on to phase 12.
12. The host coordinators. TATP: `tatp_client.Coordinator` over phase 11's
   three replicas (populate_shards at 7,000,000 subscribers, VW=10),
   width 8192, cohorts of 2048 txns (at most 4 lanes a txn, so no wave
   passes the width) for at least 8 cohorts and 3 s; then each replica's
   CF lock table replaced by an empty attributing one (the plain table
   holds no lock and no version) and one cohort on it. SmallBank:
   `init_shards` at 24,000,000 accounts, width 8192, cohorts of 4096 from
   `sb_make_txns` at the 90/4 skew, at least 8 cohorts and 3 s. Checks:
   accounting closes on the phase's own deltas; no lock held and the log
   heads equal after every cohort; the replicas bit-identical (an
   attributed CF lock's owner words apart); SmallBank's total_balance
   moves by exactly each cohort's committed deltas; the attribution
   counters 0 on plain shards and consistent on attr shards; none of the
   nine kernels launched. Prints committed txn/s, the abort mix and ms a
   cohort.
13. The serving plane. `ServeEngine` over tatp_dense (1,000,000
   subscribers, VW=10; 7M in the bench's probe below and phase 16 (e),
   (f)), smallbank_dense (24,000,000 accounts) and the
   store (24,000,000 keys, YCSB-E: 95% scans of 1-100 rows, scan_max 100,
   delta_cap 512), each with plan='auto' (PLAN.json's serve priors, which
   were calibrated for a TPU: the width menu 256-8192, the SLO and the
   first service estimates; the store has none and takes the defaults),
   monitor=True, a RealClock and 2 cohorts a block: the populate, warmup
   (which must leave the live tables bit-identical), then a 1.5 s Poisson
   schedule at half the closed-loop rate phases 9 and 7 measured, with a
   burst of 4x the top width at its middle. Checks: admitted + shed ==
   offered; serve_shed_lanes == shed; padded lanes == sum(cpb * w) -
   sum(occ); the counters equal the stats' columns and the steps;
   memory_allocated constant over the steady blocks at one width; each
   route's kernels once a step (gather_rows + lock_arbitrate, gather_rows,
   scan_rows); shedding, and a width switch forced by the burst, or, where
   no width of the plan's priors (PLAN_H100.json's, the card's) meets the
   controller's service bound, service at the priors' knee from the first
   block. Then the
   bench's serve probe (`bench.serve_probe`) at the bench's shapes (7M, w
   = 8192, 16 cohorts a block): its eleven keys. Prints each family's
   achieved and offered rate, queue and service p50/p99, widths, shed
   count, and the warmup and populate seconds.
14. The wire plane (run after phase 12, before phase 13). (a) Each of the
   six wire profiles (store, lock_2pl, lock_fasst, log_server, smallbank,
   tatp) on a small state: a CPU EnginePump, a card one and a card one at
   depth 2 (serve_forever) take the same scripted batches (full-width
   ones, unknown wire codes, same-key lanes, and a read followed by a
   batch that writes what it read) through a stub in place of the C++
   server, which scribbles over a slot once it is replied: wire replies
   (type, val bytes, ver), final state and lane counts bit-identical; then
   one loopback ShimClient round trip a profile on distinct keys, the card
   pump's replies equal to the CPU pump's. (b) TATP over the wire at
   7,000,000 subscribers: three card pumps (tatp.step, w=8192, flush 500
   us) over phase 12's replicas (attributing CF lock tables) and a
   WireCoordinator with 8 sockets a shard, cohorts of 2048: one warm
   cohort, then at least 3 cohorts and 3 s; the taxonomy closes,
   timeout_lanes == 0, no lock held and the log heads equal after every
   cohort, the replicas' tables, lock words and CF tables identical
   (cf_lock's owner words apart) and their logs holding the same new
   entries, each replica in its own arrival order (ROADMAP §C.8); prints
   committed txn/s, ms a cohort and each pump's batches, occupancy
   against padded lanes and queue and service p50/p99. (c) The store over
   the wire: phase 7's table of 24,000,000 keys behind a card pump
   (w=4096), two loopback clients at 50/50 GET/SET for 3 s, every SET
   carrying STORE_MAGIC in word 1: every reply that comes back answers
   its key, VAL with the magic word for a GET, ACK for a SET; replies the
   C++ ring shed (a 2 s timeout, no re-send) are counted; prints answered
   pkt/s, p50/p99 us and the losses. (d)
   `exp.sweep_micro` in-process with 1 s windows and use_hotset=True over
   store_zipf_w4096, store_scan_f95, lock_2pl, lock_fasst, log_server,
   store_wire, tatp_wire, tatp_wire_txn, tatp_colocate_c1 and
   store_cached_wb_bloom, launches counted from 0 around each point:
   store_zipf_w4096 must launch gather_rows_hot and scatter_rows_hot
   ("micro store_zipf"), store_scan_f95 scan_rows ("micro store_scan");
   then `python -m dint_tpu_torch.exp --quick --only store_wire` in a
   process of its own must exit 0 and write store_wire.json.
15. The observability plane (after phase 13). (a) The traced runners
   (trace=True, monitor=True) of TATP (n_sub=2000, w=256, 4 cohorts a
   block, contention mix) and SmallBank (300 accounts, w=256) on each of
   the four routes, on the CPU and the card from the same host-made
   draws: every block's decoded events and head, the stats, counters and
   tables identical; the same runs with trace off give the same tables,
   stats and counters. (b) Full rate at full width: TATP at 7,000,000
   subscribers (populate_device, one table through the default, fused,
   hotset and fused+hotset routes), w=8192, 16 cohorts a block,
   trace_rate 1.0 with the counters: 3 blocks and the drain a route, each
   window's ring decoded on the host, the events reconciling exactly with
   the counters and stats (lock == lock_requests, validate ==
   validate_lanes, install == install_writes, outcome == txn_attempted,
   each cause == its counter) and nothing dropped; then SmallBank at
   24,000,000 accounts, w=8192, default route, the same way, balance
   conserved. (c) After each of those runs, one block under
   monitor.profiler_session (host-padded and taken again when the profile
   holds no device event), attributed by monitor.attrib: every kernel
   slice linked to its launch through its correlation id and charged to
   its route's wave, as many slices of each kernel as the block launched;
   prints each wave's ms/step, host_ms and GB/s and the attributed share.
   (d) `python -m dint_tpu_torch.bench` (TATP leg, 3 s window) with
   DINT_TRACE=1, DINT_BENCH_PROFILE=1 and DINT_BENCH_TRACE_DIR: its
   dinttrace and breakdown objects hold their schemas, and the dinttrace
   and dintscope CLIs read what it wrote; `python -m
   dint_tpu_torch.profile_step --route fused --trace` read by
   `attrib.report`; then the untraced TATP leg in-process with 2 s
   windows and DINT_SCOPE=0, 1, 1, 0.
16. The sweeps and the calibration plane (after phase 15). (a)
   `exp.sweep_pipeline` over TATP at 7,000,000 subscribers, 4 cohorts a
   block, 1 s windows, the plan's route: closed w=8192, open at 0.5 and
   0.9 of its peak, latency w=256; then a closed point under
   DINT_PLAN_OVERRIDE=1 DINT_USE_FUSED=1. Every point has exp.py's
   artifact keys, committed + aborts == attempted, magic_bad 0, and the
   route's kernels launched. (b) SmallBank at 24,000,000 accounts: closed
   w=8192, open 0.5; the skew preset at hot_frac 0.16 with the hot tier.
   (c) a closed TATP point with DINT_TRACE=1 (its events reconcile with
   the stats of every block observed, none dropped; its goodput over
   (a)'s), then a 0.5 s closed point under DINT_EXP_TRACE_DIR: every
   device slice linked to its launch, every hand-kernel slice charged to
   a wave; the trace's size and parse time. (d) `exp.sweep_serve` over
   tatp_dense at 1M (7M's serving plane runs in phase 13, (e) and (f)),
   widths 256-8192, the _sat probe and rates 0.5 and
   1.1 of it, 1.5 s windows: offered == admitted + shed, occupancy +
   padded lanes == width x serving steps, each point's peak memory. (e)
   `dintserve run --journal` at 7M, `dintcal audit` of its journal clean.
   (f) four single-width serve runs at 7M at the serving plane's defaults
   (depth 2, 2 cohorts a block; 256, 1024, 4096, 8192; 1 s at half the
   width's closed-loop rate, tables from `populate_device`), `dintcal
   gather` + `fit`, the refit of the calibration's samples equal to its
   coefficients, `check_calib` of the committed CALIB_H100.json against
   this evidence (printed), `dintserve simulate` reading the fresh
   calibration; the runs are kept for phase 22 (c). The evidence, the
   calibration and their committed forms (CALIB_H100.evidence.json,
   CALIB_H100.json) go to $DINT_SMOKE_OUT when
   set. (g) `python -m dint_tpu_torch.drive`: every check passes, scan_rows
   launched.
17. The mesh on one card (after phase 16): the partitions of
   `dint_tpu_torch.parallel` are a list on the card, so this measures
   their work and their replication, and no link between devices. (a) The
   sharded runner (default and fused routes) at 4 shards and the 3x2
   multihost runner, 800 subscribers, w=32, 2 cohorts/block, on the CPU
   and the card from the same host-made draws: tables, backups, logs,
   heads and the stats of every step bit-identical. (b) Sharded TATP at
   7,000,000 subscribers over 3 shards (the reference's three servers),
   w=8192 a shard, 4 cohorts/block, one warm and 8 timed blocks and the
   drain, on the default and fused routes, each from `populate_device`
   tables (seeds 0-2) and generator seed 1: committed txn/s summed over
   the shards, ms a step, the abort mix, peak memory; accounting closes,
   magic_bad 0, no lock after the drain, every backup slot equal to the
   shard it mirrors, log heads 3x the version bumps, the route's kernels
   once a shard a step, the fused route's stats equal the default's; shard
   1 rebuilt from its own ring and from shard 2's (numpy
   `recover_tatp_dense`, key_hi filter); then one profiled block a route:
   device and host ms a step of the local waves and of `replicate`. (c)
   The same over a 3x2 (host, chip) mesh (`build_multihost_runner`), 4 timed
   blocks: the three copies of every row on three hosts; partition (1, 0)
   rebuilt from host 2's ring. (d) `entry.dryrun_multichip(4)` on the
   card.
18. Sharded SmallBank on the card (after phase 17): cross-device
   transactions, each partition's lock requests, replies and installs
   exchanged with `Mesh.all_to_all` (copies on the one card: no byte
   crosses a link). (a) The default, hot, fused and
   fused+hot routes with monitor and trace at 4 partitions, 512 accounts,
   w=32, 2 cohorts/block, on the CPU and the card from the same host-made
   draws: tables, mirrors, backups, logs, heads, the stats of every step,
   counters and event rings bit-identical (gather_rows, gather_rows_hot,
   scatter_rows_hot, gather_streams and scatter_streams against their
   plain versions inside the sharded step). (b) SmallBank at 24,000,000
   accounts over 3 partitions (the reference's three servers), w=8192 a
   partition, 4 cohorts/block, 90/4 skew, one warm and 8 timed blocks and
   the drain, on the default, hot and fused routes from one generator
   seed: committed txn/s summed, ms a step, the abort mix, overflow, peak
   memory; accounting closes, global balance conservation mod 2^32,
   overflow 0, no stamp of step - 1 after the drain, every backup slot
   equal to the partition it mirrors, the hot mirrors equal to the
   prefix, every ring's heads its own installs plus both hops (counted by
   source tag), head < capacity on every lane, the route's kernels once a
   partition a step, the routes' stats and tables identical; partition 1
   rebuilt from its own ring and from partition 2's (numpy
   `recover_sb_shard` with the ring_owner check, and `replay_sb_shard` on
   the card); one profiled block on the default and fused routes: device
   and host ms a step of each `dense_sharded_sb` wave. (c) One block and
   the drain on the default route with monitor and trace at rate 1.0:
   the events reconcile with the counters and the counters with the
   stats, nothing dropped. (d) `entry.dryrun_multichip(3)` on the card,
   its SmallBank fields included.
19. SmallBank on the 2-D (host, chip) mesh and the mesh serving plane
   (after phase 18). (a) The hierarchical, flat, serve (random
   occupancies), overlap and traced routes with monitor at 3x2, 512
   accounts, w=32, 2 cohorts/block, on the CPU and the card from the
   same host-made draws: tables, backups, logs, heads, the stats of
   every step, counters and event rings bit-identical. (b) SmallBank at
   24,000,000 accounts over 3 hosts x 2 chips (PLAN.json's
   multihost_3x2), w=8192 a partition, 4 cohorts/block, log 16 x 2^17 a
   partition, monitored, one warm and 8 timed blocks and the drain on
   the hierarchical and the flat exchange: committed txn/s summed, ms a
   step, the abort mix, overflow, peak memory, the ICI/DCN lane split;
   accounting closes, global conservation mod 2^32, overflow 0, no stamp
   of step - 1 after the drain, the backups at (h+1, c) and (h+2, c)
   equal the primaries, every ring's heads its own installs plus both
   hops by source tag, head < capacity, gather_rows once a partition a
   step, the two routes' stats and tables identical; partition (1, 0)
   rebuilt from its own ring and host 2's; one profiled block a route:
   device and host ms a step of each `multihost_sb` wave; then the two
   exchanges in turns (flat, hier, hier, flat), unmonitored, 1 warm + 4
   timed blocks each: ms a step. (c) `MeshServeEngine` at the same size,
   widths 256/1024/4096/8192, cpb 2, depth 2, monitor, wall clock: 2 s
   Poisson windows at 0.5 and 1.2 of (b)'s committed txn/s, overlap off
   and on: achieved rate, queue and service p50/p99, shed share,
   per-host admitted/shed, widths; the mesh ledger closes. (d) exp's mesh
   legs (`sweep_multihost_sb`, `sweep_serve_mesh` with one open rate) at
   DINT_BENCH_MESH=3x2 and full size, 2 s windows: exp.py's keys and the
   ledger.

20. dintlint on the card (after phase 19): (a) `tatp_dense/block@fused`,
   `tatp_dense/block@hot` and `smallbank_dense/block` traced with make_fx
   on CUDA tensors (dint_tpu_torch/analysis/targets.py), once at the lint
   geometry and once at full width (7,000,000 subscribers and 24,000,000
   accounts, w=8192, 3 steps): each route's `dint::` nodes present, one a
   kernel call, and equal in number to the wrappers' launch counts over
   the trace; (b) the five passes on each trace: the same (pass, code,
   site) set as the CPU trace of the same target, no unsuppressed error
   under the port's allowlist; (c) host microseconds a call of B1
   `gather_rows` and B3 `scatter_streams` through the wrapper,
   `torch.ops.dint` and the direct ctypes launch (1,000 calls back to back,
   the median of 5 groups); (d) host syncs a step on each route, from
   the purity pass.
21. dintcost and dintdur on the card (after phase 20): (a) ten targets at
   the lint geometry on CUDA == the CPU's cost models and findings; (b)
   TATP 7M and SmallBank 24M at w=8192, default and fused: the derived
   footprint against the carry's storages, a profiled block's per-wave
   bytes, device µs and GB/s; (c) the replay twins at full size == numpy
   recovery == the live tables.
22. The planner and its gates on the card (after phase 21). The
   measurements (c)-(e) run first, with nothing else on the host; then
   (a) and (b). (c) the calibration: phase 16 (f)'s runs at depth 2 (the
   serving plane's default; run here when phase 16 did not), and the
   same four runs at depth 1: both fits beside CALIB_H100.json's
   coefficients and tolerance (the files go to $DINT_SMOKE_OUT when set);
   (d) tatp_uniform and smallbank_skewed on the pinned and the predicted
   route, turns P N N P, 1 s windows at full width: committed txn/s; (e)
   one Poisson schedule through ServeEngine (tatp_dense, 7M) and
   MeshServeEngine (3x2, 24M accounts) with PLAN.json's document and with
   plan="auto", the same arrivals: admitted and shed shares, queue p99;
   "auto" reports PLAN_H100.json as its source and CALIB_H100.json's
   coefficients as its ServiceModel, the document "<document>" and
   others; (a) every feasible candidate of the planner's lattice (23
   targets) traced on CUDA at the lint geometry in this process: the
   frontier hash, each row's prices and ranks and the decision rule's
   picks == PLAN_H100.json's; (b) plan_check in full mode on those
   prices, calib_check (CALIB_H100.json against its evidence and the
   plan), and dintmon check's four ledger identities on a monitored
   full-size block of every family (dense TATP 7M and SmallBank 24M on
   every route, the store, both generic pipelines, the 1-D,
   sharded-SmallBank and 2-D meshes, the serving planes; the earlier
   phases keep theirs in P22_SNAPSHOTS): no unsuppressed finding, every
   identity ok or skipped.
23. The mesh's collectives on the card (after phase 22): (a)
   `dense_sharded/block`, `dense_sharded_sb/block`, `multihost_sb/block`
   and `@flat` traced on CUDA tensors at the lint geometry: the
   `dint_mesh` nodes by (op, axis) and the link bytes a step by axis,
   and the shard_consistency, protocol, durability and cost_budget
   findings, each == the CPU trace's; (b) `dint_mesh::ppermute`,
   `all_to_all` and `psum` on CUDA tensors at the 3 and 3x2 meshes, every
   axis, offsets 1 and 2, the tuple axis: bit for bit the CPU's results;
   and host µs a call of the TATP install record's hop (3 partitions, 2w
   = 16,384 lanes) and of the 3x2 route buckets' exchange, through the
   op and in the list form it replaced; (c) dintmut's pinned quick
   sample (MUTCOV_TORCH.json) re-run over the CUDA traces: each cell's
   verdict, killer and new errors == the pinned row's. (a) and (c) read
   the CUDA traces phase 22 (a) made where it made them; (a)'s CPU
   traces run in a child process meanwhile.
24. The mesh over the machine's cards (after phase 23): the partitions
   placed by `parallel.mesh.placement` over every visible card (one a
   partition where there are enough, a host's chips sharing one where
   not; on a one-card machine every partition on cuda:0, given
   explicitly). TATP at 7,000,000 subscribers over 3 shards (default and
   fused) and SmallBank at 24,000,000 accounts over 3x2 (hierarchical and
   flat), w=8192 a partition, 4 cohorts/block, monitored, 1 warm + 2
   timed blocks and the drain, each run twice: spread, then with every
   partition on cuda:0 from the same seeds and draws; the stats of every
   step, the counters and every partition's tables, backups, log rings
   and heads bit for bit. One line a run: the cards, committed txn/s
   summed, ms a step, peak memory by card. Then, on more than one card,
   one profiled block on each placement's tables: device and host ms a
   step of the waves (the device ms summed over the cards). A lost TATP
   shard rebuilt on its own card from its ring and another shard's,
   SmallBank's partition (1, 0) from its ring and host 2's (numpy and
   `replay_sb_shard`, the ring copied across). `entry.dryrun_multichip(3)` over the cards ==
   on cuda:0 but for its cards. Device time of one `ppermute` hop of
   TATP's install record across the cards beside the same hop on one
   card, and `can_device_access_peer` for every pair. On one card it
   prints "cards: 1; cross-card copies not exercised".
25. The mesh across processes (after phase 24): 3 ranks, one a host,
   spawned by `dint_tpu_torch.testing.procs` and joined by
   `parallel.dist.initialize` (on one card gloo, every rank on cuda:0,
   CUDA tensors staged through the host; on several cards NCCL, one rank
   a card). In one launch each rank runs TATP `multihost` at 7,000,000
   subscribers over 3 hosts (`populate_device`, seeds 0-2) and SmallBank
   `multihost_sb` at 24,000,000 accounts over 3x2, hierarchical and flat,
   w=8192 a partition, 4 cohorts/block, 3 blocks (the first warm) and the
   drain on draws made on the host from a seed; then the one-process mesh
   runs the same on cuda:0. Every rank's stats of every step and each
   partition's digests (tables, backups, stamps, log rings and heads,
   host ints) bit for bit the one-process run's; each rank launched its
   route's kernels once a partition a step. One line a rank a run: the
   backend, its cards and partitions, committed txn/s (the mesh's sum)
   and the blocks' seconds. Any rank's failure fails the phase.
26. The mesh serving plane across processes (after phase 25): 3 ranks,
   one a host, run `MeshServeEngine(group=)` over 3x2 at 24,000,000
   accounts, cpb 2, depth 2, monitor on, through `testing.procs`'
   ``serve_mesh`` job (rank 0 admits and broadcasts each block's command;
   on one card gloo, every rank on cuda:0; on several NCCL, one rank a
   card). (a) A VirtualClock, widths (1024, 8192), a constant 1,000,000/s
   for 12 ms then 4,000,000/s for 20 ms on draws made on the host from a
   seed, which moves the controller from 1024 to 8192 (a drain on every
   partition): every
   rank's report before and after close (offered, admitted, shed, per
   host, steps by width, the controller and its journal, the histograms,
   the counters summed over the ranks), its stats and every partition's
   digests (tables, backups, stamps, log rings and heads) bit for bit the
   one-process engine's on the card. (b) The wall clock, widths 256 to
   8192 (the full width), the plan's priors, warmed up: one 2 s Poisson
   window at 0.5 of phase 19 (b)'s committed txn/s (with --mesh-procs,
   phase 25's one-process hierarchical run's): the ledger closes on rank
   0's report, every rank returns it and holds its stats, every rank
   launched gather_rows; the achieved rate, queue and service p50/p99,
   the shed share and the per-host split beside the card.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import functools
import gc
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM published peak
N_SUB = 7_000_000
W = 8192
CPB = 16
VW = 10
TIMED_BLOCKS = 8
SB_N = 24_000_000
SB_W = 8192
SB_CPB = 16
ST_N = 24_000_000                # the reference store's keyspace
ST_W = 4096
ST_CPB = 2
ST_SMAX = 100                    # scan_max = YCSB-E's longest scan
ST_MAXLEN = 100                  # YCSB-E scan lengths: uniform in [1, 100]
ST_DCAP = 256
ST_LG = ST_SMAX + ST_DCAP        # rows in each lane's scan window
ST_SCAN_FRAC = 0.95
ST_TIMED = 8
ST_POINT_TIMED = 4
BENCH_WINDOW_S = 3               # phase 9's window (the bench's default: 10)
RECOVERY_SB_BLOCKS = 4           # phase 10's SmallBank blocks after the warm one
GEN_SLOTS = 1 << 26              # lock tables: 2^26 >= the reference's 36M
GEN_TRACE_TXNS = 20_000          # exp.py sweep_micro's lock trace
GEN_COHORT = 512
GEN_LOCK_W = 8192
GEN_LOG_LANES = 16
GEN_LOG_CAP = 1 << 20
GEN_LOG_VW = 10                  # 40-byte log values
GEN_LOG_W = 8192
GEN_WINDOW_S = 1.5               # each microbenchmark's window
GEN_N_SUB = 7_000_000
GEN_SB_N = 24_000_000
GEN_W = 4096                     # the generic runners' default width
GEN_CPB = 8
GEN_TATP_BLOCKS = 3              # timed blocks after the warm one
GEN_SB_BLOCKS = 3
TATP_CONTENTION_MIX = np.array([0, 0, 0, 50, 0, 50, 0], np.float64) / 100.0
CO_W = 8192                      # the coordinators' batch width
CO_TATP_COHORT = 2048            # <= 4 lanes a txn: no wave passes CO_W
CO_SB_N = 24_000_000
CO_SB_COHORT = 4096
CO_COHORTS = 8                   # at least, and at least CO_WINDOW_S
CO_WINDOW_S = 3.0
SV_CPB = 2                       # the serving plane's cohorts a block
SV_WINDOW_S = 1.5                # each family's schedule
SV_STORE_KW = dict(use_scan=True, scan_frac=ST_SCAN_FRAC,
                   max_scan_len=ST_MAXLEN, scan_max=ST_SMAX, delta_cap=512)
# closed-loop offered rates (lanes/s) phases 7 and 9 measured; phase 13
# offers half of each
CLOSED_LOOP_RATE = {}

# kernels launched once a step on each route at the main paths' shapes
# (SmallBank at 24M accounts: the lock table is hashed, so the hot route
# mirrors balances only: x + s in one gather_rows launch, bal through the
# mirror)
TATP_PER_STEP = {
    "default": {"gather_rows": 1, "lock_arbitrate": 1},
    "hotset": {"gather_rows_hot": 1, "lock_arbitrate": 1,
               "scatter_rows_hot": 1},
    "fused": {"lock_validate": 1, "gather_rows": 1, "scatter_streams": 1},
    "fused+hotset": {"lock_validate": 1, "gather_rows_hot": 1,
                     "scatter_streams": 1}}
SB_PER_STEP = {
    "default": {"gather_rows": 1},
    "hotset": {"gather_rows": 1, "gather_rows_hot": 1, "scatter_rows_hot": 1},
    "fused": {"gather_streams": 1, "scatter_streams": 1},
    "fused+hotset": {"gather_streams": 1, "scatter_streams": 1}}


class SmokeFailure(RuntimeError):
    pass


def check(cond, what, quiet=False):
    """Fail the run unless ``cond``; print the check unless ``quiet`` (a
    check repeated in a loop prints its first pass)."""
    if not cond:
        raise SmokeFailure(what)
    if not quiet:
        print(f"  ok: {what}")


def device_ms(fn, n=20, groups=5):
    """Back-to-back device ms of ``fn`` (`dint_tpu_torch.timing.device_ms`:
    the median over ``groups`` of ``n`` calls queued behind a sleep kernel,
    by CUDA events)."""
    from dint_tpu_torch.timing import device_ms as timed
    return timed(fn, n, groups)


def device_events(fn):
    """What one call of ``fn`` puts on the card, by torch.profiler
    (`dint_tpu_torch.timing.device_events`)."""
    from dint_tpu_torch.timing import device_events as events
    return events(fn)


def check_one_launch(label, fn):
    """One call of ``fn`` puts one kernel on the stream and nothing else:
    counted in a CUDA graph capture of the call
    (`dint_tpu_torch.timing.captured_nodes`), and under torch.profiler,
    which must agree whenever its trace holds any device event (on the
    H100 machine a profile sometimes holds none, PERF.md §7). Returns the
    profiler's record with the capture's counts under "captured"."""
    from dint_tpu_torch.timing import captured_nodes
    cap = captured_nodes(fn)
    ev = device_events(fn)
    seen = ev["kernels"] + ev["memsets"] + ev["copies"]
    check(cap == {"kernels": 1, "memsets": 0, "copies": 0, "other": 0}
          and (seen == 0 or (ev["kernels"] == 1 and seen == 1)),
          f"one {label} call is one kernel launch and nothing else on the "
          f"stream (graph capture: {cap}; torch.profiler: {ev['names']}, "
          f"{ev['kernel_us']:.3f} us"
          + ("; the profile held no device event" if seen == 0 else "")
          + ")")
    return dict(ev, captured=cap)


def bound_ms(n_bytes):
    return n_bytes / HBM_BYTES_PER_S * 1e3


def sectors(word_idx):
    """Distinct 32-byte sectors holding the given int32 word offsets."""
    return int(torch.unique(word_idx.to(torch.int64) // 8).numel())


def wrappers():
    """Every kernel wrapper of the port, each with its launch count."""
    from dint_tpu_torch.ops import row_kernels as rk
    from dint_tpu_torch.ops import scan_kernels as sk
    return rk.WRAPPERS + sk.WRAPPERS


def reset_launches():
    for fn in wrappers():
        fn.launches = 0


def launch_counts():
    return {fn.__name__: fn.launches for fn in wrappers()}


def max_abs_err(a, b):
    from dint_tpu_torch.ops.u32 import to_u64
    if a.numel() == 0:
        return 0
    return int((to_u64(a) - to_u64(b)).abs().max())


# ------------------------------------------------------------------ phases


def phase_card():
    print("== phase 1: card and kernel build")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    from dint_tpu_torch.ops import _build
    secs = _build.build_all()
    print(f"kernel build: {secs:.3f} s for {_build.sources()}")
    for name, log in sorted(_build.build_log.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  [{name}] {line.strip()}")
    return card


def phase_kernels(dev):
    print("== phase 2: kernels against their plain versions, main-path shapes")
    from dint_tpu_torch.engines import tatp_dense as td
    from dint_tpu_torch.ops import row_kernels as rk
    gen = torch.Generator(device=dev).manual_seed(2)
    n1 = td.n_rows(N_SUB) + 1
    sent = n1 - 1
    rec = {}

    def rand_rows(k):
        """Random rows with 1/8 sentinel lanes and 1/4 duplicates."""
        r = torch.randint(0, n1 - 1, (k,), generator=gen, device=dev)
        r[::8] = sent
        dup = torch.randint(0, 64, (k // 4,), generator=gen, device=dev)
        r[1::4] = r[dup]
        return r.to(torch.int32)

    # -- gather_rows: the meta gather and the magic-word gather of a step,
    # the two streams of one launch (the same draws as the single-stream
    # rows of earlier versions of this phase, so those stay comparable)
    tabs, idxs, single = [], [], {}
    for label, n_words, k, scale in (("meta", n1, 2 * W * 4, 1),
                                     ("magic", n1 * VW, W * 4, VW)):
        tab = torch.empty(n_words, dtype=torch.int32,
                          device=dev).random_(generator=gen)
        idx = rand_rows(k) * scale + (1 if scale > 1 else 0)
        got = rk.gather_rows(tab, idx, 1)
        want = rk.gather_rows_ref(tab, idx, 1)
        torch.cuda.synchronize()
        check(torch.equal(got, want) and max_abs_err(got, want) == 0,
              f"gather_rows[{label}] K={k} over [{n_words}] equals the plain "
              f"version")
        ms = device_ms(lambda: rk.gather_rows(tab, idx, 1))
        lib = device_ms(lambda: torch.index_select(tab, 0, idx))
        nbytes = 32 * sectors(idx) + 4 * k + 4 * k
        print(f"  gather_rows[{label}] K={k}, one stream: kernel {ms:.6f} ms, "
              f"index_select {lib:.6f} ms, bound {bound_ms(nbytes):.6f} ms "
              f"({nbytes} B)")
        single[label] = dict(ms=ms, library_ms=lib, bytes=nbytes)
        tabs.append(tab)
        idxs.append(idx)
        del got, want
    vws = (1, 1)
    got = rk.gather_rows(tabs, idxs, vws)
    want = rk.gather_rows_ref(tabs, idxs, vws)
    torch.cuda.synchronize()
    g_err = max(max_abs_err(x, y) for x, y in zip(got, want))
    check(all(torch.equal(x, y) for x, y in zip(got, want)) and g_err == 0,
          f"gather_rows, meta K={idxs[0].numel()} + magic "
          f"K={idxs[1].numel()} in one launch, equals the plain version")
    # the one launch beside the step's former two, in turns
    pair = [device_ms(lambda: rk.gather_rows(tabs, idxs, vws)),
            device_ms(lambda: (rk.gather_rows(tabs[0], idxs[0], 1),
                               rk.gather_rows(tabs[1], idxs[1], 1))),
            device_ms(lambda: (rk.gather_rows(tabs[0], idxs[0], 1),
                               rk.gather_rows(tabs[1], idxs[1], 1))),
            device_ms(lambda: rk.gather_rows(tabs, idxs, vws))]
    ms = (pair[0] + pair[3]) / 2
    plain = device_ms(lambda: rk.gather_rows_ref(tabs, idxs, vws))
    lib = device_ms(lambda: (torch.index_select(tabs[0], 0, idxs[0]),
                             torch.index_select(tabs[1], 0, idxs[1])))
    ev = check_one_launch("two-stream gather_rows",
                          lambda: rk.gather_rows(tabs, idxs, vws))
    g_bound = bound_ms(sum(v["bytes"] for v in single.values()))
    print(f"  gather_rows meta + magic, one launch: kernel {ms:.6f} ms, plain "
          f"{plain:.6f} ms, 2 index_select {lib:.6f} ms, bound "
          f"{g_bound:.6f} ms; in turns: one launch {pair[0]:.6f}, two "
          f"launches {pair[1]:.6f}, {pair[2]:.6f}, one launch {pair[3]:.6f}")
    rec["gather_rows"] = dict(
        ms=ms, plain_ms=plain, library_ms=lib, bound_ms=g_bound,
        max_abs_err=g_err, launches_per_call=ev["captured"]["kernels"],
        two_launches_ms=(pair[1] + pair[2]) / 2, in_turns_ms=pair,
        single_ms={k: v["ms"] for k, v in single.items()},
        single_library_ms={k: v["library_ms"] for k, v in single.items()})
    del tabs, idxs, got, want
    torch.cuda.empty_cache()

    # -- lock_arbitrate: the lock pass of a step (M = 2w write slots)
    m = 2 * W
    pool = torch.randint(0, n1 - 1, (m // 4,), generator=gen, device=dev)
    rows = pool[torch.randint(0, pool.numel(), (m,), generator=gen,
                              device=dev)]
    active = torch.rand(m, generator=gen, device=dev) < 0.75
    rows = torch.where(active, rows, sent).to(torch.int32)
    l_err = 0
    timing = None
    for t in (5, td.REBASE_AT - 1):       # the second puts stamps >= 2^31
        from dint_tpu_torch.ops.u32 import wrap_i32
        arb0 = torch.zeros(n1, dtype=torch.int32, device=dev)
        third = pool.numel() // 3
        arb0[pool[:third]] = wrap_i32(torch.full((third,), (t - 1) << td.K_ARB,
                                                 device=dev) + 7)
        arb0[pool[third:2 * third]] = wrap_i32(
            torch.full((third,), (t - 2) << td.K_ARB, device=dev) + 9)
        a_k, g_k = rk.lock_arbitrate(arb0.clone(), rows, active, t, td.K_ARB)
        a_r, g_r = rk.lock_arbitrate_ref(arb0.clone(), rows, active, t,
                                         td.K_ARB)
        torch.cuda.synchronize()
        err = max(max_abs_err(a_k, a_r), max_abs_err(g_k.int(), g_r.int()))
        check(torch.equal(a_k, a_r) and torch.equal(g_k, g_r) and err == 0,
              f"lock_arbitrate M={m} t={t} equals the plain version "
              f"(arb [{n1}] and grants; {int(g_k.sum())} granted)")
        l_err = max(l_err, err)
        if timing is None:
            timing = (t, arb0, a_k, g_k)
        else:
            del arb0, a_k, a_r
    t, arb0, a_k, g_k = timing
    arb = arb0.clone()

    def chain():
        # the XLA chain in three torch calls (gather, scatter_reduce amax,
        # gather-back); signed amax is right here because t << 18 < 2^31
        old = arb[rows]
        held = ((old >> td.K_ARB) & ((1 << (32 - td.K_ARB)) - 1)) == t - 1
        cand = active & ~held
        packed = (t << td.K_ARB) | (m - 1 - torch.arange(m, device=dev,
                                                         dtype=torch.int32))
        arb.scatter_reduce_(0, rows.long(), torch.where(cand, packed, 0),
                            "amax")
        return cand & (arb[rows] == packed)

    check(torch.equal(chain(), g_k) and torch.equal(arb, a_k),
          "the torch-chain yardstick computes the same function (t=5)")
    # repeated passes at the same step do the same work as the first: the
    # rows the first pass stamped are not held (their step field is t, not
    # t-1), so every candidate arbitrates again and wins or loses as before
    ms = device_ms(lambda: rk.lock_arbitrate(arb, rows, active, t, td.K_ARB))
    plain = device_ms(lambda: rk.lock_arbitrate_ref(arb, rows, active, t,
                                                    td.K_ARB))
    chain_ms = device_ms(chain)
    check(torch.equal(arb, a_k), "repeated passes leave arb unchanged")
    ev = check_one_launch("lock_arbitrate", lambda: rk.lock_arbitrate(
        arb, rows, active, t, td.K_ARB))
    cand_rows = rows[g_k]      # every row a candidate won keeps one stamp
    nbytes = (32 * sectors(rows[active]) + 32 * sectors(cand_rows)
              + m * (4 + 1 + 1))
    bnd = bound_ms(nbytes)
    print(f"  lock_arbitrate M={m}: kernel {ms:.6f} ms, plain {plain:.6f} ms, "
          f"torch chain (3 calls, yardstick) {chain_ms:.6f} ms, bound "
          f"{bnd:.6f} ms ({nbytes} B)")
    rec["lock_arbitrate"] = dict(ms=ms, plain_ms=plain, library_ms=None,
                                 chain_ms=chain_ms, bound_ms=bnd,
                                 max_abs_err=l_err,
                                 launches_per_call=ev["captured"]["kernels"])
    del arb, arb0, a_k
    torch.cuda.empty_cache()
    return rec


def phase_cpu_vs_card(dev):
    print("== phase 3: the port on the CPU against the port on the card")
    from dint_tpu_torch import convert
    from dint_tpu_torch.engines import tatp_dense as td
    from dint_tpu_torch.ops import u32
    n_sub, w, cpb, blocks = 2000, 256, 4, 3
    mix = np.array([0, 0, 0, 50, 0, 50, 0], np.float64) / 100.0
    db = td.populate(np.random.default_rng(0), n_sub, val_words=VW,
                     device="cpu", log_capacity=1 << 10)
    arrays = convert.dense_db_to_numpy(db)
    rng = np.random.default_rng(1)
    draws = [(rng.integers(0, 1 << 32, (cpb, w, 4), dtype=np.uint64)
              .astype(np.uint32),
              rng.integers(0, 1 << 16, (cpb, w, 2)).astype(np.int32))
             for _ in range(blocks + 1)]
    first = None
    for route, (hot, fused) in td.ROUTES.items():
        out = []
        for where in ("cpu", dev):
            run, init, drain = td.build_pipelined_runner(
                n_sub, w=w, val_words=VW, cohorts_per_block=cpb, mix=mix,
                use_hotset=hot, use_fused=fused, device=where)
            carry = init(convert.dense_db_from_numpy(arrays, where))
            stats = []
            for bits, payload in draws[:blocks]:
                carry, s = run.run_draws(carry, u32.from_numpy(bits, where),
                                         torch.from_numpy(payload).to(where))
                stats.append(s.cpu())
            db_end, tail = drain(carry, torch.from_numpy(draws[-1][1][:2])
                                 .to(where))
            stats.append(tail.cpu())
            out.append((convert.dense_db_to_numpy(db_end),
                        torch.cat(stats).numpy()))
        (a_db, a_st), (b_db, b_st) = out
        same = [k for k in a_db
                if np.array_equal(np.asarray(a_db[k]), np.asarray(b_db[k]))]
        check(np.array_equal(a_st, b_st) and same == list(a_db)
              and list(a_db) == list(b_db),
              f"TATP route {route}: stats and {same} bit-identical")
        tot = a_st.sum(axis=0)
        check(tot[td.STAT_AB_LOCK] > 0 and tot[td.STAT_AB_VALIDATE] > 0,
              f"TATP route {route}: contention fired (stats total "
              f"{tot.tolist()})")
        if first is None:
            first = (a_db, a_st)
        check(np.array_equal(first[1], a_st)
              and all(np.array_equal(np.asarray(first[0][k]),
                                     np.asarray(a_db[k])) for k in first[0]),
              f"TATP route {route}: identical to the default route")


def phase_main_path(dev):
    print(f"== phase 4: main path, n_sub={N_SUB:,}, w={W}, "
          f"{CPB} cohorts/block")
    from dint_tpu_torch.engines import tatp_dense as td
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    db = td.populate_device(torch.Generator(device=dev).manual_seed(0),
                            N_SUB, val_words=VW, device=dev)
    torch.cuda.synchronize()
    print(f"  populate_device: {time.perf_counter() - t0:.3f} s, "
          f"{db.meta.numel()} rows, val {db.val.numel() * 4} B")
    run, init, drain = td.build_pipelined_runner(
        N_SUB, w=W, val_words=VW, cohorts_per_block=CPB, device=dev)
    db, stats, launches = drive_tatp(dev, run, init, drain, db)
    # the meta and magic gathers are the two streams of one launch
    check_tatp(db, stats, launches, TATP_PER_STEP["default"])
    return launches, db, stats


def drive_tatp(dev, run, init, drain, db):
    """One warm block and TIMED_BLOCKS timed blocks of a TATP runner from
    generator seed 1, then the drain; prints the end-to-end numbers and
    returns (db, stats of every step [(TIMED_BLOCKS+1)*CPB + 2, N_STATS],
    kernel launches counted from 0 over the run)."""
    from dint_tpu_torch.engines import tatp_dense as td
    gen = torch.Generator(device=dev).manual_seed(1)
    reset_launches()
    carry = init(db)
    t0 = time.perf_counter()
    carry, s_warm = run(carry, gen)
    torch.cuda.synchronize()
    print(f"  warm block: {time.perf_counter() - t0:.3f} s")
    block_s, timed = [], []
    for _ in range(TIMED_BLOCKS):
        t0 = time.perf_counter()
        carry, s = run(carry, gen)
        torch.cuda.synchronize()
        block_s.append(time.perf_counter() - t0)
        timed.append(s)
    db, tail = drain(carry)
    torch.cuda.synchronize()
    launches = launch_counts()

    stats = torch.cat([s_warm] + timed + [tail]).cpu().numpy()
    timed = stats[CPB:-2].astype(np.int64)
    total = stats.astype(np.int64).sum(axis=0)
    committed_timed = int(timed[:, td.STAT_COMMITTED].sum())
    secs = float(sum(block_s))
    attempted = int(total[td.STAT_ATTEMPTED])
    print(f"  committed txn/s: {committed_timed / secs:.1f} "
          f"({committed_timed} committed in {secs:.6f} s, "
          f"{TIMED_BLOCKS} blocks x {CPB} steps x w={W})")
    print(f"  ms/step: {secs / (TIMED_BLOCKS * CPB) * 1e3:.6f}; per block "
          f"{[round(b * 1e3, 3) for b in block_s]} ms")
    print(f"  abort mix of {attempted}: ab_lock "
          f"{int(total[td.STAT_AB_LOCK])}, ab_missing "
          f"{int(total[td.STAT_AB_MISSING])}, ab_validate "
          f"{int(total[td.STAT_AB_VALIDATE])}")
    print(f"  max_memory_allocated: {torch.cuda.max_memory_allocated(dev)} B")
    print(f"  stats total (warm+timed+drain): {total.tolist()}")
    return db, stats, launches


def ab_missing_analytic():
    """The TATP mix's missing-row abort rate over populate's presence
    rules (sf/ai types present w.p. 0.625 with >= 1 each, CF on 25%)."""
    p_sf = 0.625 + 0.375 ** 4 / 4
    p_cf = p_sf * 0.25
    return (0.35 * (1 - p_sf) + 0.10 * (1 - p_cf) + 0.02 * (1 - p_sf)
            + 0.02 * (1 - p_sf * 0.75) + 0.02 * (1 - p_cf))


def check_tatp(db, stats, launches, per_step):
    """The TATP invariants after a `drive_tatp` run, and its launches:
    ``per_step`` kernel launches in each of its steps, none of others."""
    from dint_tpu_torch.engines import tatp_dense as td
    from dint_tpu_torch.tables import log as logring
    total = stats.astype(np.int64).sum(axis=0)
    steps = stats.shape[0]
    attempted = int(total[td.STAT_ATTEMPTED])
    check(attempted == (TIMED_BLOCKS + 1) * CPB * W, "every txn attempted")
    check(int(total[td.STAT_COMMITTED] + total[td.STAT_AB_LOCK]
              + total[td.STAT_AB_MISSING] + total[td.STAT_AB_VALIDATE])
          == attempted, "accounting closes, drain included")
    check(int(total[td.STAT_MAGIC_BAD]) == 0, "magic_bad == 0")
    check(not bool(db.locked.any()), "no row locked after the drain")
    r0 = logring.replica_entries(db.log, 0)
    check(all(torch.equal(r0, logring.replica_entries(db.log, r))
              for r in (1, 2)), "the three log replicas are identical")
    check(int(db.meta[-1]) == 0 and int(db.arb[-1]) == 0
          and not bool(db.val[-VW:].any()), "sentinel row untouched")
    expected = ab_missing_analytic()
    observed = int(total[td.STAT_AB_MISSING]) / attempted
    check(abs(observed - expected) < 0.01,
          f"ab_missing rate {observed:.6f} within 0.01 of analytic "
          f"{expected:.6f}")
    if db.hot_meta is not None:
        hn = db.hot_n
        check(hn == int((N_SUB + 1) * 0.04)
              and torch.equal(db.hot_meta, db.meta[:hn])
              and torch.equal(db.hot_val, db.val[:hn * VW]),
              f"mirror coherence: hot_meta, hot_val == the table prefix "
              f"({hn} rows)")
    want = dict.fromkeys(launches, 0)
    want.update({name: c * steps for name, c in per_step.items()})
    check(launches == want,
          f"launches {launches} == {per_step} per step over {steps} steps")


def rotating(fn, sets):
    """A no-argument call of ``fn`` on the next input set in turn, so that
    a timed run of calls meets fresh lanes (64 sets of 24,576 random
    sectors, 50 MB, are about the L2 size)."""
    state = {"i": 0}

    def call():
        i = state["i"]
        state["i"] = (i + 1) % len(sets)
        return fn(*sets[i])
    return call


def words_of(idx, vw):
    """Flat word offsets of rows ``idx`` of ``vw`` words."""
    idx = idx.to(torch.int64)
    return (idx[:, None] * vw + torch.arange(vw, device=idx.device)).reshape(-1)


def first_only(rows):
    """True on the first lane of each distinct value: unique writers."""
    order = torch.argsort(rows, stable=True)
    srt = rows[order]
    first = torch.ones_like(srt, dtype=torch.bool)
    first[1:] = srt[1:] != srt[:-1]
    out = torch.empty_like(first)
    out[order] = first
    return out


def phase_sb_kernels(dev):
    print("== phase 2 (SmallBank): stream and hot-tier kernels, 24M accounts")
    from dint_tpu_torch.engines import smallbank_dense as sd
    from dint_tpu_torch.ops import row_kernels as rk
    gen = torch.Generator(device=dev).manual_seed(3)
    n, m1 = SB_N, 2 * SB_N + 1
    h = sd.lock_slots_for(m1)
    hot_n = int(n * 0.04)
    k = SB_W * 3
    n_log = 16 * 65536
    ew3 = 3 * (4 + 2)
    n_sets = 64

    def rand_words(size):
        return torch.empty(size, dtype=torch.int32,
                           device=dev).random_(generator=gen)

    bal = rand_words(m1)
    x_step, s_step = rand_words(h), rand_words(h)
    ar = torch.arange(hot_n, device=dev)
    mirror = bal[torch.cat([ar, n + ar])]               # coherent mirror
    log = rand_words(n_log * ew3)

    def lane_set():
        """One step's lanes: 90% of accounts in the hot prefix, both
        tables; ~70% of lanes masked in as unique writers."""
        hot = torch.rand(k, generator=gen, device=dev) < 0.9
        acc = torch.where(hot, torch.randint(0, hot_n, (k,), generator=gen,
                                             device=dev),
                          torch.randint(0, n, (k,), generator=gen,
                                        device=dev))
        tbl = torch.randint(0, 2, (k,), generator=gen, device=dev)
        rows = (tbl * n + acc).to(torch.int32)
        midx = torch.where(acc < hot_n, tbl * hot_n + acc, -1).to(torch.int32)
        slot = sd._slot_of(rows, m1, h)
        mask = (torch.rand(k, generator=gen, device=dev) < 0.7) \
            & first_only(rows)
        lslot = torch.randperm(n_log, generator=gen, device=dev)[:k]
        vals = rand_words(k)
        return dict(rows=rows, midx=midx, slot=slot, mask=mask,
                    widx=torch.where(mask, rows, -1),
                    lflat=torch.where(mask, lslot, -1).to(torch.int32),
                    wmidx=torch.where(mask, midx, -1),
                    vals=vals, entry=rand_words(k * ew3))

    sets = [lane_set() for _ in range(n_sets)]
    a = sets[0]
    rec = {}

    lanes = torch.arange(k, device=dev)

    def mean_bound(nbytes_of):
        """The bytes bound over the rotating lane sets. A per-lane stream
        read in full counts 4 bytes a lane; one read on some lanes only
        counts the 32-byte sectors that hold those lanes."""
        return bound_ms(sum(nbytes_of(z) for z in sets) / n_sets)

    def report(name, ms, plain, yard, yard_what, bnd):
        print(f"  {name} K={k}: kernel {ms:.6f} ms, plain {plain:.6f} ms, "
              f"{yard_what} (yardstick) {yard:.6f} ms, bound {bnd:.6f} ms, "
              f"kernel/yardstick {ms / yard:.6f}")

    # -- gather_streams: the fused route's held-stamp and balance reads
    tabs3, vws3 = (x_step, s_step, bal), (1, 1, 1)
    got = rk.gather_streams(tabs3, (a["slot"], a["slot"], a["rows"]), vws3)
    want = rk.gather_streams_ref(tabs3, (a["slot"], a["slot"], a["rows"]),
                                 vws3)
    torch.cuda.synchronize()
    err = max(max_abs_err(g, w_) for g, w_ in zip(got, want))
    check(all(torch.equal(g, w_) for g, w_ in zip(got, want)) and err == 0,
          f"gather_streams x_step/s_step [{h}] + bal [{m1}], K={k} each, "
          f"equals the plain version")
    sel = [(z["slot"], z["rows"]) for z in sets]
    ms = device_ms(rotating(lambda sl, r: rk.gather_streams(
        tabs3, (sl, sl, r), vws3), sel))
    plain = device_ms(rotating(lambda sl, r: rk.gather_streams_ref(
        tabs3, (sl, sl, r), vws3), sel))
    yard = device_ms(rotating(lambda sl, r: (
        x_step.index_select(0, sl), s_step.index_select(0, sl),
        bal.index_select(0, r)), sel))
    bnd = mean_bound(lambda z: 32 * (2 * sectors(z["slot"])
                                     + sectors(z["rows"])) + 4 * k * 5)
    report("gather_streams", ms, plain, yard, "3 index_select", bnd)
    rec["gather_streams"] = dict(ms=ms, plain_ms=plain, library_ms=None,
                                 yard_ms=yard, bound_ms=bnd, max_abs_err=err)

    # -- gather_rows, three streams: the default route's held-stamp and
    # balance reads in one launch, on the same inputs as gather_streams
    idx3 = (a["slot"], a["slot"], a["rows"])
    got = rk.gather_rows(tabs3, idx3, vws3)
    want = rk.gather_rows_ref(tabs3, idx3, vws3)
    torch.cuda.synchronize()
    err = max(max_abs_err(g, w_) for g, w_ in zip(got, want))
    check(all(torch.equal(g, w_) for g, w_ in zip(got, want)) and err == 0
          and all(torch.equal(g, w_) for g, w_ in zip(
              got, rk.gather_streams(tabs3, idx3, vws3))),
          f"gather_rows x_step/s_step [{h}] + bal [{m1}], K={k} each, in one "
          f"launch, equals the plain version and gather_streams")
    ev = check_one_launch("three-stream gather_rows",
                          lambda: rk.gather_rows(tabs3, idx3, vws3))
    turns = [device_ms(rotating(lambda sl, r: rk.gather_rows(
                 tabs3, (sl, sl, r), vws3), sel)),
             device_ms(rotating(lambda sl, r: (
                 rk.gather_rows(x_step, sl, 1), rk.gather_rows(s_step, sl, 1),
                 rk.gather_rows(bal, r, 1)), sel)),
             device_ms(rotating(lambda sl, r: rk.gather_streams(
                 tabs3, (sl, sl, r), vws3), sel)),
             device_ms(rotating(lambda sl, r: rk.gather_streams(
                 tabs3, (sl, sl, r), vws3), sel)),
             device_ms(rotating(lambda sl, r: (
                 rk.gather_rows(x_step, sl, 1), rk.gather_rows(s_step, sl, 1),
                 rk.gather_rows(bal, r, 1)), sel)),
             device_ms(rotating(lambda sl, r: rk.gather_rows(
                 tabs3, (sl, sl, r), vws3), sel))]
    ms3 = (turns[0] + turns[5]) / 2
    # B5 again on the same inputs, now met once: the gather pass reads
    # slower on lanes it meets first (PERF.md §6), so both times are kept
    rec["gather_streams"]["in_turns_mean_ms"] = (turns[2] + turns[3]) / 2
    plain = device_ms(rotating(lambda sl, r: rk.gather_rows_ref(
        tabs3, (sl, sl, r), vws3), sel))
    report("gather_rows 3 streams", ms3, plain, yard, "3 index_select", bnd)
    print(f"  the default route's three reads, in turns: one gather_rows "
          f"{turns[0]:.6f} ms, three gather_rows {turns[1]:.6f}, "
          f"gather_streams {turns[2]:.6f}, gather_streams {turns[3]:.6f}, "
          f"three gather_rows {turns[4]:.6f}, one gather_rows "
          f"{turns[5]:.6f}")
    rec["gather_rows_smallbank"] = dict(
        ms=ms3, plain_ms=plain, yard_ms=yard, bound_ms=bnd, max_abs_err=err,
        launches_per_call=ev["captured"]["kernels"],
        three_launches_ms=(turns[1] + turns[4]) / 2,
        gather_streams_ms=(turns[2] + turns[3]) / 2, in_turns_ms=turns)

    # -- scatter_streams: the fused install_log (bal, log x3, mirror)
    def streams(z):
        return ((z["widx"], z["lflat"], z["wmidx"]),
                (z["vals"], z["entry"], z["vals"]))
    vws_s = (1, ew3, 1)
    tk = (bal.clone(), log.clone(), mirror.clone())
    tr = (bal.clone(), log.clone(), mirror.clone())
    rk.scatter_streams(tk, *streams(a), vws_s)
    rk.scatter_streams_ref(tr, *streams(a), vws_s)
    torch.cuda.synchronize()
    err = max(max_abs_err(x, y) for x, y in zip(tk, tr))
    check(all(torch.equal(x, y) for x, y in zip(tk, tr)) and err == 0,
          f"scatter_streams into bal [{m1}], log [{n_log} x {ew3}] and mirror "
          f"[{2 * hot_n}], K={k} each, {int(a['mask'].sum())} masked in, "
          f"equals the plain version")
    ms = device_ms(rotating(lambda i, v: rk.scatter_streams(
        tk, i, v, vws_s), [streams(z) for z in sets]))
    plain = device_ms(rotating(lambda i, v: rk.scatter_streams_ref(
        tr, i, v, vws_s), [streams(z) for z in sets]))
    log2d = tr[1].view(-1, ew3)

    def kept(z):
        m, hm = z["mask"], z["mask"] & (z["midx"] >= 0)
        return (z["rows"][m].long(), z["vals"][m], z["lflat"][m].long(),
                z["entry"].view(-1, ew3)[m], z["midx"][hm].long(),
                z["vals"][hm])
    yard = device_ms(rotating(lambda r, v, li, e, mi, mv: (
        tr[0].index_copy_(0, r, v), log2d.index_copy_(0, li, e),
        tr[2].index_copy_(0, mi, mv)), [kept(z) for z in sets]))

    def scat_bytes(z):
        m = z["mask"]
        hm = m & (z["midx"] >= 0)
        # three index streams read in full; the balance and mirror streams
        # share one value array, read on the masked-in lanes
        return (32 * (sectors(z["rows"][m]) + sectors(words_of(
            z["lflat"][m], ew3)) + sectors(z["midx"][hm])
            + sectors(lanes[m]) + sectors(words_of(lanes[m], ew3)))
            + 4 * 3 * k)
    bnd = mean_bound(scat_bytes)
    report("scatter_streams", ms, plain, yard, "3 index_copy_ of kept rows",
           bnd)
    rec["scatter_streams"] = dict(ms=ms, plain_ms=plain, library_ms=None,
                                  yard_ms=yard, bound_ms=bnd,
                                  max_abs_err=err)
    del tk, tr, log2d

    # -- gather_rows_hot: the hot route's balance read
    got = rk.gather_rows_hot(bal, mirror, a["rows"], a["midx"], 1)
    want = rk.gather_rows_hot_ref(bal, mirror, a["rows"], a["midx"], 1)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    check(torch.equal(got, want) and err == 0,
          f"gather_rows_hot over bal [{m1}] + mirror [{2 * hot_n}], K={k}, "
          f"{int((a['midx'] >= 0).sum())} lanes hot, equals the plain version")
    check(torch.equal(got, rk.gather_rows(bal, a["rows"], 1)),
          "gather_rows_hot equals gather_rows over the coherent mirror")
    sel = [(z["rows"], z["midx"]) for z in sets]

    def xla_chain(r, mi):
        hot = mi >= 0
        return torch.where(hot, mirror.index_select(0, mi.clamp(min=0)),
                           bal.index_select(0, r))
    # the hot tier against the plain gather on the same lanes, in turns
    cmp = [device_ms(rotating(lambda r, mi: rk.gather_rows(bal, r, 1), sel)),
           device_ms(rotating(lambda r, mi: rk.gather_rows_hot(
               bal, mirror, r, mi, 1), sel)),
           device_ms(rotating(lambda r, mi: rk.gather_rows_hot(
               bal, mirror, r, mi, 1), sel)),
           device_ms(rotating(lambda r, mi: rk.gather_rows(bal, r, 1), sel))]
    ms = (cmp[1] + cmp[2]) / 2
    plain = device_ms(rotating(lambda r, mi: rk.gather_rows_hot_ref(
        bal, mirror, r, mi, 1), sel))
    yard = device_ms(rotating(xla_chain, sel))

    def hot_bytes(z):
        # a hot lane's idx is never read: only the cold lanes' sectors count
        hot = z["midx"] >= 0
        return (32 * (sectors(z["rows"][~hot]) + sectors(z["midx"][hot])
                      + sectors(lanes[~hot])) + 4 * 2 * k)
    bnd = mean_bound(hot_bytes)
    report("gather_rows_hot", ms, plain, yard, "where/index_select chain", bnd)
    print(f"  bal read on the same lanes, in turns: gather_rows "
          f"{cmp[0]:.6f} ms, gather_rows_hot {cmp[1]:.6f} ms, "
          f"gather_rows_hot {cmp[2]:.6f} ms, gather_rows {cmp[3]:.6f} ms")
    rec["gather_rows_hot"] = dict(ms=ms, plain_ms=plain, library_ms=None,
                                  yard_ms=yard, bound_ms=bnd,
                                  max_abs_err=err, gather_rows_ms=cmp)

    # -- scatter_rows_hot: the hot route's write-through install
    def hot_in(z):
        return (z["rows"], z["midx"], z["mask"], z["vals"])
    bk, mk = bal.clone(), mirror.clone()
    br, mr = bal.clone(), mirror.clone()
    rk.scatter_rows_hot(bk, mk, *hot_in(a), 1)
    rk.scatter_rows_hot_ref(br, mr, *hot_in(a), 1)
    torch.cuda.synchronize()
    err = max(max_abs_err(bk, br), max_abs_err(mk, mr))
    check(torch.equal(bk, br) and torch.equal(mk, mr) and err == 0,
          f"scatter_rows_hot into bal [{m1}] + mirror [{2 * hot_n}], K={k}, "
          f"equals the plain version")
    ms = device_ms(rotating(lambda *z: rk.scatter_rows_hot(bk, mk, *z, 1),
                            [hot_in(z) for z in sets]))
    plain = device_ms(rotating(lambda *z: rk.scatter_rows_hot_ref(
        br, mr, *z, 1), [hot_in(z) for z in sets]))
    yard = device_ms(rotating(lambda r, v, li, e, mi, mv: (
        br.index_copy_(0, r, v), mr.index_copy_(0, mi, mv)),
        [kept(z) for z in sets]))

    def hot_scat_bytes(z):
        m = z["mask"]
        hm = m & (z["midx"] >= 0)
        # idx, midx and vals are read on masked-in lanes only
        return (32 * (sectors(z["rows"][m]) + sectors(z["midx"][hm])
                      + 3 * sectors(lanes[m])) + k)
    bnd = mean_bound(hot_scat_bytes)
    report("scatter_rows_hot", ms, plain, yard, "2 index_copy_ of kept rows",
           bnd)
    rec["scatter_rows_hot"] = dict(ms=ms, plain_ms=plain, library_ms=None,
                                   yard_ms=yard, bound_ms=bnd,
                                   max_abs_err=err)
    del bal, x_step, s_step, mirror, log, sets, bk, mk, br, mr
    torch.cuda.empty_cache()
    return rec


def timed_row(label, kernel, plain, yard, yard_what, sets, nbytes_of,
              yard_sets=None):
    """Kernel, plain version and yardstick timed over the rotating input
    ``sets`` (each call takes the next set; the yardstick's own
    ``yard_sets`` where given), and the bytes bound averaged over them;
    printed and returned as a record."""
    ms = device_ms(rotating(kernel, sets))
    plain_ms = device_ms(rotating(plain, sets))
    yard_ms = device_ms(rotating(yard, yard_sets or sets))
    bnd = bound_ms(sum(nbytes_of(*z) for z in sets) / len(sets))
    print(f"  {label}: kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, "
          f"{yard_what} (yardstick) {yard_ms:.6f} ms, bound {bnd:.6f} ms, "
          f"kernel/yardstick {ms / yard_ms:.6f}")
    return dict(ms=ms, plain_ms=plain_ms, yard_ms=yard_ms, bound_ms=bnd)


def per_step(parts):
    """The records of a kernel's calls in one step, as one: times and
    bounds add up, the error is the largest."""
    rows = list(parts.values())
    out = {k: sum(r[k] for r in rows) for k in rows[0] if k != "max_abs_err"}
    out["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    return out


def phase_tatp_kernels(dev):
    print("== phase 2 (TATP routes): lock_validate, and the stream and "
          "hot-tier kernels at TATP's shapes, 7M subscribers")
    from dint_tpu_torch.engines import tatp_dense as td
    from dint_tpu_torch.ops import row_kernels as rk
    from dint_tpu_torch.ops.u32 import shr, wrap_i32
    gen = torch.Generator(device=dev).manual_seed(4)
    n1 = td.n_rows(N_SUB) + 1
    sent = n1 - 1
    hot_n = int((N_SUB + 1) * 0.04)          # the hot route's 280,000 rows
    m, v = 2 * W, W * 4                       # lock lanes; validate = read
    n_log, ew3 = 16 * 65536, 3 * (4 + VW)
    n_sets = 32
    lanes = torch.arange(2 * v, device=dev)

    def rand_words(size):
        return torch.empty(size, dtype=torch.int32,
                           device=dev).random_(generator=gen)

    def rand_rows(k, hot_share=16):
        """Rows over the table, 1/8 on the sentinel, 1/4 duplicates, and
        1/hot_share in the hot prefix."""
        r = torch.randint(0, n1 - 1, (k,), generator=gen, device=dev)
        r[::hot_share] = torch.randint(0, hot_n, (len(r[::hot_share]),),
                                       generator=gen, device=dev)
        r[::8] = sent
        dup = torch.randint(0, 64, (k // 4,), generator=gen, device=dev)
        r[1::4] = r[dup]
        return r.to(torch.int32)

    meta = rand_words(n1)
    rec = {}

    # -- lock_validate: the fused route's lock + validate pass
    pool = torch.randint(0, n1 - 1, (m // 4,), generator=gen, device=dev)
    third = pool.numel() // 3

    def stamped(t):
        """arb with a third of the pool held (t-1) and a third expiring."""
        arb = torch.zeros(n1, dtype=torch.int32, device=dev)
        for part, age, low in ((pool[:third], 1, 7),
                               (pool[third:2 * third], 2, 9)):
            arb[part] = wrap_i32(torch.full((third,), (t - age) << td.K_ARB,
                                            device=dev) + low)
        return arb

    def lv_set():
        rows = pool[torch.randint(0, pool.numel(), (m,), generator=gen,
                                  device=dev)]
        active = torch.rand(m, generator=gen, device=dev) < 0.75
        rows = torch.where(active, rows, sent).to(torch.int32)
        vidx, ridx = rand_rows(v), rand_rows(v)
        vv1 = torch.where(torch.rand(v, generator=gen, device=dev) < 0.5,
                          meta[vidx], meta[vidx] ^ 2)
        return vidx, vv1, ridx, rows, active

    sets = [lv_set() for _ in range(n_sets)]
    err = 0
    for tt in (5, td.REBASE_AT - 1):      # the second puts stamps >= 2^31
        got = rk.lock_validate(stamped(tt), meta, *sets[0], tt, td.K_ARB)
        want = rk.lock_validate_ref(stamped(tt), meta, *sets[0], tt,
                                    td.K_ARB)
        torch.cuda.synchronize()
        e = max(max_abs_err(x.int(), y.int()) for x, y in zip(got, want))
        check(all(torch.equal(x, y) for x, y in zip(got, want)) and e == 0,
              f"lock_validate V=R={v} M={m} t={tt} over meta/arb [{n1}] "
              f"equals the plain version (arb, grant, vbad, rmeta; "
              f"{int(got[1].sum())} granted, {int(got[2].sum())} stale)")
        err = max(err, e)
    t = 5
    arb0 = stamped(t)
    arb_k, arb_p, arb_u, arb_c = (arb0.clone() for _ in range(4))
    lane_m = torch.arange(m, device=dev, dtype=torch.int32)
    packed = (t << td.K_ARB) | (m - 1 - lane_m)

    def unfused(vi, vv, ri, ro, ac):
        g = rk.gather_rows(meta, torch.cat([vi, ri]), 1)
        return g[:v] != vv, rk.lock_arbitrate(arb_u, ro, ac, t, td.K_ARB)

    def torch_chain(vi, vv, ri, ro, ac):
        # index_select + compare, and the lock pass as three torch calls
        # (signed amax is right here because t << 18 < 2^31)
        bad = meta.index_select(0, vi) != vv
        rmeta = meta.index_select(0, ri)
        old = arb_c[ro]
        cand = ac & ((shr(old, td.K_ARB)) != t - 1)
        arb_c.scatter_reduce_(0, ro.long(), torch.where(cand, packed, 0),
                              "amax")
        return bad, rmeta, cand & (arb_c[ro] == packed)

    a_f, g_f, vb_f, rm_f = rk.lock_validate(arb0.clone(), meta, *sets[0], t,
                                            td.K_ARB)
    bad_c, rm_c, g_c = torch_chain(*sets[0])
    bad_u, (a_u, g_u) = unfused(*sets[0])
    check(torch.equal(bad_c, vb_f) and torch.equal(rm_c, rm_f)
          and torch.equal(g_c, g_f) and torch.equal(arb_c, a_f)
          and torch.equal(bad_u, vb_f) and torch.equal(g_u, g_f)
          and torch.equal(a_u, a_f),
          "both yardsticks compute the same function (t=5)")
    del a_f, a_u

    def lv_bytes(vi, vv, ri, ro, ac):
        held = shr(arb0[ro.long()], td.K_ARB) == t - 1
        return (32 * (sectors(torch.cat([vi, ri])) + sectors(ro[ac])
                      + sectors(ro[ac & ~held]))
                + 4 * v * 2 + 4 * v + 4 * m + m + v + 4 * v + m)
    r_lv = timed_row(
        f"lock_validate V=R={v} M={m}",
        lambda *z: rk.lock_validate(arb_k, meta, *z, t, td.K_ARB),
        lambda *z: rk.lock_validate_ref(arb_p, meta, *z, t, td.K_ARB),
        torch_chain, "index_select + compare + 3-call lock chain", sets,
        lv_bytes)
    r_lv["unfused_ms"] = device_ms(rotating(unfused, sets))
    print(f"  lock_validate: the default route's unfused pair (gather_rows "
          f"+ compare + lock_arbitrate, yardstick) {r_lv['unfused_ms']:.6f} "
          f"ms")
    rec["lock_validate"] = dict(r_lv, library_ms=None, max_abs_err=err)
    del arb_k, arb_p, arb_u, arb_c, arb0, sets

    # -- the hot route's gathers at TATP's shapes: the meta gather (2wK
    # rows of meta) and the magic gather (wK words of val), each through
    # its mirror of the hot row prefix
    val = rand_words(n1 * VW)
    hot_meta, hot_val = meta[:hot_n].clone(), val[:hot_n * VW].clone()
    b6, b6_sets = {}, {}
    for label, tab, mirror, k, scale in (
            ("meta", meta, hot_meta, 2 * v, 1),
            ("magic", val, hot_val, v, VW)):
        def g_set():
            rows = rand_rows(k)
            idx = rows * scale + (1 if scale > 1 else 0)
            return idx, torch.where(rows < hot_n, idx, -1)
        sets = b6_sets[label] = [g_set() for _ in range(n_sets)]
        got = rk.gather_rows_hot(tab, mirror, *sets[0], 1)
        want = rk.gather_rows_hot_ref(tab, mirror, *sets[0], 1)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        check(torch.equal(got, want) and e == 0
              and torch.equal(got, rk.gather_rows(tab, sets[0][0], 1)),
              f"gather_rows_hot[{label}] K={k} over [{tab.numel()}] + mirror "
              f"[{mirror.numel()}], {int((sets[0][1] >= 0).sum())} lanes hot, "
              f"equals the plain version and gather_rows")

        def hot_bytes(idx, midx):
            hot = midx >= 0
            return (32 * (sectors(idx[~hot]) + sectors(midx[hot])
                          + sectors(lanes[:k][~hot])) + 4 * 2 * k)
        b6[label] = timed_row(
            f"gather_rows_hot[{label}] K={k}",
            lambda i, mi: rk.gather_rows_hot(tab, mirror, i, mi, 1),
            lambda i, mi: rk.gather_rows_hot_ref(tab, mirror, i, mi, 1),
            lambda i, mi: torch.where(mi >= 0, mirror.index_select(
                0, mi.clamp(min=0)), tab.index_select(0, i)),
            "where/index_select chain", sets, hot_bytes)
        b6[label]["max_abs_err"] = e
        # the plain gather on the same lanes, for the hot tier's cost
        b6[label]["gather_rows_ms"] = device_ms(rotating(
            lambda i, mi: rk.gather_rows(tab, i, 1), sets))
        print(f"  gather_rows[{label}] on the same lanes: "
              f"{b6[label]['gather_rows_ms']:.6f} ms")
    rec["gather_rows_hot"] = per_step(b6)

    # ... and the hot step's two gathers as the two streams of one launch,
    # beside the two single-stream launches, in turns
    tabs, mirrors = (meta, val), (hot_meta, hot_val)
    sets = [(mi, mg) for mi, mg in zip(b6_sets["meta"], b6_sets["magic"])]

    def two(m_, g_):
        return rk.gather_rows_hot(tabs, mirrors, (m_[0], g_[0]),
                                  (m_[1], g_[1]), (1, 1))

    def singles(m_, g_):
        return (rk.gather_rows_hot(meta, hot_meta, *m_, 1),
                rk.gather_rows_hot(val, hot_val, *g_, 1))

    def chain(m_, g_):
        return tuple(torch.where(mi >= 0, mr.index_select(0, mi.clamp(
            min=0)), t.index_select(0, i)) for t, mr, (i, mi) in zip(
                tabs, mirrors, (m_, g_)))
    got, want = two(*sets[0]), rk.gather_rows_hot_ref(
        tabs, mirrors, (sets[0][0][0], sets[0][1][0]),
        (sets[0][0][1], sets[0][1][1]), (1, 1))
    torch.cuda.synchronize()
    e = max(max_abs_err(x, y) for x, y in zip(got, want))
    check(all(torch.equal(x, y) for x, y in zip(got, want)) and e == 0
          and all(torch.equal(x, y) for x, y in zip(got, singles(*sets[0]))),
          f"gather_rows_hot meta K={2 * v} + magic K={v} in one launch "
          f"equals the plain version and the single-stream calls")
    ev = check_one_launch("two-stream gather_rows_hot",
                          lambda: two(*sets[0]))
    turns = [device_ms(rotating(two, sets)),
             device_ms(rotating(singles, sets)),
             device_ms(rotating(singles, sets)),
             device_ms(rotating(two, sets))]
    r2 = dict(ms=(turns[0] + turns[3]) / 2,
              plain_ms=device_ms(rotating(lambda m_, g_: (
                  rk.gather_rows_hot_ref(meta, hot_meta, *m_, 1),
                  rk.gather_rows_hot_ref(val, hot_val, *g_, 1)), sets)),
              yard_ms=device_ms(rotating(chain, sets)),
              bound_ms=rec["gather_rows_hot"]["bound_ms"], max_abs_err=e,
              launches_per_call=ev["captured"]["kernels"],
              two_launches_ms=(turns[1] + turns[2]) / 2, in_turns_ms=turns)
    print(f"  gather_rows_hot meta + magic, one launch: kernel "
          f"{r2['ms']:.6f} ms, plain {r2['plain_ms']:.6f} ms, "
          f"where/index_select chains {r2['yard_ms']:.6f} ms, bound "
          f"{r2['bound_ms']:.6f} ms; in turns: one launch {turns[0]:.6f}, "
          f"two launches {turns[1]:.6f}, {turns[2]:.6f}, one launch "
          f"{turns[3]:.6f}")
    rec["gather_rows_hot"]["one_launch"] = r2
    del b6_sets

    # -- the commit wave's installs at TATP's shapes (2w write slots):
    # scatter_rows_hot (hot route: meta, then val) and scatter_streams
    # (fused route: val, meta and log x3, plus the two mirrors with the
    # hot tier); ~60% of lanes masked in as unique writers
    k = m
    log = rand_words(n_log * ew3)

    def w_set():
        rows = rand_rows(k, hot_share=8)
        mask = (torch.rand(k, generator=gen, device=dev) < 0.6) \
            & first_only(rows) & (rows != sent)
        lslot = torch.randperm(n_log, generator=gen, device=dev)[:k]
        return dict(rows=rows, mask=mask, midx=torch.where(
            rows < hot_n, rows, -1), widx=torch.where(mask, rows, -1),
            wmidx=torch.where(mask & (rows < hot_n), rows, -1),
            lflat=torch.where(mask, lslot, -1).to(torch.int32),
            nval=rand_words(k * VW), nmeta=rand_words(k),
            entry=rand_words(k * ew3))
    zs = [w_set() for _ in range(n_sets)]
    b7 = {}
    for label, tab, mirror, vw, vkey in (("meta", meta, hot_meta, 1, "nmeta"),
                                         ("val", val, hot_val, VW, "nval")):
        sets = [(z["rows"], z["midx"], z["mask"], z[vkey]) for z in zs]
        tk, mk = tab.clone(), mirror.clone()
        rk.scatter_rows_hot(tk, mk, *sets[0], vw)
        rk.scatter_rows_hot_ref(tab, mirror, *sets[0], vw)
        torch.cuda.synchronize()
        e = max(max_abs_err(tk, tab), max_abs_err(mk, mirror))
        check(torch.equal(tk, tab) and torch.equal(mk, mirror) and e == 0,
              f"scatter_rows_hot[{label}] K={k} into [{tab.numel()}] + mirror "
              f"[{mirror.numel()}], {int(sets[0][2].sum())} masked in, equals "
              f"the plain version")
        del tk

        def hot_scat_bytes(rows, midx, mask, vals, vw=vw):
            hm = mask & (midx >= 0)
            return (32 * (sectors(words_of(rows[mask], vw))
                          + sectors(words_of(midx[hm], vw))
                          + 2 * sectors(lanes[:k][mask])
                          + sectors(words_of(lanes[:k][mask], vw))) + k)

        def kept(rows, midx, mask, vals, vw=vw):
            """The kept rows and values, filtered outside the timing as in
            the SmallBank rows."""
            hm = mask & (midx >= 0)
            v2 = vals.view(-1, vw)
            return rows[mask].long(), v2[mask], midx[hm].long(), v2[hm]

        def kept_copy(r, v, mi, mv, tab=tab, mirror=mirror, vw=vw):
            tab.view(-1, vw).index_copy_(0, r, v)
            mirror.view(-1, vw).index_copy_(0, mi, mv)
        b7[label] = timed_row(
            f"scatter_rows_hot[{label}] K={k}",
            lambda *z, vw=vw: rk.scatter_rows_hot(tab, mirror, *z, vw),
            lambda *z, vw=vw: rk.scatter_rows_hot_ref(tab, mirror, *z, vw),
            kept_copy, "2 index_copy_ of kept rows", sets, hot_scat_bytes,
            [kept(*z) for z in sets])
        b7[label]["max_abs_err"] = e
    rec["scatter_rows_hot"] = per_step(b7)

    # ... and the hot step's two installs as the two streams of one launch
    # on the same lanes, beside the two single-stream launches, in turns
    tabs2, mirrors2, vws2 = (meta, val), (hot_meta, hot_val), (1, VW)
    sets = [(z["rows"], z["midx"], z["mask"], z["nmeta"], z["nval"])
            for z in zs]

    def two(r, mi, ma, vm, vv, tabs=tabs2, mirrors=mirrors2):
        return rk.scatter_rows_hot(tabs, mirrors, (r, r), (mi, mi),
                                   (ma, ma), (vm, vv), vws2)

    def singles(r, mi, ma, vm, vv, tabs=tabs2, mirrors=mirrors2):
        rk.scatter_rows_hot(tabs[0], mirrors[0], r, mi, ma, vm, 1)
        rk.scatter_rows_hot(tabs[1], mirrors[1], r, mi, ma, vv, VW)
    copies = [tuple(x.clone() for x in tabs2 + mirrors2) for _ in range(3)]
    two(*sets[0], tabs=copies[0][:2], mirrors=copies[0][2:])
    singles(*sets[0], tabs=copies[1][:2], mirrors=copies[1][2:])
    r0, mi0, ma0, vm0, vv0 = sets[0]
    rk.scatter_rows_hot_ref(copies[2][:2], copies[2][2:], (r0, r0),
                            (mi0, mi0), (ma0, ma0), (vm0, vv0), vws2)
    torch.cuda.synchronize()
    e = max(max_abs_err(x, y) for x, y in zip(copies[0], copies[2]))
    check(all(torch.equal(x, y) and torch.equal(x, z) for x, y, z in zip(
        *copies)) and e == 0,
          f"scatter_rows_hot meta + val K={k} in one launch equals the "
          f"plain version and the single-stream calls")
    del copies
    ev = check_one_launch("two-stream scatter_rows_hot",
                          lambda: two(*sets[0]))
    turns = [device_ms(rotating(two, sets)),
             device_ms(rotating(singles, sets)),
             device_ms(rotating(singles, sets)),
             device_ms(rotating(two, sets))]

    def kept4(r, mi, ma, vm, vv):
        hm = ma & (mi >= 0)
        v2 = vv.view(-1, VW)
        return (r[ma].long(), vm[ma], mi[hm].long(), vm[hm], v2[ma], v2[hm])

    def four_copies(r, vm, mi, mh, v, vh):
        meta.index_copy_(0, r, vm)
        hot_meta.index_copy_(0, mi, mh)
        val.view(-1, VW).index_copy_(0, r, v)
        hot_val.view(-1, VW).index_copy_(0, mi, vh)

    def two_bytes(r, mi, ma, vm, vv):
        # the two streams share their lanes: idx, midx and mask count once
        hm = ma & (mi >= 0)
        live = lanes[:k][ma]
        return (32 * (sectors(r[ma]) + sectors(words_of(r[ma], VW))
                      + sectors(mi[hm]) + sectors(words_of(mi[hm], VW))
                      + 3 * sectors(live) + sectors(words_of(live, VW)))
                + k)
    r2 = dict(ms=(turns[0] + turns[3]) / 2,
              plain_ms=device_ms(rotating(lambda r, mi, ma, vm, vv: (
                  rk.scatter_rows_hot_ref(tabs2, mirrors2, (r, r), (mi, mi),
                                          (ma, ma), (vm, vv), vws2)), sets)),
              yard_ms=device_ms(rotating(four_copies,
                                         [kept4(*z) for z in sets])),
              bound_ms=bound_ms(sum(two_bytes(*z) for z in sets)
                                / len(sets)),
              max_abs_err=e, launches_per_call=ev["captured"]["kernels"],
              two_launches_ms=(turns[1] + turns[2]) / 2, in_turns_ms=turns)
    print(f"  scatter_rows_hot meta + val, one launch: kernel "
          f"{r2['ms']:.6f} ms, plain {r2['plain_ms']:.6f} ms, 4 index_copy_ "
          f"of kept rows (yardstick) {r2['yard_ms']:.6f} ms, bound "
          f"{r2['bound_ms']:.6f} ms; in turns: one launch {turns[0]:.6f}, "
          f"two launches {turns[1]:.6f}, {turns[2]:.6f}, one launch "
          f"{turns[3]:.6f}")
    rec["scatter_rows_hot"]["one_launch"] = r2

    b3 = {}
    for n_streams in (3, 5):
        tabs = (val, meta, log, hot_val, hot_meta)[:n_streams]
        vws = (VW, 1, ew3, VW, 1)[:n_streams]

        def streams(z, n=n_streams):
            return ((z["widx"], z["widx"], z["lflat"], z["wmidx"],
                     z["wmidx"])[:n],
                    (z["nval"], z["nmeta"], z["entry"], z["nval"],
                     z["nmeta"])[:n])
        sets = [streams(z) for z in zs]
        tk = tuple(x.clone() for x in tabs)
        rk.scatter_streams(tk, *sets[0], vws)
        rk.scatter_streams_ref(tabs, *sets[0], vws)
        torch.cuda.synchronize()
        e = max(max_abs_err(x, y) for x, y in zip(tk, tabs))
        check(all(torch.equal(x, y) for x, y in zip(tk, tabs)) and e == 0,
              f"scatter_streams install_log, {n_streams} streams (vw "
              f"{list(vws)}), K={k}, equals the plain version")
        del tk

        def scat_bytes(idxs, vals, n=n_streams):
            widx, lflat = idxs[0], idxs[2]
            mask = widx >= 0
            nb = (32 * (sectors(words_of(widx[mask], VW))
                        + sectors(widx[mask])
                        + sectors(words_of(lflat[mask], ew3))
                        + sectors(words_of(lanes[:k][mask], VW))
                        + sectors(lanes[:k][mask])
                        + sectors(words_of(lanes[:k][mask], ew3)))
                  + 4 * 2 * k)
            if n == 5:
                hm = idxs[3] >= 0
                nb += 32 * (sectors(words_of(idxs[3][hm], VW))
                            + sectors(idxs[3][hm])) + 4 * k
            return nb

        def kept(idxs, vals):
            """Per stream the kept rows and values, filtered outside the
            timing as in the SmallBank rows."""
            return [(idx[idx >= 0].long(), val_.view(-1, vw)[idx >= 0])
                    for idx, val_, vw in zip(idxs, vals, vws)]

        def kept_copies(*per_stream):
            for tab, (r, v_), vw in zip(tabs, per_stream, vws):
                tab.view(-1, vw).index_copy_(0, r, v_)
        b3[n_streams] = timed_row(
            f"scatter_streams install_log {n_streams} streams K={k}",
            lambda i, x: rk.scatter_streams(tabs, i, x, vws),
            lambda i, x: rk.scatter_streams_ref(tabs, i, x, vws),
            kept_copies, f"{n_streams} index_copy_ of kept rows", sets,
            scat_bytes, [kept(*z) for z in sets])
        b3[n_streams]["max_abs_err"] = e
    rec["scatter_streams"] = b3
    del meta, val, log, hot_meta, hot_val, zs, sets
    torch.cuda.empty_cache()
    return rec


def phase_sb_cpu_vs_card(dev):
    print("== phase 3 (SmallBank): the port on the CPU against the card")
    from dint_tpu_torch import convert
    from dint_tpu_torch.engines import smallbank_dense as sd
    from dint_tpu_torch.ops import u32
    n, w, cpb, blocks = 300, 256, 4, 3
    rng = np.random.default_rng(2)
    draws = [(rng.integers(0, 1 << 32, (cpb, w, 5), dtype=np.uint64)
              .astype(np.uint32),
              rng.integers(-20, 21, (cpb, w)).astype(np.int32))
             for _ in range(blocks)]
    for route, (hot, fused) in sd.ROUTES.items():
        out = []
        for where in ("cpu", dev):
            run, init, drain = sd.build_pipelined_runner(
                n, w=w, cohorts_per_block=cpb, use_hotset=hot,
                use_fused=fused, device=where)
            carry = init(sd.create(n, log_capacity=1 << 10, device=where))
            stats = []
            for bits, amt in draws:
                carry, st = run.run_draws(carry, u32.from_numpy(bits, where),
                                          torch.from_numpy(amt).to(where))
                stats.append(st.cpu())
            db, tail = drain(carry)
            stats.append(tail.cpu())
            out.append((convert.dense_bank_to_numpy(db),
                        torch.cat(stats).numpy()))
        (a_db, a_st), (b_db, b_st) = out
        same = [k for k in a_db
                if np.array_equal(np.asarray(a_db[k]), np.asarray(b_db[k]))]
        check(np.array_equal(a_st, b_st) and same == list(a_db)
              and list(a_db) == list(b_db),
              f"route {route}: stats and {same} bit-identical")
        tot = a_st.astype(np.int64).sum(axis=0)
        check(tot[sd.STAT_AB_LOCK] > 0 and tot[sd.STAT_COMMITTED] > 0,
              f"route {route}: contention fired (stats total {tot.tolist()})")


def phase_smallbank(dev):
    print(f"== phase 5: SmallBank main path, {SB_N:,} accounts, w={SB_W}, "
          f"{SB_CPB} cohorts/block, 90/4 skew, four routes")
    from dint_tpu_torch.engines import smallbank_dense as sd
    from dint_tpu_torch.tables import log as logring
    steps = (TIMED_BLOCKS + 1) * SB_CPB + 1
    ends, launches_all = {}, {}
    for route, counts in SB_PER_STEP.items():
        hot, fused = sd.ROUTES[route]
        print(f"  -- route {route}")
        torch.cuda.reset_peak_memory_stats(dev)
        db = sd.create(SB_N, device=dev)
        base = int(sd.total_balance(db))
        check(db.lock_slots == 1 << 25 and db.lock_slots < 2 * SB_N + 1,
              "the hashed lock regime (2^25 slots for 48,000,001 rows)")
        run, init, drain = sd.build_pipelined_runner(
            SB_N, w=SB_W, cohorts_per_block=SB_CPB, use_hotset=hot,
            use_fused=fused, device=dev)
        gen = torch.Generator(device=dev).manual_seed(5)

        reset_launches()
        carry = init(db)
        t0 = time.perf_counter()
        carry, s_warm = run(carry, gen)
        torch.cuda.synchronize()
        print(f"  warm block: {time.perf_counter() - t0:.3f} s")
        block_s, timed = [], []
        for _ in range(TIMED_BLOCKS):
            t0 = time.perf_counter()
            carry, st = run(carry, gen)
            torch.cuda.synchronize()
            block_s.append(time.perf_counter() - t0)
            timed.append(st)
        db, tail = drain(carry)
        torch.cuda.synchronize()
        launches = launch_counts()

        timed = torch.cat(timed).cpu().numpy().astype(np.int64)
        stats = np.concatenate([s_warm.cpu().numpy(), timed,
                                tail.cpu().numpy()]).astype(np.int64)
        total = stats.sum(axis=0)
        committed_timed = int(timed[:, sd.STAT_COMMITTED].sum())
        secs = float(sum(block_s))
        attempted = int(total[sd.STAT_ATTEMPTED])
        aborts = int(total[sd.STAT_AB_LOCK] + total[sd.STAT_AB_LOGIC])
        print(f"  committed txn/s: {committed_timed / secs:.1f} "
              f"({committed_timed} committed in {secs:.6f} s, "
              f"{TIMED_BLOCKS} blocks x {SB_CPB} steps x w={SB_W})")
        print(f"  ms/step: {secs / (TIMED_BLOCKS * SB_CPB) * 1e3:.6f}; per "
              f"block {[round(b * 1e3, 3) for b in block_s]} ms")
        print(f"  abort rate: {aborts / attempted:.6f} (ab_lock "
              f"{int(total[sd.STAT_AB_LOCK])}, ab_logic "
              f"{int(total[sd.STAT_AB_LOGIC])} of {attempted})")
        print(f"  max_memory_allocated: "
              f"{torch.cuda.max_memory_allocated(dev)} B")
        print(f"  stats total (warm+timed+drain): {total.tolist()}")

        check(attempted == (TIMED_BLOCKS + 1) * SB_CPB * SB_W,
              "every txn attempted")
        check(int(total[sd.STAT_COMMITTED]) + aborts == attempted,
              "accounting closes: committed + ab_lock + ab_logic == "
              "attempted, drain included")
        delta = (int(sd.total_balance(db)) - base) % (1 << 32)
        check(delta == int(total[sd.STAT_BAL_DELTA]) % (1 << 32),
              f"balance conservation mod 2^32 (delta {delta})")
        check(int(total[sd.STAT_MAGIC_BAD]) == 0, "magic_bad == 0")
        r0 = logring.replica_entries(db.log, 0)
        check(all(torch.equal(r0, logring.replica_entries(db.log, r))
                  for r in (1, 2)), "the three log replicas are identical")
        check(int(db.bal[-1]) == 0, "sentinel bal[-1] == 0")
        if hot:
            ar = torch.arange(db.hot_n, device=dev)
            idx = torch.cat([ar, SB_N + ar])
            check(db.hot_n == 960_000 and db.hot_x is None
                  and torch.equal(db.bal[idx], db.hot_bal),
                  "mirror coherence: hot_bal == bal[hot rows] (960,000 "
                  "accounts; no stamp mirror in the hashed regime)")
        want = dict.fromkeys(launches, 0)
        want.update({name: c * steps for name, c in counts.items()})
        check(launches == want,
              f"launches {launches} == {counts} per step over {steps} steps")
        launches_all[route] = launches
        ends[route] = (db, stats)

    (d0, s0), *rest = ends.values()
    for route, (db, st) in zip(list(ends)[1:], rest):
        check(np.array_equal(s0, st) and torch.equal(d0.bal, db.bal)
              and torch.equal(d0.x_step, db.x_step)
              and torch.equal(d0.s_step, db.s_step) and d0.step == db.step
              and torch.equal(d0.log.entries, db.log.entries)
              and torch.equal(d0.log.head, db.log.head),
              f"route {route}: stats, bal, x_step, s_step, step and log "
              f"identical to the default route's")
    del ends
    torch.cuda.empty_cache()
    return launches_all


def phase_tatp_routes(dev, ref):
    print(f"== phase 6: TATP routes, n_sub={N_SUB:,}, w={W}, {CPB} "
          f"cohorts/block, against phase 4's default route")
    from dint_tpu_torch.engines import tatp_dense as td
    ref_db, ref_stats = ref
    launches_all = {}
    for route in ("hotset", "fused", "fused+hotset"):
        counts = TATP_PER_STEP[route]
        hot, fused = td.ROUTES[route]
        print(f"  -- route {route}")
        torch.cuda.reset_peak_memory_stats(dev)
        db = td.populate_device(torch.Generator(device=dev).manual_seed(0),
                                N_SUB, val_words=VW, device=dev)
        run, init, drain = td.build_pipelined_runner(
            N_SUB, w=W, val_words=VW, cohorts_per_block=CPB,
            use_hotset=hot, use_fused=fused, device=dev)
        db, stats, launches = drive_tatp(dev, run, init, drain, db)
        check_tatp(db, stats, launches, counts)
        check(np.array_equal(stats, ref_stats) and db.step == ref_db.step
              and torch.equal(db.val, ref_db.val)
              and torch.equal(db.meta, ref_db.meta)
              and torch.equal(db.arb, ref_db.arb)
              and torch.equal(db.log.entries, ref_db.log.entries)
              and torch.equal(db.log.head, ref_db.log.head),
              f"route {route}: stats, val, meta, arb, step and log identical "
              f"to the default route's")
        launches_all[route] = launches
        if fused and not hot:
            launches_all["fused serve+monitor"] = serve_block(dev, db)
        del db
        torch.cuda.empty_cache()
    return launches_all


def serve_block(dev, db):
    """One serve block with monitor=True on the fused route from ``db``:
    occupancy W - (W/CPB)*i at step i (8192 - 512*i), a shed tally, then
    the drain; the counters must reconcile with the stats."""
    from dint_tpu_torch.engines import tatp_dense as td
    from dint_tpu_torch.monitor import counters as mon
    print("  -- route fused, serve=True, monitor=True: one block")
    run, init, drain = td.build_pipelined_runner(
        N_SUB, w=W, val_words=VW, cohorts_per_block=CPB, use_fused=True,
        monitor=True, serve=True, device=dev)
    occ_h = np.array([W - (W // CPB) * i for i in range(CPB)], np.int32)
    shed_h = np.arange(CPB, dtype=np.int32) % 3
    occ, shed = (torch.from_numpy(a).to(dev) for a in (occ_h, shed_h))
    gen = torch.Generator(device=dev).manual_seed(2)
    reset_launches()
    carry = init(db)
    t0 = time.perf_counter()
    carry, s_blk = run(carry, gen, occ, shed)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    db, tail, cnt = drain(carry)
    torch.cuda.synchronize()
    launches = launch_counts()
    stats = torch.cat([s_blk, tail]).cpu().numpy().astype(np.int64)
    total = stats.sum(axis=0)
    snap = mon.snapshot(cnt)
    print(f"  serve block: {secs / CPB * 1e3:.6f} ms/step (first block of "
          f"the runner, counters on); occupancy {occ_h.tolist()}")
    print(f"  counters: {snap}")
    check(int(total[td.STAT_ATTEMPTED]) == int(occ_h.sum())
          and stats[0, td.STAT_ATTEMPTED] == 0,
          f"attempted sums to sum(occ) = {int(occ_h.sum())}")
    pairs = (("txn_attempted", td.STAT_ATTEMPTED),
             ("txn_committed", td.STAT_COMMITTED),
             ("ab_lock", td.STAT_AB_LOCK), ("ab_missing", td.STAT_AB_MISSING),
             ("ab_validate", td.STAT_AB_VALIDATE),
             ("magic_bad", td.STAT_MAGIC_BAD))
    check(all(snap[k] == int(total[c]) for k, c in pairs),
          "counters reconcile with the stats (txn_attempted, "
          "txn_committed, ab_lock, ab_missing, ab_validate, magic_bad)")
    check(snap["serve_padded_lanes"] == CPB * W - int(occ_h.sum())
          and snap["serve_occupancy_lanes"] == int(occ_h.sum())
          and snap["serve_shed_lanes"] == int(shed_h.sum()),
          "serve_padded_lanes == cpb*w - sum(occ); occupancy and shed lanes "
          "as given")
    check(snap["steps"] == CPB + 2 and snap["fused_dispatch"] == CPB + 2
          and snap["dispatch_pallas"] == CPB + 2
          and snap["lock_requests"] == snap["lock_granted"]
          + snap["lock_rejected"]
          and snap["lock_rejected"] == snap["lock_reject_held"]
          + snap["lock_reject_arb"]
          and snap["install_writes"] == snap["log_appends"],
          "steps and the lock ledger close")
    check(not bool(db.locked.any()) and snap["magic_bad"] == 0,
          "no row locked after the drain; magic_bad == 0")
    return launches


# ------------------------------------------------------------------- store


def _store_batch(r, n, n_keys, dev, ops=None, lens=None):
    """A host-made store batch of n lanes over keys [1, n_keys + 400]
    (some absent), VW words of random values."""
    from dint_tpu_torch.engines.types import Op, make_batch
    if ops is None:
        ops = r.choice([Op.GET, Op.SET, Op.INSERT, Op.DELETE, Op.NOP], n,
                       p=[0.35, 0.3, 0.1, 0.15, 0.1]).astype(np.int32)
    keys = r.integers(1, n_keys + 400, n).astype(np.uint64)
    keys[:6] = 5                          # one key's GET/SET/INSERT/DELETE
    ops[:6] = [Op.GET, Op.SET, Op.INSERT, Op.DELETE, Op.GET, Op.SET]
    keys[6:60] = r.integers(1, 80, 54)    # the hot prefix
    vals = r.integers(0, 1 << 32, (n, VW), dtype=np.uint64).astype(np.uint32)
    return make_batch(ops, keys, vals, vers=lens, width=n, val_words=VW,
                      device=dev)


def store_point_steps(dev, hot):
    """Explicit store steps on the card or the CPU: a 2,000-key table with
    maintain_bloom=True (and the hot mirror of keys [0, 80) when ``hot``),
    then a 2-bucket, 1-slot table where an insert takes its alternate
    bucket and a third spills. Returns every output as numpy arrays."""
    from dint_tpu_torch import convert
    from dint_tpu_torch.clients import micro
    from dint_tpu_torch.engines import store
    from dint_tpu_torch.engines.types import Op, make_batch
    from dint_tpu_torch.ops import hashing
    from dint_tpu_torch.ops.u32 import to_numpy
    from dint_tpu_torch.tables import kv
    r = np.random.default_rng(12)
    table = micro.make_store_table(2000, val_words=VW, device=dev)
    mirror = store.attach_hot(table, 80) if hot else None
    out = []
    for _ in range(3):
        res = store.step(table, _store_batch(r, 256, 2000, dev),
                         maintain_bloom=True, hot=mirror)
        table, rep = res[:2]
        mirror = res[2] if hot else None
        out += [to_numpy(x) for x in (rep.rtype, rep.val, rep.ver)]
    out += [np.asarray(v) for v in convert.kv_table_to_numpy(table).values()]
    if hot:
        out += [to_numpy(mirror.val), to_numpy(mirror.ver)]
        return out
    ks = np.arange(1, 4000, dtype=np.uint64)
    b1, b2 = hashing.bucket_pair_np(ks, 2)
    cands = ks[(b1 == 0) & (b2 == 1)][:3]
    tiny = kv.create(2, slots=1, val_words=VW, device=dev)
    for keys in (cands[:2], cands[2:]):
        tiny, rep = store.step(tiny, make_batch(
            [Op.INSERT] * len(keys), keys, width=len(keys), val_words=VW,
            device=dev))
        out.append(to_numpy(rep.rtype))
    return out


def store_scan_steps(dev):
    """Explicit scan-route steps: a 2,000-key table, an 8-entry overlay
    that the first batch overflows (the second batch's scans answer
    RETRY), the block-end refresh, then scans that answer VAL."""
    from dint_tpu_torch import convert
    from dint_tpu_torch.clients import micro
    from dint_tpu_torch.engines import store
    from dint_tpu_torch.engines.types import Op
    from dint_tpu_torch.ops.u32 import to_numpy
    from dint_tpu_torch.tables import run as run_mod
    r = np.random.default_rng(13)
    table = micro.make_store_table(2000, val_words=VW, device=dev)
    run = run_mod.from_table(table, delta_cap=8)
    out = []
    for i in range(3):
        ops = r.choice([Op.SCAN, Op.GET, Op.SET, Op.DELETE], 128,
                       p=[0.7, 0.1, 0.15, 0.05]).astype(np.int32)
        lens = np.where(ops == Op.SCAN, r.integers(0, 24, 128), 0)
        table, rep, run, srep = store.step(
            table, _store_batch(r, 128, 2000, dev, ops, lens), run=run,
            scan_max=16)
        out += [to_numpy(x) for x in (rep.rtype, rep.val, rep.ver,
                                      srep.key_hi, srep.key_lo, srep.ver,
                                      srep.val, srep.count,
                                      srep.delta_hits)]
        if i == 1:
            run = store.rebuild_run(table, run)
    out += [np.asarray(v) for v in convert.kv_table_to_numpy(table).values()]
    out += [np.asarray(v) for v in convert.ordered_run_to_numpy(run).values()]
    return out


def store_runner_blocks(dev, use_scan, draws):
    """The store runner at n_keys=2000, w=256, 2 cohorts a block,
    scan_max=16, delta_cap=32, monitor=True on host-made draws: final
    table (and run), stats and counters as numpy arrays."""
    from dint_tpu_torch import convert
    from dint_tpu_torch.clients import micro
    from dint_tpu_torch.engines import store
    run, init, drain = store.build_serve_runner(
        2000, w=256, cohorts_per_block=2, val_words=VW, read_frac=0.5,
        scan_frac=ST_SCAN_FRAC, max_scan_len=20, scan_max=16, delta_cap=32,
        use_scan=use_scan, monitor=True, device=dev)
    carry = init(micro.make_store_table(2000, val_words=VW, device=dev))
    stats = []
    for d in draws:
        carry, s = run.run_draws(carry, [torch.from_numpy(a).to(dev)
                                         for a in d])
        stats.append(s.cpu().numpy())
    out = []
    if use_scan:
        out += [np.asarray(v) for v in
                convert.ordered_run_to_numpy(carry[1]).values()]
    table, tail, cnt = drain(carry)
    out += [np.asarray(v) for v in convert.kv_table_to_numpy(table).values()]
    return out + [np.concatenate(stats + [tail.cpu().numpy()]),
                  convert.counters_to_numpy(cnt)]


def phase_store_cpu_vs_card(dev):
    print("== phase 3 (store): the port on the CPU against the card")
    from dint_tpu_torch.engines.types import Reply
    t_phase = time.perf_counter()

    def same(what, fn, *args):
        a, b = fn("cpu", *args), fn(dev, *args)
        check(len(a) == len(b) and all(np.array_equal(x, y)
                                       for x, y in zip(a, b)),
              f"store {what}: {len(a)} outputs bit-identical")
        return a

    same("point steps (maintain_bloom, spill to the alternate bucket)",
         store_point_steps, False)
    reset_launches()
    same("hot route (maintain_bloom, mirror of keys [0, 80))",
         store_point_steps, True)
    hot_launches = launch_counts()       # the card's run only counts
    want = dict.fromkeys(hot_launches, 0)
    want.update(gather_rows_hot=3, scatter_rows_hot=3)
    check(hot_launches == want,
          f"the hot route's 3 steps launched gather_rows_hot and "
          f"scatter_rows_hot once a step each (val and ver, two streams): "
          f"{hot_launches}")
    out = same("scan route (stale overlay, refresh)", store_scan_steps)
    stale_rt, fresh_rt = out[9], out[18]       # rtype of steps 2 and 3
    check((stale_rt == Reply.RETRY).any() and (fresh_rt == Reply.VAL).any()
          and not (fresh_rt == Reply.RETRY).any(),
          "the stale overlay's scans answered RETRY, and VAL after the "
          "refresh")
    r = np.random.default_rng(14)
    draws = [tuple([r.random((2, 256), dtype=np.float32) for _ in range(3)]
                   + [r.integers(1, 81, (2, 256)).astype(np.int32),
                      r.integers(1, 2001, (2, 256)).astype(np.int32),
                      r.integers(1, 21, (2, 256)).astype(np.int32)])
             for _ in range(3)]
    for use_scan in (False, True):
        res = same(f"runner, use_scan={use_scan}, 3 blocks + drain",
                   store_runner_blocks, use_scan, draws)
        st = res[-2].astype(np.int64)
        check((st[:-1, 1] == st[:-1, 0]).all(),
              f"use_scan={use_scan}: every lane committed")
    print(f"  phase 3 (store) seconds: {time.perf_counter() - t_phase:.3f}")
    return hot_launches


def phase_store_kernels(dev, run):
    print(f"== phase 2 (store): scan_rows against its plain version, "
          f"K={ST_W}, lg={ST_LG}, over the {run.cap:,}-row run")
    from dint_tpu_torch.engines import store
    from dint_tpu_torch.ops import scan_kernels as sk
    from dint_tpu_torch.tables import run as run_mod
    cap = run.cap
    hot_n = int(ST_N * 0.04)
    gen = torch.Generator(device=dev).manual_seed(8)

    def off_set():
        """The runner's key draws of one cohort, located and clamped as
        the step clamps them (store.py:287)."""
        _, _, u_hot, k_hot, k_cold, _ = store.draw_block(
            gen, 1, ST_W, ST_N, hot_n, ST_MAXLEN, dev)
        klo = torch.where(u_hot[0] < 0.9, k_hot[0], k_cold[0])
        off = run_mod.locate(run, torch.zeros_like(klo), klo)
        return torch.clamp(off, 0, cap - ST_LG).to(torch.int32)

    sets = [off_set() for _ in range(8)]
    a = sets[0]
    a[0], a[1] = 0, cap - ST_LG                  # edge windows
    a[2::97] = a[3]                              # duplicate offsets
    args = (run.key_hi, run.key_lo, run.ver, run.val)
    got = sk.scan_rows(*args, a, ST_LG, VW)
    want = sk.scan_rows_ref(*args, a, ST_LG, VW)
    torch.cuda.synchronize()
    err = max(max_abs_err(g, w_) for g, w_ in zip(got, want))
    check(all(torch.equal(g, w_) for g, w_ in zip(got, want)) and err == 0,
          f"scan_rows K={ST_W} lg={ST_LG} vw={VW} over [{cap}] equals the "
          f"plain version (edge windows at 0 and {cap - ST_LG}, duplicates)")
    unf = [x.unfold(0, ST_LG, 1) for x in args[:3]]
    unf_val = run.val.view(cap, VW).unfold(0, ST_LG, 1)   # [*, VW, lg]

    def yard(off):
        return tuple(u.index_select(0, off) for u in unf) + (
            unf_val.index_select(0, off).permute(0, 2, 1).contiguous(),)
    check(all(torch.equal(y.reshape(-1), g) for y, g in zip(yard(a), got)),
          "the index_select yardstick computes the same function")
    del got, want
    lg_r = torch.arange(ST_LG, device=dev)
    lgv_r = torch.arange(ST_LG * VW, device=dev)

    def scan_bytes(off):
        # each array's window rows read once (the union over lanes: hot
        # windows overlap), the four slabs written, the offsets read
        rows = (off.long()[:, None] + lg_r).reshape(-1)
        words = (off.long()[:, None] * VW + lgv_r).reshape(-1)
        return (32 * (3 * sectors(rows) + sectors(words))
                + 4 * ST_W * ST_LG * (3 + VW) + 4 * ST_W)
    rec = timed_row(
        f"scan_rows K={ST_W} lg={ST_LG}",
        lambda o: sk.scan_rows(*args, o, ST_LG, VW),
        lambda o: sk.scan_rows_ref(*args, o, ST_LG, VW),
        yard, "4 index_select over unfold views + permute copy",
        [(o,) for o in sets], scan_bytes)
    no_overlap = bound_ms(2 * 4 * ST_W * ST_LG * (3 + VW) + 4 * ST_W)
    print(f"  scan_rows: bound without window overlap {no_overlap:.6f} ms")
    rec.update(library_ms=None, max_abs_err=err)
    del unf, unf_val, sets
    torch.cuda.empty_cache()
    return rec


def store_draw_lanes(gen, dev, n_blocks):
    """The scan lanes and their expected row counts of ``n_blocks`` of the
    runner's draws (a twin of the runner's generator): every key 1..N
    exists and none is deleted, so a scan from ``start`` returns
    min(slen, scan_max, N - start + 1) rows."""
    from dint_tpu_torch.engines import store
    hot_n = int(ST_N * 0.04)
    lanes = rows = 0
    for _ in range(n_blocks):
        u_scan, _, u_hot, k_hot, k_cold, slen = store.draw_block(
            gen, ST_CPB, ST_W, ST_N, hot_n, ST_MAXLEN, dev)
        is_scan = u_scan < ST_SCAN_FRAC
        start = torch.where(u_hot < 0.9, k_hot, k_cold).long()
        cnt = torch.minimum(slen.clamp(max=ST_SMAX).long(), ST_N - start + 1)
        lanes += int(is_scan.sum())
        rows += int(cnt[is_scan].sum())
    return lanes, rows


def store_explicit_step(dev, table, run, gen):
    """One explicit store.step after the timed blocks, on a host-made
    YCSB-E batch from the runner's draws: every GET, SET and scan lane is
    checked, scans against the pre-step versions."""
    import dataclasses
    from dint_tpu_torch.engines import store
    from dint_tpu_torch.engines.types import Op, Reply, make_batch
    from dint_tpu_torch.ops import hashing
    from dint_tpu_torch.tables import kv
    hot_n = int(ST_N * 0.04)
    u_scan, u_get, u_hot, k_hot, k_cold, slen = (
        x[0].cpu().numpy() for x in store.draw_block(
            gen, 1, ST_W, ST_N, hot_n, ST_MAXLEN, dev))
    is_scan = u_scan < np.float32(ST_SCAN_FRAC)
    is_get = ~is_scan & (u_get < np.float32(0.5))
    keys = np.where(u_hot < np.float32(0.9), k_hot, k_cold).astype(np.uint64)
    ops = np.where(is_scan, Op.SCAN, np.where(is_get, Op.GET, Op.SET))
    vals = np.zeros((ST_W, VW), np.uint32)
    vals[:, 0], vals[:, 1] = keys, store.STORE_MAGIC
    batch = make_batch(ops, keys, vals, vers=np.where(is_scan, slen, 0),
                       val_words=VW, device=dev)
    ver_before = table.ver.clone()
    t0 = time.perf_counter()
    table, rep, run, srep = store.step(table, batch, run=run,
                                       scan_max=ST_SMAX)
    torch.cuda.synchronize()
    print(f"  explicit step: {(time.perf_counter() - t0) * 1e3:.3f} ms, "
          f"{int(is_scan.sum())} scans, {int(is_get.sum())} GETs, "
          f"{int((~is_scan & ~is_get).sum())} SETs")
    rtype, rver = rep.rtype.cpu().numpy(), rep.ver.cpu().numpy()
    rval = rep.val.cpu().numpy()
    check((rtype[is_get] == Reply.VAL).all()
          and (rval[is_get, 0] == keys[is_get].astype(np.int64)).all()
          and (rval[is_get, 1] == store.STORE_MAGIC).all(),
          "every GET answered VAL with val word 0 == key and word 1 == the "
          "magic")
    check((rtype[~is_scan & ~is_get] == Reply.ACK).all(),
          "every SET answered ACK")
    count = srep.count.cpu().numpy()
    want = np.minimum(np.minimum(slen, ST_SMAX),
                      ST_N - keys.astype(np.int64) + 1)
    check((rtype[is_scan] == Reply.VAL).all()
          and (count[is_scan] == want[is_scan]).all()
          and (rver[is_scan] == count[is_scan]).all()
          and (count[~is_scan] == 0).all(),
          "every scan answered VAL with count == min(slen, 100, keys >= "
          "start)")
    j = np.arange(ST_SMAX)
    keep = j[None, :] < count[:, None]
    k_lo = srep.key_lo.cpu().numpy().astype(np.int64)
    k_hi = srep.key_hi.cpu().numpy()
    val = srep.val.cpu().numpy()
    start = keys.astype(np.int64)[:, None]
    check(((k_lo == start + j[None, :]) | ~keep).all() and (k_hi == 0).all()
          and ((k_lo == 0) | keep).all(),
          "scan rows are the consecutive keys start, start+1, ...; rows "
          "past count are zero")
    check(((val[:, :, 0] == k_lo) & (val[:, :, 1] == store.STORE_MAGIC)
           & (val[:, :, 2:] == 0).all(-1) | ~keep).all(),
          "every scanned row's val is (key, magic, 0, ...)")
    pre = dataclasses.replace(table, ver=ver_before)
    kk = torch.from_numpy(k_lo[keep].astype(np.int32)).to(dev)
    zero = torch.zeros_like(kk)
    b1, b2 = hashing.bucket_pair(zero, kk, table.n_buckets)
    hit, _, _, _, ver0, _, _ = kv.probe(pre, zero, kk, b1, b2)
    sver = torch.from_numpy(srep.ver.cpu().numpy()[keep]).to(dev)
    check(bool(hit.all()) and torch.equal(ver0, sver),
          f"each of the {int(keep.sum())} scanned rows carries its key's "
          f"pre-step version (scans see pre-batch state)")
    del ver_before, pre
    return table, run


def phase_store(dev):
    print(f"== phase 7: the store main path, YCSB-E over {ST_N:,} keys, "
          f"w={ST_W}, {ST_CPB} cohorts/block, scan_max={ST_SMAX}, "
          f"delta_cap={ST_DCAP}")
    from dint_tpu_torch import convert
    from dint_tpu_torch.clients import micro
    from dint_tpu_torch.engines import store
    from dint_tpu_torch.monitor import counters as mon
    from dint_tpu_torch.tables import run as run_mod
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    table = micro.make_store_table(ST_N, val_words=VW, device=dev)
    torch.cuda.synchronize()
    populate_s = time.perf_counter() - t0
    ne = table.key_hi.numel()
    print(f"  populate_s: {populate_s:.3f} ({table.n_buckets} buckets x "
          f"{table.slots} slots = {ne} entries, load {ST_N / ne:.4f})")
    nb = 1 << int(np.ceil(np.log2(ST_N / 2)))
    check(table.n_buckets == nb and int(table.valid.sum()) == ST_N,
          f"the table holds all {ST_N:,} keys in {nb} buckets")
    kw = dict(w=ST_W, cohorts_per_block=ST_CPB, val_words=VW, read_frac=0.5,
              scan_frac=ST_SCAN_FRAC, max_scan_len=ST_MAXLEN,
              scan_max=ST_SMAX, delta_cap=ST_DCAP, device=dev)
    run, init, drain = store.build_serve_runner(ST_N, use_scan=True,
                                                monitor=True, **kw)
    t0 = time.perf_counter()
    carry = init(table)
    torch.cuda.synchronize()
    print(f"  init (from_table, cap {carry[1].cap}): "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms")
    rec = phase_store_kernels(dev, carry[1])

    print("  -- the scan runner (use_scan=True, monitor=True)")
    gen = torch.Generator(device=dev).manual_seed(7)
    twin = torch.Generator(device=dev).manual_seed(7)
    reset_launches()
    t0 = time.perf_counter()
    carry, s_warm = run(carry, gen)
    torch.cuda.synchronize()
    print(f"  warm block: {time.perf_counter() - t0:.3f} s")
    block_s, timed = [], []
    for _ in range(ST_TIMED):
        t0 = time.perf_counter()
        carry, st = run(carry, gen)
        torch.cuda.synchronize()
        block_s.append(time.perf_counter() - t0)
        timed.append(st)
    scan_launches = launch_counts()
    snap = mon.snapshot(carry[-1])
    stats = torch.cat([s_warm] + timed).cpu().numpy().astype(np.int64)
    steps = (1 + ST_TIMED) * ST_CPB
    secs = float(sum(block_s))
    committed = int(stats[ST_CPB:, 1].sum())
    print(f"  ms/step: {secs / (ST_TIMED * ST_CPB) * 1e3:.6f}; per block "
          f"{[round(b * 1e3, 3) for b in block_s]} ms (block-end rebuild "
          f"included)")
    print(f"  committed ops/s: {committed / secs:.1f} ({committed} in "
          f"{secs:.6f} s, {ST_TIMED} blocks x {ST_CPB} steps x w={ST_W})")
    CLOSED_LOOP_RATE["store"] = committed / secs
    print(f"  scan_rows launches per step: "
          f"{scan_launches['scan_rows'] / steps:.3f}")
    print(f"  max_memory_allocated: {torch.cuda.max_memory_allocated(dev)} B")
    print(f"  counters: {snap}")
    check((stats[:, 0] == ST_W).all() and (stats[:, 1] == stats[:, 0]).all(),
          "committed == attempted in every step (every GET, SET and scan "
          "answered VAL or ACK; no overlay overflowed)")
    lanes, rows = store_draw_lanes(twin, dev, 1 + ST_TIMED)
    check(snap["steps"] == steps and snap["scan_requests"] == lanes
          and snap["scan_rows"] == rows
          and 0 < snap["scan_delta_hits"] <= snap["scan_rows"]
          and snap["dispatch_pallas"] == steps,
          f"counters reconcile: scan_requests == {lanes} scan lanes, "
          f"scan_rows == {rows} (sum of counts), 0 < scan_delta_hits <= "
          f"scan_rows")
    want = dict.fromkeys(scan_launches, 0)
    want["scan_rows"] = steps
    check(scan_launches == want,
          f"launches {scan_launches}: scan_rows once a step")

    table, run_ = store_explicit_step(dev, carry[0], carry[1], twin)
    check(not bool(run_.stale), "the overlay is intact after the step")
    t0 = time.perf_counter()
    fresh = store.rebuild_run(table, run_)
    torch.cuda.synchronize()
    rebuild_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    snap_run = run_mod.from_table(table, ST_DCAP)
    torch.cuda.synchronize()
    from_table_ms = (time.perf_counter() - t0) * 1e3
    check(all(torch.equal(getattr(fresh, k), getattr(snap_run, k))
              for k in convert.RUN_LEAVES),
          f"refresh of run + delta ({int(run_.d_n)} overlay entries) equals "
          f"from_table(table) leaf for leaf: run ∪ delta == table")
    t0 = time.perf_counter()
    store.rebuild_run(table, fresh)
    torch.cuda.synchronize()
    print(f"  rebuild_run: {rebuild_ms:.3f} ms with the step's overlay, "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms with an empty one; "
          f"from_table: {from_table_ms:.3f} ms")
    table, tail, _ = drain(carry)
    check(not bool(tail.any()), "the drain returns no in-flight stats")
    del carry, run_, fresh, snap_run
    torch.cuda.empty_cache()

    print("  -- the point runner (use_scan=False), on a clone of the table")
    prun, pinit, _ = store.build_serve_runner(ST_N, use_scan=False, **kw)
    pc = pinit(table.clone())
    reset_launches()
    pc, s_warm = prun(pc, gen)
    torch.cuda.synchronize()
    block_s, timed = [], []
    for _ in range(ST_POINT_TIMED):
        t0 = time.perf_counter()
        pc, st = prun(pc, gen)
        torch.cuda.synchronize()
        block_s.append(time.perf_counter() - t0)
        timed.append(st)
    point_launches = launch_counts()
    stats = torch.cat([s_warm] + timed).cpu().numpy()
    secs = float(sum(block_s))
    print(f"  ms/step: {secs / (ST_POINT_TIMED * ST_CPB) * 1e3:.6f}; "
          f"committed ops/s: {int(stats[ST_CPB:, 1].sum()) / secs:.1f}")
    check((stats[:, 1] == stats[:, 0]).all() and (stats[:, 0] == ST_W).all(),
          "point runner: committed == attempted in every step")
    check(all(v == 0 for v in point_launches.values()),
          "the point route launches no hand kernel (its probe and installs "
          "are plain torch)")
    del pc
    torch.cuda.empty_cache()

    print("  -- one serve block (serve=True, monitor=True, scan route)")
    srun, sinit, sdrain = store.build_serve_runner(
        ST_N, use_scan=True, monitor=True, serve=True, **kw)
    occ_h = np.array([ST_W - 256 * i for i in range(ST_CPB)], np.int32)
    shed_h = np.arange(ST_CPB, dtype=np.int32) % 3 + 1
    occ, shed = (torch.from_numpy(a).to(dev) for a in (occ_h, shed_h))
    gen3 = torch.Generator(device=dev).manual_seed(9)
    twin3 = torch.Generator(device=dev).manual_seed(9)
    sc = sinit(table)
    t0 = time.perf_counter()
    sc, s_blk = srun(sc, gen3, occ, shed)
    torch.cuda.synchronize()
    print(f"  serve block: {(time.perf_counter() - t0) / ST_CPB * 1e3:.6f} "
          f"ms/step; occupancy {occ_h.tolist()}")
    table, tail, cnt = sdrain(sc)
    snap = mon.snapshot(cnt)
    keep_counters("store serve@scan", snap)
    stats = torch.cat([s_blk, tail]).cpu().numpy().astype(np.int64)
    hot_n = int(ST_N * 0.04)
    u_scan = store.draw_block(twin3, ST_CPB, ST_W, ST_N, hot_n, ST_MAXLEN,
                              dev)[0]
    lane = torch.arange(ST_W, device=dev)
    lanes = int(((u_scan < ST_SCAN_FRAC) & (lane < occ[:, None])).sum())
    check((stats[:ST_CPB, 0] == occ_h).all()
          and (stats[:ST_CPB, 1] == occ_h).all() and (stats[-1] == 0).all(),
          "attempted == committed == occupancy in each step")
    check(snap["serve_occupancy_lanes"] == int(occ_h.sum())
          and snap["serve_padded_lanes"] == ST_CPB * ST_W - int(occ_h.sum())
          and snap["serve_shed_lanes"] == int(shed_h.sum())
          and snap["steps"] == ST_CPB and snap["dispatch_pallas"] == ST_CPB
          and snap["scan_requests"] == lanes,
          f"serve counters reconcile with the stats: occupancy, padded "
          f"{ST_CPB * ST_W - int(occ_h.sum())} and shed lanes, steps, "
          f"{lanes} admitted scan lanes")
    del table, sc
    torch.cuda.empty_cache()
    print(f"  phase 7 seconds: {time.perf_counter() - t_phase:.3f}")
    return rec, {"store scan": scan_launches, "store point": point_launches}


# ------------------------------------------------------- probe and cache tier


def phase_scalar_scatter(dev):
    """B9 at the probe's shape (tools/profile_pallas.py:29-32), then the
    probe's own entry point, counted from 0: its main path."""
    from dint_tpu_torch import profile_scalar_scatter as pss
    from dint_tpu_torch.ops import row_kernels as rk
    n, k = pss.N, pss.K
    print(f"== phase 2 (probe): scalar_scatter against its plain version, "
          f"[{n // pss.C} x {pss.C}] table, K={k}")
    tab, idx, val = pss.inputs(dev)
    tab.random_(generator=torch.Generator(device=dev).manual_seed(10))
    r = np.random.default_rng(10)
    dups = []
    for first in (1, 0):        # two patterns, called one after the other
        dup = idx.cpu().numpy().copy()
        dup[first::2] = dup[r.integers(0, 64, k // 2)]   # 64 indices, many
        dup[-3:] = n - 1                                 # lanes; last word
        dups.append(torch.from_numpy(dup).to(dev))
    err = 0
    for label, ix in (("unique", idx), ("duplicate", dups[0]),
                      ("other duplicate", dups[1])):
        got = rk.scalar_scatter(tab, ix, val)
        want = rk.scalar_scatter_ref(tab, ix, val)
        torch.cuda.synchronize()
        err = max(err, max_abs_err(got.view(-1), want.view(-1)))
        check(tuple(got.shape) == tuple(tab.shape) and torch.equal(got, want)
              and err == 0,
              f"scalar_scatter over [{n}] words, K={k} {label} indices "
              f"({int(torch.unique(ix).numel())} distinct) equals the plain "
              f"version (the last lane of a shared index wins)")
    check(torch.equal(pss.index_put_form(tab, idx, val),
                      rk.scalar_scatter(tab, idx, val)),
          "the index_put_ library form computes the same function on the "
          "probe's unique indices")
    ms = device_ms(lambda: rk.scalar_scatter(tab, idx, val))
    plain = device_ms(lambda: rk.scalar_scatter_ref(tab, idx, val))
    lib = device_ms(lambda: pss.index_put_form(tab, idx, val))
    ev = check_one_launch("scalar_scatter",
                          lambda: rk.scalar_scatter(tab, idx, val))
    # the table read once and the output written once, idx and val read
    nbytes = 2 * 4 * n + 2 * 4 * k
    bnd = bound_ms(nbytes)
    with_sectors = bound_ms(nbytes + 32 * k)
    print(f"  scalar_scatter K={k}: kernel {ms:.6f} ms, plain {plain:.6f} ms, "
          f"clone + index_put_ {lib:.6f} ms, bound {bnd:.6f} ms ({nbytes} B; "
          f"{with_sectors:.6f} ms counting the stores' sectors again)")
    rec = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd,
               max_abs_err=err, launches_per_call=ev["captured"]["kernels"])
    del tab, dups
    torch.cuda.empty_cache()

    print("  -- the probe's entry point: python -m "
          "dint_tpu_torch.profile_scalar_scatter")
    reset_launches()
    rc = pss.main([])
    launches = launch_counts()
    want = dict.fromkeys(launches, 0)
    want["scalar_scatter"] = 4 * pss.ITERS     # a warm chain and 3 timed
    check(rc == 0 and launches == want,
          f"the probe ran, its tables equal, launches {launches}")
    return rec, launches


CT_N = 24_000_000          # the reference store's keyspace
CT_NB = 1 << 23            # the reference's 9M-entry cache, a power of two
CT_REF_NB = 1 << 25        # the replay table's buckets (see cache_reference)
CT_W = 4096
CT_HOT = 960_000           # the hot 4% prefix [1, 960,000]
CT_ROUNDS = 16             # rounds a block
CT_TIMED = 8
CT_HOT_KEYS = CT_HOT + 1   # mirror ids key_lo < 960,001 cover keys 1..960,000


def cache_serve_rounds(dev, policy, hot_keys, rounds, n, keyspace, buckets,
                       seed, scan_max):
    """The CachedStore on ``dev`` (the cases of tests/test_store_cache.py):
    populate half the keyspace, then ``rounds`` rounds of ``n`` mixed
    lanes (scans too when ``scan_max``), then the scan barrier's flush.
    Returns every reply, the stats, the cache and the backing store as
    numpy arrays."""
    import dataclasses
    from dint_tpu_torch import convert
    from dint_tpu_torch.engines.types import Op
    from dint_tpu_torch.shim.host_kvs import CachedStore
    r = np.random.default_rng(seed)
    srv = CachedStore(buckets, val_words=4, policy=policy, width=128,
                      hot_keys=hot_keys, device=dev)
    keys0 = np.arange(1, keyspace // 2, dtype=np.uint64)
    srv.populate(keys0, r.integers(1, 99, (len(keys0), 4)).astype(np.uint32))
    choice = [Op.GET, Op.GET, Op.SET, Op.SET, Op.INSERT, Op.DELETE]
    if scan_max:
        choice += [Op.SCAN]
    out = []
    for _ in range(rounds):
        ops = r.choice(choice, n).astype(np.int32)
        lens = np.where(ops == Op.SCAN, r.integers(0, scan_max + 1, n), 0)
        res = srv.serve(ops, r.integers(1, keyspace, n).astype(np.uint64),
                        r.integers(1, 99, (n, 4)).astype(np.uint32),
                        scan_lens=lens, scan_max=scan_max)
        out += list(res[:3]) + [np.array(repr(res[3:]))]
    srv._flush_dirty()
    out.append(np.array(list(dataclasses.asdict(srv.stats).values())))
    out += [np.asarray(v) for v in
            convert.cache_table_to_numpy(srv.cache).values()]
    kvs = srv.kvs
    out += [kvs._keys, kvs._used, kvs._vals, kvs._vers, kvs._bloom_cnt,
            np.array(sorted(kvs._spill))]
    return out


def phase_cache_cpu_vs_card(dev):
    print("== phase 3 (cache tier): the port on the CPU against the card")
    from dint_tpu_torch.engines import store_cache as sc
    t_phase = time.perf_counter()
    for policy in sc.POLICIES:
        for hot_keys in (0, 40):
            for rounds, keyspace, buckets, scan_max in ((12, 60, 8, 6),
                                                        (20, 120, 4, 0)):
                args = (policy, hot_keys, rounds, 96, keyspace, buckets, 1,
                        scan_max)
                a = cache_serve_rounds("cpu", *args)
                b = cache_serve_rounds(dev, *args)
                check(len(a) == len(b) and all(np.array_equal(x, y)
                                               for x, y in zip(a, b)),
                      f"CachedStore {policy}, hot_keys={hot_keys}, {rounds} "
                      f"rounds over {keyspace} keys, {buckets} buckets, "
                      f"scan_max={scan_max}: {len(a)} outputs (replies, "
                      f"stats {a[4 * rounds].tolist()}, cache, backing "
                      f"store) bit-identical")
    print(f"  phase 3 (cache tier) seconds: "
          f"{time.perf_counter() - t_phase:.3f}")


def cache_reference(dev, stream):
    """The stream replayed in order through the store engine's step over
    make_store_table(24M) (keys 1..24M at version 1, as the backing store
    is populated): the replies every cache run must give. The table gets
    2^25 buckets, not the default 2^24: at load 0.36 some inserts of
    absent keys find both candidate buckets full and answer SPILL (the
    engine hands the key to a host tier it does not have), where the
    cache tier's backing store simply grows. No reply may be SPILL."""
    from dint_tpu_torch.clients import micro
    from dint_tpu_torch.engines import store
    from dint_tpu_torch.engines.types import Reply, make_batch
    from dint_tpu_torch.ops.u32 import to_numpy
    t0 = time.perf_counter()
    table = micro.make_store_table(CT_N, n_buckets=CT_REF_NB, val_words=VW,
                                   device=dev)
    torch.cuda.synchronize()
    populate_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = []
    for ops, keys, vals in stream:
        n = len(ops)
        table, rep = store.step(table, make_batch(
            ops, keys, vals, width=CT_W, val_words=VW, device=dev))
        ref.append((rep.rtype[:n].cpu().numpy(), to_numpy(rep.val[:n]),
                    to_numpy(rep.ver[:n])))
    print(f"  reference: make_store_table {populate_s:.3f} s, "
          f"{len(stream)} store.step replays {time.perf_counter() - t0:.3f} s")
    spills = sum(int((rt == Reply.SPILL).sum()) for rt, _, _ in ref)
    check(spills == 0, f"the reference answered no SPILL over "
          f"{sum(len(rt) for rt, _, _ in ref)} lanes")
    del table
    torch.cuda.empty_cache()
    return ref


def _timed_method(obj, name, acc):
    """Wrap ``obj.name`` so that its wall seconds add up in acc[name]."""
    fn = getattr(obj, name)

    def wrapper(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            acc[name] += time.perf_counter() - t0
    setattr(obj, name, wrapper)


def capture_hot_calls(calls):
    """Record the index, mask and value arguments of the cache tier's hot
    kernel calls in ``calls`` (keyed by caller, kernel and row width)
    while they run as usual. Returns the function that undoes it."""
    from dint_tpu_torch.engines import store_cache as sc
    orig = sc.gather_rows_hot, sc.scatter_rows_hot

    def gather(tabs, mirrors, idxs, midxs, vws):
        if tuple(vws) != (VW, 1):
            raise SmokeFailure(f"cache_step gathers val and ver in one "
                               f"call, not vws {vws}")
        calls.setdefault(("cache_step", "gather_rows_hot", "val+ver"),
                         []).append((tuple(i.clone() for i in idxs),
                                     tuple(m.clone() for m in midxs)))
        return orig[0](tabs, mirrors, idxs, midxs, vws)

    def scatter(tabs, mirrors, idxs, midxs, masks, vals, vws):
        site = sys._getframe(1).f_code.co_name       # cache_step or refill
        if tuple(vws) != (VW, 1):
            raise SmokeFailure(f"{site} installs val and ver in one call, "
                               f"not vws {vws}")
        calls.setdefault((site, "scatter_rows_hot", "val+ver"), []).append(
            tuple(tuple(x.clone() for x in a)
                  for a in (idxs, midxs, masks, vals)))
        return orig[1](tabs, mirrors, idxs, midxs, masks, vals, vws)

    sc.gather_rows_hot, sc.scatter_rows_hot = gather, scatter

    def undo():
        sc.gather_rows_hot, sc.scatter_rows_hot = orig
    return undo


def hot_kernels_at_cache_shapes(cache, calls):
    """B6 and B7 at the hot run's own shapes: for each call site, the
    wrapper against its plain version bit for bit on one round's arguments
    (a scatter into two copies of the cache's tables and mirrors), then
    kernel, plain version and yardstick timed over the recorded rounds
    against the bytes bound. Returns a record per kernel: the calls of a
    round added up, as `per_step` does."""
    from dint_tpu_torch.ops import row_kernels as rk
    t = cache.kv
    tabs2, mirrors2 = (t.val, t.ver), (cache.hot_val, cache.hot_ver)
    vws2 = (VW, 1)
    lanes = torch.arange(CT_W, device=t.val.device)
    parts = {"gather_rows_hot": {}, "scatter_rows_hot": {}}
    check(sorted(calls) == sorted(
        [("cache_step", "gather_rows_hot", "val+ver")]
        + [(s, "scatter_rows_hot", "val+ver")
           for s in ("cache_step", "refill")])
          and all(len(v) == CT_ROUNDS for v in calls.values()),
          f"the warm block ran each hot kernel call site once a round: "
          f"{ {k: len(v) for k, v in sorted(calls.items())} }")
    for (site, name, _), sets in sorted(calls.items()):
        k = sets[0][0][0].numel()
        if name == "gather_rows_hot":
            # val (vw = VW) and ver (vw = 1) of the same lanes, one launch
            label = f"{name}[{site}, val + ver] K={k}"
            got = rk.gather_rows_hot(tabs2, mirrors2, *sets[0], vws2)
            want = rk.gather_rows_hot_ref(tabs2, mirrors2, *sets[0], vws2)
            torch.cuda.synchronize()
            err = max(max_abs_err(x, y) for x, y in zip(got, want))
            check(all(torch.equal(x, y) for x, y in zip(got, want))
                  and err == 0,
                  f"{label} over [{t.val.numel()}] + mirror "
                  f"[{cache.hot_val.numel()}] and [{t.ver.numel()}] + "
                  f"[{cache.hot_ver.numel()}], "
                  f"{int((sets[0][1][0] >= 0).sum())} lanes hot, equals the "
                  f"plain version")
            ev = check_one_launch(label, lambda: rk.gather_rows_hot(
                tabs2, mirrors2, *sets[0], vws2))

            def g_bytes(idxs, midxs):
                # the two streams share their lanes: idx (read on cold
                # lanes) and midx count once
                hot = midxs[0] >= 0
                return 32 * sectors(lanes[:k][~hot]) + 4 * k + sum(
                    32 * (sectors(words_of(idxs[0][~hot], w))
                          + sectors(words_of(midxs[0][hot], w))) + 4 * k * w
                    for w in vws2)

            def chain(idxs, midxs):
                return tuple(torch.where((mi >= 0)[:, None], mr.view(
                    -1, w).index_select(0, mi.clamp(min=0)), tb.view(
                        -1, w).index_select(0, i)) for tb, mr, i, mi, w in
                    zip(tabs2, mirrors2, idxs, midxs, vws2))

            def singles(idxs, midxs):
                return tuple(rk.gather_rows_hot(tb, mr, i, mi, w) for
                             tb, mr, i, mi, w in zip(tabs2, mirrors2, idxs,
                                                     midxs, vws2))
            row = timed_row(
                label, lambda i, mi: rk.gather_rows_hot(
                    tabs2, mirrors2, i, mi, vws2),
                lambda i, mi: rk.gather_rows_hot_ref(tabs2, mirrors2, i, mi,
                                                     vws2),
                chain, "where/index_select chains", sets, g_bytes)
            row["two_launches_ms"] = device_ms(rotating(singles, sets))
            row["launches_per_call"] = ev["captured"]["kernels"]
            print(f"  {label}: the two single-stream launches "
                  f"{row['two_launches_ms']:.6f} ms")
        else:
            # the write-back's or the refill's val and ver installs on the
            # same lanes, one launch, into copies of the cache's tables
            label = f"{name}[{site}, val + ver] K={k}"
            tk = tuple(x.clone() for x in tabs2)
            mk = tuple(x.clone() for x in mirrors2)
            tr = tuple(x.clone() for x in tabs2)
            mr = tuple(x.clone() for x in mirrors2)
            rk.scatter_rows_hot(tk, mk, *sets[0], vws2)
            rk.scatter_rows_hot_ref(tr, mr, *sets[0], vws2)
            torch.cuda.synchronize()
            err = max(max_abs_err(x, y) for x, y in zip(tk + mk, tr + mr))
            check(all(torch.equal(x, y) for x, y in zip(tk + mk, tr + mr))
                  and err == 0,
                  f"{label} into [{t.val.numel()}] + mirror "
                  f"[{cache.hot_val.numel()}] and [{t.ver.numel()}] + "
                  f"[{cache.hot_ver.numel()}], {int(sets[0][2][0].sum())} "
                  f"masked in, equals the plain version (tables and whole "
                  f"mirrors)")
            ev = check_one_launch(label, lambda: rk.scatter_rows_hot(
                tk, mk, *sets[0], vws2))

            def s_bytes(idxs, midxs, masks, vals):
                # the two streams share their lanes: idx, midx and mask
                # count once
                m = masks[0]
                hm = m & (midxs[0] >= 0)
                live = lanes[:k][m]
                return 32 * 2 * sectors(live) + k + sum(
                    32 * (sectors(words_of(idxs[0][m], w))
                          + sectors(words_of(midxs[0][hm], w))
                          + sectors(words_of(live, w))) for w in vws2)

            def kept(idxs, midxs, masks, vals):
                out = []
                for i, mi, m, v, w in zip(idxs, midxs, masks, vals, vws2):
                    hm = m & (mi >= 0)
                    v2 = v.view(-1, w)
                    out += [i[m].long(), v2[m], mi[hm].long(), v2[hm]]
                return out

            def kept_copies(*z):
                for s in range(2):
                    r, v, mi, mv = z[4 * s:4 * s + 4]
                    tr[s].view(-1, vws2[s]).index_copy_(0, r, v)
                    mr[s].view(-1, vws2[s]).index_copy_(0, mi, mv)

            def singles(idxs, midxs, masks, vals):
                for s in range(2):
                    rk.scatter_rows_hot(tk[s], mk[s], idxs[s], midxs[s],
                                        masks[s], vals[s], vws2[s])

            def two(*z):
                return rk.scatter_rows_hot(tk, mk, *z, vws2)
            row = timed_row(
                label, two,
                lambda *z: rk.scatter_rows_hot_ref(tr, mr, *z, vws2),
                kept_copies, "4 index_copy_ of kept rows", sets, s_bytes,
                [kept(*z) for z in sets])
            turns = [device_ms(rotating(two, sets)),
                     device_ms(rotating(singles, sets)),
                     device_ms(rotating(singles, sets)),
                     device_ms(rotating(two, sets))]
            row.update(two_launches_ms=(turns[1] + turns[2]) / 2,
                       launches_per_call=ev["captured"]["kernels"])
            print(f"  {label}, in turns: one launch {turns[0]:.6f} ms, two "
                  f"single-stream launches {turns[1]:.6f}, {turns[2]:.6f}, "
                  f"one launch {turns[3]:.6f}")
            del tk, mk, tr, mr
        row["max_abs_err"] = err
        parts[name][site] = row
    torch.cuda.empty_cache()
    return {name: dict(per_step(p), calls=p) for name, p in parts.items()}


def cache_run(dev, label, policy, hot_keys, base, stream, ref):
    """One full-width run of the CachedStore from the populated ``base``
    (backing store, bloom words): the sweep, one warm block, CT_TIMED
    timed blocks; its replies against ``ref``; the flushed cache against
    the backing store; with the hot tier, B6 and B7 on the warm block's
    arguments. Returns (launches over the timed blocks, replies of every
    round, the B6/B7 records or None)."""
    import copy
    import dataclasses
    from dint_tpu_torch.engines.types import Reply
    from dint_tpu_torch.ops import u64
    from dint_tpu_torch.ops.u32 import to_numpy
    from dint_tpu_torch.shim.host_kvs import CacheStats, CachedStore
    print(f"  -- {label}: policy {policy}, hot_keys {hot_keys}")
    torch.cuda.reset_peak_memory_stats(dev)
    kvs, b_hi, b_lo = base
    srv = CachedStore(CT_NB, val_words=VW, policy=policy, width=CT_W,
                      hot_keys=hot_keys, device=dev)
    t0 = time.perf_counter()
    srv.kvs = copy.deepcopy(kvs)
    srv.cache.kv.bloom_hi, srv.cache.kv.bloom_lo = b_hi.clone(), b_lo.clone()
    print(f"  backing store copied in {time.perf_counter() - t0:.3f} s")
    n_sweep = len(stream) - (1 + CT_TIMED) * CT_ROUNDS
    got = []
    t0 = time.perf_counter()
    calls = {}
    for i, (ops, keys, vals) in enumerate(stream[:n_sweep + CT_ROUNDS]):
        undo = (capture_hot_calls(calls) if hot_keys and i >= n_sweep
                else (lambda: None))
        got.append(srv.serve(ops, keys, vals))
        undo()
    torch.cuda.synchronize()
    print(f"  sweep ({n_sweep} rounds) + warm block: "
          f"{time.perf_counter() - t0:.3f} s")
    split = {"_do_refills": 0.0, "resolve_batch": 0.0}
    _timed_method(srv, "_do_refills", split)
    _timed_method(srv.kvs, "resolve_batch", split)
    srv.stats = CacheStats()
    reset_launches()
    block_s = []
    for b in range(CT_TIMED):
        lo = n_sweep + (1 + b) * CT_ROUNDS
        t0 = time.perf_counter()
        for ops, keys, vals in stream[lo:lo + CT_ROUNDS]:
            got.append(srv.serve(ops, keys, vals))
        torch.cuda.synchronize()
        block_s.append(time.perf_counter() - t0)
    launches = launch_counts()
    st = dataclasses.asdict(srv.stats)
    secs = float(sum(block_s))
    rounds = CT_TIMED * CT_ROUNDS
    ms_round = secs / rounds * 1e3
    refill_ms = split["_do_refills"] / rounds * 1e3
    resolve_ms = split["resolve_batch"] / rounds * 1e3
    hit_rate = st["hits"] / max(st["hits"] + st["misses"], 1)
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"  ms/round: {ms_round:.6f}; per block "
          f"{[round(x * 1e3, 3) for x in block_s]} ms")
    print(f"  answered ops/s: {rounds * CT_W / secs:.1f} ({rounds * CT_W} "
          f"lanes in {secs:.6f} s)")
    print(f"  hits {st['hits']}, misses {st['misses']}, bloom negatives "
          f"{st['bloom_negatives']}, writebacks {st['writebacks']}, hit "
          f"rate {hit_rate:.6f}")
    print(f"  a round: refill {refill_ms:.6f} ms, host resolve "
          f"{resolve_ms:.6f} ms, device step and the rest (make_batch, "
          f"cache_step, reading its replies, flush write-backs, the refill "
          f"queue) {ms_round - refill_ms - resolve_ms:.6f} ms")
    print(f"  launches per round: "
          f"{ {k: v / rounds for k, v in launches.items() if v} }")
    print(f"  max_memory_allocated: {peak} B")

    bad = []
    for i, ((rt, rv, rr), (wt, wv, wr)) in enumerate(zip(got, ref)):
        lanes = (rt != wt) | (rr != wr) | ((wt == Reply.VAL)
                                           & (rv != wv).any(-1))
        if lanes.any():
            j = np.nonzero(lanes)[0][:3]
            bad.append(f"round {i}: {int(lanes.sum())} lanes, e.g. op "
                       f"{stream[i][0][j]} key {stream[i][1][j]} got "
                       f"{rt[j]}/{rr[j]} want {wt[j]}/{wr[j]}")
    check(len(got) == len(ref) and not bad,
          f"{label}: all {len(ref)} rounds equal the store engine's replay "
          f"(rtype and ver on every lane, val on VAL lanes)"
          + (f": {bad[:3]}" if bad else ""))
    srv._flush_dirty()
    t = srv.cache.kv
    e = torch.nonzero(t.valid).squeeze(1)
    keys = u64.join(to_numpy(t.key_hi[e]), to_numpy(t.key_lo[e]))
    found, vals, vers = srv.kvs.lookup(keys)
    check(found.all() and np.array_equal(vals, to_numpy(
        t.val.view(-1, VW)[e])) and np.array_equal(vers, to_numpy(t.ver[e]))
          and not bool(srv.cache.dirty.any()),
          f"{label}: after the flush, each of the {len(e)} cached entries "
          f"equals the backing store's record")
    if hot_keys:
        hot = (to_numpy(t.key_hi[e]) == 0) & (to_numpy(t.key_lo[e])
                                              < hot_keys)
        kid = torch.from_numpy(to_numpy(t.key_lo[e])[hot].astype(np.int64))
        check(np.array_equal(to_numpy(srv.cache.hot_ver)[kid], vers[hot])
              and np.array_equal(to_numpy(srv.cache.hot_val).reshape(
                  -1, VW)[kid], vals[hot]),
              f"{label}: the mirror equals the cache on its {int(hot.sum())} "
              f"cached hot keys")
        kern = hot_kernels_at_cache_shapes(srv.cache, calls)
    del srv, calls
    gc.collect()          # the timing wrappers hold srv in a cycle
    torch.cuda.empty_cache()
    return launches, got, kern if hot_keys else None


def phase_cache(dev):
    print(f"== phase 8: the cache tier at full width, {CT_N:,} keys behind "
          f"a {CT_NB:,} x 4 cache, w={CT_W}, 50/50 GET/SET, 90% of keys in "
          f"[1, {CT_HOT:,}]")
    from dint_tpu_torch.clients import micro
    from dint_tpu_torch.engines import store_cache as sc
    from dint_tpu_torch.shim.host_kvs import CachedStore
    t_phase = time.perf_counter()
    stream = micro.cache_stream(np.random.default_rng(21), CT_N, CT_W,
                                (1 + CT_TIMED) * CT_ROUNDS, VW)
    ref = cache_reference(dev, stream)
    keys = np.arange(1, CT_N + 1, dtype=np.uint64)
    vals = np.zeros((CT_N, VW), np.uint32)
    vals[:, 0] = keys.astype(np.uint32)
    vals[:, 1] = micro.STORE_MAGIC
    t0 = time.perf_counter()
    loader = CachedStore(CT_NB, val_words=VW, width=CT_W, device=dev)
    loader.populate(keys, vals)
    torch.cuda.synchronize()
    print(f"  CachedStore.populate: {time.perf_counter() - t0:.3f} s "
          f"({loader.kvs.nb} backing buckets x 8 slots, {loader.kvs.n_live} "
          f"live, {len(loader.kvs._spill)} in the spill dict)")
    base = (loader.kvs, loader.cache.kv.bloom_hi, loader.cache.kv.bloom_lo)
    del keys, vals, loader
    torch.cuda.empty_cache()
    paths = {}
    replies = None
    for label, policy, hot_keys in (("wb_bloom", sc.WB_BLOOM, 0),
                                    ("wb_nobloom", sc.WB_NOBLOOM, 0),
                                    ("wt", sc.WT, 0),
                                    ("wb_bloom+hot", sc.WB_BLOOM,
                                     CT_HOT_KEYS)):
        paths[label], got, kern = cache_run(dev, label, policy, hot_keys,
                                            base, stream, ref)
        if label == "wb_bloom":
            replies = got
        elif label == "wb_bloom+hot":
            check(all(all(np.array_equal(x, y) for x, y in zip(a, b))
                      for a, b in zip(replies, got)),
                  "the hot-tier run's replies equal the wb_bloom run's")
            hot_rec = kern
        del got
    check(all(v == 0 for k in ("wb_bloom", "wb_nobloom", "wt")
              for v in paths[k].values()),
          "the runs without the hot tier launch no hand kernel")
    rounds = CT_TIMED * CT_ROUNDS
    hot = paths["wb_bloom+hot"]
    check(hot["gather_rows_hot"] == rounds
          and hot["scatter_rows_hot"] == 2 * rounds,
          f"the hot-tier run launched gather_rows_hot once a round and "
          f"scatter_rows_hot twice (write-back and refill), each call val "
          f"and ver as two streams: {hot}")
    print(f"  phase 8 seconds: {time.perf_counter() - t_phase:.3f}")
    return {"cache hot": hot}, hot_rec



# ------------------------------------------------------- bench and recovery

# the bench line's keys (bench.py:362-453 with the SmallBank leg; route,
# device and card in place of use_pallas/use_hotset)
BENCH_KEYS = (
    "schema", "metric", "value", "unit", "vs_baseline", "mode",
    "throughput", "abort_rate", "contention_abort_rate", "ab_lock",
    "ab_missing", "ab_validate", "avg_us", "p50_us", "p99_us", "p999_us",
    "lat_samples", "lat_hist", "n_subscribers", "width", "blocks",
    "window_s", "host_ucores", "host_kcores", "proc_ucores", "proc_kcores",
    "route", "device", "card", "plan", "counters", "dinttrace", "serve",
    "dintlint", "dintcost", "dintdur", "breakdown",
    "smallbank_committed_txns_per_sec", "smallbank_abort_rate",
    "smallbank_width", "smallbank_points", "smallbank_route",
    "smallbank_balance_conserved", "smallbank_plan")


def phase_bench(card):
    print(f"== phase 9: the bench entry, python -m dint_tpu_torch.bench, "
          f"{BENCH_WINDOW_S} s windows, TATP at {N_SUB:,} subscribers and "
          f"SmallBank at {SB_N:,} accounts")
    from dint_tpu_torch import bench
    torch.cuda.empty_cache()
    env = {k: v for k, v in os.environ.items() if not k.startswith("DINT_")}
    # the gates' CPU runs take minutes: phase 22 runs them on the card
    env.update(DINT_BENCH_WINDOW_S=str(BENCH_WINDOW_S),
               DINT_BENCH_PROFILE="1", DINT_BENCH_LINT="0")
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "dint_tpu_torch.bench"],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    secs = time.perf_counter() - t0
    check(out.returncode == 0,
          f"the bench exits 0 in {secs:.3f} s" + (
              "" if out.returncode == 0 else
              f" (rc {out.returncode}; stderr: {out.stderr[-2000:]})"))
    lines = out.stdout.strip().splitlines()
    line = json.loads(lines[-1])
    print("  " + json.dumps({k: v for k, v in line.items()
                             if k != "lat_hist"}))
    check(len(lines) == 1 and all(k in line for k in BENCH_KEYS)
          and all(line[k] == {"disabled": "DINT_BENCH_LINT=0"}
                  for k in ("dintlint", "dintcost", "dintdur")),
          "one JSON line holding every key of the bench line; the three "
          "gate fields record DINT_BENCH_LINT=0")
    route, _ = bench.plan_route("tatp_uniform", {})
    sb_route, _ = bench.plan_route("smallbank_skewed", {})
    check(line["value"] > 0 and line["smallbank_committed_txns_per_sec"] > 0
          and line["smallbank_balance_conserved"] is True
          and line["n_subscribers"] == N_SUB and line["width"] == W
          and [p["width"] for p in line["smallbank_points"]] == [8192, 16384],
          f"committed txn/s {line['value']} > 0 at {N_SUB:,} subscribers, "
          f"w={W}; SmallBank {line['smallbank_committed_txns_per_sec']} > 0 "
          f"at w=8192 and 16384, balance conserved")
    check(line["route"] == route and line["smallbank_route"] == sb_route
          and line["card"] == card
          and line["device"] == torch.cuda.get_device_name(0),
          f"the line names the route PLAN_H100.json pins ({route}, "
          f"{sb_route}) "
          f"and the card ({line['card']})")
    CLOSED_LOOP_RATE["tatp_dense"] = line["throughput"]
    CLOSED_LOOP_RATE["smallbank_dense"] = \
        line["smallbank_committed_txns_per_sec"]
    launches = line["profile"]["launches"]
    paths = {"bench tatp": launches["tatp"],
             "bench smallbank": launches["smallbank"]}
    for (label, n), want in zip(paths.items(), (TATP_PER_STEP[route],
                                                SB_PER_STEP[sb_route])):
        ran = {k for k, c in n.items() if c}
        check(ran == set(want) and len({n[k] for k in ran}) == 1,
              f"{label}: {sorted(want)} launched, each once a step "
              f"({ {k: n[k] for k in sorted(ran)} })")
    return paths


def phase_recovery_tatp(dev, live):
    print(f"== phase 10 (TATP): phase 4's tables rebuilt from each log "
          f"replica, n_sub={N_SUB:,}")
    from dint_tpu_torch import recovery
    from dint_tpu_torch.engines import tatp_dense as td
    from dint_tpu_torch.ops.u32 import to_u64
    from dint_tpu_torch.tables import log as logring
    t_phase = time.perf_counter()
    heads = to_u64(live.log.head)
    cap = live.log.capacity
    check(int(heads.max()) < cap,
          f"every head below the capacity of {cap} a lane (max "
          f"{int(heads.max())}, {int(heads.sum())} entries a replica)")
    # phase 4's base tables: populate_device is deterministic on one card
    db0 = td.populate_device(torch.Generator(device=dev).manual_seed(0),
                             N_SUB, val_words=VW, device=dev)
    check(not torch.equal(db0.ver, live.ver),
          "the run changed ver, so recovery is not trivial")
    meta0 = db0.meta.clone()

    def same(rec, what):
        check(torch.equal(rec.val, live.val) and torch.equal(rec.ver, live.ver)
              and torch.equal(rec.exists, live.exists)
              and not bool(rec.locked.any()),
              f"{what}: val, ver and exists == the live tables on every row, "
              f"no row locked")

    for r in range(3):
        t0 = time.perf_counter()
        rec = recovery.replay_tatp_dense(
            db0, logring.replica_entries(live.log, r), live.log.head)
        torch.cuda.synchronize()
        same(rec, f"replica {r} replayed on the card in "
                  f"{time.perf_counter() - t0:.3f} s")
        del rec
    t0 = time.perf_counter()
    rec = recovery.recover_tatp_dense(
        db0, logring.replica_entries(live.log, 0), live.log.head)
    torch.cuda.synchronize()
    same(rec, f"replica 0 recovered on the host (numpy) in "
              f"{time.perf_counter() - t0:.3f} s")
    check(torch.equal(db0.meta, meta0), "db0 untouched")
    del rec, db0, meta0
    torch.cuda.empty_cache()
    print(f"  phase 10 (TATP) seconds: {time.perf_counter() - t_phase:.3f}")


def phase_recovery_smallbank(dev):
    print(f"== phase 10 (SmallBank): {SB_N:,} accounts, w={SB_W}, rebuilt "
          f"from each log replica; a wrapped ring refused")
    from dint_tpu_torch import recovery
    from dint_tpu_torch.engines import smallbank_dense as sd
    from dint_tpu_torch.ops.u32 import to_u64
    from dint_tpu_torch.tables import log as logring
    t_phase = time.perf_counter()
    db = sd.create(SB_N, device=dev)
    base = int(sd.total_balance(db))
    cap = db.log.capacity
    run, init, drain = sd.build_pipelined_runner(
        SB_N, w=SB_W, cohorts_per_block=SB_CPB, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    reset_launches()
    carry = init(db)
    carry, s = run(carry, gen)
    stats, top = [s], int(to_u64(carry[0].log.head).max())
    grew = top
    # at most RECOVERY_SB_BLOCKS more blocks, none that would wrap a lane
    for _ in range(RECOVERY_SB_BLOCKS):
        if top + grew + SB_W >= cap:
            break
        carry, s = run(carry, gen)
        stats.append(s)
        now = int(to_u64(carry[0].log.head).max())
        grew, top = now - top, now
    db, tail = drain(carry)
    torch.cuda.synchronize()
    launches = launch_counts()
    total = torch.cat(stats + [tail]).cpu().numpy().astype(np.int64).sum(0)
    heads = to_u64(db.log.head)
    check(int(heads.max()) < cap,
          f"{len(stats)} blocks + drain: every head below the capacity of "
          f"{cap} a lane (max {int(heads.max())}, {int(heads.sum())} "
          f"entries a replica)")
    final = int(sd.total_balance(db))
    check((final - base) % (1 << 32)
          == int(total[sd.STAT_BAL_DELTA]) % (1 << 32),
          "balance conservation mod 2^32")
    db0 = sd.create(SB_N, device=dev)

    def same(rec, what):
        check(torch.equal(rec.bal, db.bal)
              and int(sd.total_balance(rec)) == final
              and rec.step >= db.step - 1 and not bool(rec.x_step.any())
              and not bool(rec.s_step.any()),
              f"{what}: bal and total_balance == the live tables, stamps "
              f"reset, step {rec.step} resumes past {db.step - 1}")

    for r in range(3):
        t0 = time.perf_counter()
        rec = recovery.replay_smallbank_dense(
            db0, logring.replica_entries(db.log, r), db.log.head)
        same(rec, f"replica {r} replayed on the card in "
                  f"{time.perf_counter() - t0:.3f} s")
        del rec
    t0 = time.perf_counter()
    rec = recovery.recover_smallbank_dense(
        db0, logring.replica_entries(db.log, 0), db.log.head)
    same(rec, f"replica 0 recovered on the host (numpy) in "
              f"{time.perf_counter() - t0:.3f} s")
    del rec

    # go on until a lane wraps: recovery must refuse the ring
    carry = init(db)
    for _ in range(4 * RECOVERY_SB_BLOCKS):
        if int(to_u64(carry[0].log.head).max()) > cap:
            break
        carry, _ = run(carry, gen)
    db, _ = drain(carry)
    heads = to_u64(db.log.head)
    try:
        recovery.recover_smallbank_dense(
            db0, logring.replica_entries(db.log, 0), db.log.head)
        refused = ""
    except ValueError as e:
        refused = str(e)
    check(int(heads.max()) > cap and "wrapped" in refused,
          f"a wrapped ring (head max {int(heads.max())} > {cap}) is "
          f"refused: {refused}")
    del db, db0, carry
    torch.cuda.empty_cache()
    print(f"  phase 10 (SmallBank) seconds: "
          f"{time.perf_counter() - t_phase:.3f}")
    return launches



# ------------------------------------------------------- the generic engines


def _same_tree(a, b):
    """Two port states (dataclass trees or lists of them) bit-identical,
    compared on the host."""
    from dint_tpu_torch import convert
    if isinstance(a, list):
        return len(a) == len(b) and all(_same_tree(x, y) for x, y in zip(a, b))
    da, db = convert.tree_to_numpy(a), convert.tree_to_numpy(b)
    return da.keys() == db.keys() and all(
        np.array_equal(v, db[k]) if isinstance(v, np.ndarray) else v == db[k]
        for k, v in da.items())


def _same_replies(a, b):
    return all(torch.equal(x.cpu(), y.cpu()) for x, y in
               ((a.rtype, b.rtype), (a.val, b.val), (a.ver, b.ver)))


def _replicas_identical(shards, skip=()):
    """The replicas' (or any dataclass trees') every leaf, on the card;
    an attributed CF lock word's owner apart (only the primary locks, so
    its last holder is per replica), and the leaves ``skip`` names."""
    import dataclasses
    skip = ("cf_lock.owner_hi", "cf_lock.owner_lo", *skip)

    def leaves(x, path=""):
        for f in dataclasses.fields(x):
            v, name = getattr(x, f.name), path + f.name
            if dataclasses.is_dataclass(v):
                yield from leaves(v, name + ".")
            elif name not in skip:
                yield v
    first = list(leaves(shards[0]))
    return all(all(torch.equal(x, y) if isinstance(x, torch.Tensor)
                   else x == y for x, y in zip(first, leaves(s)))
               for s in shards[1:])


def phase_generic_cpu_vs_card(dev):
    print("== phase 11 (CPU against the card): the generic engines at a "
          "small size, the same inputs")
    from dint_tpu_torch.clients import micro, tatp_client
    from dint_tpu_torch.clients import workloads as wl
    from dint_tpu_torch.engines import (fasst, lock2pl, logsrv, smallbank,
                                        smallbank_pipeline as sp, tatp,
                                        tatp_pipeline as tp)
    from dint_tpu_torch.engines.types import Op, make_batch
    from dint_tpu_torch.monitor import counters as mon
    from dint_tpu_torch.tables import locks
    from dint_tpu_torch.tables import log as logring
    t_phase = time.perf_counter()
    rng = np.random.default_rng(11)

    def steps(label, step, make_state, make_ops, n_batches, width, vw=2):
        states = {d: make_state(d) for d in ("cpu", dev)}
        for _ in range(n_batches):
            args = make_ops()
            reps = {}
            for d in states:
                b = make_batch(*args[:3], vers=args[3], tables=args[4],
                               width=width, val_words=vw, device=d)
                states[d], reps[d] = step(states[d], b)
            if not _same_replies(reps["cpu"], reps[dev]):
                check(False, f"{label}: replies differ")
        check(_same_tree(states["cpu"], states[dev]),
              f"{label}: {n_batches} contended batches of {width} lanes, "
              f"replies and state bit-identical")

    nl = 64

    def lock_ops(codes):
        def make():
            n = 200
            ops = np.asarray(codes)[rng.integers(0, len(codes), n)]
            return (ops, rng.integers(0, 4 * nl, n).astype(np.uint64), None,
                    None, None)
        return make

    steps("lock2pl", lock2pl.step, lambda d: locks.create_sx(nl, d),
          lock_ops([Op.ACQ_S, Op.ACQ_X, Op.REL_S, Op.REL_X, Op.NOP]), 8, 256)
    occ = lock_ops([Op.READ_VER, Op.LOCK, Op.COMMIT_VER, Op.ABORT, Op.NOP])
    steps("fasst", fasst.step, lambda d: locks.create_occ(nl, d), occ, 8, 256)
    steps("fasst step_attr", fasst.step_attr,
          lambda d: locks.create_occ_attr(nl, d), occ, 8, 256)

    def log_ops():
        n = 200
        return (np.where(rng.random(n) < 0.8, Op.LOG_APPEND, Op.NOP),
                rng.integers(0, 1 << 40, n).astype(np.uint64),
                rng.integers(0, 1 << 32, (n, 2), dtype=np.uint64),
                rng.integers(0, 1 << 32, n, dtype=np.uint64),
                rng.integers(0, 5, n))
    steps("logsrv", logsrv.step, lambda d: logring.create(4, 64, 2, d),
          log_ops, 8, 256)

    def sb_ops():
        n = 200
        codes = [Op.ACQ_S_READ, Op.ACQ_X_READ, Op.REL_S, Op.REL_X,
                 Op.COMMIT_PRIM, Op.COMMIT_BCK, Op.COMMIT_LOG, Op.NOP]
        return (np.asarray(codes)[rng.integers(0, len(codes), n)],
                rng.integers(0, 40, n).astype(np.uint64),
                rng.integers(0, 1 << 32, (n, 2), dtype=np.uint64),
                ((1 << 31) - 8 + rng.integers(0, 16, n)).astype(np.uint64),
                rng.integers(0, 2, n))
    steps("smallbank.step", smallbank.step,
          lambda d: sp.create_stacked(40, log_capacity=64, device=d)[0],
          sb_ops, 8, 256)

    n_sub = 40

    def tatp_ops():
        n = 200
        codes = [Op.OCC_READ, Op.OCC_LOCK, Op.COMMIT_PRIM, Op.COMMIT_BCK,
                 Op.ABORT, Op.INSERT_PRIM, Op.INSERT_BCK, Op.DELETE_PRIM,
                 Op.DELETE_BCK, Op.COMMIT_LOG, Op.DELETE_LOG, Op.NOP]
        tbl = rng.integers(0, 5, n)
        sid = rng.integers(1, n_sub + 1, n)
        typ = rng.integers(1, 5, n)
        keys = np.where(tbl <= tatp.SEC_SUBSCRIBER, sid, sid * 4 + typ - 1)
        keys = np.where(tbl == tatp.CALL_FORWARDING, tatp.cf_key(
            rng.integers(1, 4, n), typ, 8 * rng.integers(0, 3, n)), keys)
        return (np.asarray(codes)[rng.integers(0, len(codes), n)],
                keys.astype(np.uint64),
                rng.integers(0, 1 << 32, (n, 4), dtype=np.uint64),
                rng.integers(0, 1 << 32, n, dtype=np.uint64), tbl)
    for attr in (False, True):
        steps(f"tatp.step (attr_locks={attr})", tatp.step,
              lambda d: tatp_client.populate_shards(
                  np.random.default_rng(3), n_sub, val_words=4,
                  log_capacity=64, cf_lock_slots=16, attr_locks=attr,
                  device=d)[0][0], tatp_ops, 8, 256, vw=4)

    # the pipelines: one block and the drain on the same draws
    cpb = 2
    for n_sub, w, mix, monitor in ((2000, 64, None, False),
                                   (32, 256, TATP_CONTENTION_MIX, True)):
        g = torch.Generator().manual_seed(12)
        bits = tp.draw_bits(g, (cpb, w, 4), "cpu")
        pay = torch.randint(0, 1 << 16, (cpb + 2, w, 2), dtype=torch.int32,
                            generator=g)
        out = {}
        for d in ("cpu", dev):
            shards, _ = tatp_client.populate_shards(
                np.random.default_rng(4), n_sub, val_words=4,
                log_capacity=1 << 12, device=d)
            run, init, drain = tp.build_pipelined_runner(
                n_sub, w=w, val_words=4, cohorts_per_block=cpb, mix=mix,
                monitor=monitor, device=d)
            carry, s = run.run_draws(init(shards), bits.to(d),
                                     pay[:cpb].to(d))
            res = drain(carry, payload=pay[cpb:].to(d))
            ser = tp.build_runner(n_sub, w=w, val_words=4,
                                  cohorts_per_block=cpb, device=d)
            shards, s2 = ser.run_draws(res[0], bits.to(d), pay[:cpb].to(d))
            out[d] = (shards, torch.cat([s, res[1], s2]).cpu(),
                      res[2].buf.cpu() if monitor else None)
        (a, sa, ca), (b, sb, cb) = out["cpu"], out[dev]
        check(_same_tree(a, b) and torch.equal(sa, sb)
              and (ca is None or torch.equal(ca, cb)),
              f"generic TATP n_sub={n_sub}, w={w}: one pipelined block + "
              f"drain{' (monitor)' if monitor else ''}, then one serial "
              f"block: replicas, stats{' and counters' if monitor else ''} "
              f"bit-identical")
    n, w = 64, 128
    g = torch.Generator().manual_seed(13)
    bits, amt = sp.draw_step(g, (cpb, w), "cpu")
    out = {}
    for d in ("cpu", dev):
        run = sp.build_runner(n, w=w, cohorts_per_block=cpb, monitor=True,
                              device=d)
        (shards, cnt), s = run.run_draws(
            (sp.create_stacked(n, log_capacity=1 << 12, device=d),
             mon.create(d)), bits.to(d), amt.to(d))
        out[d] = (shards, s.cpu(), cnt.buf.cpu())
    (a, sa, ca), (b, sb, cb) = out["cpu"], out[dev]
    check(_same_tree(a, b) and torch.equal(sa, sb) and torch.equal(ca, cb),
          f"generic SmallBank n={n}, w={w}: one block (monitor): replicas, "
          f"stats and counters bit-identical")

    trace = wl.lock_trace(np.random.default_rng(3), n_txns=200,
                          key_range=300)
    for label, make in (
            ("Lock2PLClient", lambda d: micro.Lock2PLClient(
                trace, n_slots=256, cohort=24, width=256, device=d)),
            ("FasstClient", lambda d: micro.FasstClient(
                trace, n_slots=256, cohort=24, width=256, device=d)),
            ("FasstClient(attribute)", lambda d: micro.FasstClient(
                trace, n_slots=256, cohort=24, width=256, attribute=True,
                device=d))):
        c = {d: make(d) for d in ("cpu", dev)}
        for _ in range(4):
            for x in c.values():
                x.run_round()
        a, b = c["cpu"], c[dev]
        check((a.rec.attempted, a.rec.committed, a.rec.extra)
              == (b.rec.attempted, b.rec.committed, b.rec.extra)
              and _same_tree(a.state, b.state),
              f"{label}: 4 rounds, stats and lock table bit-identical "
              f"({b.rec.committed} of {b.rec.attempted} committed)")
    c = {d: micro.LogClient(width=64, val_words=2, lanes=4, capacity=16,
                            device=d) for d in ("cpu", dev)}
    for i in range(4):
        for x in c.values():
            x.run_wave(np.random.default_rng(i), 50)
    check(_same_tree(c["cpu"].state, c[dev].state),
          "LogClient: 4 waves, the ring bit-identical")
    print(f"  phase 11 (CPU against the card) seconds: "
          f"{time.perf_counter() - t_phase:.3f}")


def _micro_window(label, client, card, per_round):
    """``per_round()`` (one round or wave of ``client``) for GEN_WINDOW_S
    seconds after one warm round; prints and returns the numbers."""
    per_round()
    client.rec.reset()
    rounds, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < GEN_WINDOW_S:
        per_round()
        rounds += 1
    secs = time.perf_counter() - t0
    blk = client.rec.block(secs)
    rec = {"rounds": rounds, "seconds": secs, "rounds_per_s": rounds / secs,
           "committed_per_s": blk.goodput, "attempted_per_s": blk.throughput,
           "abort_rate": 1 - client.rec.committed / max(client.rec.attempted,
                                                        1),
           "p50_us": blk.p50_us, "p99_us": blk.p99_us,
           **{k: v for k, v in client.rec.extra.items() if k != "lat_hist"}}
    print(f"  {label}: {rounds} rounds in {secs:.3f} s = "
          f"{rec['rounds_per_s']:.1f} rounds/s, committed "
          f"{blk.goodput:.1f}/s, abort rate {rec['abort_rate']:.6f}, p50 "
          f"{blk.p50_us:.1f} us, p99 {blk.p99_us:.1f} us  [{card}]")
    return rec


def phase_generic(dev, card):
    print(f"== phase 11: the generic engines: lock_2pl, lock_fasst and "
          f"log_server at {GEN_SLOTS:,} slots and a {GEN_LOG_LANES} x "
          f"{GEN_LOG_CAP:,} ring; TATP at {GEN_N_SUB:,} subscribers and "
          f"SmallBank at {GEN_SB_N:,} accounts, w={GEN_W}, 3 replicas")
    from dint_tpu_torch.clients import micro, tatp_client
    from dint_tpu_torch.clients import workloads as wl
    from dint_tpu_torch.engines import smallbank_pipeline as sp
    from dint_tpu_torch.engines import tatp_pipeline as tp
    from dint_tpu_torch.engines.types import Op, Reply
    from dint_tpu_torch.ops.u32 import to_u64
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    out = {}

    # ---- the three microbenchmarks (exp.py sweep_micro's settings)
    trace = wl.lock_trace(np.random.default_rng(0), n_txns=GEN_TRACE_TXNS)
    c = micro.Lock2PLClient(trace, n_slots=GEN_SLOTS, cohort=GEN_COHORT,
                            width=GEN_LOCK_W, device=dev)
    # one acquire wave by hand: the closed form's invariants on the table
    keys, is_read, _ = micro._flatten(c.co.cur)
    rt = c._wave(np.where(is_read, Op.ACQ_S, Op.ACQ_X).astype(np.int32),
                 keys)[0]
    sh, ex = c.state.num_sh, c.state.num_ex
    granted = rt == Reply.GRANT
    check(not bool(((sh > 0) & (ex > 0)).any()) and int(ex.max()) <= 1
          and int(sh.sum() + ex.sum()) == int(granted.sum())
          and int(sh.sum()) == int((granted & is_read).sum()),
          f"lock_2pl: after {len(keys)} acquires no slot holds S and X, X "
          f"at most 1, the counts equal the {int(granted.sum())} grants")
    rel = np.where(is_read[granted], Op.REL_S, Op.REL_X).astype(np.int32)
    c._wave(rel, keys[granted])
    check(int(sh.abs().sum() + ex.abs().sum()) == 0,
          "lock_2pl: the releases return every count to 0")
    out["lock_2pl"] = _micro_window("lock_2pl", c, card, c.run_round)
    check(int(c.state.num_sh.abs().sum() + c.state.num_ex.abs().sum()) == 0
          and out["lock_2pl"]["committed_per_s"] > 0,
          "lock_2pl: every count 0 after the window's rounds")
    del c
    for label, attr in (("lock_fasst", False), ("lock_fasst_attr", True)):
        c = micro.FasstClient(trace, n_slots=GEN_SLOTS, cohort=GEN_COHORT,
                              width=GEN_LOCK_W, attribute=attr, device=dev)
        out[label] = _micro_window(label, c, card, c.run_round)
        x = c.rec.extra
        check(not bool(c.state.locked.any())
              and out[label]["committed_per_s"] > 0
              and (not attr or x["lock_cnt"] >= x["reject_sharing_cnt"]
                   + x["reject_same_key_cnt"] > 0),
              f"{label}: no lock held after the window's rounds"
              + (f"; lock_cnt {x['lock_cnt']}, reject_sharing_cnt "
                 f"{x['reject_sharing_cnt']}, reject_same_key_cnt "
                 f"{x['reject_same_key_cnt']}" if attr else ""))
        del c
    c = micro.LogClient(width=GEN_LOG_W, val_words=GEN_LOG_VW,
                        lanes=GEN_LOG_LANES, capacity=GEN_LOG_CAP,
                        device=dev)
    rng = np.random.default_rng(1)
    waves = [0]

    def wave():
        c.run_wave(rng)
        waves[0] += 1
    out["log_server"] = _micro_window("log_server", c, card, wave)
    appended = waves[0] * GEN_LOG_W
    check(int(to_u64(c.state.head).sum()) == appended
          and c.rec.committed == c.rec.attempted,
          f"log_server: every append ACKed, the ring heads sum to the "
          f"{appended:,} appends")
    del c
    torch.cuda.empty_cache()

    # ---- generic TATP: 3 replicas of tatp.create's defaults
    t0 = time.perf_counter()
    shards, cf_keys = tatp_client.populate_shards(
        np.random.default_rng(0), GEN_N_SUB, val_words=VW, device=dev)
    torch.cuda.synchronize()
    pop_s = time.perf_counter() - t0
    print(f"  populate_shards: {pop_s:.3f} s, {len(cf_keys):,} CF keys, "
          f"{torch.cuda.memory_allocated(dev):,} B on the card")
    check(_replicas_identical(shards), "the three replicas populate "
          "identically")

    def tatp_checks(label, stacked, total, blocks):
        attempted = int(total[tp.STAT_ATTEMPTED])
        check(attempted == blocks * GEN_CPB * GEN_W and int(
            total[tp.STAT_COMMITTED] + total[tp.STAT_AB_LOCK]
            + total[tp.STAT_AB_MISSING] + total[tp.STAT_AB_VALIDATE])
            == attempted and int(total[tp.STAT_MAGIC_BAD]) == 0,
            f"{label}: accounting closes (committed + ab_lock + ab_missing "
            f"+ ab_validate == attempted == {attempted:,}), magic_bad == 0")
        check(not any(bool(lk.any()) for s in stacked
                      for _, lk in s.dense_tables())
              and not any(bool(s.cf_lock.locked.any()) for s in stacked),
              f"{label}: no lock held")
        check(_replicas_identical(stacked),
              f"{label}: the three replicas' tables, CF table, lock words "
              f"and log rings bit-identical")

    def timed_blocks(run, carry, gen, n):
        stats, block_s = [], []
        for _ in range(n):
            t0 = time.perf_counter()
            carry, s = run(carry, gen)
            torch.cuda.synchronize()
            block_s.append(time.perf_counter() - t0)
            stats.append(s)
        return carry, stats, block_s

    def report(label, stats, block_s, committed_col):
        timed = torch.cat(stats[1:]).cpu().numpy().astype(np.int64)
        secs = float(sum(block_s[1:]))
        committed = int(timed[:, committed_col].sum())
        rec = {"ms_per_block": secs / len(block_s[1:]) * 1e3,
               "committed_per_s": committed / secs,
               "block_ms": [b * 1e3 for b in block_s]}
        print(f"  {label}: {rec['ms_per_block']:.3f} ms/block "
              f"({GEN_CPB} cohorts x w={GEN_W}), committed "
              f"{rec['committed_per_s']:.1f} txn/s; blocks (warm first) "
              f"{[round(b, 3) for b in rec['block_ms']]} ms  [{card}]")
        return rec

    run, init, drain = tp.build_pipelined_runner(
        GEN_N_SUB, w=GEN_W, val_words=VW, cohorts_per_block=GEN_CPB,
        device=dev)
    gen = torch.Generator(device=dev).manual_seed(21)
    carry, stats, block_s = timed_blocks(run, init(shards), gen,
                                         GEN_TATP_BLOCKS + 1)
    shards, tail = drain(carry)
    torch.cuda.synchronize()
    total = torch.cat(stats + [tail]).cpu().numpy().astype(np.int64).sum(0)
    print(f"  stats total (blocks + drain): {total.tolist()}")
    out["tatp pipelined"] = report("TATP build_pipelined_runner", stats,
                                   block_s, tp.STAT_COMMITTED)
    tatp_checks("TATP pipelined + drain", shards, total, GEN_TATP_BLOCKS + 1)
    ser = tp.build_runner(GEN_N_SUB, w=GEN_W, val_words=VW,
                          cohorts_per_block=GEN_CPB, validate=True,
                          device=dev)
    t0 = time.perf_counter()
    shards, s = ser(shards, gen)
    torch.cuda.synchronize()
    ser_s = time.perf_counter() - t0
    total = s.cpu().numpy().astype(np.int64).sum(0)
    print(f"  TATP build_runner(validate=True): one block {ser_s * 1e3:.3f} "
          f"ms, committed {int(total[tp.STAT_COMMITTED]) / ser_s:.1f} txn/s, "
          f"stats {total.tolist()}  [{card}]")
    out["tatp serial"] = {"ms_per_block": ser_s * 1e3,
                          "committed_per_s":
                          int(total[tp.STAT_COMMITTED]) / ser_s}
    tatp_checks("TATP build_runner(validate=True)", shards, total, 1)
    check(int(total[tp.STAT_AB_VALIDATE]) == 0,
          "serial cohorts: ab_validate == 0")
    del carry, run, init, drain, ser     # the replicas go on to phase 12
    torch.cuda.empty_cache()

    # ---- generic SmallBank: 3 replicas, built on the card
    stacked = sp.create_stacked(GEN_SB_N, device=dev)
    base = [int(sp.total_balance(stacked, r)) for r in range(3)]
    run = sp.build_runner(GEN_SB_N, w=GEN_W, cohorts_per_block=GEN_CPB,
                          device=dev)
    gen = torch.Generator(device=dev).manual_seed(22)
    stacked, stats, block_s = timed_blocks(run, stacked, gen,
                                           GEN_SB_BLOCKS + 1)
    total = torch.cat(stats).cpu().numpy().astype(np.int64).sum(0)
    out["smallbank"] = report("SmallBank build_runner", stats, block_s,
                              sp.STAT_COMMITTED)
    attempted = int(total[sp.STAT_ATTEMPTED])
    print(f"  stats total: {total.tolist()}; abort rate "
          f"{1 - int(total[sp.STAT_COMMITTED]) / attempted:.6f}")
    check(attempted == (GEN_SB_BLOCKS + 1) * GEN_CPB * GEN_W
          and int(total[sp.STAT_COMMITTED] + total[sp.STAT_AB_LOCK]
                  + total[sp.STAT_AB_LOGIC]) == attempted
          and int(total[sp.STAT_MAGIC_BAD]) == 0,
          "SmallBank: accounting closes, magic_bad == 0")
    deltas = [(int(sp.total_balance(stacked, r)) - base[r]) % (1 << 32)
              for r in range(3)]
    check(all(d == int(total[sp.STAT_BAL_DELTA]) % (1 << 32)
              for d in deltas),
          f"SmallBank: each replica's total_balance delta == the stats' "
          f"balance delta mod 2^32 ({deltas[0]})")
    check(_replicas_identical(stacked)
          and not any(bool(lk.any()) for s in stacked for lk in
                      (s.sav_sh, s.sav_ex, s.chk_sh, s.chk_ex)),
          "SmallBank: the three replicas identical, every lock released")
    del stacked, run
    shards = _p11_monitored(dev, tp, sp, shards)
    torch.cuda.synchronize()
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t_phase
    print(f"  phase 11 kernel launches: {launches}")
    check(not any(launches.values()),
          "phase 11 launches none of the nine kernels (the generic engines "
          "reach no TPU kernel)")
    print(f"  phase 11 max_memory_allocated: {peak:,} B; seconds: "
          f"{secs:.3f}; populate {pop_s:.3f} s  [{card}]")
    out["peak_bytes"] = peak
    out["seconds"] = secs
    print("  generic: " + json.dumps(out))
    return launches, shards, pop_s


# ------------------------------------------------- coordinators and serving


def _heads(shards):
    from dint_tpu_torch.ops.u32 import to_u64
    return [int(to_u64(s.log.head).sum()) for s in shards]


def _cohorts(label, co, step, card, min_cohorts=CO_COHORTS,
             window_s=CO_WINDOW_S, after=None):
    """Cohorts of ``step()`` until at least ``min_cohorts`` ran and
    ``window_s`` passed; ``after(i)`` checks each. Returns (stats delta,
    seconds, per-cohort ms)."""
    import dataclasses
    s0 = dataclasses.asdict(co.stats)
    ms = []
    t_all = time.perf_counter()
    while len(ms) < min_cohorts or time.perf_counter() - t_all < window_s:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if after is not None:
            after(len(ms) - 1)
    secs = sum(ms) / 1e3
    d = {k: v - s0[k] for k, v in dataclasses.asdict(co.stats).items()}
    aborts = {k: v for k, v in d.items() if k.startswith("aborted_")}
    print(f"  {label}: {len(ms)} cohorts, committed "
          f"{d['committed'] / secs:.1f} txn/s ({d['committed']:,} of "
          f"{d['attempted']:,}), abort mix {aborts}; ms a cohort "
          f"{[round(m, 3) for m in ms]}  [{card}]")
    return d, secs, ms


def phase_coordinators(dev, card, shards, pop_s):
    print(f"== phase 12: the host coordinators: TATP over phase 11's three "
          f"replicas ({GEN_N_SUB:,} subscribers, VW={VW}), cohorts of "
          f"{CO_TATP_COHORT}, and SmallBank over init_shards at "
          f"{CO_SB_N:,} accounts, cohorts of {CO_SB_COHORT} at 90/4 skew; "
          f"width {CO_W}")
    from dint_tpu_torch.clients import smallbank_client as sbc
    from dint_tpu_torch.clients import tatp_client as tc
    from dint_tpu_torch.clients import workloads as wl
    from dint_tpu_torch.engines import smallbank
    from dint_tpu_torch.engines.types import Op
    from dint_tpu_torch.tables import locks
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    out = {}

    def tatp_locks_free(ss):
        return not any(bool(lk.any()) for s in ss
                       for _, lk in s.dense_tables()) \
            and not any(bool(s.cf_lock.locked.any()) for s in ss)

    # ---- TATP: the plain CF lock table, then an attributing one
    check(_replicas_identical(shards) and tatp_locks_free(shards),
          "phase 11's three replicas identical, no lock held")
    print(f"  populate_shards: {pop_s:.3f} s (phase 11's)")
    co = tc.Coordinator(shards, GEN_N_SUB, width=CO_W, val_words=VW,
                        device=dev)
    rng = np.random.default_rng(12)

    def tatp_after(i):
        h = _heads(co.shards)
        check(h[0] == h[1] == h[2] and tatp_locks_free(co.shards),
              f"TATP cohort {i}: no lock held, log heads equal ({h[0]:,})",
              quiet=i > 0)
    d, secs, ms = _cohorts("TATP Coordinator", co,
                           lambda: co.run_cohort(rng, CO_TATP_COHORT), card,
                           after=tatp_after)
    check(d["committed"] + d["aborted_lock"] + d["aborted_validate"]
          + d["aborted_missing"] + d["aborted_timeout"] == d["attempted"]
          == len(ms) * CO_TATP_COHORT and d["committed"] > 0
          and d["aborted_timeout"] == 0,
          "TATP: accounting closes on this phase's deltas (committed + "
          "aborted_* == attempted)")
    check(d["lock_cnt"] == d["reject_sharing_cnt"]
          == d["reject_same_key_cnt"] == 0,
          "TATP: the attribution counters stay 0 on plain shards")
    check(_replicas_identical(co.shards),
          "TATP: the three replicas' tables, locks and log rings "
          "bit-identical")
    out["tatp"] = {"committed_per_s": d["committed"] / secs,
                   "ms_per_cohort": secs * 1e3 / len(ms),
                   "cohorts": len(ms), "stats": d}
    # an attributing CF lock table in place of the plain one: no lock is
    # held and the plain table's versions are all 0 (no TATP op sends
    # COMMIT_VER), so each replica is what populate_shards(attr_locks=True)
    # gives with this history
    check(all(int(s.cf_lock.ver.abs().sum()) == 0 for s in co.shards),
          "TATP: the plain CF lock versions are all 0")
    for s in co.shards:
        s.cf_lock = locks.create_occ_attr(s.cf_lock.n_slots, dev)
    ca = tc.Coordinator(co.shards, GEN_N_SUB, width=CO_W, val_words=VW,
                        device=dev)
    check(ca.attr, "the attr coordinator sees OCCAttrTable shards")
    d, secs, ms = _cohorts("TATP Coordinator, attr shards", ca,
                           lambda: ca.run_cohort(rng, CO_TATP_COHORT), card,
                           min_cohorts=1, window_s=0.0)
    check(d["committed"] + d["aborted_lock"] + d["aborted_validate"]
          + d["aborted_missing"] == d["attempted"] == CO_TATP_COHORT
          and d["lock_cnt"] > 0 and d["reject_same_key_cnt"]
          + d["reject_sharing_cnt"] <= d["lock_cnt"]
          and tatp_locks_free(ca.shards) and _replicas_identical(ca.shards),
          f"TATP attr cohort: accounting closes, lock_cnt {d['lock_cnt']} "
          f">= same-key {d['reject_same_key_cnt']} + sharing "
          f"{d['reject_sharing_cnt']}, no lock held, replicas identical")
    out["tatp_attr"] = {"stats": d, "ms": ms[0]}
    replicas = list(ca.shards)      # phase 14 (b) serves them
    del co, ca, shards
    gc.collect()
    torch.cuda.empty_cache()

    # ---- SmallBank
    t0 = time.perf_counter()
    sb = sbc.init_shards(CO_SB_N, device=dev)
    torch.cuda.synchronize()
    sb_pop_s = time.perf_counter() - t0
    print(f"  init_shards: {sb_pop_s:.3f} s")
    check(_replicas_identical(sb), "SmallBank: the three replicas populate "
          "identically")
    co = sbc.Coordinator(sb, width=CO_W, device=dev)
    # the committed deltas: each cohort's new balances less the balances
    # replica 0 held before its first commit wave (one write a
    # (table, account) a cohort, under its X lock)
    deltas = []
    wave = co._run_wave_explicit

    def spy(ops, tbls, accts, shard_of, vals=None, vers=None):
        if len(ops) and int(ops[0]) == Op.COMMIT_LOG and \
                int(shard_of[0]) == 0:
            s0 = co.shards[0]
            a = torch.from_numpy(accts.astype(np.int64)).to(dev) * sbc.VW
            is_sav = torch.from_numpy(tbls == smallbank.SAVINGS).to(dev)
            old = torch.where(is_sav, s0.sav.val[a], s0.chk.val[a])
            new = vals[:, 0].astype(np.uint32).view(np.int32)
            deltas.append(int(new.astype(np.int64).sum())
                          - int(old.to(torch.int64).sum()))
        return wave(ops, tbls, accts, shard_of, vals, vers)
    co._run_wave_explicit = spy
    rng = np.random.default_rng(13)
    bal = [sbc.total_balance(co.shards)]

    def sb_cohort():
        deltas.append(0)
        co.run_cohort(*wl.sb_make_txns(rng, CO_SB_COHORT, CO_SB_N))

    def sb_after(i):
        bal.append(sbc.total_balance(co.shards))
        h = _heads(co.shards)
        free = all(int(x.abs().sum()) == 0 for s in co.shards
                   for x in (s.sav_sh, s.sav_ex, s.chk_sh, s.chk_ex))
        check(bal[-1] - bal[-2] == sum(deltas) and free
              and h[0] == h[1] == h[2],
              f"SmallBank cohort {i}: total_balance moved by the committed "
              f"deltas ({bal[-1] - bal[-2]:+,}), every lock released, log "
              f"heads equal", quiet=i > 0)
        deltas.clear()
    d, secs, ms = _cohorts("SmallBank Coordinator", co, sb_cohort, card,
                           after=sb_after)
    check(d["committed"] + d["aborted_lock"] + d["aborted_logic"]
          == d["attempted"] == len(ms) * CO_SB_COHORT
          and d["committed"] > 0,
          "SmallBank: accounting closes on this phase's deltas (committed "
          "+ aborted_lock + aborted_logic == attempted)")
    check(_replicas_identical(co.shards),
          "SmallBank: the three replicas' tables, locks and log rings "
          "bit-identical")
    out["smallbank"] = {"committed_per_s": d["committed"] / secs,
                        "ms_per_cohort": secs * 1e3 / len(ms),
                        "cohorts": len(ms), "stats": d,
                        "init_shards_s": sb_pop_s,
                        "balance_moved": bal[-1] - bal[0]}
    del co, sb
    gc.collect()
    torch.cuda.empty_cache()
    launches = launch_counts()
    secs = time.perf_counter() - t_phase
    print(f"  phase 12 kernel launches: {launches}")
    check(not any(launches.values()),
          "phase 12 launches none of the nine kernels")
    print(f"  phase 12 max_memory_allocated: "
          f"{torch.cuda.max_memory_allocated(dev):,} B; seconds: "
          f"{secs:.3f}  [{card}]")
    out["seconds"] = secs
    print("  coordinators: " + json.dumps(out))
    return {"coordinators": launches}, replicas


SV_TATP_N_SUB = 1_000_000        # tatp_dense's subscribers (a numpy
                                 # populate: 7M ~35 s); 7M's serving plane
                                 # runs in the bench's probe and 16 (e), (f)
# per family: (size, engine kw, kernels a step, drain steps)
SERVE_FAMILIES = {
    "tatp_dense": (SV_TATP_N_SUB, {"val_words": VW},
                   TATP_PER_STEP["default"], 2),
    "smallbank_dense": (SB_N, {}, SB_PER_STEP["default"], 1),
    "store": (ST_N, {"val_words": VW, "runner_kw": SV_STORE_KW},
              {"scan_rows": 1}, 0),
}
# the counters that mirror each family's stats columns (tatp_dense and
# smallbank_dense STAT_* layout)
SERVE_STAT_COUNTERS = {
    "tatp_dense": ("txn_attempted", "txn_committed", "ab_lock",
                   "ab_missing", "ab_validate", "magic_bad"),
    "smallbank_dense": ("txn_attempted", "txn_committed", "ab_lock",
                        "ab_logic", "magic_bad"),
    "store": (),
}


def phase_serve(dev, card):
    print(f"== phase 13: the serving plane: ServeEngine over tatp_dense "
          f"({SV_TATP_N_SUB:,} subscribers, VW={VW}), smallbank_dense "
          f"({SB_N:,} accounts) and the store ({ST_N:,} keys, YCSB-E scans), "
          f"plan='auto', {SV_CPB} cohorts a block, a RealClock; then the "
          f"bench's serve probe")
    from dint_tpu_torch import bench, serve
    from dint_tpu_torch import plan as dplan
    from dint_tpu_torch.clients.tatp_client import clone_tree
    t_phase = time.perf_counter()
    paths, out = {}, {}

    class Probe(serve.ServeEngine):
        """A ServeEngine that times its populate and notes the memory
        held after each dispatch and its drains."""

        def __init__(self, *a, **kw):
            self.mem, self.detaches = [], 0
            super().__init__(*a, **kw)

        def _fresh_db(self, seed):
            t0 = time.perf_counter()
            db = super()._fresh_db(seed)
            torch.cuda.synchronize()
            self.fresh_db_s = time.perf_counter() - t0
            return db

        def _dispatch(self, occ, shed0):
            super()._dispatch(occ, shed0)
            self.mem.append((self._cur_w,
                             torch.cuda.memory_allocated(dev)))

        def _detach(self):
            self.detaches += 1
            super()._detach()

    for fam, (size, kw, per_step, drain_steps) in SERVE_FAMILIES.items():
        torch.cuda.empty_cache()
        eng = Probe(fam, size, cohorts_per_block=SV_CPB,
                    clock=serve.RealClock(), monitor=True, plan="auto",
                    device=dev, **kw)
        before = clone_tree(eng._db)
        t0 = time.perf_counter()
        eng.warmup()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        check(_replicas_identical([before, eng._db]),
              f"{fam}: the live tables bit-identical before and after "
              f"warmup ({len(eng.cfg.widths)} widths)")
        del before
        torch.cuda.empty_cache()
        rate = 0.5 * CLOSED_LOOP_RATE[fam]
        top = eng.cfg.widths[-1]
        sched = np.sort(np.concatenate([
            serve.poisson_schedule(rate, SV_WINDOW_S, seed=13),
            np.full(4 * top, SV_WINDOW_S / 2)]))
        reset_launches()
        t0 = time.perf_counter()
        eng.run(sched)
        eng.close()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = launch_counts()
        rep = eng.snapshot()
        c = rep["counters"]
        keep_counters(f"serve {fam}", c)
        serve_steps = sum(rep["steps_by_width"].values())
        steps = serve_steps + drain_steps * eng.detaches
        served = sum(int(w) * n for w, n in rep["steps_by_width"].items())
        visited = sorted(int(w) for w, n in rep["steps_by_width"].items()
                         if n)
        print(f"  {fam}: offered {rep['offered_rate']:.1f}/s (Poisson at "
              f"{rate:.1f}/s for {SV_WINDOW_S} s + a burst of {4 * top}), "
              f"achieved {rep['achieved_rate']:.1f} committed/s; queue p50 "
              f"{rep['queue']['p50']:.1f} p99 {rep['queue']['p99']:.1f} us; "
              f"service p50 {rep['service']['p50']:.1f} p99 "
              f"{rep['service']['p99']:.1f} us a block; widths "
              f"{rep['steps_by_width']} (steps), switches "
              f"{rep['controller']['switches']}; shed {rep['shed']:,} of "
              f"{rep['offered']:,}; blocks {rep['blocks']}, run {secs:.3f} "
              f"s; warmup {warm_s:.3f} s, _fresh_db {eng.fresh_db_s:.3f} s "
              f"[{card}]")
        svc = {w: round(v, 3)
               for w, v in rep["controller"]["service_us"].items()}
        print(f"    observed service us a step by width: {svc}; slo_met "
              f"{rep['slo_met']}")
        check(rep["offered"] == len(sched) == rep["admitted"] + rep["shed"]
              and c["serve_shed_lanes"] == rep["shed"]
              and c["serve_occupancy_lanes"] == rep["admitted"]
              == rep["attempted"]
              and c["serve_padded_lanes"] == served - rep["admitted"],
              f"{fam}: admitted + shed == offered, serve_shed_lanes == shed, "
              f"padded lanes == sum(cpb * w) - sum(occ) "
              f"({c['serve_padded_lanes']:,})")
        st = eng.stats_total
        check(all(c[name] == int(st[col]) for col, name in
                  enumerate(SERVE_STAT_COUNTERS[fam]))
              and c["steps"] == steps and c["dispatch_xla"] == 0
              and c["dispatch_pallas"] == (serve_steps if fam == "store"
                                           else steps),
              f"{fam}: the counters equal the stats' columns "
              f"{SERVE_STAT_COUNTERS[fam]} and the steps ({steps})")
        if fam != "store":
            check(int(st[SERVE_STAT_COUNTERS[fam].index("magic_bad")]) == 0,
                  f"{fam}: magic_bad == 0")
        stints, steady = [], []
        for w, m in eng.mem:
            if stints and stints[-1][0] == w:
                stints[-1][1].append(m)
            else:
                stints.append((w, [m]))
        for w, ms in stints:
            if len(ms) >= 3:
                steady.append((w, ms[2:]))
        check(steady and all(len(set(ms)) == 1 for _, ms in steady),
              f"{fam}: memory_allocated constant over the steady blocks at "
              f"one width ({[(w, len(ms), ms[0]) for w, ms in steady]})")
        want = dict.fromkeys(launches, 0)
        want.update({k: n * steps for k, n in per_step.items()})
        check(launches == want,
              f"{fam}: {per_step} a step over {steps} steps "
              f"({ {k: v for k, v in launches.items() if v} })")
        # the plan's priors: where no width meets the service bound
        # (slo_fraction x SLO), the controller serves at their knee from
        # the first block and never switches (the card's priors)
        knee = None
        if fam in dplan.SERVE_WORKLOADS:
            pri = dplan.load_plan()["workloads"][
                dplan.SERVE_WORKLOADS[fam]]["serve"]
            bound = eng.cfg.slo_fraction * eng.cfg.slo_us
            if all(v["service_us"] > bound for v in pri["widths"].values()):
                knee = pri["knee_width"]
        first = rep["controller"]["switches"][0][1]
        check(rep["shed"] > 0
              and (first == knee if knee else len(visited) >= 2),
              f"{fam}: " + (f"no width of the plan's priors meets the "
                            f"service bound: served at their knee {knee} "
                            f"from the first block ({first}; widths "
                            f"{visited} as the observed service moved)"
                            if knee else "the burst forced a width switch "
                            f"({visited})")
              + f", and shed {rep['shed']:,}")
        paths[f"serve {fam}"] = launches
        out[fam] = {k: rep[k] for k in (
            "offered", "admitted", "shed", "attempted", "committed",
            "blocks", "steps_by_width", "offered_rate", "achieved_rate",
            "slo_met", "elapsed_s")}
        out[fam].update(queue={k: rep["queue"][k] for k in ("p50", "p99")},
                        service={k: rep["service"][k]
                                 for k in ("p50", "p99")},
                        service_us=rep["controller"]["service_us"],
                        warmup_s=warm_s, fresh_db_s=eng.fresh_db_s,
                        run_s=secs)
        del eng
        gc.collect()

    # the bench's serve probe at the bench's shapes
    torch.cuda.empty_cache()
    k = bench.Knobs()
    t0 = time.perf_counter()
    probe = bench.serve_probe(k, dev)
    secs = time.perf_counter() - t0
    print("  bench serve probe: " + json.dumps(
        {key: v for key, v in probe.items()
         if key not in ("queue", "service", "controller")}, default=str)
        + f"; queue p99 {probe['queue']['p99']:.1f} us, service p99 "
        f"{probe['service']['p99']:.1f} us; {secs:.3f} s  [{card}]")
    check(tuple(probe) == bench.SERVE_KEYS and len(probe) == 11
          and probe["offered"] == probe["admitted"] + probe["shed"]
          == k.width * k.block * 8 and probe["blocks"] > 0
          and probe["controller"]["width"] == k.width,
          f"the bench's serve probe ({k.n_subscribers:,} subscribers, "
          f"w={k.width}, {k.block} cohorts a block): its eleven keys, "
          f"admitted + shed == offered")
    out["bench_probe"] = {"admitted": probe["admitted"],
                          "shed": probe["shed"], "blocks": probe["blocks"],
                          "achieved_rate": probe["achieved_rate"],
                          "seconds": secs}
    secs = time.perf_counter() - t_phase
    print(f"  phase 13 seconds: {secs:.3f}  [{card}]")
    out["seconds"] = secs
    print("  serving: " + json.dumps(out, default=str))
    return paths


# ------------------------------------------------------------ the wire plane


WIRE_W = 64                  # (a): the stub pumps' width
WIRE_SIZES = (WIRE_W, 1, 23, 40, WIRE_W - 1, 17, WIRE_W)
WT_W = 8192                  # (b): the TATP pumps' width
WT_FLUSH_US = 500
WT_SOCKS = 8                 # sockets a shard (exp.py's tatp_wire_txn)
WT_COHORT = 2048             # tatp/caladan/tatp.h:28's scale, as phase 12
WT_COHORTS = 3               # at least, and at least WT_WINDOW_S
WT_WINDOW_S = 3.0
WS_N = 24_000_000            # (c): the reference store's keyspace
WS_W = 4096
WS_CLIENTS = 2
WS_WINDOW_S = 3.0
WS_TIMEOUT_MS = 2000         # a lost reply costs one exchange this much
MICRO_WINDOW_S = 1.0         # (d): sweep_micro's window
MICRO_POINTS = ("store_zipf_w4096", "store_scan_f95", "lock_2pl",
                "lock_fasst", "log_server", "store_wire", "tatp_wire",
                "tatp_wire_txn", "tatp_colocate_c1", "store_cached_wb_bloom")


class StubServer:
    """ShimServer's stand-in for phase 14 (a): `poll` hands out scripted
    batches as views of a ring slot, `reply` records the replies and then
    scribbles over the slot, as the C++ ring reuses it; an empty script
    stops the pump."""

    def __init__(self, port=0, width=4096, flush_us=200, nrings=8, fmt=0,
                 ip="127.0.0.1"):
        self.width, self.port = width, 0
        self.script, self.replies = [], []
        self.pump, self._slots, self._next = None, {}, 0

    def poll(self, timeout_us=100_000):
        if not self.script:
            if self.pump is not None:
                self.pump._stop.set()
            return None
        b = self.script.pop(0)
        slot = self._next % 8
        self._next += 1
        if len(b["key"]) > self.width or slot in self._slots:
            raise SmokeFailure("stub server: a batch wider than the pump, "
                               "or a ring slot reused before its reply")
        self._slots[slot] = {k: v.copy() for k, v in b.items()}
        return slot, dict(self._slots[slot])

    def reply(self, slot, rtype, rval=None, rver=None):
        ring = self._slots.pop(slot)
        n = len(ring["key"])
        if len(rtype) != n or np.shape(rval) != (n, 40) or len(rver) != n:
            raise SmokeFailure(f"stub server: {len(rtype)} replies for a "
                               f"batch of {n}")
        self.replies.append((np.array(rtype, np.uint8),
                             np.array(rval, np.uint8),
                             np.array(rver, np.uint32)))
        for v in ring.values():
            v.view(np.uint8)[...] = 0xA5
        return len(rtype)

    def stats(self):
        return {"pkts_rx": 0, "pkts_tx": 0, "batches": 0, "dropped": 0}


def _wire_batch(rng, fmt, types, keys, tables=None, vers=None, ver_hi=8):
    """A polled batch as the C++ pump fills it for ``fmt``."""
    from dint_tpu_torch.shim import native
    n = len(types)
    b = {"ord": np.arange(n, dtype=np.uint8),
         "type": np.asarray(types, np.uint8),
         "table": np.zeros(n, np.uint8) if tables is None
         else np.asarray(tables, np.uint8),
         "key": np.asarray(keys, np.uint64),
         "val": rng.integers(0, 256, (n, native.VAL_SIZE)).astype(np.uint8),
         "ver": (rng.integers(0, ver_hi, n) if vers is None
                 else np.asarray(vers)).astype(np.uint32)}
    if fmt in (native.FMT_LOCK6, native.FMT_FASST9):
        b["val"][:] = 0
        b["table" if fmt == native.FMT_FASST9 else "ver"][:] = 0
    if fmt != native.FMT_MSG55:
        b["ord"][:] = 0
        if fmt == native.FMT_LOG53:
            b["table"][:] = 0
    return b


def wire_script(name, fmt, seed):
    """Batches of the profile's codes and unknown ones (63, 200, ...) over
    few keys (same-key lanes), full-width ones among them, then a read
    followed at once by a batch that writes what it read."""
    from dint_tpu_torch.engines import tatp
    rng = np.random.default_rng(seed)
    codes = {"store": [0, 1, 2, 0, 1, 3, 63, 200],
             "lock_2pl": [0, 0, 1, 1, 5, 77],
             "lock_fasst": [0, 1, 2, 3, 1, 9],
             "log_server": [0, 0, 0, 1, 250],
             "smallbank": [0, 1, 2, 3, 4, 5, 6, 7, 40],
             "tatp": [0, 0, 1, 2, 12, 13, 14, 18, 19, 22, 23, 24, 3, 60,
                      255]}[name]
    out = []
    for n in WIRE_SIZES:
        t = rng.choice(codes, n)
        if name == "tatp":
            tbl = rng.integers(0, 5, n)
            sid, typ = rng.integers(1, 21, n), rng.integers(1, 5, n)
            keys = np.where(tbl <= tatp.SEC_SUBSCRIBER, sid,
                            sid * 4 + typ - 1)
            keys = np.where(tbl == tatp.CALL_FORWARDING,
                            tatp.cf_key(rng.integers(1, 9, n), typ,
                                        8 * rng.integers(0, 3, n)), keys)
        elif name == "log_server":
            tbl, keys = None, rng.integers(0, 1 << 63, n)
        else:
            tbl = rng.integers(0, 2 if name != "store" else 3, n)
            keys = rng.integers(1 if name == "store" else 0,
                                25 if name == "store" else 16, n)
        out.append(_wire_batch(rng, fmt, t, keys, tbl))
    k, z, o = np.arange(100, 108), np.zeros(8), np.ones(8)
    one = functools.partial(_wire_batch, rng, fmt)
    deps = {"store": [(np.full(8, 2), k), (z, k), (o, k)],
            "lock_2pl": [(z, k, o), (o, k, o)],
            "lock_fasst": [(o, k), (z, k), (np.full(8, 3), k)],
            "log_server": [(z, k), (z, k)],
            "smallbank": [(o, k - 60, z),
                          (np.full(8, 4), k - 60, z, np.full(8, 9))],
            "tatp": [(o, k - 70, z), (z, k - 70, z),
                     (np.full(8, 12), k - 70, z, np.full(8, 9))]}[name]
    return out + [one(*d) for d in deps]


def wire_states(name, dev):
    """The profile's step, value words and a small starting state on the
    CPU and its copy on ``dev``."""
    from dint_tpu_torch import convert
    from dint_tpu_torch.clients import tatp_client as tc
    from dint_tpu_torch.engines import (fasst, lock2pl, logsrv, smallbank,
                                        store, tatp)
    from dint_tpu_torch.ops.u32 import from_numpy
    from dint_tpu_torch.tables import kv, locks
    from dint_tpu_torch.tables import log as plog
    rng = np.random.default_rng(7)
    cpu = torch.device("cpu")
    if name == "store":
        vals = rng.integers(0, 1 << 32, (40, 10), dtype=np.uint64)
        s = kv.populate(kv.create(1 << 5, val_words=10, device=cpu),
                        np.arange(1, 41, dtype=np.uint64),
                        vals.astype(np.uint32))
        step, vw, back = store.step, 10, convert.kv_table_from_numpy
    elif name == "lock_2pl":
        s, step, vw = locks.create_sx(1 << 4, cpu), lock2pl.step, 10
        back = convert.sx_lock_table_from_numpy
    elif name == "lock_fasst":
        s, step, vw = locks.create_occ(1 << 6, cpu), fasst.step, 10
        back = convert.occ_table_from_numpy
    elif name == "log_server":
        s, step, vw = plog.create(4, 1 << 6, 10, cpu), logsrv.step, 10
        back = convert.log_ring_from_numpy
    elif name == "smallbank":
        s = smallbank.create(64, val_words=2, log_lanes=4,
                             log_capacity=1 << 8, device=cpu)
        s.sav.val = from_numpy(rng.integers(0, 1 << 32, 128,
                                            dtype=np.uint64)
                               .astype(np.uint32), cpu)
        s.sav.ver.fill_(1)
        s.chk.ver.fill_(1)
        step, vw, back = smallbank.step, 2, convert.smallbank_shard_from_numpy
    else:
        s = tc.populate_shards(np.random.default_rng(0), 40, val_words=10,
                               log_lanes=4, log_capacity=1 << 8,
                               device=cpu)[0][0]
        step, vw, back = tatp.step, 10, convert.tatp_shard_from_numpy
    return step, vw, s, back(convert.tree_to_numpy(s), dev)


def stub_pump(profile, step, state, vw, device, depth=1):
    """An EnginePump whose server is a StubServer."""
    from dint_tpu_torch.shim import pump as pump_mod
    real = pump_mod.ShimServer
    pump_mod.ShimServer = StubServer
    try:
        p = pump_mod.EnginePump(profile, step, state, width=WIRE_W,
                                val_words=vw, depth=depth, device=device)
    finally:
        pump_mod.ShimServer = real
    p.server.pump = p
    return p


def _same_wire(a, b):
    return len(a) == len(b) and all(
        np.array_equal(u, v) for x, y in zip(a, b) for u, v in zip(x, y))


def phase_wire_cpu_vs_card(dev, card):
    print(f"== phase 14 (a): the wire plane, CPU pump against card pump on "
          f"the six profiles, stub server, w={WIRE_W}, "
          f"{len(WIRE_SIZES) + 2}-{len(WIRE_SIZES) + 3} batches each; then "
          f"one loopback round "
          f"trip a profile")
    from dint_tpu_torch.shim import PROFILES, EnginePump, ShimClient
    t_phase = time.perf_counter()
    reset_launches()
    for name, prof in PROFILES.items():
        step, vw, cpu_state, card_state = wire_states(name, dev)
        script = wire_script(name, prof.fmt, seed=len(name))
        runs = {}
        for label, state, device, depth in (
                ("cpu", cpu_state, "cpu", None),
                ("card", card_state, dev, None),
                ("card depth 2", wire_states(name, dev)[3], dev, 2)):
            p = stub_pump(prof, step, state, vw, device, depth or 1)
            p.server.script = list(script)
            if depth is None:
                while p.server.script:
                    p.serve_one(0)
            else:
                p.serve_forever()
            torch.cuda.synchronize()
            runs[label] = p
        ref = runs["cpu"]
        snap = ref.latency_snapshot()
        check(all(_same_wire(ref.server.replies, r.server.replies)
                  and _same_tree(ref.state, r.state)
                  for r in runs.values())
              and snap["batches"] == len(script)
              and snap["occupancy_lanes"] + snap["padded_lanes"]
              == WIRE_W * len(script)
              and all(r.latency_snapshot()["occupancy_lanes"]
                      == snap["occupancy_lanes"] for r in runs.values()),
              f"{name}: {len(script)} batches ({snap['occupancy_lanes']} "
              f"lanes), wire replies (type, val bytes, ver) and final state "
              f"bit-identical on the CPU, the card and the card at depth 2 "
              f"(batch i+1 writes what batch i read)")
        # one loopback round trip a profile: distinct keys, the CPU and
        # card pumps from their (equal) states after the script
        rng = np.random.default_rng(3)
        n = 16
        keys = np.arange(200, 200 + n, dtype=np.uint64)
        if name in ("smallbank", "tatp"):
            keys = np.arange(48, 48 + n, dtype=np.uint64) % (
                64 if name == "smallbank" else 41)
            keys = np.unique(keys)
            n = len(keys)
        types = np.zeros(n, np.uint8)
        got = {}
        for label in ("cpu", "card"):
            r = runs[label]
            with EnginePump(prof, step, r.state, width=WIRE_W, val_words=vw,
                            flush_us=2000, device=r.device).start() as p:
                with ShimClient("127.0.0.1", p.port, fmt=prof.fmt) as c:
                    out = c.exchange(types, keys,
                                     vals=rng.integers(0, 256, (n, 40)),
                                     timeout_ms=20_000)
            order = np.argsort(out["key"], kind="stable")
            got[label] = {k: out[k][order] for k in ("type", "val", "ver",
                                                      "key")}
            got[label]["n"] = out["n"]
        check(got["card"]["n"] == n and all(
                  np.array_equal(got["cpu"][k], got["card"][k])
                  for k in ("type", "val", "ver", "key"))
              and not (got["card"]["type"] == 255).any(),
              f"{name}: a loopback round trip of {n} requests on the card "
              f"pump, every reply defined and equal to the CPU pump's",
              quiet=False)
    launches = launch_counts()
    print(f"  phase 14 (a) kernel launches: {launches}; seconds: "
          f"{time.perf_counter() - t_phase:.3f}  [{card}]")
    return launches


def _pump_report(pumps):
    out = []
    for p in pumps:
        s = p.latency_snapshot()
        out.append({k: s[k] for k in ("batches", "width", "depth",
                                      "occupancy_lanes", "padded_lanes",
                                      "shed")}
                   | {side: {k: s[side][k] for k in ("p50_us", "p99_us")}
                      for side in ("queue", "service")})
    return out


def _log_since(shard, heads):
    """The log entries a shard appended since its per-lane ``heads``, as
    rows sorted on the host (the order of arrival taken out)."""
    from dint_tpu_torch.ops.u32 import to_u64
    ring = shard.log
    rows = [ring.entries[lane, torch.arange(h0, h1, device=ring.head.device)
                         % ring.capacity]
            for lane, (h0, h1) in enumerate(zip(heads,
                                                to_u64(ring.head).tolist()))]
    a = torch.cat(rows).cpu().numpy()
    return a[np.lexsort(a.T[::-1])]


def phase_wire_tatp(dev, card, shards):
    print(f"== phase 14 (b): TATP over the wire at {GEN_N_SUB:,} "
          f"subscribers: three card pumps (tatp.step, w={WT_W}, flush "
          f"{WT_FLUSH_US} us) over phase 11's replicas after phase 12, a "
          f"WireCoordinator with {WT_SOCKS} sockets a shard, cohorts of "
          f"{WT_COHORT}")
    import dataclasses
    from dint_tpu_torch.clients import tatp_wire as tw
    from dint_tpu_torch.engines import tatp
    from dint_tpu_torch.ops.u32 import to_u64
    from dint_tpu_torch.shim import TATP, EnginePump
    t_phase = time.perf_counter()
    reset_launches()

    def locks_free(ss):
        return not any(bool(lk.any()) for s in ss
                       for _, lk in s.dense_tables()) \
            and not any(bool(s.cf_lock.locked.any()) for s in ss)

    check(_replicas_identical(shards) and locks_free(shards),
          "phase 12's three replicas identical, no lock held")
    heads0 = [to_u64(s.log.head).tolist() for s in shards]
    pumps = []
    try:
        for s in shards:
            pumps.append(EnginePump(TATP, tatp.step, s, width=WT_W,
                                    flush_us=WT_FLUSH_US, val_words=VW,
                                    device=dev).start())
        with tw.WireCoordinator([p.port for p in pumps], GEN_N_SUB,
                                width=WT_W, val_words=VW,
                                n_socks=WT_SOCKS) as co:
            rng = np.random.default_rng(14)
            t0 = time.perf_counter()
            co.run_cohort(rng, WT_COHORT)
            warm_ms = (time.perf_counter() - t0) * 1e3
            print(f"  warm cohort: {warm_ms:.3f} ms, stats "
                  f"{dataclasses.asdict(co.stats)}")
            warm_batches = [p.batches_served for p in pumps]

            def after(i):
                ss = [p.state for p in pumps]
                h = _heads(ss)
                check(h[0] == h[1] == h[2] and locks_free(ss),
                      f"wire cohort {i}: no lock held, log heads equal "
                      f"({h[0]:,})", quiet=i > 0)
            d, secs, ms = _cohorts("TATP WireCoordinator", co,
                                   lambda: co.run_cohort(rng, WT_COHORT),
                                   card, min_cohorts=WT_COHORTS,
                                   window_s=WT_WINDOW_S, after=after)
            timeout_lanes = co.stats.timeout_lanes
        check(d["committed"] + d["aborted_lock"] + d["aborted_validate"]
              + d["aborted_missing"] + d["aborted_timeout"]
              == d["attempted"] == len(ms) * WT_COHORT
              and d["committed"] > 0 and d["aborted_timeout"] == 0
              and timeout_lanes == 0,
              f"wire TATP: the taxonomy closes (committed + aborted_* == "
              f"attempted == {d['attempted']:,}), timeout_lanes == 0")
        for p in pumps:
            p.stop()      # the last batch's tally lands before the report
        report = _pump_report(pumps)
        batches = [p.batches_served - b for p, b in zip(pumps, warm_batches)]
    finally:
        for p in pumps:
            p.close()
    ss = [p.state for p in pumps]
    logs = [_log_since(s, h) for s, h in zip(ss, heads0)]
    lane_heads = [to_u64(s.log.head).tolist() for s in ss]
    print(f"  replicas after the run: every leaf identical "
          f"{_replicas_identical(ss)}; per-lane log heads identical "
          f"{lane_heads[0] == lane_heads[1] == lane_heads[2]}; "
          f"{len(logs[0]):,} new log entries a replica")
    check(locks_free(ss)
          and _replicas_identical(ss, skip=("log.entries", "log.head"))
          and len(set(_heads(ss))) == 1
          and all(np.array_equal(logs[0], x) for x in logs[1:]),
          "wire TATP: no lock held after the last cohort; the three "
          "replicas' tables, lock words and CF tables identical (cf_lock's "
          "owner words apart); their logs took the same entries (each "
          "in its own arrival order, which sets the lanes) and the log "
          "heads' sums are equal")
    for i, r in enumerate(report):
        print(f"  pump {i}: {r['batches']} batches ({batches[i]} after the "
              f"warm cohort), occupancy {r['occupancy_lanes']:,} of "
              f"{r['occupancy_lanes'] + r['padded_lanes']:,} lanes "
              f"({r['occupancy_lanes'] / max(r['occupancy_lanes'] + r['padded_lanes'], 1):.4f}), "
              f"shed {r['shed']}; queue p50/p99 {r['queue']['p50_us']}/"
              f"{r['queue']['p99_us']} us, service p50/p99 "
              f"{r['service']['p50_us']}/{r['service']['p99_us']} us  "
              f"[{card}]")
    launches = launch_counts()
    secs_all = time.perf_counter() - t_phase
    out = {"committed_per_s": d["committed"] / secs,
           "ms_per_cohort": secs * 1e3 / len(ms), "cohorts": len(ms),
           "warm_ms": warm_ms, "stats": d, "pumps": report,
           "seconds": secs_all}
    print(f"  phase 14 (b) kernel launches: {launches}; seconds: "
          f"{secs_all:.3f}  [{card}]")
    print("  wire tatp: " + json.dumps(out))
    return launches


def phase_wire_store(dev, card):
    print(f"== phase 14 (c): the store over the wire at {WS_N:,} keys, "
          f"w={WS_W}, {WS_CLIENTS} loopback clients at 50/50 GET/SET, "
          f"{WS_WINDOW_S} s")
    from dint_tpu_torch import exp
    from dint_tpu_torch.clients import micro
    from dint_tpu_torch.engines import store
    from dint_tpu_torch.shim import STORE, EnginePump
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    table = micro.make_store_table(WS_N, val_words=VW, device=dev)
    torch.cuda.synchronize()
    pop_s = time.perf_counter() - t0
    check(int(table.valid.sum()) == WS_N,
          f"the table holds all {WS_N:,} keys ({pop_s:.3f} s)")
    wave = WS_W // WS_CLIENTS
    bad = []
    # GET lanes, SET lanes, VAL replies, ACK replies, lost replies,
    # exchanges that lost any
    counts = np.zeros(6, np.int64)
    lock = threading.Lock()

    def waves(i, c, rng, stop_at, sent, answered, lat):
        vals = np.zeros((wave, 10), np.uint32)
        vals[:, 1] = micro.STORE_MAGIC
        while time.time() < stop_at:
            k = rng.integers(1, WS_N + 1, size=wave).astype(np.uint64)
            is_get = rng.random(wave) < 0.5
            vals[:, 0] = rng.integers(0, 1 << 30, wave)
            t0 = time.monotonic()
            r = c.exchange(np.where(is_get, 0, 1).astype(np.uint8), k,
                           vals=vals.view(np.uint8).reshape(wave, 40),
                           timeout_ms=WS_TIMEOUT_MS)
            dt = time.monotonic() - t0
            sent[i] += wave
            answered[i] += r["n"]
            lat.add(np.full(r["n"], dt * 1e6))
            # a reply answers the key it echoes: VAL for a GET (with the
            # magic word), ACK for a SET
            is_val, is_ack = r["type"] == 3, r["type"] == 5
            magic = r["val"][:, 4:8].copy().view(np.uint32)[:, 0]
            ok = ((is_val | is_ack).all()
                  and np.isin(r["key"][is_val], k[is_get]).all()
                  and np.isin(r["key"][is_ack], k[~is_get]).all()
                  and (magic[is_val] == micro.STORE_MAGIC).all())
            with lock:
                counts[:] += [int(is_get.sum()), int((~is_get).sum()),
                              int(is_val.sum()), int(is_ack.sum()),
                              wave - r["n"], int(r["n"] < wave)]
                if not ok:
                    bad.append(np.unique(r["type"]).tolist())

    reset_launches()
    with EnginePump(STORE, store.step, table, width=WS_W, flush_us=500,
                    device=dev).start() as pump:
        exp._warm_pump(pump, "wire store")
        sent, answered, lats, dt = exp._wire_clients(pump, WS_CLIENTS,
                                                     WS_WINDOW_S, waves)
        pump.stop()
        snap = _pump_report([pump])[0]
    blk = exp._wire_block(sent, answered, lats, dt, {})
    launches = launch_counts()
    print(f"  wire store: {counts[0]:,} GET and {counts[1]:,} SET lanes "
          f"sent; {counts[2]:,} VAL and {counts[3]:,} ACK replies; "
          f"{counts[4]:,} replies lost in {counts[5]} of "
          f"{int(sent.sum()) // wave} exchanges ({WS_TIMEOUT_MS} ms "
          f"timeout, no re-send)")
    check(not bad and answered.sum() > 0 and counts[2] <= counts[0]
          and counts[3] <= counts[1]
          and counts[2] + counts[3] == answered.sum(),
          f"wire store: every reply that came back answers its key: VAL "
          f"with the STORE_MAGIC word for a GET of a populated key "
          f"({counts[2]:,}), ACK for a SET ({counts[3]:,})"
          + (f"; wrong replies {bad[:5]}" if bad else ""))
    out = {"pkt_per_s": blk["goodput"], "sent_per_s": blk["throughput"],
           "p50_us": blk["p50_us"], "p99_us": blk["p99_us"],
           "sent": int(sent.sum()), "lost": int(counts[4]),
           "lossy_exchanges": int(counts[5]), "window_s": dt,
           "populate_s": pop_s, "pump": snap,
           "seconds": time.perf_counter() - t_phase}
    print(f"  wire store: {blk['goodput']:.1f} answered pkt/s "
          f"({blk['throughput']:.1f} sent), p50 {blk['p50_us']:.1f} us, p99 "
          f"{blk['p99_us']:.1f} us; pump {snap}  [{card}]")
    print(f"  phase 14 (c) kernel launches: {launches}; seconds: "
          f"{out['seconds']:.3f}")
    print("  wire store: " + json.dumps(out))
    del table
    gc.collect()
    torch.cuda.empty_cache()
    return launches


class _PointLaunches(dict):
    """sweep_micro's results: each point's kernel launches, counted from 0
    at the previous point's end (or the sweep's start)."""

    def __init__(self):
        super().__init__()
        self.launches = {}
        reset_launches()

    def __setitem__(self, name, block):
        torch.cuda.synchronize()
        self.launches[name] = launch_counts()
        reset_launches()
        super().__setitem__(name, block)


def phase_micro(dev, card):
    print(f"== phase 14 (d): exp.sweep_micro in-process, "
          f"{MICRO_WINDOW_S} s windows, use_hotset=True: "
          f"{', '.join(MICRO_POINTS)}")
    import tempfile
    from dint_tpu_torch import exp
    t_phase = time.perf_counter()
    res = _PointLaunches()
    exp.sweep_micro(MICRO_WINDOW_S, False, res,
                    want=lambda n: n in MICRO_POINTS, use_hotset=True,
                    device=dev)
    check(sorted(res) == sorted(MICRO_POINTS),
          f"sweep_micro ran the {len(MICRO_POINTS)} points")
    for name in MICRO_POINTS:
        r = res[name]
        ran = {k: v for k, v in res.launches[name].items() if v}
        print(f"  {name}: throughput {r['throughput']}, goodput "
              f"{r['goodput']}, p50 {r['p50_us']} us, p99 {r['p99_us']} us"
              + (f", unit {r['unit']}" if "unit" in r else "")
              + f"; launches {ran}  [{card}]")
        check(r["goodput"] > 0, f"{name}: goodput > 0", quiet=True)
    zipf, scan = res.launches["store_zipf_w4096"], \
        res.launches["store_scan_f95"]
    check(res["store_zipf_w4096"]["use_hotset"] is True
          and zipf["gather_rows_hot"] > 0 and zipf["scatter_rows_hot"] > 0
          and scan["scan_rows"] > 0,
          f"micro store_zipf ran the hot kernels (gather_rows_hot "
          f"{zipf['gather_rows_hot']}, scatter_rows_hot "
          f"{zipf['scatter_rows_hot']}), micro store_scan ran scan_rows "
          f"({scan['scan_rows']})")
    wt = res["tatp_wire_txn"]
    check(wt["ab_timeout"] == wt["timeout_lanes"] == 0,
          "tatp_wire_txn: no timeout")
    print("  micro: " + json.dumps(
        {n: {k: v for k, v in r.items() if k not in ("lat_hist", "pump")}
         for n, r in res.items()}, default=str))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", "dint_tpu_torch.exp",
                              "--quick", "--only", "store_wire", "--out",
                              tmp], capture_output=True, text=True,
                             timeout=300)
        secs = time.perf_counter() - t0
        ok = out.returncode == 0 and os.path.exists(
            os.path.join(tmp, "store_wire.json"))
        check(ok, f"python -m dint_tpu_torch.exp --quick --only store_wire "
              f"exits 0 and writes store_wire.json ({secs:.3f} s)" + (
                  "" if ok else f" (rc {out.returncode}; stderr: "
                  f"{out.stderr[-2000:]})"))
        print("  " + out.stdout.strip().replace("\n", "\n  "))
    print(f"  phase 14 (d) seconds: {time.perf_counter() - t_phase:.3f}  "
          f"[{card}]")
    return {"micro store_zipf": zipf, "micro store_scan": scan}


def phase_wire(dev, card, replicas):
    """Phase 14. (b) serves phase 12's TATP replicas, which ``replicas``
    (a list) holds; it is emptied after (b), so the tables are freed."""
    t_phase = time.perf_counter()
    paths = {"wire stub": phase_wire_cpu_vs_card(dev, card)}
    paths["wire tatp"] = phase_wire_tatp(dev, card, replicas)
    replicas.clear()
    gc.collect()
    torch.cuda.empty_cache()
    paths["wire store"] = phase_wire_store(dev, card)
    paths.update(phase_micro(dev, card))
    print(f"  phase 14 seconds: {time.perf_counter() - t_phase:.3f}  "
          f"[{card}]")
    return paths


# ------------------------------------------------- the observability plane

# the wrapper of each kernel slice phase 15 profiles, by the kernel's
# name in the trace (gather_rows and gather_streams share
# gather_pass_kernel<false>, which only SmallBank's fused routes launch as
# gather_streams; phase 15 profiles SmallBank's default route), and the
# wave each wrapper's launches are charged to, per route
OBS_KERNEL_OF = (("gather_pass_kernel<false", "gather_rows"),
                 ("gather_pass_kernel<true", "gather_rows_hot"),
                 ("scatter_pass_kernel<false", "scatter_streams"),
                 ("scatter_pass_kernel<true", "scatter_rows_hot"),
                 ("lock_arbitrate_kernel", "lock_arbitrate"),
                 ("lock_validate_kernel", "lock_validate"))
OBS_WAVES = {
    "tatp default": {"gather_rows": "dint.tatp_dense.meta_gather",
                     "lock_arbitrate": "dint.tatp_dense.lock"},
    "tatp hotset": {"gather_rows_hot": "dint.tatp_dense.meta_gather",
                    "lock_arbitrate": "dint.tatp_dense.lock",
                    "scatter_rows_hot": "dint.tatp_dense.install"},
    "tatp fused": {"lock_validate": "dint.tatp_dense.lock_validate",
                   "gather_rows": "dint.tatp_dense.magic_gather",
                   "scatter_streams": "dint.tatp_dense.install_log"},
    "tatp fused+hotset": {
        "lock_validate": "dint.tatp_dense.lock_validate",
        "gather_rows_hot": "dint.tatp_dense.magic_gather",
        "scatter_streams": "dint.tatp_dense.install_log"},
    "smallbank default": {"gather_rows": "dint.smallbank_dense.read"},
}
OBS_BLOCKS = 3                   # phase 15 (b)'s blocks a route
OBS_SMALL = dict(tatp=(2000, 256, 4), smallbank=(300, 256, 4))
OBS_AB_WINDOW_S = 2              # phase 15 (d)'s DINT_SCOPE A/B windows


def _obs_kernel_name(slice_name):
    for prefix, name in OBS_KERNEL_OF:
        if prefix in slice_name:
            return name
    return None


def _obs_counts(events):
    """Kinds and outcome causes of decoded events (numpy u32 [n, 4])."""
    from dint_tpu_torch.monitor import txnevents as txe
    kind = (events[:, 1] >> 24) & 0xFF
    aux = events[:, 1] & 0xFF
    kinds = {txe.KIND_NAMES[k]: int((kind == k).sum())
             for k in txe.KIND_NAMES}
    out = kind == txe.EV_OUTCOME
    causes = {txe.CAUSE_NAMES[c]: int((out & (aux == c)).sum())
              for c in txe.CAUSE_NAMES}
    return kinds, causes


def _obs_small_runs(dev, engine, trace):
    """(a): one small runner of ``engine`` with the counters on each
    route, on the CPU and the card, from one host-made state and draw set;
    returns {route: [(tables, stats, [(events, head)] of each block and
    the drain, counter snapshot) on the CPU, the same on the card]}."""
    from dint_tpu_torch import convert
    from dint_tpu_torch.engines import smallbank_dense as sd
    from dint_tpu_torch.engines import tatp_dense as td
    from dint_tpu_torch.monitor import txnevents as txe
    from dint_tpu_torch.ops import u32
    n, w, cpb = OBS_SMALL[engine]
    rng = np.random.default_rng(15)
    tatp = engine == "tatp"
    ring_ix = 3 if tatp else 2
    words = 4 if tatp else 5
    draws = [(rng.integers(0, 1 << 32, (cpb, w, words), dtype=np.uint64)
              .astype(np.uint32),
              (rng.integers(0, 1 << 16, (cpb, w, 2)) if tatp
               else rng.integers(-20, 21, (cpb, w))).astype(np.int32))
             for _ in range(3)]
    pay = rng.integers(0, 1 << 16, (2, w, 2)).astype(np.int32)
    arrays = convert.dense_db_to_numpy(td.populate(
        np.random.default_rng(0), n, val_words=VW, device="cpu",
        log_capacity=1 << 10)) if tatp else None

    def ring_of(ring, cap):
        return txe.decode(ring.buf, ring.head, cap), int(
            u32.to_u64(ring.head))

    out = {}
    for route, (hot, fused) in td.ROUTES.items():
        out[route] = []
        for where in ("cpu", dev):
            kw = dict(use_hotset=hot, use_fused=fused, monitor=True,
                      trace=trace, device=where)
            if tatp:
                run, init, drain = td.build_pipelined_runner(
                    n, w=w, val_words=VW, cohorts_per_block=cpb,
                    mix=TATP_CONTENTION_MIX, **kw)
                carry = init(convert.dense_db_from_numpy(arrays, where))
            else:
                run, init, drain = sd.build_pipelined_runner(
                    n, w=w, cohorts_per_block=cpb, **kw)
                carry = init(sd.create(n, log_capacity=1 << 10,
                                       device=where))
            cap = init.trace_cfg.cap if trace else 0
            rings, stats = [], []
            for a, b in draws:
                carry, s = run.run_draws(carry, u32.from_numpy(a, where),
                                         torch.from_numpy(b).to(where))
                stats.append(s.cpu())
                if trace:
                    rings.append(ring_of(carry[ring_ix], cap))
            outs = (drain(carry, torch.from_numpy(pay).to(where)) if tatp
                    else drain(carry))
            stats.append(outs[1].cpu())
            if trace:
                rings.append(ring_of(outs[2], cap))
            tables = (convert.dense_db_to_numpy(outs[0]) if tatp
                      else convert.dense_bank_to_numpy(outs[0]))
            out[route].append((tables, torch.cat(stats).numpy(), rings,
                               _obs_snapshot(outs[-1])))
    return out


def _obs_snapshot(c):
    from dint_tpu_torch.monitor import counters as mon
    return mon.snapshot(c)


def _same_tables(a, b):
    return list(a) == list(b) and all(
        np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a)


def phase_obs_cpu_vs_card(dev):
    print("== phase 15 (a): the traced runners on the CPU against the card, "
          "four routes each, trace on and off")
    for engine in ("tatp", "smallbank"):
        on = _obs_small_runs(dev, engine, True)
        off = _obs_small_runs(dev, engine, False)
        for route, ((c_tab, c_st, c_rings, c_ctr),
                    (g_tab, g_st, g_rings, g_ctr)) in on.items():
            check(_same_tables(c_tab, g_tab) and np.array_equal(c_st, g_st)
                  and c_ctr == g_ctr and len(c_rings) == len(g_rings)
                  and all(np.array_equal(a[0], b[0]) and a[1] == b[1]
                          for a, b in zip(c_rings, g_rings)),
                  f"{engine} {route}: decoded events, heads, stats, counters "
                  f"and tables identical on the CPU and the card "
                  f"({sum(len(r[0]) for r in g_rings)} events)")
            check(all(r[0].shape[0] == r[1] > 0 for r in g_rings[:-1]),
                  f"{engine} {route}: every block's ring holds its events, "
                  f"none dropped")
            o_tab, o_st, _, o_ctr = off[route][1]
            del o_ctr["trace_dropped"], g_ctr["trace_dropped"]
            check(_same_tables(o_tab, g_tab) and np.array_equal(o_st, g_st)
                  and o_ctr == g_ctr,
                  f"{engine} {route}: trace off gives the tables, stats and "
                  f"counters of trace on")


def _obs_reconcile(label, events, snap, total, stat, engine):
    kinds, causes = _obs_counts(events)
    want = {"lock": snap["lock_requests"],
            "install": snap["install_writes"],
            "outcome": snap["txn_attempted"]}
    if engine == "tatp":
        want["validate"] = snap["validate_lanes"]
    ok = (all(kinds[k] == v for k, v in want.items())
          and snap["txn_attempted"] == int(total[stat.STAT_ATTEMPTED])
          and causes["commit"] == snap["txn_committed"]
          == int(total[stat.STAT_COMMITTED])
          and causes["ab_lock"] == snap["ab_lock"]
          and snap["trace_dropped"] == 0 and snap["lock_requests"] > 0)
    if engine == "tatp":
        ok = ok and causes["ab_missing"] == snap["ab_missing"] \
            and causes["ab_validate"] == snap["ab_validate"]
    else:
        ok = ok and causes["ab_logic"] == snap["ab_logic"]
    check(ok, f"{label}: events reconcile with the counters and stats "
          f"exactly, none dropped (kinds {kinds}, outcomes {causes})")


def _obs_drive(dev, label, run, init, drain, state, engine, stat):
    """(b): OBS_BLOCKS blocks and the drain at rate 1.0 with the counters,
    each window's ring decoded on the host; reconciles. Returns the
    drained state and the stats total."""
    from dint_tpu_torch.monitor import txnevents as txe
    ring_ix = 3 if engine == "tatp" else 2
    cap = init.trace_cfg.cap
    carry = init(state)
    gen = torch.Generator(device=dev).manual_seed(15)
    events, dropped = [], []
    total = np.zeros(stat.N_STATS, np.int64)
    t0 = time.perf_counter()
    for _ in range(OBS_BLOCKS):
        carry, s = run(carry, gen)
        total += s.cpu().numpy().astype(np.int64).sum(axis=0)
        ring = carry[ring_ix]
        events.append(txe.decode(ring.buf, ring.head, cap))
        dropped.append(txe.dropped_of(ring.head, cap))
    outs = drain(carry)
    total += outs[1].cpu().numpy().astype(np.int64).sum(axis=0)
    events.append(txe.decode(outs[2].buf, outs[2].head, cap))
    dropped.append(txe.dropped_of(outs[2].head, cap))
    secs = time.perf_counter() - t0
    ev = np.concatenate(events)
    print(f"  {label}: {len(ev)} events over {OBS_BLOCKS} blocks + drain "
          f"(cap {cap} a window), {secs:.3f} s with the host decode")
    _obs_reconcile(label, ev, _obs_snapshot(outs[-1]), total, stat, engine)
    check(dropped == [0] * (OBS_BLOCKS + 1),
          f"{label}: no window dropped an event")
    return outs[0], total


def _obs_profiled_block(dev, label, run, init, drain, state, trace_dir,
                        geometry, steps):
    """(c): one block from ``state`` under `profiler_session` (padded with
    host sleep, and taken again with twice the padding when the profile
    holds no device event, at most 3 times), then the drain; returns the
    drained state, the breakdown, each kernel's slices by the wave they
    are charged to, the count of unlinked device slices, the block's
    kernel launches and the profile's events."""
    from dint_tpu_torch.monitor import attrib, profiler_session
    carry = init(state)
    gen = torch.Generator(device=dev).manual_seed(151)
    for i in range(3):
        reset_launches()
        with profiler_session(os.path.join(trace_dir, f"{label}_{i}")) as p:
            time.sleep(0.2 * 2 ** i)
            carry, _ = run(carry, gen)
            torch.cuda.synchronize()
            time.sleep(0.2 * 2 ** i)
        launches = launch_counts()
        events, _ = attrib.load_trace_events(p["trace"])
        if any(e.get("cat") in attrib.DEVICE_CATS for e in events):
            break
        print(f"  {label}: profile {i} held no device event; taken again")
    bd = attrib.attribute(events, steps=steps, geometry=geometry,
                          trace_path=p["trace"])
    by_kernel, unlinked = {}, 0
    for e, wave, linked in attrib.charge(events):
        unlinked += not linked
        name = _obs_kernel_name(e["name"])
        if name is not None:
            by_kernel.setdefault(name, {}).setdefault(wave, 0)
            by_kernel[name][wave] += 1
    return drain(carry)[0], bd, by_kernel, unlinked, launches, events


def _obs_check_breakdown(label, bd, by_kernel, unlinked, launches):
    want = OBS_WAVES[label]
    ran = {k: c for k, c in launches.items() if c}
    check(set(ran) == set(want) and unlinked == 0
          and by_kernel == {k: {want[k]: ran[k]} for k in ran},
          f"{label}: every kernel slice linked to its launch and charged to "
          f"its wave, as many as the block launched ({by_kernel} vs "
          f"launches {ran})")
    share = bd["attributed_ms"] / bd["total_ms"]
    print(f"  {label}: attributed {bd['attributed_ms']:.6f} of "
          f"{bd['total_ms']:.6f} device ms ({share:.6f}), steps "
          f"{bd['steps']}, step_ms {bd['step_ms']:.6f}")
    for name, r in bd["waves"].items():
        if r["slices"] or r["host_ms"]:
            gbps = "-" if r["gbps"] is None else f"{r['gbps']:.3f}"
            print(f"    {name:34s} ms/step {r['ms_per_step']:.6f} host_ms "
                  f"{r['host_ms']:.6f} slices {r['slices']} GB/s {gbps}")
    return {"attributed_share": share, "total_ms": bd["total_ms"],
            "step_ms": bd["step_ms"],
            "waves": {n: {k: r[k] for k in ("ms_per_step", "host_ms",
                                             "slices", "gbps")}
                      for n, r in bd["waves"].items()
                      if r["slices"] or r["host_ms"]}}


def phase_obs_full(dev, trace_dir):
    print(f"== phase 15 (b, c): full-rate dinttrace reconciliation and one "
          f"profiled block a route: TATP at {N_SUB:,} subscribers, w={W}, "
          f"{CPB} cohorts/block, four routes; SmallBank at {SB_N:,} "
          f"accounts, w={SB_W}, default route")
    from dint_tpu_torch.engines import smallbank_dense as sd
    from dint_tpu_torch.engines import tatp_dense as td
    paths, report = {}, {}
    # one table through the four routes, the hot ones last: the first of
    # them attaches the mirrors, and both write through to them
    db = td.populate_device(torch.Generator(device=dev).manual_seed(0),
                            N_SUB, val_words=VW, device=dev)
    for route in ("default", "fused", "hotset", "fused+hotset"):
        hot, fused = td.ROUTES[route]
        label = f"tatp {route}"
        run, init, drain = td.build_pipelined_runner(
            N_SUB, w=W, val_words=VW, cohorts_per_block=CPB,
            use_hotset=hot, use_fused=fused, monitor=True, trace=True,
            trace_rate=1.0, device=dev)
        check(init.trace_cfg.cap == W * (td.K + 6) * CPB,
              f"{label}: the ring holds a full block at rate 1.0 "
              f"({init.trace_cfg.cap} records)", quiet=route != "default")
        reset_launches()
        db, _ = _obs_drive(dev, label, run, init, drain, db, "tatp", td)
        paths[f"traced {label}"] = launches = launch_counts()
        steps = OBS_BLOCKS * CPB + 2
        want = dict.fromkeys(launches, 0)
        want.update({k: c * steps for k, c in TATP_PER_STEP[route].items()})
        check(launches == want, f"{label}: launches {launches} == "
              f"{TATP_PER_STEP[route]} per step over {steps} steps")
        check(not bool(db.locked.any()),
              f"{label}: no row locked after the drain")
        db, bd, by_kernel, unlinked, launches, _ = _obs_profiled_block(
            dev, label, run, init, drain, db, trace_dir,
            {"w": W, "k": td.K, "vw": VW}, CPB)
        paths[f"profiled {label}"] = launches
        report[label] = _obs_check_breakdown(label, bd, by_kernel, unlinked,
                                             launches)
    del db
    torch.cuda.empty_cache()

    label = "smallbank default"
    bank = sd.create(SB_N, device=dev)
    base = int(sd.total_balance(bank))
    run, init, drain = sd.build_pipelined_runner(
        SB_N, w=SB_W, cohorts_per_block=SB_CPB, monitor=True, trace=True,
        trace_rate=1.0, device=dev)
    reset_launches()
    bank, total = _obs_drive(dev, label, run, init, drain, bank,
                             "smallbank", sd)
    paths[f"traced {label}"] = launches = launch_counts()
    steps = OBS_BLOCKS * SB_CPB + 1
    check(launches == {**dict.fromkeys(launches, 0), "gather_rows": steps},
          f"{label}: one gather_rows launch a step over {steps} steps")
    delta = (int(sd.total_balance(bank)) - base) % (1 << 32)
    check(delta == int(total[sd.STAT_BAL_DELTA]) % (1 << 32),
          f"{label}: balance conserved mod 2^32 (delta {delta})")
    bank, bd, by_kernel, unlinked, launches, _ = _obs_profiled_block(
        dev, label, run, init, drain, bank, trace_dir,
        {"w": SB_W, "l": sd.L, "vw": sd.VW}, SB_CPB)
    paths[f"profiled {label}"] = launches
    report[label] = _obs_check_breakdown(label, bd, by_kernel, unlinked,
                                         launches)
    del bank
    torch.cuda.empty_cache()
    return paths, report


def phase_obs_bench(card, trace_dir):
    print("== phase 15 (d): the bench with DINT_TRACE=1, DINT_BENCH_PROFILE=1 "
          "and DINT_BENCH_TRACE_DIR (TATP leg, 3 s window); the dintscope "
          "and dinttrace CLIs on what it wrote; profile_step --trace read by "
          "dintscope report; then the TATP leg with DINT_SCOPE=0 and 1 in "
          "turns (0, 1, 1, 0)")
    from dint_tpu_torch import bench, dintscope, dinttrace
    from dint_tpu_torch.monitor import attrib, waves
    torch.cuda.empty_cache()
    jsonl = os.path.join(trace_dir, "bench_trace.jsonl")
    env = {k: v for k, v in os.environ.items() if not k.startswith("DINT_")}
    # the gates' CPU runs take minutes: phase 22 runs them on the card
    env.update(DINT_BENCH_WINDOW_S=str(BENCH_WINDOW_S),
               DINT_BENCH_SKIP_SB="1", DINT_TRACE="1",
               DINT_TRACE_JSONL=jsonl, DINT_BENCH_PROFILE="1",
               DINT_BENCH_TRACE_DIR=os.path.join(trace_dir, "bench"),
               DINT_BENCH_LINT="0")
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "dint_tpu_torch.bench"],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    secs = time.perf_counter() - t0
    check(out.returncode == 0,
          f"the traced and profiled bench exits 0 in {secs:.3f} s" + (
              "" if out.returncode == 0 else
              f" (rc {out.returncode}; stderr: {out.stderr[-2000:]})"))
    line = json.loads(out.stdout.strip().splitlines()[-1])
    d, bd = line["dinttrace"], line["breakdown"]
    print("  dinttrace: " + json.dumps(d))
    print(f"  traced bench: {line['value']} committed txn/s, "
          f"{line['blocks']} blocks in {line['window_s']} s")
    check(isinstance(d, dict) and set(d) == {
        "schema", "rate", "cap", "windows", "events", "dropped",
        "dropped_windows"} and d["schema"] == 1 and d["rate"] == 1.0
          and d["cap"] == W * 10 * CPB and d["events"] > 0
          and d["dropped"] == 0 and d["dropped_windows"] == []
          and d["windows"] == line["blocks"] + 1,
          "the line's dinttrace object holds its schema: every window of the "
          "timed and profiled blocks drained, none dropped")
    check(isinstance(bd, dict) and bd["kind"] == "dintscope_breakdown"
          and bd["schema"] == 1 and bd["steps"] == CPB
          and list(bd["waves"]) == list(waves.ALL_WAVES)
          and all(set(r) == {"ms", "slices", "ms_per_step", "pct",
                             "bytes_per_step", "gbps", "host_ms"}
                  for r in bd["waves"].values())
          and bd["geometry"] == {"w": W, "k": 4, "vw": VW}
          and 0 < bd["attributed_ms"] <= bd["total_ms"]
          and bd["waves"]["dint.tatp_dense.meta_gather"]["slices"] > 0
          and bd["waves"]["dint.tatp_dense.trace"]["host_ms"] > 0,
          f"the line's breakdown object holds its schema (attributed "
          f"{bd['attributed_ms']:.6f} of {bd['total_ms']:.6f} device ms, "
          f"step_ms {bd['step_ms']:.6f})")
    check(dinttrace.main(["summarize", jsonl]) == 0
          and dintscope.main(["report", env["DINT_BENCH_TRACE_DIR"],
                              "--steps", str(CPB)]) == 0,
          "dinttrace summarize and dintscope report read what the bench "
          "wrote")
    prof_trace = os.path.join(trace_dir, "profile_step.pt.trace.json")
    out = subprocess.run(
        [sys.executable, "-m", "dint_tpu_torch.profile_step", "--route",
         "fused", "--trace", prof_trace, "--rows", "3"],
        env={k: v for k, v in os.environ.items()
             if not k.startswith("DINT_")},
        capture_output=True, text=True, timeout=600)
    check(out.returncode == 0, "profile_step --route fused --trace exits 0"
          + ("" if out.returncode == 0 else f": {out.stderr[-2000:]}"))
    rep = attrib.report(prof_trace)
    check(all(rep["waves"][f"dint.tatp_dense.{w}"]["slices"] > 0
              for w in ("lock_validate", "magic_gather", "install_log")),
          f"dintscope report reads profile_step's trace: lock_validate, "
          f"magic_gather and install_log charged ({rep['attributed_ms']:.6f} "
          f"of {rep['total_ms']:.6f} device ms)")
    ab = {"0": [], "1": []}
    prev = os.environ.get("DINT_SCOPE")
    try:
        for flag in ("0", "1", "1", "0"):
            os.environ["DINT_SCOPE"] = flag
            leg = bench.measure(env={
                "DINT_BENCH_WINDOW_S": str(OBS_AB_WINDOW_S),
                "DINT_BENCH_SKIP_SB": "1"})
            ab[flag].append(leg["value"])
    finally:
        if prev is None:
            os.environ.pop("DINT_SCOPE", None)
        else:
            os.environ["DINT_SCOPE"] = prev
    print(f"  DINT_SCOPE A/B, untraced TATP leg ({card}), committed txn/s "
          f"in turns 0, 1, 1, 0: {ab['0'][0]}, {ab['1'][0]}, {ab['1'][1]}, "
          f"{ab['0'][1]}; means 0: {np.mean(ab['0']):.1f}, 1: "
          f"{np.mean(ab['1']):.1f}")
    check(all(v > 0 for v in ab["0"] + ab["1"]),
          "the DINT_SCOPE A/B's four legs committed")
    return {"dinttrace": d, "traced_value": line["value"],
            "breakdown_step_ms": bd["step_ms"], "scope_ab": ab}


def phase_observability(dev, card):
    import tempfile
    t0 = time.perf_counter()
    phase_obs_cpu_vs_card(dev)
    with tempfile.TemporaryDirectory(prefix="dint_obs_") as trace_dir:
        paths, report = phase_obs_full(dev, trace_dir)
        bench_rec = phase_obs_bench(card, trace_dir)
    print("  phase 15 record: " + json.dumps(
        {"breakdowns": report, **bench_rec}))
    print(f"  phase 15: {time.perf_counter() - t0:.3f} s")
    return paths


# ------------------------------------------ the sweeps and the calibration

P16_CPB = 4                      # exp.py's cohorts a block
P16_WINDOW_S = 1.0               # (a), (b), (c): each pipeline window
P16_PROF_WINDOW_S = 0.5          # (c): the profiled window
P16_SERVE_WINDOW_S = 1.5         # (d): each rate point's schedule
P16_SERVE_N_SUB = 1_000_000      # (d)'s subscribers: its three points each
                                 # populate in numpy (7M: ~20 s a point);
                                 # 7M's serving plane runs in 13, (e), (f)
P16_SERVE_RATES = (0.5, 1.1)
P16_CAL_WIDTHS = (256, 1024, 4096, 8192)   # ControllerCfg's width menu
P16_CAL_WINDOW_S = 1.0
# (f)'s serve runs at the serving plane's defaults, by depth: (closed-loop
# rates, snapshots, evidence sources); phase 22 (c) fits them again
CAL_RUNS: dict = {}
P16_SKEW_FRAC = 0.16
# exp.py's artifact keys (its points at n_sub 2000, w 256, read off the
# JAX package's sweep), by point kind
P16_BASE = {"throughput", "goodput", "abort_rate", "avg_us", "p50_us",
            "p99_us", "p999_us", "device_duty", "schema", "lat_hist",
            "breakdown", "plan", "mode", "width"}
P16_KEYS = {
    "closed": P16_BASE | {"host_ucores", "host_kcores", "proc_ucores",
                          "proc_kcores", "counters", "dinttrace"},
    "open": P16_BASE | {"target_rate", "offered_rate", "load_frac", "queue",
                        "service"},
    "latency": P16_BASE | {"cpb", "steps", "lat_samples"},
}
P16_AB = {"tatp": {"ab_lock", "ab_missing", "ab_validate"},
          "smallbank": {"ab_lock", "ab_logic"}}
P16_SKEW_KEYS = {"hot_frac", "hot_prob", "use_hotset"}
P16_SERVE_KEYS = {"throughput", "goodput", "abort_rate", "avg_us", "p50_us",
                  "p99_us", "p999_us", "device_duty", "load", "mode",
                  "engine", "widths", "offered", "admitted", "shed",
                  "blocks", "offered_rate", "achieved_rate", "slo_us",
                  "slo_met", "service", "controller", "serve_counters",
                  "schema", "lat_hist", "breakdown", "plan"}


class _Env:
    """Set environment variables for a ``with`` block (None unsets), and
    put back what was there."""

    def __init__(self, **kv):
        self.kv, self.old = kv, {}

    def __enter__(self):
        for k, v in self.kv.items():
            self.old[k] = os.environ.get(k)
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    def __exit__(self, *exc):
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


P16_ENV = dict(DINT_TRACE=None, DINT_MONITOR=None, DINT_EXP_TRACE_DIR=None,
               DINT_PLAN_OVERRIDE=None, DINT_USE_FUSED=None,
               DINT_USE_HOTSET=None, DINT_CALIB_PATH=None)


class PointSink(dict):
    """exp's results: as each point lands, its kernel launches and the
    peak device memory since the previous point landed (or since the sink
    was made) are kept beside it and both are reset."""

    def __init__(self):
        super().__init__()
        self.launches, self.peak = {}, {}
        reset_launches()
        torch.cuda.reset_peak_memory_stats()

    def __setitem__(self, name, block):
        super().__setitem__(name, block)
        self.launches[name] = launch_counts()
        self.peak[name] = torch.cuda.max_memory_allocated()
        reset_launches()
        torch.cuda.reset_peak_memory_stats()


def _p16_counted(runner_fn, rec):
    """``runner_fn`` whose runs and drains keep every block's stats in
    ``rec`` (warm blocks included) and hand on the traced runner's
    ``txn_monitor``."""
    def fn(w, b):
        run, carry, drain = runner_fn(w, b)

        def counted(carry, gen):
            carry, s = run(carry, gen)
            rec["stats"].append(s)
            return carry, s

        def drained(carry):
            out = drain(carry)
            rec["stats"].append(out[1])
            return out

        counted.txn_monitor = getattr(run, "txn_monitor", None)
        rec["tmon"] = counted.txn_monitor
        return counted, carry, drained
    return fn


def _p16_extras(engine, extras_fn):
    """exp's extras with the accounting checked: committed plus the abort
    counts equals attempted, magic_bad 0."""
    from dint_tpu_torch.engines import smallbank_dense as sd
    from dint_tpu_torch.engines import tatp_dense as td
    stat = td if engine == "tatp" else sd

    def fn(total):
        att, com, extra = extras_fn(total)
        aborts = sum(extra[k] for k in P16_AB[engine])
        check(com + aborts == att > 0
              and int(total[stat.STAT_MAGIC_BAD]) == 0,
              f"{engine}: committed {com:,} + aborts {aborts:,} == attempted "
              f"{att:,}, magic_bad 0", quiet=True)
        return att, com, extra
    return fn


def _p16_point(card, res, name, kind, engine, extra_keys=()):
    blk = res[name]
    want = P16_KEYS[kind] | P16_AB[engine] | set(extra_keys)
    check(set(blk) == want, f"{name}: exp.py's artifact keys"
          + ("" if set(blk) == want else
             f" (extra {set(blk) - want}, missing {want - set(blk)})"))
    line = (f"  {name}: goodput {blk['goodput']:,.1f} txn/s, throughput "
            f"{blk['throughput']:,.1f}, abort {blk['abort_rate']}, p50 "
            f"{blk['p50_us']} p99 {blk['p99_us']} us")
    if kind == "open":
        check(blk["offered_rate"] > 0 and isinstance(blk["queue"], dict)
              and isinstance(blk["service"], dict)
              and "p99_us" in blk["queue"] and "p99_us" in blk["service"],
              f"{name}: offered_rate, queue and service present")
        line += (f"; target {blk['target_rate']:,.1f}/s offered "
                 f"{blk['offered_rate']:,.1f}/s; queue p99 "
                 f"{blk['queue']['p99_us']} service p99 "
                 f"{blk['service']['p99_us']} us")
    if kind == "latency":
        line += f"; {blk['steps']} steps, {blk['lat_samples']} samples"
    launches = {k: v for k, v in res.launches[name].items() if v}
    print(line + f"; launches {launches}; peak {res.peak[name]:,} B  "
          f"[{card}]")
    return blk


def phase_p16_pipeline(dev, card, trace_dir):
    """(a)-(c): the TATP and SmallBank sweeps, the traced and profiled
    points. Returns (paths, record)."""
    from dint_tpu_torch import exp
    from dint_tpu_torch.engines import smallbank_dense as sd
    from dint_tpu_torch.engines import tatp_dense as td
    from dint_tpu_torch.monitor import attrib
    paths, out = {}, {}

    def tatp_fn(n_sub):
        return lambda w, b: exp._tatp_runner(n_sub, w, b, device=dev)

    def sb_fn(w, b):
        return exp._sb_runner(SB_N, w, b, device=dev)

    print(f"== phase 16 (a): exp.sweep_pipeline, TATP at {N_SUB:,} "
          f"subscribers: closed w={W}, open {P16_SERVE_RATES[0]} and 0.9 of "
          f"its peak, latency w=256, {P16_CPB} cohorts a block, "
          f"{P16_WINDOW_S} s windows, the plan's route; then a closed point "
          f"on the fused route")
    res = PointSink()
    t0 = time.perf_counter()
    exp.sweep_pipeline(
        "tatp", tatp_fn(N_SUB), _p16_extras("tatp", exp._tatp_extras),
        td.N_STATS, widths=[W], cpb=P16_CPB, depth=3,
        magic_idx=td.STAT_MAGIC_BAD, window_s=P16_WINDOW_S,
        open_rates=(0.5, 0.9), results=res, lat_widths=[256],
        geom={"k": td.K, "vw": exp.TATP_VW}, device=dev)
    kinds = {f"tatp_closed_w{W}": "closed", "tatp_open_50pct": "open",
             "tatp_open_90pct": "open", "tatp_latency_w256": "latency"}
    check(sorted(res) == sorted(kinds), f"(a) ran {sorted(res)}")
    for name, kind in kinds.items():
        blk = _p16_point(card, res, name, kind, "tatp")
        out[name] = {k: blk[k] for k in ("goodput", "throughput", "p50_us",
                                          "p99_us", "abort_rate")}
        if kind == "open":
            out[name].update(queue_p99_us=blk["queue"]["p99_us"],
                             service_p99_us=blk["service"]["p99_us"],
                             offered_rate=blk["offered_rate"])
        paths[f"p16 {name}"] = res.launches[name]
    for name in kinds:
        check(res.launches[name]["gather_rows"] > 0
              and res.launches[name]["lock_arbitrate"] > 0,
              f"{name}: gather_rows and lock_arbitrate launched (the "
              f"default route)", quiet=name != f"tatp_closed_w{W}")
    untraced = res[f"tatp_closed_w{W}"]["goodput"]
    with _Env(DINT_PLAN_OVERRIDE="1", DINT_USE_FUSED="1"):
        res = PointSink()
        exp.sweep_pipeline(
            "tatp_fused", tatp_fn(N_SUB),
            _p16_extras("tatp", exp._tatp_extras), td.N_STATS,
            widths=[W], cpb=P16_CPB, depth=3, magic_idx=td.STAT_MAGIC_BAD,
            window_s=P16_WINDOW_S, open_rates=(), results=res,
            geom={"k": td.K, "vw": exp.TATP_VW}, device=dev)
    name = f"tatp_fused_closed_w{W}"
    blk = _p16_point(card, res, name, "closed", "tatp")
    check(blk["plan"]["overridden"] == ["use_fused"]
          and res.launches[name]["lock_validate"] > 0
          and res.launches[name]["scatter_streams"] > 0
          and res.launches[name]["lock_arbitrate"] == 0,
          f"{name}: the override recorded, lock_validate and "
          f"scatter_streams launched, lock_arbitrate not")
    paths[f"p16 {name}"] = res.launches[name]
    out[name] = {"goodput": blk["goodput"], "p99_us": blk["p99_us"]}
    print(f"  (a) {time.perf_counter() - t0:.3f} s")

    print(f"== phase 16 (b): SmallBank at {SB_N:,} accounts: closed w={SB_W}, "
          f"open 0.5; the skew preset at hot_frac {P16_SKEW_FRAC} with the "
          f"hot tier (DINT_PLAN_OVERRIDE=1 DINT_USE_HOTSET=1)")
    t0 = time.perf_counter()
    res = PointSink()
    exp.sweep_pipeline(
        "smallbank", sb_fn, _p16_extras("smallbank", exp._sb_extras),
        sd.N_STATS, widths=[SB_W], cpb=P16_CPB, depth=2,
        magic_idx=sd.STAT_MAGIC_BAD, window_s=P16_WINDOW_S,
        open_rates=(0.5,), results=res,
        point_extra=exp._sb_skew_extra(None, None, 0.9),
        geom={"l": sd.L, "vw": sd.VW}, device=dev)
    for name, kind in ((f"smallbank_closed_w{SB_W}", "closed"),
                       ("smallbank_open_50pct", "open")):
        # exp.py records the skew on the closed points only
        blk = _p16_point(card, res, name, kind, "smallbank",
                         P16_SKEW_KEYS if kind == "closed" else ())
        check(res.launches[name]["gather_rows"] > 0,
              f"{name}: gather_rows launched (the default route)")
        paths[f"p16 {name}"] = res.launches[name]
        out[name] = {"goodput": blk["goodput"], "p99_us": blk["p99_us"],
                     "abort_rate": blk["abort_rate"]}
    with _Env(DINT_PLAN_OVERRIDE="1", DINT_USE_HOTSET="1"):
        res = PointSink()
        exp.sweep_skew(SB_N, width=SB_W, cpb=P16_CPB, window_s=P16_WINDOW_S,
                       results=res, fracs=(P16_SKEW_FRAC,), device=dev)
    name = f"smallbank_skew_h{int(P16_SKEW_FRAC * 100):02d}_closed_w{SB_W}"
    blk = _p16_point(card, res, name, "closed", "smallbank", P16_SKEW_KEYS)
    check(blk["use_hotset"] is True and blk["hot_frac"] == P16_SKEW_FRAC
          and res.launches[name]["gather_rows_hot"] > 0
          and res.launches[name]["scatter_rows_hot"] > 0,
          f"{name}: the hot tier built, gather_rows_hot and "
          f"scatter_rows_hot launched")
    paths[f"p16 {name}"] = res.launches[name]
    out[name] = {"goodput": blk["goodput"], "p99_us": blk["p99_us"],
                 "abort_rate": blk["abort_rate"]}
    print(f"  (b) {time.perf_counter() - t0:.3f} s")

    print(f"== phase 16 (c): a closed TATP point with DINT_TRACE=1 "
          f"({P16_WINDOW_S} s), then one under DINT_EXP_TRACE_DIR "
          f"({P16_PROF_WINDOW_S} s)")
    t0 = time.perf_counter()
    rec = {"stats": []}
    with _Env(DINT_TRACE="1"):
        res = PointSink()
        exp.sweep_pipeline(
            "tatp_traced", _p16_counted(tatp_fn(N_SUB), rec),
            _p16_extras("tatp", exp._tatp_extras), td.N_STATS,
            widths=[W], cpb=P16_CPB, depth=3, magic_idx=td.STAT_MAGIC_BAD,
            window_s=P16_WINDOW_S, open_rates=(), results=res,
            geom={"k": td.K, "vw": exp.TATP_VW}, device=dev)
    name = f"tatp_traced_closed_w{W}"
    blk = _p16_point(card, res, name, "closed", "tatp")
    d = blk["dinttrace"]
    tmon = rec.pop("tmon")
    events = np.concatenate([np.asarray(r["events"], np.int64).reshape(-1, 4)
                             for win in tmon.windows for r in win])
    events = events.astype(np.uint32)
    total = sum(s.cpu().numpy().astype(np.int64).sum(axis=0)
                for s in rec["stats"])
    kinds, causes = _obs_counts(events)
    check(isinstance(d, dict) and d["dropped"] == 0
          and d["dropped_windows"] == [] and d["events"] == len(events) > 0
          and kinds["outcome"] == int(total[td.STAT_ATTEMPTED])
          and causes["commit"] == int(total[td.STAT_COMMITTED])
          and causes["ab_lock"] == int(total[td.STAT_AB_LOCK])
          and causes["ab_missing"] == int(total[td.STAT_AB_MISSING])
          and causes["ab_validate"] == int(total[td.STAT_AB_VALIDATE]),
          f"{name}: the dinttrace summary ({d['events']:,} events, "
          f"{d['windows']} windows) reconciles with the stats of every "
          f"block it observed (outcomes {causes}), none dropped")
    traced = blk["goodput"]
    print(f"  traced / untraced closed goodput: {traced:,.1f} / "
          f"{untraced:,.1f} = {traced / untraced:.4f}  [{card}]")
    paths[f"p16 {name}"] = res.launches[name]
    out[name] = {"goodput": traced, "ratio_to_untraced": traced / untraced,
                 "events": d["events"], "windows": d["windows"]}
    del tmon, events, rec
    gc.collect()

    tdir = os.path.join(trace_dir, "exp")
    with _Env(DINT_EXP_TRACE_DIR=tdir):
        res = PointSink()
        exp.sweep_pipeline(
            "tatp_profiled", tatp_fn(N_SUB),
            _p16_extras("tatp", exp._tatp_extras), td.N_STATS,
            widths=[W], cpb=P16_CPB, depth=3, magic_idx=td.STAT_MAGIC_BAD,
            window_s=P16_PROF_WINDOW_S, open_rates=(), results=res,
            geom={"k": td.K, "vw": exp.TATP_VW}, device=dev)
    name = f"tatp_profiled_closed_w{W}"
    blk = _p16_point(card, res, name, "closed", "tatp")
    bd = blk["breakdown"]
    path = attrib.find_trace_file(tdir)
    t1 = time.perf_counter()
    ev, _ = attrib.load_trace_events(path)
    parse_s = time.perf_counter() - t1
    charged = attrib.charge(ev)
    unlinked = sum(not linked for _, _, linked in charged)
    hand = [(_obs_kernel_name(e["name"]), wave) for e, wave, _ in charged
            if _obs_kernel_name(e["name"]) is not None]
    bad = sorted({k for k, wave in hand if wave is None})
    by_wave = {}
    for k, wave in hand:
        by_wave.setdefault(k, {}).setdefault(wave, 0)
        by_wave[k][wave] += 1
    check(isinstance(bd, dict) and bd["kind"] == "dintscope_breakdown"
          and bd["geometry"] == {"k": td.K, "vw": exp.TATP_VW, "w": W}
          and unlinked == 0 and hand and not bad,
          f"{name}: the breakdown is an object; all {len(charged):,} device "
          f"slices are linked to their launch, and every slice of the hand "
          f"kernels is charged to a wave ({by_wave})"
          + ("" if not bad else f"; uncharged: {bad}"))
    size = os.path.getsize(path)
    print(f"  the window's trace: {size:,} bytes, {len(ev):,} events, "
          f"parsed in {parse_s:.3f} s; attributed {bd['attributed_ms']:.3f} "
          f"of {bd['total_ms']:.3f} device ms over {bd['steps']} steps "
          f"(step_ms {bd['step_ms']})  [{card}]")
    paths[f"p16 {name}"] = res.launches[name]
    out[name] = {"goodput": blk["goodput"], "trace_bytes": size,
                 "trace_events": len(ev), "parse_s": parse_s,
                 "attributed_ms": bd["attributed_ms"],
                 "total_ms": bd["total_ms"], "steps": bd["steps"]}
    del ev, charged, hand
    gc.collect()
    print(f"  (c) {time.perf_counter() - t0:.3f} s")
    return paths, out


def _serve_identity(label, snap):
    c = snap["counters"]
    served = sum(int(w) * n for w, n in snap["steps_by_width"].items())
    check(snap["offered"] == snap["admitted"] + snap["shed"]
          and c["serve_occupancy_lanes"] + c["serve_padded_lanes"] == served
          and c["serve_occupancy_lanes"] == snap["admitted"]
          and c["serve_shed_lanes"] == snap["shed"],
          f"{label}: offered {snap['offered']:,} == admitted "
          f"{snap['admitted']:,} + shed {snap['shed']:,}; occupancy + padded "
          f"lanes == width x serving steps ({served:,})")


def _recorded(base):
    """A subclass of the serving-plane engine ``base`` for exp's sweeps:
    each engine made keeps its last snapshot in ``snaps``, in the order
    they were made, for the lane identities."""
    class Recorded(base):
        snaps = []

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self._slot = len(Recorded.snaps)
            Recorded.snaps.append(None)

        def snapshot(self):
            snap = super().snapshot()
            Recorded.snaps[self._slot] = snap
            return snap

    return Recorded


def _device_filled(base):
    """``base`` (a ServeEngine class) with its TATP tables filled on the
    card (`populate_device`, the population rules of `populate`)."""
    from dint_tpu_torch.engines import tatp_dense as td

    class DeviceFilled(base):
        def _fresh_db(self, seed):
            if self.engine != "tatp_dense":
                return super()._fresh_db(seed)
            gen = torch.Generator(device=self.dev).manual_seed(seed)
            return td.populate_device(gen, self.size,
                                      val_words=self.val_words,
                                      device=self.dev)
    return DeviceFilled


def _cal_closed(dev, card, label):
    """The calibration's offered rates: tatp_dense's closed-loop attempted
    txn/s at 7M by width of the menu, at the serving plane's defaults
    (SV_CPB cohorts a block, depth 2)."""
    from dint_tpu_torch import exp
    from dint_tpu_torch.engines import tatp_dense as td
    res = PointSink()
    exp.sweep_pipeline(
        label, lambda w, b: exp._tatp_runner(N_SUB, w, b, device=dev),
        exp._tatp_extras, td.N_STATS, widths=list(P16_CAL_WIDTHS),
        cpb=SV_CPB, depth=2, magic_idx=td.STAT_MAGIC_BAD,
        window_s=P16_CAL_WINDOW_S, open_rates=(), results=res, device=dev)
    closed = {w: res[f"{label}_closed_w{w}"]["throughput"]
              for w in P16_CAL_WIDTHS}
    print(f"  closed-loop attempted txn/s by width ({SV_CPB} cohorts a "
          f"block, depth 2): {closed}  [{card}]")
    return closed


def _cal_serve_runs(dev, card, closed, depth, where, key):
    """The calibration's serve runs: ServeEngine over tatp_dense at 7M
    (SV_CPB cohorts a block, ``depth``, no plan), one P16_CAL_WINDOW_S s
    Poisson run a width of the menu at half its closed-loop rate.
    Returns (snapshots, evidence sources naming ``where``, launches by
    path)."""
    from dint_tpu_torch import serve
    engine_cls = _device_filled(serve.ServeEngine)
    snaps, sources, paths = [], [], {}
    for w in P16_CAL_WIDTHS:
        eng = engine_cls("tatp_dense", N_SUB,
                         cfg=serve.ControllerCfg(widths=(w,)),
                         cohorts_per_block=SV_CPB, depth=depth, monitor=True,
                         plan=None, device=dev)
        eng.warmup()
        reset_launches()
        eng.run(serve.poisson_schedule(0.5 * closed[w], P16_CAL_WINDOW_S,
                                       seed=17))
        eng.close()
        paths[f"{key} w{w}"] = launch_counts()
        snap = eng.snapshot()
        del eng
        gc.collect()
        _serve_identity(f"calibration depth {depth} w{w}", snap)
        keep_counters("serve calibration", snap["counters"])
        print(f"  depth {depth} w={w}: {snap['blocks']} blocks, "
              f"{snap['controller']['service_samples']['n']} service "
              f"samples, observed service {snap['controller']['service_us']}"
              f" us a step, service p50 {snap['service']['p50']:.1f} us a "
              f"block; queue p99 {snap['queue']['p99']:.1f} us  [{card}]")
        snaps.append(snap)
        sources.append(f"chip_smoke {where}, {card}: depth {depth} w{w}")
    return snaps, sources, paths


def phase_p16_serve(dev, card, out_dir):
    """(d)-(f): sweep_serve, dintserve run + dintcal audit, and the
    calibration. Returns (paths, record)."""
    import contextlib
    import io
    from dint_tpu_torch import dintcal, dintserve, exp, serve
    from dint_tpu_torch.monitor import calib as CAL
    paths, out = {}, {}

    Recorded = _recorded(serve.ServeEngine)
    print(f"== phase 16 (d): exp.sweep_serve('serve_tatp', 'tatp_dense', "
          f"{P16_SERVE_N_SUB:,}): widths (256, 1024, 4096, 8192), the _sat "
          f"probe, "
          f"rates {P16_SERVE_RATES} of it, {P16_SERVE_WINDOW_S} s windows")
    t0 = time.perf_counter()
    res = PointSink()
    real = exp.ServeEngine
    exp.ServeEngine = Recorded
    try:
        exp.sweep_serve("serve_tatp", "tatp_dense", P16_SERVE_N_SUB,
                        window_s=P16_SERVE_WINDOW_S,
                        open_rates=P16_SERVE_RATES, results=res, quick=False,
                        cpb=P16_CPB, device=dev)
    finally:
        exp.ServeEngine = real
    names = ["serve_tatp_sat"] + [f"serve_tatp_r{int(f * 100)}pct"
                                  for f in P16_SERVE_RATES]
    check(sorted(res) == sorted(names)
          and len(Recorded.snaps) == len(names), f"(d) ran {sorted(res)}")
    peaks = []
    for name, snap in zip(names, Recorded.snaps):
        blk = res[name]
        want = P16_SERVE_KEYS | ({"target_rate"} if name != names[0]
                                 else set())
        check(set(blk) == want, f"{name}: exp.py's artifact keys")
        _serve_identity(name, snap)
        check(blk["serve_counters"]["serve_occupancy_lanes"]
              == blk["admitted"]
              and res.launches[name]["gather_rows"] > 0
              and res.launches[name]["lock_arbitrate"] > 0,
              f"{name}: serve_counters agree, gather_rows and "
              f"lock_arbitrate launched")
        peaks.append(res.peak[name])
        print(f"  {name}: offered {blk['offered']:,} "
              f"({blk['offered_rate']:,.1f}/s), admitted {blk['admitted']:,}, shed {blk['shed']:,}; "
              f"achieved {blk['achieved_rate']:,.1f} committed/s; queue p50 "
              f"{blk['p50_us']} p99 {blk['p99_us']} us; service p99 "
              f"{blk['service']['p99']:.1f} us; steps by width "
              f"{snap['steps_by_width']}; slo_met {blk['slo_met']}; peak "
              f"max_memory_allocated {res.peak[name]:,} B  [{card}]")
        paths[f"p16 {name}"] = res.launches[name]
        out[name] = {k: blk[k] for k in ("offered", "admitted", "shed",
                                          "achieved_rate", "offered_rate",
                                          "p50_us", "p99_us", "slo_met")}
        out[name]["service_p99_us"] = blk["service"]["p99"]
        out[name]["peak_bytes"] = res.peak[name]
    check(max(peaks) - min(peaks) < 2 ** 30,
          f"(d) the peak memory of the three points within 1 GiB of each "
          f"other ({peaks}): no point keeps an earlier point's tables")
    print(f"  (d) {time.perf_counter() - t0:.3f} s")

    print(f"== phase 16 (e): dintserve run --engine tatp_dense --size "
          f"{N_SUB:,} --journal, then dintcal audit of the journal")
    t0 = time.perf_counter()
    journal = os.path.join(out_dir, "dintserve_journal.jsonl")
    rate = 0.5 * res["serve_tatp_sat"]["achieved_rate"]
    reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = dintserve.main([
            "run", "--engine", "tatp_dense", "--size", str(N_SUB),
            "--rate", f"{rate:.1f}", "--window", "1", "--journal", journal,
            "--json", "--no-gate"])
    launches = launch_counts()
    rep = json.loads(buf.getvalue().strip().splitlines()[-1])
    _serve_identity("dintserve run", rep)
    check(rc == 0 and launches["gather_rows"] > 0,
          f"dintserve run exits 0 (slo_met {rep['slo_met']}; queue p99 "
          f"{rep['queue']['p99']:.1f} us at {rate:,.1f}/s offered; "
          f"achieved {rep['achieved_rate']:,.1f}/s)  [{card}]")
    paths["p16 dintserve run"] = launches
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = dintcal.main(["audit", journal, "--json"])
    aud = json.loads(buf.getvalue())
    check(rc == 0 and aud["n_violations"] == 0 and aud["n_entries"] > 0,
          f"dintcal audit: {aud['n_entries']} entries replayed, 0 "
          f"violations")
    out["dintserve"] = {"slo_met": rep["slo_met"],
                        "achieved_rate": rep["achieved_rate"],
                        "journal_entries": aud["n_entries"]}
    print(f"  (e) {time.perf_counter() - t0:.3f} s")

    print(f"== phase 16 (f): the calibration at the serving plane's "
          f"defaults (depth 2, {SV_CPB} cohorts a block): one serve run a "
          f"width {P16_CAL_WIDTHS} at {N_SUB:,} subscribers, "
          f"{P16_CAL_WINDOW_S} s at half the width's closed-loop rate; "
          f"dintcal gather + fit")
    t0 = time.perf_counter()
    closed = _cal_closed(dev, card, "cal_tatp")
    snaps, sources, p = _cal_serve_runs(dev, card, closed, 2, "phase 16 (f)",
                                        "p16 calibration")
    paths.update(p)
    CAL_RUNS[2] = (closed, snaps, sources)     # phase 22 (c)'s depth 2
    arts = []
    for w, snap in zip(P16_CAL_WIDTHS, snaps):
        p = os.path.join(out_dir, f"serve_tatp_w{w}.json")
        with open(p, "w") as f:
            json.dump(snap, f)
        arts.append(p)
    evidence = os.path.join(out_dir, "evidence.json")
    fresh = os.path.join(out_dir, "calib.json")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc_g = dintcal.main(["gather", *arts, "-o", evidence, "--json"])
        rc_f = dintcal.main(["fit", evidence, "-o", fresh, "--json"])
    g, fit = (json.loads(x) for x in buf.getvalue().strip().splitlines())
    check(rc_g == 0 and rc_f == 0 and g["n_samples"] > 0,
          f"dintcal gather ({g['n_samples']} samples) and fit exit 0")
    doc = CAL.load_calib(fresh)
    refit = CAL.fit_service_model(doc["samples"])
    check(refit["base_us"] == doc["model"]["base_us"]
          and refit["per_lane_ns"] == doc["model"]["per_lane_ns"]
          and doc["fit"]["widths"] == list(P16_CAL_WIDTHS),
          f"refitting the calibration's {doc['fit']['n']} samples gives its "
          f"coefficients bit for bit: base_us {doc['model']['base_us']}, "
          f"per_lane_ns {doc['model']['per_lane_ns']} (rms_us "
          f"{doc['fit']['rms_us']}, max_abs_us {doc['fit']['max_abs_us']}) "
          f"[{card}]")
    # the committed form: sources naming this phase and the card
    ev = CAL.gather_evidence(snaps, sources=sources)
    CAL.save_calib(CAL.fit_calib(ev, source="CALIB_H100.evidence.json"),
                   os.path.join(out_dir, "CALIB_H100.json"))
    with open(os.path.join(out_dir, "CALIB_H100.evidence.json"), "w") as f:
        f.write(json.dumps(ev, indent=1, sort_keys=True) + "\n")
    committed = CAL.calib_path()
    if committed.is_file():
        drift = CAL.check_calib(CAL.load_calib(committed),
                                CAL.load_evidence(evidence))
        print(f"  check_calib of the committed {committed.name} against this "
              f"evidence: {len(drift)} drift record(s)"
              + "".join(f"\n    {d['message']}" for d in drift))
    else:
        print(f"  no committed {committed.name}: nothing to check")
    buf = io.StringIO()
    with _Env(DINT_CALIB_PATH=fresh), contextlib.redirect_stdout(buf):
        rc = dintserve.main(["simulate", "--rate", "200000", "--window",
                             "0.5", "--json"])
    sim = json.loads(buf.getvalue())
    check(rc == 0 and sim["model"]["source"] == "calib"
          and sim["model"]["base_us"] == doc["model"]["base_us"],
          f"dintserve simulate under DINT_CALIB_PATH reads the fresh "
          f"calibration (source {sim['model']['source']}, final width "
          f"{sim['final_width']})")
    out["calibration"] = {"closed_rate": closed, "model": doc["model"],
                          "fit": doc["fit"],
                          "provenance": doc["provenance"]}
    print(f"  (f) {time.perf_counter() - t0:.3f} s")
    return paths, out


def phase_p16_drive(card):
    print("== phase 16 (g): python -m dint_tpu_torch.drive on the card")
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "dint_tpu_torch.drive"],
                         capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    lines = out.stdout.strip().splitlines()
    fails = [ln for ln in lines if ln.startswith("FAIL")]
    passes = sum(ln.startswith("PASS") for ln in lines)
    check(out.returncode == 0 and not fails
          and lines[-1].startswith("ALL CHECKS PASSED"),
          f"drive: every check passes ({passes} PASS) in {secs:.3f} s  "
          f"[{card}]" + (
              "" if out.returncode == 0 else
              f" (rc {out.returncode}; {fails}; stderr "
              f"{out.stderr[-2000:]})"))
    launches = json.loads(lines[-2])["launches"]
    check(launches["scan_rows"] > 0,
          f"drive's scan section launched scan_rows ({launches})")
    return {"p16 drive": launches}


def phase_sweeps(dev, card):
    import tempfile
    t0 = time.perf_counter()
    with _Env(**P16_ENV), \
            tempfile.TemporaryDirectory(prefix="dint_p16_") as tmp:
        out_dir = os.environ.get("DINT_SMOKE_OUT") or tmp
        os.makedirs(out_dir, exist_ok=True)
        paths, rec = phase_p16_pipeline(dev, card, tmp)
        gc.collect()
        torch.cuda.empty_cache()
        p, r = phase_p16_serve(dev, card, out_dir)
        paths.update(p)
        rec.update(r)
        gc.collect()
        torch.cuda.empty_cache()
        paths.update(phase_p16_drive(card))
    secs = time.perf_counter() - t0
    rec["seconds"] = secs
    print("  phase 16 record: " + json.dumps(rec, default=str))
    print(f"  phase 16: {secs:.3f} s  [{card}]")
    return paths


# ------------------------------------------------------- the mesh on one card

MESH_D = 3                       # the reference's three servers
MESH_2D = (3, 2)                 # three hosts of two chips
MESH_W = 8192                    # each shard's cohort width
MESH_CPB = 4
MESH_BLOCKS = 8                  # timed blocks after the warm one (1-D)
MESH_2D_BLOCKS = 4               # (2-D)
MESH_TEST = dict(n=4, n_sub=4 * 200, w=32, cpb=2, vw=4, log_cap=128)


def _mesh_states(dev, mesh, axis, n_sub_global, seed0=0):
    """The partitions' states at full size: `populate_device` a partition
    on its own device (generator seeds seed0 + p, the population rules of
    `populate`), the backups assembled by dense_sharded's helper; and each
    partition's populated ver sum."""
    from dint_tpu_torch.engines import tatp_dense as td
    from dint_tpu_torch.ops import u32
    from dint_tpu_torch.parallel import dense_sharded as ds
    from dint_tpu_torch.timing import synchronize
    n_loc = ds.n_sub_local(n_sub_global, mesh.size)
    t0 = time.perf_counter()
    devs = [mesh.device_of(p) for p in range(mesh.size)]
    dbs = [td.populate_device(torch.Generator(device=d).manual_seed(
        seed0 + p), n_loc, val_words=VW, log_replicas=1, device=d)
        for p, d in enumerate(devs)]
    states = ds._with_backups(mesh, axis, dbs)
    base = [int((u32.to_u64(st.db.meta) >> 1).sum()) for st in states]
    synchronize(mesh.cards)
    print(f"  {mesh.size} partitions of {n_loc:,} subscribers "
          f"({dbs[0].meta.numel():,} rows each) populated on the card with "
          f"their backups: {time.perf_counter() - t0:.3f} s")
    return states, base


def _mesh_drive(dev, card, label, run, init, drain, states, n_parts, blocks,
                cards=None):
    """One warm block and ``blocks`` timed blocks from generator seed 1,
    then the drain, launches counted from 0 over them, every card of
    ``cards`` (the mesh's; default ``dev``) synchronised around each;
    prints committed txn/s summed over the partitions, ms a step, the
    abort mix and the peak memory of each card. Returns (states, stats of
    every step, launches)."""
    from dint_tpu_torch.engines import tatp_dense as td
    from dint_tpu_torch.timing import peak_memory, synchronize
    cards = cards or (dev,)
    gen = torch.Generator(device=dev).manual_seed(1)
    reset_launches()
    carry = init(states)
    t0 = time.perf_counter()
    carry, s_warm = run(carry, gen)
    synchronize(cards)
    warm = time.perf_counter() - t0
    block_s, timed = [], []
    for _ in range(blocks):
        t0 = time.perf_counter()
        carry, s = run(carry, gen)
        synchronize(cards)
        block_s.append(time.perf_counter() - t0)
        timed.append(s)
    states, tail, *rest = drain(carry)
    synchronize(cards)
    launches = launch_counts()
    stats = torch.cat([s_warm] + timed + [tail]).cpu().numpy()
    total = stats.astype(np.int64).sum(axis=0)
    committed = int(stats[MESH_CPB:-2, td.STAT_COMMITTED].astype(
        np.int64).sum())
    secs = float(sum(block_s))
    att = int(total[td.STAT_ATTEMPTED])
    print(f"  {label}: warm block {warm:.3f} s; committed txn/s "
          f"{committed / secs:.1f} summed over {n_parts} partitions "
          f"({committed} in {secs:.6f} s, {blocks} blocks x {MESH_CPB} "
          f"steps x w={MESH_W} a partition); ms/step "
          f"{secs / (blocks * MESH_CPB) * 1e3:.6f}  [{card}]")
    print(f"  {label}: abort mix of {att}: ab_lock "
          f"{int(total[td.STAT_AB_LOCK])}, ab_missing "
          f"{int(total[td.STAT_AB_MISSING])}, ab_validate "
          f"{int(total[td.STAT_AB_VALIDATE])}; max_memory_allocated by "
          f"card {peak_memory(cards)} B")
    return states, stats, launches


def _mesh_check(label, mesh, axis, states, base, stats, launches, per_step,
                n_blocks):
    """The sharded invariants after a `_mesh_drive` run: accounting,
    magic_bad, no lock held, each backup slot equal to the partition it
    mirrors (whose sentinel row, like the slot's, is zero), log heads three
    times the version bumps, and the route's launches a shard a step."""
    from dint_tpu_torch.engines import tatp_dense as td
    from dint_tpu_torch.ops import u32
    total = stats.astype(np.int64).sum(axis=0)
    att = int(total[td.STAT_ATTEMPTED])
    check(att == (n_blocks + 1) * MESH_CPB * MESH_W * mesh.size
          and int(total[td.STAT_COMMITTED] + total[td.STAT_AB_LOCK]
                  + total[td.STAT_AB_MISSING] + total[td.STAT_AB_VALIDATE])
          == att and int(total[td.STAT_MAGIC_BAD]) == 0
          and total[td.STAT_COMMITTED] > 0,
          f"{label}: every txn attempted, accounting closes (drain "
          f"included), magic_bad == 0")
    check(not any(bool(st.db.locked.any()) for st in states),
          f"{label}: no row locked after the drain")
    n1 = states[0].db.meta.numel()
    for p, st in enumerate(states):
        for off in (1, 2):
            q = mesh.shift(p, axis, off)       # the partition that backs p up
            slot = off - 1
            check(torch.equal(states[q].bck_meta[slot * n1:(slot + 1) * n1],
                              st.db.meta)
                  and torch.equal(
                      states[q].bck_val[slot * n1 * VW:(slot + 1) * n1 * VW],
                      st.db.val),
                  f"{label}: partition {mesh.coords(p)}'s tables == backup "
                  f"slot {slot} of partition {mesh.coords(q)}", quiet=p > 0)
    bumps = sum(int((u32.to_u64(st.db.meta) >> 1).sum()) - b
                for st, b in zip(states, base))
    heads = sum(int(u32.to_u64(st.db.log.head).sum()) for st in states)
    check(bumps > 0 and heads == 3 * bumps,
          f"{label}: log heads {heads} == 3 x {bumps} version bumps (each "
          f"write logged on three partitions)")
    steps = stats.shape[0]
    want = dict.fromkeys(launches, 0)
    want.update({k: c * steps * mesh.size for k, c in per_step.items()})
    check(launches == want,
          f"{label}: launches {launches} == {per_step} a partition a step "
          f"over {steps} steps x {mesh.size} partitions")


def _mesh_recover(dev, label, mesh, states, dead, sources, n_loc, seed0=0):
    """Partition ``dead`` rebuilt from its populate (`populate_device` from
    the same seed) and each (holder, tag) ring of ``sources`` with the
    numpy `recover_tatp_dense`: val and meta equal the live tables."""
    from dint_tpu_torch import recovery
    from dint_tpu_torch.engines import tatp_dense as td
    from dint_tpu_torch.tables import log as logring
    home = mesh.device_of(dead)         # rebuilt on the lost partition's card
    snap = td.populate_device(torch.Generator(device=home).manual_seed(
        seed0 + dead), n_loc, val_words=VW, log_replicas=1, device=home)
    for holder, tag in sources:
        t0 = time.perf_counter()
        log = states[holder].db.log
        rec = recovery.recover_tatp_dense(
            snap, logring.replica_entries(log, 0), log.head,
            key_hi_filter=tag)
        check(torch.equal(rec.val, states[dead].db.val)
              and torch.equal(rec.meta, states[dead].db.meta),
              f"{label}: lost partition {mesh.coords(dead)} rebuilt from "
              f"partition {mesh.coords(holder)}'s ring (key_hi tag {tag}, "
              f"max head {int(log.head.max())} of {log.capacity} slots a "
              f"lane) in {time.perf_counter() - t0:.3f} s")
        del rec


def _mesh_wave_split(dev, card, label, run, init, drain, states,
                     trace_dir):
    """One profiled block (`_obs_profiled_block`): device ms and host ms a
    step of the shards' local steps (the tatp_dense waves) and of the
    ``dense_sharded.replicate`` wave, and the device kernels that carry
    most of replicate's time."""
    from dint_tpu_torch.monitor import attrib
    states, bd, _, unlinked, _, events = _obs_profiled_block(
        dev, label, run, init, drain, states, trace_dir, {}, MESH_CPB)
    by_name = {}
    for e, wave, _ in attrib.charge(events):
        if wave == "dint.dense_sharded.replicate":
            n, ms = by_name.get(e["name"], (0, 0.0))
            by_name[e["name"]] = (n + 1, ms + float(e.get("dur", 0)) / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:4]
    print(f"  {label}: replicate's top kernels (launches, device ms a step): "
          + "; ".join(f"{name[:72]} ({n / MESH_CPB:g}, {ms / MESH_CPB:.6f})"
                      for name, (n, ms) in top))
    split = {}
    for part, pre in (("local", "dint.tatp_dense."),
                      ("replicate", "dint.dense_sharded.replicate")):
        rows = [r for n, r in bd["waves"].items() if n.startswith(pre)]
        split[part] = {"ms_per_step": sum(r["ms_per_step"] or 0
                                          for r in rows),
                       "host_ms_per_step": sum(r["host_ms"] for r in rows)
                       / MESH_CPB}
    dev_ms = split["local"]["ms_per_step"] + split["replicate"]["ms_per_step"]
    check(split["replicate"]["ms_per_step"] > 0 and unlinked == 0,
          f"{label}: the profiled block charged device time to both parts "
          f"of a step: "
          f"local {split['local']['ms_per_step']:.6f} ms/step, replicate "
          f"{split['replicate']['ms_per_step']:.6f} ms/step (replicate's "
          f"share {split['replicate']['ms_per_step'] / dev_ms:.6f}); host "
          f"ms/step in their ranges {split['local']['host_ms_per_step']:.6f} "
          f"and {split['replicate']['host_ms_per_step']:.6f}  [{card}]")
    return states, split


def phase_mesh_cpu_vs_card(dev, card):
    c = MESH_TEST
    print(f"== phase 17 (a): the mesh, CPU against the card: "
          f"{c['n']} shards (default and fused) and 3x2 (multihost), "
          f"{c['n_sub']} subscribers, w={c['w']}, {c['cpb']} cohorts/block, "
          f"the same host-made draws")
    from dint_tpu_torch import convert
    from dint_tpu_torch.ops import u32
    from dint_tpu_torch.parallel import dense_sharded as ds
    from dint_tpu_torch.parallel import multihost as mh
    t0 = time.perf_counter()
    for label, shape in (("default", (c["n"],)), ("fused", (c["n"],)),
                         ("multihost 3x2", MESH_2D)):
        n = int(np.prod(shape))
        rng = np.random.default_rng(17)
        draws = [(rng.integers(0, 1 << 32, (c["cpb"], n, c["w"], 4),
                               dtype=np.uint64).astype(np.uint32),
                  rng.integers(0, 1 << 16, (c["cpb"], n, c["w"], 2))
                  .astype(np.int32)) for _ in range(3)]
        out = []
        for where in ("cpu", dev):
            kw = dict(w=c["w"], val_words=c["vw"],
                      cohorts_per_block=c["cpb"])
            if len(shape) == 2:
                mesh = mh.make_mesh_2d(*shape, device=where)
                states = mh.create_multihost(mesh, c["n_sub"],
                                             val_words=c["vw"],
                                             log_capacity=c["log_cap"])
                run, init, drain = mh.build_multihost_runner(
                    mesh, c["n_sub"], **kw)
            else:
                mesh = ds.make_mesh(n, device=where)
                states = ds.create_sharded(mesh, n, c["n_sub"],
                                           val_words=c["vw"],
                                           log_capacity=c["log_cap"])
                run, init, drain = ds.build_sharded_pipelined_runner(
                    mesh, n, c["n_sub"], use_fused=label == "fused", **kw)
            carry = init(states)
            stats = []
            for bits, payload in draws[:2]:
                carry, s = run.run_draws(carry, u32.from_numpy(bits, where),
                                         torch.from_numpy(payload).to(where))
                stats.append(s.cpu())
            states, tail = drain(carry, torch.from_numpy(draws[2][1][:2])
                                 .to(where))
            stats.append(tail.cpu())
            out.append((convert.sharded_state_to_numpy(states, shape),
                        torch.cat(stats).numpy()))
        (a, a_st), (b, b_st) = out
        same = [k for k in a if np.array_equal(np.asarray(a[k]),
                                               np.asarray(b[k]))]
        check(np.array_equal(a_st, b_st) and same == list(a),
              f"{label}: stats of every step and {same} bit-identical "
              f"(stats total {a_st.sum(axis=0).tolist()})")
    print(f"  phase 17 (a) seconds: {time.perf_counter() - t0:.3f}")


def phase_mesh_1d(dev, card, trace_dir):
    from dint_tpu_torch import timing
    from dint_tpu_torch.monitor import counters as mon
    from dint_tpu_torch.parallel import dense_sharded as ds
    print(f"== phase 17 (b): sharded TATP at {N_SUB:,} subscribers over "
          f"{MESH_D} shards on one card, w={MESH_W} a shard, VW={VW}, "
          f"{MESH_CPB} cohorts/block, 1 warm + {MESH_BLOCKS} timed blocks, "
          f"default and fused routes")
    t_phase = time.perf_counter()
    mesh = ds.make_mesh(MESH_D, dev)
    n_loc = ds.n_sub_local(N_SUB, MESH_D)
    paths, rec, ref = {}, {}, None
    for route, fused in (("default", False), ("fused", True)):
        label = f"tatp sharded{' fused' if fused else ''}"
        timing.reset_peak_memory(mesh.cards)
        states, base = _mesh_states(dev, mesh, ds.SHARD_AXIS, N_SUB)
        run, init, drain = ds.build_sharded_pipelined_runner(
            mesh, MESH_D, N_SUB, w=MESH_W, val_words=VW,
            cohorts_per_block=MESH_CPB, use_fused=fused)
        states, stats, launches = _mesh_drive(
            dev, card, label, run, init, drain, states, MESH_D, MESH_BLOCKS,
            mesh.cards)
        rec[route] = {"peak_bytes": timing.peak_memory(mesh.cards)}
        paths[label] = launches
        _mesh_check(label, mesh, ds.SHARD_AXIS, states, base, stats,
                    launches, TATP_PER_STEP[route], MESH_BLOCKS)
        if ref is None:
            ref = stats
            dead = 1
            _mesh_recover(dev, label, mesh, states, dead,
                          ((dead, 0), ((dead + 1) % MESH_D, dead + 1)),
                          n_loc)
        else:
            check(np.array_equal(ref, stats),
                  f"{label}: the stats of every step equal the default "
                  f"route's (same tables, same draws)")
        states, rec[route]["wave_split"] = _mesh_wave_split(
            dev, card, label, run, init, drain, states, trace_dir)
        # phase 22 (b)'s monitored block of the route
        run, init, drain = ds.build_sharded_pipelined_runner(
            mesh, MESH_D, N_SUB, w=MESH_W, val_words=VW,
            cohorts_per_block=2, use_fused=fused, monitor=True)
        carry, _ = run(init(states),
                       torch.Generator(device=dev).manual_seed(171))
        outs = drain(carry)
        keep_counters(f"dense_sharded {route}", mon.snapshot(outs[-1]))
        del states, run, init, drain, carry, outs
        gc.collect()
        torch.cuda.empty_cache()
    print(f"  phase 17 (b) seconds: {time.perf_counter() - t_phase:.3f}  "
          f"[{card}]")
    return paths, rec


def phase_mesh_2d(dev, card):
    from dint_tpu_torch import timing
    from dint_tpu_torch.parallel import multihost as mh
    h, c = MESH_2D
    print(f"== phase 17 (c): multihost TATP at {N_SUB:,} subscribers over a "
          f"{h}x{c} (host, chip) mesh on one card, w={MESH_W} a partition, "
          f"{MESH_CPB} cohorts/block, 1 warm + {MESH_2D_BLOCKS} timed blocks")
    t_phase = time.perf_counter()
    mesh = mh.make_mesh_2d(h, c, dev)
    timing.reset_peak_memory(mesh.cards)
    states, base = _mesh_states(dev, mesh, mh.DCN_AXIS, N_SUB)
    run, init, drain = mh.build_multihost_runner(
        mesh, N_SUB, w=MESH_W, val_words=VW, cohorts_per_block=MESH_CPB)
    states, stats, launches = _mesh_drive(
        dev, card, "tatp multihost", run, init, drain, states, mesh.size,
        MESH_2D_BLOCKS, mesh.cards)
    peak = timing.peak_memory(mesh.cards)
    _mesh_check("tatp multihost", mesh, mh.DCN_AXIS, states, base, stats,
                launches, TATP_PER_STEP["default"], MESH_2D_BLOCKS)
    hosts = {p: {mesh.coords(mesh.shift(p, mh.DCN_AXIS, off))[0]
                 for off in (0, 1, 2)} for p in range(mesh.size)}
    check(all(len(v) == 3 for v in hosts.values())
          and all(mesh.coords(mesh.shift(p, mh.DCN_AXIS, 1))[1]
                  == mesh.coords(p)[1] for p in range(mesh.size)),
          "fault domains: the three copies of every partition's rows sit on "
          "three hosts, at the same chip")
    dead = mesh.flat((1, 0))
    holder = mesh.flat((2, 0))
    _mesh_recover(dev, "tatp multihost", mesh, states, dead,
                  ((holder, dead + 1),), mh.n_sub_local(N_SUB, mesh.size))
    del states, run, init, drain
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  phase 17 (c) seconds: {time.perf_counter() - t_phase:.3f}  "
          f"[{card}]")
    return {"tatp multihost": launches}, {"peak_bytes": peak}


def phase_mesh_dryrun(dev, card):
    import contextlib
    import io
    from dint_tpu_torch import entry
    print("== phase 17 (d): entry.dryrun_multichip(4) on the card")
    buf = io.StringIO()
    reset_launches()
    with contextlib.redirect_stdout(buf):
        entry.dryrun_multichip(4, device=dev)
    launches = launch_counts()
    line = buf.getvalue().strip().splitlines()[-1]
    print(f"  {line}")
    check(line.startswith("dryrun_multichip ok: devices=4 ")
          and launches["gather_rows"] > 0,
          f"the dry run passes its checks on the card, its dense runner "
          f"through the kernels ({launches})  [{card}]")
    return {"p17 dryrun": launches}


def phase_mesh(dev, card):
    """Phase 17: the mesh on one card."""
    import tempfile
    t0 = time.perf_counter()
    phase_mesh_cpu_vs_card(dev, card)
    with tempfile.TemporaryDirectory(prefix="dint_p17_") as tmp:
        paths, rec = phase_mesh_1d(dev, card, tmp)
    p, rec["multihost"] = phase_mesh_2d(dev, card)
    paths.update(p)
    paths.update(phase_mesh_dryrun(dev, card))
    secs = time.perf_counter() - t0
    rec["seconds"] = secs
    print("  phase 17 record: " + json.dumps(rec, default=str))
    print(f"  phase 17: {secs:.3f} s  [{card}]")
    return paths


# ------------------------------------------------- sharded SmallBank (mesh)

MESH_SB_N = 24_000_000           # bench_smallbank.py:24-32's accounts
MESH_SB_BLOCKS = 8               # timed blocks after the warm one
# ring slots a lane: every ring gets every committed write of the mesh
# (own installs and both hops), ~1,900 a lane a step at this size
MESH_SB_LOG_CAP = 1 << 17
MESH_SB_TEST = dict(n=4, n_acc=512, w=32, cpb=2, log_cap=256)
SB_MESH_PER_STEP = {
    "default": {"gather_rows": 1},
    "hotset": {"gather_rows_hot": 1, "scatter_rows_hot": 1},
    "fused": {"gather_streams": 1, "scatter_streams": 1},
    "fused+hotset": {"gather_streams": 1, "scatter_streams": 1}}


def _sb_mesh_rings(rings, cap):
    """Each partition's recorded ring words (u32, a copy: the runner zeroes
    the ring in place at the next block) and head."""
    from dint_tpu_torch.ops import u32
    return [(u32.to_numpy(r.buf[:cap * 4]).copy(), int(r.head) & 0xFFFFFFFF)
            for r in rings]


def phase_sb_mesh_cpu_vs_card(dev, card):
    c = MESH_SB_TEST
    n, cpb, w = c["n"], c["cpb"], c["w"]
    print(f"== phase 18 (a): sharded SmallBank, CPU against the card: {n} "
          f"partitions, {c['n_acc']} accounts, w={w}, {cpb} cohorts/block, "
          f"four routes with monitor and trace, the same host-made draws")
    from dint_tpu_torch import convert
    from dint_tpu_torch.engines.types import ROUTES
    from dint_tpu_torch.ops import u32
    from dint_tpu_torch.parallel import dense_sharded_sb as dsb
    t0 = time.perf_counter()
    for route in SB_MESH_PER_STEP:
        hot, fused = ROUTES[route]
        rng = np.random.default_rng(18)
        draws = [(rng.integers(0, 1 << 32, (cpb, n, w, 5), dtype=np.uint64)
                  .astype(np.uint32),
                  rng.integers(-20, 21, (cpb, n, w)).astype(np.int32))
                 for _ in range(2)]
        out = []
        for where in ("cpu", dev):
            mesh = dsb.make_mesh(n, device=where)
            states = dsb.create_sharded_sb(mesh, n, c["n_acc"],
                                           log_capacity=c["log_cap"])
            run, init, drain = dsb.build_sharded_sb_runner(
                mesh, n, c["n_acc"], w=w, cohorts_per_block=cpb,
                use_hotset=hot, use_fused=fused, monitor=True, trace=True,
                trace_rate=1.0)
            cap = init.trace_cfg.cap
            carry = init(states)
            stats, rings = [], []
            for bits, amt in draws:
                carry, s = run.run_draws(carry, u32.from_numpy(bits, where),
                                         torch.from_numpy(amt).to(where))
                stats.append(s.cpu())
                rings.append(_sb_mesh_rings(carry[2], cap))
            states, tail, rs, cnts = drain(carry)
            stats.append(tail.cpu())
            rings.append(_sb_mesh_rings(rs, cap))
            out.append((convert.sharded_sb_to_numpy(states),
                        torch.cat(stats).numpy(), rings,
                        np.stack([u32.to_numpy(k.buf) for k in cnts])))
        (a, a_st, a_r, a_c), (b, b_st, b_r, b_c) = out
        same = [k for k in a if np.array_equal(np.asarray(a[k]),
                                               np.asarray(b[k]))]
        rings_same = all(np.array_equal(x[0], y[0]) and x[1] == y[1]
                         for wa, wb in zip(a_r, b_r) for x, y in zip(wa, wb))
        check(np.array_equal(a_st, b_st) and same == list(a) and rings_same
              and np.array_equal(a_c, b_c) and ("hot_bal" in a) == hot,
              f"{route}: stats of every step, {same}, the counters and "
              f"every window's event rings bit-identical (stats total "
              f"{a_st.astype(np.int64).sum(axis=0).tolist()})")
    print(f"  phase 18 (a) seconds: {time.perf_counter() - t0:.3f}  "
          f"[{card}]")


def _sb_mesh_states(dev, mesh):
    from dint_tpu_torch.parallel import dense_sharded_sb as dsb
    t0 = time.perf_counter()
    states = dsb.create_sharded_sb(mesh, mesh.size, MESH_SB_N,
                                   log_capacity=MESH_SB_LOG_CAP)
    torch.cuda.synchronize()
    print(f"  {mesh.size} partitions of "
          f"{dsb.n_acct_local(MESH_SB_N, mesh.size):,} accounts "
          f"({states[0].bal.numel():,} rows each) made on the card: "
          f"{time.perf_counter() - t0:.3f} s")
    return states


def _sb_mesh_drive(dev, card, label, run, init, drain, states, n_parts,
                   cards=None):
    """One warm block and MESH_SB_BLOCKS timed blocks from generator seed
    18, then the drain, launches counted from 0 over them; prints
    committed txn/s summed over the partitions, ms a step, the abort mix,
    the overflow and the peak memory. Returns (states, stats of every
    step, launches, record; with a monitored runner the record holds the
    counters' snapshot). ``cards``: the mesh's, each synchronised around
    a block and its peak memory read (default ``dev``)."""
    from dint_tpu_torch.parallel import dense_sharded_sb as dsb
    from dint_tpu_torch.timing import peak_memory, synchronize
    cards = cards or (dev,)
    gen = torch.Generator(device=dev).manual_seed(18)
    reset_launches()
    carry = init(states)
    t0 = time.perf_counter()
    carry, s_warm = run(carry, gen)
    synchronize(cards)
    warm = time.perf_counter() - t0
    block_s, timed = [], []
    for _ in range(MESH_SB_BLOCKS):
        t0 = time.perf_counter()
        carry, s = run(carry, gen)
        synchronize(cards)
        block_s.append(time.perf_counter() - t0)
        timed.append(s)
    states, tail, *rest = drain(carry)
    synchronize(cards)
    launches = launch_counts()
    stats = torch.cat([s_warm] + timed + [tail]).cpu().numpy()
    total = stats.astype(np.int64).sum(axis=0)
    # the timed blocks' steps complete the warm block's last cohort and
    # their own but the last: rows MESH_CPB .. the drain's
    committed = int(stats[MESH_CPB:-1, dsb.STAT_COMMITTED].astype(
        np.int64).sum())
    secs = float(sum(block_s))
    att = int(total[dsb.STAT_ATTEMPTED])
    rec = {"txn_s": committed / secs,
           "ms_step": secs / (MESH_SB_BLOCKS * MESH_CPB) * 1e3,
           "peak_bytes": peak_memory(cards),
           "ab_lock": int(total[dsb.STAT_AB_LOCK]),
           "ab_logic": int(total[dsb.STAT_AB_LOGIC]),
           "overflow": int(total[dsb.STAT_OVERFLOW]), "attempted": att}
    if rest:                     # a monitored runner: its counters
        from dint_tpu_torch.monitor import counters as mon
        rec["counters"] = mon.snapshot(rest[-1])
    print(f"  {label}: warm block {warm:.3f} s; committed txn/s "
          f"{rec['txn_s']:.1f} summed over {n_parts} partitions "
          f"({committed} in {secs:.6f} s, {MESH_SB_BLOCKS} blocks x "
          f"{MESH_CPB} steps x w={MESH_W} a partition); ms/step "
          f"{rec['ms_step']:.6f}; per block "
          f"{[round(b * 1e3, 3) for b in block_s]} ms  [{card}]")
    print(f"  {label}: abort mix of {att}: ab_lock {rec['ab_lock']}, "
          f"ab_logic {rec['ab_logic']}; overflow {rec['overflow']}; "
          f"max_memory_allocated by card {rec['peak_bytes']} B")
    return states, stats, launches, rec


def _sb_ring_tags(st, n_parts):
    """Live entries of one partition's ring by key_hi source tag (0 = its
    own installs, src + 1 = forwarded from src), counted on the card."""
    from dint_tpu_torch.ops import u32
    from dint_tpu_torch.tables import log as logring
    ents = logring.replica_entries(st.log, 0)
    cap = st.log.capacity
    live = (torch.arange(cap, device=ents.device)[None, :]
            < u32.to_u64(st.log.head)[:, None])
    tags = torch.where(live, ents[:, :, 1].to(torch.int64), -1)
    return [int((tags == t).sum()) for t in range(n_parts + 1)]


def _sb_mesh_check(label, mesh, states, base, stats, launches, per_step,
                   axis="shard"):
    """The sharded SmallBank invariants after a `_sb_mesh_drive` run; the
    backups of partition p sit at ``mesh.shift(p, axis, 1)`` and ``2``."""
    from dint_tpu_torch.ops import u32
    from dint_tpu_torch.parallel import dense_sharded_sb as dsb
    d = mesh.size
    total = stats.astype(np.int64).sum(axis=0)
    att = int(total[dsb.STAT_ATTEMPTED])
    check(att == (MESH_SB_BLOCKS + 1) * MESH_CPB * MESH_W * d
          and int(total[dsb.STAT_COMMITTED] + total[dsb.STAT_AB_LOCK]
                  + total[dsb.STAT_AB_LOGIC]) == att
          and int(total[dsb.STAT_MAGIC_BAD]) == 0
          and total[dsb.STAT_COMMITTED] > 0,
          f"{label}: every txn attempted, accounting closes (drain "
          f"included), magic_bad == 0")
    delta = (dsb.total_balance_global(states) - base) % (1 << 32)
    check(delta == int(total[dsb.STAT_BAL_DELTA]) % (1 << 32),
          f"{label}: global balance conservation mod 2^32 (delta {delta})")
    check(int(total[dsb.STAT_OVERFLOW]) == 0,
          f"{label}: no routed lane overflowed its destination bucket")
    t = states[0].step
    held = u32.i32_bits(t - 1)
    check(all(st.step == t for st in states)
          and not any(bool(((st.x_step == held) | (st.s_step == held)).any())
                      for st in states),
          f"{label}: every partition at step {t}, no stamp of step {t - 1} "
          f"after the drain")
    m1 = states[0].bal.numel()
    for p, st in enumerate(states):
        for off in (1, 2):
            q = mesh.shift(p, axis, off)
            check(torch.equal(states[q].bck_bal[(off - 1) * m1:off * m1],
                              st.bal),
                  f"{label}: partition {p}'s balances == backup slot "
                  f"{off - 1} of partition {q}", quiet=p > 0)
    if states[0].hot_bal is not None:
        h = states[0].hot_loc
        n_loc = dsb.n_acct_local(MESH_SB_N, d)
        ar = torch.arange(h, device=states[0].bal.device)
        idx = torch.cat([ar, n_loc + ar])
        check(all(torch.equal(st.bal[idx], st.hot_bal)
                  and torch.equal(st.x_step[idx], st.hot_x)
                  and torch.equal(st.s_step[idx], st.hot_s)
                  for st in states),
              f"{label}: the mirrors == the tables' local hot prefix "
              f"({h:,} accounts a partition, stamps and balances)")
    tags = [_sb_ring_tags(st, d) for st in states]
    own = [tg[0] for tg in tags]
    heads = [int(u32.to_u64(st.log.head).sum()) for st in states]
    check(all(heads[p] == own[p] + own[mesh.shift(p, axis, -1)]
              + own[mesh.shift(p, axis, -2)]
              and tags[p][mesh.shift(p, axis, -1) + 1]
              == own[mesh.shift(p, axis, -1)]
              and tags[p][mesh.shift(p, axis, -2) + 1]
              == own[mesh.shift(p, axis, -2)] for p in range(d))
          and min(own) > 0,
          f"{label}: every ring's heads ({heads}) == its own installs + "
          f"both hops (own installs {own}, counted by source tag)")
    hwm = max(int(u32.to_u64(st.log.head).max()) for st in states)
    check(hwm < states[0].log.capacity,
          f"{label}: head < capacity on every lane ({hwm} of "
          f"{states[0].log.capacity})")
    steps = stats.shape[0]
    want = dict.fromkeys(launches, 0)
    want.update({k: v * steps * d for k, v in per_step.items()})
    check(launches == want,
          f"{label}: launches {launches} == {per_step} a partition a step "
          f"over {steps} steps x {d} partitions")


def _sb_mesh_recover(dev, label, mesh, states, dead, axis="shard"):
    """Partition ``dead``'s balances rebuilt from its own ring and from its
    first backup holder's (``mesh.shift(dead, axis, 1)``): numpy
    `recover_sb_shard` (with the ring_owner check) and `replay_sb_shard`
    on the lost partition's card (the holder's ring copied there)."""
    from dint_tpu_torch import recovery
    from dint_tpu_torch.ops import u32
    from dint_tpu_torch.parallel import dense_sharded_sb as dsb
    from dint_tpu_torch.tables import log as logring
    want = states[dead].bal
    bal0 = torch.full_like(want, 1000)     # create_sharded_sb's balances
    bal0[-1] = 0
    for holder in (dead, mesh.shift(dead, axis, 1)):
        log = states[holder].log
        ents = logring.replica_entries(log, 0)
        t0 = time.perf_counter()
        rec = recovery.recover_sb_shard(MESH_SB_N, dead, mesh.size, ents,
                                        log.head, ring_owner=holder)
        t_np = time.perf_counter() - t0
        t0 = time.perf_counter()
        rep = recovery.replay_sb_shard(bal0, ents, log.head, dead=dead,
                                       n_shards=mesh.size)
        torch.cuda.synchronize(want.device)
        t_dev = time.perf_counter() - t0
        check(np.array_equal(rec, u32.to_numpy(want))
              and torch.equal(rep, want),
              f"{label}: lost partition {dead}'s {want.numel():,} balances "
              f"rebuilt from partition {holder}'s ring (max head "
              f"{int(u32.to_u64(log.head).max())} of {log.capacity} a lane): "
              f"numpy {t_np:.3f} s, on the card {t_dev:.3f} s")
        del rec, rep


SB_MESH_WAVES = ("gen", "route", "arbitrate", "lock_validate", "reply",
                 "install_route", "install_log", "replicate")


def _sb_mesh_wave_split(dev, card, label, run, init, drain, states,
                        trace_dir, ms_step, engine="dense_sharded_sb",
                        wave_names=SB_MESH_WAVES):
    """One profiled block (`_obs_profiled_block`): device and host ms a
    step of each ``engine`` wave, the device kernels that carry most of
    `replicate`'s and the owners' install waves' time, and the card's
    idle share of an unprofiled step of ``ms_step`` ms."""
    from dint_tpu_torch.monitor import attrib
    states, bd, _, unlinked, _, events = _obs_profiled_block(
        dev, label.replace(" ", "_"), run, init, drain, states, trace_dir,
        {}, MESH_CPB)
    for wave in ("replicate", "install_route", "install_log"):
        by_name = {}
        for e, charged, _ in attrib.charge(events):
            if charged == f"dint.{engine}.{wave}":
                n, ms = by_name.get(e["name"], (0, 0.0))
                by_name[e["name"]] = (n + 1,
                                      ms + float(e.get("dur", 0)) / 1e3)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:3]
        if top:
            print(f"  {label}: {wave}'s top kernels (launches, device ms a "
                  f"step): " + "; ".join(
                      f"{name[:72]} ({n / MESH_CPB:g}, {ms / MESH_CPB:.6f})"
                      for name, (n, ms) in top))
    split = {}
    for wave in wave_names:
        r = bd["waves"].get(f"dint.{engine}.{wave}")
        if r is not None and (r["slices"] or r["host_ms"]):
            split[wave] = {"ms_per_step": r["ms_per_step"] or 0.0,
                           "host_ms_per_step": r["host_ms"] / MESH_CPB}
    dev_ms = sum(v["ms_per_step"] for v in split.values())
    host_ms = sum(v["host_ms_per_step"] for v in split.values())
    print(f"  {label}: wave split a step (device ms, host ms): "
          + "; ".join(f"{k} {v['ms_per_step']:.6f}, "
                      f"{v['host_ms_per_step']:.6f}"
                      for k, v in split.items())
          + f"  [{card}]")
    busy = bd["total_ms"] / MESH_CPB
    check(unlinked == 0 and dev_ms > 0
          and split.get("replicate", {}).get("ms_per_step", 0) > 0,
          f"{label}: every device slice linked; {dev_ms:.6f} device ms a "
          f"step in the waves ({busy:.6f} in all) against {host_ms:.6f} host "
          f"ms; the card idle {1 - busy / ms_step:.6f} of an unprofiled "
          f"{ms_step:.6f} ms step")
    return states, {"waves": split, "device_ms": dev_ms, "host_ms": host_ms,
                    "busy_ms": busy, "idle": 1 - busy / ms_step}


def phase_sb_mesh_full(dev, card, trace_dir):
    from dint_tpu_torch import timing
    from dint_tpu_torch.engines.types import ROUTES
    from dint_tpu_torch.parallel import dense_sharded_sb as dsb
    print(f"== phase 18 (b): sharded SmallBank at {MESH_SB_N:,} accounts "
          f"over {MESH_D} partitions on one card, w={MESH_W} a partition, "
          f"{MESH_CPB} cohorts/block, 90/4 skew, 1 warm + {MESH_SB_BLOCKS} "
          f"timed blocks, default, hot and fused routes")
    t_phase = time.perf_counter()
    mesh = dsb.make_mesh(MESH_D, dev)
    paths, rec, ref = {}, {}, None
    for route in ("default", "hotset", "fused"):
        hot, fused = ROUTES[route]
        label = ("smallbank sharded" if route == "default"
                 else f"smallbank sharded {route}")
        timing.reset_peak_memory(mesh.cards)
        states = _sb_mesh_states(dev, mesh)
        base = dsb.total_balance_global(states)
        run, init, drain = dsb.build_sharded_sb_runner(
            mesh, MESH_D, MESH_SB_N, w=MESH_W, cohorts_per_block=MESH_CPB,
            use_hotset=hot, use_fused=fused)
        states, stats, launches, rec[route] = _sb_mesh_drive(
            dev, card, label, run, init, drain, states, MESH_D, mesh.cards)
        paths[label] = launches
        _sb_mesh_check(label, mesh, states, base, stats, launches,
                       SB_MESH_PER_STEP[route])
        if ref is None:
            ref = (stats, [st.bal.clone() for st in states],
                   [st.log.head.clone() for st in states])
            _sb_mesh_recover(dev, label, mesh, states, 1)
        else:
            check(np.array_equal(ref[0], stats)
                  and all(torch.equal(a, st.bal)
                          and torch.equal(h, st.log.head)
                          for a, h, st in zip(ref[1], ref[2], states)),
                  f"{label}: the stats of every step, the balances and the "
                  f"log heads equal the default route's")
        if route != "hotset":
            states, rec[route]["wave_split"] = _sb_mesh_wave_split(
                dev, card, label, run, init, drain, states, trace_dir,
                rec[route]["ms_step"])
        del states, run, init, drain
        gc.collect()
        torch.cuda.empty_cache()
    del ref
    print(f"  phase 18 (b) seconds: {time.perf_counter() - t_phase:.3f}  "
          f"[{card}]")
    return paths, rec


def phase_sb_mesh_traced(dev, card):
    from dint_tpu_torch.monitor import counters as mon
    from dint_tpu_torch.monitor import txnevents as txe
    from dint_tpu_torch.ops import u32
    from dint_tpu_torch.parallel import dense_sharded_sb as dsb
    print(f"== phase 18 (c): sharded SmallBank at {MESH_SB_N:,} accounts "
          f"over {MESH_D} partitions, default route, monitor and trace at "
          f"rate 1.0: one block and the drain")
    t0 = time.perf_counter()
    mesh = dsb.make_mesh(MESH_D, dev)
    states = _sb_mesh_states(dev, mesh)
    run, init, drain = dsb.build_sharded_sb_runner(
        mesh, MESH_D, MESH_SB_N, w=MESH_W, cohorts_per_block=MESH_CPB,
        monitor=True, trace=True, trace_rate=1.0)
    cap = init.trace_cfg.cap
    carry = init(states)
    gen = torch.Generator(device=dev).manual_seed(181)
    carry, s = run(carry, gen)
    windows = [[txe.decode(r.buf, r.head, cap) for r in carry[2]]]
    dropped = [txe.dropped_of(r.head, cap) for r in carry[2]]
    states, tail, rings, cnts = drain(carry)
    windows.append([txe.decode(r.buf, r.head, cap) for r in rings])
    dropped += [txe.dropped_of(r.head, cap) for r in rings]
    total = (torch.cat([s, tail]).cpu().numpy().astype(np.int64)
             .sum(axis=0))
    snap = mon.snapshot(np.stack([u32.to_numpy(k.buf) for k in cnts]))
    keep_counters("dense_sharded_sb", snap)
    ev = np.concatenate([e for win in windows for e in win])
    kind = (ev[:, 1] >> 24) & 0xFF
    aux = ev[:, 1] & 0xFF
    kinds = {n: int((kind == k).sum()) for k, n in txe.KIND_NAMES.items()}
    out = kind == txe.EV_OUTCOME
    causes = {n: int((out & (aux == c)).sum())
              for c, n in txe.CAUSE_NAMES.items()}
    print(f"  {len(ev):,} events (cap {cap:,} a window a partition), "
          f"kinds {kinds}, {time.perf_counter() - t0:.3f} s with the host "
          f"decode  [{card}]")
    check(snap["txn_attempted"] == total[dsb.STAT_ATTEMPTED]
          and snap["txn_committed"] == total[dsb.STAT_COMMITTED]
          and snap["ab_lock"] == total[dsb.STAT_AB_LOCK]
          and snap["ab_logic"] == total[dsb.STAT_AB_LOGIC]
          and snap["route_overflow"] == total[dsb.STAT_OVERFLOW] == 0
          and snap["repl_push_hop1"] == snap["repl_push_hop2"]
          == snap["install_writes"] == snap["log_appends"] > 0
          and snap["lock_requests"] == snap["lock_granted"]
          + snap["lock_rejected"],
          f"the counters reconcile with the stats "
          f"({total.tolist()}; installs {snap['install_writes']}, each "
          f"pushed over both hops)")
    check(kinds["route"] == kinds["lock"] == snap["lock_requests"] > 0
          and kinds["vote"] == kinds["outcome"] == snap["txn_attempted"]
          and kinds["install"] == snap["install_writes"]
          and kinds["repl"] == snap["repl_push_hop1"]
          + snap["repl_push_hop2"]
          and causes["commit"] == snap["txn_committed"]
          and causes["ab_lock"] == snap["ab_lock"]
          and causes["ab_logic"] == snap["ab_logic"],
          "the events reconcile with the counters (route == lock == "
          "lock_requests, vote == outcome == attempted, install, repl, each "
          "cause)")
    check(dropped == [0] * len(dropped) and snap["trace_dropped"] == 0,
          "no window of any partition dropped an event")
    del states, carry, rings, cnts
    gc.collect()
    torch.cuda.empty_cache()
    return {"events": len(ev), "seconds": time.perf_counter() - t0}


def phase_sb_mesh_dryrun(dev, card):
    import contextlib
    import io
    from dint_tpu_torch import entry
    print(f"== phase 18 (d): entry.dryrun_multichip({MESH_D}) on the card")
    buf = io.StringIO()
    reset_launches()
    with contextlib.redirect_stdout(buf):
        entry.dryrun_multichip(MESH_D, device=dev)
    launches = launch_counts()
    line = buf.getvalue().strip().splitlines()[-1]
    print(f"  {line}")
    fields = dict(kv.split("=") for kv in line.split(": ", 1)[1].split())
    check(line.startswith(f"dryrun_multichip ok: devices={MESH_D} ")
          and int(fields["dense_sb_committed"]) > 0
          and fields["conservation_ok"] == "True"
          and launches["gather_rows"] > 0,
          f"the dry run passes its checks on the card with its SmallBank "
          f"fields, its dense runners through the kernels ({launches})  "
          f"[{card}]")
    return {"p18 dryrun": launches}


def phase_sb_mesh(dev, card):
    """Phase 18: sharded SmallBank on one card."""
    import tempfile
    t0 = time.perf_counter()
    phase_sb_mesh_cpu_vs_card(dev, card)
    with tempfile.TemporaryDirectory(prefix="dint_p18_") as tmp:
        paths, rec = phase_sb_mesh_full(dev, card, tmp)
    rec["traced"] = phase_sb_mesh_traced(dev, card)
    paths.update(phase_sb_mesh_dryrun(dev, card))
    secs = time.perf_counter() - t0
    rec["seconds"] = secs
    print("  phase 18 record: " + json.dumps(rec, default=str))
    print(f"  phase 18: {secs:.3f} s  [{card}]")
    return paths


# ----------------------------------- SmallBank on the 2-D mesh and serving

MH_SHAPE = (3, 2)                # PLAN.json's multihost_3x2: three hosts
MH_TEST = dict(shape=(3, 2), n_acc=512, w=32, cpb=2, log_cap=256)
# the routes of phase 19 (a), every one monitored
MH_ROUTES = {
    "hier": dict(hierarchical=True),
    "flat": dict(hierarchical=False),
    "serve": dict(hierarchical=True, serve=True),
    "overlap": dict(hierarchical=True, serve=True, overlap=True),
    "trace": dict(hierarchical=True, trace=True, trace_rate=1.0),
}
MH_WAVES = ("gen", "route", "arbitrate", "reply", "install_route",
            "replicate")
MH_SERVE_WIDTHS = (256, 1024, 4096, 8192)
MH_SERVE_WINDOW_S = 2.0
MH_SERVE_LOADS = (0.5, 1.2)      # of (b)'s committed txn/s
MH_EXP_RATES = (0.5,)            # (d)'s open-rate ladder: one rung
MH_EXP_WINDOW_S = 2.0            # (d)'s windows
MH_AB_BLOCKS = 4                 # (b)'s exchange A/B: timed blocks a turn


def _mh_identities(label, rep, d):
    """The mesh serving plane's ledger (tests/test_dintmesh.py's
    `_identities`)."""
    c = rep["counters"]
    served = sum(int(w) * n for w, n in rep["steps_by_width"].items())
    check(rep["offered"] == rep["admitted"] + rep["shed"]
          and c["serve_occupancy_lanes"] == rep["admitted"]
          == rep["attempted"]
          and c["serve_occupancy_lanes"] + c["serve_padded_lanes"]
          == served * d
          and c["serve_shed_lanes"] == rep["shed"]
          and sum(h["admitted"] for h in rep["per_host"]) == rep["admitted"]
          and sum(h["shed"] for h in rep["per_host"]) == rep["shed"]
          and c["route_ici_lanes"] + c["route_dcn_lanes"]
          == c["lock_requests"] + c["install_writes"],
          f"{label}: occupancy + padded == served x {d} ({served:,}), the "
          f"shed mirrored ({rep['shed']:,}), the per-host sums equal the "
          f"totals, route_ici + route_dcn == lock_requests + "
          f"install_writes")


def phase_mh_sb_cpu_vs_card(dev, card):
    c = MH_TEST
    (h, ci), cpb, w = c["shape"], c["cpb"], c["w"]
    d = h * ci
    print(f"== phase 19 (a): SmallBank on the {h}x{ci} mesh, CPU against "
          f"the card: {c['n_acc']} accounts, w={w}, {cpb} cohorts/block, "
          f"routes {list(MH_ROUTES)} with monitor, the same host-made "
          f"draws and occupancies")
    from dint_tpu_torch import convert
    from dint_tpu_torch.ops import u32
    from dint_tpu_torch.parallel import multihost_sb as mhs
    t0 = time.perf_counter()
    for route, kw in MH_ROUTES.items():
        rng = np.random.default_rng(19)
        draws = [(rng.integers(0, 1 << 32, (cpb, d, w, 5), dtype=np.uint64)
                  .astype(np.uint32),
                  rng.integers(-20, 21, (cpb, d, w)).astype(np.int32),
                  rng.integers(0, w + 1, (h, ci, cpb)).astype(np.int32),
                  rng.integers(0, 4, (h, ci, cpb)).astype(np.int32))
                 for _ in range(3)]
        serve = kw.get("serve", False)
        trace = kw.get("trace", False)
        out = []
        for where in ("cpu", dev):
            mesh = mhs.make_mesh_2d(h, ci, device=where)
            states = mhs.create_multihost_sb(mesh, c["n_acc"],
                                             log_capacity=c["log_cap"])
            run, init, drain = mhs.build_multihost_sb_runner(
                mesh, c["n_acc"], w=w, cohorts_per_block=cpb, monitor=True,
                **kw)
            cap = init.trace_cfg.cap if trace else None
            carry = init(states)
            stats, rings = [], []
            for bits, amt, occ, shed in draws:
                args = ((torch.from_numpy(occ).to(where),
                         torch.from_numpy(shed).to(where)) if serve else ())
                carry, s = run.run_draws(carry, u32.from_numpy(bits, where),
                                         torch.from_numpy(amt).to(where),
                                         *args)
                stats.append(s.cpu())
                if trace:
                    rings.append(_sb_mesh_rings(carry[2], cap))
            states, tail, *rest = drain(carry)
            stats.append(tail.cpu())
            if trace:
                rings.append(_sb_mesh_rings(rest[0], cap))
            out.append((convert.multihost_sb_to_numpy(states, (h, ci)),
                        torch.cat(stats).numpy(), rings,
                        np.stack([u32.to_numpy(k.buf) for k in rest[-1]])))
        (a, a_st, a_r, a_c), (b, b_st, b_r, b_c) = out
        same = [k for k in a if np.array_equal(np.asarray(a[k]),
                                               np.asarray(b[k]))]
        rings_same = all(np.array_equal(x[0], y[0]) and x[1] == y[1]
                         for wa, wb in zip(a_r, b_r) for x, y in zip(wa, wb))
        check(np.array_equal(a_st, b_st) and same == list(a) and rings_same
              and np.array_equal(a_c, b_c) and (len(a_r) > 0) == trace,
              f"{route}: stats of every step, {same}, the counters"
              + (" and every window's event rings" if trace else "")
              + f" bit-identical (stats total "
              f"{a_st.astype(np.int64).sum(axis=0).tolist()})")
    print(f"  phase 19 (a) seconds: {time.perf_counter() - t0:.3f}  "
          f"[{card}]")


def phase_mh_sb_full(dev, card, trace_dir):
    from dint_tpu_torch import timing
    from dint_tpu_torch.parallel import multihost_sb as mhs
    h, ci = MH_SHAPE
    d = h * ci
    print(f"== phase 19 (b): SmallBank at {MESH_SB_N:,} accounts over "
          f"{h} hosts x {ci} chips on one card, w={MESH_W} a partition, "
          f"{MESH_CPB} cohorts/block, 90/4 skew, monitored, 1 warm + "
          f"{MESH_SB_BLOCKS} timed blocks, the hierarchical and the flat "
          f"exchange")
    t_phase = time.perf_counter()
    mesh = mhs.make_mesh_2d(h, ci, dev)
    paths, rec, ref = {}, {}, None
    for route, hier in (("hier", True), ("flat", False)):
        label = ("smallbank multihost" if hier
                 else "smallbank multihost flat")
        timing.reset_peak_memory(mesh.cards)
        t0 = time.perf_counter()
        states = mhs.create_multihost_sb(mesh, MESH_SB_N,
                                         log_capacity=MESH_SB_LOG_CAP)
        torch.cuda.synchronize()
        print(f"  {d} partitions of "
              f"{mhs.n_acct_local(MESH_SB_N, d):,} accounts "
              f"({states[0].bal.numel():,} rows each) made on the card: "
              f"{time.perf_counter() - t0:.3f} s")
        base = mhs.total_balance_global(states)
        run, init, drain = mhs.build_multihost_sb_runner(
            mesh, MESH_SB_N, w=MESH_W, cohorts_per_block=MESH_CPB,
            hierarchical=hier, monitor=True)
        states, stats, launches, rec[route] = _sb_mesh_drive(
            dev, card, label, run, init, drain, states, d, mesh.cards)
        paths[label] = launches
        _sb_mesh_check(label, mesh, states, base, stats, launches,
                       SB_MESH_PER_STEP["default"], axis=mhs.DCN_AXIS)
        cnt = rec[route].pop("counters")
        keep_counters("multihost_sb " + ("hierarchical" if hier else "flat"),
                      cnt)
        ici, dcn = cnt["route_ici_lanes"], cnt["route_dcn_lanes"]
        rec[route]["route_ici_lanes"], rec[route]["route_dcn_lanes"] = \
            ici, dcn
        check(ici + dcn == cnt["lock_requests"] + cnt["install_writes"]
              and cnt["txn_committed"] == int(stats[:, mhs.STAT_COMMITTED]
                                              .astype(np.int64).sum())
              and 0.5 < dcn / (ici + dcn) < 0.8,
              f"{label}: the lane split ICI {ici:,} / DCN {dcn:,} (DCN "
              f"share {dcn / (ici + dcn):.6f}; two hosts of three are "
              f"remote) == lock_requests + install_writes; the counters "
              f"reconcile with the stats")
        if ref is None:
            ref = (stats, [(st.bal.clone(), st.bck_bal.clone(),
                            st.log.head.clone()) for st in states])
            _sb_mesh_recover(dev, label, mesh, states, mesh.flat((1, 0)),
                             axis=mhs.DCN_AXIS)
        else:
            check(np.array_equal(ref[0], stats)
                  and all(torch.equal(a, st.bal) and torch.equal(b, st.bck_bal)
                          and torch.equal(hd, st.log.head)
                          for (a, b, hd), st in zip(ref[1], states)),
                  f"{label}: the stats of every step, the balances, backups "
                  f"and log heads equal the hierarchical route's")
        states, rec[route]["wave_split"] = _sb_mesh_wave_split(
            dev, card, label, run, init, drain, states, trace_dir,
            rec[route]["ms_step"], engine="multihost_sb",
            wave_names=MH_WAVES)
        del states, run, init, drain
        gc.collect()
        torch.cuda.empty_cache()
    del ref
    hs, fs = (rec[r]["wave_split"]["host_ms"] for r in ("hier", "flat"))
    print(f"  host ms a step in the waves: hierarchical {hs:.6f}, flat "
          f"{fs:.6f} (ratio {hs / fs:.6f})  [{card}]")
    rec["ab"] = _mh_exchange_ab(dev, card, mesh)
    print(f"  phase 19 (b) seconds: {time.perf_counter() - t_phase:.3f}  "
          f"[{card}]")
    return paths, rec


def _mh_exchange_ab(dev, card, mesh):
    """The two exchanges in turns (flat, hier, hier, flat), unmonitored,
    each from fresh tables and generator seed 18: one warm block, then
    MH_AB_BLOCKS timed blocks; ms a step of each turn, the turns' stats
    identical."""
    from dint_tpu_torch.parallel import multihost_sb as mhs
    ms, ref = {"hier": [], "flat": []}, None
    for route in ("flat", "hier", "hier", "flat"):
        states = mhs.create_multihost_sb(mesh, MESH_SB_N,
                                         log_capacity=MESH_SB_LOG_CAP)
        run, init, drain = mhs.build_multihost_sb_runner(
            mesh, MESH_SB_N, w=MESH_W, cohorts_per_block=MESH_CPB,
            hierarchical=route == "hier")
        carry = init(states)
        gen = torch.Generator(device=dev).manual_seed(18)
        carry, _ = run(carry, gen)
        torch.cuda.synchronize()
        secs, stats = 0.0, []
        for _ in range(MH_AB_BLOCKS):
            t0 = time.perf_counter()
            carry, s = run(carry, gen)
            torch.cuda.synchronize()
            secs += time.perf_counter() - t0
            stats.append(s)
        stats = torch.cat(stats).cpu().numpy()
        ms[route].append(secs / (MH_AB_BLOCKS * MESH_CPB) * 1e3)
        drain(carry)
        if ref is None:
            ref = stats
        check(np.array_equal(ref, stats), f"exchange A/B: the {route} "
              f"turn's stats equal the first turn's", quiet=True)
        del states, carry, run, init, drain
        gc.collect()
        torch.cuda.empty_cache()
    h, f = (sum(ms[r]) / 2 for r in ("hier", "flat"))
    print(f"  exchange A/B in turns (flat, hier, hier, flat), unmonitored, "
          f"ms a step: hierarchical {ms['hier']}, flat {ms['flat']}; means "
          f"{h:.6f} and {f:.6f} (hierarchical / flat {h / f:.6f})  "
          f"[{card}]")
    return {"hier_ms_step": ms["hier"], "flat_ms_step": ms["flat"],
            "hier_over_flat": h / f}


def phase_mh_sb_serve(dev, card, txn_s):
    from dint_tpu_torch.serve import (ControllerCfg, MeshServeEngine,
                                      poisson_schedule)
    h, ci = MH_SHAPE
    d = h * ci
    print(f"== phase 19 (c): MeshServeEngine over {h}x{ci} at "
          f"{MESH_SB_N:,} accounts, widths {MH_SERVE_WIDTHS}, cpb "
          f"{SV_CPB}, depth 2, monitor, wall clock: {MH_SERVE_WINDOW_S} s "
          f"Poisson windows at {MH_SERVE_LOADS} of (b)'s "
          f"{txn_s:,.1f} committed txn/s, overlap off and on")
    t0 = time.perf_counter()
    paths, out = {}, {}
    for overlap in (False, True):
        for load in MH_SERVE_LOADS:
            rate = load * txn_s
            label = (f"p19 serve {'overlap' if overlap else 'plain'} "
                     f"{int(load * 100)}pct")
            eng = MeshServeEngine(
                MESH_SB_N, mesh_shape=MH_SHAPE,
                cfg=ControllerCfg(widths=MH_SERVE_WIDTHS),
                cohorts_per_block=SV_CPB, depth=2, monitor=True,
                overlap=overlap, device=dev)
            eng.warmup()
            sched = poisson_schedule(rate, MH_SERVE_WINDOW_S, seed=19)
            torch.cuda.reset_peak_memory_stats(dev)
            reset_launches()
            eng.run(sched)
            eng.close()
            launches = launch_counts()
            rep = eng.snapshot()
            del eng
            gc.collect()
            torch.cuda.empty_cache()
            _mh_identities(label, rep, d)
            keep_counters("serve mesh", rep["counters"])
            q, s = rep["queue"], rep["service"]
            shed_share = rep["shed"] / max(rep["offered"], 1)
            check(rep["committed"] > 0 and launches["gather_rows"] > 0
                  and rep["mesh"]["overlap"] is overlap,
                  f"{label}: offered {rep['offered']:,} at "
                  f"{rep['offered_rate']:,.1f}/s, achieved "
                  f"{rep['achieved_rate']:,.1f} committed/s; queue p50 "
                  f"{q['p50']:.1f} p99 {q['p99']:.1f} us, service p50 "
                  f"{s['p50']:.1f} p99 {s['p99']:.1f} us; shed share "
                  f"{shed_share:.6f}; per host "
                  f"{[(x['admitted'], x['shed']) for x in rep['per_host']]};"
                  f" steps by width {rep['steps_by_width']}; prefetched "
                  f"{rep['counters']['route_prefetch_lanes']:,} lanes; "
                  f"gather_rows {launches['gather_rows']}  [{card}]")
            if overlap:
                check(rep["counters"]["route_prefetch_lanes"]
                      == rep["counters"]["lock_requests"],
                      f"{label}: every lock lane prefetched "
                      f"(route_prefetch_lanes == lock_requests)")
            paths[label] = launches
            out[label] = {"offered_rate": rep["offered_rate"],
                          "achieved_rate": rep["achieved_rate"],
                          "queue_p50_us": q["p50"], "queue_p99_us": q["p99"],
                          "service_p50_us": s["p50"],
                          "service_p99_us": s["p99"],
                          "shed_share": shed_share,
                          "per_host": rep["per_host"],
                          "steps_by_width": rep["steps_by_width"],
                          "slo_met": rep["slo_met"]}
    print(f"  phase 19 (c) seconds: {time.perf_counter() - t0:.3f}  "
          f"[{card}]")
    return paths, out


def phase_mh_sb_exp(dev, card):
    from dint_tpu_torch import exp
    from dint_tpu_torch import serve
    h, ci = MH_SHAPE
    print(f"== phase 19 (d): exp's mesh legs at DINT_BENCH_MESH={h}x{ci}, "
          f"{MESH_SB_N:,} accounts: sweep_multihost_sb (hier and flat, "
          f"w={MESH_W}, {MH_EXP_WINDOW_S} s windows) and sweep_serve_mesh "
          f"(the _sat probe, rates {MH_EXP_RATES} of it, "
          f"{MH_EXP_WINDOW_S} s windows)")
    t0 = time.perf_counter()
    paths, out = {}, {}

    Recorded = _recorded(serve.MeshServeEngine)
    res = PointSink()
    real = exp.MeshServeEngine
    exp.MeshServeEngine = Recorded
    try:
        with _Env(DINT_BENCH_MESH=f"{h}x{ci}", DINT_SERVE_OVERLAP=None,
                  **P16_ENV):
            exp.sweep_multihost_sb(MESH_SB_N, width=MESH_W, cpb=P16_CPB,
                                   window_s=MH_EXP_WINDOW_S, results=res,
                                   device=dev)
            exp.sweep_serve_mesh("serve_mesh", MESH_SB_N,
                                 window_s=MH_EXP_WINDOW_S,
                                 open_rates=MH_EXP_RATES, results=res,
                                 quick=False, cpb=P16_CPB, device=dev)
    finally:
        exp.MeshServeEngine = real
    closed = [f"multihost_sb_{t}_closed_w{MESH_W}" for t in ("hier", "flat")]
    serve_names = ["serve_mesh_sat"] + [f"serve_mesh_r{int(f * 100)}pct"
                                        for f in MH_EXP_RATES]
    check(sorted(res) == sorted(closed + serve_names)
          and len(Recorded.snaps) == len(serve_names),
          f"(d) ran {sorted(res)}")
    # exp.py's keys, and the port's record of the cards the mesh ran on
    mesh_keys = {"n_shards", "mesh", "hierarchical", "route_overflow",
                 "cards"}
    for name in closed:
        blk = _p16_point(card, res, name, "closed", "smallbank", mesh_keys)
        check(blk["n_shards"] == h * ci
              and blk["mesh"] == {"n_hosts": h, "n_ici": ci,
                                  "axes": ["dcn", "ici"]}
              and blk["hierarchical"] == name.startswith("multihost_sb_hier")
              and blk["route_overflow"] == 0 and blk["cards"] == [str(dev)]
              and res.launches[name]["gather_rows"] > 0,
              f"{name}: the mesh keys, no overflow, gather_rows launched")
        paths[f"p19 {name}"] = res.launches[name]
        out[name] = {k: blk[k] for k in ("goodput", "throughput",
                                          "abort_rate", "p50_us", "p99_us")}
    for name, snap in zip(serve_names, Recorded.snaps):
        blk = res[name]
        want = P16_SERVE_KEYS | {"mesh", "per_host", "cards"} | (
            {"target_rate"} if name != serve_names[0] else set())
        check(set(blk) == want and blk["cards"] == [str(dev)],
              f"{name}: exp.py's artifact keys and the cards"
              + ("" if set(blk) == want else
                 f" (extra {set(blk) - want}, missing {want - set(blk)})"))
        _mh_identities(name, snap, h * ci)
        check(blk["serve_counters"]["serve_occupancy_lanes"]
              == blk["admitted"] and res.launches[name]["gather_rows"] > 0,
              f"{name}: serve_counters agree, gather_rows launched")
        print(f"  {name}: offered {blk['offered']:,} "
              f"({blk['offered_rate']:,.1f}/s), admitted {blk['admitted']:,}"
              f", shed {blk['shed']:,}; achieved {blk['achieved_rate']:,.1f} "
              f"committed/s; queue p50 {blk['p50_us']} p99 {blk['p99_us']} "
              f"us; service p99 {blk['service']['p99']:.1f} us; steps by "
              f"width {snap['steps_by_width']}; peak "
              f"{res.peak[name]:,} B  [{card}]")
        paths[f"p19 {name}"] = res.launches[name]
        out[name] = {k: blk[k] for k in ("offered_rate", "achieved_rate",
                                          "p50_us", "p99_us", "shed")}
    print(f"  phase 19 (d) seconds: {time.perf_counter() - t0:.3f}  "
          f"[{card}]")
    return paths, out


def phase_mh_sb(dev, card):
    """Phase 19: SmallBank on the 2-D mesh and the mesh serving plane."""
    import tempfile
    t0 = time.perf_counter()
    phase_mh_sb_cpu_vs_card(dev, card)
    with tempfile.TemporaryDirectory(prefix="dint_p19_") as tmp:
        paths, rec = phase_mh_sb_full(dev, card, tmp)
    CLOSED_LOOP_RATE["mh_sb hier"] = rec["hier"]["txn_s"]
    serve_paths, rec["serve"] = phase_mh_sb_serve(dev, card,
                                                  rec["hier"]["txn_s"])
    paths.update(serve_paths)
    gc.collect()
    torch.cuda.empty_cache()
    exp_paths, rec["exp"] = phase_mh_sb_exp(dev, card)
    paths.update(exp_paths)
    secs = time.perf_counter() - t0
    rec["seconds"] = secs
    print("  phase 19 record: " + json.dumps(rec, default=str))
    print(f"  phase 19: {secs:.3f} s  [{card}]")
    return paths


P20_TARGETS = ("tatp_dense/block@fused", "tatp_dense/block@hot",
               "smallbank_dense/block")
P20_KERNELS = {
    "tatp_dense/block@fused": ("gather_rows", "lock_validate",
                               "scatter_streams"),
    "tatp_dense/block@hot": ("gather_rows_hot", "lock_arbitrate",
                             "scatter_rows_hot"),
    "smallbank_dense/block": ("gather_rows",),
}
P20_CALLS = 1000
P20_GROUPS = 5
# dintlint's five trace-level passes (the cost and durability gates are
# phase 21's: their budgets hold at the lint geometry only)
P20_PASSES = ("scatter_race", "aliasing", "purity", "u64_overflow",
              "protocol")


def _p20_keys(trace, passes=P20_PASSES):
    """(pass, code, site) of every finding of ``passes`` on a trace, the
    port's allowlist applied; and the unsuppressed errors."""
    from dint_tpu_torch import analysis
    from dint_tpu_torch.analysis import allowlist as al
    fs = []
    for name in passes:
        fs += analysis.PASSES[name](trace)
    fs = al.apply(analysis._dedup(fs), al.load(analysis.DEFAULT_ALLOWLIST),
                  check_unused=False)
    return ({(f.pass_name, f.code, f.site) for f in fs},
            [str(f) for f in fs if f.severity == "error" and not f.suppressed],
            fs)


def _p20_host_us(fn):
    """Host microseconds a call of ``fn``: P20_CALLS calls back to back,
    the median over P20_GROUPS groups (the stream drained between
    groups, outside the timing)."""
    per = []
    for _ in range(P20_GROUPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(P20_CALLS):
            fn()
        per.append((time.perf_counter() - t0) / P20_CALLS * 1e6)
        torch.cuda.synchronize()
    return float(np.median(per)), per


def phase_lint(dev, card):
    """Phase 20: the static analysis on the card's traces, and the cost of
    the dint:: dispatcher on the host."""
    import dataclasses
    from dint_tpu_torch.analysis import core
    from dint_tpu_torch.analysis import targets as T
    from dint_tpu_torch.analysis.passes.purity import HOST_SYNC_CODES
    from dint_tpu_torch.ops import library
    from dint_tpu_torch.ops import row_kernels as rk
    print("== phase 20: dintlint on the card's traces; dint:: dispatch cost")
    t0 = time.perf_counter()
    full = dataclasses.replace(T.LINT, device=dev.type, n_sub=N_SUB,
                               n_acct=SB_N, w=W, vw=VW, logcap=1 << 16)
    geoms = {"lint": dataclasses.replace(T.LINT, device=dev.type),
             "full": full}
    paths, rec = {}, {"traces": {}}
    for name in P20_TARGETS:
        cpu = T.build(name, T.LINT)
        check(cpu.gm is not None, f"{name}: the CPU trace builds")
        want, cpu_errs, _ = _p20_keys(cpu)
        check(not cpu_errs, f"{name}: no unsuppressed error on the CPU "
                            f"trace {cpu_errs}")
        for gname, geom in geoms.items():
            reset_launches()
            ts = time.perf_counter()
            tr = T.build(name, geom)
            secs = time.perf_counter() - ts
            torch.cuda.synchronize()
            launches = launch_counts()
            paths[f"p20 trace {name} {gname}"] = launches
            check(tr.gm is not None and tr.device == dev.type,
                  f"{name} ({gname}): traced on CUDA tensors "
                  f"({tr.trace_error})")
            nodes = {}
            for ctx in core.walk(tr):
                if ctx.in_kernel:
                    k = ctx.prim.split("::")[1]
                    nodes[k] = nodes.get(k, 0) + 1
            expect = {k: geom.cpb for k in P20_KERNELS[name]}
            check(nodes == expect, f"{name} ({gname}): one dint:: node a "
                                   f"kernel call a step {nodes}")
            check(all(launches[k] == n for k, n in nodes.items())
                  and sum(launches.values()) == sum(nodes.values()),
                  f"{name} ({gname}): the dint:: nodes equal the wrappers' "
                  f"launches {launches}")
            got, errs, fs = _p20_keys(tr)
            check(not errs, f"{name} ({gname}): no unsuppressed error {errs}")
            check(got == want, f"{name} ({gname}): the same (pass, code, "
                               f"site) set as the CPU trace "
                               f"{sorted(got ^ want)}")
            syncs = {}
            for f in fs:
                if f.pass_name == "purity" and f.code in HOST_SYNC_CODES:
                    syncs[f.code] = syncs.get(f.code, 0) + f.count
            per_step = {k: v / geom.cpb for k, v in syncs.items()}
            rec["traces"][f"{name} {gname}"] = {
                "trace_s": secs, "nodes": len(tr.graph.nodes),
                "dint_nodes": nodes, "findings": len(fs),
                "host_syncs_per_step": per_step}
            print(f"  {name} ({gname}): trace {secs:.3f} s, "
                  f"{len(tr.graph.nodes)} nodes, host syncs a step "
                  f"{per_step}")
            del tr
            gc.collect()
            torch.cuda.empty_cache()
    # (c) the dispatcher's host cost: wrapper, torch.ops.dint, direct launch
    g = torch.Generator(device=dev).manual_seed(20)
    tab = torch.randint(0, 1 << 30, (1 << 20,), dtype=torch.int32,
                        device=dev, generator=g)
    idx = torch.randint(0, 1 << 20, (16384,), dtype=torch.int32, device=dev,
                        generator=g)
    tabs = [torch.zeros(1 << 16, dtype=torch.int32, device=dev)
            for _ in range(3)]
    sidx = [torch.randperm(1 << 16, device=dev, generator=g)[:8192].to(
        torch.int32) for _ in range(3)]
    vals = [torch.randint(0, 9, (8192,), dtype=torch.int32, device=dev,
                          generator=g) for _ in range(3)]
    calls = {
        "gather_rows": {
            "wrapper": lambda: rk.gather_rows(tab, idx, 1),
            "op": lambda: library.op("gather_rows")([tab], [idx], [1]),
            "direct": lambda: rk._gather_dev(rk.gather_rows, (tab,), None,
                                             (idx,), None, (1,))},
        "scatter_streams": {
            "wrapper": lambda: rk.scatter_streams(tabs, sidx, vals,
                                                  [1, 1, 1]),
            "op": lambda: library.op("scatter_streams")(tabs, sidx, vals,
                                                        [1, 1, 1]),
            "direct": lambda: rk._scatter_dev(
                rk.scatter_streams, tuple(tabs), None, tuple(sidx), None,
                None, tuple(vals), (1, 1, 1))},
    }
    want_g = rk.gather_rows_ref(tab, idx, 1)
    check(torch.equal(calls["gather_rows"]["op"]()[0], want_g)
          and torch.equal(calls["gather_rows"]["direct"]()[0], want_g),
          "gather_rows through torch.ops.dint and the direct launch equal "
          "the plain version")
    rec["dispatch_us"] = {}
    for kname, forms in calls.items():
        order = ["direct", "op", "wrapper", "wrapper", "op", "direct"]
        got = {f: [] for f in forms}
        for form in order:          # in turns, P N N P
            med, _ = _p20_host_us(forms[form])
            got[form].append(med)
        r = {f: float(np.mean(v)) for f, v in got.items()}
        r["turns"] = got
        r["op_over_direct_us"] = r["op"] - r["direct"]
        r["wrapper_over_direct_us"] = r["wrapper"] - r["direct"]
        rec["dispatch_us"][kname] = r
        print(f"  {kname}: host us a call: direct {r['direct']:.3f}, "
              f"torch.ops.dint {r['op']:.3f}, wrapper {r['wrapper']:.3f} "
              f"(+{r['wrapper_over_direct_us']:.3f})  [{card}]")
    reset_launches()
    rec["seconds"] = time.perf_counter() - t0
    print("  phase 20 record: " + json.dumps(rec, default=str))
    print(f"  phase 20: {rec['seconds']:.3f} s  [{card}]")
    return paths


# ------------------------------------------- phase 21: dintcost, dintdur


P21_LINT = ("tatp_dense/block", "tatp_dense/block@fused",
            "tatp_dense/block@hot", "smallbank_dense/block",
            "smallbank_dense/block@fused", "store/block@scan",
            "dense_sharded_sb/block", "recovery/tatp_dense",
            "recovery/smallbank_dense", "recovery/sb_shard")
P21_PASSES = ("cost_budget", "durability")
# full width: target -> (engine, use_fused)
P21_FULL = {"tatp_dense/block": ("tatp", False),
            "tatp_dense/block@fused": ("tatp", True),
            "smallbank_dense/block": ("smallbank", False),
            "smallbank_dense/block@fused": ("smallbank", True)}


def _p21_model_key(model):
    return (model.wave_bytes_per_step(), model.wave_dispatches_per_step(),
            model.footprint_bytes)


def _p21_storages(obj):
    """{storage ptr: bytes} of the distinct storages of a carry's tensors."""
    from dint_tpu_torch.analysis import targets as T
    out = {}
    for _, t in T.leaves(obj):
        st = t.untyped_storage()
        out[st.data_ptr()] = max(out.get(st.data_ptr(), 0), st.nbytes())
    return out


def _p21_lint(dev):
    """(a): the lint geometry traced on CUDA tensors gives the CPU
    trace's cost model and the CPU trace's cost and durability findings."""
    import dataclasses
    from dint_tpu_torch.analysis import cost
    from dint_tpu_torch.analysis import targets as T
    on_card = dataclasses.replace(T.LINT, device=dev.type)
    rec = {}
    for name in P21_LINT:
        meta = T.TARGET_COST[name]
        models, keys = [], []
        for geom in (T.LINT, on_card):
            tr = T.build(name, geom)
            check(tr.gm is not None and tr.device == geom.device,
                  f"{name}: traced on {geom.device} ({tr.trace_error})")
            models.append(cost.derive(tr, steps=meta["steps"],
                                      geom=meta["geom"]))
            keys.append(_p20_keys(tr, P21_PASSES))
            del tr
        (mc, mg), ((want, cpu_errs, _), (got, errs, _)) = models, keys
        check(_p21_model_key(mg) == _p21_model_key(mc),
              f"{name}: the CUDA trace's cost model == the CPU trace's "
              f"(bytes/step {mg.bytes_per_step} vs {mc.bytes_per_step}, "
              f"dispatches {mg.dispatches_per_step} vs "
              f"{mc.dispatches_per_step}, footprint {mg.footprint_bytes} "
              f"vs {mc.footprint_bytes})")
        check(not cpu_errs and not errs and got == want,
              f"{name}: the same cost_budget/durability (pass, code, site) "
              f"set as the CPU trace, no unsuppressed error "
              f"{sorted(got ^ want)} {errs}")
        rec[name] = {"bytes_per_step": mg.bytes_per_step,
                     "dispatches_per_step": mg.dispatches_per_step,
                     "footprint_bytes": mg.footprint_bytes,
                     "findings": sorted(list(k) for k in got)}
        print(f"  (a) {name}: {mg.bytes_per_step:g} B/step, "
              f"{mg.dispatches_per_step:g} dispatches/step, footprint "
              f"{mg.footprint_bytes} B, {len(got)} finding keys: "
              "CPU == CUDA")
    return rec


def _p21_runner(engine, use_fused, dev, cpb):
    """The full-width runner of a P21_FULL target and its populated
    state, built as the target's builder builds them."""
    if engine == "tatp":
        from dint_tpu_torch.engines import tatp_dense as td
        run, init, _ = td.build_pipelined_runner(
            N_SUB, w=W, val_words=VW, cohorts_per_block=cpb,
            use_fused=use_fused, device=dev)
        db = td.populate_device(torch.Generator(device=dev).manual_seed(0),
                                N_SUB, val_words=VW, device=dev)
    else:
        from dint_tpu_torch.engines import smallbank_dense as sd
        run, init, _ = sd.build_pipelined_runner(
            SB_N, w=SB_W, cohorts_per_block=cpb, use_fused=use_fused,
            device=dev)
        db = sd.create(SB_N, device=dev)
    return run, init, db


def _p21_profiled(label, run, carry, gen, trace_dir, geometry, steps):
    """One block under `profiler_session` (taken again with more host
    padding when the profile holds no device event, at most 3 times):
    (carry, breakdown, kernel slices a step, wrapper launches)."""
    from dint_tpu_torch.monitor import attrib, profiler_session
    for i in range(3):
        reset_launches()
        with profiler_session(os.path.join(trace_dir, f"{label}_{i}")) as p:
            time.sleep(0.2 * 2 ** i)
            carry, _ = run(carry, gen)
            torch.cuda.synchronize()
            time.sleep(0.2 * 2 ** i)
        launches = launch_counts()
        events, _ = attrib.load_trace_events(p["trace"])
        if any(e.get("cat") in attrib.DEVICE_CATS for e in events):
            break
        print(f"  {label}: profile {i} held no device event; taken again")
    bd = attrib.attribute(events, steps=steps, geometry=geometry,
                          trace_path=p["trace"])
    kernels = sum(1 for e, _, _ in attrib.charge(events)
                  if e.get("cat") == "kernel")
    return carry, bd, kernels / steps, launches


def _p21_full(dev, card, trace_dir):
    """(b): the model at full width on the card, its footprint against
    the carry's storages, and one profiled steady-state block: per wave
    the derived bytes against the device time. (c): the replay twins at
    full size against the numpy recovery on a ring the route wrote."""
    import dataclasses
    from dint_tpu_torch.analysis import cost
    from dint_tpu_torch.analysis import targets as T
    full = dataclasses.replace(T.LINT, device=dev.type, n_sub=N_SUB,
                               n_acct=SB_N, w=W, vw=VW, logcap=1 << 16)
    cpb = full.cpb
    rec, paths = {}, {}
    for name, (engine, use_fused) in P21_FULL.items():
        route = "fused" if use_fused else "default"
        geom = (dict(w=W, k=4, vw=VW) if engine == "tatp"
                else dict(w=SB_W, l=3, vw=2))
        t0 = time.perf_counter()
        tr = T.build(name, full)
        check(tr.gm is not None, f"{name} (full): traced ({tr.trace_error})")
        model = cost.derive(tr, steps=float(cpb), geom=geom)
        del tr
        gc.collect()
        torch.cuda.empty_cache()
        trace_s = time.perf_counter() - t0
        # the footprint: the carry's distinct storages, plus every tensor
        # the block returns in a storage of its own
        run, init, db = _p21_runner(engine, use_fused, dev, cpb)
        gen = torch.Generator(device=dev).manual_seed(21)
        carry = init(db)
        ins = _p21_storages(carry)
        reset_launches()
        out = run(carry, gen)
        torch.cuda.synchronize()
        paths[f"p21 {engine} {route} block 1"] = launch_counts()
        outs = _p21_storages(out)
        want_fp = sum(ins.values()) + sum(
            b for ptr, b in outs.items() if ptr not in ins)
        check(model.footprint_bytes == want_fp,
              f"{name} (full): the model's footprint {model.footprint_bytes}"
              f" B == the carry's distinct storages and the block's fresh "
              f"outputs, {want_fp} B")
        del carry, ins, outs
        carry = out[0]
        del out
        carry, bd, kernels_per_step, launches = _p21_profiled(
            f"p21_{engine}_{route}", run, carry, gen, trace_dir, geom, cpb)
        paths[f"p21 {engine} {route} profiled"] = launches
        derived = {k: round(v * cpb) for k, v in
                   model.kernel_dispatches_per_step().items()}
        ran = {k: c for k, c in launches.items() if c}
        check(ran == derived,
              f"{name} (full): the dint:: launch counters of the profiled "
              f"block {ran} == the derived kernel dispatches {derived}")
        per_wave = {}
        print(f"  (b) {name} (full width, {route}): model "
              f"{model.bytes_per_step:g} B/step, {model.dispatches_per_step:g}"
              f" dispatches/step, footprint {model.footprint_bytes:,} B "
              f"(trace {trace_s:.3f} s)  [{card}]")
        for wave, nbytes in sorted(model.wave_bytes_per_step().items()):
            r = bd["waves"].get(wave, {})
            check(r.get("slices", 0) > 0,
                  f"{name} (full): wave {wave} derives {nbytes:g} B/step "
                  "and has device slices in the profiled block")
            us = r["ms_per_step"] * 1e3
            gbps = nbytes / (us * 1e-6) / 1e9
            per_wave[wave] = {
                "bytes_per_step": nbytes, "device_us_per_step": us,
                "gbps": gbps, "share_of_3350": gbps / 3350.0,
                "dispatches_per_step":
                    model.wave_dispatches_per_step()[wave],
                "slices": r["slices"]}
            print(f"      {wave:34s} {nbytes:>12,.1f} B/step "
                  f"{us:>10.3f} us/step {gbps:>9.3f} GB/s "
                  f"({gbps / 3350.0:.6f} of 3.35 TB/s)")
        print(f"      per step: derived dispatches "
              f"{model.dispatches_per_step:g}, profiled kernel launches "
              f"{kernels_per_step:g}, dint:: launches "
              f"{sum(ran.values()) / cpb:g} (== derived "
              f"{sum(derived.values()) / cpb:g})")
        rec[name] = {"bytes_per_step": model.bytes_per_step,
                     "dispatches_per_step": model.dispatches_per_step,
                     "footprint_bytes": model.footprint_bytes,
                     "profiled_kernels_per_step": kernels_per_step,
                     "dint_launches": ran, "step_device_ms": bd["step_ms"],
                     "waves": per_wave}
        if not use_fused:
            rec[f"{engine} replay"] = _p21_replay(dev, engine, run, carry,
                                                  gen)
        del carry, db, run, init
        gc.collect()
        torch.cuda.empty_cache()
    return rec, paths


def _p21_replay(dev, engine, run, carry, gen):
    """(c): one more block of the full-width route, then the live ring
    replayed on the card and recovered in numpy: equal tables."""
    from dint_tpu_torch import recovery
    from dint_tpu_torch.ops.u32 import to_u64
    from dint_tpu_torch.tables import log as logring
    carry, _ = run(carry, gen)
    torch.cuda.synchronize()
    live = carry[0]
    heads = to_u64(live.log.head)
    check(0 < int(heads.max()) < live.log.capacity,
          f"{engine}: the ring holds {int(heads.sum())} entries a replica, "
          f"below the capacity of {live.log.capacity} a lane")
    entries = logring.replica_entries(live.log, 0)
    if engine == "tatp":
        from dint_tpu_torch.engines import tatp_dense as td
        db0 = td.populate_device(torch.Generator(device=dev).manual_seed(0),
                                 N_SUB, val_words=VW, device=dev)
        t0 = time.perf_counter()
        got = recovery.replay_tatp_dense(db0, entries, live.log.head)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = recovery.recover_tatp_dense(db0, entries, live.log.head)
        host_s = time.perf_counter() - t0
        same = (torch.equal(got.val, want.val)
                and torch.equal(got.meta, want.meta))
        live_ok = (torch.equal(got.val, live.val)
                   and torch.equal(got.meta, live.meta))
    else:
        from dint_tpu_torch.engines import smallbank_dense as sd
        db0 = sd.create(SB_N, device=dev)
        t0 = time.perf_counter()
        got = recovery.replay_smallbank_dense(db0, entries, live.log.head)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = recovery.recover_smallbank_dense(db0, entries, live.log.head)
        host_s = time.perf_counter() - t0
        same = torch.equal(got.bal, want.bal) and got.step == want.step
        live_ok = torch.equal(got.bal, live.bal)
    check(same and live_ok,
          f"(c) {engine}: the replay twin on the card ({card_s:.3f} s) == "
          f"the numpy recovery ({host_s:.3f} s) on the same ring of "
          f"{int(heads.sum()):,} entries, and == the live tables")
    print(f"  (c) {engine}: replay on the card {card_s:.3f} s, numpy "
          f"{host_s:.3f} s, {int(heads.sum()):,} entries a replica")
    del got, want, db0, entries, live
    return {"entries": int(heads.sum()), "card_s": card_s, "host_s": host_s}


def phase_cost(dev, card):
    """Phase 21: dintcost and dintdur on the card."""
    import tempfile
    print("== phase 21: dintcost and dintdur on the card: the lint "
          "geometry's models and findings == the CPU's; the model at full "
          "width against a profiled block; the replay twins at full size")
    t0 = time.perf_counter()
    rec = {"lint": _p21_lint(dev)}
    with tempfile.TemporaryDirectory(prefix="dint_p21_") as trace_dir:
        rec["full"], paths = _p21_full(dev, card, trace_dir)
    reset_launches()
    rec["seconds"] = time.perf_counter() - t0
    print("  phase 21 record: " + json.dumps(rec, default=str))
    print(f"  phase 21: {rec['seconds']:.3f} s  [{card}]")
    return paths


# ------------------------------------------- the planner and its gates

P22_CAL_DEPTHS = (2, 1)          # the default, and one block in flight
P22_ROUTE_WINDOW_S = 1.0         # (d): each turn's window
P22_REPAIR_WINDOW_S = 2.0        # (e): the Poisson schedule's length
# (e)'s offered rates (lanes/s): about 0.5 of the committed rates phase
# 9's bench (TATP) and phase 19 (b) (the 3x2 mesh) measure
P22_REPAIR_RATE = {"tatp_dense": 250_000.0, "mesh": 350_000.0}
P22_MON_CPB = 2                   # (b): each monitored block's cohorts
# (b): the families whose counter snapshot dintmon check reads; the
# phases that already run such a block at full size keep theirs in
# P22_SNAPSHOTS, phase 22 runs the others
P22_FAMILIES = (
    "tatp_dense default", "tatp_dense hotset", "tatp_dense fused",
    "tatp_dense fused+hotset", "smallbank_dense default",
    "smallbank_dense hotset", "smallbank_dense fused",
    "smallbank_dense fused+hotset", "store serve@scan", "tatp_pipeline",
    "smallbank_pipeline", "dense_sharded default", "dense_sharded fused",
    "dense_sharded_sb", "multihost_sb hierarchical", "multihost_sb flat",
    "serve tatp_dense", "serve smallbank_dense", "serve store",
    "serve mesh", "serve calibration")
P22_SNAPSHOTS: dict = {}


def keep_counters(label, snap):
    """Keep a monitored full-size block's counter snapshot for phase 22
    (b)'s dintmon check."""
    P22_SNAPSHOTS[label] = dict(snap)


def _p22_pricer(dev):
    """A pricer for `plan.price_frontier` that traces each candidate on
    the card at the lint geometry (memoized)."""
    import dataclasses
    from dint_tpu_torch.analysis import cost
    from dint_tpu_torch.analysis import plan as P
    from dint_tpu_torch.analysis import targets as T
    on_card = dataclasses.replace(T.LINT, device=dev.type)
    prices = {}

    def pricer(name):
        if name not in prices:
            tr = T.build(name, on_card)
            check(tr.gm is not None and tr.device == on_card.device,
                  f"{name}: traced on {on_card.device} ({tr.trace_error})",
                  quiet=True)
            meta = T.TARGET_COST[name]
            prices[name] = P.price_model(cost.derive(
                tr, steps=meta["steps"], geom=meta["geom"]))
            if name in P23_KEEP:        # phase 23 reads these traces
                CARD_TRACES[name] = tr
        return prices[name]
    return pricer


def _p22_frontier(dev, card):
    """(a): every feasible candidate priced from CUDA traces at the lint
    geometry; the frontier hash, each row's prices and ranks ==
    PLAN_H100.json's. Returns (record, the memoized pricer)."""
    from dint_tpu_torch.analysis import plan as P
    print("== phase 22 (a): the planner's frontier priced from CUDA traces "
          "at the lint geometry == PLAN_H100.json's")
    t0 = time.perf_counter()
    pricer = _p22_pricer(dev)
    rows = P.price_frontier(pricer)
    plan = P.load_plan()
    check(os.path.basename(str(P.plan_path())) == "PLAN_H100.json",
          f"the port's plan is {P.plan_path()}")
    flat = sorted((r for rs in rows.values() for r in rs),
                  key=lambda r: (r["workload"], r["target"]))
    pinned = {(r["workload"], r["target"]): r for r in plan["frontier"]}
    keys = ("dispatches_per_step", "bytes_per_step", "footprint_bytes",
            "ici_bytes_per_step", "dcn_bytes_per_step", "unpriced_waves",
            "rank", "dominated", "dominated_by")
    for r in flat:
        p = pinned.get((r["workload"], r["target"]))
        check(p is not None and all(p[k] == r[k] for k in keys),
              f"{r['workload']}/{r['target']}: CUDA prices and rank == the "
              f"pinned row ({ {k: r[k] for k in keys} })", quiet=True)
    fh = P.frontier_hash(flat)
    secs = time.perf_counter() - t0
    check(len(flat) == len(plan["frontier"])
          and fh == plan["provenance"]["cost_model_hash"],
          f"{len(flat)} candidates priced on the card in {secs:.3f} s: "
          f"frontier_hash {fh} == PLAN_H100.json's cost_model_hash, every "
          f"row's prices and ranks equal  [{card}]")
    picks = {w: min((r for r in rs if not r["dominated"]),
                    key=lambda r: (P.decision_key(r), r["target"]))["target"]
             for w, rs in rows.items()}
    check(all(picks[w] == e["predicted_target"]
              for w, e in plan["workloads"].items()),
          f"the decision rule on the card's prices picks the plan's "
          f"predicted targets {picks}")
    return ({"candidates": len(flat), "frontier_hash": fh, "picks": picks,
             "seconds": secs}, pricer)


def _p22_dense_snapshots(dev):
    """(b): one monitored block and the drain of dense TATP (7M) and
    SmallBank (24M) at w = 8192 on every route."""
    from dint_tpu_torch.engines import smallbank_dense as sd
    from dint_tpu_torch.engines import tatp_dense as td
    from dint_tpu_torch.engines.types import ROUTES
    from dint_tpu_torch.monitor import counters as mon
    for label, mod, make in (
            ("tatp_dense", td, lambda: td.populate_device(
                torch.Generator(device=dev).manual_seed(0), N_SUB,
                val_words=VW, device=dev)),
            ("smallbank_dense", sd, lambda: sd.create(SB_N, device=dev))):
        db = make()
        for route, (hot, fused) in ROUTES.items():
            kw = dict(val_words=VW) if mod is td else {}
            run, init, drain = mod.build_pipelined_runner(
                N_SUB if mod is td else SB_N, w=W,
                cohorts_per_block=P22_MON_CPB,
                use_hotset=hot, use_fused=fused, monitor=True, device=dev,
                **kw)
            carry, _ = run(init(db), torch.Generator(device=dev)
                           .manual_seed(221))
            outs = drain(carry)
            db = outs[0]
            keep_counters(f"{label} {route}", mon.snapshot(outs[-1]))
            del carry, outs, run, init, drain
        del db
        gc.collect()
        torch.cuda.empty_cache()


def _p22_generic_snapshots(dev):
    """Phase 11's generic pipelines, one monitored block each at full size
    (run here only when phase 11 did not)."""
    from dint_tpu_torch.clients import tatp_client
    from dint_tpu_torch.engines import smallbank_pipeline as sp
    from dint_tpu_torch.engines import tatp_pipeline as tp
    shards, _ = tatp_client.populate_shards(
        np.random.default_rng(0), GEN_N_SUB, val_words=VW, device=dev)
    _p11_monitored(dev, tp, sp, shards)
    del shards
    gc.collect()
    torch.cuda.empty_cache()


def _p11_monitored(dev, tp, sp, shards):
    """One monitored block and the drain of the generic TATP pipeline on
    ``shards``, and one of generic SmallBank at GEN_SB_N: the counter
    snapshots phase 22 (b) checks. Returns the drained shards."""
    from dint_tpu_torch import monitor as mn
    from dint_tpu_torch.monitor import counters as mon
    run, init, drain = tp.build_pipelined_runner(
        GEN_N_SUB, w=GEN_W, val_words=VW, cohorts_per_block=2,
        monitor=True, device=dev)
    carry, _ = run(init(shards), torch.Generator(device=dev).manual_seed(23))
    outs = drain(carry)
    keep_counters("tatp_pipeline", mon.snapshot(outs[-1]))
    shards = outs[0]
    del carry, outs
    run = sp.build_runner(GEN_SB_N, w=GEN_W, cohorts_per_block=2,
                          monitor=True, device=dev)
    (stacked, cnt), _ = run((sp.create_stacked(GEN_SB_N, device=dev),
                             mn.create(dev)),
                            torch.Generator(device=dev).manual_seed(24))
    keep_counters("smallbank_pipeline", mon.snapshot(cnt))
    del stacked, cnt
    return shards


def _p22_gates(dev, card, pricer, require_all=True):
    """(b): plan_check in full mode (the card's prices), calib_check, and
    dintmon check's identities on every family's monitored block."""
    from dint_tpu_torch import analysis
    from dint_tpu_torch.analysis import allowlist as al
    from dint_tpu_torch.analysis import plan as P
    from dint_tpu_torch.analysis.passes import calib_check, plan_check
    from dint_tpu_torch.dintmon import check_identities
    from dint_tpu_torch.monitor import calib as CAL
    print("== phase 22 (b): plan_check (full, the card's prices), "
          "calib_check and dintmon check on every family's monitored "
          "block at full size")
    t0 = time.perf_counter()
    anchor = P.DEFAULT_ANCHOR
    plan = P.load_plan()
    cpath = CAL.calib_path()
    fs = plan_check.check_plan(plan, anchor, static=False, pricer=pricer)
    fs += calib_check.check_calib_doc(CAL.load_calib(cpath), anchor,
                                      plan=plan, source_dir=cpath.parent)
    fs = al.apply(analysis._dedup(fs), al.load(analysis.DEFAULT_ALLOWLIST),
                  check_unused=False)
    errs = [str(f) for f in fs if f.severity == "error"
            and not f.suppressed]
    check(not errs, f"plan_check (full) and calib_check on "
          f"{P.plan_path().name} and {cpath.name}: {len(fs)} finding(s), "
          f"no unsuppressed error {errs}")
    _p22_dense_snapshots(dev)
    if "tatp_pipeline" not in P22_SNAPSHOTS:
        _p22_generic_snapshots(dev)
    rows = {}
    for label in P22_FAMILIES:
        snap = P22_SNAPSHOTS.get(label)
        if snap is None:
            if require_all:
                check(False, f"{label}: a monitored block's counters were "
                      f"kept")
            print(f"  {label}: not run in this call")
            continue
        ok, ids = check_identities(snap)
        check(ok and snap["steps"] > 0,
              f"dintmon check {label}: "
              + "; ".join(f"{r['identity'].split(' ==')[0]} {r['status']}"
                          + ("" if r["status"] == "skipped"
                             else f" ({r['lhs']:,})") for r in ids))
        rows[label] = {r["identity"]: r["status"] for r in ids}
    print(f"  (b) {time.perf_counter() - t0:.3f} s  [{card}]")
    return {"findings": len(fs), "identities": rows}


def _p22_calibration(dev, card, out_dir):
    """(c): the serve runs at depth 2 (the default: phase 16 (f)'s, else
    run here) and at depth 1, each depth's evidence gathered and fit,
    printed beside CALIB_H100.json."""
    import contextlib
    import io
    from dint_tpu_torch import dintcal
    from dint_tpu_torch.monitor import calib as CAL
    print(f"== phase 22 (c): the calibration at the serving plane's "
          f"defaults (depth 2, {SV_CPB} cohorts a block) and at depth 1: "
          f"ServeEngine over tatp_dense at {N_SUB:,}, one "
          f"{P16_CAL_WINDOW_S} s run a width {P16_CAL_WIDTHS} at half the "
          f"closed-loop rate")
    t0 = time.perf_counter()
    runs, paths = {}, {}
    if 2 in CAL_RUNS:
        closed, *runs[2] = CAL_RUNS[2]
        print(f"  depth 2: phase 16 (f)'s runs (closed-loop rates {closed})")
    else:
        closed = _cal_closed(dev, card, "p22_cal")
    for depth in P22_CAL_DEPTHS:
        if depth not in runs:
            snaps, sources, p = _cal_serve_runs(
                dev, card, closed, depth, "phase 22 (c)",
                f"p22 calibration d{depth}")
            runs[depth] = (snaps, sources)
            paths.update(p)
    committed = CAL.load_calib(CAL.calib_path())
    fits = {}
    for depth in P22_CAL_DEPTHS:
        snaps, sources = runs[depth]
        ev = CAL.gather_evidence(snaps, sources=sources)
        name = "CALIB_H100" if depth == 2 else f"CALIB_H100_depth{depth}"
        evp = os.path.join(out_dir, f"p22_{name}.evidence.json")
        with open(evp, "w") as f:
            f.write(json.dumps(ev, indent=1, sort_keys=True) + "\n")
        doc = CAL.fit_calib(ev, source=f"{name}.evidence.json")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = dintcal.main(["fit", evp, "-o",
                               os.path.join(out_dir, "fit.json"), "--json"])
        check(rc == 0 and json.loads(buf.getvalue())["model"]
              == doc["model"], f"depth {depth}: dintcal fit of the evidence "
              f"== the fit ({doc['model']})")
        drift = CAL.check_calib(committed, ev)
        rel = {c: doc["model"][c] / committed["model"][c] - 1
               for c in ("base_us", "per_lane_ns")}
        fits[depth] = {"model": doc["model"], "fit": doc["fit"],
                       "rel_to_committed": rel, "drift": len(drift),
                       "sources": sources}
        print(f"  depth {depth} fit: base_us {doc['model']['base_us']}, "
              f"per_lane_ns {doc['model']['per_lane_ns']} (rms_us "
              f"{doc['fit']['rms_us']}, n {doc['fit']['n']}); committed "
              f"CALIB_H100.json base_us {committed['model']['base_us']}, "
              f"per_lane_ns {committed['model']['per_lane_ns']}, tolerance "
              f"{committed['tolerance']}: relative {rel}, check_calib "
              f"{len(drift)} drift record(s)  [{card}]")
    print(f"  (c) {time.perf_counter() - t0:.3f} s")
    return {"closed": closed, "fits": fits,
            "seconds": time.perf_counter() - t0}, paths


def _p22_routes(dev, card):
    """(d): the pinned and the predicted route of tatp_uniform and
    smallbank_skewed at full width, in turns P N N P."""
    from dint_tpu_torch import bench
    from dint_tpu_torch.analysis import plan as P
    from dint_tpu_torch.clients import bench_smallbank
    from dint_tpu_torch.engines import tatp_dense as td
    from dint_tpu_torch.engines.types import ROUTES
    plan = P.load_plan()
    route_of = {v: k for k, v in ROUTES.items()}
    print(f"== phase 22 (d): the pinned and the predicted route, turns P N "
          f"N P, {P22_ROUTE_WINDOW_S} s windows at full width")
    out, paths = {}, {}
    for wname in ("tatp_uniform", "smallbank_skewed"):
        e = plan["workloads"][wname]
        turns = {}
        for kind in ("pinned", "predicted"):
            knobs = e[kind]
            turns[kind] = route_of[(bool(knobs["use_hotset"]),
                                    bool(knobs["use_fused"]))]
        got = {"pinned": [], "predicted": []}
        for i, kind in enumerate(("pinned", "predicted", "predicted",
                                  "pinned")):
            route = turns[kind]
            if wname == "tatp_uniform":
                leg = bench._tatp_leg(bench.Knobs(
                    window_s=P22_ROUTE_WINDOW_S), route, dev)
                tps = float(leg["total"][td.STAT_COMMITTED]) / leg["dt"]
                paths[f"p22 {wname} {kind} {i}"] = leg["launches"]
            else:
                reset_launches()
                pt = bench_smallbank._run_one(
                    P22_ROUTE_WINDOW_S, SB_N, SB_W, SB_CPB, None, None,
                    route, dev)
                tps = pt["committed_tps"]
                paths[f"p22 {wname} {kind} {i}"] = launch_counts()
            got[kind].append(tps)
            gc.collect()
            torch.cuda.empty_cache()
        out[wname] = {"pinned_route": turns["pinned"],
                      "predicted_route": turns["predicted"], **got}
        print(f"  {wname}: pinned {turns['pinned']} {got['pinned']}, "
              f"predicted {turns['predicted']} {got['predicted']} committed "
              f"txn/s (P N N P)  [{card}]")
    return out, paths


def _p22_repair(dev, card):
    """(e): one Poisson schedule through ServeEngine (tatp_dense, 7M) and
    MeshServeEngine (3x2, 24M accounts), with PLAN.json's priors (a TPU's)
    and with plan="auto" (PLAN_H100.json), the same arrivals both times."""
    from dint_tpu_torch import serve
    from dint_tpu_torch.analysis import plan as P
    from dint_tpu_torch.monitor import calib as CAL
    print(f"== phase 22 (e): the serving planes on PLAN.json's priors and "
          f"on plan=\"auto\" (PLAN_H100.json): one {P22_REPAIR_WINDOW_S} s "
          f"Poisson schedule each, rates {P22_REPAIR_RATE} lanes/s")
    ref_plan = P.load_plan(os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "PLAN.json"))
    h100 = P.load_plan()
    cal = CAL.load_calib(CAL.calib_path())
    cal_name = CAL.calib_path().name
    card_model = {c: cal["model"][c] for c in ("base_us", "per_lane_ns")}
    out, paths = {}, {}
    tatp_cls = _device_filled(serve.ServeEngine)
    for fam in ("tatp_dense", "mesh"):
        wname = P.SERVE_WORKLOADS["multihost_sb" if fam == "mesh" else fam]
        prior = h100["workloads"][wname]["serve"]["model"]
        check(all(prior[c] == v for c, v in card_model.items()),
              f"PLAN_H100.json's {wname} prior == {cal_name}'s fit "
              f"({card_model})", quiet=True)
        sched = serve.poisson_schedule(P22_REPAIR_RATE[fam],
                                       P22_REPAIR_WINDOW_S, seed=22)
        for label, plan in (("PLAN.json", ref_plan), ("auto", "auto")):
            if fam == "tatp_dense":
                eng = tatp_cls("tatp_dense", N_SUB,
                               cohorts_per_block=SV_CPB, monitor=True,
                               plan=plan, device=dev)
            else:
                eng = serve.MeshServeEngine(
                    MESH_SB_N, mesh_shape=MH_SHAPE,
                    cohorts_per_block=SV_CPB, depth=2, monitor=True,
                    plan=plan, device=dev)
            eng.warmup()
            reset_launches()
            eng.run(sched)
            eng.close()
            paths[f"p22 repair {fam} {label}"] = launch_counts()
            rep = eng.snapshot()
            model = {"base_us": eng.model.base_us,
                     "per_lane_ns": eng.model.per_lane_ns}
            del eng
            gc.collect()
            torch.cuda.empty_cache()
            src = (rep["plan"] or {}).get("source") or ""
            auto = label == "auto"
            check(os.path.basename(src) == ("PLAN_H100.json" if auto
                                            else "<document>")
                  and (model == card_model) == auto,
                  f"{fam} plan={label}: the plan's source is {src}, its "
                  f"ServiceModel {model} "
                  + ("==" if auto else "!=") + f" PLAN_H100.json's "
                  f"{wname} prior, {cal_name}'s fit")
            if auto:
                keep_counters(f"serve {fam}" if fam == "mesh"
                              else "serve tatp_dense", rep["counters"])
            if fam == "mesh":
                _mh_identities(f"{fam} {label}", rep,
                               MH_SHAPE[0] * MH_SHAPE[1])
            else:
                _serve_identity(f"{fam} {label}", rep)
            shares = {"admitted": rep["admitted"] / max(rep["offered"], 1),
                      "shed": rep["shed"] / max(rep["offered"], 1)}
            out[f"{fam} {label}"] = {
                **shares, "queue_p99_us": rep["queue"]["p99"],
                "service_p50_us": rep["service"]["p50"],
                "steps_by_width": rep["steps_by_width"],
                "achieved_rate": rep["achieved_rate"],
                "slo_met": rep["slo_met"], "model": model}
            print(f"  {fam} plan={label}: offered {rep['offered']:,}, "
                  f"admitted {shares['admitted']:.6f}, shed "
                  f"{shares['shed']:.6f}, queue p99 "
                  f"{rep['queue']['p99']:.1f} us, service p50 "
                  f"{rep['service']['p50']:.1f} us, steps by width "
                  f"{rep['steps_by_width']}, achieved "
                  f"{rep['achieved_rate']:,.1f}/s, priors {model}  "
                  f"[{card}]")
    return out, paths


def phase_plan(dev, card, require_all=True):
    """Phase 22: the planner and its gates on the card. The measurements
    (c)-(e) run first, with nothing else on the host; then the pricing's
    traces (a) and the gates (b)."""
    import tempfile
    t0 = time.perf_counter()
    with _Env(**P16_ENV, DINT_PLAN_PATH=None), \
            tempfile.TemporaryDirectory(prefix="dint_p22_") as tmp:
        out_dir = os.environ.get("DINT_SMOKE_OUT") or tmp
        os.makedirs(out_dir, exist_ok=True)
        rec = {}
        rec["calibration"], paths = _p22_calibration(dev, card, out_dir)
        rec["routes"], p = _p22_routes(dev, card)
        paths.update(p)
        rec["repair"], p = _p22_repair(dev, card)
        paths.update(p)
        rec["frontier"], pricer = _p22_frontier(dev, card)
        rec["gates"] = _p22_gates(dev, card, pricer, require_all)
    reset_launches()
    rec["seconds"] = time.perf_counter() - t0
    print("  phase 22 record: " + json.dumps(rec, default=str))
    print(f"  phase 22: {rec['seconds']:.3f} s  [{card}]")
    return paths


# ------------------------------------- the mesh's collectives on the card

P23_TARGETS = ("dense_sharded/block", "dense_sharded_sb/block",
               "multihost_sb/block", "multihost_sb/block@flat")
# the lint geometry's CUDA traces phase 22 (a) makes and phase 23 reuses
# (its mesh targets, and the quick sample's tatp_dense/block)
P23_KEEP = P23_TARGETS + ("tatp_dense/block",)
CARD_TRACES: dict = {}
P23_PASSES = ("shard_consistency", "protocol", "durability", "cost_budget")


def _p23_collectives(trace):
    """{"op axes": nodes} of a trace's dint_mesh nodes."""
    from dint_tpu_torch.analysis import core
    from dint_tpu_torch.ops import mesh_ops
    out = {}
    for n in trace.graph.nodes:
        if n.op == "call_function" and mesh_ops.is_collective(n.target):
            k = f"{core.op_name(n)} {','.join(mesh_ops.node_axes(n))}"
            out[k] = out.get(k, 0) + 1
    return dict(sorted(out.items()))


def _p23_summary(trace):
    """What (a) compares of one trace: its collective nodes, its link
    bytes a step by axis, its unpriced collective waves, and the four
    passes' (pass, code, site) keys and unsuppressed errors."""
    from dint_tpu_torch.analysis import cost
    from dint_tpu_torch.analysis import targets as T
    meta = T.TARGET_COST[trace.name]
    model = cost.derive(trace, steps=meta["steps"], geom=meta["geom"])
    keys, errs, _ = _p20_keys(trace, P23_PASSES)
    return {"collectives": _p23_collectives(trace),
            "links": model.axis_bytes_per_step(),
            "unpriced": list(model.unpriced_waves),
            "keys": sorted(list(k) for k in keys), "errors": errs}


def p23_cpu_main():
    """(a)'s CPU side, run as a child process beside the card's traces:
    one JSON line of every target's summary."""
    from dint_tpu_torch.analysis import targets as T
    out = {name: _p23_summary(T.build(name, T.LINT)) for name in P23_TARGETS}
    print("P23 " + json.dumps(out), flush=True)


def _p23_traces(dev, card):
    """(a): the mesh targets traced on CUDA == their CPU traces (traced in
    a child process meanwhile): the collective nodes, the link bytes and
    the four passes' findings. Returns (record, {target: CUDA trace})."""
    import dataclasses
    from dint_tpu_torch.analysis import targets as T
    child = subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.p23_cpu_main()"],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, text=True,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    on_card = dataclasses.replace(T.LINT, device=dev.type)
    rec, traces, got = {}, {}, {}
    try:
        for name in P23_TARGETS:
            tr = CARD_TRACES.pop(name, None) or T.build(name, on_card)
            check(tr.gm is not None and tr.device == dev.type,
                  f"{name}: traced on {dev.type} ({tr.trace_error})")
            traces[name] = tr
            got[name] = _p23_summary(tr)
        out, _ = child.communicate(timeout=600)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    check(child.returncode == 0, f"(a)'s CPU traces: child exit "
                                 f"{child.returncode}")
    cpu = json.loads(next(ln[4:] for ln in out.splitlines()
                          if ln.startswith("P23 ")))
    for name in P23_TARGETS:
        g, c = got[name], cpu[name]
        print(f"  (a) {name}: collective nodes {g['collectives']}; link "
              f"bytes a step {g['links']}  [{card}]")
        check(g["collectives"] == c["collectives"]
              and g["links"] == c["links"]
              and not g["unpriced"] and not c["unpriced"],
              f"{name}: the CUDA trace's collective nodes and link bytes "
              f"== the CPU trace's ({c['collectives']}, {c['links']}), "
              f"every collective wave priced")
        check(g["keys"] == c["keys"] and not g["errors"]
              and not c["errors"],
              f"{name}: the same {'/'.join(P23_PASSES)} (pass, code, site) "
              f"set as the CPU trace ({len(g['keys'])} keys), no "
              f"unsuppressed error {g['errors']} {c['errors']}")
        rec[name] = {"collectives": g["collectives"],
                     "link_bytes_per_step": g["links"],
                     "findings": g["keys"]}
    return rec, traces


def _p23_ops(dev, card):
    """(b): the three ops on CUDA tensors == on CPU tensors, bit for bit."""
    from dint_tpu_torch.parallel.mesh import Mesh
    g = torch.Generator().manual_seed(23)
    n_calls = 0
    for shape, axes in (((3,), ("shard",)), ((3, 2), ("dcn", "ici"))):
        meshes = [Mesh(shape, axes, device=d) for d in ("cpu", dev)]
        size = meshes[0].size
        rows = 4 * size * 6
        xs = [torch.randint(-(1 << 31), 1 << 31, (rows, 5), generator=g,
                            dtype=torch.int64).to(torch.int32)
              for _ in range(size)]
        masks = [torch.rand(rows, generator=g) < 0.5 for _ in range(size)]
        on = [[x.to(m.device) for x in xs] for m in meshes]
        mk = [[x.to(m.device) for x in masks] for m in meshes]
        calls = []
        for axis in axes:
            for off in (1, 2):
                calls.append(("ppermute", lambda m, i, a=axis, o=off:
                              m.ppermute(list(zip(on[i], mk[i])), a, o)))
            calls.append(("all_to_all", lambda m, i, a=axis:
                          m.all_to_all(on[i], a)))
        calls.append(("all_to_all", lambda m, i: m.all_to_all(
            on[i], tuple(axes))))
        calls.append(("psum", lambda m, i: [m.psum(on[i])]))
        for op, fn in calls:
            want, got = fn(meshes[0], 0), fn(meshes[1], 1)
            flat = (lambda v: [t for e in v for t in (
                e if isinstance(e, tuple) else (e,))])
            w_, g_ = flat(want), flat(got)
            check(len(w_) == len(g_) and all(
                b.device.type == dev.type and torch.equal(a, b.cpu())
                for a, b in zip(w_, g_)),
                f"dint_mesh::{op} on a {shape} mesh: the card's result == "
                f"the CPU's", quiet=True)
            n_calls += 1
    torch.cuda.synchronize()
    print(f"  (b) {n_calls} calls of dint_mesh::ppermute, all_to_all and "
          f"psum on the 3 and 3x2 meshes: the card's results == the CPU's, "
          f"bit for bit  [{card}]")
    return {"calls": n_calls, "host_us": _p23_host_cost(dev, card)}


def _p23_host_cost(dev, card):
    """Host µs a call of a hop and an exchange at the main path's width,
    through the op and in the list form it replaced (a re-index of the
    list; a stack and one transposed copy): what a mesh step pays for
    the ops."""
    from dint_tpu_torch.engines import tatp_dense as td
    from dint_tpu_torch.parallel.mesh import Mesh
    n = 2 * MESH_W
    mesh = Mesh((MESH_D,), ("shard",), device=dev)

    def rec():
        z = torch.zeros(n, dtype=torch.int32, device=dev)
        return td.Installs(
            wmask=torch.zeros(n, dtype=torch.bool, device=dev),
            rows=z.clone(), meta=z.clone(),
            val=torch.zeros((n, VW), dtype=torch.int32, device=dev),
            tbl=z.clone(), key=z.clone(), is_del=z.clone(), ver=z.clone())
    insts = [rec() for _ in range(MESH_D)]
    h, ci = MH_SHAPE
    m2 = Mesh(MH_SHAPE, ("dcn", "ici"), device=dev)
    rows = m2.size * 2 * -(-MESH_W * 3 // m2.size)
    buckets = [torch.zeros((rows, 2), dtype=torch.int32, device=dev)
               for _ in range(m2.size)]

    def listed_hop():
        return [insts[mesh.shift(p, "shard", -1)] for p in range(MESH_D)]

    def listed_exchange():
        x = torch.stack(buckets).reshape(h, ci, ci, rows // ci, 2)
        return list(x.transpose(1, 2).reshape(m2.size, rows, 2).unbind(0))
    out = {}
    for label, fn in (
            ("ppermute op", lambda: mesh.ppermute(insts, "shard", 1)),
            ("ppermute list form", listed_hop),
            ("all_to_all op", lambda: m2.all_to_all(buckets, "ici")),
            ("all_to_all list form", listed_exchange)):
        out[label], _ = _p20_host_us(fn)
    print(f"  (b) host µs a call: the TATP install record's hop over "
          f"{MESH_D} partitions (2w = {n} lanes, VW = {VW}): op "
          f"{out['ppermute op']:.3f}, list form "
          f"{out['ppermute list form']:.3f}; the {h}x{ci} route buckets' "
          f"ici exchange ([{rows}, 2] a partition): op "
          f"{out['all_to_all op']:.3f}, list form "
          f"{out['all_to_all list form']:.3f}  [{card}]")
    return out


def _p23_mutants(dev, card, traces):
    """(c): the pinned quick sample re-run over the card's traces."""
    import dataclasses
    from dint_tpu_torch.analysis import mutate as M
    from dint_tpu_torch.analysis import targets as T
    doc = M.load_mutcov()
    ids = doc["quick"]["cells"]
    on_card = dataclasses.replace(T.LINT, device=dev.type)

    def get_trace(name):
        if name not in traces:
            traces[name] = CARD_TRACES.pop(name, None) or T.build(
                name, on_card)
        return traces[name]
    fresh = M.run_cells(ids, get_trace=get_trace)
    pinned = {c["id"]: c for c in doc["cells"]}
    rec = {}
    for cell in fresh:
        want = pinned[cell["id"]]
        same = all(cell.get(k) == want[k]
                   for k in ("verdict", "killer", "new_errors"))
        print(f"  (c) {cell['id']}: {cell.get('verdict')} by "
              f"{cell.get('killer')!r} (pinned: {want['verdict']} by "
              f"{want['killer']!r})")
        check(same, f"{cell['id']}: the CUDA trace's mutant gives the "
                    f"pinned verdict, killer and new errors", quiet=True)
        rec[cell["id"]] = [cell.get("verdict"), cell.get("killer")]
    check(len(fresh) == len(ids) == len({i.split("|")[1] for i in ids}),
          f"dintmut's quick sample ({len(ids)} cells, one an operator) "
          f"re-run on the card's traces == MUTCOV_TORCH.json  [{card}]")
    return rec


def phase_mesh_trace(dev, card):
    """Phase 23: the mesh's collectives in the card's traces."""
    print("== phase 23: the mesh's collectives on the card: the mesh "
          "targets' CUDA traces (collective nodes, link bytes, findings) "
          "== the CPU's; the three ops on CUDA tensors == on CPU tensors; "
          "dintmut's quick sample over the CUDA traces == the pin")
    t0 = time.perf_counter()
    rec = {}
    t = time.perf_counter()
    rec["traces"], traces = _p23_traces(dev, card)
    rec["traces_s"] = time.perf_counter() - t
    t = time.perf_counter()
    rec["ops"] = _p23_ops(dev, card)
    rec["ops_s"] = time.perf_counter() - t
    t = time.perf_counter()
    rec["mutants"] = _p23_mutants(dev, card, traces)
    rec["mutants_s"] = time.perf_counter() - t
    del traces
    CARD_TRACES.clear()
    gc.collect()
    torch.cuda.empty_cache()
    reset_launches()
    rec["seconds"] = time.perf_counter() - t0
    print("  phase 23 record: " + json.dumps(rec, default=str))
    print(f"  phase 23: {rec['seconds']:.3f} s  [{card}]")


# ------------------------------------------------ the mesh over the cards

P24_BLOCKS = 2                   # timed blocks after the warm one, a run


def _p24_order(turns: int) -> list:
    """The placements of a route's runs: spread, one card, then the pair
    in turns (one card, spread; spread, one card; ...), ``turns`` pairs."""
    return [w for i in range(turns)
            for w in (("spread", "one card") if i % 2 == 0
                      else ("one card", "spread"))]


def _p24_spread(shape):
    """The spread placement: `parallel.mesh.placement` over the visible
    cards (on one card, every partition on cuda:0, given explicitly)."""
    from dint_tpu_torch.parallel.mesh import placement
    return placement(shape, [torch.device("cuda", i)
                             for i in range(torch.cuda.device_count())])


def _p24_run(card, label, mesh, runner, states, seed, commit_idx):
    """One warm block and P24_BLOCKS timed blocks drawn from generator
    seed ``seed`` on the mesh's home device, then the drain, every card of
    the mesh synchronised around each block, launches counted from 0.
    Prints the run's line. Returns (states, stats of every step, the
    counters' snapshot, launches, record)."""
    from dint_tpu_torch import timing
    from dint_tpu_torch.monitor import counters as mon
    run, init, drain = runner
    timing.reset_peak_memory(mesh.cards)
    gen = torch.Generator(device=mesh.device).manual_seed(seed)
    reset_launches()
    carry, s = run(init(states), gen)
    stats = [s]
    timing.synchronize(mesh.cards)
    secs = 0.0
    for _ in range(P24_BLOCKS):
        t0 = time.perf_counter()
        carry, s = run(carry, gen)
        timing.synchronize(mesh.cards)
        secs += time.perf_counter() - t0
        stats.append(s)
    states, tail, cnt = drain(carry)      # monitored: the counters last
    timing.synchronize(mesh.cards)
    launches = launch_counts()
    stats = torch.cat(stats + [tail]).cpu().numpy()
    timed = stats[MESH_CPB:MESH_CPB * (1 + P24_BLOCKS), commit_idx]
    rec = {"cards": [str(d) for d in mesh.cards],
           "txn_s": int(timed.astype(np.int64).sum()) / secs,
           "ms_step": secs / (P24_BLOCKS * MESH_CPB) * 1e3,
           "peak_bytes": timing.peak_memory(mesh.cards)}
    print(f"  {label}: cards {rec['cards']}; committed txn/s "
          f"{rec['txn_s']:.1f} summed over {mesh.size} partitions; ms/step "
          f"{rec['ms_step']:.6f}; peak memory by card {rec['peak_bytes']} B"
          f"  [{card}]")
    return states, stats, mon.snapshot(cnt), launches, rec


def _p24_host_fields(obj) -> list:
    """The host values (step counters, sizes) of a state, in field order."""
    import dataclasses
    out = []
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.extend(_p24_host_fields(v))
        elif not isinstance(v, torch.Tensor):
            out.append(v)
    return out


def _p24_same(label, run, ref):
    """A run against the route's first (spread) run: the stats of every
    step, the counters, and every partition's tensors (tables, backups,
    log rings, stamps; each copied to the other's card where they differ)
    and host fields, bit for bit."""
    from dint_tpu_torch.parallel.mesh import leaves
    (s_states, s_stats, s_cnt), (r_states, r_stats, r_cnt) = run, ref
    n_leaves = 0
    for a, b in zip(s_states, r_states):
        la, lb = leaves(a), leaves(b)
        check(len(la) == len(lb)
              and all(torch.equal(x.to(y.device), y) for x, y in zip(la, lb))
              and _p24_host_fields(a) == _p24_host_fields(b),
              f"{label}: a partition's tensors equal", quiet=True)
        n_leaves += len(la)
    check(np.array_equal(s_stats, r_stats) and s_cnt == r_cnt
          and len(s_states) == len(r_states),
          f"{label} bit for bit: the stats of "
          f"{s_stats.shape[0]} steps, the counters and {n_leaves} tensors of "
          f"{len(s_states)} partitions (tables, backups, log rings and heads, "
          f"stamps)")


def _p24_tatp(dev, card, spread, turns, trace_dir):
    """TATP at 7M over 3 shards, default and fused: the spread mesh, then
    ``device=dev``, from the same populate seeds and draws (``turns``
    pairs, `_p24_order`), every run held against the first; a lost shard
    rebuilt on its own card from its ring and another card's; then, on
    more than one card, one profiled block on each placement's last
    tables (`_mesh_wave_split`)."""
    from dint_tpu_torch.engines import tatp_dense as td
    from dint_tpu_torch.parallel import dense_sharded as ds
    paths, rec = {}, {}
    for route, fused in (("default", False), ("fused", True)):
        ref, last = None, {}
        rec[route] = {"spread": [], "one card": []}
        for where in _p24_order(turns):
            last.pop(where, None)
            mesh = ds.make_mesh(MESH_D, **({"devices": spread}
                                           if where == "spread"
                                           else {"device": dev}))
            label = f"p24 tatp {route}, {where}"
            states, _ = _mesh_states(dev, mesh, ds.SHARD_AXIS, N_SUB)
            runner = ds.build_sharded_pipelined_runner(
                mesh, MESH_D, N_SUB, w=MESH_W, val_words=VW,
                cohorts_per_block=MESH_CPB, use_fused=fused, monitor=True)
            states, stats, cnt, launches, r = _p24_run(
                card, label, mesh, runner, states, 1, td.STAT_COMMITTED)
            rec[route][where].append(r)
            last[where] = (runner, states)
            del runner
            if ref is None:
                paths[f"p24 tatp {route}"] = launches
                if not fused:
                    _mesh_recover(dev, label, mesh, states, 1,
                                  ((1, 0), (2, 2)),
                                  ds.n_sub_local(N_SUB, MESH_D))
                ref = (states, stats, cnt)
            else:
                _p24_same(f"tatp {route}, {where} == spread",
                          (states, stats, cnt), ref)
            del states
            gc.collect()
            torch.cuda.empty_cache()
        del ref
        if len(set(spread)) > 1:     # one card: both placements are one
            for where, (runner, states) in last.items():
                _, rec[route][f"{where} wave split"] = _mesh_wave_split(
                    dev, card, f"p24 tatp {route}, {where}", *runner,
                    states, trace_dir)
            del runner, states
        del last
        gc.collect()
        torch.cuda.empty_cache()
    return paths, rec


def _p24_smallbank(dev, card, spread, turns, trace_dir):
    """SmallBank at 24M over 3x2, hierarchical and flat: the spread mesh,
    then ``device=dev``, the same draws (``turns`` pairs, `_p24_order`),
    every run held against the first; partition (1, 0) rebuilt on its
    own card from its ring and host 2's; then, on more than one card, one
    profiled block on each placement's last tables
    (`_sb_mesh_wave_split`)."""
    from dint_tpu_torch.parallel import multihost_sb as mhs
    paths, rec = {}, {}
    for route, hier in (("hier", True), ("flat", False)):
        ref, last = None, {}
        rec[route] = {"spread": [], "one card": []}
        for where in _p24_order(turns):
            last.pop(where, None)
            mesh = mhs.make_mesh_2d(*MH_SHAPE, **({"devices": spread}
                                                  if where == "spread"
                                                  else {"device": dev}))
            label = f"p24 smallbank 3x2 {route}, {where}"
            states = mhs.create_multihost_sb(mesh, MESH_SB_N,
                                             log_capacity=MESH_SB_LOG_CAP)
            runner = mhs.build_multihost_sb_runner(
                mesh, MESH_SB_N, w=MESH_W, cohorts_per_block=MESH_CPB,
                hierarchical=hier, monitor=True)
            states, stats, cnt, launches, r = _p24_run(
                card, label, mesh, runner, states, 18, mhs.STAT_COMMITTED)
            rec[route][where].append(r)
            last[where] = (runner, states, r["ms_step"])
            del runner
            if ref is None:
                paths[f"p24 smallbank 3x2 {route}"] = launches
                if hier:
                    _sb_mesh_recover(dev, label, mesh, states,
                                     mesh.flat((1, 0)), axis=mhs.DCN_AXIS)
                ref = (states, stats, cnt)
            else:
                _p24_same(f"smallbank 3x2 {route}, {where} == spread",
                          (states, stats, cnt), ref)
            del states
        del ref
        if len(set(spread)) > 1:     # one card: both placements are one
            for where, (runner, states, ms_step) in last.items():
                _, rec[route][f"{where} wave split"] = _sb_mesh_wave_split(
                    dev, card, f"p24 smallbank 3x2 {route}, {where}",
                    *runner, states, trace_dir, ms_step,
                    engine="multihost_sb", wave_names=MH_WAVES)
            del runner, states
        del last
        gc.collect()
        torch.cuda.empty_cache()
    return paths, rec


def _p24_dryrun(dev, card):
    """`entry.dryrun_multichip(3)` over the visible cards against
    ``device=dev``: the same line but for the cards and the wall time."""
    import contextlib
    import io
    import re
    from dint_tpu_torch import entry
    lines = {}
    for where, device in (("spread", None), ("one card", dev)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            entry.dryrun_multichip(MESH_D, device=device)
        cards, lines[where] = buf.getvalue().strip().splitlines()[-2:]
        print(f"  p24 dry run, {where}: {cards}; {lines[where]}")
    bare = {k: re.sub(r" wall_s=\S+", "", v) for k, v in lines.items()}
    check(bare["spread"] == bare["one card"]
          and bare["spread"].startswith(f"dryrun_multichip ok: devices="
                                        f"{MESH_D} "),
          f"the dry run over the cards prints the one-card run's line but "
          f"for its wall time  [{card}]")


def _p24_hop(dev, card, spread):
    """Device ms of one `ppermute` hop of TATP's install record (3
    partitions, 2w lanes, VW words) on the spread mesh and on one card,
    by CUDA events on every card the mesh uses."""
    from dint_tpu_torch import timing
    from dint_tpu_torch.engines import tatp_dense as td
    from dint_tpu_torch.parallel.mesh import Mesh
    n = 2 * MESH_W

    def rec(d):
        z = torch.zeros(n, dtype=torch.int32, device=d)
        return td.Installs(
            wmask=torch.zeros(n, dtype=torch.bool, device=d),
            rows=z.clone(), meta=z.clone(),
            val=torch.zeros((n, VW), dtype=torch.int32, device=d),
            tbl=z.clone(), key=z.clone(), is_del=z.clone(), ver=z.clone())
    meshes = {"spread": Mesh((MESH_D,), ("shard",), devices=spread),
              "one card": Mesh((MESH_D,), ("shard",), device=dev)}
    insts = {k: [rec(m.device_of(p)) for p in range(MESH_D)]
             for k, m in meshes.items()}
    nbytes = sum(t.numel() * t.element_size()
                 for x in insts["spread"]
                 for t in (x.wmask, x.rows, x.meta, x.val, x.tbl, x.key,
                           x.is_del, x.ver))
    out = {k: {"ms": [], "bytes": nbytes,
               "cards": [str(d) for d in m.cards]}
           for k, m in meshes.items()}
    for where in ("spread", "one card", "one card", "spread"):   # in turns
        mesh, xs = meshes[where], insts[where]
        out[where]["ms"].append(timing.device_ms(
            lambda: mesh.ppermute(xs, "shard", 1), devices=mesh.cards))
    for where, r in out.items():
        ms = float(np.mean(r["ms"]))
        print(f"  p24 hop of the install record, {where} ({r['cards']}): "
              f"{[round(t * 1e3, 3) for t in r['ms']]} us device time in "
              f"turns for {nbytes:,} B over {MESH_D} partitions "
              f"({nbytes / (ms * 1e-3) / 1e9:.3f} GB/s at their mean)  "
              f"[{card}]")
    return out


def phase_mesh_cards(dev, card, turns=1):
    """Phase 24: the mesh over the machine's cards (``turns`` spread and
    one-card pairs a route, `_p24_order`)."""
    import tempfile
    n_cards = torch.cuda.device_count()
    print(f"== phase 24: the mesh over the cards ({n_cards} visible): TATP "
          f"at {N_SUB:,} over {MESH_D} shards (default, fused) and "
          f"SmallBank at {MESH_SB_N:,} over {MH_SHAPE[0]}x{MH_SHAPE[1]} "
          f"(hierarchical, flat), w={MESH_W} a partition, 1 warm + "
          f"{P24_BLOCKS} timed blocks and the drain each, spread by the "
          f"placement and then on one card, bit for bit; the dry run; a "
          f"lost partition from another card's ring; one hop timed")
    t0 = time.perf_counter()
    peers = {f"{i}->{j}": torch.cuda.can_device_access_peer(i, j)
             for i in range(n_cards) for j in range(n_cards) if i != j}
    print(f"  can_device_access_peer: {peers}")
    if n_cards == 1:
        print("  cards: 1; cross-card copies not exercised")
    else:
        print(f"  cards: {n_cards}")
    rec = {"cards": n_cards, "peers": peers}
    with tempfile.TemporaryDirectory(prefix="dint_p24_") as tmp:
        paths, rec["tatp"] = _p24_tatp(dev, card, _p24_spread((MESH_D,)),
                                       turns, tmp)
        p, rec["smallbank"] = _p24_smallbank(
            dev, card, _p24_spread(MH_SHAPE), turns, tmp)
    paths.update(p)
    _p24_dryrun(dev, card)
    rec["hop"] = _p24_hop(dev, card, _p24_spread((MESH_D,)))
    rec["seconds"] = time.perf_counter() - t0
    print("  phase 24 record: " + json.dumps(rec, default=str))
    print(f"  phase 24: {rec['seconds']:.3f} s  [{card}]")
    return paths


# ------------------------------------------- the mesh across processes

P25_RANKS = 3                    # one process a host
P25_BLOCKS = 3                   # a warm block and two timed, then the drain
P25_PROFILED_BLOCKS = 4          # --mesh-procs: and one profiled
P25_DEADLINE_S = 540             # the ranks are killed past this
P25_TATP_SHAPE = (3, 1)          # TATP's multihost runner: 3 hosts


def _p25_specs(profile=False) -> list:
    """Phase 25's runs (`testing.procs` run specs, full size, draws made
    on the host from a seed): TATP `multihost` at 7M over 3 hosts
    (`populate_device` a partition, seeds 0-2), SmallBank `multihost_sb`
    at 24M over 3x2, hierarchical and flat; each partition's tensors as
    digests. ``profile``: the last block under torch.profiler."""
    base = dict(w=MESH_W, cpb=MESH_CPB, outputs="digest", profile=profile,
                blocks=P25_PROFILED_BLOCKS if profile else P25_BLOCKS)
    sb = dict(base, engine="multihost_sb", shape=list(MH_SHAPE),
              n=MESH_SB_N, log_cap=MESH_SB_LOG_CAP, draw_seed=2526)
    return [dict(base, label="tatp multihost", engine="multihost",
                 shape=list(P25_TATP_SHAPE), n=N_SUB, vw=VW, log_cap=None,
                 state="device", seed=0, draw_seed=2525),
            dict(sb, label="smallbank 3x2 hier",
                 route={"hierarchical": True}),
            dict(sb, label="smallbank 3x2 flat",
                 route={"hierarchical": False})]


def _p25_rate(spec, stats, block_s) -> float:
    """Committed txn/s of a run's timed blocks (after the warm one): the
    mesh's sum, as every rank sees it."""
    from dint_tpu_torch.engines import tatp_dense as td
    from dint_tpu_torch.parallel import multihost_sb as mhs
    col = td.STAT_COMMITTED if spec["engine"] == "multihost" \
        else mhs.STAT_COMMITTED
    cpb = spec["cpb"]
    timed = stats[cpb:cpb * len(block_s), col].astype(np.int64).sum()
    return float(timed) / sum(block_s[1:])


def _p25_idle(busy_by_proc, block_s) -> dict:
    """Each card's share of a block: 1 minus the seconds its device
    slices but NCCL's covered in the profiled block (summed over the
    processes on the card) over the mean of the unprofiled timed blocks'
    seconds (``idle``), and NCCL's kernels' seconds over the same
    (``nccl``: waits for the peers and the transfers)."""
    t = float(np.mean(block_s[1:]))
    cards = {}
    for busy in busy_by_proc:
        for c, secs in (busy or {}).items():
            acc = cards.setdefault(c, {"busy_s": 0.0, "nccl_s": 0.0})
            for k in acc:
                acc[k] += secs.get(k, 0.0)
    return {c: {"idle": round(1 - v["busy_s"] / t, 6),
                "nccl": round(v["nccl_s"] / t, 6)}
            for c, v in sorted(cards.items())}


def _p25_ranks(card, specs, turn=""):
    """The runs of ``specs`` on P25_RANKS spawned ranks (one launch: each
    rank runs them in turn). Prints each rank's line a run; returns the
    ranks' (arrays, record) and the launch's seconds."""
    from dint_tpu_torch.testing import procs
    t0 = time.perf_counter()
    outs = procs.launch("runs", {"runs": specs}, P25_RANKS,
                        deadline_s=P25_DEADLINE_S)
    secs = time.perf_counter() - t0
    for i, spec in enumerate(specs):
        for arrays, rec in outs:
            r = rec["runs"][i]
            print(f"  p25 {spec['label']}{turn}, rank {rec['rank']} "
                  f"({rec['backend']}, cards {rec['cards']}, partitions "
                  f"{r['local']}): committed txn/s "
                  f"{_p25_rate(spec, arrays[f'{i}/stats'], r['block_s']):.1f}"
                  f" (the mesh's sum); block s "
                  f"{[round(b, 6) for b in r['block_s']]}  [{card}]")
        if spec.get("profile"):
            runs = [rec["runs"][i] for _, rec in outs]
            idle = _p25_idle([r["busy_s"] for r in runs],
                             runs[0]["block_s"])
            print(f"  p25 {spec['label']}{turn}, ranks: each card's idle "
                  f"share of a block, and NCCL's kernels' {idle}  [{card}]")
    print(f"  p25 ranks{turn}: {P25_RANKS} processes, "
          f"{len(specs)} runs in {secs:.3f} s (spawn, join and build "
          f"included)")
    return outs, secs


def _p25_one_process(dev, card, spec, devices=None, turn=""):
    """``spec``'s run on the one-process mesh (every partition on ``dev``,
    or on ``devices``): (stats, {partition: digests}, record)."""
    from dint_tpu_torch import timing
    from dint_tpu_torch.testing import procs
    where = "one card" if devices is None else "spread"
    mesh = procs.make_mesh(spec["engine"], spec["shape"],
                           **({"device": dev} if devices is None
                              else {"devices": devices}))
    states, stats, _, block_s, busy = procs.drive(
        spec["engine"], mesh, spec, {},
        sync=lambda: timing.synchronize(mesh.cards))
    digests = {p: procs.state_digests(states[p]) for p in range(mesh.size)}
    del states
    rate = _p25_rate(spec, stats, block_s)
    if spec["label"] == "smallbank 3x2 hier":
        CLOSED_LOOP_RATE.setdefault("p25 hier", rate)
    idle = None if busy is None else _p25_idle([busy], block_s)
    print(f"  p25 {spec['label']}{turn}, one process ({where}, cards "
          f"{[str(c) for c in mesh.cards]}): committed txn/s {rate:.1f}; "
          f"block s {[round(b, 6) for b in block_s]}"
          + ("" if idle is None else
             f"; each card's idle share of a block, and NCCL's kernels' "
             f"{idle}") + f"  [{card}]")
    return stats, digests, {"txn_s": rate, "idle": idle,
                            "cards": [str(c) for c in mesh.cards]}


def _p25_same(spec, i, outs, stats, digests):
    """Every rank's stats == the one-process run's, and each partition's
    digests (tables, backups, stamps, log rings and heads, host ints) ==
    the one-process run's, partition by partition."""
    n = 0
    for arrays, rec in outs:
        check(np.array_equal(arrays[f"{i}/stats"], stats),
              f"{spec['label']}: rank {rec['rank']}'s stats of "
              f"{stats.shape[0]} steps == the one-process mesh's",
              quiet=True)
        for p in rec["runs"][i]["local"]:
            check(list(arrays[f"{i}/p{p}/digest"]) == digests[p],
                  f"{spec['label']}: partition {p}'s digests", quiet=True)
            n += 1
    check(n == len(digests),
          f"p25 {spec['label']} bit for bit across {P25_RANKS} processes: "
          f"the stats of {stats.shape[0]} steps on every rank and the "
          f"digests of {sum(len(d) for d in digests.values())} tensors and "
          f"host ints of {n} partitions (tables, backups, stamps, log rings "
          f"and heads) == the one-process mesh's")


def _p25_launches(spec, i, outs) -> dict:
    """The run's kernel launches summed over the ranks; checks each rank
    launched its route's kernels on its partitions every step."""
    total = {}
    for arrays, rec in outs:
        got = rec["runs"][i]["launches"]
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        steps = arrays[f"{i}/stats"].shape[0]
        want = ("gather_rows", "lock_arbitrate") \
            if spec["engine"] == "multihost" else ("gather_rows",)
        per = len(rec["runs"][i]["local"])
        check(all(got[k] == steps * per for k in want),
              f"p25 {spec['label']}: rank {rec['rank']} launched "
              f"{[k for k in want]} once a partition a step ({got})",
              quiet=rec["rank"] > 0)
    return total


def phase_mesh_procs(dev, card, turns=0):
    """Phase 25: the mesh across processes (see the module docstring).
    ``turns`` > 0 (``--mesh-procs``): that many pairs of the ranks and the
    one-process mesh spread over the visible cards, in turns, with the
    cards' idle share of a profiled block."""
    n_cards = torch.cuda.device_count()
    print(f"== phase 25: the mesh across processes: {P25_RANKS} ranks, one a "
          f"host ({n_cards} card(s) visible: "
          f"{'gloo through the host, every rank on cuda:0' if n_cards < P25_RANKS else 'NCCL, one rank a card'}"
          f"); TATP multihost at {N_SUB:,} over "
          f"{P25_TATP_SHAPE[0]}x{P25_TATP_SHAPE[1]}, SmallBank at "
          f"{MESH_SB_N:,} over {MH_SHAPE[0]}x{MH_SHAPE[1]} (hierarchical, "
          f"flat), w={MESH_W} a partition, {MESH_CPB} cohorts/block, "
          f"{P25_BLOCKS} blocks (the first warm) and the drain on host-made "
          f"draws, bit for bit with the one-process mesh")
    t0 = time.perf_counter()
    specs = _p25_specs(profile=turns > 0)
    order = ["ranks", "one process"] if turns == 0 else [
        w for k in range(turns)
        for w in (("ranks", "one process") if k % 2 == 0
                  else ("one process", "ranks"))]
    rec = {"cards": n_cards, "runs": {s["label"]: {"ranks": [], "one": []}
                                      for s in specs}}
    launches, one = [], {}
    for k, where in enumerate(order):
        turn = "" if turns == 0 else f" (turn {k + 1})"
        if where == "ranks":
            outs, _ = _p25_ranks(card, specs, turn)
            launches.append(outs)
            for i, spec in enumerate(specs):
                runs = [x["runs"][i] for _, x in outs]
                rec["runs"][spec["label"]]["ranks"].append({
                    "idle": spec["profile"] and _p25_idle(
                        [r["busy_s"] for r in runs], runs[0]["block_s"]),
                    "ranks": [{
                        "rank": x["rank"], "backend": x["backend"],
                        "cards": x["cards"],
                        "txn_s": _p25_rate(spec, a[f"{i}/stats"],
                                           x["runs"][i]["block_s"]),
                        "launches": x["runs"][i]["launches"]}
                        for a, x in outs]})
            continue
        devices = None if turns == 0 else _p24_spread
        for spec in specs:
            stats, digests, r = _p25_one_process(
                dev, card, spec, devices and devices(tuple(spec["shape"])),
                turn)
            rec["runs"][spec["label"]]["one"].append(r)
            first = one.setdefault(spec["label"], (stats, digests))
            check(np.array_equal(first[0], stats) and first[1] == digests,
                  f"p25 {spec['label']}: the one-process run == its first",
                  quiet=True)
            gc.collect()
            torch.cuda.empty_cache()
    paths = {}
    for i, spec in enumerate(specs):
        for outs in launches:
            _p25_same(spec, i, outs, *one[spec["label"]])
        paths[f"p25 {spec['label']}"] = _p25_launches(spec, i, launches[0])
    rec["seconds"] = time.perf_counter() - t0
    print("  phase 25 record: " + json.dumps(rec, default=str))
    print(f"  phase 25: {rec['seconds']:.3f} s  [{card}]")
    return paths


# ------------------------------- the mesh serving plane across processes

P26_RANKS = 3                    # one process a host
P26_WIDTHS_A = (1024, 8192)      # (a): the menu, one switch between them
P26_MODEL_A = (1000.0, 500.0)    # (a): the virtual device (base_us, ns)
# (a): (arrivals a second, seconds) of virtual time: 1024 keeps up with
# the first part, the second moves the controller to 8192
P26_LOADS_A = ((1_000_000.0, 0.012), (4_000_000.0, 0.02))
P26_DEADLINE_S = 300             # the ranks are killed past this
P26_DRAW_SEED = 2626


def _p26_specs(rate_b, spread):
    """Phase 26's engines (`testing.procs.serve_engine` specs), full size:
    (a) under a VirtualClock on host-made draws, a two-rate constant
    schedule that moves the controller from 1024 to 8192 (a drain on
    every partition);
    (b) a wall-clock Poisson window at ``rate_b`` through the plan's
    priors at MH_SERVE_WIDTHS, warmed up first. ``spread``: the
    one-process engine over the visible cards (else on cuda:0)."""
    from dint_tpu_torch.serve import constant_schedule, poisson_schedule
    base = dict(n=MESH_SB_N, shape=list(MH_SHAPE), cpb=SV_CPB, depth=2,
                seed=0, plan="auto", overlap=False, device=None)
    a = dict(base, widths=list(P26_WIDTHS_A), model=list(P26_MODEL_A),
             clock="virtual", draws="host", draw_seed=P26_DRAW_SEED,
             schedule="a")
    b = dict(base, widths=list(MH_SERVE_WIDTHS), clock="real",
             warmup=True, schedule="b")
    one_a = dict(a, device=None if spread else "cuda:0")
    parts, t = [], 0.0
    for rate, secs in P26_LOADS_A:
        parts.append(t + constant_schedule(rate, secs))
        t += secs
    return [a, b], one_a, {
        "a": np.concatenate(parts),
        "b": poisson_schedule(rate_b, MH_SERVE_WINDOW_S, seed=26)}


def _p26_strip(rep):
    """A rank's report without the fields its group adds."""
    return {k: v for k, v in rep.items()
            if k not in ("processes", "backend", "rank_cards")}


def phase_serve_procs(dev, card):
    """Phase 26: the mesh serving plane across processes (see the module
    docstring)."""
    from dint_tpu_torch.testing import procs
    n_cards = torch.cuda.device_count()
    h, ci = MH_SHAPE
    d = h * ci
    rate_src = "phase 19 (b)" if "mh_sb hier" in CLOSED_LOOP_RATE \
        else "phase 25's one-process hier run"
    txn_s = CLOSED_LOOP_RATE.get("mh_sb hier",
                                 CLOSED_LOOP_RATE.get("p25 hier"))
    rate_b = 0.5 * txn_s
    print(f"== phase 26: the mesh serving plane across processes: "
          f"MeshServeEngine over {h}x{ci} on {P26_RANKS} ranks, one a host "
          f"({n_cards} card(s) visible: "
          f"{'gloo through the host, every rank on cuda:0' if n_cards < P26_RANKS else 'NCCL, one rank a card'}"
          f"), {MESH_SB_N:,} accounts, cpb {SV_CPB}, depth 2, monitor; "
          f"rank 0 admits and broadcasts each block's command. (a) a "
          f"VirtualClock, widths {P26_WIDTHS_A}, (arrivals/s, s) "
          f"{P26_LOADS_A} on host-made draws, bit for bit with the "
          f"one-process engine; (b) the wall clock, widths "
          f"{MH_SERVE_WIDTHS}, one {MH_SERVE_WINDOW_S} s Poisson window at "
          f"0.5 of {rate_src}'s {txn_s:,.1f} committed txn/s")
    t0 = time.perf_counter()
    specs, one_a, inputs = _p26_specs(rate_b, spread=n_cards >= P26_RANKS)
    t1 = time.perf_counter()
    outs = procs.launch("serve_mesh", {"engines": specs}, P26_RANKS,
                        inputs=inputs, deadline_s=P26_DEADLINE_S)
    launch_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    ref_arrays, ref = procs.serve_mesh_run(one_a, inputs)
    one_s = time.perf_counter() - t1
    gc.collect()
    torch.cuda.empty_cache()

    # (a): every rank's reports, stats and counters, every partition's
    # digests == the one-process engine's
    n_parts = 0
    for arrays, rec in outs:
        run = rec["runs"][0]
        check(all(_p26_strip(run[k]) == ref[k] for k in ("report", "closed"))
              and run["counters"] == ref["counters"]
              and np.array_equal(arrays["0/stats"], ref_arrays["stats"]),
              f"p26 (a): rank {rec['rank']}'s report (offered, admitted, "
              f"shed, per host, steps by width, controller and journal, "
              f"histograms, counters) before and after close, its stats "
              f"and its summed counters == the one-process engine's",
              quiet=True)
        for p in run["local"]:
            check(np.array_equal(arrays[f"0/p{p}/digest"],
                                 ref_arrays[f"p{p}/digest"]),
                  f"p26 (a): partition {p}'s digests", quiet=True)
            n_parts += 1
    rep_a = ref["closed"]
    switches = rep_a["controller"]["switches"]
    served = [w for w, n in rep_a["steps_by_width"].items() if n]
    check(n_parts == d and len(served) >= 2 and rep_a["committed"] > 0,
          f"p26 (a) bit for bit across {P26_RANKS} processes: every rank's "
          f"report == the one-process engine's ({rep_a['blocks']} blocks, "
          f"steps by width {rep_a['steps_by_width']}: a switch drained "
          f"every partition; controller switches {switches}, offered {rep_a['offered']:,}, shed "
          f"{rep_a['shed']:,}), stats, counters, and the digests of {d} "
          f"partitions (tables, backups, stamps, log rings and heads)")
    _mh_identities("p26 (a)", rep_a, d)

    # (b): rank 0's report on every rank, every rank's stats equal it
    rep_b = outs[0][1]["runs"][1]["closed"]
    stats0 = outs[0][0]["1/stats"]
    for arrays, rec in outs:
        run = rec["runs"][1]
        check(run["closed"] == rep_b and run["report"] ==
              outs[0][1]["runs"][1]["report"]
              and np.array_equal(arrays["1/stats"], stats0)
              and run["launches"]["gather_rows"] > 0
              and run["launches"]["gather_rows"] % len(run["local"]) == 0,
              f"p26 (b): rank {rec['rank']} ({rec['backend']}, cards "
              f"{rec['cards']}, partitions {run['local']}) returned rank "
              f"0's report, its own stats equal it, gather_rows launched "
              f"{run['launches']['gather_rows']} times on its partitions",
              quiet=rec["rank"] > 0)
    check(int(stats0[0]) == rep_b["attempted"]
          and int(stats0[1]) == rep_b["committed"] > 0,
          f"p26 (b): the report's attempted and committed "
          f"({rep_b['attempted']:,}, {rep_b['committed']:,}) are the "
          f"stats every rank holds")
    _mh_identities("p26 (b)", rep_b, d)
    q, sv = rep_b["queue"], rep_b["service"]
    shed_share = rep_b["shed"] / max(rep_b["offered"], 1)
    print(f"  p26 (b): offered {rep_b['offered']:,} at "
          f"{rep_b['offered_rate']:,.1f}/s, achieved "
          f"{rep_b['achieved_rate']:,.1f} committed/s; queue p50 "
          f"{q['p50']:.1f} p99 {q['p99']:.1f} us, service p50 "
          f"{sv['p50']:.1f} p99 {sv['p99']:.1f} us; shed share "
          f"{shed_share:.6f}; per host "
          f"{[(x['admitted'], x['shed']) for x in rep_b['per_host']]}; "
          f"steps by width {rep_b['steps_by_width']}; slo met "
          f"{rep_b['slo_met']}; backend {rep_b['backend']}, cards "
          f"{rep_b['rank_cards']}  [{card}]")
    paths = {}
    for i, tag in enumerate(("a", "b")):
        total = {}
        for _, rec in outs:
            for k, v in rec["runs"][i]["launches"].items():
                total[k] = total.get(k, 0) + v
        paths[f"p26 serve ranks ({tag})"] = total
    secs = time.perf_counter() - t0
    print("  phase 26 record: " + json.dumps({
        "cards": n_cards, "launch_s": launch_s, "one_process_a_s": one_s,
        "rank_run_s": [[r["seconds"] for r in rec["runs"]]
                       for _, rec in outs],
        "a": {"blocks": rep_a["blocks"], "switches": switches,
              "steps_by_width": rep_a["steps_by_width"]},
        "b": {"offered_rate": rep_b["offered_rate"],
              "achieved_rate": rep_b["achieved_rate"],
              "queue_p50_us": q["p50"], "queue_p99_us": q["p99"],
              "service_p50_us": sv["p50"], "service_p99_us": sv["p99"],
              "shed_share": shed_share, "per_host": rep_b["per_host"],
              "steps_by_width": rep_b["steps_by_width"],
              "slo_met": rep_b["slo_met"], "rate_source": rate_src,
              "closed_txn_s": txn_s},
        "launches": paths}, default=str))
    print(f"  phase 26: {secs:.3f} s  [{card}]")
    return paths


TURN_BLOCKS = 8                  # timed blocks a path a turn


def turn_paths(dev) -> dict:
    """One turn of ``--turns``: the one-card paths whose host work the
    mesh over the cards changed (the `dint::` ops' device guard, the
    exchange, a constant a card), each from fresh tables, one warm block
    and TURN_BLOCKS timed blocks: dense TATP at 7M (phase 4's runner),
    dense SmallBank at 24M (phase 5's default route), sharded SmallBank at
    24M over 3 partitions (phase 18 (b)'s default route) and over 3x2,
    monitored, hierarchical and flat (phase 19 (b)). Committed txn/s and
    wall ms a step each. Uses only the API that the trees compared
    share."""
    from dint_tpu_torch.engines import smallbank_dense as sd
    from dint_tpu_torch.engines import tatp_dense as td
    from dint_tpu_torch.parallel import dense_sharded_sb as dsb
    from dint_tpu_torch.parallel import multihost_sb as mhs
    out = {}

    def timed(name, runner, state, seed, commit_idx, cpb):
        run, init, drain = runner
        gen = torch.Generator(device=dev).manual_seed(seed)
        carry, _ = run(init(state), gen)
        torch.cuda.synchronize()
        secs, committed = 0.0, 0
        for _ in range(TURN_BLOCKS):
            t0 = time.perf_counter()
            carry, st = run(carry, gen)
            torch.cuda.synchronize()
            secs += time.perf_counter() - t0
            committed += int(st[:, commit_idx].to(torch.int64).sum())
        drain(carry)
        torch.cuda.synchronize()
        out[name] = {"txn_s": committed / secs,
                     "ms_step": secs / (TURN_BLOCKS * cpb) * 1e3}
        gc.collect()
        torch.cuda.empty_cache()

    timed("tatp 7M", td.build_pipelined_runner(
        N_SUB, w=W, val_words=VW, cohorts_per_block=CPB, device=dev),
        td.populate_device(torch.Generator(device=dev).manual_seed(0), N_SUB,
                           val_words=VW, device=dev),
        1, td.STAT_COMMITTED, CPB)
    timed("smallbank 24M", sd.build_pipelined_runner(
        SB_N, w=SB_W, cohorts_per_block=SB_CPB, device=dev),
        sd.create(SB_N, device=dev), 5, sd.STAT_COMMITTED, SB_CPB)
    mesh = dsb.make_mesh(MESH_D, dev)
    timed("smallbank sharded x3", dsb.build_sharded_sb_runner(
        mesh, MESH_D, MESH_SB_N, w=MESH_W, cohorts_per_block=MESH_CPB),
        dsb.create_sharded_sb(mesh, MESH_D, MESH_SB_N,
                              log_capacity=MESH_SB_LOG_CAP),
        18, dsb.STAT_COMMITTED, MESH_CPB)
    mesh = mhs.make_mesh_2d(*MH_SHAPE, dev)
    for tag, hier in (("hier", True), ("flat", False)):
        timed(f"smallbank 3x2 {tag}", mhs.build_multihost_sb_runner(
            mesh, MESH_SB_N, w=MESH_W, cohorts_per_block=MESH_CPB,
            hierarchical=hier, monitor=True),
            mhs.create_multihost_sb(mesh, MESH_SB_N,
                                    log_capacity=MESH_SB_LOG_CAP),
            18, mhs.STAT_COMMITTED, MESH_CPB)
    return out


def turns(other: str, rounds: int = 2) -> int:
    """``--turns DIR``: `turn_paths` in a process of its own for the tree
    at DIR and for this one, in turns DIR, here, here, DIR, ``rounds``
    times; prints every turn and, a path, both trees' txn/s and ms a step
    and the change's median over the other's."""
    here = os.path.dirname(os.path.abspath(__file__))
    roots = {"other": os.path.abspath(other), "this": here}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"== turns: {roots['this']} against {roots['other']}, "
          f"{TURN_BLOCKS} timed blocks a path  [{card}]")
    res = {"other": [], "this": []}
    for who in ("other", "this", "this", "other") * rounds:
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--turn-worker", roots[who]],
                           capture_output=True, text=True, timeout=900)
        sys.stderr.write(p.stderr[-4000:])
        lines = [ln for ln in p.stdout.splitlines() if ln.startswith("turn: ")]
        check(p.returncode == 0 and len(lines) == 1,
              f"the {who} tree's turn ran (rc {p.returncode})")
        rec = json.loads(lines[0][len("turn: "):])
        check(rec["package"] == os.path.join(roots[who], "dint_tpu_torch"),
              f"the turn ran the {who} tree's package {rec['package']}")
        res[who].append(rec["paths"])
        print(f"  {who}: {time.perf_counter() - t0:.1f} s; " + json.dumps(
            {k: {m: round(v, 3) for m, v in r.items()}
             for k, r in res[who][-1].items()}), flush=True)
    for path in res["this"][0]:
        row = {who: {m: [r[path][m] for r in rs] for m in ("txn_s",
                                                              "ms_step")}
               for who, rs in res.items()}
        ratio = {m: float(np.median(row["this"][m])
                          / np.median(row["other"][m]))
                 for m in ("txn_s", "ms_step")}
        print(f"  {path}: " + json.dumps({**row, "this_over_other": ratio}))
    print(card)
    return 0


KERNELS = {
    "gather_rows": ("dint_tpu_torch/csrc/gather_rows.cu",
                    "dint_tpu/ops/pallas_gather.py:212"),
    "lock_arbitrate": ("dint_tpu_torch/csrc/lock_arbitrate.cu",
                       "dint_tpu/ops/pallas_gather.py:780"),
    "lock_validate": ("dint_tpu_torch/csrc/lock_validate.cu",
                      "dint_tpu/ops/pallas_gather.py:913"),
    "gather_streams": ("dint_tpu_torch/csrc/gather_streams.cu",
                       "dint_tpu/ops/pallas_gather.py:984"),
    "scatter_streams": ("dint_tpu_torch/csrc/scatter_streams.cu",
                        "dint_tpu/ops/pallas_gather.py:1089"),
    "gather_rows_hot": ("dint_tpu_torch/csrc/gather_rows_hot.cu",
                        "dint_tpu/ops/pallas_gather.py:302"),
    "scatter_rows_hot": ("dint_tpu_torch/csrc/scatter_rows_hot.cu",
                         "dint_tpu/ops/pallas_gather.py:553"),
    "scan_rows": ("dint_tpu_torch/csrc/scan_rows.cu",
                  "dint_tpu/ops/pallas_gather.py:421"),
    "scalar_scatter": ("dint_tpu_torch/csrc/scalar_scatter.cu",
                       "tools/profile_pallas.py:48"),
}


def calibrate_only(dev, card, n):
    """``--calibrate N``: phase 22 (c) alone N times back to back, nothing
    else on the host: each run's fits at depth 2 (the serving plane's
    default) and depth 1, and their spread. Each run's evidence goes to
    $DINT_SMOKE_OUT/run<i> when set."""
    import statistics
    import tempfile
    with _Env(**P16_ENV, DINT_PLAN_PATH=None), \
            tempfile.TemporaryDirectory(prefix="dint_cal_") as tmp:
        root = os.environ.get("DINT_SMOKE_OUT") or tmp
        runs = []
        for i in range(n):
            out_dir = os.path.join(root, f"run{i}")
            os.makedirs(out_dir, exist_ok=True)
            print(f"== calibration run {i + 1} of {n}")
            rec, _ = _p22_calibration(dev, card, out_dir)
            runs.append({d: f["model"] for d, f in rec["fits"].items()})
            gc.collect()
            torch.cuda.empty_cache()
    spread = {d: {c: {"min": min(r[d][c] for r in runs),
                      "median": statistics.median(r[d][c] for r in runs),
                      "max": max(r[d][c] for r in runs)}
                  for c in ("base_us", "per_lane_ns")}
              for d in P22_CAL_DEPTHS}
    print("  calibration runs: " + json.dumps(
        {"runs": runs, "spread": spread, "card": card}))
    return 0


def main(argv=None) -> int:
    t_run = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calibrate", type=int, metavar="N",
                    help="run phase 22 (c) alone N times and print the "
                         "fits' spread, in place of the smoke run")
    ap.add_argument("--mesh-cards", type=int, nargs="?", const=1,
                    metavar="TURNS",
                    help="run phase 24 (the mesh over every visible card) "
                         "alone after phase 1, in place of the smoke run; "
                         "TURNS spread and one-card pairs a route, in turns "
                         "(default 1)")
    ap.add_argument("--mesh-procs", type=int, nargs="?", const=1,
                    metavar="TURNS",
                    help="run phase 25 (the mesh across processes: NCCL, "
                         "one rank a card, on several cards; gloo through "
                         "the host on one) alone after phase 1, in place of "
                         "the smoke run; TURNS pairs of the ranks and the "
                         "one-process mesh spread over the cards, in turns, "
                         "each with a profiled block (default 1)")
    ap.add_argument("--turns", metavar="DIR",
                    help="time the one-card paths of `turn_paths` for this "
                         "tree against the tree at DIR, in turns, in place "
                         "of the smoke run")
    ap.add_argument("--turn-worker", metavar="ROOT", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.turn_worker:         # one turn, on the tree at ROOT
        sys.path.insert(0, os.path.abspath(args.turn_worker))
    if args.turns:
        return turns(args.turns)
    try:
        import dint_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the dint_tpu_torch package is missing ({e}); "
              f"run from the repository root", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    if args.turn_worker:
        print("turn: " + json.dumps({
            "package": os.path.dirname(dint_tpu_torch.__file__),
            "paths": turn_paths(dev)}))
        return 0
    card = phase_card()
    if args.calibrate:
        return calibrate_only(dev, card, args.calibrate)
    if args.mesh_cards:
        phase_mesh_cards(dev, card, args.mesh_cards)
        return 0
    if args.mesh_procs:
        phase_mesh_procs(dev, card, args.mesh_procs)
        gc.collect()
        torch.cuda.empty_cache()
        phase_serve_procs(dev, card)
        return 0
    rec = {**phase_kernels(dev), **phase_sb_kernels(dev)}
    tatp_rec = phase_tatp_kernels(dev)
    rec["lock_validate"] = tatp_rec.pop("lock_validate")
    rec["scalar_scatter"], probe = phase_scalar_scatter(dev)
    phase_cpu_vs_card(dev)
    phase_sb_cpu_vs_card(dev)
    store_hot = phase_store_cpu_vs_card(dev)
    phase_cache_cpu_vs_card(dev)
    tatp_default, ref_db, ref_stats = phase_main_path(dev)
    tatp = {"default": tatp_default,
            **phase_tatp_routes(dev, (ref_db, ref_stats))}
    phase_recovery_tatp(dev, ref_db)
    del ref_db
    torch.cuda.empty_cache()
    sb = phase_smallbank(dev)
    torch.cuda.empty_cache()
    sb["recovery"] = phase_recovery_smallbank(dev)
    rec["scan_rows"], store_paths = phase_store(dev)
    store_paths["store hot"] = store_hot
    torch.cuda.empty_cache()
    cache_paths, cache_rec = phase_cache(dev)
    store_paths.update(cache_paths)
    store_paths["probe"] = probe
    store_paths.update(phase_bench(card))
    gc.collect()
    torch.cuda.empty_cache()
    phase_generic_cpu_vs_card(dev)
    store_paths["generic engines"], shards, pop_s = phase_generic(dev, card)
    coord_paths, replicas = phase_coordinators(dev, card, shards, pop_s)
    store_paths.update(coord_paths)
    del shards
    store_paths.update(phase_wire(dev, card, replicas))
    gc.collect()
    torch.cuda.empty_cache()
    store_paths.update(phase_serve(dev, card))
    gc.collect()
    torch.cuda.empty_cache()
    store_paths.update(phase_observability(dev, card))
    gc.collect()
    torch.cuda.empty_cache()
    store_paths.update(phase_sweeps(dev, card))
    gc.collect()
    torch.cuda.empty_cache()
    store_paths.update(phase_mesh(dev, card))
    gc.collect()
    torch.cuda.empty_cache()
    store_paths.update(phase_sb_mesh(dev, card))
    gc.collect()
    torch.cuda.empty_cache()
    store_paths.update(phase_mh_sb(dev, card))
    gc.collect()
    torch.cuda.empty_cache()
    store_paths.update(phase_lint(dev, card))
    gc.collect()
    torch.cuda.empty_cache()
    store_paths.update(phase_cost(dev, card))
    gc.collect()
    torch.cuda.empty_cache()
    store_paths.update(phase_plan(dev, card))
    gc.collect()
    torch.cuda.empty_cache()
    phase_mesh_trace(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    store_paths.update(phase_mesh_cards(dev, card))
    gc.collect()
    torch.cuda.empty_cache()
    store_paths.update(phase_mesh_procs(dev, card))
    gc.collect()
    torch.cuda.empty_cache()
    store_paths.update(phase_serve_procs(dev, card))

    kernels = []
    for name, (src, replaces) in KERNELS.items():
        r = rec[name]
        # launches on the main paths: TATP's routes (phases 4 and 6),
        # SmallBank's (phase 5, and phase 10's run), the store's (phase 7,
        # and the hot route's steps on the card in phase 3), the cache
        # tier's hot run (phase 8), the probe's entry point (phase 2) and
        # the bench's two legs (phase 9, counted in its process),
        # sweep_micro's store points (phase 14 (d)), phase 15's traced
        # runs and profiled blocks, phase 16's sweep, serve and
        # calibration points and drive, phase 17's sharded, multihost
        # and dry runs, phase 18's sharded SmallBank runs and dry run, and
        # phase 19's 2-D mesh runs, serving windows and exp points,
        # phase 20's traced blocks, phase 21's full-width blocks (the
        # footprint's and the profiled one), phase 24's spread mesh runs
        # and phase 25's runs and phase 26's serving runs across
        # processes (counted in each rank's process from 0 just before
        # its run, summed over the ranks),
        # each counted from 0 just before its run
        paths = {**{f"tatp {k}": v[name] for k, v in tatp.items()},
                 **{f"smallbank {k}": v[name] for k, v in sb.items()},
                 **{k: v[name] for k, v in store_paths.items()}}
        print(f"  {name}: launches {paths}")
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces, "launches": sum(paths.values()),
               "max_abs_err": r["max_abs_err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": "bytes", "library_ms": r["library_ms"],
               "launches_by_path": paths}
        if name in tatp_rec:     # the same kernel at TATP's shapes
            row["tatp_shapes"] = tatp_rec[name]
        if name == "gather_rows":   # SmallBank's three-stream call
            row["smallbank_shapes"] = rec["gather_rows_smallbank"]
        if name in cache_rec:    # and at the cache tier's (phase 8)
            row["cache_shapes"] = cache_rec[name]
        if "yard_ms" in r:     # the same call's yardstick: comparable
            row["kernel_over_yardstick"] = r["ms"] / r["yard_ms"]
        if name == "lock_validate":
            row["unfused_pair_ms"] = r["unfused_ms"]
            row["torch_chain_ms"] = r["yard_ms"]
        if name == "scan_rows":
            row["index_select_yardstick_ms"] = r["yard_ms"]
        if "launches_per_call" in r:   # a graph capture of one call
            row["launches_per_call"] = r["launches_per_call"]
        kernels.append(row)
    check(all(k["launches"] > 0 for k in kernels),
          "every kernel was launched on a main path")
    by_name = {k["name"]: k["launches_by_path"] for k in kernels}
    check(all(by_name["lock_validate"][f"tatp {r}"] > 0
              for r in ("fused", "fused+hotset"))
          and all(by_name[k][f"tatp {r}"] > 0
                  for k in ("gather_rows_hot", "scatter_rows_hot")
                  for r in ("hotset",))
          and by_name["gather_rows_hot"]["tatp fused+hotset"] > 0,
          "lock_validate ran on both fused TATP routes, the hot kernels on "
          "the TATP hot routes")
    check(by_name["scan_rows"]["store scan"] > 0
          and by_name["scan_rows"]["store point"] == 0
          and by_name["gather_rows_hot"]["store hot"] > 0
          and by_name["scatter_rows_hot"]["store hot"] > 0,
          "scan_rows ran on the store's scan path and not on its point path; "
          "the hot kernels on the store's hot route")
    check(by_name["gather_rows_hot"]["micro store_zipf"] > 0
          and by_name["scatter_rows_hot"]["micro store_zipf"] > 0
          and by_name["scan_rows"]["micro store_scan"] > 0,
          "sweep_micro's store_zipf_w4096 (use_hotset) ran the hot kernels, "
          "its store_scan_f95 scan_rows")
    check(by_name["gather_rows_hot"]["cache hot"] > 0
          and by_name["scatter_rows_hot"]["cache hot"] > 0
          and by_name["scalar_scatter"]["probe"] > 0
          and len(kernels) == 9,
          "the hot kernels ran on the cache tier's hot run, scalar_scatter "
          "on the probe; the kernels line lists nine kernels")
    check(all(by_name[k][f"p16 tatp_closed_w{W}"] > 0
              for k in ("gather_rows", "lock_arbitrate"))
          and all(by_name[k][f"p16 tatp_fused_closed_w{W}"] > 0
                  for k in ("scatter_streams", "lock_validate"))
          and all(by_name[k]["p16 smallbank_skew_h16_closed_w8192"] > 0
                  for k in ("gather_rows_hot", "scatter_rows_hot"))
          and by_name["scan_rows"]["p16 drive"] > 0,
          "phase 16: gather_rows and lock_arbitrate ran on the default TATP "
          "points, scatter_streams and lock_validate on the fused one, the "
          "hot kernels on the hot-tier skew point, scan_rows in drive")
    check(all(by_name[k][p] > 0 for k in ("gather_rows", "lock_arbitrate")
              for p in ("tatp sharded", "tatp multihost"))
          and all(by_name[k]["tatp sharded fused"] > 0
                  for k in ("scatter_streams", "lock_validate")),
          "phase 17: gather_rows and lock_arbitrate ran on the sharded and "
          "multihost default routes, scatter_streams and lock_validate on "
          "the sharded fused route")
    check(by_name["gather_rows"]["smallbank sharded"] > 0
          and all(by_name[k]["smallbank sharded hotset"] > 0
                  for k in ("gather_rows_hot", "scatter_rows_hot"))
          and all(by_name[k]["smallbank sharded fused"] > 0
                  for k in ("gather_streams", "scatter_streams")),
          "phase 18: gather_rows ran on sharded SmallBank's default route, "
          "gather_rows_hot and scatter_rows_hot on its hot route, "
          "gather_streams and scatter_streams on its fused route")
    check(by_name["gather_rows"]["smallbank multihost"] > 0
          and by_name["gather_rows"]["smallbank multihost flat"] > 0,
          "phase 19: gather_rows ran on SmallBank's 2-D mesh, both "
          "exchanges")
    check(all(by_name[k]["p24 tatp default"] > 0
              for k in ("gather_rows", "lock_arbitrate"))
          and all(by_name[k]["p24 tatp fused"] > 0
                  for k in ("scatter_streams", "lock_validate"))
          and all(by_name["gather_rows"][f"p24 smallbank 3x2 {r}"] > 0
                  for r in ("hier", "flat")),
          "phase 24: the spread mesh's runs launched their routes' "
          "kernels on the partitions' cards")
    check(all(by_name[k]["p25 tatp multihost"] > 0
              for k in ("gather_rows", "lock_arbitrate"))
          and all(by_name["gather_rows"][f"p25 smallbank 3x2 {r}"] > 0
                  for r in ("hier", "flat")),
          "phase 25: the ranks launched their routes' kernels on their "
          "partitions")
    check(all(by_name["gather_rows"][f"p26 serve ranks ({t})"] > 0
              for t in ("a", "b")),
          "phase 26: the serving plane's ranks launched gather_rows on "
          "their partitions")
    print(f"chip_smoke: {time.perf_counter() - t_run:.3f} s, every phase  "
          f"[{card}]")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
