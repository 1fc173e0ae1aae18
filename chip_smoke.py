#!/usr/bin/env python3
"""On-card smoke of the PyTorch port (`alphatriangle_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA card and the repository checkout around this file; exits
non-zero, printing no result, without either. Phases, any failure of
which exits non-zero:

1. Prints the card (`nvidia-smi` name and power limit), the torch and
   CUDA versions, and builds every kernel from `alphatriangle_tpu_torch/
   csrc/` (one `nvcc` per source, all started together).
2. Kernels: at the flagship shapes of their paths each kernel must be
   bit-equal (`torch.equal`) to its plain PyTorch version on the same
   card inputs: the search's gather and backup at the serving path's
   B=64 slots and the training path's B=512 lanes (N=65 node rows,
   A=360, W=32, D=8; the backup's inputs holding duplicate edges and
   inactive entries), the PER count of the megastep
   (250,000 priorities with zero runs and a zero trash slot, K=2 x
   B=256 draws, some on segment edges), and the promotion's row reorder
   at B=64 and B=512 (N=129 node rows, A=360, a budget of 65 rows, 8 BFS
   rounds; random forests built as a search builds them, with invalid
   lanes and lanes cut at the budget). Times the kernel, its plain
   version and one library call with CUDA events, and computes the least
   time the card could take. Then the PER count and the backup on every
   adversarial family of `alphatriangle_tpu_torch/ops/kernel_cases.py`
   (the backup bit-equal, signs of zero included, at B=64 and B=512),
   and each one's worst case timed: an unsorted cumsum, every backup
   entry on one element.
3. Serve: the full-width default configuration (8x15 board, 3 slots,
   bf16 net of seed 0, 64 slots x 64 simulations, W=32, depth 8) through
   `run_simulated_load` -> `PolicyService.dispatch` for a few
   dispatches. Every request must be answered with an action valid for
   its live lane, the search outputs must be finite, and the launch
   counters must show 16 `gather_rows` and 2 `backup_update` launches per
   dispatch.
4. Train: the full-width default training configuration (512 lanes x
   64 simulations, batch 256, a 250,000-slot ring, 5-step returns, PER,
   AdamW with a cosine schedule) through `run_training` in fused
   megastep mode, cut in depth only: 2-move chunks, 256 rows to start
   training, K=2 learner steps per megastep, 4 megasteps. Losses must
   be finite, the parameters must change, `per_sample` must launch once
   per megastep and the search kernels 16 + 2 times per searched move,
   and the device priorities, ring size and cursor must agree with the
   host SumTree mirror. Then one more megastep runs under
   `torch.profiler`.
   Phases 3 and 4 record the backup operands of their first dispatch and
   first searched move (copied to the host) on the way.
5. Real waves: the backup kernel on those recorded operands must be
   bit-equal to its plain version; its time on them.
6. Serve with subtree reuse: phase 3 with `MCTSConfig(tree_reuse=True)`
   (129 node rows). Besides phase 3's checks, one `subtree_promote`
   launch per dispatch, live lanes' root visits equal to the budget plus
   the inherited visits, and some visits inherited.
7. Train with subtree reuse: phase 4 with `tree_reuse=True` under the
   same cuts. Besides phase 4's checks, one `subtree_promote` launch per
   searched move and some visits inherited.
8. Reference: a small search on the card must give the visit counts of
   the same search on the CPU (plain versions), under a stub net whose
   outputs are exact; three moves of carried search and promotion must
   give the CPU's visit counts, inherited visits and carried planes; and
   a tiny megastep (f32 net, TF32 off) must ingest the same rows, draw
   the same slots and reach the same losses on the card as on the CPU;
   so must a tiny synchronous iteration (3 learner steps and a weight
   sync), which "auto" runs on the host ring on the CPU and on the
   device ring on the card.

Between phases 7 and 8, the synchronous and the overlapped loop at the
train phase's widths and cuts, through `run_training`:

- train-sync: the device ring (`DEVICE_REPLAY="auto"` on the card), 10
  learner steps in single-step groups, a weight sync at step 10. Losses
  must be finite, each iteration must take `max(1, round(rows / 256))`
  steps once the ring can give a batch (within the budget), the search
  kernels must launch 16 + 2 times per searched move and `per_sample`
  never, the eval net's weights must differ from the learner's before the
  sync and equal them bit for bit after it, every chunk must search with
  one set of weights, and the ring must hold the rows ingested. Then one
  more iteration runs under `torch.profiler`.
- train-sync-host: the same with `DEVICE_REPLAY="off"`, 4 steps: the host
  ring, batches uploaded.
- train-async: `ASYNC_ROLLOUTS` with 2 producer streams, `REPLAY_RATIO`
  1.0, a pipelined learner of fused pairs, a queue of 4, the default
  2-second chunk target, the device ring, 10 steps. The run must
  complete at step 10 with both streams' harvests folded, no producer
  restart, a replay ratio of at most 1.0, at least one weight sync
  (checked as above), one set of weights per chunk, and 16 + 2 search
  launches per searched move over all streams. Then the same loop runs 2
  more steps under the profiler: the card's busy share is the union of
  every stream's kernel and copy intervals over the window's wall. Then
  2 more with every beacon armed and no beacon ring yet: the rows the
  ring's drain writes must equal, as a multiset, the beacons the host
  enqueued on the two producer streams and the learner's, none dropped.

Then the checkpoint paths, at the default widths and the train-sync
phase's depth cuts:

- preempt-resume: `python -m alphatriangle_tpu_torch.cli train` (the
  synchronous loop, the device ring) with a checkpoint every 4 of 10
  steps, SIGTERM once step 4 is committed. It must exit 114 and leave
  `preempt_report.json`, a committed checkpoint and a spill at the step
  it stopped at. The same command under another run name must
  auto-resume that run from that step with the spill's rows and reach
  step 10 (exit 0). The search kernels 16 + 2 times per searched move
  over both processes (each process counts its own).
- megastep-resume: `run_training` in megastep mode, checkpoints every 2
  steps to step 4, then a run of another name auto-resumes it for 2
  megasteps. The learner installed before the first resumed megastep
  must equal the file bit for bit (parameters, moments, count, step,
  key), which also loads on the CPU bit-equal; the device priorities the
  first resumed megastep draws from must be the float32 of the restored
  SumTree leaves; `per_sample` once per resumed megastep.
- ring round trip: the device ring at all 250,000 slots (the resumed
  ring's rows and priorities repeated, the cursor wrapped), timed
  through `get_state`, the spill, `restore_buffer_path` and `set_state`;
  the restored ring and SumTree must equal it bit for bit, oldest row
  first.
- eval: `python -m alphatriangle_tpu_torch.cli eval` against the
  preempted run's checkpoint, 64 games x 64 simulations, cut at 8
  moves. The JAX report's keys, the restored step named, the random
  side equal to the same baseline played on the CPU, 16 + 2 search
  launches per dispatch.

Then the paths of the Gumbel root search, playout-cap randomization and
the presets, each at its preset's full width and cut in depth only:

- kernels at the new search shapes (`kernel_cases.SEARCH_SHAPES`: fast
  searches N=17/W=16, presets 2 and 4 N=201/401 W=25, preset 5 B=1024
  A=756): the gather and the backup (the Gumbel wave family and the
  random one) bit-equal to their plain versions, each timed against its
  bytes bound; after train-preset3, the backup on the recorded operands
  of its first full (Gumbel) and first fast wave, bit-equal.
- train-preset3: `cli train --preset 3` (512 lanes, Gumbel roots of 64
  simulations, fast searches of 16 at p = 0.25, the 4-layer
  transformer, batch 256, the 250,000-slot ring) in its synchronous loop
  to 2 learner steps, timed with no synchronisation added: 16 + 2
  launches per full move and 8 + 1 per fast one over the run, the
  Full_Search_Fraction ticks matching the moves, a live_metrics.jsonl
  line per tick. Then chunks of the same engine with every move timed
  between synchronisations (the full and fast move times, each move's
  launches) and one iteration profiled. train-preset3-megastep: the
  same with --fused-megastep (K = 2), one megastep profiled.
  train-preset3-async: the same with --async-rollouts (the preset's one
  producer stream), no restart, the replay ratio within its gate.
- eval-gumbel: `cli eval --gumbel` of the preempted run's checkpoint
  (the eval phase's checks). serve-gumbel: the serve default through
  `GumbelMCTS(exploit=True)`, every served action the search's
  selection, 16 + 2 launches per dispatch, one dispatch profiled.
- train-preset2/4/5: `cli train --preset N` in the synchronous loop
  until one learner step: 8 gathers and a backup per wave (8, 16 and 2
  waves a move); the iteration time and the peak memory.
- attention memory: preset 5's leaf evaluation (1024 x 32 leaves of 252
  tokens) in attention slices and, as before this slice, whole (an
  out-of-memory error there is the measurement).
- references: a Gumbel search (explore and exploit) and four moves of a
  playout-cap Gumbel chunk on the card equal to the CPU's.

Then slice eight's paths, at the default widths (`EnvConfig()`,
`ModelConfig()` with bf16 compute, 512 lanes, batch 256, the 250,000-slot
ring; the train phases' depth cuts, 4 learner steps in groups of 2),
NORM_TYPE and INFERENCE_PRECISION set by a tuned-preset artifact through
`cli train --preset PATH`:

- train-bn-bf16-megastep (`--fused-megastep`, batch norm, bf16): every
  chunk searches with a bf16 `InferenceNet`, one cast per megastep, 16 +
  2 launches per searched move and one `per_sample` per megastep, every
  running statistic moved and finite; the cast timed alone and one
  megastep profiled. train-bn-int8-sync (the synchronous loop, batch
  norm, int8) and train-int8-async (one producer stream, int8): one cast
  per weights version the chunks read, one iteration (or a window of 2
  steps) profiled for the busy share.
- eval-bn-int8: `cli eval` of the int8 batch-norm run (the eval phase's
  checks). serve-run: `cli serve --run-name` of that run at 64 slots x
  64 simulations; a newer checkpoint committed once the server restored
  its own must be hot-reloaded (`--reload-every 2`).
- serve-precision: the serve default at float32, bfloat16 and int8 in
  this process on the same weights and sessions, their dispatches
  interleaved round by round: dispatch p50, moves/s,
  `search.evaluate` on the card per dispatch, the bytes the search reads
  its weights from, the int8 dequantization's launches per evaluation
  (one kernel per row-length group, counted in a profile) and its time,
  bit-equal to the leaf-by-leaf form on the card.
- reference: the default net's int8 `q` / `scale` and dequantized
  weights on the card equal the CPU's bit for bit; a batch-norm learner
  step within 1e-5 (losses) and 1e-4 (running statistics) of the CPU's;
  bf16 and int8 searches within the bf16 tolerances of
  `tests/torch_parity.py`.

Then slice nine's paths, at the serve default's widths (`EnvConfig()`,
`ModelConfig()`, 64 simulations) and the train phases' depth cuts:

- serve-ladder: `PolicyService(slots=16, ladder="16,32,64", sustain=2)`,
  every rung warmed (one search at its width), then a storm of 160
  sessions of 8 moves at concurrency 64 through `run_simulated_load`.
  Every session served, at least two switches, the rung up to 64 and
  down again on the drain, 16 + 2 launches in every dispatch at
  whatever rung, the `_build/` listing and the loaded libraries
  unchanged after the warm-up, every served action valid. Per rung:
  dispatch p50, the first dispatch after a switch, the migration's ms
  (synchronised). Then a tracked session plays the same game solo as in
  a churning crowd with the same switch (16 -> 32) after the same
  dispatch.
- serve-ladder-reuse: the same storm with `tree_reuse=True`: every
  carried tree dropped at each switch (`_carry_ok` all False, empty
  trees at the new width), one `subtree_promote` launch per dispatch,
  and the reorder of the first promotion at 32 lanes (its operands
  recorded on the way) bit-equal to its plain version.
- league: `cli train` (the synchronous loop, 4 steps, a checkpoint every
  2) writes a pool of two checkpoints; `cli league --pool-from` it with
  `--steps 1 --mix 1.0 --slots 8 --games 4 --max-moves 24
  --promotion-games 1 --promotion-win-rate 0.0`. Exit 0, a pool of at
  least 2, a round and a promotion, every round's rows ingested equal to
  the live side's moves less the stale ones, `league.jsonl` replayed to
  the report's ratings, 16 + 2 launches per league dispatch; rounds/s,
  ingested moves/s and the league service's dispatch p50.

Then slice ten's serving fleet, at the serve default's widths (no
configs.json, 64 simulations):

- fleet (a): `python -m alphatriangle_tpu_torch.cli fleet --smoke --device
  cuda` in a process whose imports of torch, numpy and JAX raise: 2
  replica subprocesses on the card at 16 slots on the ladder 4/8/16, a
  storm of 64 episode requests of up to 8 moves at concurrency 16, a
  rolling reload once 8 ended, a `hang-serve` fault at the 3rd dispatch
  of one replica (10 s dispatch deadline, watchdog poll 0.5 s, one
  strike to quarantine), a SIGKILL once 60 ended. Exit 0, nothing lost,
  every request completed or shed; on `fleet.jsonl` the hung replica's
  death with 113, its dispatch-hung verdict naming `serve/b16`,
  its respawn at 8 slots, its ready line and its re-admission in that
  order, the chaos kill's death and respawn, the reload's replies with
  0 recompiles (a replica that died during the round excepted), every
  ready line on this card with its warm-up searches run; `fleet.prom`
  and an SLO status. Move latency p50 / p95, requests/s, deaths,
  respawns, re-admissions, each death to its re-admission, each spawn
  to its ready line, each replica's dispatch p50 (its flight seals).
- fleet (b): in this process, a `ReplicaServer` of the serve default at
  16 and then at 8 slots, each fed a pipe of episode requests filling its
  slots: 16 `gather_rows` and 2 `backup_update` launches per dispatch and
  nothing else, the first gather and backup at each width bit-equal to
  their plain versions. Its launches and dispatches are the fleet path's
  in the kernels line.

Slice eleven's telemetry of a training run rides on those paths, at
their widths and cuts (no training run is added):

- train, train-reuse, train-sync, train-sync-host and train-async: each
  telemetry hook the loop calls (`RunTelemetry.on_rollout`,
  `on_learner_step`, `on_util_tick`, `on_tick`, the collector's
  `record_metrics`, the iteration's `record_device_stats`) timed with `perf_counter`, plus the flight
  recorder's own `overhead_seconds`, per iteration (from one
  `_iteration_tail` to the next): the mean per iteration must be at most
  5% of the iteration p50. Right after `run_training`: `health.json`
  live by the port's `health_verdict`; `metrics.jsonl` one `kind:"util"`
  record per iteration after the first, each on this card's name with
  `peak_source` "table", and with an MFU in (0, 1) and non-zero
  dispatches, transfers and simulations in the synchronous and megastep
  loops (per record) and over the overlapped loop's run (its beats may
  fold nothing); the flight ring one intent and one `ok` seal per chunk,
  learner group or megastep the components counted, none unsealed.
- preempt-resume: `cli health --probe` of the run while the first
  `cli train` trains (exit 0, one JSON line, code 0); after the resumed
  run, `cli health` and `cli perf --json` of it, in a process whose
  imports of torch, numpy and JAX raise: exit 0, a non-null MFU.
- league: the report's `ledger` is the run's `metrics.jsonl`, which
  holds the report's `kind:"league"` records, one per round.

Slice twelve's device telemetry and profiling, at the serve and train
defaults' widths and cuts:

- kernel: the beacon writer (`csrc/beacon.cu`, not a TPU kernel: the
  JAX package's beacons are host callbacks) against its plain version,
  4,196 rows through a wrapping 4,096-slot ring in mapped pinned memory,
  equal word for word; timed per call against its bytes bound.
- the train phases (train, train-reuse, train-sync, -sync-host, -async,
  the three train-preset3 loops) and league run with the stat-packs on
  (the training default): one `kind:"device_stats"` record an iteration
  (the overlapped loop: its freshest folds), every search leg finite
  with its root entropy in [0, ln 360], the depth histograms summing to
  the run's simulations (fast moves at their 16), a PER and a learner
  leg for every megastep, a reused share above 0 with reuse, the util
  records' `root_visit_entropy`, `tree_occupancy` and `beacons_armed`
  set; the league's serve legs count every league dispatch. The search
  and PER launches stay 16 + 2 a searched move and one count a megastep.
  Serve phases build their searches with the stat-packs off, the serve
  default. After the train phase's run, on its components: megasteps
  with the packs off and on interleaved, one profiled with them off
  whose host-blocking runtime calls must equal the profiled one's with
  them on, and one megastep with every beacon armed whose rows, drained
  from the card's ring, must equal the beacons the host enqueued.
- reference: the small reference search's stat-pack on the card equal
  to the CPU's (histogram, concentration, occupancy, |value| max; the
  entropy within 1e-6 relative).
- serve-stats: the serve default built with the packs off and under
  `ALPHATRIANGLE_DEVICE_STATS=1` with a serve run's telemetry,
  dispatches interleaved (p50 off / on), one of each profiled (launches,
  equal host-blocking calls), the stats service's ticks ledgering serve
  legs of 64 x 64 simulations a dispatch and the util gauges.
- beacons: the serve default with a 4 s dispatch deadline whose wedges
  do not exit. A dispatch stalled 2.8 s on the card between its waves:
  the near-deadline warning arms the beacons, once.
  Dispatches until the deadline is back at its floor, then an armed
  dispatch stalled 6 s on the card before its second wave's beacon: 1 s
  into it the host has enqueued that beacon, and the run's last beacon
  must be the first wave's (`search_wave` 0; the rows before it end at
  wave 1); the wedge report written at 4 s carries it and
  `classify_run` names it; the rows after the fetch equal what the host
  enqueued. Then armed and unarmed dispatches interleaved.
- profile: `cli train --fused-megastep --profile` to 2 megasteps of
  4-move chunks (the window, which counts megasteps, holds the second), then
  `cli analyze` of its `profile_data/` (exit 0 both): the phase timers
  hold rollout, megastep and checkpoint; the trace's device lines count
  the window's gather, backup and PER-count kernels exactly; the top
  five device kernels and the profiled against the unprofiled megastep.

Slice thirteen's supervisor, doctor and run readers, after the fleet
(the two supervise drills on a thread of their own, beside slice
fourteen's dp phases: each side waits on its own processes):

- supervise-wedge: `cli supervise --run-name R -- train --fused-megastep`
  at the train phase's widths and cuts to step 12 with a checkpoint every
  2, in a process whose imports of torch, numpy and JAX raise, with
  `hang-dispatch` at the 3rd megastep's dispatch (dispatch deadline
  max(15 s, 10 x its expected wall), watchdog poll 0.5 s): exit 0;
  `supervisor.jsonl` spawn -> death (113, dispatch-hung, family
  megastep, restart with `TELEMETRY__BEACONS`) -> spawn -> complete; `cli
  doctor` at the death naming the hung megastep (exit 4); no child
  building a kernel (`_build/` unchanged); the respawn resuming at the
  newest committed step (at most one cadence lost), its
  beacon rows written by the card's writer, 16 + 2 search launches a
  searched move and one count a megastep. The death to the respawn's
  first dispatch and first megastep, the hang to the death.
- supervise-torn: the same, to step 8, with `sigkill-save` at step 4: a
  SIGKILL between the meta and the commit marker, the torn step_4 seen at
  the death, the restart from step 2, exit 0.
- doctor: `cli doctor --json` of the preempted run (preempted, exit 7,
  taken before its resume), the beacon phase's wedged serve run
  (dispatch-hung naming its beacon), the fleet parent (the fleet branch,
  its deaths and respawns those of `fleet.jsonl`) and the supervised run
  once complete (clean); each exit code its verdict's.
- readers: `cli trace` of the profile run (its phase spans), `trace
  --fleet` of the fleet parent (every replica, flow arrows), `watch
  --once`, `compare` of the supervised run with itself (parity), `slo
  --json` and `perf --json` of the fleet parent (the report's exit code;
  the fleet_* fields), all torch-free; `cli devices` (the card, one).

Slice fourteen's data-parallel training, beside the supervise drills and
before the doctor (the one-process resume below runs beside the doctor,
readers and reference phases), at the train phase's widths and cuts to 4
megasteps with a checkpoint every megastep,
each rank's second and third megasteps traced (`--profile`, whose
window counts megasteps, not warm-up chunks):

- train-dp1: `cli train --distributed --fused-megastep` as a world of
  one over NCCL. The report must name NCCL and a world of one; 16 + 2
  search launches a searched move and one count a megastep; finite
  losses; the parameters after the first megastep bit-equal to the train
  phase's (the same run without `--distributed`), or else, where two
  `cli train` runs without it agree bit for bit, to theirs, and within
  rtol 2e-4, atol 2e-5 where they do not; the phase says which.
- train-dp2-shared: the same command as two rank processes sharing the
  card over gloo (`--dist-backend gloo`), each with 256 lanes, a batch
  of 128 and a 125,000-slot ring shard. The parameter digests of both
  ranks equal after each megastep; each rank's launches as above; rank
  0 alone writing the checkpoints, `meta.json`, the ledger and the
  heartbeat (rank 1 opens no writer); then the run's checkpoint and
  spill resumed in one process (`cli train --fused-megastep`, one more
  megastep) with both shards' rows.

Each prints, per rank, the megastep p50, the `dp.all_reduce` label's
share of the traced megastep, the peak device memory and the wall from
the spawn to the first megastep. The kernel phase holds `gather_rows`
and `backup_update` bit-equal to their plain versions at a rank's 256
lanes too, and `per_sample` over a rank's 125,000-slot shard with K x
128 draws.

Slice fifteen's tensor and sequence parallelism, after the dp2 resume,
in the synchronous loop: one pair of rank processes sharing the card
over gloo (`python3 chip_smoke.py --mesh-rank SPEC RANK`, this file as a
child) runs both meshes in turn, each through `run_training(mesh_config=
...)` (no CLI flag sets the mdl or sp axis) over a process group of its
own, at the train default's widths (64 simulations, batch 256), cut to
3-move chunks, 1 learner step an iteration and 3 steps: 4 iterations,
the first without rows, the third traced (`--profile`'s window of
iterations 1-2 narrowed to 2, a trace half the size); the shares are
its (the second pays the learner's first use, on tp2 unequally: the
rank that played has run the net).

- train-tp2-shared: `MeshConfig(MDL_SIZE=2)`, the transformer sharded
  Megatron-style over the two ranks. The mdl line's first rank plays the
  512 lanes and broadcasts each harvest (the lanes are replicated over
  mdl); the other plays none.
- train-sp2-shared: `MeshConfig(SP_SIZE=2, SP_ATTENTION="ring")`, 256
  lanes a rank. Before training each rank holds ring and Ulysses
  attention at the learner's shape (256, 120, 4, 32), float32, to dense
  attention on the whole inputs, forward and q / k / v gradients, within
  2e-5 / 5e-5 (`tests/test_ring_attention.py`'s tolerances), and times
  each beside dense.

Each must complete at step 3 with the gathered-parameter digests equal
on both ranks after every iteration, the search kernels launched 16 + 2
times a searched move on every rank that plays, at its lanes, and no
PER count (the host ring), and the checkpoint's episodes those of the
lanes' owners (each lane once). Each prints per rank the iteration p50,
the share of the traced training iteration under `tp.all_reduce` /
`sp.attention`, the peak device memory and the wall to the first
iteration (from the pair's spawn for tp2, from the start of its group
for sp2).

Slice sixteen: train-dp2-shared-async, the overlapped loop over two
gloo ranks sharing the card (`cli train --distributed --async-rollouts
--device-replay on`, each rank 256 lanes in 2 producer streams, a batch
of 256 over the ranks, a 125,000-slot shard; cut to 4-move chunks, a
replay ratio of 0.25 and 4 learner steps, `--profile`), on a thread
of its own beside train-dp1, train-dp2-shared and the drills. Both ranks must report the same steps, beats and tuned
chunk and the same parameter digest after every beat that trained, and
launch the search kernels 16 + 2 times a move of every chunk they
played (`chunk_moves`) and no PER count; it prints per rank the learner
steps/s, the queue depth, the producer chunk p50 and the `dp.all_reduce`
share of the traced beats. The memory plane, after the async pair on
its thread: `cli warm` at the card's default plan (`bench_config.py`'s
flagship scale; exit 0, seconds per program, the build cache's hits and
misses), `cli fit` at that plan (exit 0; its budget beside the train
phase's `max_memory_allocated` and their ratio), `cli fit --limit-gb 1
--programs search` (exit 1); after the async pair, `cli mem` and `cli
roofline` (torch-free) on its run directory (rows for the self-play and
learner programs) and `cli roofline` on the serve-run phase's own run
(the search's `serve/b64` row), both at the H100 table's balance.

Slice seventeen, on two threads of their own beside the dp2 resume, the
mesh pair, the doctor, the readers and the reference phases (beside the
dp phases, the drills and the memory plane, a trial run of this script
saw the tuned run exit 1 and an async rank's last chunk outlast its 30 s
join, its launches short of its chunk moves): the tune phase runs `cli
tune --device cuda` at the flagship plan over a pinned space (B = 512
and 256, the plan's 16-move chunk and K = 16, capacities 10,000 and
100,000,000): exit 0, the limit the card's memory, 1 oracle call, the B
row `fit`, the B/2 row `dominated`, both rows of the large capacity
`ring-over` (its ring alone is over the card); the oracle's programs
launch `gather_rows`, `backup_update` and `per_sample` (the child's
counts) and each call leaves `memory_allocated` as it found it. Then
`cli train --preset` of the tuned preset, two megasteps, whose report's
`tune_outcome` holds the observed moves/s and the observed / predicted
ratio; then `cli tune --calibrate <that run>` under three quarters of
the first tune's budget at B: `tune_outcome x1` among the calibration's
sources, B `over`, B/2 `fit`, 2 oracle calls. It prints each oracle
call's seconds and budget. The play phase: `cli play --engine jax` on
the card prints the CPU's transcript line for line; `cli play --engine
native` plays its legal moves (the two engines draw their hands from
different streams, as in the JAX package, so their transcripts differ
from the first hand on); the native engine's refill-free transitions
equal the card engine's; `NeuralNetwork.evaluate_batch` of six
`GameState`s on the card at the flagship net equals `evaluate_state` of
each within the bf16 forward's tolerance (0.05 on the policy, 0.2 + 0.1
relative on the value).

Depth cut for slice sixteen (widths unchanged): supervise-torn to step 6
(was 8); the new phases run beside the drills and the dp phases, and
the mesh pair beside the resume, the doctor, the readers and the
reference phases (it ran after them). For
slice fifteen: the league to step 1 (was 2). Earlier, for the two
meshes: train-sync to step 10 (was 12),
train-async to step 10 (was 12; 16 before slice fourteen), both still
past their weight sync at step 10, and train-async's profiled and armed
windows 2 steps each (were 4). Earlier cuts: supervise-torn to step 8
(was 12), train-async's profiled window 4 steps (was 8), preempt-resume to step 10 (was 12), the league
to step 2 (was 4), the train and serve A/B and the beacons' 2 off / on
pairs (was 3), the profile run 2 megasteps (was 3), eval to 8 moves
(was 16), the preset-3 loops to 2 learner steps (were 4); the evals, the
profile run and the league's two runs call the command in this process
(they spawned one each).

Every run directory lives under one temporary directory, removed at the
end, and every train phase starts its run fresh. Every profile is read
from the profiler's raw events (`Trace`), held equal to torch's own
reader on the first profiled dispatch; each line is also written to
stderr beside the script's elapsed seconds.

Then one JSON line of kernel figures, the card line, `kernels: ...`, and
as the last line `{"ok": true, "device": {...}}`.
"""

import collections
import gc
import json
import os
import re
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# Every run directory of every phase lives under this one temporary root
# (made in `main`, removed at its end): no phase resumes another's run
# and nothing is written into the checkout.
RUN_ROOT: "Path | None" = None
SERVE_DISPATCHES = 8
TIMED_LAUNCHES = 100
# The train phase's cuts (depth only; every width is the default's).
TRAIN_CHUNK_MOVES = 2
TRAIN_MIN_BUFFER = 256
TRAIN_K = 2
TRAIN_MEGASTEPS = 4
# The dp phases (train-dp1, train-dp2-shared): the train default at full
# width, as one rank over NCCL and as two ranks sharing the card over
# gloo (each with 256 lanes, a batch of 128 and a 125,000-slot shard).
DP2_LANES, DP2_BATCH, DP2_SHARD = 256, 128, 125_000
# The promotion's shapes on both reuse paths: the default search's 64 +
# 65 node rows, its 65-row budget and its 8 BFS rounds (the depth).
PROMOTE_N, PROMOTE_BUDGET, PROMOTE_ROUNDS = 129, 65, 8
# Each path's kernel launches per dispatch (serve) or per searched move
# (train); per_sample launches once per megastep of either train path.
PER_STEP = {
    "serve": {"gather_rows": 16, "backup_update": 2, "subtree_promote": 0},
    "serve_reuse": {"gather_rows": 16, "backup_update": 2, "subtree_promote": 1},
    "train": {"gather_rows": 16, "backup_update": 2, "subtree_promote": 0},
    "train_reuse": {"gather_rows": 16, "backup_update": 2, "subtree_promote": 1},
}

# The backup's four planes, in its argument order.
PLANES = ("e_visits", "e_value", "children", "e_reward")

# Published HBM rates (NVIDIA data sheets), bytes/s, by card name.
_HBM_RATES = (
    ("H200", 4.8e12),
    ("H100 NVL", 3.9e12),
    ("H100 PCIe", 2.0e12),
    ("H100", 3.35e12),
)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


T_START = time.perf_counter()


def say(msg: str) -> None:
    """`msg` on stdout; on stderr, its start beside the script's elapsed time."""
    print(msg, flush=True)
    print(f"[{time.perf_counter() - T_START:7.1f} s] {msg[:100]}", file=sys.stderr, flush=True)


def hbm_rate(name: str) -> float:
    for key, rate in _HBM_RATES:
        if key in name:
            return rate
    fail(f"no published memory rate for card {name!r}")


def sleep_cycles_per_ms() -> float:
    """The rate of `torch.cuda._sleep`, which spins one thread for a
    number of clock cycles, timed with CUDA events."""
    import torch

    torch.cuda._sleep(1000)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    torch.cuda.synchronize()
    return 20_000_000 / start.elapsed_time(end)


def time_ms(fn, cycles_per_ms: float, iters: int = TIMED_LAUNCHES) -> float:
    """Median per-call device time over `iters` calls, between CUDA
    events around each call. A sleep kernel queued first keeps the card
    busy while the host enqueues the timed calls, so the events time the
    card's work rather than the host's launch rate: it lasts three times
    the host's measured enqueue time, since a call the card reaches
    before the host has enqueued all of it (per_sample's second grid)
    would be timed with the host's gap inside. A call of more launches
    than the card's queue holds (the plain backup) is timed at the
    host's rate all the same."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / 5
    torch.cuda.synchronize()
    pairs = [
        (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        for _ in range(iters)
    ]
    torch.cuda._sleep(int(cycles_per_ms * (3.0 * host_ms * iters + 1.0)))
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def search_kernels(torch, dev, rate: float, cycles: float, b: int) -> dict:
    """The search's two kernels at B = `b` lanes (N=65, A=360, W=32,
    D=8): bit-equality with the plain versions, then their times."""
    import importlib

    # The package re-exports the dispatchers under the modules' names.
    g = importlib.import_module("alphatriangle_tpu_torch.ops.gather_rows")
    mb = importlib.import_module("alphatriangle_tpu_torch.ops.mcts_backup")

    n, a, w, d = 65, 360, 32, 8
    k = 6 * a
    gen = torch.Generator(device=dev).manual_seed(0)
    report = {}

    # --- gather_rows ---
    stats = torch.rand((b, n, k), generator=gen, device=dev)
    idx = torch.randint(0, n, (b, w), generator=gen, device=dev)
    out_k = g.gather_rows_cuda(stats, idx)
    out_p = g.gather_rows_plain(stats, idx)
    torch.cuda.synchronize()
    if not torch.equal(out_k, out_p):
        fail(f"gather_rows kernel differs from its plain version at B={b}")
    rows = torch.unique(torch.arange(b, device=dev)[:, None] * n + idx).numel()
    gather_bytes = rows * k * 4 + b * w * k * 4 + b * w * 8
    lib_idx = idx[..., None].expand(b, w, k)
    report["gather_rows"] = {
        "name": "gather_rows",
        "route": "cuda",
        "source": "alphatriangle_tpu_torch/csrc/gather_rows.cu",
        "replaces": "alphatriangle_tpu/ops/gather_rows.py:49",
        "max_abs_err": float((out_k - out_p).abs().max()),
        "ms": time_ms(lambda: g.gather_rows_cuda(stats, idx), cycles),
        "plain_ms": time_ms(lambda: g.gather_rows_plain(stats, idx), cycles),
        "bound_ms": gather_bytes / rate * 1e3,
        "bound_by": "bytes",
        "library_ms": time_ms(lambda: torch.gather(stats, 1, lib_idx), cycles),
        "bytes": gather_bytes,
    }

    # --- backup_update: duplicate edges and inactive entries ---
    def planes():
        g2 = torch.Generator(device=dev).manual_seed(1)
        children = torch.full((b, n, a), -1.0, device=dev)
        children[:, 0, :8] = torch.randint(1, n, (b, 8), generator=g2, device=dev).float()
        return [
            torch.randint(0, 5, (b, n, a), generator=g2, device=dev).float(),
            torch.randn((b, n, a), generator=g2, device=dev),
            children,
            torch.randn((b, n, a), generator=g2, device=dev),
        ]

    parents = torch.randint(0, 4, (b, w), generator=gen, device=dev)
    actions = torch.randint(0, 6, (b, w), generator=gen, device=dev)
    parents[:, 1::4], actions[:, 1::4] = parents[:, 0::4], actions[:, 0::4]  # forced duplicates
    new_child = torch.where(
        torch.rand((b, w), generator=gen, device=dev) < 0.5,
        torch.randint(1, n, (b, w), generator=gen, device=dev).float(),
        torch.tensor(-1.0, device=dev),
    )
    rewards = torch.randn((b, w), generator=gen, device=dev)
    rec_active = torch.rand((b, w, d), generator=gen, device=dev) < 0.7
    rec_node = torch.where(
        rec_active, torch.randint(0, 4, (b, w, d), generator=gen, device=dev), -1
    )
    rec_action = torch.where(
        rec_active, torch.randint(0, 6, (b, w, d), generator=gen, device=dev), -1
    )
    returns = torch.randn((b, w, d), generator=gen, device=dev)
    if not bool((~rec_active).any()):
        fail("backup inputs hold no inactive entry")
    rest = (parents, actions, new_child, rewards, rec_node, rec_action, rec_active, returns)
    got = mb.backup_update_cuda(*planes(), *rest)
    want = mb.backup_update_plain(*planes(), *rest)
    torch.cuda.synchronize()
    for name, x, y in zip(("e_visits", "e_value", "children", "e_reward"), got, want):
        if not torch.equal(x, y):
            fail(f"backup_update kernel differs from its plain version on {name} at B={b}")
    err = max(float((x - y).abs().max()) for x, y in zip(got, want))

    bcol = torch.arange(b, device=dev)[:, None]
    ins_flat = (bcol * n * a + parents * a + actions).reshape(-1)
    bk_flat = (bcol[..., None] * n * a + rec_node.clamp(min=0) * a + rec_action.clamp(min=0))
    bk_flat = bk_flat.reshape(-1)
    backup_bytes = (
        torch.unique(ins_flat).numel() * 12  # children read+write, reward write
        + torch.unique(bk_flat).numel() * 16  # visits and value read+write
        + b * w * (8 + 8 + 4 + 4)
        + b * w * d * (8 + 8 + 1 + 4)
    )
    cnt = rec_active.float().reshape(-1)
    val = torch.where(rec_active, returns, 0.0).reshape(-1)
    lib_planes = planes()

    def library_chain():
        ev, eq, ch, er = lib_planes
        ch.view(-1).scatter_reduce_(0, ins_flat, new_child.reshape(-1), "amax")
        er.view(-1).index_put_((ins_flat,), rewards.reshape(-1))
        ev.view(-1).index_put_((bk_flat,), cnt, accumulate=True)
        eq.view(-1).index_put_((bk_flat,), val, accumulate=True)

    kp, pp = planes(), planes()
    report["backup_update"] = {
        "name": "backup_update",
        "route": "cuda",
        "source": "alphatriangle_tpu_torch/csrc/mcts_backup.cu",
        "replaces": "alphatriangle_tpu/ops/mcts_backup.py:80",
        "max_abs_err": err,
        "ms": time_ms(lambda: mb.backup_update_cuda(*kp, *rest), cycles),
        "plain_ms": time_ms(lambda: mb.backup_update_plain(*pp, *rest), cycles, iters=20),
        "bound_ms": backup_bytes / rate * 1e3,
        "bound_by": "bytes",
        "library_ms": time_ms(library_chain, cycles),
        "bytes": backup_bytes,
    }
    return report


def promote_operands(torch, dev, b: int, seed: int):
    """The promotion's inputs as a search leaves them: six edge planes
    around random forests (child ids increasing away from the root, one
    parent edge per node, the node count differing by lane), the played
    actions, and terminal flags. Every fourth lane plays an unexpanded
    root action (an invalid promotion); in even lanes every node descends
    from the played child, so their subtrees outgrow the budget."""
    n, a = PROMOTE_N, 360
    gen = torch.Generator(device=dev).manual_seed(seed)
    lanes = torch.arange(b, device=dev)
    children = torch.full((b, n, a), -1.0, device=dev)
    children[:, 0, 0] = 1.0
    count = torch.randint(n // 2, n + 1, (b,), generator=gen, device=dev)
    count[0::2] = n
    lo = (lanes % 2 == 0).long()
    for j in range(2, n):
        parent = lo + (torch.rand(b, generator=gen, device=dev) * (j - lo)).long()
        act = torch.randint(0, a, (b,), generator=gen, device=dev)
        put = (children[lanes, parent, act] < 0) & (j < count)
        children[lanes[put], parent[put], act[put]] = float(j)
    actions = torch.zeros(b, dtype=torch.int64, device=dev)
    actions[1::4] = a - 1
    children[1::4, 0, a - 1] = -1.0
    planes = [
        torch.randint(0, 9, (b, n, a), generator=gen, device=dev).float(),
        torch.randn((b, n, a), generator=gen, device=dev),
        torch.randn((b, n, a), generator=gen, device=dev),
        children,
        torch.rand((b, n, a), generator=gen, device=dev),
        (torch.rand((b, n, a), generator=gen, device=dev) < 0.7).float(),
    ]
    terminal = torch.rand((b, n), generator=gen, device=dev) < 0.2
    return planes, actions, terminal


def promote_kernel(torch, dev, rate: float, cycles: float, b: int) -> dict:
    """The promotion's row reorder at B = `b` lanes: bit-equality of the
    kernel with the plain version on all six planes, then their times,
    the library yardstick's and the plan's."""
    import importlib

    sr = importlib.import_module("alphatriangle_tpu_torch.ops.subtree_reuse")
    planes, actions, _ = promote_operands(torch, dev, b, seed=b)
    order, _, keep, new_children, valid, retained = sr.promotion_plan(
        planes[3], actions, PROMOTE_BUDGET, PROMOTE_ROUNDS
    )
    if bool(valid[1::4].any()) or not bool(valid[0::4].all()):
        fail(f"subtree_promote operands: the invalid lanes are not the planned ones at B={b}")
    if not bool((retained[0::2] == PROMOTE_BUDGET).all()):
        fail(f"subtree_promote operands: no lane was cut at the budget at B={b}")
    ins = (*planes[:3], new_children, *planes[4:])
    got = sr.reorder_planes_cuda(order, retained, ins)
    want = sr.reorder_planes_plain(order, keep, ins)
    torch.cuda.synchronize()
    for q, (x, y) in enumerate(zip(got, want)):
        if not torch.equal(x, y):
            fail(f"subtree_promote kernel differs from its plain version on plane {q} at B={b}")
    n, a = PROMOTE_N, planes[0].shape[-1]
    # Kept rows of six planes read once, every row of six planes written
    # once, the order and the row counts read.
    kept = int(retained.sum())
    promote_bytes = kept * 6 * a * 4 + b * n * 6 * a * 4 + b * n * 8 + b * 4
    stacked = torch.stack(ins)  # (6, B, N, A): the library call's operand
    idx6 = torch.where(keep, order, 0)[None, :, :, None].expand(6, b, n, a)
    keep6 = keep[None, :, :, None]
    fill6 = torch.tensor(sr.FILLS, device=dev)[:, None, None, None]
    library = torch.where(keep6, torch.gather(stacked, 2, idx6), fill6)
    if not torch.equal(library, torch.stack(want)):
        fail(f"the library yardstick for subtree_promote is not the same function at B={b}")
    return {
        "name": "subtree_promote",
        "route": "cuda",
        "source": "alphatriangle_tpu_torch/csrc/subtree_promote.cu",
        "replaces": "alphatriangle_tpu/ops/subtree_reuse.py:144",
        "max_abs_err": max(float((x - y).abs().max()) for x, y in zip(got, want)),
        "ms": time_ms(lambda: sr.reorder_planes_cuda(order, retained, ins), cycles),
        "plain_ms": time_ms(lambda: sr.reorder_planes_plain(order, keep, ins), cycles),
        "bound_ms": promote_bytes / rate * 1e3,
        "bound_by": "bytes",
        "library_ms": time_ms(
            lambda: torch.where(keep6, torch.gather(stacked, 2, idx6), fill6), cycles
        ),
        "bytes": promote_bytes,
        "retained_rows": kept,
        "plan_ms": time_ms(
            lambda: sr.promotion_plan(planes[3], actions, PROMOTE_BUDGET, PROMOTE_ROUNDS),
            cycles, iters=20,
        ),
    }


def tiles_counted(torch, cum, u) -> int:
    """Summed over the draws, the tiles of `cum` that the count kernel
    cannot settle from their minimum and maximum (NaN left out)."""
    from alphatriangle_tpu_torch.ops.per_sample import TILE

    nan = torch.isnan(cum)
    pad = (-cum.numel()) % TILE
    inf = float("inf")
    lo = torch.cat([torch.where(nan, inf, cum), cum.new_full((pad,), inf)])
    hi = torch.cat([torch.where(nan, -inf, cum), cum.new_full((pad,), -inf)])
    lo, hi = lo.view(-1, TILE).amin(dim=1), hi.view(-1, TILE).amax(dim=1)
    v = u.reshape(-1, 1)
    return int((~(hi < v) & (lo < v)).sum())


def count_worst_case(torch, dev, ps, cycles: float) -> dict:
    """The count at the flagship sizes on an unsorted `cum`: every tile
    straddles every draw, so the kernel counts every element."""
    gen = torch.Generator(device=dev).manual_seed(3)
    cum = torch.randn(250_000, generator=gen, device=dev)
    u = torch.randn((TRAIN_K, 256), generator=gen, device=dev)
    got, want = ps.count_below_cuda(cum, u), ps.count_below_plain(cum, u)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail("per_sample kernel differs from its plain version on an unsorted cum")
    return {
        "input": "unsorted cum (normal), n = 250,000, K = 2, B = 256",
        "ms": time_ms(lambda: ps.count_below_cuda(cum, u), cycles),
        "tiles_counted_per_draw": tiles_counted(torch, cum, u) / u.numel(),
    }


def bits_equal(torch, x, y) -> bool:
    """Bit for bit: torch.equal, and -0.0 apart from +0.0."""
    return torch.equal(x, y) and torch.equal(torch.signbit(x), torch.signbit(y))


def kernel_families(torch, dev, cycles: float) -> dict:
    """The redesigned kernels on every adversarial family of
    `ops/kernel_cases.py` (the backup at 64 and 512 lanes): bit-equal to
    the plain versions. Then the backup's worst case, every entry on one
    element, timed at both widths."""
    import importlib

    cases = importlib.import_module("alphatriangle_tpu_torch.ops.kernel_cases")
    ps = importlib.import_module("alphatriangle_tpu_torch.ops.per_sample")
    mb = importlib.import_module("alphatriangle_tpu_torch.ops.mcts_backup")
    on = lambda arrays: [torch.from_numpy(x).to(dev) for x in arrays]  # noqa: E731
    for name in cases.COUNT_CASES:
        cum, u = on(cases.count_case(name, seed=1))
        got, want = ps.count_below_cuda(cum, u), ps.count_below_plain(cum, u)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"per_sample kernel differs from its plain version on family {name}")
    worst = {}
    for b in (64, 512):
        for name in cases.BACKUP_CASES:
            planes, updates = cases.backup_case(name, b=b, n=65, a=360, seed=b)
            planes, updates = on(planes), on(updates)
            want = mb.backup_update_plain(*[p.clone() for p in planes], *updates)
            got = mb.backup_update_cuda(*[p.clone() for p in planes], *updates)
            torch.cuda.synchronize()
            for plane, x, y in zip(PLANES, got, want):
                if not bits_equal(torch, x, y):
                    fail(f"backup_update kernel differs from its plain version on {plane}, "
                         f"family {name}, B={b}")
            if name == "one_element":
                worst[b] = time_ms(lambda: mb.backup_update_cuda(*planes, *updates), cycles)
    # The backup against the number of games (one block each; 132 SMs).
    by_lanes = {}
    for b in (64, 132, 264, 396, 512, 1024):
        inputs = cases.backup_case("random", b, n=65, a=360, seed=b)
        planes, updates = (on(x) for x in inputs)
        by_lanes[b] = time_ms(lambda: mb.backup_update_cuda(*planes, *updates), cycles)
    return {
        "count_families": list(cases.COUNT_CASES),
        "backup_families": list(cases.BACKUP_CASES),
        "backup_worst_case": {
            "input": "every entry and insertion on one element, W = 32, D = 8",
            "ms": worst[64],
            "ms_at_512_lanes": worst[512],
        },
        "backup_ms_by_lanes": by_lanes,
        # One launch of a kernel that does nothing, timed the same way.
        "empty_kernel_ms": time_ms(lambda: torch.cuda._sleep(0), cycles),
    }


def record_backups(calls: list, waves: int):
    """Wrap the search's `backup_update` so that its next `waves` calls
    are recorded (operands copied to the host before the in-place update,
    so the path's device memory is not changed); returns the function
    that restores it."""
    from alphatriangle_tpu_torch.mcts import search as search_mod

    real = search_mod.backup_update

    def recorded(*args, **kwargs):
        if len(calls) < waves:
            calls.append([x.cpu() for x in args])
        return real(*args, **kwargs)

    search_mod.backup_update = recorded
    return lambda: setattr(search_mod, "backup_update", real)


def real_wave_phase(torch, cycles: float, recorded: dict) -> dict:
    """The backup kernel on the operands of real waves (one serve
    dispatch, one train move): bit-equal to the plain version, and its
    time on them."""
    import importlib

    mb = importlib.import_module("alphatriangle_tpu_torch.ops.mcts_backup")
    report = {}
    for path, calls in recorded.items():
        if not calls:
            fail(f"no backup operands were recorded on the {path} path")
        calls = [[x.to("cuda") for x in args] for args in calls]
        for args in calls:
            got = mb.backup_update_cuda(*[x.clone() for x in args])
            want = mb.backup_update_plain(*[x.clone() for x in args])
            torch.cuda.synchronize()
            for x, y in zip(got, want):
                if not bits_equal(torch, x, y):
                    fail(f"backup_update kernel differs from plain on a {path} wave")
        args = [x.clone() for x in calls[0]]
        report[path] = {
            "waves": len(calls),
            "lanes": int(args[0].shape[0]),
            "inactive_share": float((~torch.stack([c[10] for c in calls])).float().mean()),
            "ms": time_ms(lambda: mb.backup_update_cuda(*args), cycles),
        }
    return report


def per_sample_operands(torch, dev, gen, ps, cap: int, bq: int) -> tuple:
    """The PER count's operands at a ring of `cap` slots and K x `bq`
    draws (a zero-priority run, a ring not yet full, a zero trash slot,
    draws on segment edges), its kernel's and plain version's counts,
    held equal: (cum, u, kernel, plain)."""
    at = lambda frac: int(cap * frac)  # noqa: E731 (the flagship's fractions of the ring)
    prio = torch.rand(cap + 1, generator=gen, device=dev) * 2.0
    prio[at(0.16):at(0.26)] = 0.0  # empty slots: a zero-priority run
    prio[at(0.8) + 1:] = 0.0  # a ring not yet full; the trash slot at `cap` is 0
    cum = torch.cumsum(prio[:cap], dim=0)
    u = ps.stratum_draws(cum, TRAIN_K, bq, torch.tensor([0, 11], dtype=torch.int64))
    edges = torch.tensor([0, at(0.16) - 1, at(0.16), at(0.26)], device=dev)
    u[0, :4] = cum[edges]  # on segment edges
    u[-1, -1] = cum[-1]
    got = ps.count_below_cuda(cum, u)
    want = ps.count_below_plain(cum, u)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"per_sample kernel differs from its plain version at cap {cap}, B={bq}")
    return cum, u, got, want


def rank_shapes(torch, dev, rate: float, cycles: float) -> dict:
    """The kernels at the shapes a rank of the two-rank dp megastep gives
    them (train-dp2-shared): the search's at 256 lanes, the PER count
    over a 125,000-slot shard with K x 128 draws. Bit-equal to their
    plain versions; the kernels' times and bounds."""
    import importlib

    ps = importlib.import_module("alphatriangle_tpu_torch.ops.per_sample")
    out = {
        name: {key: e[key] for key in ("ms", "plain_ms", "bound_ms", "library_ms", "bytes")}
        for name, e in search_kernels(torch, dev, rate, cycles, b=DP2_LANES).items()
    }
    cap, bq = DP2_SHARD, DP2_BATCH
    cum, u, _, _ = per_sample_operands(torch, dev, torch.Generator(device=dev).manual_seed(3), ps, cap, bq)
    ps_bytes = cap * 4 + 2 * TRAIN_K * bq * 4
    out["per_sample"] = {
        "ms": time_ms(lambda: ps.count_below_cuda(cum, u), cycles),
        "plain_ms": time_ms(lambda: ps.count_below_plain(cum, u), cycles, iters=20),
        "bound_ms": ps_bytes / rate * 1e3,
        "library_ms": time_ms(lambda: torch.searchsorted(cum, u), cycles),
        "bytes": ps_bytes,
    }
    return out


def kernel_phase(torch, dev, rate: float) -> dict:
    """Every kernel at the shapes of the paths that run it: the search's
    at the serving path's 64 lanes (the figures of the kernels line) and
    at the training path's 512 lanes, the PER count at the megastep's."""
    import importlib

    cycles = sleep_cycles_per_ms()
    report = search_kernels(torch, dev, rate, cycles, b=64)
    for name, entry in search_kernels(torch, dev, rate, cycles, b=512).items():
        report[name]["at_512_lanes"] = {
            key: entry[key] for key in ("ms", "plain_ms", "bound_ms", "library_ms", "bytes")
        }
    gen = torch.Generator(device=dev).manual_seed(2)

    # --- per_sample: the megastep's PER count at the flagship ---
    ps = importlib.import_module("alphatriangle_tpu_torch.ops.per_sample")
    cap, kq, bq = 250_000, TRAIN_K, 256
    cum, u, got, want = per_sample_operands(torch, dev, gen, ps, cap, bq)
    # The function needs the cumsum read once, the draws read and the counts
    # written: bytes bound it. The kernel's brute-force compares (one per
    # draw and element) are work of its algorithm, not of the function.
    ps_bytes = cap * 4 + 2 * kq * bq * 4
    report["per_sample"] = {
        "name": "per_sample",
        "route": "cuda",
        "source": "alphatriangle_tpu_torch/csrc/per_sample.cu",
        "replaces": "alphatriangle_tpu/ops/per_sample.py:52",
        "max_abs_err": float((got - want).abs().max()),
        "ms": time_ms(lambda: ps.count_below_cuda(cum, u), cycles),
        "plain_ms": time_ms(lambda: ps.count_below_plain(cum, u), cycles, iters=20),
        "bound_ms": ps_bytes / rate * 1e3,
        "bound_by": "bytes",
        "library_ms": time_ms(lambda: torch.searchsorted(cum, u), cycles),
        "bytes": ps_bytes,
        # The kernel's data-dependent work: tiles it counts element by
        # element, per draw (the rest it settles from their summaries).
        "tiles_counted_per_draw": tiles_counted(torch, cum, u) / u.numel(),
        "worst_case": count_worst_case(torch, dev, ps, cycles),
        # A binary search equals the count only on a nondecreasing cumsum,
        # which the card's parallel scan does not promise: recorded, not held.
        "cumsum_descents": int((cum[1:] < cum[:-1]).sum()),
        "searchsorted_disagrees": int((torch.searchsorted(cum, u).int() != want).sum()),
    }

    # --- the per-rank shapes of the two-rank dp megastep ---
    for name, entry in rank_shapes(torch, dev, rate, cycles).items():
        report[name]["at_dp2_rank"] = entry

    # --- the redesigned kernels on their adversarial families ---
    families = kernel_families(torch, dev, cycles)
    report["backup_update"]["worst_case"] = families["backup_worst_case"]
    report["backup_update"]["ms_by_lanes"] = families["backup_ms_by_lanes"]
    report["empty_kernel_ms"] = families["empty_kernel_ms"]
    report["families"] = families

    # --- subtree_promote: the promotion on both reuse paths ---
    report["subtree_promote"] = promote_kernel(torch, dev, rate, cycles, b=64)
    at = promote_kernel(torch, dev, rate, cycles, b=512)
    report["subtree_promote"]["at_512_lanes"] = {
        key: at[key] for key in ("ms", "plain_ms", "bound_ms", "library_ms", "bytes", "plan_ms")
    }

    # torch.argmax must return the first maximum on the card, as on the
    # CPU and in jnp.argmax: the descent and the action rule rely on it.
    ties = torch.randint(0, 3, (256, 360), generator=gen, device=dev).float()
    if not torch.equal(ties.argmax(dim=-1).cpu(), ties.cpu().argmax(dim=-1)):
        fail("torch.argmax on the card does not return the first maximum")
    return report


def serve_phase(
    torch, dev, kernels, reuse: bool = False, record: list | None = None, gumbel: bool = False
):
    """The full-width serve default, with or without subtree reuse, or
    with `gumbel` as `cli serve --gumbel` runs it (a Gumbel root search
    in exploit mode, its selected actions served), through
    `run_simulated_load` with counted launches; then one more dispatch
    under the profiler. With `record`, the first dispatch's backup
    operands are appended to it (copied to the host, so that dispatch's
    time includes the copies)."""
    from alphatriangle_tpu_torch.config import AlphaTriangleMCTSConfig, EnvConfig, ModelConfig
    from alphatriangle_tpu_torch.env import TriangleEnv
    from alphatriangle_tpu_torch.features import FeatureExtractor
    from alphatriangle_tpu_torch.mcts import BatchedMCTS, GumbelMCTS
    from alphatriangle_tpu_torch.nn import NeuralNetwork
    from alphatriangle_tpu_torch.serving import PolicyService, run_simulated_load

    slots, sims = 64, 64
    serve_default_stats()
    env_cfg, model_cfg = EnvConfig(), ModelConfig()
    mcts_cfg = AlphaTriangleMCTSConfig(
        max_simulations=sims, tree_reuse=reuse, root_selection="gumbel" if gumbel else "puct"
    )
    env = TriangleEnv(env_cfg, device=dev)
    extractor = FeatureExtractor(env, model_cfg)
    net = NeuralNetwork(model_cfg, env_cfg, seed=0, device=dev)
    if gumbel:
        mcts = GumbelMCTS(env, extractor, net.model, mcts_cfg, net.support, exploit=True)
    else:
        mcts = BatchedMCTS(env, extractor, net.model, mcts_cfg, net.support)
    if (mcts.wave_size, mcts.num_waves, mcts_cfg.max_depth) != (32, 2, 8):
        fail(f"unexpected search shape W={mcts.wave_size} waves={mcts.num_waves}")
    if mcts.num_nodes != (PROMOTE_N if reuse else sims + 1):
        fail(f"unexpected node budget N={mcts.num_nodes}")
    service = PolicyService(env, extractor, net, mcts, slots=slots, rng_seed=0)
    checked = {"dispatches": 0, "answered": 0}
    torch.cuda.reset_peak_memory_stats()
    real_dispatch = service.dispatch

    def dispatch_checked(*args, **kwargs):
        pending = set(service._queue)
        states = service.sessions.states
        valid = env.valid_action_mask(states).cpu()
        done = states.done.cpu()
        results = real_dispatch(*args, **kwargs)
        if {r["sid"] for r in results} != pending or len(results) != len(pending):
            fail("a dispatch left a request unanswered")
        for r in results:
            if done[r["slot"]] or not valid[r["slot"], r["action"]]:
                fail(f"served action {r['action']} is not valid for lane {r['slot']}")
        out = service.last_output
        live = ~done.to(dev)
        if gumbel:
            picked = out.selected_action.clamp(min=0).cpu()
            if any(r["action"] != int(picked[r["slot"]]) for r in results):
                fail("a served action is not the Gumbel search's selection")
        for name in ("visit_counts", "root_value", "root_prior"):
            if not bool(torch.isfinite(getattr(out, name)).all()):
                fail(f"search output {name} is not finite")
        # Every simulation passes the root once; reuse adds the inherited visits.
        inherited = service.last_reused if reuse else torch.zeros_like(out.root_value)
        if not bool((out.visit_counts.sum(dim=-1)[live] == sims + inherited[live]).all()):
            fail("a live lane's root visits are not the simulation budget plus the inherited ones")
        if not all(map(lambda r: abs(r["score"]) < 1e9 and abs(r["reward"]) < 1e9, results)):
            fail("non-finite served reward or score")
        checked["dispatches"] += 1
        checked["answered"] += len(results)
        return results

    service.dispatch = dispatch_checked
    waves = PER_STEP["serve"]["backup_update"]
    restore = record_backups(record, waves) if record is not None else None
    for kern in kernels.values():
        kern.launches = 0
    stats = run_simulated_load(
        service,
        total_sessions=96,
        concurrency=slots,
        max_moves=200,
        seed=0,
        max_dispatches=SERVE_DISPATCHES,
    )
    torch.cuda.synchronize()
    launches = {name: kern.launches for name, kern in kernels.items()}
    if restore is not None:
        restore()
    n_disp = stats["dispatches"]
    if n_disp != SERVE_DISPATCHES or checked["dispatches"] != n_disp:
        fail(f"expected {SERVE_DISPATCHES} dispatches, ran {n_disp}")
    if checked["answered"] != stats["moves_served"] or stats["moves_served"] == 0:
        fail("served move count disagrees with the answered requests")
    for name, want in PER_STEP["serve_reuse" if reuse else "serve"].items():
        if launches[name] != want * n_disp:
            fail(f"{name}: {launches[name]} launches in {n_disp} dispatches, want {want} each")
    reused = service.reused_visits_total
    if reuse and reused <= 0:
        fail("the serve-reuse phase inherited no root visits")
    batch_s = sum(service.batch_ms) / 1e3
    report = {
        "launches": launches,
        "dispatches": n_disp,
        "moves_served": stats["moves_served"],
        "dispatch_ms_p50": statistics.median(service.batch_ms),
        "dispatch_ms_first": service.batch_ms[0],
        "moves_per_s": stats["moves_served"] / batch_s,
        "leaf_evals_per_s": slots * sims * n_disp / batch_s,
        # Inherited root visits count as evaluations the search was spared.
        "leaf_evals_per_s_with_reused": (slots * sims * n_disp + reused) / batch_s,
        "reused_visits": reused,
        "reused_share": reused / (reused + service.simulations_total),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
    }
    report["profile"] = profile_dispatch(torch, service, report["dispatch_ms_p50"])
    return report


STAGES = (
    "search.init_tree", "search.descend", "search.expand", "search.evaluate",
    "search.backup", "search.promote", "search.stats", "serve.step", "serve.fetch",
)


# The first profiled dispatch's check of `Trace` against torch's reader.
TRACE_READER: dict = {}


def profile_dispatch(torch, service, dispatch_ms: float) -> dict:
    """One more full dispatch under `torch.profiler`, after the counted
    run: the device time of its kernels and copies, the kernels that
    took the most, and each labelled stage's host and device time. The
    busy share divides the device time by the unprofiled dispatch time
    (the profiler slows the host, not the kernels)."""
    from torch.profiler import ProfilerActivity, profile

    from alphatriangle_tpu_torch import rng

    keys = torch.arange(service.sessions.free_count)
    for s in service.open_sessions(rng.fold_in(rng.PRNGKey(7), keys)):
        service.request_move(s.sid)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        results = service.dispatch()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if len(results) != service.sessions.slots:
        fail("the profiled dispatch did not serve every slot")
    if not TRACE_READER:
        TRACE_READER.update(check_trace_reader(prof, STAGES))
    return read_profile(prof, STAGES, wall_ms, dispatch_ms)


class Trace:
    """A finished `torch.profiler` session's events, read straight from
    the profiler's result. torch's own reader (`prof.events()`,
    `key_averages()`) builds a Python object for every event and a tree
    of them, seconds for a megastep's ~100,000 events, once for every
    profile this script reads; this keeps a tuple an event and gives the
    same figures by the same rules (held equal to torch's reader on the
    serve dispatch's profile, `check_trace_reader`):

    - a device event's time is its span, nothing for an asynchronous one;
    - an op's kernels are the device events linked to it (the profiler's
      linked correlation id), an op's device time its kernels' and those
      of the ops nested in it on its thread (a stage's device time);
    - events grouped as `key_averages` groups them (name, device type,
      user annotation)."""

    def __init__(self, prof):
        from torch.autograd import DeviceType
        from torch.autograd.profiler_util import _filter_name

        cuda, result = DeviceType.CUDA, prof.profiler.kineto_results
        # Device times in us from the trace's start, as torch's reader keeps
        # them (the absolute ns in a float would lose the low digits).
        base = result.trace_start_ns()
        self.cpu = collections.defaultdict(list)  # thread -> [(start ns, end ns, id, is_async, name)]
        self.device = []  # (name, start us, end us, is_async, is_user_annotation)
        self.names = collections.Counter()
        self.kernel_us = collections.defaultdict(float)  # op id -> its linked kernels' device us
        for e in result.events():
            name = e.name()
            if name.startswith("ProfilerStep#"):
                name = "ProfilerStep*"  # as torch's reader names it
            if _filter_name(name) or getattr(e, "is_hidden_event", lambda: False)():
                continue
            self.names[name] += 1
            start, end = e.start_ns(), e.end_ns()
            is_async = e.is_async() or e.start_thread_id() != e.end_thread_id()
            kind, linked = e.device_type(), e.linked_correlation_id()
            if kind == cuda:
                ua = getattr(e, "is_user_annotation", lambda: False)()
                start_us, end_us = (start - base) / 1000, (end - base) / 1000
                self.device.append((name, start_us, end_us, is_async, ua))
                if linked > 0:
                    self.kernel_us[linked] += end_us - start_us
            elif kind == DeviceType.CPU and linked == 0:
                self.cpu[e.start_thread_id()].append((start, end, e.correlation_id(), is_async, name))
        for ops in self.cpu.values():
            ops.sort(key=lambda op: (op[0], -op[1]))

    def device_rows(self, labels) -> list:
        """(name, device ms, count) of each group of device events not
        named in `labels` with device time, the most first."""
        groups: dict = {}
        for name, start, end, is_async, ua in self.device:
            g = groups.setdefault((name, ua), [0.0, 0])
            g[0] += 0.0 if is_async else end - start
            g[1] += 1
        rows = [(name, us / 1e3, n) for (name, _), (us, n) in groups.items() if name not in labels and us > 0]
        return sorted(rows, key=lambda r: -r[1])

    def stages(self, stage_names) -> dict:
        """Each named op's host time, device time (its kernels and those
        of the ops nested in it) and calls."""
        import bisect

        out = {name: {"host_ms": 0.0, "device_ms": 0.0, "calls": 0} for name in stage_names}
        for ops in self.cpu.values():
            starts = [op[0] for op in ops]
            for start, end, _, is_async, name in ops:
                if name not in out:
                    continue
                st = out[name]
                st["host_ms"] += (end - start) / 1e6
                st["calls"] += 1
                if is_async:
                    continue
                lo, hi = bisect.bisect_left(starts, start), bisect.bisect_left(starts, end)
                st["device_ms"] += sum(
                    self.kernel_us.get(op[2], 0.0) for op in ops[lo:hi]
                    if op[1] <= end and not op[3]
                ) / 1e3
        return out

    def device_spans(self, labels) -> list:
        """(start, end) in us of every device event not named in `labels`."""
        return [(s, e) for name, s, e, _, _ in self.device if name not in labels and e > s]


def trace_of(prof) -> Trace:
    """The profile's `Trace`, read once."""
    if not hasattr(prof, "_smoke_trace"):
        prof._smoke_trace = Trace(prof)
    return prof._smoke_trace


def check_trace_reader(prof, stage_names) -> dict:
    """torch's reader and `Trace` on one profile must give the same
    device rows, stages, spans and event counts; their times."""
    from torch.autograd import DeviceType

    labels = set(STAGES) | set(TRAIN_STAGES)
    t0 = time.perf_counter()
    trace = Trace(prof)
    fast_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    events, averages = prof.events(), prof.key_averages()
    torch_s = time.perf_counter() - t0
    rows = sorted(
        (e.key, e.self_device_time_total / 1e3, e.count) for e in averages
        if e.device_type == DeviceType.CUDA and e.key not in labels and e.self_device_time_total > 0
    )
    stages = {name: {"host_ms": 0.0, "device_ms": 0.0, "calls": 0} for name in stage_names}
    for e in events:
        if e.name in stages and e.device_type == DeviceType.CPU:
            stages[e.name]["host_ms"] += e.cpu_time_total / 1e3
            stages[e.name]["device_ms"] += e.device_time_total / 1e3
            stages[e.name]["calls"] += 1
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in events
        if e.device_type == DeviceType.CUDA and e.name not in labels and e.time_range.end > e.time_range.start
    )
    # The runtime calls' counts are the ones this script reads (torch's
    # reader also folds an op into a same-named parent, `aten::bitwise_and`
    # calling itself: not a runtime call).
    runtime = lambda name: name.startswith("cu")  # noqa: E731
    counts = collections.Counter(e.name for e in events if runtime(e.name))
    names = collections.Counter({k: n for k, n in trace.names.items() if runtime(k)})

    def close(a: float, b: float) -> bool:
        return abs(a - b) <= 1e-6 * max(1.0, abs(a), abs(b))

    mine = sorted(trace.device_rows(labels))
    got = trace.stages(stage_names)
    my_spans = sorted(trace.device_spans(labels))
    if ([(k, n) for k, _, n in mine] != [(k, n) for k, _, n in rows]
            or not all(close(a[1], b[1]) for a, b in zip(mine, rows))
            or any(got[s]["calls"] != stages[s]["calls"] or not close(got[s]["host_ms"], stages[s]["host_ms"])
                   or not close(got[s]["device_ms"], stages[s]["device_ms"]) for s in stage_names)
            or len(my_spans) != len(spans)
            or not close(sum(b - a for a, b in my_spans), sum(b - a for a, b in spans))
            or names != counts):
        fail(f"the profile reader differs from torch's: rows {mine[:3]} / {rows[:3]}, stages {got} / {stages}, "
             f"{len(my_spans)} / {len(spans)} spans, runtime calls {names - counts} / {counts - names}")
    return {"events": len(events), "runtime_calls": sum(counts.values()), "torch_s": torch_s, "fast_s": fast_s}


def read_profile(prof, stage_names, wall_ms: float, ref_ms: float) -> dict:
    """A profile's device time of kernels and copies, the kernels that
    took the most, each labelled stage's host and device time, and the
    ported kernels' time. The busy share divides the device time by the
    unprofiled time `ref_ms` of the same work (the profiler slows the
    host, not the kernels)."""
    # Every `record_function` label also shows as a device range; only
    # kernels and copies count as device time.
    trace = trace_of(prof)
    rows = trace.device_rows(set(STAGES) | set(TRAIN_STAGES))
    stages = trace.stages(stage_names)
    device_ms = sum(r[1] for r in rows)
    # The ported kernels launch through ctypes, outside any torch op, so
    # the stage labels do not see them; read them by kernel name (one op
    # may run several grids: per_sample's summary and count kernels).
    ported = {
        kname: {
            "ms": sum(ms for k, ms, _ in rows if re.search(rf"\b{kname}\w*_kernel\b", k)),
            "count": sum(c for k, _, c in rows if re.search(rf"\b{kname}\w*_kernel\b", k)),
        }
        for kname in ("gather_rows", "backup_update", "per_sample", "subtree_promote")
    }
    # A profiler that recorded no device activity measured nothing.
    return {
        "wall_ms": wall_ms,
        "device_ms": device_ms if rows else None,
        "device_busy_share": device_ms / ref_ms if rows else None,
        "device_launches": sum(r[2] for r in rows),
        "stages": stages,
        "ported": ported,
        "top": [{"name": k[:80], "ms": ms, "count": c} for k, ms, c in rows[:10]],
    }


# The megastep's stages; the search's own stages nest inside selfplay.chunk.
TRAIN_STAGES = (
    "selfplay.cast", "selfplay.chunk", "search.init_tree", "search.descend", "search.expand", "search.evaluate",
    "search.backup", "search.promote", "search.stats", "ring.ingest", "per.sample", "learner.steps",
    "per.update",
)


def run_dir(name: str):
    """A run directory of its own under RUN_ROOT."""
    from alphatriangle_tpu_torch.config import PersistenceConfig

    return PersistenceConfig(ROOT_DATA_DIR=str(RUN_ROOT / name), RUN_NAME=name)


def loop_config(**kw):
    """The default `TrainConfig` with the train phases' depth cuts (2-move
    chunks, 256 rows to start training), no auto-resume (each phase's run
    starts fresh in its own directory), and `kw`; fails if a width was cut."""
    from alphatriangle_tpu_torch.config import TrainConfig

    kw = {"AUTO_RESUME_LATEST": False, "ROLLOUT_CHUNK_MOVES": TRAIN_CHUNK_MOVES,
          "MIN_BUFFER_SIZE_TO_TRAIN": TRAIN_MIN_BUFFER, **kw}
    cfg = TrainConfig(RANDOM_SEED=0, **kw)
    defaults = TrainConfig()
    for name in ("SELF_PLAY_BATCH_SIZE", "BATCH_SIZE", "BUFFER_CAPACITY", "N_STEP_RETURNS", "USE_PER",
                 "OPTIMIZER_TYPE", "LR_SCHEDULER_TYPE", "GRADIENT_CLIP_VALUE"):
        if getattr(cfg, name) != getattr(defaults, name):
            fail(f"a train phase cut a width: {name}")
    return cfg


# The share of a loop's iteration p50 its telemetry hooks may take.
TELEMETRY_HOOK_SHARE = 0.05
TELEMETRY_HOOKS = (
    "on_rollout", "on_learner_step", "on_util_tick", "on_tick", "record_metrics", "record_device_stats",
)


def watch_telemetry():
    """Time every telemetry hook of a training run (`perf_counter` around
    each `RunTelemetry` method the loop and its collector call, on any
    thread), and close an iteration at the end of each `_iteration_tail`:
    its hook seconds, with the flight recorder's `overhead_seconds` added
    since the last one (the intents and seals of every thread), and its
    wall since the end of the last one. A hook that raises is noted: the
    collector logs and drops what its tick sink (`record_metrics`)
    raises, as the JAX collector does, so `check_telemetry` fails the
    phase on it. Returns ({"iterations", "errors", "record_metrics"},
    restore)."""
    from alphatriangle_tpu_torch.telemetry import RunTelemetry
    from alphatriangle_tpu_torch.training.loop import TrainingLoop

    real = {name: getattr(RunTelemetry, name) for name in TELEMETRY_HOOKS}
    real_tail = TrainingLoop._iteration_tail
    lock = threading.Lock()
    state = {"hook_s": 0.0, "flight_s": 0.0, "t": None}
    # Per hook: calls, wall seconds, the calling thread's CPU seconds (the
    # rest of the wall is waiting: IO, the interpreter lock, CUDA calls)
    # and the longest call.
    by_name = {name: {"calls": 0, "wall_s": 0.0, "cpu_s": 0.0, "max_s": 0.0} for name in TELEMETRY_HOOKS}
    # The collector's passes over the run, and those inside a hook (they
    # count in its wall): passes, seconds and the longest, by generation.
    gc_passes = {where: {gen: [0, 0.0, 0.0] for gen in range(3)} for where in ("run", "hooks")}
    watch = {"iterations": [], "errors": [], "record_metrics": 0, "by_name": by_name, "gc": gc_passes}
    local = threading.local()

    def on_gc(phase, info):
        if phase == "start":
            local.gc_t0 = time.perf_counter()
            return
        t0 = getattr(local, "gc_t0", None)
        if t0 is None:
            return
        dt = time.perf_counter() - t0
        local.gc_t0 = None
        wheres = ("run", "hooks") if getattr(local, "in_hook", 0) else ("run",)
        for where in wheres:
            rec = gc_passes[where][info["generation"]]
            rec[0] += 1
            rec[1] += dt
            rec[2] = max(rec[2], dt)

    def timed(name, fn):
        def hook(self, *args, **kwargs):
            t0, c0 = time.perf_counter(), time.thread_time()
            local.in_hook = getattr(local, "in_hook", 0) + 1
            try:
                return fn(self, *args, **kwargs)
            except BaseException as exc:
                with lock:
                    watch["errors"].append(f"{name}: {exc!r}")
                raise
            finally:
                local.in_hook -= 1
                dt, dc = time.perf_counter() - t0, time.thread_time() - c0
                with lock:
                    state["hook_s"] += dt
                    b = by_name[name]
                    b["calls"] += 1
                    b["wall_s"] += dt
                    b["cpu_s"] += dc
                    b["max_s"] = max(b["max_s"], dt)
                    if name == "record_metrics":
                        watch["record_metrics"] += 1
        return hook

    def tail(self, *args, **kwargs):
        real_tail(self, *args, **kwargs)
        now = time.perf_counter()
        flight = self.telemetry.flight
        flight_s = flight.overhead_seconds if flight is not None else 0.0
        with lock:
            watch["iterations"].append({
                "hook_s": state["hook_s"] + flight_s - state["flight_s"],
                "flight_s": flight_s - state["flight_s"],
                "wall_s": None if state["t"] is None else now - state["t"],
            })
            state.update(hook_s=0.0, flight_s=flight_s, t=now)

    for name, fn in real.items():
        setattr(RunTelemetry, name, timed(name, fn))
    TrainingLoop._iteration_tail = tail
    gc.callbacks.append(on_gc)

    def restore():
        for name, fn in real.items():
            setattr(RunTelemetry, name, fn)
        TrainingLoop._iteration_tail = real_tail
        if on_gc in gc.callbacks:
            gc.callbacks.remove(on_gc)

    return watch, restore


def check_telemetry(loop, watch: dict, label: str, strict: bool = True) -> dict:
    """A finished training run's heartbeat, ledger and flight ring on the
    card, and its telemetry's host time, from `watch_telemetry` (see the
    module docstring). `strict`: every util record did work and has an
    MFU in (0, 1) (the synchronous and megastep loops). Otherwise (the
    overlapped loop, which adds a chunk's work to its counters when it
    folds the harvest, so one short record can carry a whole chunk) only
    the run does: its MFU is the analytic FLOPs of all records over their
    summed windows."""
    import torch

    from alphatriangle_tpu_torch.telemetry.flight import read_flight, unsealed_intents
    from alphatriangle_tpu_torch.telemetry.health import health_verdict, read_health
    from alphatriangle_tpu_torch.telemetry.ledger import read_ledger
    from alphatriangle_tpu_torch.telemetry.perf import summarize_utilization

    if watch["errors"]:
        fail(f"{label}: telemetry hooks raised: {watch['errors']}")
    iterations = watch["iterations"]
    c = loop.c
    run = c.persistence_config.get_run_base_dir()
    kind = torch.cuda.get_device_name(c.device)
    health = read_health(run / "health.json")
    if health is None:
        fail(f"{label}: no health.json in {run}")
    live, age, reason = health_verdict(health)
    if not live or health["learner_step"] != loop.global_step:
        fail(f"{label}: heartbeat {reason} at step {health['learner_step']} ({age:.1f} s old)")
    ledger = read_ledger(run / "metrics.jsonl")
    utils = [r for r in ledger if r.get("kind") == "util"]
    # The collector's tick sink: one record per processed batch with means.
    sink = [r for r in ledger if r.get("kind") == "tick"]
    if len(sink) != watch["record_metrics"] or not any("Loss/total_loss" in r["means"] for r in sink):
        fail(f"{label}: {len(sink)} tick records for {watch['record_metrics']} processed metric batches, "
             f"Loss/total_loss in {sum('Loss/total_loss' in r['means'] for r in sink)}")
    ticks = loop.iterations + loop.warmup_chunks
    if len(utils) != ticks - 1:
        fail(f"{label}: {len(utils)} util records for {ticks} iterations")
    for r in utils:
        if r["device_kind"] != kind or r["peak_source"] != "table":
            fail(f"{label}: util record at step {r['step']} on {r['device_kind']!r} "
                 f"({r['peak_source']}), want {kind!r} from the table")
        if "chip_idle_fraction" not in r or r["dispatches_per_iteration"] is None:
            fail(f"{label}: util record at step {r['step']} lacks the dispatch figures")
        if strict and not (0 < r["mfu"] < 1 and r["dispatches_per_iteration"] > 0 and r["transfer_d2h_ms"] > 0
                           and r["sims_per_sec"] > 0):
            fail(f"{label}: util record at step {r['step']} without work, or its MFU out of (0, 1): "
                 f"{json.dumps(r)}")
    summary = summarize_utilization(utils)
    window_s = sum(r["window_s"] for r in utils)
    mfu_run = sum(r["tflops_per_sec"] * r["window_s"] for r in utils) / window_s / summary["peak_bf16_tflops"]
    if not (0 < mfu_run < 1 and summary["dispatches_per_iteration"] > 0
            and summary["transfer_d2h_ms"] > 0 and summary["sims_per_sec"] > 0):
        fail(f"{label}: util summary without work (run MFU {mfu_run}): {json.dumps(summary)}")
    records = read_flight(run / "flight.jsonl")
    if unsealed_intents(records):
        fail(f"{label}: unsealed flight intents {unsealed_intents(records)}")
    seals = {r["seq"]: r for r in records if r.get("phase") == "seal"}
    by_family: dict = {}
    for r in records:
        if r.get("phase") == "intent":
            if not seals[r["seq"]].get("ok"):
                fail(f"{label}: dispatch {r['program']} sealed {seals[r['seq']]}")
            by_family[r["family"]] = by_family.get(r["family"], 0) + 1
    want = {"rollout": sum(e.dispatch_count for e in loop._engines()), "learner": c.trainer.dispatch_count,
            "megastep": c.megastep.dispatch_count if c.megastep is not None else 0}
    if by_family != {k: v for k, v in want.items() if v}:
        fail(f"{label}: flight intents by family {by_family}, the components counted {want}")
    walls = [i["wall_s"] for i in iterations[1:]]
    if len(iterations) != ticks or not walls:
        fail(f"{label}: {len(iterations)} iteration tails timed for {ticks} iterations")
    p50 = statistics.median(walls)
    hook = [i["hook_s"] for i in iterations]
    mean_hook = sum(hook) / len(hook)
    by_name = {
        name: {"calls": b["calls"], "wall_ms": b["wall_s"] * 1e3, "cpu_ms": b["cpu_s"] * 1e3,
               "max_ms": b["max_s"] * 1e3}
        for name, b in watch["by_name"].items() if b["calls"]
    }
    gc_passes = {
        where: {f"gen{gen}": {"passes": n, "ms": t * 1e3, "max_ms": m * 1e3} for gen, (n, t, m) in gens.items()}
        for where, gens in watch["gc"].items()
    }
    if mean_hook > TELEMETRY_HOOK_SHARE * p50:
        fail(f"{label}: telemetry hooks {mean_hook * 1e3:.2f} ms an iteration, over "
             f"{TELEMETRY_HOOK_SHARE:.0%} of the iteration p50 {p50 * 1e3:.1f} ms; by hook "
             f"{format_hooks(by_name)}; flight recorder "
             f"{statistics.fmean(i['flight_s'] for i in iterations) * 1e3:.3f} ms an iteration; "
             f"iterations' hook ms {[round(i['hook_s'] * 1e3, 1) for i in iterations]}; "
             f"collector passes {json.dumps(gc_passes)}")
    device_stats = check_device_stats(loop, label, strict=strict)
    return {
        "device_stats": device_stats,
        "util_records": len(utils),
        "tick_records": len(sink),
        "mfu_run": mfu_run,
        "mfu": summary["mfu"],
        "mfu_max": summary["mfu_max"],
        "tflops_per_sec": summary["tflops_per_sec"],
        "peak_bf16_tflops": summary["peak_bf16_tflops"],
        "dispatches_per_iteration": summary["dispatches_per_iteration"],
        "transfer_d2h_ms": summary["transfer_d2h_ms"],
        "sims_per_sec": summary["sims_per_sec"],
        "dispatch_in_flight_share": (
            None if summary.get("chip_idle_fraction") is None else 1.0 - summary["chip_idle_fraction"]
        ),
        "flight_intents": by_family,
        "iterations_timed": len(iterations),
        "iteration_ms_p50": p50 * 1e3,
        "iteration_ms_min": min(walls) * 1e3,
        "iteration_ms_max": max(walls) * 1e3,
        "hook_ms_mean": mean_hook * 1e3,
        "hook_ms_max": max(hook) * 1e3,
        "flight_overhead_ms_mean": statistics.fmean(i["flight_s"] for i in iterations) * 1e3,
        "hook_share_of_p50": mean_hook / p50,
        "hook_ms_by_name": by_name,
        "gc_passes": gc_passes,
    }


def format_gc(gens: dict) -> str:
    return ", ".join(f"{g} {r['passes']} x {r['ms']:.1f} (max {r['max_ms']:.1f})" for g, r in gens.items())


def format_hooks(by_name: dict) -> str:
    """`name calls x wall (cpu, max) ms`, one per hook that was called."""
    return ", ".join(
        f"{name} {b['calls']} x {b['wall_ms']:.1f} ({b['cpu_ms']:.1f} cpu, max {b['max_ms']:.1f}) ms"
        for name, b in by_name.items()
    )


def say_telemetry(label: str, r: dict, card: str) -> None:
    say(
        f"{label} telemetry: {r['util_records']} util records, {r['tick_records']} tick records, MFU over the "
        f"run {r['mfu_run']:.4%} (records' mean {r['mfu']:.4%}, max {r['mfu_max']:.4%}) of "
        f"{r['peak_bf16_tflops']} TFLOP/s, {r['tflops_per_sec']:.2f} TFLOP/s, "
        f"{r['dispatches_per_iteration']:.2f} dispatches an iteration, fetch {r['transfer_d2h_ms']:.1f} "
        f"ms a tick, {r['sims_per_sec']:.0f} sims/s, a dispatch in flight "
        f"{r['dispatch_in_flight_share']:.1%} of the ticks; flight intents {r['flight_intents']}; "
        f"hooks {r['hook_ms_mean']:.3f} ms an iteration (max {r['hook_ms_max']:.3f}, flight recorder "
        f"{r['flight_overhead_ms_mean']:.3f}), {r['hook_share_of_p50']:.3%} of the iteration p50 "
        f"{r['iteration_ms_p50']:.1f} ms (min {r['iteration_ms_min']:.1f}, max "
        f"{r['iteration_ms_max']:.1f}, {r['iterations_timed']} iterations); by hook, over the run: "
        f"{format_hooks(r['hook_ms_by_name'])}; the collector's passes (count, ms, longest) over the "
        f"run {format_gc(r['gc_passes']['run'])}, inside hooks {format_gc(r['gc_passes']['hooks'])} "
        f"[{card}]"
    )
    say_device_stats(label, r["device_stats"], card)


# The train phase's parameters after its first megastep (CPU copies): the
# undistributed run train-dp1 is held to.
FIRST_MEGASTEP_PARAMS: dict = {}


def train_phase(torch, dev, kernels, reuse: bool = False, record: list | None = None):
    """The default training configuration, with or without subtree
    reuse, cut in depth only, through `run_training` in megastep mode,
    with counted launches; then one more megastep under the profiler.
    With `record`, the first searched move's backup operands are
    appended to it (copied to the host, inside the first warm-up chunk)."""
    from torch.profiler import ProfilerActivity, profile

    from alphatriangle_tpu_torch.config import AlphaTriangleMCTSConfig, EnvConfig, ModelConfig
    from alphatriangle_tpu_torch.nn import NeuralNetwork
    from alphatriangle_tpu_torch.training import LoopStatus, run_training

    cfg = loop_config(
        FUSED_MEGASTEP=True, FUSED_LEARNER_STEPS=TRAIN_K, MAX_TRAINING_STEPS=TRAIN_K * TRAIN_MEGASTEPS
    )
    waves = PER_STEP["train"]["backup_update"]
    restore = record_backups(record, waves) if record is not None else None
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels.values():
        kern.launches = 0
    watch, restore_watch = watch_telemetry()
    from alphatriangle_tpu_torch.rl.megastep import MegastepRunner

    real_megastep = MegastepRunner.run_megastep

    def first_megastep(self, *args, **kwargs):
        out = real_megastep(self, *args, **kwargs)
        if not reuse and not FIRST_MEGASTEP_PARAMS:
            FIRST_MEGASTEP_PARAMS.update(
                {n: p.detach().cpu().clone() for n, p in self.trainer.model.named_parameters()}
            )
        return out

    MegastepRunner.run_megastep = first_megastep
    t0 = time.perf_counter()
    mcts_cfg = AlphaTriangleMCTSConfig(tree_reuse=reuse)
    try:
        loop = run_training(
            cfg, mcts_config=mcts_cfg, persistence_config=run_dir("train-reuse" if reuse else "train"),
            device=dev,
        )
        torch.cuda.synchronize()
    finally:
        MegastepRunner.run_megastep = real_megastep
        restore_watch()
    wall_s = time.perf_counter() - t0
    launches = {name: kern.launches for name, kern in kernels.items()}
    if restore is not None:
        restore()
    if loop.status is not LoopStatus.COMPLETED:
        fail(f"training ended {loop.status.value}")
    telemetry = check_telemetry(loop, watch, "train-reuse" if reuse else "train")
    c = loop.c
    mega = loop.timings["megastep_s"]
    if loop.megastep_iterations != TRAIN_MEGASTEPS or len(mega) != TRAIN_MEGASTEPS:
        fail(f"expected {TRAIN_MEGASTEPS} megasteps, ran {loop.megastep_iterations}")
    if loop.global_step != TRAIN_K * TRAIN_MEGASTEPS:
        fail(f"expected {TRAIN_K * TRAIN_MEGASTEPS} learner steps, took {loop.global_step}")
    for m in loop.metrics:
        for key in ("total_loss", "policy_loss", "value_loss", "entropy", "grad_norm"):
            if not (m[key] == m[key] and abs(m[key]) < float("inf")):
                fail(f"non-finite {key} at step {m['step']}")
    fresh = NeuralNetwork(ModelConfig(), EnvConfig(), seed=cfg.RANDOM_SEED, device="cpu")
    if all(
        torch.equal(a.detach().cpu(), b)
        for a, b in zip(c.net.model.parameters(), fresh.model.parameters())
    ):
        fail("training left the parameters unchanged")
    moves = (loop.warmup_chunks + loop.megastep_iterations) * TRAIN_CHUNK_MOVES
    if c.self_play.mcts.num_nodes != (PROMOTE_N if reuse else mcts_cfg.max_simulations + 1):
        fail(f"unexpected node budget N={c.self_play.mcts.num_nodes}")
    want = {"per_sample": loop.megastep_iterations}
    for name, per_move in PER_STEP["train_reuse" if reuse else "train"].items():
        want[name] = per_move * moves
    for name, n in want.items():
        if launches[name] != n:
            fail(f"{name}: {launches[name]} launches in the train phase, want {n}")
    buf, tree = c.buffer, c.buffer.tree
    size = len(buf)
    if (buf._size, buf._pos) != (tree.n_entries, tree.data_pointer):
        fail("ring size or cursor disagrees with the SumTree mirror")
    if size != min(loop.experiences_added, buf.capacity) or buf._pos != loop.experiences_added % buf.capacity:
        fail("ring size or cursor disagrees with the rows ingested")
    if reuse and loop.total_reused_visits <= 0:
        fail("the train-reuse phase inherited no root visits")
    dev_p = c.megastep.priorities.cpu().numpy()
    host_p = tree.tree[tree._cap2 : tree._cap2 + buf.capacity]
    import numpy as np

    if not np.allclose(dev_p[: buf.capacity], host_p, rtol=1e-4, atol=1e-6) or dev_p[-1] != 0.0:
        fail("device priorities disagree with the host SumTree mirror")
    sums = buf.storage["policy_target"][:size].sum(dim=1)
    if not bool(((sums - 1.0).abs() < 1e-3).all()):
        fail("a ring row's policy target is not a distribution")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    # One more megastep under the profiler (outside the counted run).
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        c.megastep.run_megastep(TRAIN_CHUNK_MOVES, TRAIN_K)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    profiled = read_profile(prof, TRAIN_STAGES, prof_wall_ms, statistics.median(mega) * 1e3)
    # Stat-packs off / on, and the beacons armed (outside the counted run).
    stats_ab = None
    if not reuse:
        stats_ab = megastep_stats_ab(
            torch, c, prof, profiled, c.persistence_config.get_run_base_dir(), sleep_cycles_per_ms()
        )
    lanes = c.self_play.batch_size
    warm = loop.timings["warmup_chunk_s"]
    report = loop.report()
    sims = mcts_cfg.max_simulations
    share = loop.total_reused_visits / (loop.total_reused_visits + loop.total_simulations)
    return {
        "stats_ab": stats_ab,
        "launches": launches,
        "megasteps": loop.megastep_iterations,
        "warmup_chunks": loop.warmup_chunks,
        "searched_moves": moves,
        "rows_ingested": loop.experiences_added,
        "episodes": loop.episodes_played,
        "losses": report["losses"],
        "wall_s": wall_s,
        "megastep_ms_first": mega[0] * 1e3,
        "megastep_ms_p50": statistics.median(mega) * 1e3,
        "megastep_ms": [t * 1e3 for t in mega],
        "warmup_chunk_ms_p50": statistics.median(warm) * 1e3,
        "rollout_moves_per_s": lanes * TRAIN_CHUNK_MOVES / statistics.median(warm),
        "megastep_moves_per_s_p50": lanes * TRAIN_CHUNK_MOVES / statistics.median(mega),
        "learner_steps_per_s_p50": TRAIN_K / statistics.median(mega),
        "leaf_evals_per_s_p50": lanes * TRAIN_CHUNK_MOVES * sims / statistics.median(mega),
        # The run's inherited share counted as evaluations the searches were spared.
        "leaf_evals_per_s_p50_with_reused": (
            lanes * TRAIN_CHUNK_MOVES * sims / statistics.median(mega) / (1.0 - share)
        ),
        "reused_visits": loop.total_reused_visits,
        "reused_share": share,
        "peak_mem_gb": peak_gb,
        "profile": profiled,
        "telemetry": telemetry,
    }


# The synchronous and overlapped phases' depth cuts (their widths are the
# defaults, as in the train phase).
SYNC_STEPS, SYNC_HOST_STEPS, ASYNC_STEPS = 10, 4, 10
# Further windows of the overlapped loop: one under the profiler, one
# with every beacon armed.
ASYNC_PROFILED_STEPS, ASYNC_ARMED_STEPS = 2, 2


def watch_chunks():
    """Record, for every rollout chunk on any thread, the weights it was
    handed and the module and version each of its moves searched with.
    Returns (records, restore)."""
    from alphatriangle_tpu_torch.rl.self_play import SelfPlayEngine

    real_chunk, real_body = SelfPlayEngine._chunk, SelfPlayEngine._move_body
    records, lock, local = [], threading.Lock(), threading.local()

    def chunk(self, num_moves, carry, weights=None):
        local.moves = []
        out = real_chunk(self, num_moves, carry, weights)
        with lock:
            records.append({"weights": weights, "moves": local.moves, "lanes": self.batch_size,
                            "net_version_after": self.net.live.version})
        return out

    def body(self, carry, version):
        local.moves.append((self.mcts.model, version))
        return real_body(self, carry, version)

    SelfPlayEngine._chunk, SelfPlayEngine._move_body = chunk, body

    def restore():
        SelfPlayEngine._chunk, SelfPlayEngine._move_body = real_chunk, real_body

    return records, restore


def check_chunks(records: list, label: str) -> dict:
    """Every chunk searched all its moves with the module it was handed
    and tagged them with that version."""
    for rec in records:
        w = rec["weights"]
        if w is None or not all(m is w.model and v == w.version for m, v in rec["moves"]):
            fail(f"{label}: a chunk read more than one set of weights")
    return {
        "chunks": len(records),
        "searched_moves": sum(len(r["moves"]) for r in records),
        "lane_moves": sum(len(r["moves"]) * r["lanes"] for r in records),
        # Chunks during which a sync installed newer weights than they read.
        "chunks_crossing_a_sync": sum(r["net_version_after"] != r["weights"].version for r in records),
        "versions": sorted({r["weights"].version for r in records}),
    }


def watch_syncs(torch):
    """Record, around every `Trainer.sync_to_network`, whether the net's
    weights equal the learner's bit for bit before and after it."""
    from alphatriangle_tpu_torch.rl.trainer import Trainer

    real = Trainer.sync_to_network
    records = []

    def same(a, b) -> bool:
        return all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))

    def sync(self):
        before = same(self.model, self.nn.model)
        version = real(self)
        records.append({"step": self.global_step, "version": version,
                        "equal_before": before, "equal_after": same(self.model, self.nn.model)})
        return version

    Trainer.sync_to_network = sync
    return records, lambda: setattr(Trainer, "sync_to_network", real)


def check_syncs(syncs: list, loop, want: "int | None", label: str) -> None:
    if len(syncs) != loop.weight_updates or (want is not None and len(syncs) != want):
        fail(f"{label}: {len(syncs)} weight syncs, loop counted {loop.weight_updates}, want {want}")
    for rec in syncs:
        if rec["equal_before"] or not rec["equal_after"]:
            fail(f"{label}: at step {rec['step']} the eval net did not differ from the learner "
                 "before the sync and equal it after")


def check_launches(launches: dict, moves: int, label: str) -> None:
    """The search kernels 16 + 2 times per searched move; no PER count."""
    want = {"gather_rows": 16 * moves, "backup_update": 2 * moves, "per_sample": 0,
            "subtree_promote": 0}
    for name, n in want.items():
        if launches[name] != n:
            fail(f"{label}: {name} launched {launches[name]} times in {moves} searched moves, want {n}")


def check_losses(loop, label: str) -> None:
    for m in loop.metrics:
        for key in ("total_loss", "policy_loss", "value_loss", "entropy", "grad_norm"):
            if not (m[key] == m[key] and abs(m[key]) < float("inf")):
                fail(f"{label}: non-finite {key} at step {m['step']}")


def device_union(prof, labels) -> dict:
    """Device time of a profile's kernels and copies on every stream: the
    union of their intervals (the time the card was busy) and their sum
    (above the union where streams ran at once)."""
    spans = sorted(trace_of(prof).device_spans(labels))
    union, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            union += b - max(a, end)
            end = b
    return {"union_ms": union / 1e3, "sum_ms": sum(b - a for a, b in spans) / 1e3, "spans": len(spans)}


def train_sync_phase(torch, dev, kernels, host_ring: bool = False) -> dict:
    """The synchronous loop at the default widths through `run_training`:
    the device ring ("auto" on the card), or with `host_ring` the host
    ring and uploaded batches. Cut in depth only. With the device ring,
    one more iteration runs under the profiler."""
    from alphatriangle_tpu_torch.training import LoopStatus, run_training

    label = "train-sync-host" if host_ring else "train-sync"
    steps = SYNC_HOST_STEPS if host_ring else SYNC_STEPS
    cfg = loop_config(MAX_TRAINING_STEPS=steps, DEVICE_REPLAY="off" if host_ring else "auto")
    chunks, restore_chunks = watch_chunks()
    syncs, restore_syncs = watch_syncs(torch)
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels.values():
        kern.launches = 0
    watch, restore_watch = watch_telemetry()
    t0 = time.perf_counter()
    try:
        loop = run_training(cfg, persistence_config=run_dir(label), device=dev)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = {name: kern.launches for name, kern in kernels.items()}
    finally:
        restore_chunks()
        restore_syncs()
        restore_watch()
    if loop.status is not LoopStatus.COMPLETED or loop.global_step != steps:
        fail(f"{label}: ended {loop.status.value} at step {loop.global_step}, want {steps}")
    telemetry = check_telemetry(loop, watch, label)
    c, buf, trainer = loop.c, loop.c.buffer, loop.c.trainer
    if buf.is_device == host_ring:
        fail(f"{label}: the replay ring is not where DEVICE_REPLAY={cfg.DEVICE_REPLAY!r} puts it")
    if trainer.model is c.net.model:
        fail(f"{label}: the learner trains the net's own module")
    check_losses(loop, label)
    # LEARNER_STEPS_PER_ROLLOUT unset: max(1, round(rows / batch)) steps an
    # iteration once the ring can give a batch, within the step budget.
    size = done = 0
    need = max(cfg.MIN_BUFFER_SIZE_TO_TRAIN, cfg.BATCH_SIZE)
    for added, ran in zip(loop.rows_per_iteration, loop.steps_per_iteration):
        size = min(size + added, buf.capacity)
        want = min(max(1, round(added / cfg.BATCH_SIZE)), steps - done) if size >= need else 0
        if ran != want:
            fail(f"{label}: {ran} learner steps after {added} rows, want {want}")
        done += ran
    seen = check_chunks(chunks, label)
    if seen["searched_moves"] != loop.iterations * TRAIN_CHUNK_MOVES:
        fail(f"{label}: {seen['searched_moves']} searched moves in {loop.iterations} iterations")
    check_launches(launches, seen["searched_moves"], label)
    check_syncs(syncs, loop, steps // cfg.WORKER_UPDATE_FREQ_STEPS, label)
    if len(buf) != loop.experiences_added or (buf.tree.n_entries, buf.tree.data_pointer) != (
        len(buf), buf._pos
    ):
        fail(f"{label}: ring size {len(buf)} is not the {loop.experiences_added} rows ingested")
    if host_ring and trainer.transfer_h2d_seconds <= 0:
        fail(f"{label}: no learner batch was uploaded")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    report = loop.report()
    lanes = c.self_play.batch_size
    it_s, roll_s, learn_s = (loop.timings[k] for k in ("iteration_s", "rollout_s", "learner_s"))
    full = [t for t, n in zip(it_s, loop.steps_per_iteration) if n == max(loop.steps_per_iteration)]
    per_step = [t / n for t, n in zip(learn_s, loop.steps_per_iteration) if n]
    out = {
        "launches": launches,
        "iterations": loop.iterations,
        "searched_moves": seen["searched_moves"],
        "rows_per_iteration": loop.rows_per_iteration,
        "steps_per_iteration": loop.steps_per_iteration,
        "rows_ingested": loop.experiences_added,
        "episodes": loop.episodes_played,
        "losses": report["losses"],
        "weight_updates": loop.weight_updates,
        "syncs": syncs,
        "replay_ratio": report["replay_ratio"],
        "staleness_mean": report["staleness_mean"],
        "wall_s": wall_s,
        "run_s": loop.run_s,
        "iteration_ms": [t * 1e3 for t in it_s],
        # Iterations that ran the most learner steps: the steady state.
        "iteration_ms_p50_full": statistics.median(full) * 1e3,
        "steps_full": max(loop.steps_per_iteration),
        "rollout_ms_p50": statistics.median(roll_s) * 1e3,
        "learner_ms_per_step_p50": statistics.median(per_step) * 1e3,
        "rollout_moves_per_s": lanes * TRAIN_CHUNK_MOVES / statistics.median(roll_s),
        "lane_moves_per_s_run": report["timings"]["lane_moves_per_s"],
        "learner_steps_per_s_run": report["timings"]["learner_steps_per_s"],
        "learner_steps_per_s_full": max(loop.steps_per_iteration) / statistics.median(full),
        "transfer_h2d_s": trainer.transfer_h2d_seconds,
        "transfer_d2h_s": trainer.transfer_d2h_seconds,
        "peak_mem_gb": peak_gb,
        "telemetry": telemetry,
    }
    if host_ring:
        return out

    out["profile"] = profile_sync_iteration(torch, loop, out["steps_full"], out["iteration_ms_p50_full"])
    return out


def profile_sync_iteration(torch, loop, steps: int, ref_ms: float) -> dict:
    """One more synchronous iteration on the device ring under the
    profiler, outside the counted run: a chunk, its fold, and `steps`
    learner steps one by one (the run's fullest iterations' count; the
    busy share divides by their p50, `ref_ms`)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    c, buf, trainer = loop.c, loop.c.buffer, loop.c.trainer
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with record_function("selfplay.chunk"):
            result, payload = c.self_play.play_moves_device(loop.cfg.ROLLOUT_CHUNK_MOVES)
        with record_function("ring.ingest"):
            loop._fold_result(result, payload=payload)
        for _ in range(steps):
            with record_function("per.sample"):
                s = buf.sample(loop.cfg.BATCH_SIZE, current_train_step=trainer.global_step)
            with record_function("learner.steps"):
                ((_, td),) = trainer.train_steps_from(buf, [s])
            with record_function("per.update"):
                buf.update_priorities(s["indices"], td)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    report = read_profile(prof, TRAIN_STAGES, prof_wall_ms, ref_ms)
    report["learner_steps"] = steps
    return report


def train_async_phase(torch, dev, kernels) -> dict:
    """The overlapped loop at the default widths through `run_training`:
    two producer streams, the replay-ratio gate at 1.0, a pipelined
    learner of fused pairs, the device ring. Cut in depth only. Then a
    further window of the same loop runs under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from alphatriangle_tpu_torch.training import LoopStatus, run_training

    label = "train-async"
    cfg = loop_config(
        ASYNC_ROLLOUTS=True, NUM_SELF_PLAY_WORKERS=2, REPLAY_RATIO=1.0, PIPELINE_LEARNER=True,
        FUSED_LEARNER_STEPS=2, ROLLOUT_QUEUE_MAX=4, MAX_TRAINING_STEPS=ASYNC_STEPS,
    )
    if cfg.ASYNC_CHUNK_SECONDS != 2.0:
        fail(f"{label}: ASYNC_CHUNK_SECONDS is not the default 2.0")
    chunks, restore_chunks = watch_chunks()
    syncs, restore_syncs = watch_syncs(torch)
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels.values():
        kern.launches = 0
    watch, restore_watch = watch_telemetry()
    t0 = time.perf_counter()
    try:
        loop = run_training(cfg, persistence_config=run_dir(label), device=dev)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = {name: kern.launches for name, kern in kernels.items()}
        seen = check_chunks(chunks, label)
    finally:
        restore_chunks()
        restore_syncs()
        restore_watch()
    if loop.status is not LoopStatus.COMPLETED or loop.global_step != ASYNC_STEPS:
        fail(f"{label}: ended {loop.status.value} at step {loop.global_step}, want {ASYNC_STEPS}"
             f" ({loop.report()['error']})")
    telemetry = check_telemetry(loop, watch, label, strict=False)
    c, buf = loop.c, loop.c.buffer
    if not buf.is_device:
        fail(f"{label}: DEVICE_REPLAY='auto' did not give the device ring on the card")
    check_losses(loop, label)
    if sorted(loop.harvests_by_stream) != [0, 1] or min(loop.harvests_by_stream.values()) < 1:
        fail(f"{label}: harvests by stream {loop.harvests_by_stream}, want both streams")
    if loop.producer_restarts != 0:
        fail(f"{label}: {loop.producer_restarts} producer restarts")
    report = loop.report()
    if report["replay_ratio"] > cfg.REPLAY_RATIO:
        fail(f"{label}: replay ratio {report['replay_ratio']} above {cfg.REPLAY_RATIO}")
    if loop.weight_updates < 1:
        fail(f"{label}: no weight sync")
    check_syncs(syncs, loop, None, label)
    check_launches(launches, seen["searched_moves"], label)
    if len(buf) != loop.experiences_added:
        fail(f"{label}: ring size {len(buf)} is not the {loop.experiences_added} rows ingested")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    run_s = loop.run_s
    out = {
        "launches": launches,
        "searched_moves": seen["searched_moves"],
        "chunks": seen["chunks"],
        "chunks_crossing_a_sync": seen["chunks_crossing_a_sync"],
        "chunk_versions": seen["versions"],
        "harvests_by_stream": loop.harvests_by_stream,
        "rows_ingested": loop.experiences_added,
        "steps": loop.global_step,
        "losses": report["losses"],
        "weight_updates": loop.weight_updates,
        "syncs": syncs,
        "replay_ratio": report["replay_ratio"],
        "staleness_mean": report["staleness_mean"],
        "tuned_chunk_moves": report["tuned_chunk_moves"],
        "queue_depth_max": report["queue_depth_max"],
        "queue_depth_mean": statistics.fmean(loop.queue_depths),
        "iterations": loop.iterations,
        "iteration_ms_p50": report["timings"]["iteration_s_p50"] * 1e3,
        # A producer's chunk, played while the other stream and the
        # learner share the card and the interpreter lock.
        "producer_chunk_ms_p50": report["timings"]["producer_chunk_s_p50"] * 1e3,
        "producer_chunks": len(loop.timings["producer_chunk_s"]),
        "wall_s": wall_s,
        "run_s": run_s,
        # Over the whole run, the tuning chunks included; the moves of
        # every chunk played (a chunk cut short by the stop is not folded).
        "lane_moves_per_s_run": seen["lane_moves"] / run_s,
        "learner_steps_per_s_run": loop.global_step / run_s,
        "learner_dispatches": c.trainer.dispatch_count,
        "peak_mem_gb": peak_gb,
        "telemetry": telemetry,
    }

    # The same loop, continued for ASYNC_PROFILED_STEPS more steps under
    # the profiler (chunk length as tuned; a fresh second stream).
    loop.cfg = loop.cfg.model_copy(
        {"MAX_TRAINING_STEPS": ASYNC_STEPS + ASYNC_PROFILED_STEPS, "ASYNC_CHUNK_SECONDS": None}
    )
    loop.stop_event.clear()
    moves0, steps0 = loop.lane_moves, loop.global_step
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loop._run_async()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    if loop.global_step != ASYNC_STEPS + ASYNC_PROFILED_STEPS:
        fail(f"{label}: the profiled window ended at step {loop.global_step}")
    busy = device_union(prof, set(STAGES) | set(TRAIN_STAGES))
    measured = busy["spans"] > 0  # a profiler that saw no device activity measured nothing
    out["profile"] = {
        "wall_ms": prof_wall_ms,
        "steps": loop.global_step - steps0,
        "lane_moves_folded": loop.lane_moves - moves0,
        "device_ms": busy["union_ms"] if measured else None,
        "device_kernel_ms_summed": busy["sum_ms"] if measured else None,
        "device_spans": busy["spans"],
        # The card is busy while any stream runs a kernel or copy.
        "device_busy_share": busy["union_ms"] / prof_wall_ms if measured else None,
        "streams_overlap": busy["sum_ms"] / busy["union_ms"] if measured else None,
    }
    out["armed"] = armed_async_window(torch, loop, dev)
    return out


def armed_async_window(torch, loop, dev) -> dict:
    """The overlapped loop, continued for ASYNC_ARMED_STEPS more steps with
    every beacon armed from the start. No beacon ring exists yet: the
    first armed site makes it, on whichever thread reaches one, and the
    two producer streams and the learner's then all add to its counter.
    The rows must be, as a multiset, the beacons the host enqueued on
    every stream (noted with their stream at `BeaconRing.emit`), with
    none dropped."""
    from alphatriangle_tpu_torch.ops import beacon as obeacon
    from alphatriangle_tpu_torch.telemetry import device_stats as tds

    label = "train-async-armed"
    run = RUN_ROOT / label
    enqueued, lock, real_emit = [], threading.Lock(), obeacon.BeaconRing.emit

    def emit(self, phase, index, program):
        real_emit(self, phase, index, program)
        with lock:
            enqueued.append(((phase, int(index), program), torch.cuda.current_stream(self.device).cuda_stream))

    tds.disarm_beacons()  # stops and forgets every ring
    loop.cfg = loop.cfg.model_copy({"MAX_TRAINING_STEPS": loop.global_step + ASYNC_ARMED_STEPS})
    loop.stop_event.clear()
    steps0 = loop.global_step
    obeacon.BeaconRing.emit = emit
    tds.attach_beacon_run_dir(run)
    tds.arm_beacons(1)
    try:
        t0 = time.perf_counter()
        loop._run_async()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        tds.drain_beacons()
        dropped = obeacon.ring_for(dev).dropped
        rows = beacon_rows(run / "beacons.jsonl")
    finally:
        obeacon.BeaconRing.emit = real_emit
        tds.disarm_beacons()
    if loop.global_step != steps0 + ASYNC_ARMED_STEPS:
        fail(f"{label}: ended at step {loop.global_step}, want {steps0 + ASYNC_ARMED_STEPS}")
    want = collections.Counter(row for row, _ in enqueued)
    streams = {s for _, s in enqueued}
    phases = sorted({p for p, _, _ in rows})
    if not rows or collections.Counter(rows) != want or dropped:
        fail(f"{label}: {len(rows)} rows against the {len(enqueued)} the host enqueued, {dropped} "
             f"dropped; rows not enqueued {list((collections.Counter(rows) - want).items())[:8]}, "
             f"enqueued and missing {list((want - collections.Counter(rows)).items())[:8]}")
    if len(streams) < 3 or not {"search_wave", "learner_step"} <= set(phases):
        fail(f"{label}: beacons from {len(streams)} streams, phases {phases}: want both producers' "
             "and the learner's")
    return {
        "steps": ASYNC_ARMED_STEPS,
        "wall_ms": wall_ms,
        "rows": len(rows),
        "streams": len(streams),
        "phases": phases,
        "dropped": dropped,
    }


def tiny_reference_configs():
    """The reference phases' small world: a 3x4 board, an f32 net without
    the transformer (whose dropout masks differ between the two devices'
    generators), 8 simulations without Dirichlet noise (a device
    generator's draw)."""
    from alphatriangle_tpu_torch.config import (
        AlphaTriangleMCTSConfig,
        EnvConfig,
        ModelConfig,
        expected_other_features_dim,
    )

    env_cfg = EnvConfig(
        ROWS=3, COLS=4, PLAYABLE_RANGE_PER_ROW=[(0, 4)] * 3, NUM_SHAPE_SLOTS=1,
        MAX_SHAPE_TRIANGLES=3, LINE_MIN_LENGTH=3,
    )
    model_cfg = ModelConfig(
        CONV_FILTERS=[8], CONV_KERNEL_SIZES=[3], CONV_STRIDES=[1], NUM_RESIDUAL_BLOCKS=0,
        RESIDUAL_BLOCK_FILTERS=8, USE_TRANSFORMER=False, TRANSFORMER_LAYERS=0,
        # Hidden widths of 64 keep GroupNorm at 8 features a group: a group
        # of 2 nearly equal values normalises rounding, which differs by device.
        FC_DIMS_SHARED=[64], POLICY_HEAD_DIMS=[64], VALUE_HEAD_DIMS=[64], NUM_VALUE_ATOMS=11,
        OTHER_NN_INPUT_FEATURES_DIM=expected_other_features_dim(env_cfg), COMPUTE_DTYPE="float32",
    )
    mcts_cfg = AlphaTriangleMCTSConfig(
        max_simulations=8, max_depth=4, mcts_batch_size=4, dirichlet_epsilon=0.0
    )
    return env_cfg, model_cfg, mcts_cfg


def reference_sync_phase(torch, dev) -> dict:
    """One tiny synchronous iteration (3 learner steps, a sync after the
    second) from the same seed on the CPU (plain versions, the host ring
    that "auto" gives there) and on the card (the kernels, the device
    ring): the same rows ingested, the same sampled slots, losses within
    the reference megastep's tolerances (1e-3 relative)."""
    import numpy as np

    from alphatriangle_tpu_torch.config import TrainConfig
    from alphatriangle_tpu_torch.training import TrainingLoop, setup_training_components

    env_cfg, model_cfg, mcts_cfg = tiny_reference_configs()
    cfg = TrainConfig(
        SELF_PLAY_BATCH_SIZE=4, ROLLOUT_CHUNK_MOVES=2, BATCH_SIZE=8, BUFFER_CAPACITY=2000,
        MIN_BUFFER_SIZE_TO_TRAIN=16, N_STEP_RETURNS=2, MAX_EPISODE_MOVES=30, RANDOM_SEED=5,
        LEARNER_STEPS_PER_ROLLOUT=3, WORKER_UPDATE_FREQ_STEPS=2, MAX_TRAINING_STEPS=3,
    )
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    sides = {}
    try:
        for device in ("cpu", dev):
            c = setup_training_components(
                cfg, env_cfg, model_cfg, mcts_cfg,
                persistence_config=run_dir(f"reference-sync-{torch.device(device).type}"),
                device=device,
            )
            loop = TrainingLoop(c)
            drawn, real_sample = [], c.buffer.sample

            def sample(*args, _real=real_sample, _drawn=drawn, **kwargs):
                s = _real(*args, **kwargs)
                _drawn.append(None if s is None else s["indices"])
                return s

            c.buffer.sample = sample
            counts = []
            while len(c.buffer) < cfg.MIN_BUFFER_SIZE_TO_TRAIN:
                counts.append(loop._process_rollout())
            counts.append(loop._process_rollout())
            ran = loop._run_training_steps(cfg.LEARNER_STEPS_PER_ROLLOUT)
            size = len(c.buffer)
            if c.buffer.is_device:
                ring = {k: v[:size].cpu().numpy() for k, v in c.buffer.storage.items()}
            else:
                ring = {k: v[:size].copy() for k, v in c.buffer._storage.items()}
            sides[str(device)] = {
                "ring_kind": "device" if c.buffer.is_device else "host",
                "counts": counts, "ran": ran, "ring": ring, "idx": drawn,
                "syncs": loop.weight_updates,
                "losses": np.array([[m["total_loss"], m["value_loss"]] for m in loop.metrics]),
            }
            c.stats.close()  # its last events, while the run directory exists
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    cpu, card = sides["cpu"], sides[str(dev)]
    if (cpu["ring_kind"], card["ring_kind"]) != ("host", "device"):
        fail("reference sync: DEVICE_REPLAY='auto' did not give the host ring on the CPU "
             "and the device ring on the card")
    if cpu["counts"] != card["counts"]:
        fail(f"reference sync: rows ingested differ: CPU {cpu['counts']}, card {card['counts']}")
    if not (cpu["ran"] == card["ran"] == 3 and cpu["syncs"] == card["syncs"] == 1):
        fail("reference sync: the iteration did not run 3 steps and one sync on both devices")
    for name in ("grid", "policy_target", "policy_weight"):
        if not np.array_equal(cpu["ring"][name].astype(np.float32), card["ring"][name].astype(np.float32)):
            fail(f"reference sync: ring column {name} differs between the card and the CPU")
    for name in ("other_features", "value_target"):
        if not np.allclose(cpu["ring"][name], card["ring"][name], rtol=1e-4, atol=1e-4):
            fail(f"reference sync: ring column {name} differs between the card and the CPU")
    if len(cpu["idx"]) != len(card["idx"]) or not all(
        np.array_equal(a, b) for a, b in zip(cpu["idx"], card["idx"])
    ):
        fail("reference sync: the sampled slots differ between the card and the CPU")
    loss_err = float(np.abs(cpu["losses"] - card["losses"]).max())
    if not np.allclose(card["losses"], cpu["losses"], rtol=1e-3, atol=1e-5):
        fail(f"reference sync: losses differ between the card and the CPU by {loss_err}")
    return {"rows": cpu["counts"], "steps": cpu["ran"], "draws": len(cpu["idx"]),
            "loss_max_abs_err": loss_err}


class _ExactStub:
    """Zero policy logits and value logits that select one atom per
    state (from the occupied-cell count), so both devices compute the
    net's outputs exactly."""

    def __init__(self, atoms: int):
        self.atoms = atoms

    def __call__(self, grid, other):
        import torch

        count = grid[:, 0].clamp(min=0).sum(dim=(-2, -1)).long()
        atom = (count * 3 + 1) % self.atoms
        value = torch.full((grid.shape[0], self.atoms), float("-inf"), device=grid.device)
        value[torch.arange(grid.shape[0], device=grid.device), atom] = 0.0
        return torch.zeros((grid.shape[0], 12), device=grid.device), value


def reference_phase(torch, dev) -> dict:
    from alphatriangle_tpu_torch import rng
    from alphatriangle_tpu_torch.config import (
        AlphaTriangleMCTSConfig,
        EnvConfig,
        ModelConfig,
        expected_other_features_dim,
    )
    from alphatriangle_tpu_torch.env import TriangleEnv
    from alphatriangle_tpu_torch.features import FeatureExtractor
    from alphatriangle_tpu_torch.mcts import BatchedMCTS
    from alphatriangle_tpu_torch.nn.model import value_support

    env_cfg = EnvConfig(
        ROWS=3, COLS=4, PLAYABLE_RANGE_PER_ROW=[(0, 4)] * 3, NUM_SHAPE_SLOTS=1,
        MAX_SHAPE_TRIANGLES=3, LINE_MIN_LENGTH=3,
    )
    model_cfg = ModelConfig(
        OTHER_NN_INPUT_FEATURES_DIM=expected_other_features_dim(env_cfg), NUM_VALUE_ATOMS=11
    )
    mcts_cfg = AlphaTriangleMCTSConfig(
        max_simulations=16, max_depth=5, mcts_batch_size=8, dirichlet_epsilon=0.0
    )
    from alphatriangle_tpu_torch.telemetry import device_stats as tds

    outs = {}
    tds.set_device_stats(True)  # both searches carry their stat-packs
    try:
        for device in ("cpu", dev):
            env = TriangleEnv(env_cfg, device=device)
            mcts = BatchedMCTS(
                env, FeatureExtractor(env, model_cfg), _ExactStub(11), mcts_cfg,
                value_support(model_cfg),
            )
            roots = env.reset(rng.split(rng.PRNGKey(4), 16))
            out = mcts.search(roots, rng.PRNGKey(5))
            outs[device] = (out.visit_counts.cpu(), out.root_value.cpu(), out.stats.cpu())
    finally:
        tds.set_device_stats(False)
    if not torch.equal(outs["cpu"][0], outs[dev][0]):
        fail("search visit counts on the card differ from the CPU's")
    if not torch.allclose(outs["cpu"][1], outs[dev][1], atol=1e-5, rtol=1e-5):
        fail("search root values on the card differ from the CPU's")
    # The stat-pack: histogram, concentration, occupancy and |value| max
    # equal (float64 means of equal float32 values are exact in any
    # order); the entropy's per-game sums over the actions within 1e-6.
    got, want = (tds.unpack_search_stats(outs[d][2].numpy()) for d in (dev, "cpu"))
    for key in ("depth_hist", "root_concentration", "occupancy", "value_abs_max", "reuse_frac"):
        if not (got[key] == want[key]).all():
            fail(f"search stat-pack {key} on the card {got[key]} differs from the CPU's {want[key]}")
    if abs(got["root_entropy"] - want["root_entropy"]) > 1e-6 * abs(want["root_entropy"]):
        fail(f"search stat-pack root_entropy on the card {got['root_entropy']} vs the CPU's "
             f"{want['root_entropy']}")
    if got["depth_hist"].sum() != 16 * 16:
        fail("the reference stat-pack's histogram does not count every simulation")
    return {key: (v.tolist() if hasattr(v, "tolist") else v) for key, v in got.items()}


def reference_reuse_phase(torch, dev) -> dict:
    """Three moves of carried search and promotion from the same roots on
    the CPU (plain versions) and on the card (the kernels), under the
    exact stub: the same visit counts, inherited visits, carried planes,
    carry validity and bases; root values within 1e-5."""
    from alphatriangle_tpu_torch import rng
    from alphatriangle_tpu_torch.config import (
        AlphaTriangleMCTSConfig,
        EnvConfig,
        ModelConfig,
        expected_other_features_dim,
    )
    from alphatriangle_tpu_torch.env import TriangleEnv
    from alphatriangle_tpu_torch.features import FeatureExtractor
    from alphatriangle_tpu_torch.mcts import BatchedMCTS, root_actions
    from alphatriangle_tpu_torch.nn.model import value_support

    env_cfg = EnvConfig(
        ROWS=3, COLS=4, PLAYABLE_RANGE_PER_ROW=[(0, 4)] * 3, NUM_SHAPE_SLOTS=1,
        MAX_SHAPE_TRIANGLES=3, LINE_MIN_LENGTH=3,
    )
    model_cfg = ModelConfig(
        OTHER_NN_INPUT_FEATURES_DIM=expected_other_features_dim(env_cfg), NUM_VALUE_ATOMS=11
    )
    mcts_cfg = AlphaTriangleMCTSConfig(
        max_simulations=16, max_depth=5, mcts_batch_size=8, dirichlet_epsilon=0.0, tree_reuse=True
    )
    names = ("e_visits", "e_value", "e_reward", "children", "prior", "valid", "terminal")
    sides = {}
    for device in ("cpu", dev):
        env = TriangleEnv(env_cfg, device=device)
        mcts = BatchedMCTS(
            env, FeatureExtractor(env, model_cfg), _ExactStub(11), mcts_cfg,
            value_support(model_cfg),
        )
        states = env.reset(rng.split(rng.PRNGKey(6), 16))
        carried = mcts.zero_carried(states)
        moves = []
        for move in range(3):
            out, tree, reused = mcts._search_carried(states, rng.PRNGKey(20 + move), carried)
            actions = root_actions(out)
            carried = mcts.promote(tree, actions)
            moves.append({
                "visits": out.visit_counts.cpu(), "root_value": out.root_value.cpu(),
                "reused": reused.cpu(), "carry_valid": carried.valid.cpu(),
                "carry_base": carried.base.cpu(),
                **{name: getattr(carried.tree, name).cpu() for name in names},
            })
            states, _, _ = env.step(states, actions)
        sides[str(device)] = moves
    for move, (cpu, card) in enumerate(zip(sides["cpu"], sides[str(dev)])):
        for key, x in cpu.items():
            if key == "root_value":
                if not torch.allclose(x, card[key], atol=1e-5, rtol=1e-5):
                    fail(f"carried search root values differ from the CPU's at move {move}")
            elif not torch.equal(x, card[key]):
                fail(f"carried search {key} differs between the card and the CPU at move {move}")
    last = sides["cpu"][-1]
    if float(sum(m["reused"].sum() for m in sides["cpu"])) <= 0:
        fail("the carried reference search inherited no visits")
    return {"moves": 3, "reused": [float(m["reused"].sum()) for m in sides["cpu"]],
            "valid_lanes": int(last["carry_valid"].sum())}


def reference_train_phase(torch, dev) -> dict:
    """A tiny megastep (f32 net without the transformer, whose dropout
    masks differ between the two devices' generators; TF32 off; no
    Dirichlet noise, which draws from a device generator) from the same
    seed on the CPU and on the card: the same rows, slots and draws; the
    n-step returns within 1e-4 (root values of the net, summed in another
    order), and losses and TD errors within 1e-3 relative."""
    import numpy as np

    from alphatriangle_tpu_torch.config import TrainConfig
    from alphatriangle_tpu_torch.training import setup_training_components

    env_cfg, model_cfg, mcts_cfg = tiny_reference_configs()
    cfg = TrainConfig(
        FUSED_MEGASTEP=True, SELF_PLAY_BATCH_SIZE=4, ROLLOUT_CHUNK_MOVES=2, BATCH_SIZE=8,
        BUFFER_CAPACITY=2000, MIN_BUFFER_SIZE_TO_TRAIN=16, N_STEP_RETURNS=2, MAX_EPISODE_MOVES=30,
        RANDOM_SEED=5, FUSED_LEARNER_STEPS=2, MAX_TRAINING_STEPS=2,
    )
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    sides = {}
    try:
        for device in ("cpu", dev):
            c = setup_training_components(
                cfg, env_cfg, model_cfg, mcts_cfg,
                persistence_config=run_dir(f"reference-train-{torch.device(device).type}"),
                device=device,
            )
            counts = []
            while len(c.buffer) < max(cfg.MIN_BUFFER_SIZE_TO_TRAIN, cfg.BATCH_SIZE):
                _, payload = c.self_play.play_moves_device(cfg.ROLLOUT_CHUNK_MOVES)
                counts.append(c.buffer.ingest_payload(payload))
            c.megastep.sync_priorities_from_host()
            results, added = c.megastep.run_megastep(cfg.ROLLOUT_CHUNK_MOVES, cfg.FUSED_LEARNER_STEPS)
            size = len(c.buffer)
            sides[str(device)] = {
                "counts": counts + [added],
                "ring": {k: v[:size].cpu().numpy() for k, v in c.buffer.storage.items()},
                "idx": c.megastep.last_idx,
                "losses": np.array([[m["total_loss"], m["value_loss"]] for m, _ in results]),
                "td": np.stack([td for _, td in results]),
            }
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    cpu, card = sides["cpu"], sides[str(dev)]
    if cpu["counts"] != card["counts"]:
        fail(f"rows ingested differ: CPU {cpu['counts']}, card {card['counts']}")
    for name in ("grid", "policy_target", "policy_weight"):
        if not np.array_equal(cpu["ring"][name], card["ring"][name]):
            fail(f"ring column {name} differs between the card and the CPU")
    ring_err = {
        name: float(np.abs(cpu["ring"][name] - card["ring"][name]).max())
        for name in ("other_features", "value_target")
    }
    for name, err in ring_err.items():
        if not np.allclose(cpu["ring"][name], card["ring"][name], rtol=1e-4, atol=1e-4):
            fail(f"ring column {name} differs between the card and the CPU by {err}")
    if not np.array_equal(cpu["idx"], card["idx"]):
        fail("the megastep's sampled slots differ between the card and the CPU")
    loss_err = float(np.abs(cpu["losses"] - card["losses"]).max())
    td_err = float(np.abs(cpu["td"] - card["td"]).max())
    if not np.allclose(card["losses"], cpu["losses"], rtol=1e-3, atol=1e-5):
        fail(f"losses differ between the card and the CPU by {loss_err}")
    if not np.allclose(card["td"], cpu["td"], rtol=1e-3, atol=1e-5):
        fail(f"TD errors differ between the card and the CPU by {td_err}")
    return {
        "rows": cpu["counts"], "loss_max_abs_err": loss_err, "td_max_abs_err": td_err,
        "value_target_max_abs_err": ring_err["value_target"],
    }


# The checkpoint phases' depth cuts (widths are the defaults): the
# train-sync phase's 2-move chunks and 256 rows to start training; the
# preempted run checkpoints every 4 steps of 10; the megastep run every 2
# steps of 4, then resumes for 2 more megasteps; eval plays 64 games of up
# to 8 moves (the serve default's 64 slots x 64 simulations).
PREEMPT_FREQ, PREEMPT_STEPS = 4, 10
MEGA_RESUME_FREQ, MEGA_RESUME_STEPS = 2, 4
EVAL_GAMES, EVAL_SIMS, EVAL_MAX_MOVES = 64, 64, 8
# `cli eval`'s report keys, the JAX package's (alphatriangle_tpu/cli.py cmd_eval).
EVAL_KEYS = (
    "source", "games", "sims", "mcts_mean_score", "mcts_max_score", "mcts_mean_length",
    "finished_fraction", "random_mean_score", "score_vs_random", "paired_mean_diff",
    "paired_win_rate",
)
LOSS_KEYS = ("total_loss", "policy_loss", "value_loss", "entropy", "grad_norm")


def run_cli(args: list, label: str, timeout: float, on_start=None) -> tuple:
    """`python -m alphatriangle_tpu_torch.cli <args>` in a process of its
    own, as a user runs it, its output in files under RUN_ROOT;
    `on_start(proc)` runs while it does. Returns (exit code, the JSON
    report on its last line). The process never outlives the call."""
    out_path, err_path = RUN_ROOT / f"{label}.out", RUN_ROOT / f"{label}.err"
    with open(out_path, "w") as out, open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "alphatriangle_tpu_torch.cli", *args],
            cwd=ROOT, stdout=out, stderr=err, text=True,
        )
        try:
            if on_start is not None:
                on_start(proc)
            rc = proc.wait(timeout=timeout)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    lines = out_path.read_text().strip().splitlines()
    try:
        return rc, json.loads(lines[-1])
    except (IndexError, ValueError):
        fail(f"{label}: exit {rc} without a JSON report; stderr: {err_path.read_text()[-3000:]}")


def cli_in_process(args: list, label: str) -> tuple:
    """`python -m alphatriangle_tpu_torch.cli <args>` run in this process
    (`cli.main`, its standard output in a file under RUN_ROOT), the
    kernels' launch counts zeroed first so its report counts its own.
    Returns (exit code, the JSON report on its last line)."""
    import contextlib
    import io

    from alphatriangle_tpu_torch import cli
    from alphatriangle_tpu_torch.ops import KERNELS

    for kern in KERNELS.values():
        kern.launches = 0
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(args)
    (RUN_ROOT / f"{label}.out").write_text(out.getvalue())
    lines = out.getvalue().strip().splitlines()
    try:
        return rc, json.loads(lines[-1])
    except (IndexError, ValueError):
        fail(f"{label}: exit {rc} without a JSON report")


def check_report_losses(report: dict, label: str) -> None:
    for key in LOSS_KEYS:
        for v in report["losses"][key]:
            if not (v == v and abs(v) < float("inf")):
                fail(f"{label}: non-finite {key}")


def state_equal(torch, a: dict, b: dict) -> bool:
    """Two `Trainer.get_state()` snapshots equal bit for bit (on the CPU)."""
    if (a["step"], a["opt_state"]["count"]) != (b["step"], b["opt_state"]["count"]):
        return False
    if not torch.equal(a["rng"].cpu(), b["rng"].cpu()):
        return False
    for part in ("mu", "nu", "params"):
        x = a["params"] if part == "params" else a["opt_state"][part]
        y = b["params"] if part == "params" else b["opt_state"][part]
        if set(x) != set(y) or not all(torch.equal(x[n].cpu(), y[n].cpu()) for n in x):
            return False
    return True


def run_reader(args: list, label: str) -> tuple:
    """`cli health` / `cli perf` with `args` in a process whose imports of
    torch, numpy or JAX raise (the readers run on the standard library);
    (exit code, standard output). Fails on a guarded import."""
    proc = subprocess.run(
        [sys.executable, "-c", _NO_TORCH_PARENT + "sys.exit(main(sys.argv[1:]))", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=60,
    )
    if "a torch-free process imported" in proc.stderr:
        fail(f"{label}: {proc.stderr.strip().splitlines()[-1]}")
    return proc.returncode, proc.stdout


def preempt_resume_phase(torch) -> dict:
    """`cli train` (the synchronous loop, the device ring) at the default
    widths, SIGTERM once its first checkpoint is committed: exit 114, a
    preempt report, a committed checkpoint and a spill at the step it
    stopped at. Then the same command under another run name auto-resumes
    that run from that step, with the spill's rows, to the last step."""
    import numpy as np

    from alphatriangle_tpu_torch.config import TrainConfig

    label = "preempt-resume"
    torch.cuda.empty_cache()  # the card's memory for the two processes this phase starts
    root = RUN_ROOT / label
    run = root / "AlphaTriangleTPUTorch" / "runs" / "ckpt"
    common = [
        "train", "--device", "cuda", "--root-dir", str(root), "--checkpoint-freq", str(PREEMPT_FREQ),
        "--max-steps", str(PREEMPT_STEPS), "--rollout-chunk", str(TRAIN_CHUNK_MOVES),
        "--min-buffer", str(TRAIN_MIN_BUFFER),
    ]
    marker = run / "checkpoints" / f"step_{PREEMPT_FREQ:08d}.commit"
    signalled = {}

    def preempt(proc):
        deadline = time.monotonic() + 600
        while not marker.exists():
            if proc.poll() is not None or time.monotonic() > deadline:
                return
            time.sleep(0.05)
        # The run's probe while it trains: live, one JSON line.
        t_probe = time.perf_counter()
        rc, out = run_reader(["health", "ckpt", "--root-dir", str(root), "--probe"], label)
        signalled["probe_s"] = time.perf_counter() - t_probe
        lines = out.strip().splitlines()
        signalled["probe"] = json.loads(lines[0]) if len(lines) == 1 else None
        signalled["probe_rc"] = rc
        signalled["alive_after_probe"] = proc.poll() is None
        signalled["at"] = time.perf_counter()
        proc.send_signal(signal.SIGTERM)

    t0 = time.perf_counter()
    rc, first = run_cli([*common, "--run-name", "ckpt"], "preempt-train", 900, preempt)
    first_s = time.perf_counter() - t0
    if "at" not in signalled:
        fail(f"{label}: the run ended (exit {rc}) before step {PREEMPT_FREQ} was committed")
    probe = signalled["probe"]
    if signalled["probe_rc"] != 0 or probe is None or probe["code"] != 0 or not signalled["alive_after_probe"]:
        fail(f"{label}: the probe of the training run gave exit {signalled['probe_rc']}, {probe}")
    stop_s = time.perf_counter() - signalled["at"]
    if rc != 114 or first["status"] != "preempted":
        fail(f"{label}: SIGTERM gave exit {rc}, status {first['status']}, want 114, preempted")
    step = first["checkpointed_step"]
    report = json.loads((run / "preempt_report.json").read_text())
    if not (report["checkpointed_step"] == step == first["steps"] == first["buffer_saved_step"]
            and step >= PREEMPT_FREQ and report["exit_code"] == 114 and report["kind"] == "preempt"):
        fail(f"{label}: preempt report {report} against the run's report at step {first['steps']}")
    spill = run / "buffers" / f"buffer_{step:08d}.npz"
    if not (run / "checkpoints" / f"step_{step:08d}.commit").is_file() or not spill.is_file():
        fail(f"{label}: no committed checkpoint and spill at step {step}")
    # The doctor of the preempted run, before the resume writes into it.
    doctor_rc, doctor_out = run_reader(["doctor", "ckpt", "--root-dir", str(root), "--json"], label)
    doctor = json.loads(doctor_out)
    if doctor_rc != 7 or doctor["verdict"] != "preempted":
        fail(f"{label}: cli doctor of the preempted run gave exit {doctor_rc}: {doctor}")
    with np.load(spill) as data:
        spill_rows = int(data["size"])
    t0 = time.perf_counter()
    rc, second = run_cli([*common, "--run-name", "other"], "resume-train", 900)
    second_s = time.perf_counter() - t0
    if rc != 0 or second["status"] != "completed":
        fail(f"{label}: the resumed run gave exit {rc}, status {second['status']}")
    if (second["run_name"], second["resumed_step"], second["restored_rows"]) != ("ckpt", step, spill_rows):
        fail(f"{label}: resumed run {second['run_name']} at step {second['resumed_step']} with "
             f"{second['restored_rows']} rows, want ckpt at {step} with the spill's {spill_rows}")
    if second["steps"] != PREEMPT_STEPS or second["checkpointed_step"] != PREEMPT_STEPS:
        fail(f"{label}: the resumed run ended at step {second['steps']}")
    if (root / "AlphaTriangleTPUTorch" / "runs" / "other" / "checkpoints").exists():
        fail(f"{label}: the resumed run wrote a run of its own")
    for r in (first, second):
        check_report_losses(r, label)
        if r["replay_ring"] != "device" or r["mode"] != "sync":
            fail(f"{label}: not the synchronous loop on the device ring")
    # The run's heartbeat and ledger through the readers, as a user reads them.
    health_rc, health_out = run_reader(["health", "ckpt", "--root-dir", str(root)], label)
    perf_rc, perf_out = run_reader(["perf", "ckpt", "--root-dir", str(root), "--json"], label)
    summary = json.loads(perf_out) if perf_rc == 0 else {}
    if health_rc != 0 or not health_out.startswith("run ckpt: LIVE") or perf_rc != 0 or summary.get("mfu") is None:
        fail(f"{label}: cli health exit {health_rc} ({health_out[:200]!r}), cli perf exit {perf_rc}, "
             f"MFU {summary.get('mfu')}")
    lanes = TrainConfig().SELF_PLAY_BATCH_SIZE
    launches = {
        k: first["kernel_launches"][k] + second["kernel_launches"][k] for k in first["kernel_launches"]
    }
    moves = (first["lane_moves"] + second["lane_moves"]) // lanes
    check_launches(launches, moves, label)
    ck1, ck2 = first["checkpoints"], second["checkpoints"]
    return {
        "launches": launches,
        "searched_moves": moves,
        "preempted_at_step": step,
        "spill_rows": spill_rows,
        "first_run_s": first_s,
        "sigterm_to_exit_s": stop_s,
        "resumed_run_s": second_s,
        "save_ms": [t * 1e3 for t in ck1["save_s"]],
        "spill_ms": [t * 1e3 for t in ck1["spill_s"]],
        "spill_bytes": ck1["spill_bytes"],
        "restore_state_ms": ck2["restore_state_s"][0] * 1e3,
        "restore_ring_ms": ck2["restore_buffer_s"][0] * 1e3,
        "restore_ms": second["restore_s"] * 1e3,
        "first_resumed_iteration_ms": second["timings"]["first_iteration_s"] * 1e3,
        "resumed_iteration_ms_p50": second["timings"]["iteration_s_p50"] * 1e3,
        "resumed_save_ms": [t * 1e3 for t in ck2["save_s"]],
        "steps_per_iteration": [first["steps_per_iteration"], second["steps_per_iteration"]],
        "losses": [first["losses"], second["losses"]],
        "probe": probe,
        "probe_s": signalled["probe_s"],
        "doctor_rc": doctor_rc,
        "doctor": doctor,
        "health": health_out.strip().splitlines(),
        "perf": {k: summary.get(k) for k in (
            "ticks", "ticks_total", "device_kind", "peak_bf16_tflops", "peak_source", "mfu", "mfu_max",
            "tflops_per_sec", "learner_steps_per_sec", "moves_per_sec", "sims_per_sec",
            "step_time_ms_p50", "dispatches_per_iteration", "transfer_d2h_ms", "chip_idle_fraction",
        )},
        "perf_programs": summary.get("programs"),
    }


def megastep_resume_phase(torch, dev, kernels) -> tuple:
    """The default widths through `run_training` in megastep mode with a
    checkpoint every 2 steps to step 4; then a run of another name
    auto-resumes it for 2 more megasteps. The learner installed before the
    first resumed megastep must equal the file bit for bit, the device
    priorities it draws from the float32 of the restored SumTree leaves,
    and the resumed megasteps must launch `per_sample` once each and the
    search kernels 16 + 2 times per searched move. The file also loads on
    the CPU, bit-equal. Returns (figures, the resumed ring)."""
    import numpy as np

    from alphatriangle_tpu_torch.config import PersistenceConfig
    from alphatriangle_tpu_torch.rl.megastep import MegastepRunner
    from alphatriangle_tpu_torch.stats import CheckpointManager
    from alphatriangle_tpu_torch.stats.persistence import load_spill
    from alphatriangle_tpu_torch.training import LoopStatus, TrainingLoop, run_training

    label = "megastep-resume"
    steps = MEGA_RESUME_STEPS
    kw = dict(FUSED_MEGASTEP=True, FUSED_LEARNER_STEPS=TRAIN_K, CHECKPOINT_SAVE_FREQ_STEPS=MEGA_RESUME_FREQ)
    p1 = run_dir(label)
    first = run_training(
        loop_config(RUN_NAME=p1.RUN_NAME, MAX_TRAINING_STEPS=steps, **kw), persistence_config=p1,
        device=dev,
    )
    if first.status is not LoopStatus.COMPLETED or first.global_step != steps:
        fail(f"{label}: the first run ended {first.status.value} at step {first.global_step}")
    mgr = first.c.checkpoints
    if mgr.valid_steps() != list(range(MEGA_RESUME_FREQ, steps + 1, MEGA_RESUME_FREQ)):
        fail(f"{label}: checkpoints at {mgr.valid_steps()}")
    on_card = mgr.restore(step=steps).train_state
    on_cpu = CheckpointManager(p1, device="cpu", create_dirs=False).restore(step=steps).train_state
    if on_card["params"] and next(iter(on_card["params"].values())).device.type != "cuda":
        fail(f"{label}: the restore did not land on the card")
    if not state_equal(torch, on_card, on_cpu):
        fail(f"{label}: the checkpoint loaded on the CPU differs from the card's")
    spill = load_spill(p1.get_buffer_dir() / f"buffer_{steps:08d}.npz")

    seen = {}
    real_run, real_megastep = TrainingLoop.run, MegastepRunner.run_megastep

    def run(loop):
        buf = loop.c.buffer
        seen["state"] = loop.c.trainer.get_state()
        seen["rows"] = len(buf)
        seen["leaves"] = buf.tree.tree[buf.tree._cap2 :][: buf.capacity].copy()
        return real_run(loop)

    def run_megastep(runner, *args, **kwargs):
        if "priorities" not in seen:
            seen["priorities"] = runner.priorities.cpu().clone().numpy()
        return real_megastep(runner, *args, **kwargs)

    TrainingLoop.run, MegastepRunner.run_megastep = run, run_megastep
    p2 = PersistenceConfig(ROOT_DATA_DIR=p1.ROOT_DATA_DIR, RUN_NAME="resumed")
    for kern in kernels.values():
        kern.launches = 0
    try:
        second = run_training(
            loop_config(
                RUN_NAME="resumed", AUTO_RESUME_LATEST=True, MAX_TRAINING_STEPS=steps + 2 * TRAIN_K, **kw
            ),
            persistence_config=p2, device=dev,
        )
        torch.cuda.synchronize()
        launches = {name: kern.launches for name, kern in kernels.items()}
    finally:
        TrainingLoop.run, MegastepRunner.run_megastep = real_run, real_megastep
    if second.status is not LoopStatus.COMPLETED or second.global_step != steps + 2 * TRAIN_K:
        fail(f"{label}: the resumed run ended {second.status.value} at step {second.global_step}")
    if (second.c.persistence_config.RUN_NAME, second.resumed_step) != (p1.RUN_NAME, steps):
        fail(f"{label}: resumed {second.c.persistence_config.RUN_NAME} at {second.resumed_step}")
    if not state_equal(torch, seen["state"], on_card):
        fail(f"{label}: the restored learner differs from the checkpoint file")
    rows = spill["size"]
    if seen["rows"] != rows or not np.array_equal(seen["leaves"][:rows], spill["priorities"]):
        fail(f"{label}: the restored ring or SumTree differs from the spill")
    prio, leaves = seen["priorities"], seen["leaves"]
    if not (np.array_equal(prio[:-1], leaves.astype(np.float32)) and prio[-1] == 0):
        fail(f"{label}: the first resumed megastep's priorities are not the restored SumTree's")
    if second.warmup_chunks != 0 or second.megastep_iterations != 2:
        fail(f"{label}: {second.warmup_chunks} warm-up chunks and {second.megastep_iterations} megasteps")
    moves = second.megastep_iterations * TRAIN_CHUNK_MOVES
    want = {"per_sample": second.megastep_iterations, "gather_rows": 16 * moves,
            "backup_update": 2 * moves, "subtree_promote": 0}
    if launches != want:
        fail(f"{label}: launches {launches}, want {want}")
    if second.c.checkpoints.latest_step() != second.global_step:
        fail(f"{label}: the resumed run's last checkpoint is not at its last step")
    check_losses(first, label)
    check_losses(second, label)
    ck1, ck2 = first.c.checkpoints.timings, second.c.checkpoints.timings
    out = {
        "launches": launches,
        "megasteps": second.megastep_iterations,
        "searched_moves": moves,
        "restored_rows": seen["rows"],
        "save_ms": [t * 1e3 for t in ck1["save_s"]],
        "spill_ms": [t * 1e3 for t in ck1["spill_s"]],
        "spill_bytes": ck1["spill_bytes"],
        "restore_state_ms": ck2["restore_state_s"][0] * 1e3,
        "restore_ring_ms": ck2["restore_buffer_s"][0] * 1e3,
        "restore_ms": second.restore_s * 1e3,
        "first_resumed_megastep_ms": second.timings["megastep_s"][0] * 1e3,
        "resumed_megastep_ms": [t * 1e3 for t in second.timings["megastep_s"]],
        "losses": [first.report()["losses"], second.report()["losses"]],
    }
    return out, second.c.buffer


def ring_round_trip_phase(torch, dev, src) -> dict:
    """The device ring at its full 250,000 slots, the rows and priorities
    of `src` (a train phase's ring) repeated, its cursor wrapped: timed
    `get_state`, `save_buffer` (the spill), `restore_buffer_path` into a
    fresh ring, and `set_state`; the restored ring and SumTree equal the
    source in chronological order bit for bit, and a second round trip
    of the restored ring is the identity."""
    import numpy as np

    from alphatriangle_tpu_torch.config import TrainConfig
    from alphatriangle_tpu_torch.rl import DeviceReplayBuffer
    from alphatriangle_tpu_torch.stats import CheckpointManager

    label = "ring-round-trip"
    cfg = TrainConfig(RANDOM_SEED=0)
    cap, n, wrap = cfg.BUFFER_CAPACITY, len(src), 12_345
    shape = dict(
        grid_shape=tuple(src.storage["grid"].shape[1:]), other_dim=src.storage["other_features"].shape[1],
        action_dim=src.storage["policy_target"].shape[1],
    )

    def ring():
        return DeviceReplayBuffer(cfg, **shape, device=dev)

    full = ring()
    rows = torch.arange(cap, device=dev) % n
    for name, col in full.storage.items():
        col[:cap] = src.storage[name][rows]
    full.record_ingest(cap)
    full.record_ingest(wrap)  # the cursor past slot 0: a wrapped ring
    src_leaves = src.tree.tree[src.tree._cap2 :][:n]
    full.tree.update_batch(np.arange(cap), src_leaves[np.arange(cap) % n])
    torch.cuda.synchronize()
    mgr = CheckpointManager(run_dir(label), device=dev)
    t0 = time.perf_counter()
    state = full.get_state()
    get_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    path = mgr.save_buffer(0, full)
    save_ms = (time.perf_counter() - t0) * 1e3
    restored = ring()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.restore_buffer_path(restored, path)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    again = ring()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again.set_state(restored.get_state())
    torch.cuda.synchronize()
    round_trip_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ring().set_state(state)
    torch.cuda.synchronize()
    set_ms = (time.perf_counter() - t0) * 1e3
    order = np.roll(np.arange(cap), -full._pos)  # oldest first
    idx = torch.from_numpy(order).to(dev)
    for name, col in full.storage.items():
        if not torch.equal(restored.storage[name][:cap], col[:cap][idx]) or restored.storage[name][cap].any():
            fail(f"{label}: restored column {name} differs from the ring it was spilled from")
        if not torch.equal(again.storage[name], restored.storage[name]):
            fail(f"{label}: a second round trip changed column {name}")
    leaves = full.tree.tree[full.tree._cap2 :][:cap]
    if not np.array_equal(restored.tree.tree[restored.tree._cap2 :][:cap], leaves[order]):
        fail(f"{label}: restored SumTree leaves differ")
    if not np.array_equal(again.tree.tree, restored.tree.tree):
        fail(f"{label}: a second round trip changed the SumTree")
    if (len(restored), restored._pos, len(full), full._pos) != (cap, 0, cap, wrap):
        fail(f"{label}: ring counters after the restore")
    row_bytes = sum(col[0].numel() * col.element_size() for col in full.storage.values())
    return {
        "rows": cap,
        "source_rows": n,
        "row_bytes": row_bytes,
        "spill_bytes": path.stat().st_size,
        "get_state_ms": get_ms,
        "save_buffer_ms": save_ms,
        "restore_buffer_path_ms": restore_ms,
        "set_state_ms": set_ms,
        "get_set_round_trip_ms": round_trip_ms,
    }


def eval_phase(
    torch, gumbel: bool = False, run: str = "ckpt", root: str = "preempt-resume",
    step: int = PREEMPT_STEPS, label: "str | None" = None, precision: str = "float32",
) -> dict:
    """`cli eval` on the card (in this process) against a run's newest
    checkpoint (the preempt-resume run's by default): 64 paired games through
    `PolicyService` (64 slots x 64 simulations), cut at 8 moves; with
    `gumbel`, `cli eval --gumbel` (the Gumbel search in exploit mode).
    The report carries the JAX report's keys and names the restored step;
    its random side equals the same baseline played on the CPU; the
    search kernels launch 16 + 2 times per dispatch."""
    import numpy as np

    from alphatriangle_tpu_torch.arena import play, random_policy
    from alphatriangle_tpu_torch.config import EnvConfig
    from alphatriangle_tpu_torch.env import TriangleEnv

    label = label or ("eval-gumbel" if gumbel else "eval")
    rc, report = cli_in_process(
        ["eval", "--run-name", run, "--root-dir", str(RUN_ROOT / root), "--games",
         str(EVAL_GAMES), "--sims", str(EVAL_SIMS), "--max-moves", str(EVAL_MAX_MOVES), "--device",
         "cuda"] + (["--gumbel"] if gumbel else []),
        label,
    )
    if rc != 0 or report.get("gumbel") is not gumbel:
        fail(f"{label}: exit {rc}, gumbel {report.get('gumbel')}")
    missing = [k for k in EVAL_KEYS if k not in report]
    if missing:
        fail(f"{label}: report lacks {missing}")
    if report["source"] != f"{run} step {step}" or report["inference_precision"] != precision:
        fail(f"{label}: evaluated {report['source']!r} at {report['inference_precision']}, want "
             f"the run's step {step} at {precision}")
    if not 0.0 <= report["finished_fraction"] <= 1.0 or report["games"] != EVAL_GAMES:
        fail(f"{label}: finished fraction {report['finished_fraction']} of {report['games']} games")
    scores = np.asarray(report["mcts_scores"])
    if scores.shape != (EVAL_GAMES,) or not np.isfinite(scores).all():
        fail(f"{label}: search scores {scores}")
    env = TriangleEnv(EnvConfig(), device="cpu")
    cpu_random, _, _ = play(env, random_policy(env, 0), EVAL_GAMES, EVAL_MAX_MOVES, 0)
    if report["random_scores"] != cpu_random.tolist():
        fail(f"{label}: the card run's random baseline differs from the CPU's")
    n = report["dispatches"]
    want = {"gather_rows": 16 * n, "backup_update": 2 * n, "per_sample": 0, "subtree_promote": 0}
    if report["kernel_launches"] != want or not 0 < n <= EVAL_MAX_MOVES:
        fail(f"{label}: launches {report['kernel_launches']} in {n} dispatches, want {want}")
    return {
        "launches": report["kernel_launches"],
        "dispatches": n,
        "games_per_s": report["games_per_s"],
        "dispatch_ms_p50": report["dispatch_ms_p50"],
        "mcts_wall_s": report["mcts_wall_s"],
        "report": {k: report[k] for k in EVAL_KEYS},
    }


# --- slice 7: Gumbel root search, playout caps, the presets --------------

# Preset 3's cuts in every loop (depth only): 2-move chunks, 256 rows to
# start training, 2 learner steps in a group of 2.
P3_STEPS, P3_K = 2, 2
# Presets 2, 4 and 5 (the synchronous loop at each preset's widths): the
# moves of the one chunk that gives the ring a batch (rows mature after
# the 5-step window), and one learner step.
PRESET_CHUNKS = {2: 8, 4: 6, 5: 6}


def search_waves(sims: int, wave: int = 32) -> int:
    """Waves of a search of `sims` simulations: W is the largest divisor
    of `sims` at most `wave`."""
    w = min(wave, sims)
    while sims % w:
        w -= 1
    return sims // w


def record_waves_by_width(store: dict, names: dict):
    """Record the first backup of each wave width W in `names` (W ->
    label) into `store[label]` (operands copied to the host); returns the
    function that restores the search's backup."""
    from alphatriangle_tpu_torch.mcts import search as search_mod

    real = search_mod.backup_update

    def recorded(*args, **kwargs):
        label = names.get(int(args[4].shape[1]))
        if label is not None and not store.get(label):
            store[label] = [[x.cpu() for x in args]]
        return real(*args, **kwargs)

    search_mod.backup_update = recorded
    return lambda: setattr(search_mod, "backup_update", real)


def search_cases_in_background():
    """Start making the search-shape cases of `search_shape_phase` (numpy,
    `ops/kernel_cases.py`: gigabytes at presets 4 and 5) on a thread, so
    numpy fills them (without the interpreter lock) beside the build and
    the kernel phase. Returns the wait for them: {shape: {"gather": its
    arrays, family: (planes, updates)}}."""
    from alphatriangle_tpu_torch.ops.kernel_cases import SEARCH_SHAPES, backup_case, gather_case

    cases: dict = {}

    def make() -> None:
        for name, (b, n, a, w, d) in SEARCH_SHAPES.items():
            cases[name] = {"gather": gather_case(b, n, 6 * a, w, seed=n)}
            for family in ("gumbel_roots", "random"):
                cases[name][family] = backup_case(family, b=b, n=n, a=a, seed=n, w=w, d=d)

    join = in_background(make)

    def wait() -> dict:
        join()
        return cases

    return wait


def search_shape_phase(torch, dev, rate: float, cycles: float, cases: dict) -> dict:
    """The gather and the backup at the search shapes of the paths this
    slice adds (`kernel_cases.SEARCH_SHAPES`: fast searches, presets 2, 4
    and 5): bit-equal to their plain versions (the backup on the Gumbel
    wave family and the random one), then each kernel's time against the
    least time its bytes need. `cases` are `search_cases_in_background`'s
    (each shape's arrays are dropped once used)."""
    import importlib

    from alphatriangle_tpu_torch.ops.kernel_cases import SEARCH_SHAPES

    g = importlib.import_module("alphatriangle_tpu_torch.ops.gather_rows")
    mb = importlib.import_module("alphatriangle_tpu_torch.ops.mcts_backup")
    report = {"gather_rows": {}, "backup_update": {}}
    for name, (b, n, a, w, d) in SEARCH_SHAPES.items():
        k = 6 * a
        made = cases.pop(name)
        stats, idx = (torch.from_numpy(x).to(dev) for x in made.pop("gather"))
        got = g.gather_rows_cuda(stats, idx)
        torch.cuda.synchronize()
        if not torch.equal(got, g.gather_rows_plain(stats, idx)):
            fail(f"gather_rows kernel differs from its plain version at the {name} shape")
        rows = torch.unique(torch.arange(b, device=dev)[:, None] * n + idx).numel()
        gbytes = rows * k * 4 + b * w * k * 4 + b * w * 8
        report["gather_rows"][name] = {
            "shape": {"B": b, "N": n, "K": k, "W": w},
            "ms": time_ms(lambda: g.gather_rows_cuda(stats, idx), cycles),
            "bound_ms": gbytes / rate * 1e3,
            "bound_by": "bytes",
        }
        del stats, idx, got
        for case in ("gumbel_roots", "random"):
            planes, updates = made.pop(case)
            planes = [torch.from_numpy(x).to(dev) for x in planes]
            updates = [torch.from_numpy(x).to(dev) for x in updates]
            want = mb.backup_update_plain(*[p.clone() for p in planes], *updates)
            got = mb.backup_update_cuda(*[p.clone() for p in planes], *updates)
            torch.cuda.synchronize()
            for plane, x, y in zip(PLANES, got, want):
                if not bits_equal(torch, x, y):
                    fail(f"backup_update kernel differs from plain on {plane} ({case}, {name})")
            if case != "gumbel_roots":
                continue
            parents, actions, _, _, rec_node, rec_action, rec_active, _ = updates
            bcol = torch.arange(b, device=dev)[:, None]
            ins = torch.unique(bcol * n * a + parents * a + actions).numel()
            bk = torch.unique(
                bcol[..., None] * n * a + rec_node.clamp(min=0) * a + rec_action.clamp(min=0)
            ).numel()
            bbytes = ins * 12 + bk * 16 + b * w * (8 + 8 + 4 + 4) + b * w * d * (8 + 8 + 1 + 4)
            report["backup_update"][name] = {
                "shape": {"B": b, "N": n, "A": a, "W": w, "D": d, "W*D": w * d},
                "family": case,
                "ms": time_ms(lambda: mb.backup_update_cuda(*planes, *updates), cycles),
                "bound_ms": bbytes / rate * 1e3,
                "bound_by": "bytes",
            }
        del planes, updates, want, got
        torch.cuda.empty_cache()
    return report


def watched_moves(torch, kernels):
    """Time every move between synchronisations, with its kernel launches
    and its full/fast choice (a list of dicts, filled as moves run);
    returns (moves, restore)."""
    from alphatriangle_tpu_torch.rl.self_play import SelfPlayEngine

    moves, real_body = [], SelfPlayEngine._move_body

    def body(self, carry, version):
        torch.cuda.synchronize()
        before = {name: kern.launches for name, kern in kernels.items()}
        t0 = time.perf_counter()
        new_carry, out = real_body(self, carry, version)
        torch.cuda.synchronize()
        sims, is_full = out["mode"]
        moves.append({
            "ms": (time.perf_counter() - t0) * 1e3, "sims": sims, "is_full": is_full,
            "launches": {name: kern.launches - before[name] for name, kern in kernels.items()},
        })
        return new_carry, out

    SelfPlayEngine._move_body = body
    return moves, lambda: setattr(SelfPlayEngine, "_move_body", real_body)


def train_cli(torch, kernels, label: str, args: list) -> dict:
    """`cli train <args>` in this process, as `python -m ... cli train`
    runs it (its JSON report read from its standard output), in a run
    directory of its own, with counted launches and the peak device
    memory. The `TrainingLoop` it ran is kept (through the training
    package's `run_training`, which the command looks up when it runs),
    and every move played is noted, full or fast, without a
    synchronisation (`played`: the moves of chunks a stopping producer
    never hands over too)."""
    import contextlib
    import io

    from alphatriangle_tpu_torch import cli, training
    from alphatriangle_tpu_torch.rl.self_play import SelfPlayEngine

    loops, played = [], []
    real_run, real_body = training.run_training, SelfPlayEngine._move_body

    def run_training(*a, **kw):
        loops.append(real_run(*a, **kw))
        return loops[-1]

    def body(self, carry, version):
        new_carry, out = real_body(self, carry, version)
        played.append(bool(out["mode"][1]))
        return new_carry, out

    training.run_training = run_training
    SelfPlayEngine._move_body = body
    for kern in kernels.values():
        kern.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main([
                "train", "--device", "cuda", "--root-dir", str(RUN_ROOT / label), "--run-name",
                label, "--no-auto-resume", *args,
            ])
        torch.cuda.synchronize()
    finally:
        training.run_training = real_run
        SelfPlayEngine._move_body = real_body
    wall_s = time.perf_counter() - t0
    launches = {name: kern.launches for name, kern in kernels.items()}
    report = json.loads(out.getvalue().strip().splitlines()[-1])
    if rc != 0 or report["status"] != "completed" or len(loops) != 1:
        fail(f"{label}: exit {rc}, status {report['status']}, error {report['error']}")
    check_report_losses(report, label)
    return {
        "report": report, "loop": loops[0], "launches": launches, "played": played,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30, "wall_s": wall_s,
    }


def check_search_launches(launches: dict, full: int, fast: int, waves: tuple, label: str) -> None:
    """8 gathers (one per descent level) and one backup per wave, for
    `full` moves of `waves[0]` waves and `fast` moves of `waves[1]`."""
    n = full * waves[0] + fast * waves[1]
    for name, want in (("gather_rows", 8 * n), ("backup_update", n), ("subtree_promote", 0)):
        if launches[name] != want:
            fail(f"{label}: {launches[name]} {name} launches for {full} full and {fast} fast "
                 f"moves, want {want}")


def train_preset3_phase(torch, dev, kernels, mode: str, record: "dict | None" = None) -> dict:
    """`cli train --preset 3` at full width (512 lanes, Gumbel roots of 64
    simulations, fast searches of 16 at p = 0.25, the 4-layer
    transformer, batch 256, the 250,000-slot ring), cut in depth only,
    in the preset's synchronous loop (`mode` "sync"), with
    --fused-megastep ("megastep") or with --async-rollouts ("async").
    Launches must be 16 + 2 per full move and 8 + 1 per fast one. The
    counted run is timed as it runs, with no synchronisation added. Then
    the synchronous mode times chunks of the same engine with every move
    between synchronisations (the full and the fast move times, the
    launches of each move; with `record`, the first full and fast waves'
    backup operands are kept) and profiles one iteration; the megastep
    mode profiles one megastep."""
    from alphatriangle_tpu_torch.config import baseline_preset

    label = {"sync": "train-preset3", "megastep": "train-preset3-megastep",
             "async": "train-preset3-async"}[mode]
    args = ["--preset", "3", "--rollout-chunk", str(TRAIN_CHUNK_MOVES), "--min-buffer",
            str(TRAIN_MIN_BUFFER), "--max-steps", str(P3_STEPS), "--fused-learner-steps", str(P3_K)]
    args += {"sync": [], "megastep": ["--fused-megastep"], "async": ["--async-rollouts"]}[mode]
    run = train_cli(torch, kernels, label, args)
    loop, report, launches = run["loop"], run["report"], run["launches"]
    c = loop.c
    want = baseline_preset(3)
    mcts, fast = c.self_play.mcts, c.self_play.mcts_fast
    if (c.self_play.batch_size, c.train_config.BATCH_SIZE, c.train_config.BUFFER_CAPACITY) != (
        want["train"].SELF_PLAY_BATCH_SIZE, want["train"].BATCH_SIZE, want["train"].BUFFER_CAPACITY
    ) or c.model_config != want["model"] or not c.self_play.use_gumbel:
        fail(f"{label}: the run is not at preset 3's widths")
    if (mcts.num_waves, fast.num_waves, fast.exploit, fast.config.max_simulations) != (2, 1, True, 16):
        fail(f"{label}: unexpected searches (waves {mcts.num_waves}/{fast.num_waves})")
    if loop.global_step != P3_STEPS or report["mode"] != mode:
        fail(f"{label}: {loop.global_step} learner steps in mode {report['mode']}, want {P3_STEPS}")
    searched, full = len(run["played"]), sum(run["played"])
    check_search_launches(launches, full, searched - full, (2, 1), label)
    if launches["per_sample"] != (loop.megastep_iterations if mode == "megastep" else 0):
        fail(f"{label}: {launches['per_sample']} per_sample launches")
    series = c.stats.get_series("SelfPlay/Full_Search_Fraction")
    if not series or not all(0.0 <= f <= 1.0 for _, f in series):
        fail(f"{label}: Full_Search_Fraction ticks {series}")
    live = Path(report["live_metrics"]).read_text().splitlines()
    if mode == "async":
        ticks = loop.iterations
        if loop.producer_restarts != 0 or report["replay_ratio"] > c.train_config.REPLAY_RATIO:
            fail(f"{label}: {loop.producer_restarts} restarts, replay ratio {report['replay_ratio']}")
        if c.stats.latest("System/Rollout_Queue_Depth") is None:
            fail(f"{label}: no System/Rollout_Queue_Depth tick")
    else:
        # One tick per chunk, each the fraction of its moves searched in full.
        ticks = (loop.warmup_chunks + loop.megastep_iterations) if mode == "megastep" else loop.iterations
        if searched != ticks * TRAIN_CHUNK_MOVES or len(series) != ticks or round(
            sum(f for _, f in series) * TRAIN_CHUNK_MOVES
        ) != full:
            fail(f"{label}: {searched} moves ({full} full) against {len(series)} ticks {series}")
    if not ticks <= len(live) <= ticks + 1:
        fail(f"{label}: {len(live)} live_metrics lines for {ticks} ticks")
    device_stats = check_device_stats(loop, label, strict=mode != "async")
    lanes = c.self_play.batch_size
    out = {
        "launches": launches,
        "searched_moves": searched,
        "full_moves": full,
        "fast_moves": searched - full,
        "full_search_fraction": full / searched,
        "full_search_fraction_series": [f for _, f in series],
        "rows_ingested": loop.experiences_added,
        "episodes": loop.episodes_played,
        "losses": report["losses"],
        "steps": loop.global_step,
        "wall_s": run["wall_s"],
        "run_s": loop.run_s,
        "peak_mem_gb": run["peak_mem_gb"],
        "live_metrics_lines": len(live),
        "stats_writers": report["stats_writers"],
        "learner_steps_per_s_run": report["timings"]["learner_steps_per_s"],
        "device_stats": device_stats,
    }
    if mode == "async":
        out.update({
            "iterations": loop.iterations,
            "harvests_by_stream": loop.harvests_by_stream,
            "tuned_chunk_moves": report["tuned_chunk_moves"],
            "replay_ratio": report["replay_ratio"],
            "queue_depth_max": report["queue_depth_max"],
            "producer_chunk_ms_p50": report["timings"]["producer_chunk_s_p50"] * 1e3,
            # Every move the producer played, over the run's wall.
            "moves_per_s_run": lanes * searched / loop.run_s,
        })
        return out
    if mode == "megastep":
        mega, warm = loop.timings["megastep_s"], loop.timings["warmup_chunk_s"]
        out.update({
            "megasteps": loop.megastep_iterations,
            "warmup_chunks": loop.warmup_chunks,
            "megastep_ms": [t * 1e3 for t in mega],
            "megastep_ms_p50": statistics.median(mega) * 1e3,
            "warmup_chunk_ms_p50": statistics.median(warm) * 1e3,
            "rollout_moves_per_s": lanes * TRAIN_CHUNK_MOVES / statistics.median(warm),
            "megastep_moves_per_s_p50": lanes * TRAIN_CHUNK_MOVES / statistics.median(mega),
            "learner_steps_per_s_p50": P3_K / statistics.median(mega),
        })
        torch.cuda.synchronize()
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            c.megastep.run_megastep(TRAIN_CHUNK_MOVES, P3_K)
            torch.cuda.synchronize()
            prof_wall_ms = (time.perf_counter() - t0) * 1e3
        out["profile"] = read_profile(prof, TRAIN_STAGES, prof_wall_ms, out["megastep_ms_p50"])
        out["profile"]["moves_full"] = [bool(x) for x in c.self_play.last_trace["is_full"]]
        return out
    it_s, roll_s = loop.timings["iteration_s"], loop.timings["rollout_s"]
    steps_full = max(loop.steps_per_iteration)
    full_its = [t for t, n in zip(it_s, loop.steps_per_iteration) if n == steps_full]
    out.update({
        "iterations": loop.iterations,
        "rows_per_iteration": loop.rows_per_iteration,
        "steps_per_iteration": loop.steps_per_iteration,
        "iteration_ms_p50_full": statistics.median(full_its) * 1e3,
        "rollout_ms_p50": statistics.median(roll_s) * 1e3,
        "rollout_moves_per_s": lanes * TRAIN_CHUNK_MOVES / statistics.median(roll_s),
    })
    # The watched pass: chunks of the same engine, outside the counted
    # run, until two moves of each kind were timed (at most 8 chunks).
    moves, restore = watched_moves(torch, kernels)
    restore_rec = record_waves_by_width(record, {32: "gumbel", 16: "fast"}) if record is not None else None
    try:
        for _ in range(8):
            c.self_play.play_moves_device(TRAIN_CHUNK_MOVES)
            n_full = sum(m["is_full"] for m in moves)
            if min(n_full, len(moves) - n_full) >= 2:
                break
    finally:
        restore()
        if restore_rec is not None:
            restore_rec()
    for m in moves:
        per = (16, 2) if m["is_full"] else (8, 1)
        if (m["launches"]["gather_rows"], m["launches"]["backup_update"]) != per:
            fail(f"{label}: a {'full' if m['is_full'] else 'fast'} move launched {m['launches']}")
    full_ms = [m["ms"] for m in moves if m["is_full"]]
    fast_ms = [m["ms"] for m in moves if not m["is_full"]]
    out.update({
        # Each move between synchronisations, in the watched pass.
        "full_move_ms_p50": statistics.median(full_ms) if full_ms else None,
        "fast_move_ms_p50": statistics.median(fast_ms) if fast_ms else None,
        "full_move_ms": full_ms,
        "fast_move_ms": fast_ms,
        "launches_per_full_move": {"gather_rows": 16, "backup_update": 2},
        "launches_per_fast_move": {"gather_rows": 8, "backup_update": 1},
    })
    out["profile"] = profile_sync_iteration(torch, loop, steps_full, out["iteration_ms_p50_full"])
    out["profile"]["moves_full"] = [bool(x) for x in c.self_play.last_trace["is_full"]]
    return out


def train_preset_phase(torch, kernels, n: int) -> dict:
    """`cli train --preset N` (N = 2, 4, 5) at the preset's widths in its
    synchronous loop, cut in depth: chunks of `PRESET_CHUNKS[n]` moves
    (one gives the ring a batch at these widths) and one learner step.
    8 gathers and one backup per wave. The figures are the last
    iteration's, the one with the learner step."""
    from alphatriangle_tpu_torch.config import baseline_preset

    label = f"train-preset{n}"
    chunk = PRESET_CHUNKS[n]
    run = train_cli(torch, kernels, label, [
        "--preset", str(n), "--rollout-chunk", str(chunk), "--min-buffer", str(TRAIN_MIN_BUFFER),
        "--max-steps", "1",
    ])
    loop, launches = run["loop"], run["launches"]
    c, want = loop.c, baseline_preset(n)
    if (c.self_play.batch_size, c.env_config, c.model_config, c.mcts_config.max_simulations) != (
        want["train"].SELF_PLAY_BATCH_SIZE, want["env"], want["model"], want["mcts"].max_simulations
    ):
        fail(f"{label}: the run is not at preset {n}'s widths")
    waves = search_waves(want["mcts"].max_simulations)
    if c.self_play.mcts.num_waves != waves or loop.global_step != 1:
        fail(f"{label}: {loop.iterations} iterations, {loop.global_step} steps, "
             f"{c.self_play.mcts.num_waves} waves")
    searched = loop.iterations * chunk
    check_search_launches(launches, searched, 0, (waves, 0), label)
    it_s, roll_s, learn_s = (loop.timings[k] for k in ("iteration_s", "rollout_s", "learner_s"))
    lanes = c.self_play.batch_size
    return {
        "launches": launches,
        "searched_moves": searched,
        "lanes": lanes,
        "sims": c.mcts_config.max_simulations,
        "waves": waves,
        "board": [c.env_config.ROWS, c.env_config.COLS],
        "transformer_layers": c.model_config.TRANSFORMER_LAYERS if c.model_config.USE_TRANSFORMER else 0,
        "remat": c.model_config.REMAT,
        "rows_ingested": loop.experiences_added,
        "losses": run["report"]["losses"],
        "iterations": loop.iterations,
        "iteration_ms": it_s[-1] * 1e3,
        "rollout_ms": roll_s[-1] * 1e3,
        "learner_ms": learn_s[-1] * 1e3,
        "rollout_moves_per_s": lanes * chunk / roll_s[-1],
        "leaf_evals_per_s": lanes * chunk * c.mcts_config.max_simulations / roll_s[-1],
        "wall_s": run["wall_s"],
        "peak_mem_gb": run["peak_mem_gb"],
    }


def attention_memory_phase(torch, dev) -> dict:
    """Preset 5's leaf evaluation at full width: one forward of its net
    (12x21 board, 8 transformer layers, bf16) over 1024 lanes x 32 wave
    members, with the attention in slices of the batch (`SCORE_BUDGET`)
    and, as before this slice, the whole batch at once. Peak device
    memory of each above what was allocated before it; an out-of-memory
    error of the whole batch is the measurement, not a failure."""
    import importlib

    from alphatriangle_tpu_torch.config import baseline_preset
    from alphatriangle_tpu_torch.nn import NeuralNetwork

    model_mod = importlib.import_module("alphatriangle_tpu_torch.nn.model")
    bundle = baseline_preset(5)
    env_cfg, model_cfg = bundle["env"], bundle["model"]
    net = NeuralNetwork(model_cfg, env_cfg, seed=0, device=dev)
    leaves = bundle["train"].SELF_PLAY_BATCH_SIZE * 32
    gen = torch.Generator(device=dev).manual_seed(0)
    grid = torch.randint(-1, 2, (leaves, model_cfg.GRID_INPUT_CHANNELS, env_cfg.ROWS, env_cfg.COLS),
                         generator=gen, device=dev).float()
    other = torch.rand((leaves, model_cfg.OTHER_NN_INPUT_FEATURES_DIM), generator=gen, device=dev)
    budget = model_mod.SCORE_BUDGET
    report = {"leaves": leaves, "tokens": env_cfg.ROWS * env_cfg.COLS,
              "heads": model_cfg.TRANSFORMER_HEADS, "score_budget": budget}
    sliced = None
    for name, limit in (("sliced", budget), ("whole", 1 << 62)):
        model_mod.SCORE_BUDGET = limit
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        try:
            t0 = time.perf_counter()
            with torch.no_grad():
                policy, value = net.model(grid, other)
            torch.cuda.synchronize()
            report[name] = {
                "ms": (time.perf_counter() - t0) * 1e3,
                "peak_gb": (torch.cuda.max_memory_allocated() - base) / 2**30,
                "slices": -(-leaves // max(1, limit // (model_cfg.TRANSFORMER_HEADS * report["tokens"] ** 2))),
            }
            if name == "sliced":
                if not (bool(torch.isfinite(policy).all()) and bool(torch.isfinite(value).all())):
                    fail("preset 5's leaf evaluation is not finite")
                sliced = (policy.cpu(), value.cpu())
                del policy, value
                # The same forward once more under the profiler: its kernels.
                from torch.profiler import ProfilerActivity, profile

                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    t1 = time.perf_counter()
                    with torch.no_grad():
                        policy, value = net.model(grid, other)
                    torch.cuda.synchronize()
                    wall_ms = (time.perf_counter() - t1) * 1e3
                report[name]["profile"] = read_profile(prof, (), wall_ms, report[name]["ms"])
            else:
                report[name]["max_abs_diff_vs_sliced"] = max(
                    float((policy.cpu() - sliced[0]).abs().max()),
                    float((value.cpu() - sliced[1]).abs().max()),
                )
            del policy, value
        except torch.cuda.OutOfMemoryError as exc:
            report[name] = {"out_of_memory": True,
                            "peak_gb": (torch.cuda.max_memory_allocated() - base) / 2**30,
                            "error": str(exc).splitlines()[0][:200]}
        finally:
            model_mod.SCORE_BUDGET = budget
    torch.cuda.empty_cache()
    return report


def reference_gumbel_phase(torch, dev) -> dict:
    """One Gumbel search of 16 simulations in 2 halving waves, explore and
    exploit, from the same roots on the CPU and on the card under the
    exact stub: the same selected actions and visit counts; improved
    policies within 1e-6."""
    from alphatriangle_tpu_torch import rng
    from alphatriangle_tpu_torch.env import TriangleEnv
    from alphatriangle_tpu_torch.features import FeatureExtractor
    from alphatriangle_tpu_torch.mcts import GumbelMCTS
    from alphatriangle_tpu_torch.nn.model import value_support

    env_cfg, model_cfg, base = tiny_reference_configs()
    mcts_cfg = base.model_copy(update={"max_simulations": 16, "mcts_batch_size": 8,
                                       "root_selection": "gumbel", "gumbel_m": 4})
    report = {}
    for exploit in (False, True):
        outs = {}
        for device in ("cpu", dev):
            env = TriangleEnv(env_cfg, device=device)
            mcts = GumbelMCTS(env, FeatureExtractor(env, model_cfg), _ExactStub(11), mcts_cfg,
                              value_support(model_cfg), exploit=exploit)
            out = mcts.search(env.reset(rng.split(rng.PRNGKey(8), 16)), rng.PRNGKey(9))
            outs[str(device)] = {k: getattr(out, k).cpu() for k in (
                "selected_action", "visit_counts", "improved_policy")}
        cpu, card = outs["cpu"], outs[str(dev)]
        label = "exploit" if exploit else "explore"
        for key in ("selected_action", "visit_counts"):
            if not torch.equal(cpu[key], card[key]):
                fail(f"Gumbel search ({label}) {key} on the card differs from the CPU's")
        err = float((cpu["improved_policy"] - card["improved_policy"]).abs().max())
        if err > 1e-6:
            fail(f"Gumbel search ({label}) improved policy differs by {err:.2e}")
        report[label] = {"improved_policy_max_abs_err": err,
                         "selected": cpu["selected_action"].tolist()}
    return report


def reference_pcr_phase(torch, dev) -> dict:
    """Four moves of a chunk with Gumbel roots and playout-cap
    randomization (8 simulations, fast searches of 4 at p = 0.5) from the
    same carry on the CPU and on the card under the exact stub: the same
    `is_full` sequence, simulations, actions' rows, masks and policy
    weights; improved policies within 1e-6, returns and root values
    within 1e-5, features within one float32 ulp."""
    from types import SimpleNamespace

    from alphatriangle_tpu_torch.config import TrainConfig
    from alphatriangle_tpu_torch.env import TriangleEnv
    from alphatriangle_tpu_torch.features import FeatureExtractor
    from alphatriangle_tpu_torch.nn.model import value_support
    from alphatriangle_tpu_torch.nn.network import LiveWeights
    from alphatriangle_tpu_torch.rl import SelfPlayEngine
    from alphatriangle_tpu_torch.utils.transfer import fetch

    env_cfg, model_cfg, base = tiny_reference_configs()
    mcts_cfg = base.model_copy(update={"root_selection": "gumbel", "fast_simulations": 4,
                                       "full_search_prob": 0.5})
    train_cfg = TrainConfig(RUN_NAME="ref", N_STEP_RETURNS=2, MAX_EPISODE_MOVES=30,
                            SELF_PLAY_BATCH_SIZE=8)
    sides = {}
    for device in ("cpu", dev):
        env = TriangleEnv(env_cfg, device=device)
        stub = _ExactStub(11)
        support = value_support(model_cfg, device=device)
        net = SimpleNamespace(model=stub, support=support, weights_version=0,
                              live=LiveWeights(0, stub))
        engine = SelfPlayEngine(env, FeatureExtractor(env, model_cfg), net, mcts_cfg, train_cfg,
                                seed=3)
        _, out = engine._chunk(4, engine._carry, LiveWeights(0, stub))
        sides[str(device)] = fetch(out)
    cpu, card = sides["cpu"], sides[str(dev)]
    import numpy as np

    def compare(a, b, path):
        if isinstance(a, dict):
            for key in a:
                compare(a[key], b[key], f"{path}/{key}")
            return
        if path.endswith("/policy"):
            ok = np.allclose(a, b, rtol=0, atol=1e-6)
        elif path.endswith(("/ret", "/root_value")):
            ok = np.allclose(a, b, rtol=0, atol=1e-5)
        elif path.endswith("/other"):
            ok = np.allclose(a, b, rtol=2.5e-7, atol=0)
        else:
            ok = np.array_equal(a, b)
        if not ok:
            fail(f"the playout-cap chunk's {path} on the card differs from the CPU's")

    compare(cpu, card, "")
    return {"is_full": cpu["trace"]["is_full"].tolist(), "sims": cpu["trace"]["sims"].tolist(),
            "rows": int(cpu["mat"]["mask"].sum() + cpu["flush"]["mask"].sum())}


# --- slice 8: batch-norm training, inference precision, serve/eval of a run --

# The precision phases' cuts (depth only, widths the defaults): 2-move
# chunks, 256 rows to start training, 4 learner steps in groups of 2.
PREC_STEPS, PREC_K = 4, 2
# tests/torch_parity.py's bf16 tolerances (a bf16 forward against another).
BF16_PROB_ATOL, BF16_VALUE_ATOL, BF16_VALUE_RTOL = 0.05, 0.2, 0.1
# tests/test_torch_learner.py's tolerances of one learner step.
LEARNER_LOSS_RTOL, LEARNER_MOMENT_RTOL = 1e-5, 1e-4


def precision_preset(label: str, norm: str, precision: str) -> str:
    """A tuned-preset artifact (schema `alphatriangle.tuned_preset.v1`) of
    the default board, net, search and TrainConfig with NORM_TYPE and
    INFERENCE_PRECISION set, as a user sets them for `cli train --preset
    PATH`; returns its path."""
    from alphatriangle_tpu_torch.config import (
        AlphaTriangleMCTSConfig,
        EnvConfig,
        ModelConfig,
        TrainConfig,
    )
    from alphatriangle_tpu_torch.config.presets import TUNED_PRESET_SCHEMA

    train = TrainConfig(RANDOM_SEED=0)
    if (train.SELF_PLAY_BATCH_SIZE, train.BATCH_SIZE, train.BUFFER_CAPACITY) != (512, 256, 250_000):
        fail("the default TrainConfig is not at 512 lanes, batch 256 and 250,000 slots")
    path = RUN_ROOT / f"{label}.tuned_preset.json"
    path.write_text(json.dumps({
        "schema": TUNED_PRESET_SCHEMA,
        "description": f"default widths, NORM_TYPE={norm}, INFERENCE_PRECISION={precision}",
        "configs": {
            "env": EnvConfig().model_dump(),
            "model": ModelConfig(NORM_TYPE=norm, INFERENCE_PRECISION=precision).model_dump(),
            "train": train.model_dump(),
            "mcts": AlphaTriangleMCTSConfig().model_dump(),
        },
    }))
    return str(path)


def running_stats(model) -> dict:
    return {n: b.detach().clone() for n, b in model.named_buffers() if ".running_" in n}


def train_precision_phase(torch, dev, kernels, label: str, norm: str, precision: str, mode: str) -> dict:
    """`cli train --preset PATH` at the default widths with NORM_TYPE and
    INFERENCE_PRECISION from the artifact, cut in depth only, in the fused
    megastep ("megastep"), the synchronous loop ("sync") or the
    overlapped loop with one producer stream ("async"). Every chunk must
    search with an `InferenceNet` of the run's precision, cast once per
    weights version across the streams (once per megastep in the
    megastep), the search kernels 16 + 2 times per searched move and
    `per_sample` once per megastep; a batch-norm run's running
    statistics must move and stay finite. Then one megastep, iteration
    or window of the overlapped loop under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from alphatriangle_tpu_torch.nn import precision as prec
    from alphatriangle_tpu_torch.rl.megastep import MegastepRunner

    path = precision_preset(label, norm, precision)
    args = ["--preset", path, "--rollout-chunk", str(TRAIN_CHUNK_MOVES), "--min-buffer",
            str(TRAIN_MIN_BUFFER), "--max-steps", str(PREC_STEPS), "--fused-learner-steps", str(PREC_K),
            "--no-tensorboard"]
    args += {"megastep": ["--fused-megastep"], "sync": [], "async": ["--async-rollouts", "--workers", "1"]}[mode]
    chunks, restore_chunks = watch_chunks()
    mega_casts, real_mega = [], MegastepRunner.run_megastep

    def run_megastep(self, *a, **kw):
        before = prec.InferenceNet.casts
        out = real_mega(self, *a, **kw)
        mega_casts.append(prec.InferenceNet.casts - before)
        return out

    MegastepRunner.run_megastep = run_megastep
    casts0 = prec.InferenceNet.casts
    try:
        run = train_cli(torch, kernels, label, args)
        casts = prec.InferenceNet.casts - casts0
        seen = check_chunks(chunks, label)
    finally:
        restore_chunks()
        MegastepRunner.run_megastep = real_mega
    loop, report, launches = run["loop"], run["report"], run["launches"]
    c = loop.c
    artifact = json.loads(Path(path).read_text())["configs"]
    def as_json(cfg):
        return json.loads(json.dumps(cfg.model_dump()))

    if as_json(c.model_config) != artifact["model"] or as_json(c.env_config) != artifact["env"]:
        fail(f"{label}: the run's net or board is not the artifact's")
    widths = ("SELF_PLAY_BATCH_SIZE", "BATCH_SIZE", "BUFFER_CAPACITY")
    if any(getattr(c.train_config, w) != artifact["train"][w] for w in widths):
        fail(f"{label}: the run is not at the artifact's widths")
    if loop.global_step != PREC_STEPS or report["mode"] != mode:
        fail(f"{label}: {loop.global_step} steps in mode {report['mode']}")
    searched = len(run["played"])
    check_search_launches(launches, searched, 0, (2, 1), label)
    megasteps = loop.megastep_iterations if mode == "megastep" else 0
    if launches["per_sample"] != megasteps:
        fail(f"{label}: {launches['per_sample']} per_sample launches in {megasteps} megasteps")
    for rec in chunks:
        model = rec["weights"].model
        if not isinstance(model, prec.InferenceNet) or model.precision != precision:
            fail(f"{label}: a chunk searched with {type(model).__name__}, not a {precision} copy")
    versions = seen["versions"]
    if mode == "megastep":
        # Warm-up chunks read the net's copy of version 0; each megastep casts its own.
        if mega_casts != [1] * loop.megastep_iterations or casts != loop.megastep_iterations + 1:
            fail(f"{label}: casts {casts}, per megastep {mega_casts}")
    elif casts != len(versions):
        fail(f"{label}: {casts} casts for the {len(versions)} weights versions chunks read")
    stats = running_stats(c.trainer.model)
    if norm == "batch":
        if not stats or not all(bool(torch.isfinite(v).all()) for v in stats.values()):
            fail(f"{label}: running statistics missing or not finite")
        moved = [n for n, v in stats.items()
                 if not torch.equal(v, torch.zeros_like(v) if n.endswith("mean") else torch.ones_like(v))]
        if len(moved) != len(stats):
            fail(f"{label}: {len(stats) - len(moved)} running statistics never moved")
    elif stats:
        fail(f"{label}: a {norm}-norm net holds running statistics")
    lanes = c.self_play.batch_size
    out = {
        "launches": launches, "searched_moves": searched, "casts": casts,
        "chunk_versions": versions, "steps": loop.global_step, "losses": report["losses"],
        "rows_ingested": loop.experiences_added, "peak_mem_gb": run["peak_mem_gb"],
        "wall_s": run["wall_s"], "run_s": loop.run_s,
        "running_stats": len(stats),
    }
    if mode == "megastep":
        mega = loop.timings["megastep_s"]
        out.update({
            "megasteps": loop.megastep_iterations, "megastep_casts": mega_casts,
            "megastep_ms": [t * 1e3 for t in mega], "megastep_ms_p50": statistics.median(mega) * 1e3,
            "megastep_moves_per_s_p50": lanes * TRAIN_CHUNK_MOVES / statistics.median(mega),
        })
        # The cast alone, between synchronisations, on the trained module.
        cast_ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prec.InferenceNet(c.trainer.model, c.model_config)
            torch.cuda.synchronize()
            cast_ms.append((time.perf_counter() - t0) * 1e3)
        out["cast_ms_p50"] = statistics.median(cast_ms)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            c.megastep.run_megastep(TRAIN_CHUNK_MOVES, PREC_K)
            torch.cuda.synchronize()
            prof_wall_ms = (time.perf_counter() - t0) * 1e3
        out["profile"] = read_profile(prof, TRAIN_STAGES, prof_wall_ms, out["megastep_ms_p50"])
        return out
    if mode == "sync":
        it_s, roll_s = loop.timings["iteration_s"], loop.timings["rollout_s"]
        steps_full = max(loop.steps_per_iteration)
        full_its = [t for t, n in zip(it_s, loop.steps_per_iteration) if n == steps_full]
        out.update({
            "iterations": loop.iterations, "steps_per_iteration": loop.steps_per_iteration,
            "iteration_ms_p50_full": statistics.median(full_its) * 1e3,
            "rollout_ms_p50": statistics.median(roll_s) * 1e3,
            "rollout_moves_per_s": lanes * TRAIN_CHUNK_MOVES / statistics.median(roll_s),
        })
        out["profile"] = profile_sync_iteration(torch, loop, steps_full, out["iteration_ms_p50_full"])
        return out
    if loop.producer_restarts or report["replay_ratio"] > c.train_config.REPLAY_RATIO:
        fail(f"{label}: {loop.producer_restarts} restarts, replay ratio {report['replay_ratio']}")
    out.update({
        "iterations": loop.iterations, "harvests_by_stream": loop.harvests_by_stream,
        "iteration_ms_p50": report["timings"]["iteration_s_p50"] * 1e3,
        "producer_chunk_ms_p50": report["timings"]["producer_chunk_s_p50"] * 1e3,
        "lane_moves_per_s_run": seen["lane_moves"] / loop.run_s,
        "replay_ratio": report["replay_ratio"],
    })
    # Two more steps of the same loop under the profiler: the busy share.
    loop.cfg = loop.cfg.model_copy(
        {"MAX_TRAINING_STEPS": PREC_STEPS + PREC_K, "ASYNC_CHUNK_SECONDS": None}
    )
    loop.stop_event.clear()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loop._run_async()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    busy = device_union(prof, set(STAGES) | set(TRAIN_STAGES))
    measured = busy["spans"] > 0
    out["profile"] = {
        "wall_ms": prof_wall_ms, "steps": loop.global_step - PREC_STEPS,
        "device_ms": busy["union_ms"] if measured else None,
        "device_busy_share": busy["union_ms"] / prof_wall_ms if measured else None,
    }
    return out


def serve_run_phase(torch, run: str) -> dict:
    """`cli serve --run-name` of a trained run (its configs.json and
    newest checkpoint), 64 slots x 64 simulations, 128 sessions of up to
    8 moves; once the server has restored its checkpoint a newer one is
    committed into the run, and `--reload-every 2` must swap it in. The
    report must name the run's precision and norm, and the search kernels
    launch 16 + 2 times per dispatch."""
    from alphatriangle_tpu_torch.config import PersistenceConfig
    from alphatriangle_tpu_torch.stats import CheckpointManager

    label = f"serve-run-{run}"
    mgr = CheckpointManager(
        PersistenceConfig(ROOT_DATA_DIR=str(RUN_ROOT / run), RUN_NAME=run), device="cpu",
        create_dirs=False,
    )
    first = mgr.latest_step()
    if first is None:
        fail(f"{label}: the run has no checkpoint")
    newer = first + 1
    err_path = RUN_ROOT / f"{label}.err"

    def commit_while_serving(proc):
        deadline = time.monotonic() + 300
        while "serve: step" not in (err_path.read_text() if err_path.exists() else ""):
            if proc.poll() is not None or time.monotonic() > deadline:
                return
            time.sleep(0.05)
        mgr.save(newer, mgr.restore().train_state)

    rc, report = run_cli(
        ["serve", "--run-name", run, "--root-dir", str(RUN_ROOT / run), "--slots", "64", "--sims", "64",
         "--sessions", "128", "--max-moves", "8", "--reload-every", "2", "--device", "cuda"],
        label, 600, on_start=commit_while_serving,
    )
    if rc != 0 or report["source"] != f"step {first}":
        fail(f"{label}: exit {rc}, served {report.get('source')!r}, want step {first}")
    if report["reloaded_steps"] != [newer] or report["serve_weight_reloads"] != 1:
        fail(f"{label}: reloaded {report['reloaded_steps']}, want [{newer}]")
    artifact = json.loads((mgr.config.get_run_base_dir() / "configs.json").read_text())["model"]
    if (report["inference_precision"], report["norm_type"]) != (
        artifact["INFERENCE_PRECISION"], artifact["NORM_TYPE"]
    ):
        fail(f"{label}: served {report['norm_type']}/{report['inference_precision']}, not the run's")
    n = report["serve_dispatches"]
    want = {"gather_rows": 16 * n, "backup_update": 2 * n, "per_sample": 0, "subtree_promote": 0}
    if report["kernel_launches"] != want:
        fail(f"{label}: launches {report['kernel_launches']} in {n} dispatches, want {want}")
    # The report's window fields are the last tick window's (`--tick-every`);
    # the dispatch p50 of the whole run is its flight ring's.
    from alphatriangle_tpu_torch.telemetry.flight import read_flight, summarize_flight

    serve_dir = Path(report["ledger"]).parent
    [row] = [r for r in summarize_flight(read_flight(serve_dir / "flight.jsonl"))
             if r["program"] == "serve/b64"]
    if row["count"] != n:
        fail(f"{label}: {row['count']} sealed serve/b64 dispatches in the flight ring, {n} served")
    return {
        "launches": report["kernel_launches"], "dispatches": n,
        "inference_precision": report["inference_precision"], "norm_type": report["norm_type"],
        "served_step": first, "reloaded_steps": report["reloaded_steps"],
        "dispatch_ms_p50": row["wall_s_p50"] * 1e3, "moves_per_s": report["moves_per_sec"],
        "sessions_served": report["sessions_served"],
        # The service's own telemetry (`--serve-run-name`'s default).
        "serve_run_dir": str(serve_dir),
    }


def serve_precision_phase(torch, dev, kernels, cycles: float) -> dict:
    """The serve default (64 slots x 64 simulations) at float32, bfloat16
    and int8 in this process, on the same weights (the bf16 net of seed
    0) and the same 64 sessions: `SERVE_DISPATCHES` rounds, each one
    dispatch of every service in a rotating order (the host's pace drifts
    within a call, so the three are timed side by side), 16 + 2 launches
    per dispatch; then one more dispatch of each under the profiler
    (`search.evaluate`'s device time), the bytes the search reads its
    weights from (float32: the module's parameters and buffers; otherwise
    the `InferenceNet`, and the JAX count of the leaf form), and for int8
    the dequantization's launches per evaluation (the kernel launches in
    a profile of one call, which must be one per row-length group) and
    its time, and its result bit-equal to the leaf-by-leaf form."""
    from torch.profiler import ProfilerActivity, profile

    from alphatriangle_tpu_torch import rng
    from alphatriangle_tpu_torch.config import AlphaTriangleMCTSConfig, EnvConfig, ModelConfig
    from alphatriangle_tpu_torch.env import TriangleEnv
    from alphatriangle_tpu_torch.features import FeatureExtractor
    from alphatriangle_tpu_torch.mcts import BatchedMCTS
    from alphatriangle_tpu_torch.nn import NeuralNetwork, precision as prec
    from alphatriangle_tpu_torch.serving import PolicyService

    names = ("float32", "bfloat16", "int8")
    serve_default_stats()
    env_cfg = EnvConfig()
    state = NeuralNetwork(ModelConfig(), env_cfg, seed=0, device="cpu").get_weights()
    services, launches, casts0 = {}, {}, prec.InferenceNet.casts
    for name in names:
        model_cfg = ModelConfig(INFERENCE_PRECISION=name)
        env = TriangleEnv(env_cfg, device=dev)
        extractor = FeatureExtractor(env, model_cfg)
        net = NeuralNetwork(model_cfg, env_cfg, state_dict=state, device=dev)
        mcts = BatchedMCTS(env, extractor, net.model, AlphaTriangleMCTSConfig(max_simulations=64), net.support)
        services[name] = PolicyService(env, extractor, net, mcts, slots=64, rng_seed=0)
        services[name].open_sessions(rng.split(rng.PRNGKey(11), 64))
        launches[name] = {k: 0 for k in kernels}
    moves = {name: 0 for name in names}
    for round_ in range(SERVE_DISPATCHES):
        for i in range(len(names)):
            name = names[(round_ + i) % len(names)]
            service = services[name]
            for s in service.sessions.live_sessions():
                service.request_move(s.sid)
            before = {k: kern.launches for k, kern in kernels.items()}
            results = service.dispatch()
            torch.cuda.synchronize()
            for k, kern in kernels.items():
                launches[name][k] += kern.launches - before[k]
            moves[name] += len(results)
            for r in results:  # a finished game's lane takes a fresh session
                if r["done"]:
                    service.close_session(r["sid"])
                    service.open_session(seed=1000 * round_ + r["slot"])
    out = {}
    for name in names:
        service = services[name]
        net, model = service.net, service.mcts.model
        n = service.dispatch_count
        for kname, per in PER_STEP["serve"].items():
            if launches[name][kname] != per * n:
                fail(f"serve-{name}: {kname} launched {launches[name][kname]} times in {n} dispatches")
        if name == "float32":
            if model is not net.model:
                fail("serve-float32: the search did not read the module itself")
            resident = sum(t.numel() * t.element_size() for t in net.model.state_dict().values())
            leaf_bytes = resident
        else:
            if not isinstance(model, prec.InferenceNet) or model.precision != name:
                fail(f"serve-{name}: the search did not read a {name} copy")
            resident = model.nbytes()
            leaf_bytes = prec.quantized_param_bytes(
                prec.cast_params_for_inference(net.model.state_dict(), net.model_config)
            )
        for field in ("visit_counts", "root_value", "root_prior"):
            if not bool(torch.isfinite(getattr(service.last_output, field)).all()):
                fail(f"serve-{name}: search output {field} is not finite")
        batch_s = sum(service.batch_ms) / 1e3
        out[name] = {
            "launches": launches[name], "dispatches": n,
            "dispatch_ms_p50": statistics.median(service.batch_ms),
            "dispatch_ms": list(service.batch_ms),
            "moves_per_s": moves[name] / batch_s,
            "resident_weight_bytes": resident, "leaf_form_bytes": leaf_bytes,
        }
    # One weights version each: one cast for bf16 and one for int8.
    if prec.InferenceNet.casts != casts0 + 2:
        fail(f"serve-precision: {prec.InferenceNet.casts - casts0} casts, want 2")
    for name in names:
        r = out[name]
        service = services[name]
        for s in list(service.sessions.live_sessions()):
            service.close_session(s.sid)
        r["profile"] = profile_dispatch(torch, service, r["dispatch_ms_p50"])
        evaluate = r["profile"]["stages"]["search.evaluate"]
        r["evaluate_device_ms_per_dispatch"] = evaluate["device_ms"]
    groups = services["int8"].mcts.model.params
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prec.dequantize_params(groups)
        torch.cuda.synchronize()
    # Kernel launches as the runtime saw them (the profiler may file a
    # window's first kernel under its buffer request).
    launched = sum(
        n for name, n in trace_of(prof).names.items() if name.startswith(("cudaLaunchKernel", "cuLaunchKernel"))
    )
    if launched != groups.launches:
        fail(f"serve-int8: a dequantization launched {launched} kernels, want {groups.launches}")
    out["int8"]["dequant_launches_per_evaluation"] = launched
    out["int8"]["dequant_us_per_evaluation"] = time_ms(lambda: prec.dequantize_params(groups), cycles) * 1e3
    net = services["int8"].net
    leaves = prec.cast_params_for_inference(net.model.state_dict(), net.model_config)
    by_leaf, packed = prec.dequantize_params(leaves), prec.dequantize_params(groups)
    if any(not torch.equal(by_leaf[k], packed[k]) for k in by_leaf):
        fail("serve-int8: the grouped dequantization differs from the leaf-by-leaf one")
    return out


def reference_precision_phase(torch, dev) -> dict:
    """Small, card against CPU: (1) the default net's int8 `q` / `scale`
    and their dequantization bit for bit; (2) one batch-norm learner step
    (f32 net, TF32 off): losses and TD errors within 1e-5 relative and
    running statistics within 1e-4 (`tests/test_torch_learner.py`'s
    LOSS_RTOL and MOMENT_RTOL); (3) a search under bf16 and under int8
    weights: root priors and values within the bf16 tolerances."""
    import numpy as np

    from alphatriangle_tpu_torch import rng
    from alphatriangle_tpu_torch.config import EnvConfig, ModelConfig, TrainConfig
    from alphatriangle_tpu_torch.env import TriangleEnv
    from alphatriangle_tpu_torch.features import FeatureExtractor
    from alphatriangle_tpu_torch.mcts import BatchedMCTS
    from alphatriangle_tpu_torch.nn import NeuralNetwork, precision as prec
    from alphatriangle_tpu_torch.rl import Trainer

    # (1) int8 leaves and their dequantization.
    cfg = ModelConfig(INFERENCE_PRECISION="int8")
    state = NeuralNetwork(ModelConfig(), EnvConfig(), seed=0, device="cpu").model.state_dict()
    cpu_leaves = prec.cast_params_for_inference(state, cfg)
    card_leaves = prec.cast_params_for_inference({k: v.to(dev) for k, v in state.items()}, cfg)
    quantized = 0
    for name, want in cpu_leaves.items():
        got = card_leaves[name]
        if prec.is_quantized_leaf(want):
            quantized += 1
            if not (torch.equal(got["q"].cpu(), want["q"]) and torch.equal(got["scale"].cpu(), want["scale"])):
                fail(f"reference precision: int8 leaf {name} differs between the card and the CPU")
        elif not torch.equal(got.cpu(), want):
            fail(f"reference precision: bf16 leaf {name} differs between the card and the CPU")
    cpu_deq = prec.QuantizedGroups(cpu_leaves).dequantize()
    card_deq = prec.QuantizedGroups(card_leaves).dequantize()
    if any(not torch.equal(card_deq[k].cpu(), v) for k, v in cpu_deq.items()):
        fail("reference precision: the dequantized weights differ between the card and the CPU")

    # (2) a batch-norm learner step.
    env_cfg, model_cfg, mcts_cfg = tiny_reference_configs()
    bn_cfg = model_cfg.model_copy(update={"NORM_TYPE": "batch"})
    pick = np.random.default_rng(3)
    n, adim = 16, env_cfg.action_dim
    policy = pick.random((n, adim)).astype(np.float32) ** 3
    batch = {
        "grid": pick.integers(-1, 2, (n, 1, env_cfg.ROWS, env_cfg.COLS)).astype(np.float32),
        "other_features": pick.random((n, bn_cfg.OTHER_NN_INPUT_FEATURES_DIM)).astype(np.float32),
        "policy_target": policy / policy.sum(-1, keepdims=True),
        "value_target": (pick.normal(size=n) * 6).astype(np.float32),
        "weights": pick.uniform(0.2, 1.0, n).astype(np.float32),
        "policy_weight": np.ones(n, np.float32),
    }
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    sides = {}
    try:
        for device in ("cpu", dev):
            trainer = Trainer(
                NeuralNetwork(bn_cfg, env_cfg, seed=3, device=device),
                TrainConfig(BATCH_SIZE=n, RANDOM_SEED=7, MAX_TRAINING_STEPS=10),
            )
            ((m, td),) = trainer.train_steps([batch])
            sides[str(device)] = (m, np.asarray(td), {k: v.cpu() for k, v in running_stats(trainer.model).items()})
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    (cm, ctd, cstats), (gm, gtd, gstats) = sides["cpu"], sides[str(dev)]
    loss_err = max(abs(gm[k] - cm[k]) / max(abs(cm[k]), 1e-12) for k in LOSS_KEYS)
    if loss_err > LEARNER_LOSS_RTOL or not np.allclose(gtd, ctd, rtol=LEARNER_LOSS_RTOL, atol=1e-6):
        fail(f"reference precision: the batch-norm step's losses differ by {loss_err:.2e} relative")
    stats_err = max(float((gstats[k] - v).abs().max()) for k, v in cstats.items())
    if not all(torch.allclose(gstats[k], v, rtol=LEARNER_MOMENT_RTOL, atol=1e-6) for k, v in cstats.items()):
        fail(f"reference precision: running statistics differ by {stats_err:.2e}")

    # (3) searches under reduced weights: the root evaluation and the search's values.
    search = {}
    net_cpu = NeuralNetwork(model_cfg, env_cfg, seed=3, device="cpu")
    for name in ("bfloat16", "int8"):
        cfg_p = model_cfg.model_copy(update={"INFERENCE_PRECISION": name})
        outs = {}
        for device in ("cpu", dev):
            env = TriangleEnv(env_cfg, device=device)
            net = NeuralNetwork(cfg_p, env_cfg, state_dict=net_cpu.get_weights(), device=device)
            mcts = BatchedMCTS(env, FeatureExtractor(env, cfg_p), net.inference_model(), mcts_cfg, net.support)
            out = mcts.search(env.reset(rng.split(rng.PRNGKey(4), 16)), rng.PRNGKey(5))
            outs[device] = (out.root_prior.cpu(), out.root_value.cpu())
        (cp, cv), (gp, gv) = outs["cpu"], outs[dev]
        prior_err, value_err = float((gp - cp).abs().max()), float((gv - cv).abs().max())
        if prior_err > BF16_PROB_ATOL or not torch.allclose(gv, cv, atol=BF16_VALUE_ATOL, rtol=BF16_VALUE_RTOL):
            fail(f"reference precision: {name} search differs (priors {prior_err:.2e}, values {value_err:.2e})")
        search[name] = {"root_prior_max_abs_err": prior_err, "root_value_max_abs_err": value_err}
    return {
        "int8_leaves": quantized, "bn_step_loss_max_rel_err": loss_err,
        "bn_running_stats_max_abs_err": stats_err, "search": search,
    }


# --- slice 9: the serving bucket ladder and the league flywheel ----------

LADDER, LADDER_BASE, LADDER_SUSTAIN = "16,32,64", 16, 2
LADDER_SESSIONS, LADDER_CONCURRENCY, LADDER_MAX_MOVES = 160, 64, 8
# The league phase: a pool of two checkpoints written by `cli train`,
# then `cli league` against it (depth cuts only: 4 learner steps).
LEAGUE_POOL_STEPS, LEAGUE_POOL_FREQ = 4, 2
LEAGUE_STEPS, LEAGUE_SLOTS, LEAGUE_GAMES, LEAGUE_MAX_MOVES = 1, 8, 4, 24


def build_listing() -> tuple:
    """The kernel libraries on disk and the ones loaded in this process."""
    from alphatriangle_tpu_torch.ops import KERNELS
    from alphatriangle_tpu_torch.ops._cuda import BUILD_DIR

    return (
        sorted(p.name for p in BUILD_DIR.iterdir()),
        {name: id(kern._lib) for name, kern in KERNELS.items()},
    )


def ladder_service(torch, dev, reuse: bool = False, ladder: str = LADDER):
    """The serve default (`EnvConfig()`, `ModelConfig()`, seed 0, 64
    simulations) on a rung ladder starting at its lowest rung."""
    from alphatriangle_tpu_torch.config import AlphaTriangleMCTSConfig, EnvConfig, ModelConfig
    from alphatriangle_tpu_torch.env import TriangleEnv
    from alphatriangle_tpu_torch.features import FeatureExtractor
    from alphatriangle_tpu_torch.mcts import BatchedMCTS
    from alphatriangle_tpu_torch.nn import NeuralNetwork
    from alphatriangle_tpu_torch.serving import PolicyService

    serve_default_stats()
    env_cfg, model_cfg = EnvConfig(), ModelConfig()
    mcts_cfg = AlphaTriangleMCTSConfig(max_simulations=64, tree_reuse=reuse)
    env = TriangleEnv(env_cfg, device=dev)
    extractor = FeatureExtractor(env, model_cfg)
    net = NeuralNetwork(model_cfg, env_cfg, seed=0, device=dev)
    mcts = BatchedMCTS(env, extractor, net.model, mcts_cfg, net.support)
    base = int(ladder.split(",")[0])
    return PolicyService(
        env, extractor, net, mcts, slots=base, rng_seed=0, ladder=ladder, sustain=LADDER_SUSTAIN
    )


def record_promotions(store: dict, lanes: int):
    """Wrap the search's `subtree_promote` so that the operands of its
    first call at `lanes` lanes are kept (device copies, taken before the
    call); returns the function that restores it."""
    from alphatriangle_tpu_torch.mcts import search as search_mod

    real = search_mod.subtree_promote

    def recorded(*args, **kwargs):
        if "args" not in store and args[0].shape[0] == lanes:
            store["args"] = [x.clone() if hasattr(x, "clone") else x for x in args]
            store["kwargs"] = dict(kwargs)
        return real(*args, **kwargs)

    search_mod.subtree_promote = recorded
    return lambda: setattr(search_mod, "subtree_promote", real)


def record_search_kernels(store: dict, lanes: tuple):
    """Wrap the search's `gather_rows` and `backup_update` so that the
    operands of each one's first call at each lane count in `lanes` are
    kept in `store[(name, lanes)]` (device copies taken before the call,
    so the in-place backup keeps its inputs); returns the function that
    restores both."""
    from alphatriangle_tpu_torch.mcts import search as search_mod

    real = {name: getattr(search_mod, name) for name in ("gather_rows", "backup_update")}

    def wrap(name):
        def recorded(*args, **kwargs):
            key = (name, int(args[0].shape[0]))
            if key[1] in lanes and key not in store:
                store[key] = [x.clone() for x in args]
            return real[name](*args, **kwargs)

        return recorded

    for name in real:
        setattr(search_mod, name, wrap(name))
    return lambda: [setattr(search_mod, name, fn) for name, fn in real.items()]


def hold_search_kernels(torch, store: dict, lanes: tuple, label: str) -> dict:
    """Each recorded call of `record_search_kernels` through the kernel and
    its plain version: bit-equal (`bits_equal`) at every lane count in
    `lanes`, else the phase fails. Returns the shapes held per lane count."""
    import importlib

    g = importlib.import_module("alphatriangle_tpu_torch.ops.gather_rows")
    mb = importlib.import_module("alphatriangle_tpu_torch.ops.mcts_backup")
    held = {}
    for b in lanes:
        for name in ("gather_rows", "backup_update"):
            if (name, b) not in store:
                fail(f"{label}: no {name} call was recorded at {b} lanes")
        stats, node = store[("gather_rows", b)]
        got, want = g.gather_rows_cuda(stats, node), g.gather_rows_plain(stats, node)
        torch.cuda.synchronize()
        if not bits_equal(torch, got, want):
            fail(f"{label}: gather_rows kernel differs from its plain version at {b} lanes")
        args = store[("backup_update", b)]
        got = mb.backup_update_cuda(*[x.clone() for x in args])
        want = mb.backup_update_plain(*[x.clone() for x in args])
        torch.cuda.synchronize()
        for plane, x, y in zip(PLANES, got, want):
            if not bits_equal(torch, x, y):
                fail(f"{label}: backup_update kernel differs from its plain version on {plane} "
                     f"at {b} lanes")
        planes = args[0].shape
        held[b] = {
            "gather_rows": {"B": b, "N": int(stats.shape[1]), "K": int(stats.shape[2]),
                            "W": int(node.shape[1])},
            "backup_update": {"B": b, "N": int(planes[1]), "A": int(planes[2]),
                              "W": int(args[4].shape[1]), "D": int(args[8].shape[2])},
        }
    return held


def drive_tracked(torch, service, dispatches: int, churn: bool, switch: tuple) -> tuple:
    """`tests/test_torch_ladder.py::drive_session` on the card: one tracked
    session in lane 0 with fixed dispatch keys, with or without a churning
    crowd, `switch=(i, rung)` forcing a rung switch after dispatch i.
    Returns its (actions, scores)."""
    from alphatriangle_tpu_torch import rng

    tracked = service.open_session(rng.PRNGKey(42))
    if tracked.slot != 0:
        fail("serve-ladder: the tracked session is not in lane 0")
    if churn:
        for o in service.open_sessions(rng.split(rng.PRNGKey(7), 12)):
            service.request_move(o.sid)
    actions, scores = [], []
    for i in range(dispatches):
        service.request_move(tracked.sid)
        results = service.dispatch(rng.PRNGKey(100 + i))
        mine = next(r for r in results if r["sid"] == tracked.sid)
        actions.append(mine["action"])
        scores.append(mine["score"])
        if churn:
            for r in results:
                if r["sid"] == tracked.sid:
                    continue
                if r["done"] or i % 2:
                    service.close_session(r["sid"])
                else:
                    service.request_move(r["sid"])
            n_fresh = min(6, service.sessions.free_count - 1)
            if n_fresh > 0:
                for o in service.open_sessions(rng.split(rng.PRNGKey(1007 + i), n_fresh)):
                    service.request_move(o.sid)
        if i == switch[0]:
            service._switch_rung(switch[1], "forced")
        if mine["done"]:
            break
    return actions, scores


def serve_ladder_phase(torch, dev, kernels, reuse: bool = False) -> dict:
    """`PolicyService(slots=16, ladder="16,32,64", sustain=2)` at the serve
    default's widths: every rung warmed, then a storm of 160 sessions at
    concurrency 64 with 8 moves each through `run_simulated_load`. Every
    session served, the ladder walked up to 64 and back down on the drain,
    16 + 2 launches (+ 1 promotion under reuse) in every dispatch at
    whatever rung, no kernel library built or loaded after the warm-up,
    every carried tree dropped at each switch. Under reuse, the promotion's
    reorder at 32 lanes (recorded from the storm) is bit-equal to its plain
    version. Without reuse, a tracked session plays the same game solo as in
    a churning crowd switched at the same dispatch."""
    import importlib

    label = "serve-ladder-reuse" if reuse else "serve-ladder"
    service = ladder_service(torch, dev, reuse)
    warm_ms = {}
    for rung in service.ladder.rungs:
        t0 = time.perf_counter()
        service.warm_rung(rung)
        warm_ms[rung] = (time.perf_counter() - t0) * 1e3
    listing = build_listing()
    per_dispatch, switches = [], []
    real_dispatch, real_switch = service.dispatch, service._switch_rung

    def dispatch(*args, **kwargs):
        rung = service.sessions.slots
        before = {name: kern.launches for name, kern in kernels.items()}
        states = service.sessions.states
        valid = service.env.valid_action_mask(states).cpu()
        done = states.done.cpu()
        t0 = time.perf_counter()
        results = real_dispatch(*args, **kwargs)
        ms = (time.perf_counter() - t0) * 1e3
        for r in results:
            if done[r["slot"]] or not valid[r["slot"], r["action"]]:
                fail(f"{label}: served action {r['action']} is not valid for lane {r['slot']}")
        if not bool(torch.isfinite(service.last_output.root_value).all()):
            fail(f"{label}: non-finite root values at rung {rung}")
        delta = {name: kern.launches - before[name] for name, kern in kernels.items()}
        want = {"gather_rows": 16, "backup_update": 2, "per_sample": 0, "subtree_promote": int(reuse)}
        if delta != want:
            fail(f"{label}: a dispatch at rung {rung} launched {delta}, want {want}")
        per_dispatch.append({"rung": rung, "ms": ms, "served": len(results),
                             "after_switch": bool(switches) and switches[-1]["dispatch"] == service.dispatch_count - 1})
        return results

    def switch(new_rung, reason):
        old = service.sessions.slots
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_switch(new_rung, reason)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if service._carry_ok.shape != (new_rung,) or service._carry_ok.any():
            fail(f"{label}: carried trees survived the switch {old} -> {new_rung}")
        if reuse and (service._carried.valid.shape[0] != new_rung or bool(service._carried.valid.any())):
            fail(f"{label}: the carried trees at {new_rung} lanes are not empty")
        switches.append({"dispatch": service.dispatch_count, "from": old, "to": new_rung, "ms": ms})

    service.dispatch, service._switch_rung = dispatch, switch
    promoted, searched = {}, {}
    restore = record_promotions(promoted, 32) if reuse else None
    restore_search = record_search_kernels(searched, service.ladder.rungs)
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels.values():
        kern.launches = 0
    from alphatriangle_tpu_torch.serving import run_simulated_load

    t0 = time.perf_counter()
    stats = run_simulated_load(
        service, total_sessions=LADDER_SESSIONS, concurrency=LADDER_CONCURRENCY,
        max_moves=LADDER_MAX_MOVES, seed=0,
    )
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {name: kern.launches for name, kern in kernels.items()}
    restore_search()
    if restore is not None:
        restore()
    rungs = [d["rung"] for d in per_dispatch]
    if stats["sessions_served"] != LADDER_SESSIONS:
        fail(f"{label}: {stats['sessions_served']} of {LADDER_SESSIONS} sessions served")
    if service.rung_switches < 2 or max(rungs) != 64 or service.sessions.slots >= 64:
        fail(f"{label}: the ladder did not walk up to 64 and back down ({service.rung_switches} "
             f"switches, rungs {rungs}, ending at {service.sessions.slots})")
    if build_listing() != listing:
        fail(f"{label}: a kernel library was built or loaded after the warm-up")
    if not len(per_dispatch) == stats["dispatches"] == service.dispatch_count:
        fail(f"{label}: {len(per_dispatch)} dispatches seen, {stats['dispatches']} run")
    report = {
        "launches": launches,
        "dispatches": stats["dispatches"],
        "moves_served": stats["moves_served"],
        "sessions_served": stats["sessions_served"],
        "moves_per_s": stats["moves_served"] / wall_s,
        "wall_s": wall_s,
        "rung_switches": service.rung_switches,
        "rungs": rungs,
        "switches": switches,
        "warm_ms": warm_ms,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
        "by_rung": {
            rung: {
                "dispatches": sum(1 for d in per_dispatch if d["rung"] == rung),
                "dispatch_ms_p50": statistics.median([d["ms"] for d in per_dispatch if d["rung"] == rung]),
                "first_after_switch_ms": [d["ms"] for d in per_dispatch if d["rung"] == rung and d["after_switch"]],
                "migration_ms": [s["ms"] for s in switches if s["to"] == rung],
            }
            for rung in sorted(set(rungs))
        },
        "kernels_held_bit_equal": hold_search_kernels(torch, searched, service.ladder.rungs, label),
    }
    if reuse:
        if "args" not in promoted:
            fail(f"{label}: no promotion ran at 32 lanes")
        sr = importlib.import_module("alphatriangle_tpu_torch.ops.subtree_reuse")
        args, kw = promoted["args"], promoted["kwargs"]
        e_visits, e_value, e_reward, children, prior, valid_p, _terminal, actions = args[:8]
        order, _, keep, new_children, _, retained = sr.promotion_plan(
            children, actions, kw["max_retained"], kw["bfs_rounds"]
        )
        planes = (e_visits, e_value, e_reward, new_children, prior, valid_p)
        got = sr.reorder_planes_cuda(order, retained, planes)
        want = sr.reorder_planes_plain(order, keep, planes)
        torch.cuda.synchronize()
        if not all(bits_equal(torch, x, y) for x, y in zip(got, want)):
            fail(f"{label}: the promotion's reorder differs from its plain version at 32 lanes")
        report["promote_at_32_lanes"] = {
            "bit_equal": True, "retained_rows": int(retained.sum()),
            "max_abs_err": max(float((x - y).abs().max()) for x, y in zip(got, want)),
        }
    else:
        solo = drive_tracked(torch, ladder_service(torch, dev, ladder="16,32"), 10, False, (2, 32))
        crowd = drive_tracked(torch, ladder_service(torch, dev, ladder="16,32"), 10, True, (2, 32))
        if solo != crowd:
            fail(f"{label}: the tracked session played another game in the crowd: {solo} vs {crowd}")
        if len(solo[0]) < 4:
            fail(f"{label}: the tracked game ended before it ran at the new width")
        report["lane_isolation_moves"] = len(solo[0])
    return report


def league_width_kernels(torch, dev) -> dict:
    """The gather and the backup at the league service's widths: an
    in-process service of `LEAGUE_SLOTS` lanes at the league run's configs
    (`EnvConfig()`, `ModelConfig()`, 64 simulations) serves one move of a
    full slot array; the operands of its first gather and backup are held
    bit-equal to their plain versions."""
    from alphatriangle_tpu_torch import rng

    service = ladder_service(torch, dev, ladder=str(LEAGUE_SLOTS))
    searched = {}
    restore = record_search_kernels(searched, (LEAGUE_SLOTS,))
    try:
        for s in service.open_sessions(rng.split(rng.PRNGKey(11), LEAGUE_SLOTS)):
            service.request_move(s.sid)
        if len(service.dispatch(rng.PRNGKey(12))) != LEAGUE_SLOTS:
            fail(f"league: the {LEAGUE_SLOTS}-lane service did not serve every lane")
    finally:
        restore()
    return hold_search_kernels(torch, searched, (LEAGUE_SLOTS,), "league")


def league_phase(torch, dev) -> dict:
    """`cli train` (the synchronous loop at the default widths and the train
    phases' depth cuts) writes a pool of two checkpoints; `cli league
    --pool-from` it at mix 1.0 with a permissive promotion gate. Exit 0, a
    pool of at least 2, a round and a promotion, every round's rows the live
    side's moves less the stale ones, `league.jsonl` replayed to the
    report's ratings, 16 + 2 launches per league dispatch (the league
    command's own counts: with mix 1.0 every search is a league dispatch).
    Both commands run in this process."""
    from alphatriangle_tpu_torch.league import LIVE_ID, LeaguePool
    from alphatriangle_tpu_torch.telemetry.ledger import read_ledger

    label = "league"
    held = league_width_kernels(torch, dev)
    torch.cuda.empty_cache()
    root = str(RUN_ROOT / label)
    t0 = time.perf_counter()
    rc, pool_report = cli_in_process([
        "train", "--device", "cuda", "--root-dir", root, "--run-name", "league-pool",
        "--no-auto-resume", "--no-tensorboard", "--max-steps", str(LEAGUE_POOL_STEPS),
        "--checkpoint-freq", str(LEAGUE_POOL_FREQ), "--rollout-chunk", str(TRAIN_CHUNK_MOVES),
        "--min-buffer", str(TRAIN_MIN_BUFFER),
    ], "league-pool")
    pool_s = time.perf_counter() - t0
    if rc != 0 or pool_report["steps"] != LEAGUE_POOL_STEPS:
        fail(f"{label}: the pool run exited {rc} at step {pool_report.get('steps')}")
    pool_moves = sum(1 for _ in pool_report["rows_per_iteration"]) * TRAIN_CHUNK_MOVES
    check_launches(pool_report["kernel_launches"], pool_moves, "league-pool")
    t0 = time.perf_counter()
    rc, report = cli_in_process([
        "league", "--device", "cuda", "--root-dir", root, "--pool-from", "league-pool",
        "--run-name", "league", "--steps", str(LEAGUE_STEPS), "--mix", "1.0",
        "--slots", str(LEAGUE_SLOTS), "--games", str(LEAGUE_GAMES), "--max-moves", str(LEAGUE_MAX_MOVES),
        "--promotion-games", "1", "--promotion-win-rate", "0.0", "--min-buffer", str(TRAIN_MIN_BUFFER),
    ], "league")
    league_s = time.perf_counter() - t0
    if rc != 0 or report["exit"] != 0 or report["status"] != "completed":
        fail(f"{label}: exit {rc}, status {report.get('status')}, error {report.get('error')}")
    if report["pool_size"] < 2 or report["league_rounds"] < 1 or report["promotions"] < 1:
        fail(f"{label}: pool {report['pool_size']}, rounds {report['league_rounds']}, "
             f"promotions {report['promotions']}")
    if report["steps"] != LEAGUE_STEPS:
        fail(f"{label}: stopped at step {report['steps']}")
    for r in report["league_records"]:
        if r["moves_ingested"] != r["live_moves"] - r["stale_dropped"]:
            fail(f"{label}: round {r['round']} ingested {r['moves_ingested']} rows of "
                 f"{r['live_moves']} live moves less {r['stale_dropped']} stale")
    pool = LeaguePool(report["league_jsonl"])
    if {m: round(pool.rating(m), 2) for m in pool.member_ids()} != report["ratings"] or round(
        pool.rating(LIVE_ID), 2
    ) != report["live_elo"]:
        fail(f"{label}: league.jsonl does not replay to the report's ratings")
    ledgered = [r for r in read_ledger(report["ledger"]) if r.get("kind") == "league"]
    if len(ledgered) != report["league_rounds"] or ledgered != report["league_records"]:
        fail(f"{label}: {len(ledgered)} league records in {report['ledger']} for "
             f"{report['league_rounds']} rounds")
    launches = report["kernel_launches"]
    dispatches = report["league_dispatches"]
    want = {"gather_rows": 16 * dispatches, "backup_update": 2 * dispatches, "per_sample": 0,
            "subtree_promote": 0}
    if launches != want or dispatches == 0:
        fail(f"{label}: launches {launches} in {dispatches} league dispatches, want {want}")
    # Device stats (the training default): one record an iteration in both
    # runs; the pool's search legs count its simulations; the league's
    # serve legs count every league dispatch's 64 simulations a lane.
    sims = 64
    ds = {}
    for name, rep_, path in (
        ("league-pool", pool_report, Path(pool_report["run_dir"]) / "metrics.jsonl"),
        ("league", report, Path(report["ledger"])),
    ):
        records = [r for r in read_ledger(path) if r.get("kind") == "device_stats"]
        ticks = rep_["iterations"] + rep_["warmup_chunks"]
        hist = {leg: sum(sum(r[leg]["depth_hist"]) for r in records if r.get(leg)) for leg in ("search", "serve")}
        if len(records) != ticks or hist["search"] != rep_["simulations"]:
            fail(f"{name}: {len(records)} device_stats records for {ticks} iterations, search legs "
                 f"counting {hist['search']} of {rep_['simulations']} simulations")
        ds[name] = {"records": len(records), **hist}
    if ds["league"]["serve"] != dispatches * LEAGUE_SLOTS * sims:
        fail(f"{label}: serve legs count {ds['league']['serve']} simulations for {dispatches} "
             f"dispatches of {LEAGUE_SLOTS} x {sims}")
    return {
        "device_stats": ds,
        "launches": launches,
        "dispatches": dispatches,
        "pool_launches": pool_report["kernel_launches"],
        "pool_s": pool_s,
        "league_s": league_s,
        "rounds": report["league_rounds"],
        "rounds_per_s": report["league_rounds_per_s"],
        "ingested_moves": report["league_moves_ingested"],
        "ingested_moves_per_s": report["league_ingested_moves_per_s"],
        "stale_dropped": report["stale_dropped"],
        "dispatch_ms_p50": report["league_dispatch_ms_p50"],
        "round_s": report["league_round_s"],
        "pool_size": report["pool_size"],
        "promotions": report["promotions"],
        "ratings": report["ratings"],
        "steps": report["steps"],
        "iteration_s_p50": report["timings"]["iteration_s_p50"],
        "kernels_held_bit_equal": held,
        "ledger_league_records": len(ledgered),
    }


# --- slice 10: the serving fleet -------------------------------------------

# `cli fleet` at the serve default's widths (`EnvConfig()`, `ModelConfig()`,
# no configs.json, 64 simulations): 2 replicas on the ladder 4/8/16 from 16.
FLEET_REPLICAS, FLEET_SLOTS, FLEET_BUCKETS, FLEET_SIMS = 2, 16, "4,8,16", 64
FLEET_REQUESTS, FLEET_CONCURRENCY, FLEET_MAX_MOVES = 64, 16, 8
# The chaos schedule: one `hang-serve` at the 3rd dispatch of the first
# replica to reach it (before the ladder's window of 3 dispatches can
# walk it off 16 slots), holding the ~8 requests routed to it until its
# watchdog exits 113 ten seconds on; a rolling reload once 8 requests
# ended (the hung replica's drain fails when it dies); a SIGKILL once 60
# ended, which those held requests keep after the 113 exit.
FLEET_RELOAD_AFTER, FLEET_HANG_AT, FLEET_KILL_AFTER = 8, 2, 60
# The in-process replica: episodes of 8 moves filling each rung of the
# fleet's ladder in turn (16, 8, 4): every width a replica may serve at.
FLEET_INPROC_WIDTHS = tuple(sorted((int(b) for b in FLEET_BUCKETS.split(",")), reverse=True))
# A guard that makes a process's imports of torch, numpy or JAX raise:
# the fleet parent and the run readers must run on the standard library.
_NO_TORCH_PARENT = (
    "import builtins, sys\n"
    "_real = builtins.__import__\n"
    "def _guard(name, *a, **k):\n"
    "    if name.split('.')[0] in ('torch', 'numpy', 'jax'):\n"
    "        raise ImportError('a torch-free process imported ' + name)\n"
    "    return _real(name, *a, **k)\n"
    "builtins.__import__ = _guard\n"
    "from alphatriangle_tpu_torch.cli import main\n"
)


def fleet_events(path: Path) -> list:
    from alphatriangle_tpu_torch.telemetry.ledger import read_ledger

    return [e for e in read_ledger(path) if e.get("kind") == "fleet"]


def check_fleet_chain(events: list, kind: str, label: str) -> dict:
    """The chain `cli fleet`'s chaos leaves on fleet.jsonl, in order: the
    hung replica's death with 113 and a dispatch-hung verdict naming its
    serve program, its respawn onto 8 slots, its ready line, its
    re-admission; a chaos kill, its death and its respawn; the rolling
    reload's replies with no recompile; every ready line on the card.
    Returns the chain's figures."""
    names = [e["event"] for e in events]
    wedge = next((i for i, e in enumerate(events) if e["event"] == "death" and e.get("rc") == 113), None)
    if wedge is None:
        fail(f"{label}: no death with exit 113 on fleet.jsonl: "
             f"{[(e.get('replica'), e.get('rc'), e.get('verdict')) for e in events if e['event'] == 'death']}")
    death = events[wedge]
    victim = death["replica"]
    if death.get("verdict") != "dispatch-hung" or death.get("family") != "serve" or death.get(
        "program"
    ) != f"serve/b{FLEET_SLOTS}":
        fail(f"{label}: the 113 death reads {death.get('verdict')} / {death.get('program')}")
    # In order, with other events (a chaos kill of the warming respawn,
    # say) allowed between: respawn at 8 slots -> ready -> re-admission.
    mine = [e for e in events[wedge + 1:] if e.get("replica") == victim]
    steps, found = ("respawn", "replica-ready", "readmit"), []
    for e in mine:
        if len(found) < len(steps) and e["event"] == steps[len(found)]:
            found.append(e)
    if len(found) < len(steps):
        fail(f"{label}: after its 113 death {victim} went {[e['event'] for e in mine]}, "
             "not respawn -> ready -> readmit")
    respawn, ready, readmit = found
    if respawn.get("slots") != 8 or ready.get("slots") != 8:
        fail(f"{label}: the quarantined respawn serves {respawn.get('slots')} slots, want 8")
    kill = next((i for i, e in enumerate(events) if e["event"] == "chaos-kill"), None)
    if kill is None:
        fail(f"{label}: no chaos-kill on fleet.jsonl")
    killed = events[kill]["replica"]
    after = [e["event"] for e in events[kill:] if e.get("replica") == killed]
    if "death" not in after or "respawn" not in after[after.index("death"):]:
        fail(f"{label}: the chaos-killed {killed} went {after}, not death -> respawn")
    reloaded = [e for e in events if e["event"] == "replica-reloaded"]
    if not reloaded or any(e.get("recompiles") != 0 for e in reloaded):
        fail(f"{label}: rolling reload replies {[(e['replica'], e.get('recompiles')) for e in reloaded]}")
    start = names.index("reload-start")
    for e in events:
        if e["event"] == "reload-failed" and not any(
            d["event"] == "death" and d.get("replica") == e["replica"] for d in events[start:]
        ):
            fail(f"{label}: the live replica {e['replica']} failed its reload: {e.get('error')}")
    if "reload-done" not in names:
        fail(f"{label}: the rolling reload never completed")
    for e in events:
        if e["event"] == "replica-ready" and (e.get("device") != kind or e.get("warm_aot") is not True):
            fail(f"{label}: {e['replica']} reported ready on {e.get('device')} (warm {e.get('warm_aot')})")
    return {
        "wedged_replica": victim, "wedged_program": death["program"],
        "wedge_to_readmit_s": readmit["time"] - death["time"],
        "killed_replica": killed, "replicas_reloaded": [e["replica"] for e in reloaded],
    }


def fleet_figures(events: list, run_dir: Path) -> dict:
    """Seconds from each spawn to its ready line and from each death to the
    re-admission that follows it, and each replica's dispatch p50 per serve
    program (its flight ring's sealed walls of `serve/b<slots>`, every
    incarnation), with the count of seals behind each."""
    from alphatriangle_tpu_torch.telemetry.flight import read_flight

    spawn_to_ready, death_to_readmit = [], []
    for i, e in enumerate(events):
        later = [x for x in events[i + 1:] if x.get("replica") == e.get("replica")]
        if e["event"] in ("spawn", "respawn"):
            ready = next((x for x in later if x["event"] == "replica-ready"), None)
            if ready is not None:
                spawn_to_ready.append({"replica": e["replica"], "event": e["event"], "slots": e["slots"],
                                       "s": ready["time"] - e["time"]})
        if e["event"] == "death":
            readmit = next((x for x in later if x["event"] == "readmit"), None)
            death_to_readmit.append({"replica": e["replica"], "rc": e.get("rc"),
                                     "s": None if readmit is None else readmit["time"] - e["time"]})
    dispatch_ms_p50 = {}
    for rdir in sorted(run_dir.glob("replica_*")):
        walls = {}
        for r in read_flight(rdir / "flight.jsonl"):
            if r.get("phase") == "seal" and r.get("family") == "serve" and r.get("ok", True):
                walls.setdefault(r["program"], []).append(r["wall_s"] * 1e3)
        dispatch_ms_p50[rdir.name[len("replica_"):]] = {
            program: {"p50": statistics.median(w), "n": len(w)}
            for program, w in sorted(walls.items(), key=lambda kv: -int(kv[0].split("/b")[-1]))
        }
    return {"spawn_to_ready": spawn_to_ready, "death_to_readmit": death_to_readmit,
            "replica_dispatch_ms_p50": dispatch_ms_p50}


def fleet_cli_part(torch, kind: str) -> dict:
    """(a) `cli fleet --smoke --device cuda` in a process whose imports of
    torch, numpy and JAX raise, its replicas on the card, with the chaos
    schedule above. Exit 0, nothing lost, every request completed or shed,
    the chain on fleet.jsonl, fleet.prom and an SLO status."""
    label = "fleet"
    torch.cuda.empty_cache()  # the card's memory for the replicas
    root = RUN_ROOT / label
    argv = [
        "fleet", "--smoke", "--device", "cuda", "--root-dir", str(root), "--run-name", label,
        "--replicas", str(FLEET_REPLICAS), "--slots", str(FLEET_SLOTS), "--buckets", FLEET_BUCKETS,
        "--sims", str(FLEET_SIMS), "--requests", str(FLEET_REQUESTS),
        "--concurrency", str(FLEET_CONCURRENCY), "--max-moves", str(FLEET_MAX_MOVES),
        "--reload-after", str(FLEET_RELOAD_AFTER), "--chaos-kill-after", str(FLEET_KILL_AFTER),
        "--replica-dispatch-min-deadline", "10", "--replica-dispatch-first-deadline", "300",
        "--replica-watchdog-poll", "0.5", "--backoff-base", "0.5", "--quarantine-after", "1",
        "--settle", "120",
    ]
    env = {**os.environ, "ALPHATRIANGLE_FAULTS": f"hang-serve@after={FLEET_HANG_AT}",
           "ALPHATRIANGLE_FAULT_STATE_DIR": str(root / "faults")}
    out_path, err_path = RUN_ROOT / f"{label}.out", RUN_ROOT / f"{label}.err"
    t0 = time.perf_counter()
    with open(out_path, "w") as out, open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", _NO_TORCH_PARENT + f"sys.exit(main({argv!r}))"],
            cwd=ROOT, stdout=out, stderr=err, text=True, env=env,
        )
        try:
            rc = proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall_s = time.perf_counter() - t0
    lines = out_path.read_text().strip().splitlines()
    try:
        report = json.loads(lines[-1])
    except (IndexError, ValueError):
        fail(f"{label}: exit {rc} without a JSON report; stderr: {err_path.read_text()[-3000:]}")
    if rc != 0:
        fail(f"{label}: exit {rc}; stderr: {err_path.read_text()[-3000:]}")
    if report["lost"] != 0 or not (
        report["completed"] + report["shed"] == report["terminal"] == report["requests"] == FLEET_REQUESTS
    ):
        fail(f"{label}: lost {report['lost']}, completed {report['completed']} + shed {report['shed']} "
             f"of {report['terminal']} terminal, {report['requests']} requests")
    run_dir = Path(report["ledger"]).parent
    events = fleet_events(run_dir / "fleet.jsonl")
    chain = check_fleet_chain(events, kind, label)
    if not (run_dir / "fleet.prom").exists() or report.get("slo") not in ("ok", "burning", "no-data"):
        fail(f"{label}: fleet.prom missing or no SLO status ({report.get('slo')})")
    if not (root / "faults" / "hang-serve.fired").exists():
        fail(f"{label}: the hang-serve fault never fired")
    return {"report": report, "chain": chain, "wall_s": wall_s, **fleet_figures(events, run_dir)}


def fleet_inproc_part(torch, dev, kernels) -> dict:
    """(b) In this process on the card: a `ReplicaServer` of the serve
    default at each rung of the fleet's ladder (16, 8, 4 slots), each fed
    a pipe of episode requests that fill its slots. 16 gathers and 2
    backups per dispatch, no PER count, no reorder; the first gather and
    backup at each width bit-equal to their plain versions."""
    import io

    from alphatriangle_tpu_torch.config import AlphaTriangleMCTSConfig, EnvConfig, ModelConfig
    from alphatriangle_tpu_torch.env import TriangleEnv
    from alphatriangle_tpu_torch.features import FeatureExtractor
    from alphatriangle_tpu_torch.mcts import BatchedMCTS
    from alphatriangle_tpu_torch.nn import NeuralNetwork
    from alphatriangle_tpu_torch.serving import PolicyService, build_serve_telemetry
    from alphatriangle_tpu_torch.serving.replica import ReplicaServer

    label = "fleet-inproc"
    serve_default_stats()
    env_cfg, model_cfg = EnvConfig(), ModelConfig()
    env = TriangleEnv(env_cfg, device=dev)
    extractor = FeatureExtractor(env, model_cfg)
    net = NeuralNetwork(model_cfg, env_cfg, seed=0, device=dev)
    mcts = BatchedMCTS(env, extractor, net.model, AlphaTriangleMCTSConfig(max_simulations=FLEET_SIMS),
                       net.support)
    servers = []
    for width in FLEET_INPROC_WIDTHS:
        telemetry = build_serve_telemetry(RUN_ROOT / f"{label}-b{width}", f"b{width}", env_cfg,
                                          model_cfg, device=dev)
        service = PolicyService(env, extractor, net, mcts, slots=width, rng_seed=width,
                                telemetry=telemetry)
        service.warm()
        servers.append((width, service, telemetry))
    torch.cuda.synchronize()
    searched = {}
    restore = record_search_kernels(searched, FLEET_INPROC_WIDTHS)
    for kern in kernels.values():
        kern.launches = 0
    t0 = time.perf_counter()
    replies, dispatches = {}, 0
    try:
        for width, service, telemetry in servers:
            out = io.StringIO()
            server = ReplicaServer(service, telemetry, tick_every=4, out=out)
            read_fd, write_fd = os.pipe()
            stdin, pipe = os.fdopen(read_fd), os.fdopen(write_fd, "w", buffering=1)
            worker = threading.Thread(target=server.serve_forever, args=(0.5, stdin), daemon=True)
            worker.start()
            for i in range(width):
                pipe.write(json.dumps({"id": i, "kind": "episode", "seed": 100 * width + i,
                                       "max_moves": FLEET_MAX_MOVES}) + "\n")
            deadline = time.monotonic() + 300
            while time.monotonic() < deadline and len(out.getvalue().splitlines()) < width:
                time.sleep(0.05)
            pipe.write(json.dumps({"id": width, "kind": "shutdown"}) + "\n")
            pipe.close()
            worker.join(timeout=30)
            stdin.close()
            telemetry.close(step=service.dispatch_count)
            got = [json.loads(line) for line in out.getvalue().splitlines()]
            episodes = [r for r in got if r.get("kind") == "episode"]
            if len(episodes) != width or not all(r["ok"] and r["moves"] >= 1 for r in episodes):
                fail(f"{label}: at {width} slots the replies were {got[:4]}...")
            replies[width] = episodes
            dispatches += service.dispatch_count
    finally:
        restore()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {name: kern.launches for name, kern in kernels.items()}
    want = {"gather_rows": 16 * dispatches, "backup_update": 2 * dispatches, "per_sample": 0,
            "subtree_promote": 0}
    if launches != want or dispatches == 0:
        fail(f"{label}: launches {launches} in {dispatches} dispatches, want {want}")
    moves = sum(r["moves"] for eps in replies.values() for r in eps)
    return {
        "launches": launches,
        "dispatches": dispatches,
        "dispatches_by_width": {w: s.dispatch_count for w, s, _ in servers},
        "moves_served": moves,
        "moves_per_s": moves / wall_s,
        "move_latency_ms_p50": statistics.median(
            v for eps in replies.values() for r in eps for v in r["lat_ms"]),
        "kernels_held_bit_equal": hold_search_kernels(torch, searched, FLEET_INPROC_WIDTHS, label),
    }


def fleet_phase(torch, dev, kernels, kind: str) -> dict:
    """The serving fleet: (a) `cli fleet` as a user runs it, (b) a replica
    server in this process, whose launches and dispatches are the path's."""
    t0 = time.perf_counter()
    cli_part = fleet_cli_part(torch, kind)
    inproc = fleet_inproc_part(torch, dev, kernels)
    return {**inproc, "cli": cli_part, "phase_s": time.perf_counter() - t0}


def say_fleet(r: dict, card: str) -> None:
    rep, chain, cli_part = r["cli"]["report"], r["cli"]["chain"], r["cli"]
    say(
        f"fleet: {rep['replicas']} replicas x {rep['slots']} slots (ladder {FLEET_BUCKETS}), "
        f"{rep['requests']} requests x up to {FLEET_MAX_MOVES} moves at concurrency "
        f"{FLEET_CONCURRENCY}: {rep['completed']} completed, {rep['shed']} shed "
        f"{rep['shed_by_code']}, 0 lost, {rep['retried_requests']} retried; move latency p50 "
        f"{rep['move_latency_ms_p50']:.1f} ms, p95 {rep['move_latency_ms_p95']:.1f} ms, "
        f"{rep['requests_per_sec']:.2f} requests/s over the storm's {rep['elapsed_s']:.1f} s; "
        f"deaths {rep['fleet']['deaths']}, respawns {rep['fleet']['respawns']}, re-admissions "
        f"{rep['fleet']['readmissions']}, reload recompiles {rep['fleet']['reload_recompiles']}; "
        f"SLO {rep['slo']} [{card}]"
    )
    say(
        f"fleet chain: {chain['wedged_replica']} hung in {chain['wedged_program']} -> exit 113 -> "
        f"dispatch-hung -> respawn at 8 slots -> ready -> readmit in {chain['wedge_to_readmit_s']:.1f} "
        f"s; chaos-killed {chain['killed_replica']} -> death -> respawn; reloaded "
        f"{chain['replicas_reloaded']} with 0 recompiles"
    )
    say("fleet death to re-admission: " + ", ".join(
        f"{d['replica']} rc {d['rc']} {'-' if d['s'] is None else format(d['s'], '.1f') + ' s'}"
        for d in cli_part["death_to_readmit"]))
    say("fleet spawn to ready: " + ", ".join(
        f"{x['replica']} {x['event']} b{x['slots']} {x['s']:.1f} s" for x in cli_part["spawn_to_ready"]))
    say("fleet replica dispatch p50: " + "; ".join(
        f"{name} " + (", ".join(f"{program} {v['p50']:.1f} ms ({v['n']} seals)"
                                for program, v in by_program.items()) or "-")
        for name, by_program in cli_part["replica_dispatch_ms_p50"].items()) + f" [{card}]")
    held = ", ".join(f"b{w}" for w in r["kernels_held_bit_equal"])
    say(
        f"fleet in-process replica: {r['dispatches']} dispatches {r['dispatches_by_width']}, "
        f"{r['moves_served']} moves, {r['moves_per_s']:.1f} moves/s, move latency p50 "
        f"{r['move_latency_ms_p50']:.1f} ms; gather_rows and backup_update bit-equal to plain at "
        f"{held}; launches {r['launches']} [{card}]"
    )
    say(f"fleet cli part: {cli_part['wall_s']:.1f} s; fleet phase: {r['phase_s']:.1f} s")


def supervised_path(r: dict) -> dict:
    """A supervised run's figures for the JSON line: the respawn's
    launches (the killed child's are not reported) and the chain."""
    keep = ("launches", "searched_moves", "megasteps", "beacon_launches", "wall_s", "steps_done_before_death",
            "steps_lost", "death_to_respawn_first_intent_s", "death_to_respawn_first_megastep_s",
            "respawn_spawn_to_first_intent_s", "respawn_restore_ms", "respawn_megastep_ms_p50",
            "respawn_run_s", "hang_at_dispatch", "hung_program", "wedge_deadline_s", "wedge_elapsed_s",
            "hang_to_death_s", "beacon_rows", "checkpoints_at_death")
    out = {k: r[k] for k in keep if k in r}
    out["events"] = [
        {k: e.get(k) for k in ("event", "attempt", "rc", "verdict", "program", "family", "progress_step",
                                "action", "delay_s", "overrides") if e.get(k) is not None}
        for e in r["events"]
    ]
    out["doctor_at_death"] = {"rc": r["at_death"]["doctor_rc"], "verdict": r["at_death"]["doctor"]["verdict"],
                              "program": r["at_death"]["doctor"].get("program")}
    return out


def say_supervise(label: str, r: dict, card: str) -> None:
    death = r["events"][1]
    say(
        f"{label}: exit 0 in {r['wall_s']:.1f} s; {' -> '.join(e['event'] for e in r['events'])}; death rc "
        f"{death['rc']}, {death['verdict']} [{death.get('family')}], committed step {death['progress_step']}, "
        f"{r['steps_done_before_death']} steps done, {r['steps_lost']} lost; death to the respawn's first "
        f"dispatch {r['death_to_respawn_first_intent_s']:.1f} s (spawn to it "
        f"{r['respawn_spawn_to_first_intent_s']:.1f} s), to its first megastep "
        f"{r['death_to_respawn_first_megastep_s']:.1f} s; restore {r['respawn_restore_ms']:.1f} ms, "
        f"megastep p50 {r['respawn_megastep_ms_p50']:.1f} ms; launches {r['launches']} in "
        f"{r['searched_moves']} searched moves, {r['megasteps']} megasteps [{card}]"
    )


def say_ladder(label: str, r: dict, card: str) -> None:
    by_rung = "; ".join(
        f"b{rung}: {v['dispatches']} dispatches, p50 {v['dispatch_ms_p50']:.1f} ms, first after a "
        f"switch {', '.join(f'{x:.1f}' for x in v['first_after_switch_ms']) or '-'} ms, migration "
        f"{', '.join(f'{x:.2f}' for x in v['migration_ms']) or '-'} ms"
        for rung, v in r["by_rung"].items()
    )
    extra = ""
    if "promote_at_32_lanes" in r:
        extra = f"; the reorder at 32 lanes bit-equal ({r['promote_at_32_lanes']['retained_rows']} rows kept)"
    held = ", ".join(f"b{rung}" for rung in r["kernels_held_bit_equal"])
    extra = f"; gather_rows and backup_update bit-equal to plain at {held}{extra}"
    if "lane_isolation_moves" in r:
        extra += f"; a tracked game of {r['lane_isolation_moves']} moves equal solo and in a crowd across a switch"
    say(
        f"{label}: {r['sessions_served']} sessions, {r['moves_served']} moves in {r['dispatches']} "
        f"dispatches ({r['moves_per_s']:.1f} moves/s), {r['rung_switches']} switches, warm "
        f"{', '.join(f'b{k} {v:.0f} ms' for k, v in r['warm_ms'].items())}; {by_rung}{extra}; "
        f"launches {r['launches']} [{card}]"
    )


def say_profile(label: str, prof: dict, card: str) -> None:
    if prof["device_ms"] is None:
        say(f"profiled {label}: wall {prof['wall_ms']:.1f} ms, device time not measured [{card}]")
    else:
        say(
            f"profiled {label}: wall {prof['wall_ms']:.1f} ms, device {prof['device_ms']:.1f} "
            f"ms in {prof['device_launches']} kernels and copies, device busy "
            f"{prof['device_busy_share']:.1%} of the p50 {label} [{card}]"
        )
    for stage, st in prof["stages"].items():
        say(f"  stage {stage}: host {st['host_ms']:.1f} ms, device {st['device_ms']:.1f} ms, "
            f"{st['calls']} calls")
    for kname, st in prof["ported"].items():
        say(f"  ported kernel {kname}: device {st['ms']:.3f} ms in {st['count']} grids")
    for row in prof["top"]:
        say(f"  {row['ms']:8.3f} ms  x{row['count']:<5d} {row['name']}")


def say_serve(label: str, r: dict, card: str) -> None:
    say(
        f"{label}: {r['dispatches']} dispatches, {r['moves_served']} moves; "
        f"dispatch p50 {r['dispatch_ms_p50']:.1f} ms (first {r['dispatch_ms_first']:.1f} ms), "
        f"{r['moves_per_s']:.1f} moves/s, {r['leaf_evals_per_s']:.0f} leaf evals/s "
        f"({r['leaf_evals_per_s_with_reused']:.0f} with {r['reused_visits']} inherited visits, "
        f"{r['reused_share']:.1%} of root visits), peak {r['peak_mem_gb']:.2f} GiB; "
        f"launches {r['launches']} [{card}]"
    )
    say_profile("dispatch", r["profile"], card)


def say_train(label: str, r: dict, card: str) -> None:
    say(
        f"{label}: {r['megasteps']} megasteps after {r['warmup_chunks']} warm-up chunks, "
        f"{r['searched_moves']} searched moves, {r['rows_ingested']} rows, "
        f"{r['episodes']} episodes; megastep p50 {r['megastep_ms_p50']:.1f} ms "
        f"(first {r['megastep_ms_first']:.1f} ms), warm-up chunk p50 "
        f"{r['warmup_chunk_ms_p50']:.1f} ms, rollout {r['rollout_moves_per_s']:.1f} "
        f"moves/s (warm-up chunks), {r['megastep_moves_per_s_p50']:.1f} moves/s and "
        f"{r['learner_steps_per_s_p50']:.2f} learner steps/s (p50 megastep), "
        f"{r['leaf_evals_per_s_p50']:.0f} leaf evals/s "
        f"({r['leaf_evals_per_s_p50_with_reused']:.0f} with {r['reused_visits']} inherited "
        f"visits, {r['reused_share']:.1%} of root visits), "
        f"peak {r['peak_mem_gb']:.2f} GiB; launches {r['launches']} [{card}]"
    )
    say(f"{label} losses: {json.dumps(r['losses'])}")
    say_profile("megastep", r["profile"], card)


def say_loop(label: str, r: dict, card: str) -> None:
    say(
        f"{label}: {r['iterations']} iterations, {r['searched_moves']} searched moves, rows "
        f"{r['rows_per_iteration']}, learner steps {r['steps_per_iteration']}, "
        f"{r['episodes']} episodes, {r['weight_updates']} weight syncs (differ before, equal "
        f"after), replay ratio {r['replay_ratio']:.3f}; iteration p50 "
        f"{r['iteration_ms_p50_full']:.1f} ms at {r['steps_full']} steps, rollout p50 "
        f"{r['rollout_ms_p50']:.1f} ms ({r['rollout_moves_per_s']:.1f} moves/s), learner "
        f"{r['learner_ms_per_step_p50']:.1f} ms/step p50, {r['learner_steps_per_s_full']:.2f} "
        f"learner steps/s at {r['steps_full']} steps an iteration, over the run "
        f"{r['learner_steps_per_s_run']:.2f} learner steps/s and {r['lane_moves_per_s_run']:.1f} "
        f"moves/s ({r['run_s']:.1f} s); upload {r['transfer_h2d_s'] * 1e3:.1f} ms, fetch "
        f"{r['transfer_d2h_s'] * 1e3:.1f} ms; peak {r['peak_mem_gb']:.2f} GiB; launches "
        f"{r['launches']} [{card}]"
    )
    say(f"{label} losses: {json.dumps(r['losses'])}")


def say_async(r: dict, card: str) -> None:
    p = r["profile"]
    say(
        f"train-async: {r['steps']} steps, {r['chunks']} chunks ({r['searched_moves']} searched "
        f"moves, harvests by stream {r['harvests_by_stream']}, {r['chunks_crossing_a_sync']} "
        f"chunks crossing a sync, versions {r['chunk_versions']}), {r['rows_ingested']} rows, "
        f"replay ratio {r['replay_ratio']:.3f}, {r['weight_updates']} weight syncs, chunk "
        f"{r['tuned_chunk_moves']} moves (tuned), queue depth max {r['queue_depth_max']} mean "
        f"{r['queue_depth_mean']:.2f}, staleness {r['staleness_mean']}, producer chunk p50 "
        f"{r['producer_chunk_ms_p50']:.1f} ms over {r['producer_chunks']}; over the run "
        f"{r['learner_steps_per_s_run']:.2f} learner steps/s and {r['lane_moves_per_s_run']:.1f} "
        f"moves/s ({r['run_s']:.1f} s); peak {r['peak_mem_gb']:.2f} GiB; launches "
        f"{r['launches']} [{card}]"
    )
    say(f"train-async losses: {json.dumps(r['losses'])}")
    window = (f"profiled async window: {p['steps']} steps, {p['lane_moves_folded']} moves folded "
              f"in {p['wall_ms']:.1f} ms")
    if p["device_ms"] is None:
        say(f"{window}; device time not measured [{card}]")
    else:
        say(
            f"{window}; device busy {p['device_ms']:.1f} ms ({p['device_busy_share']:.1%} of the "
            f"wall, {p['device_spans']} kernels and copies; summed over streams "
            f"{p['device_kernel_ms_summed']:.1f} ms, overlap {p['streams_overlap']:.2f}x) [{card}]"
        )
    a = r["armed"]
    say(
        f"armed async window: {a['steps']} steps in {a['wall_ms']:.1f} ms, {a['rows']} beacon rows from "
        f"{a['streams']} streams ({', '.join(a['phases'])}) equal as a multiset to the host's, "
        f"{a['dropped']} dropped [{card}]"
    )


def say_preset3(label: str, r: dict, card: str) -> None:
    if "producer_chunk_ms_p50" in r:
        loop = (f"{r['iterations']} loop iterations, harvests {r['harvests_by_stream']}, chunk "
                f"{r['tuned_chunk_moves']} moves, producer chunk p50 "
                f"{r['producer_chunk_ms_p50']:.1f} ms, {r['moves_per_s_run']:.1f} moves/s and "
                f"{r['learner_steps_per_s_run']:.2f} learner steps/s over the run, replay ratio "
                f"{r['replay_ratio']:.3f}, queue depth max {r['queue_depth_max']}")
    elif "megasteps" in r:
        loop = (f"{r['megasteps']} megasteps after {r['warmup_chunks']} warm-up chunks; megastep "
                f"p50 {r['megastep_ms_p50']:.1f} ms, {r['megastep_moves_per_s_p50']:.1f} moves/s "
                f"and {r['learner_steps_per_s_p50']:.2f} learner steps/s (p50 megastep), rollout "
                f"{r['rollout_moves_per_s']:.1f} moves/s (warm-up chunks)")
    else:
        loop = (f"{r['iterations']} iterations, rows {r['rows_per_iteration']}, learner steps "
                f"{r['steps_per_iteration']}; iteration p50 {r['iteration_ms_p50_full']:.1f} ms, "
                f"rollout {r['rollout_moves_per_s']:.1f} moves/s, "
                f"{r['learner_steps_per_s_run']:.2f} learner steps/s over the run; watched pass "
                f"(every move synchronised): full move p50 {r['full_move_ms_p50']} ms, fast move "
                f"p50 {r['fast_move_ms_p50']} ms")
    say(
        f"{label}: {r['searched_moves']} searched moves ({r['full_moves']} full of 64 sims, "
        f"{r['fast_moves']} fast of 16: Full_Search_Fraction {r['full_search_fraction']:.3f}), "
        f"{r['rows_ingested']} rows, {r['steps']} steps; {loop}; peak {r['peak_mem_gb']:.2f} GiB; "
        f"{r['live_metrics_lines']} live_metrics lines, writers {r['stats_writers']}; launches "
        f"{r['launches']} [{card}]"
    )
    say(f"{label} losses: {json.dumps(r['losses'])}")
    say_device_stats(label, r["device_stats"], card)
    if "profile" in r:
        say_profile("megastep" if "megasteps" in r else "sync iteration", r["profile"], card)


# --- slice 12: the device telemetry plane and the profiling plane -----------

# Interleaved pairs timed: stat-packs off / on, beacons unarmed / armed.
STATS_PAIRS = 2
# The beacon phase's service: a dispatch that has sealed once is due in
# max(10 x its expected wall, this floor); it warns at half of that. The
# stalls follow the first wave's beacon site: the first ends before the
# deadline (the warning arms the beacons), the second after it (a wedge).
BEACON_DEADLINE_S, BEACON_POLL_S = 4.0, 0.05
BEACON_WARN_STALL_MS, BEACON_WEDGE_STALL_MS = 2800.0, 6000.0
# The stall's wait before the beacon file is read, within the stall.
BEACON_READ_AFTER_S = 1.0


def serve_default_stats() -> None:
    """The serve bring-up never sets the stat-pack flag (nor does the JAX
    package's): a serve path starts with it off, whatever a training
    phase of this process set."""
    from alphatriangle_tpu_torch.telemetry import device_stats as tds

    tds.set_device_stats(False)


def runtime_syncs(prof) -> dict:
    """The host-blocking CUDA runtime calls a profile recorded, by name."""
    names = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
             "cudaMemcpyAsync", "cudaMemcpy")
    counts = trace_of(prof).names
    return {name: counts[name] for name in names}


def check_device_stats(loop, label: str, strict: bool = True) -> dict:
    """A finished run's `kind:"device_stats"` records (stat-packs on, the
    training default). `strict` (the synchronous and megastep loops): one
    record an iteration, their depth histograms summing to the run's
    simulations (fast moves at their 16), a PER and a learner leg for
    every megastep, the three gauges on every util record. Otherwise
    (the overlapped loop ledgers the freshest fold of its streams) at
    least one record, its histograms within the run's simulations. Every
    search leg finite, its root entropy within [0, ln 360], every
    histogram a whole number of searches over the lanes; with inherited
    visits, a reused share above 0."""
    import math

    from alphatriangle_tpu_torch.telemetry.ledger import read_ledger

    ledger = read_ledger(loop.c.persistence_config.get_run_base_dir() / "metrics.jsonl")
    records = [r for r in ledger if r.get("kind") == "device_stats"]
    utils = [r for r in ledger if r.get("kind") == "util"]
    ticks = loop.iterations + loop.warmup_chunks
    lanes = loop.c.self_play.batch_size
    if not records or (strict and len(records) != ticks):
        fail(f"{label}: {len(records)} device_stats records for {ticks} iterations")
    sims = 0
    for r in records:
        leg = r.get("search") or {}
        keys = ("root_entropy", "root_concentration", "occupancy", "value_abs_max", "reuse_frac")
        if any(not isinstance(leg.get(k), float) or not math.isfinite(leg[k]) for k in keys):
            fail(f"{label}: a search leg is missing or not finite: {json.dumps(r)}")
        if not 0.0 <= leg["root_entropy"] <= math.log(360.0) + 1e-9:
            fail(f"{label}: root entropy {leg['root_entropy']} outside [0, ln 360]")
        n = sum(leg["depth_hist"])
        if n <= 0 or n != int(n) or int(n) % lanes:
            fail(f"{label}: a depth histogram counts {n} simulations over {lanes} lanes")
        sims += int(n)
    if sims > loop.total_simulations or (strict and sims != loop.total_simulations):
        fail(f"{label}: the histograms count {sims} simulations, the run {loop.total_simulations}")
    full = [r for r in records if r.get("per") and r.get("learner")]
    if loop.c.megastep is not None and strict and len(full) != loop.megastep_iterations:
        fail(f"{label}: {len(full)} records with PER and learner legs for "
             f"{loop.megastep_iterations} megasteps")
    for r in full:
        vals = [*r["per"].values(), *r["learner"].values()]
        if not all(math.isfinite(v) for v in vals) or not 0.0 < r["per"]["is_weight_min"] <= 1.0:
            fail(f"{label}: PER or learner leg out of range: {json.dumps(r)}")
    gauges = [u for u in utils
              if all(u.get(k) is not None for k in ("root_visit_entropy", "tree_occupancy", "beacons_armed"))]
    if not gauges or (strict and len(gauges) != len(utils)):
        fail(f"{label}: {len(gauges)} of {len(utils)} util records carry the device-stats gauges")
    reuse = max(r["search"]["reuse_frac"] for r in records)
    if loop.total_reused_visits > 0 and reuse <= 0.0:
        fail(f"{label}: inherited visits but a reused share of 0 in every record")
    legs = [r["search"] for r in records]
    return {
        "records": len(records),
        "iterations": ticks,
        "hist_simulations": sims,
        "run_simulations": loop.total_simulations,
        "root_entropy_mean": statistics.fmean(x["root_entropy"] for x in legs),
        "root_concentration_mean": statistics.fmean(x["root_concentration"] for x in legs),
        "occupancy_mean": statistics.fmean(x["occupancy"] for x in legs),
        "value_abs_max": max(x["value_abs_max"] for x in legs),
        "reuse_frac_max": reuse,
        "per_records": len(full),
        "priority_skew_max": max((r["per"]["priority_skew"] for r in full), default=None),
        "grad_norm_max": max((r["learner"]["grad_norm_max"] for r in full), default=None),
        "util_records_with_gauges": len(gauges),
    }


def say_device_stats(label: str, r: dict, card: str) -> None:
    say(
        f"{label} device stats: {r['records']} records for {r['iterations']} iterations, histograms "
        f"{r['hist_simulations']} of the run's {r['run_simulations']} simulations, root entropy mean "
        f"{r['root_entropy_mean']:.4f}, concentration {r['root_concentration_mean']:.4f}, occupancy "
        f"{r['occupancy_mean']:.4f}, |value| max {r['value_abs_max']:.4f}, reused share max "
        f"{r['reuse_frac_max']:.4f}; {r['per_records']} PER / learner legs (skew max "
        f"{r['priority_skew_max']}, grad norm max {r['grad_norm_max']}); gauges on "
        f"{r['util_records_with_gauges']} util records [{card}]"
    )


def set_search_stats(c, on: bool) -> None:
    """Flip the stat-pack flag built components snapshotted, so one set of
    components runs both sides of an A/B."""
    engine = c.self_play
    for part in (c.megastep, engine, engine.mcts, engine.mcts_fast):
        if part is not None:
            part.device_stats = on


def watch_beacons(torch, cycles: float):
    """Note every beacon the host enqueues on the card ((phase, index,
    program), through `BeaconRing.emit`), and, when `stall["ms"]` is set,
    enqueue one `torch.cuda._sleep` of that long right before the next
    second-wave beacon site of a search (`BatchedMCTS.beacon(1)`, armed
    or not): the host then enqueues that beacon while the card sleeps in
    front of it. Returns (enqueued, stall, restore)."""
    from alphatriangle_tpu_torch.mcts.search import BatchedMCTS
    from alphatriangle_tpu_torch.ops.beacon import BeaconRing

    enqueued, stall = [], {"ms": 0.0}
    real_emit, real_site = BeaconRing.emit, BatchedMCTS.beacon

    def emit(self, phase, index, program):
        real_emit(self, phase, index, program)
        enqueued.append((phase, int(index), program))

    def site(self, k):
        if k == 1 and stall["ms"]:
            torch.cuda._sleep(int(cycles * stall["ms"]))
            stall["ms"] = 0.0
        real_site(self, k)

    BeaconRing.emit, BatchedMCTS.beacon = emit, site

    def restore():
        BeaconRing.emit, BatchedMCTS.beacon = real_emit, real_site

    return enqueued, stall, restore


def beacon_rows(path) -> list:
    from alphatriangle_tpu_torch.telemetry.device_stats import read_beacons

    return [(r["phase"], r["index"], r["program"]) for r in read_beacons(path)]


def megastep_stats_ab(torch, c, prof_on, on: dict, run: Path, cycles: float) -> dict:
    """On the train phase's components after its run: megasteps with the
    stat-packs off and on, interleaved (host clock around each, which
    ends in the megastep's own fetch); one more megastep profiled with
    them off, whose host-blocking runtime calls must equal the profiled
    one's with them on (`prof_on`, read already into `on`); then one
    megastep with every beacon armed, its rows (drained from the card's
    ring) equal to the beacons the host enqueued, in order."""
    from torch.profiler import ProfilerActivity, profile

    from alphatriangle_tpu_torch.ops import beacon as obeacon
    from alphatriangle_tpu_torch.telemetry import device_stats as tds

    times = {"off": [], "on": []}
    for _ in range(STATS_PAIRS):
        for mode in ("off", "on"):
            set_search_stats(c, mode == "on")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            c.megastep.run_megastep(TRAIN_CHUNK_MOVES, TRAIN_K)
            times[mode].append((time.perf_counter() - t0) * 1e3)
    set_search_stats(c, False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_off:
        c.megastep.run_megastep(TRAIN_CHUNK_MOVES, TRAIN_K)
        torch.cuda.synchronize()
    set_search_stats(c, True)
    syncs_on, syncs_off = runtime_syncs(prof_on), runtime_syncs(prof_off)
    if syncs_on != syncs_off or not syncs_on["cudaMemcpyAsync"] + syncs_on["cudaMemcpy"]:
        fail(f"train: stat-packs changed a megastep's host-blocking calls: on {syncs_on}, off {syncs_off}")
    off = read_profile(prof_off, TRAIN_STAGES, 1.0, 1.0)
    # One megastep with every beacon armed.
    path = run / "beacons.jsonl"
    enqueued, _, restore = watch_beacons(torch, cycles)
    obeacon.KERNEL.launches = 0
    tds.attach_beacon_run_dir(run)
    tds.arm_beacons(1)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c.megastep.run_megastep(TRAIN_CHUNK_MOVES, TRAIN_K)
        armed_ms = (time.perf_counter() - t0) * 1e3
        tds.drain_beacons()
        rows = beacon_rows(path)
    finally:
        tds.disarm_beacons()
        restore()
    program = f"megastep/t{TRAIN_CHUNK_MOVES}_k{TRAIN_K}"
    want = [(p, i, program) for p, i, _ in enqueued]
    phases = {p for p, _, _ in rows}
    if rows != enqueued or rows != want or phases != {"search_wave", "rollout_chunk", "ring_scatter",
                                                      "learner_step"}:
        fail(f"train: the armed megastep's beacon rows {rows[:8]}... differ from the host's {enqueued[:8]}...")
    return {
        "megastep_ms_off": times["off"],
        "megastep_ms_on": times["on"],
        "megastep_ms_p50_off": statistics.median(times["off"]),
        "megastep_ms_p50_on": statistics.median(times["on"]),
        "device_launches_off": off["device_launches"],
        "device_launches_on": on["device_launches"],
        "added_launches_per_searched_move": (on["device_launches"] - off["device_launches"]) / TRAIN_CHUNK_MOVES,
        "device_ms_off": off["device_ms"],
        "device_ms_on": on["device_ms"],
        "stats_device_ms": on["stages"]["search.stats"]["device_ms"],
        "host_blocking_calls": syncs_on,
        "armed_megastep_ms": armed_ms,
        "armed_rows": len(rows),
        "beacon_launches": obeacon.KERNEL.launches,
    }


def serve_round(torch, service, sids: set, seed: int) -> float:
    """Fill the free slots with new sessions, request a move for every
    live one and dispatch; close the sessions whose game ended. Returns
    the dispatch's host ms (it ends in the dispatch's one fetch)."""
    from alphatriangle_tpu_torch import rng

    free = service.sessions.free_count
    if free:
        keys = rng.fold_in(rng.PRNGKey(seed), torch.arange(free))
        sids.update(s.sid for s in service.open_sessions(keys))
    for sid in sids:
        service.request_move(sid)
    t0 = time.perf_counter()
    results = service.dispatch()
    ms = (time.perf_counter() - t0) * 1e3
    if len(results) != len(sids):
        fail(f"a dispatch answered {len(results)} of {len(sids)} requests")
    for r in results:
        if r["done"]:
            service.close_session(r["sid"])
            sids.discard(r["sid"])
    return ms


def serve_stack(torch, dev):
    """The serve default's env, extractor and net (seed 0)."""
    from alphatriangle_tpu_torch.config import EnvConfig, ModelConfig
    from alphatriangle_tpu_torch.env import TriangleEnv
    from alphatriangle_tpu_torch.features import FeatureExtractor
    from alphatriangle_tpu_torch.nn import NeuralNetwork

    env_cfg, model_cfg = EnvConfig(), ModelConfig()
    env = TriangleEnv(env_cfg, device=dev)
    return env, FeatureExtractor(env, model_cfg), NeuralNetwork(model_cfg, env_cfg, seed=0, device=dev)


def serve_stats_phase(torch, dev, slots: int = 64, sims: int = 64) -> dict:
    """The serve default at 64 slots x 64 simulations twice over one net:
    a service built with the stat-packs off (the serve default) and one
    built under `ALPHATRIANGLE_DEVICE_STATS=1` with a serve run's
    telemetry. Their dispatches interleaved: p50 off and on; one dispatch
    of each profiled: the kernels and copies it launched, and its
    host-blocking runtime calls, which must be equal. Two ticks of the
    stats service: each ledgers one `kind:"device_stats"` record whose
    serve leg counts 64 x 64 simulations a dispatch of its window, and
    the second's util record carries the three gauges."""
    import math

    from torch.profiler import ProfilerActivity, profile

    from alphatriangle_tpu_torch.config import AlphaTriangleMCTSConfig
    from alphatriangle_tpu_torch.mcts import BatchedMCTS
    from alphatriangle_tpu_torch.serving import PolicyService
    from alphatriangle_tpu_torch.serving.service import build_serve_telemetry
    from alphatriangle_tpu_torch.telemetry import device_stats as tds
    from alphatriangle_tpu_torch.telemetry.ledger import read_ledger

    serve_default_stats()
    env, extractor, net = serve_stack(torch, dev)
    mcts_cfg = AlphaTriangleMCTSConfig(max_simulations=sims)
    services, sids = {}, {}
    run = RUN_ROOT / "serve-stats"
    for mode in ("off", "on"):
        os.environ[tds.DEVICE_STATS_ENV] = "1" if mode == "on" else "0"
        try:
            mcts = BatchedMCTS(env, extractor, net.model, mcts_cfg, net.support)
        finally:
            del os.environ[tds.DEVICE_STATS_ENV]
        telemetry = None
        if mode == "on":
            telemetry = build_serve_telemetry(run, "serve-stats", env.cfg, extractor.model_config,
                                              device=dev)
        services[mode] = PolicyService(env, extractor, net, mcts, slots=slots, rng_seed=0, telemetry=telemetry)
        sids[mode] = set()
    if services["off"].mcts.device_stats or not services["on"].mcts.device_stats:
        fail("serve-stats: the environment override did not set the searches' stat-pack flags")
    on = services["on"]
    times = {"off": [], "on": []}
    for i in range(STATS_PAIRS + 1):
        for mode in ("off", "on"):
            ms = serve_round(torch, services[mode], sids[mode], seed=100 + i)
            if i:  # the first pair warms both
                times[mode].append(ms)
        if i == 0:
            on.tick()  # the meter's baseline; ledgers the first dispatch's leg
    record_util = on.tick()
    profiles = {}
    for mode in ("off", "on"):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            serve_round(torch, services[mode], sids[mode], seed=200)
            torch.cuda.synchronize()
        profiles[mode] = (read_profile(prof, STAGES, 1.0, 1.0), runtime_syncs(prof))
    on.tick()
    on.telemetry.close(on.dispatch_count)
    if profiles["on"][1] != profiles["off"][1] or (
        dev.type == "cuda" and not profiles["on"][1]["cudaMemcpyAsync"] + profiles["on"][1]["cudaMemcpy"]
    ):
        fail(f"serve-stats: stat-packs changed a dispatch's host-blocking calls: {profiles}")
    ledger = read_ledger(run / "metrics.jsonl")
    records = [r for r in ledger if r.get("kind") == "device_stats"]
    windows = [1, STATS_PAIRS, 1]  # dispatches of the stats service between its ticks
    if len(records) != len(windows):
        fail(f"serve-stats: {len(records)} device_stats records for {len(windows)} ticks")
    for r, n in zip(records, windows):
        leg = r.get("serve") or {}
        if sum(leg.get("depth_hist", [])) != slots * sims * n or r.get("program") != f"serve/b{slots}":
            fail(f"serve-stats: a serve leg does not count {n} dispatches of {slots} x {sims}: {json.dumps(r)}")
        if not 0.0 <= leg["root_entropy"] <= math.log(360.0):
            fail(f"serve-stats: root entropy {leg['root_entropy']}")
    if record_util is None or any(record_util.get(k) is None for k in
                                  ("root_visit_entropy", "tree_occupancy", "beacons_armed")):
        fail(f"serve-stats: the util record lacks the device-stats gauges: {record_util}")
    off_p, on_p = profiles["off"][0], profiles["on"][0]
    return {
        "dispatch_ms_off": times["off"],
        "dispatch_ms_on": times["on"],
        "dispatch_ms_p50_off": statistics.median(times["off"]),
        "dispatch_ms_p50_on": statistics.median(times["on"]),
        "device_launches_off": off_p["device_launches"],
        "device_launches_on": on_p["device_launches"],
        "added_launches_per_dispatch": on_p["device_launches"] - off_p["device_launches"],
        "stats_device_ms": on_p["stages"]["search.stats"]["device_ms"],
        "stats_host_ms": on_p["stages"]["search.stats"]["host_ms"],
        "device_ms_off": off_p["device_ms"],
        "device_ms_on": on_p["device_ms"],
        "host_blocking_calls": profiles["on"][1],
        "records": len(records),
        "serve_leg": records[1]["serve"],
    }


def beacon_phase(torch, dev, cycles: float) -> dict:
    """Beacons on the serve default at 64 slots, with a run's telemetry
    whose dispatch deadline is `BEACON_DEADLINE_S` (polled every
    `BEACON_POLL_S`, the warning at half of it) and wedges that do not
    exit. Unarmed dispatches, then one that stalls `BEACON_WARN_STALL_MS`
    on the card between its waves: its warning must arm the beacons
    (`arm_beacons` called exactly once) and no wedge fires. Dispatches
    until the deadline is back at its floor (armed: their rows end at
    wave 1), then an armed dispatch that stalls `BEACON_WEDGE_STALL_MS`
    right before its second wave's beacon: `BEACON_READ_AFTER_S` into
    it, the host has enqueued that beacon, and the run's last beacon
    must still be the first wave's (`search_wave` 0 of `serve/b64`), as
    the card has reached only that; the wedge report, written while the
    card still sleeps, must carry it and `classify_run` must name it;
    after the fetch the rows must be the beacons the host enqueued, in
    order. Then armed and unarmed dispatches interleaved (the armed cost)."""
    from alphatriangle_tpu_torch import telemetry as telemetry_pkg
    from alphatriangle_tpu_torch.config import AlphaTriangleMCTSConfig, TelemetryConfig
    from alphatriangle_tpu_torch.mcts import BatchedMCTS
    from alphatriangle_tpu_torch.ops import beacon as obeacon
    from alphatriangle_tpu_torch.serving import PolicyService
    from alphatriangle_tpu_torch.serving.service import build_serve_telemetry
    from alphatriangle_tpu_torch.telemetry import device_stats as tds
    from alphatriangle_tpu_torch.telemetry.flight import (
        classify_run, read_flight, read_wedge_report, WEDGE_REPORT_FILENAME,
    )

    serve_default_stats()
    tds.disarm_beacons()
    run = RUN_ROOT / "beacons"
    env, extractor, net = serve_stack(torch, dev)
    mcts_cfg = AlphaTriangleMCTSConfig(max_simulations=64)
    # One dispatch of the stack without telemetry first: a cold first
    # dispatch (the libraries' set-up) must not trip the short deadline.
    warm = PolicyService(env, extractor, net, BatchedMCTS(env, extractor, net.model, mcts_cfg, net.support),
                         slots=64, rng_seed=0)
    serve_round(torch, warm, set(), seed=299)
    del warm
    cfg = TelemetryConfig(
        DISPATCH_MIN_DEADLINE_S=BEACON_DEADLINE_S, DISPATCH_FIRST_DEADLINE_S=BEACON_DEADLINE_S,
        DISPATCH_WATCHDOG_POLL_S=BEACON_POLL_S,
    )
    telemetry = build_serve_telemetry(run, "beacons", env.cfg, extractor.model_config, cfg, device=dev)
    dog = telemetry.dispatch_watchdog
    dog.exit_on_wedge = False
    mcts = BatchedMCTS(env, extractor, net.model, mcts_cfg, net.support)
    service = PolicyService(env, extractor, net, mcts, slots=64, rng_seed=0, telemetry=telemetry)
    armed = []
    real_arm = telemetry_pkg.arm_beacons

    def counting_arm(every=None):
        # Counted as the hook calls it; armed at every wave, so that the
        # stall after wave 0's beacon is the one the reader sees.
        armed.append(every)
        real_arm(1)

    telemetry_pkg.arm_beacons = counting_arm
    enqueued, stall, restore = watch_beacons(torch, cycles)
    obeacon.KERNEL.launches = 0
    sids: set = set()
    telemetry.start()
    try:
        def to_the_floor(seed: int) -> None:
            """Dispatches until the program's expected wall (a running
            mean of its sealed walls) puts its deadline at the floor."""
            for i in range(16):
                serve_round(torch, service, sids, seed=seed + i)
                deadline = telemetry.flight.deadline_s(telemetry.flight.expected_s("serve/b64"))
                if i and deadline <= BEACON_DEADLINE_S:
                    return
            fail(f"beacons: the dispatch deadline stayed at {deadline:.2f} s")

        to_the_floor(300)
        if tds.beacons_armed() or enqueued or dog.warn_count:
            fail(f"beacons: armed ({tds.beacons_armed()}) or warned ({dog.warn_count}) while warming up")
        # A long dispatch: the warning arms the beacons, no wedge.
        stall["ms"] = BEACON_WARN_STALL_MS
        warn_ms = serve_round(torch, service, sids, seed=310)
        if armed != [None] or dog.warn_count != 1 or dog.wedge_count != 0 or not tds.beacons_armed():
            fail(f"beacons: after a {warn_ms:.0f} ms dispatch, arms {armed}, warnings "
                 f"{dog.warn_count}, wedges {dog.wedge_count}")
        to_the_floor(340)  # armed: the last row is now an earlier dispatch's
        before = len(enqueued)
        # The wedge: armed, stalled after its first wave's beacon.
        seen = {}

        def read_later():
            time.sleep(BEACON_READ_AFTER_S)
            seen["enqueued"] = list(enqueued[before:])
            seen["row"] = tds.last_beacon(run)

        reader = threading.Thread(target=read_later, name="beacon-reader")
        stall["ms"] = BEACON_WEDGE_STALL_MS
        reader.start()
        wedge_ms = serve_round(torch, service, sids, seed=311)
        reader.join(timeout=30)
        tds.drain_beacons()
        mine = enqueued[before:]
        rows = beacon_rows(run / "beacons.jsonl")
        report = read_wedge_report(run / WEDGE_REPORT_FILENAME)
        verdict = classify_run(read_flight(run / "flight.jsonl"), wedge=report)
        row = seen.get("row") or {}
        if ("search_wave", 1, "serve/b64") not in seen.get("enqueued", []) or (
            row.get("phase"), row.get("index"), row.get("program")
        ) != ("search_wave", 0, "serve/b64"):
            fail(f"beacons: {BEACON_READ_AFTER_S} s into the stall the last beacon was {row}, "
                 f"the host had enqueued {seen.get('enqueued')}")
        if report is None or dog.wedge_count != 1 or (report.get("last_beacon") or {}).get("index") != 0:
            fail(f"beacons: wedge report {report}")
        if verdict["verdict"] != "dispatch-hung" or verdict.get("last_beacon", {}).get("phase") != "search_wave" \
                or "last beacon: serve/b64 phase=search_wave index=0" not in verdict["detail"]:
            fail(f"beacons: classify_run gave {verdict}")
        if armed != [None] or dog.warn_count != 2:
            fail(f"beacons: arms {armed}, warnings {dog.warn_count} (one a dispatch) by the wedge")
        if rows != enqueued or [p for p, _, _ in mine] != ["search_wave"] * mcts.num_waves:
            fail(f"beacons: rows {rows} against the host's {enqueued}")
        # The armed cost: unarmed and armed dispatches interleaved.
        times = {"unarmed": [], "armed": []}
        for i in range(STATS_PAIRS):
            for mode in ("unarmed", "armed"):
                tds._beacons_armed = mode == "armed"
                times[mode].append(serve_round(torch, service, sids, seed=320 + i))
        launches = obeacon.KERNEL.launches
        ring = obeacon.ring_for(dev)
    finally:
        restore()
        telemetry_pkg.arm_beacons = real_arm
        tds.disarm_beacons()
        telemetry.close(service.dispatch_count)
    return {
        "warn_dispatch_ms": warn_ms,
        "wedge_dispatch_ms": wedge_ms,
        "read_after_s": BEACON_READ_AFTER_S,
        "last_beacon_during_stall": {k: row.get(k) for k in ("program", "phase", "index")},
        "enqueued_before_read": seen["enqueued"],
        "wedge_last_beacon": {k: report["last_beacon"].get(k) for k in ("program", "phase", "index")},
        "verdict": verdict["verdict"],
        "verdict_detail": verdict["detail"],
        "rows": len(rows),
        "dropped": ring.dropped,
        "dispatch_ms_unarmed": times["unarmed"],
        "dispatch_ms_armed": times["armed"],
        "dispatch_ms_p50_unarmed": statistics.median(times["unarmed"]),
        "dispatch_ms_p50_armed": statistics.median(times["armed"]),
        "launches": launches,
    }


def beacon_kernel(torch, dev, rate: float, cycles: float) -> dict:
    """The beacon writer against its plain version: the same 4096 + 100
    rows (the ring wraps) into a pinned ring by the kernel and into a ring
    in device memory by the plain version, equal word for word with
    equal counters; both timed per call. The bound: the row's 32 bytes
    and the counter's 8 read and written, over the memory rate."""
    from alphatriangle_tpu_torch.ops import beacon as ob

    slots, n = ob.RING_SLOTS, ob.RING_SLOTS + 100
    host = torch.zeros((slots, ob.ROW_WORDS), dtype=torch.int64, pin_memory=True)
    dev_ring = torch.zeros((slots, ob.ROW_WORDS), dtype=torch.int64, device=dev)
    c_k, c_p = (torch.zeros((1,), dtype=torch.int64, device=dev) for _ in range(2))
    ptr = ob.device_pointer(host)
    for i in range(n):
        ob.beacon_cuda(c_k, ptr, slots, 1 + i % 3, i, 7)
        ob.beacon_plain(c_p, dev_ring, 1 + i % 3, i, 7)
    torch.cuda.synchronize()
    if not torch.equal(host, dev_ring.cpu()) or not torch.equal(c_k, c_p) or int(c_k[0]) != n:
        fail("beacon kernel differs from its plain version")
    err = float((host - dev_ring.cpu()).abs().max())
    return {
        "name": "beacon",
        "route": "cuda",
        "source": "alphatriangle_tpu_torch/csrc/beacon.cu",
        "replaces": "none: not a TPU kernel (the jax.debug.callback of alphatriangle_tpu/telemetry/"
                    "device_stats.py:221 emit_beacon)",
        "max_abs_err": err,
        "ms": time_ms(lambda: ob.beacon_cuda(c_k, ptr, slots, 1, 0, 7), cycles),
        "plain_ms": time_ms(lambda: ob.beacon_plain(c_p, dev_ring, 1, 0, 7), cycles),
        "bound_ms": (ob.ROW_WORDS * 8 + 16) / rate * 1e3,
        "bound_by": "bytes",
        "library_ms": None,
    }


# The profile phase's chunks: 4 moves, and 2 megasteps: the trace window
# (megasteps 1-2) holds the second, the first runs unprofiled.
PROFILE_CHUNK_MOVES, PROFILE_MEGASTEPS = 4, 2


def profile_phase(torch) -> dict:
    """`cli train --fused-megastep --profile` (in this process) at the
    train phase's widths, cut to `PROFILE_MEGASTEPS` megasteps of `PROFILE_CHUNK_MOVES`-move
    chunks, then `cli analyze` of its profile directory: exit 0 both;
    `phase_timers.json` with the rollout, megastep and checkpoint phases;
    the trace's device lines naming the gather, the backup and the PER
    count kernels, with their counts."""
    from alphatriangle_tpu_torch.profiling import summarize_chrome_trace

    label = "profile"
    rc, report = cli_in_process([
        "train", "--device", "cuda", "--root-dir", str(RUN_ROOT / label), "--run-name", label,
        "--no-auto-resume", "--no-tensorboard", "--fused-megastep", "--fused-learner-steps",
        str(TRAIN_K), "--max-steps", str(PROFILE_MEGASTEPS * TRAIN_K), "--rollout-chunk",
        str(PROFILE_CHUNK_MOVES), "--min-buffer", str(TRAIN_MIN_BUFFER), "--profile",
    ], label)
    if rc != 0 or report["status"] != "completed" or report["megasteps"] != PROFILE_MEGASTEPS:
        fail(f"{label}: exit {rc}, status {report.get('status')}, megasteps {report.get('megasteps')}")
    prof_dir = Path(report["run_dir"]) / "profile_data"
    timers = json.loads((prof_dir / "phase_timers.json").read_text())
    if not {"rollout", "megastep", "checkpoint"} <= set(timers) or (
        timers["megastep"]["count"] != PROFILE_MEGASTEPS
    ):
        fail(f"{label}: phase_timers.json holds {timers}")
    traces = list(prof_dir.glob("*.pt.trace.json"))
    if len(traces) != 1:
        fail(f"{label}: {len(traces)} traces in {prof_dir}")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "alphatriangle_tpu_torch.cli", "analyze", str(prof_dir), "--top", "10"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    analyze_s = time.perf_counter() - t0
    if proc.returncode != 0 or "device" not in proc.stdout:
        fail(f"{label}: cli analyze exited {proc.returncode}: {proc.stderr[-2000:]}")
    lines = summarize_chrome_trace(traces[0])
    device = [ln for ln in lines if ln["plane"] != "host"]
    totals: dict = {}
    for ln in device:
        for op in ln["ops"]:
            t = totals.setdefault(op["name"], [0.0, 0])
            t[0] += op["total_us"]
            t[1] += op["count"]
    counts = {
        k: sum(c for name, (_, c) in totals.items() if re.search(rf"\b{k}\w*_kernel\b", name))
        for k in ("gather_rows", "backup_update", "per_sample_count", "per_sample_summary")
    }
    # The window is megasteps 1-2 (the warm-up chunks stay out), each of a
    # chunk's searched moves; a megastep runs the PER count's two grids.
    window = (["megastep"] * report["megasteps"])[1:3]
    moves, megasteps = PROFILE_CHUNK_MOVES * len(window), len(window)
    want = {"gather_rows": 16 * moves, "backup_update": 2 * moves, "per_sample_count": megasteps,
            "per_sample_summary": megasteps}
    if counts != want or megasteps == 0:
        fail(f"{label}: the trace's device lines count {counts} for the window {window}, want {want}")
    grand = sum(t for t, _ in totals.values())
    top = sorted(totals.items(), key=lambda kv: -kv[1][0])[:5]
    mega = report["timings"]["megastep_s"]
    return {
        "phase_timers": {k: v["count"] for k, v in timers.items()},
        "kernel_counts": counts,
        "device_lines": [f"{ln['plane']} / {ln['line']}" for ln in device],
        "device_ms": grand / 1e3,
        "top5": [{"name": k[:80], "ms": t / 1e3, "count": c, "share": t / grand} for k, (t, c) in top],
        "window": window,
        "megastep_ms_profiled": [t * 1e3 for t in mega[1: 1 + megasteps]],
        "megastep_ms_unprofiled": [t * 1e3 for t in mega[:1] + mega[1 + megasteps:]],
        "trace_mb": traces[0].stat().st_size / 2**20,
        "analyze_s": analyze_s,
        "launches": report["kernel_launches"],
    }


# Slice thirteen's drills: `cli supervise -- train --fused-megastep` at the
# train phase's widths and cuts, a checkpoint every 2 steps to step 12 (the
# torn drill to step 8: the wedge drill's respawn must dispatch past the
# hung intent's sequence number, which the doctor reads as sealed by it);
# the wedge at the 3rd megastep's dispatch (past the first committed
# checkpoint), whose deadline is max(15 s, 10 x the megastep's expected
# wall) under a watchdog polled every 0.5 s; the torn save at step 4.
SUPERVISE_FREQ, SUPERVISE_STEPS, SUPERVISE_TORN_STEPS = 2, 12, 6
SUPERVISE_HANG_MEGASTEP, SUPERVISE_MIN_DEADLINE = 3, 15.0
SUPERVISE_TORN_STEP = 4


def supervisor_events(run: Path) -> list:
    from alphatriangle_tpu_torch.telemetry.ledger import read_ledger

    return [e for e in read_ledger(run / "supervisor.jsonl") if e.get("kind") == "supervisor"]


def run_supervised(label: str, faults: str, steps: int = SUPERVISE_STEPS) -> dict:
    """`cli supervise --run-name <label> -- train --fused-megastep` at the
    train phase's widths and cuts, in a process whose imports of torch,
    numpy and JAX raise, with `faults` armed (once, by a sentinel under
    the phase's root). At the first death, before the respawn gets far:
    the checkpoint directory's listing and `cli doctor --json` of the run.
    Returns the exit code, the children's JSON reports, the events of
    `supervisor.jsonl`, the at-death evidence and the wall."""
    from alphatriangle_tpu_torch.config import TrainConfig
    from alphatriangle_tpu_torch.telemetry.flight import read_flight

    root = RUN_ROOT / label
    run = root / "AlphaTriangleTPUTorch" / "runs" / label
    argv = [
        "supervise", "--run-name", label, "--root-dir", str(root), "--backoff-base", "0.5", "--",
        "train", "--fused-megastep", "--device", "cuda", "--seed", "0",
        "--max-steps", str(steps), "--rollout-chunk", str(TRAIN_CHUNK_MOVES),
        "--min-buffer", str(TRAIN_MIN_BUFFER), "--fused-learner-steps", str(TRAIN_K),
        "--checkpoint-freq", str(SUPERVISE_FREQ), "--no-tensorboard",
        "--dispatch-min-deadline", str(SUPERVISE_MIN_DEADLINE), "--dispatch-watchdog-poll", "0.5",
        "--log-level", "WARNING",
    ]
    env = {**os.environ, "ALPHATRIANGLE_FAULTS": faults,
           "ALPHATRIANGLE_FAULT_STATE_DIR": str(root / "faults")}
    at_death: dict = {}
    done = threading.Event()

    def watch_death():
        while not done.is_set():
            events = supervisor_events(run) if (run / "supervisor.jsonl").exists() else []
            if any(e["event"] == "death" for e in events):
                ckpt = run / "checkpoints"
                # Each entry's name; a step directory's with its files.
                at_death["checkpoints"] = {
                    p.name: sorted(q.name for q in p.iterdir()) if p.is_dir() else None
                    for p in sorted(ckpt.iterdir())
                }
                rc, out = run_reader(["doctor", label, "--root-dir", str(root), "--json"], label)
                at_death["doctor_rc"], at_death["doctor"] = rc, json.loads(out)
                return
            time.sleep(0.05)

    watcher = threading.Thread(target=watch_death, daemon=True)
    out_path, err_path = RUN_ROOT / f"{label}.out", RUN_ROOT / f"{label}.err"
    t0 = time.perf_counter()
    with open(out_path, "w") as out, open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", _NO_TORCH_PARENT + f"sys.exit(main({argv!r}))"],
            cwd=ROOT, stdout=out, stderr=err, text=True, env=env,
        )
        watcher.start()
        try:
            rc = proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            done.set()
            watcher.join(timeout=60)
    wall_s = time.perf_counter() - t0
    stderr = err_path.read_text()
    if "a torch-free process imported" in stderr:
        fail(f"{label}: the supervisor imported torch, numpy or JAX: {stderr[-1000:]}")
    reports = [json.loads(line) for line in out_path.read_text().splitlines() if line.startswith("{")]
    events = supervisor_events(run)
    names = [e["event"] for e in events]
    if rc != 0 or names != ["spawn", "death", "spawn", "complete"] or len(reports) != 1:
        fail(f"{label}: exit {rc}, supervisor.jsonl {names}, {len(reports)} reports; stderr "
             f"{stderr[-3000:]}")
    if "doctor" not in at_death:
        fail(f"{label}: no evidence taken at the death")
    report = reports[0]
    moves = report["lane_moves"] // TrainConfig().SELF_PLAY_BATCH_SIZE
    launches = report["kernel_launches"]
    check_report_losses(report, label)
    want = {"gather_rows": 16 * moves, "backup_update": 2 * moves, "per_sample": report["megasteps"],
            "subtree_promote": 0}
    if report["status"] != "completed" or report["steps"] != steps or launches != want:
        fail(f"{label}: the respawn ended {report['status']} at step {report['steps']}, launches "
             f"{launches} in {moves} searched moves and {report['megasteps']} megasteps, want {want}")
    if report["mode"] != "megastep" or not report["device"].startswith("cuda"):
        fail(f"{label}: the respawn ran {report['mode']} on {report['device']}")
    death, respawn = events[1], events[2]
    flight = read_flight(run / "flight.jsonl")
    first = [r for r in flight if r["time"] < respawn["time"]]
    later = [r for r in flight if r["time"] >= respawn["time"]]
    sealed = [r for r in first if r["phase"] == "seal" and r["family"] == "megastep" and r.get("ok", True)]
    steps_done = len(sealed) * TRAIN_K
    if report["resumed_step"] != death["progress_step"] or death["progress_step"] is None:
        fail(f"{label}: the respawn resumed at {report['resumed_step']}, the newest committed step at the "
             f"death was {death['progress_step']}")
    first_intent = next(r for r in later if r["phase"] == "intent")
    first_mega = next(r for r in later if r["phase"] == "seal" and r["family"] == "megastep")
    return {
        "rc": rc, "events": events, "report": report, "at_death": at_death, "wall_s": wall_s,
        "run": run, "root": root, "first_attempt_flight": first,
        "launches": launches, "searched_moves": moves, "megasteps": report["megasteps"],
        "beacon_launches": report["beacon_launches"],
        "steps_done_before_death": steps_done,
        "steps_lost": steps_done - report["resumed_step"],
        "death_to_respawn_first_intent_s": first_intent["time"] - death["time"],
        "death_to_respawn_first_megastep_s": first_mega["time"] - death["time"],
        "respawn_spawn_to_first_intent_s": first_intent["time"] - respawn["time"],
        "respawn_restore_ms": report["restore_s"] * 1e3,
        "respawn_megastep_ms_p50": report["timings"]["megastep_s_p50"] * 1e3,
        "respawn_run_s": report["timings"]["run_s"],
    }


def supervise_wedge_phase(torch, warmup_chunks: int) -> dict:
    """`cli supervise` with `hang-dispatch` at the 3rd megastep's dispatch:
    the child's watchdog exits 113; supervisor.jsonl must read spawn ->
    death (113, dispatch-hung, family megastep, restart with
    TELEMETRY__BEACONS) -> spawn (those overrides) -> complete; the
    doctor at the death names the hung megastep (exit 4); no child builds a
    kernel (the `_build/` listing unchanged); the respawn resumes at the
    newest committed step, losing at most one cadence,
    writes beacon rows through the card's writer, and its search kernels
    and PER count launch 16 + 2 a searched move and once a megastep."""
    label = "supervise-wedge"
    torch.cuda.empty_cache()  # the card's memory for the children
    hang_at = warmup_chunks + SUPERVISE_HANG_MEGASTEP
    built = build_listing()[0]
    r = run_supervised(label, f"hang-dispatch@after={hang_at}")
    if build_listing()[0] != built:
        fail(f"{label}: the children built kernels: {built} -> {build_listing()[0]}")
    death, respawn = r["events"][1], r["events"][2]
    if not (death["rc"] == 113 and death["verdict"] == "dispatch-hung" and death["family"] == "megastep"
            and death["action"] == "restart" and death["overrides"].get("TELEMETRY__BEACONS") is True
            and respawn["overrides"] == death["overrides"]):
        fail(f"{label}: death {death}, respawn overrides {respawn.get('overrides')}")
    doc = r["at_death"]["doctor"]
    if r["at_death"]["doctor_rc"] != 4 or doc["verdict"] != "dispatch-hung" or doc["family"] != "megastep":
        fail(f"{label}: cli doctor at the death gave exit {r['at_death']['doctor_rc']}: {doc}")
    if r["steps_lost"] > SUPERVISE_FREQ or r["report"]["resumed_step"] < SUPERVISE_FREQ:
        fail(f"{label}: {r['steps_done_before_death']} steps done before the death, resumed at "
             f"{r['report']['resumed_step']}")
    from alphatriangle_tpu_torch.telemetry.ledger import read_ledger

    rows = [b for b in read_ledger(r["run"] / "beacons.jsonl") if b["time"] >= respawn["time"]]
    if not rows or r["beacon_launches"] == 0:
        fail(f"{label}: the respawn wrote {len(rows)} beacon rows in {r['beacon_launches']} launches")
    wedge = json.loads((r["run"] / "wedge_report.json.attempt1").read_text())
    hung = next(x for x in r["first_attempt_flight"] if x["phase"] == "intent" and x["seq"] == hang_at)
    if wedge["seq"] != hang_at or wedge["program"] != hung["program"] or wedge["exit_code"] != 113:
        fail(f"{label}: wedge report {wedge} against the hung intent {hung}")
    r.update({
        "hang_at_dispatch": hang_at, "hung_program": hung["program"], "death": death,
        "wedge_deadline_s": wedge["deadline_s"], "wedge_elapsed_s": wedge["elapsed_s"],
        "hang_to_death_s": death["time"] - hung["time"], "beacon_rows": len(rows),
    })
    return r


def supervise_torn_phase(torch) -> dict:
    """`cli supervise` with `sigkill-save` at step 4: the child dies by
    SIGKILL between the state and meta writes and the commit marker,
    leaving an uncommitted step_4 (seen at the death); the supervisor
    restarts from step 2, the newest committed, and the run completes."""
    label = "supervise-torn"
    torch.cuda.empty_cache()
    r = run_supervised(label, f"sigkill-save@step={SUPERVISE_TORN_STEP}", SUPERVISE_TORN_STEPS)
    death = r["events"][1]
    prior = SUPERVISE_TORN_STEP - SUPERVISE_FREQ
    torn = f"step_{SUPERVISE_TORN_STEP:08d}"
    listing = r["at_death"]["checkpoints"]
    if not (death["rc"] == -signal.SIGKILL and death["action"] == "restart" and death["progress_step"] == prior
            and r["report"]["resumed_step"] == prior):
        fail(f"{label}: death {death}, the respawn resumed at {r['report']['resumed_step']}")
    if (listing.get(torn) != ["train_state.pt"] or f"{torn}.meta.json" not in listing
            or f"{torn}.commit" in listing or f"step_{prior:08d}.commit" not in listing):
        fail(f"{label}: the checkpoints at the death: {listing}")
    if not (r["root"] / "faults" / "sigkill-save.fired").exists():
        fail(f"{label}: the sigkill-save fault never fired")
    r.update({"death": death, "checkpoints_at_death": listing})
    return r


def doctor_phase(prreport: dict, flreport: dict, swreport: dict) -> dict:
    """`cli doctor --json` (in a process whose imports of torch, numpy and
    JAX raise) over the beacon phase's wedged serve run (dispatch-hung,
    naming its last beacon, exit 4), the fleet phase's parent (the fleet
    branch: the deaths and respawns its fleet.jsonl counted) and the
    supervise-wedge run once it completed (clean: the supervisor moved the
    wedge report aside and the respawn sealed past the hung dispatch);
    with the preempt-resume phase's first run (preempted, exit 7) and the
    supervise-wedge run at its death (dispatch-hung, exit 4), taken in
    their phases. Each exit code must be its verdict's."""
    from alphatriangle_tpu_torch.telemetry.flight import DOCTOR_EXIT_CODES

    label = "doctor"
    out = {"preempted": {"rc": prreport["doctor_rc"], **prreport["doctor"]},
           "supervise_wedge_at_death": {"rc": swreport["at_death"]["doctor_rc"],
                                        **swreport["at_death"]["doctor"]}}
    fleet_root = RUN_ROOT / "fleet"
    for name, args in (
        ("beacon_wedge", [str(RUN_ROOT / "beacons")]),
        ("fleet_parent", ["fleet", "--root-dir", str(fleet_root)]),
        ("supervise_wedge_done", ["supervise-wedge", "--root-dir", str(RUN_ROOT / "supervise-wedge")]),
    ):
        rc, text = run_reader(["doctor", *args, "--json"], label)
        out[name] = {"rc": rc, **json.loads(text)}
    for name, v in out.items():
        if v["rc"] != DOCTOR_EXIT_CODES[v["verdict"]] or v["rc"] != v["exit_code"]:
            fail(f"{label}: {name} exit {v['rc']} for the verdict {v['verdict']}")
    want = {"preempted": "preempted", "supervise_wedge_at_death": "dispatch-hung",
            "beacon_wedge": "dispatch-hung", "supervise_wedge_done": "clean"}
    got = {name: out[name]["verdict"] for name in want}
    if got != want:
        fail(f"{label}: verdicts {got}, want {want}")
    if "last beacon: serve/b64 phase=search_wave index=0" not in out["beacon_wedge"]["detail"]:
        fail(f"{label}: the beacon run's verdict does not name its beacon: {out['beacon_wedge']['detail']}")
    events = fleet_events(fleet_root / "AlphaTriangleTPUTorch" / "runs" / "fleet" / "fleet.jsonl")
    ev = out["fleet_parent"]["evidence"]
    counted = {k: sum(1 for e in events if e["event"] == k) for k in ("death", "respawn")}
    if (ev["deaths"], ev["respawns"]) != (counted["death"], counted["respawn"]) or counted["death"] < 2:
        fail(f"{label}: the fleet branch counted {ev['deaths']} deaths and {ev['respawns']} respawns, "
             f"fleet.jsonl {counted} (the fleet report: {flreport['cli']['report']['fleet']})")
    return out


def readers_phase(kind: str) -> dict:
    """The commands that read a run, each in a process whose imports of
    torch, numpy and JAX raise, over the run directories earlier phases
    left: `cli trace` of the profile run (rows for its phase spans),
    `cli trace --fleet` of the fleet parent (events of every replica, flow
    arrows), `cli watch --once` of the supervise-wedge run (a frame naming
    it), `cli compare` of that run against itself (parity), `cli slo
    --json` and `cli perf --json` of the fleet parent (the exit code the
    report's; the fleet_* fields); then `cli devices` (it imports torch):
    the card, one device."""
    label = "readers"
    out: dict = {}
    t0 = time.perf_counter()
    rc, text = run_reader(["trace", "profile", "--root-dir", str(RUN_ROOT / "profile")], label)
    spans = [line.split()[0] for line in text.splitlines()[1:] if line.strip() and not line.startswith("full")]
    if rc != 0 or not {"rollout", "megastep"} <= set(spans):
        fail(f"{label}: cli trace exit {rc}: {text[:500]}")
    out["trace_spans"] = spans
    fleet_root = RUN_ROOT / "fleet"
    fleet_dir = fleet_root / "AlphaTriangleTPUTorch" / "runs" / "fleet"
    rc, text = run_reader(["trace", "fleet", "--root-dir", str(fleet_root), "--fleet"], label)
    merged = json.loads((fleet_dir / "trace_fleet.json").read_text())
    names = [m["args"]["name"] for m in merged["traceEvents"] if m.get("name") == "process_name"]
    replicas = {n.split()[1] for n in names if n.startswith("replica ")}
    flows = sum(1 for e in merged["traceEvents"] if e.get("cat") == "fleet-flow" and e.get("ph") in "tf")
    if rc != 0 or replicas != {f"replica_r{i}" for i in range(FLEET_REPLICAS)} or flows == 0:
        fail(f"{label}: cli trace --fleet exit {rc}, replicas {replicas}, {flows} flow arrows: {text}")
    out["trace_fleet"] = {"processes": len(names), "replicas": sorted(replicas), "flows": flows,
                          "events": len(merged["traceEvents"]), "summary": text.strip().splitlines()}
    rc, text = run_reader(
        ["watch", "--run-name", "supervise-wedge", "--root-dir", str(RUN_ROOT / "supervise-wedge"), "--once"],
        label,
    )
    if rc != 0 or not text.startswith(f"run supervise-wedge @ step {SUPERVISE_STEPS}"):
        fail(f"{label}: cli watch exit {rc}: {text[:500]}")
    out["watch_frame"] = text.strip().splitlines()
    ledger = str(RUN_ROOT / "supervise-wedge" / "AlphaTriangleTPUTorch" / "runs" / "supervise-wedge")
    rc, text = run_reader(["compare", ledger, ledger, "--json"], label)
    compared = json.loads(text) if rc == 0 else {}
    if rc != 0 or compared.get("regressions") != [] or not any(
        row["status"] == "ok" for row in compared.get("rows", [])
    ):
        fail(f"{label}: cli compare of a run against itself exit {rc}: {text[:500]}")
    out["compare_rows"] = [row["metric"] for row in compared["rows"] if row["status"] == "ok"]
    rc, text = run_reader(["slo", str(fleet_dir), "--json"], label)
    slo = json.loads(text)
    if rc != slo["exit_code"]:
        fail(f"{label}: cli slo exit {rc}, its report's {slo['exit_code']}")
    out["slo"] = {"rc": rc, "status": slo["status"],
                  "slos": {s["name"]: s["status"] for s in slo["slos"]}}
    rc, text = run_reader(["perf", str(fleet_dir), "--json"], label)
    perf = json.loads(text) if rc == 0 else {}
    fleet_fields = {k: v for k, v in perf.items() if k.startswith("fleet_")}
    if rc != 0 or not fleet_fields.get("fleet_deaths"):
        fail(f"{label}: cli perf of the fleet parent exit {rc}, fields {sorted(fleet_fields)}")
    out["perf_fleet"] = fleet_fields
    proc = subprocess.run(
        [sys.executable, "-m", "alphatriangle_tpu_torch.cli", "devices"], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    if proc.returncode != 0 or kind not in proc.stdout or ": 1 CUDA device(s)" not in proc.stdout:
        fail(f"{label}: cli devices exit {proc.returncode}: {proc.stdout} {proc.stderr[-500:]}")
    out["devices"] = proc.stdout.strip().splitlines()
    out["phase_s"] = time.perf_counter() - t0
    return out


# Slice fourteen: `cli train --distributed --fused-megastep` at the train
# phase's widths and cuts to 4 megasteps, a checkpoint every megastep;
# megasteps 1-2 of each rank traced (`--profile`, whose window counts
# megasteps) for the all-reduce's share.
DP_STEPS = TRAIN_K * TRAIN_MEGASTEPS
DP_TRACED = 2  # --profile traces megasteps 1-2 of the run's 4


def dp_argv(run: str, steps: int, fresh: bool = True) -> list:
    return [
        "train", "--fused-megastep", "--device", "cuda", "--seed", "0",
        "--rollout-chunk", str(TRAIN_CHUNK_MOVES), "--min-buffer", str(TRAIN_MIN_BUFFER),
        "--fused-learner-steps", str(TRAIN_K), "--max-steps", str(steps),
        "--checkpoint-freq", str(TRAIN_K), "--keep-checkpoints", "0", "--root-dir", str(RUN_ROOT / "dp"),
        "--run-name", run, "--no-tensorboard", "--log-level", "WARNING",
        *(["--no-auto-resume"] if fresh else []),
    ]


def dp_flags(world: int, rank: int, port: int, backend: str) -> list:
    return ["--distributed", "--coordinator", f"localhost:{port}", "--num-processes", str(world),
            "--process-id", str(rank), "--dist-backend", backend]


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def launch_all(jobs: list, timeout: float = 600) -> list:
    """Start every (label, args, extra env) job at once as `python -m
    alphatriangle_tpu_torch.cli <args>`, wait for all; each job's (exit
    code, JSON report, pid, unix time just before its spawn). No process
    outlives the call."""
    procs, files = [], []
    try:
        for label, args, env in jobs:
            out = open(RUN_ROOT / f"{label}.out", "w")
            err = open(RUN_ROOT / f"{label}.err", "w")
            files += [out, err]
            t_spawn = time.time()
            proc = subprocess.Popen([sys.executable, "-m", "alphatriangle_tpu_torch.cli", *args], cwd=ROOT,
                                    stdout=out, stderr=err, text=True, env={**os.environ, **env})
            procs.append((label, proc, t_spawn))
        deadline = time.monotonic() + timeout
        for _, proc, _ in procs:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for _, proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in files:
            f.close()
    results = []
    for label, proc, t_spawn in procs:
        lines = (RUN_ROOT / f"{label}.out").read_text().strip().splitlines()
        err = (RUN_ROOT / f"{label}.err").read_text()
        try:
            report = json.loads(lines[-1])
        except (IndexError, ValueError):
            fail(f"{label}: exit {proc.returncode} without a JSON report; stderr: {err[-3000:]}")
        if proc.returncode != 0 or report["status"] != "completed":
            fail(f"{label}: exit {proc.returncode}, status {report['status']} ({report['error']}); "
                 f"stderr: {err[-3000:]}")
        results.append((report, proc.pid, t_spawn))
    return results


def dp_trace_share(run: Path, pid: int) -> dict:
    """The traced megasteps of rank `pid` (the `--profile` window's two):
    their wall in the trace and the `dp.all_reduce` label's host time
    inside them (and the label's device range, where the trace has one),
    as a share of that wall."""
    traces = list((run / "profile_data").glob(f"*_{pid}.*.pt.trace.json"))
    if len(traces) != 1:
        fail(f"dp: {len(traces)} traces of rank pid {pid} in {run / 'profile_data'}")
    events = json.loads(traces[0].read_text())["traceEvents"]
    mega = [e for e in events if e.get("name") == "phase/megastep" and e.get("ph") == "X"
            and e.get("cat") == "user_annotation"]
    if len(mega) != DP_TRACED:
        fail(f"dp: the trace of pid {pid} holds {len(mega)} megasteps, not {DP_TRACED}")
    inside = [e for e in events if e.get("name") == "dp.all_reduce" and e.get("ph") == "X"
              and any(m["ts"] <= e["ts"] < m["ts"] + m["dur"] for m in mega)]
    host = [e["dur"] for e in inside if e.get("cat") == "user_annotation"]
    device = [e["dur"] for e in inside if e.get("cat") == "gpu_user_annotation"]
    if len(host) != TRAIN_K * DP_TRACED:
        fail(f"dp: {len(host)} dp.all_reduce calls in the traced megasteps of pid {pid}, "
             f"not {TRAIN_K * DP_TRACED}")
    wall = sum(m["dur"] for m in mega)
    return {
        "megastep_ms": wall / DP_TRACED / 1e3,
        "all_reduce_host_ms": sum(host) / DP_TRACED / 1e3,
        "all_reduce_share": sum(host) / wall,
        "all_reduce_device_ms": sum(device) / DP_TRACED / 1e3 if device else None,
        "calls": len(host) // DP_TRACED,
    }


def dp_rank_figures(report: dict, pid: int, t_spawn: float, run: Path, label: str) -> dict:
    """One rank's checks (finite losses, 16 + 2 search launches a
    searched move and one PER count a megastep) and its figures."""
    check_report_losses(report, label)
    moves = (report["warmup_chunks"] + report["megasteps"]) * TRAIN_CHUNK_MOVES
    launches = report["kernel_launches"]
    want = {"gather_rows": 16 * moves, "backup_update": 2 * moves, "per_sample": report["megasteps"],
            "subtree_promote": 0}
    if launches != want or report["megasteps"] != TRAIN_MEGASTEPS:
        fail(f"{label}: launches {launches} over {moves} searched moves and {report['megasteps']} "
             f"megasteps, want {want} and {TRAIN_MEGASTEPS} megasteps")
    mega = report["timings"]["megastep_s"]
    return {
        "rank": report["dp"]["rank"], "megastep_ms": [t * 1e3 for t in mega],
        "megastep_ms_p50": statistics.median(mega) * 1e3,
        "spawn_to_first_megastep_s": report["timings"]["first_megastep_unix"] - t_spawn,
        "peak_gb": report["peak_device_bytes"] / 2**30, "trace": dp_trace_share(run, pid),
        "launches": launches, "searched_moves": moves, "megasteps": report["megasteps"],
        "warmup_chunks": report["warmup_chunks"], "lanes": report["lane_moves"] // moves,
    }


def dp_params(torch, run: str, step: int) -> dict:
    path = RUN_ROOT / "dp" / "AlphaTriangleTPUTorch" / "runs" / run / "checkpoints" / f"step_{step:08d}"
    return torch.load(path / "train_state.pt", map_location="cpu", weights_only=True)["params"]


def train_dp1_phase(torch) -> dict:
    """A world of one over NCCL to 4 megasteps. Its parameters after the
    first megastep must equal those of the same run without
    --distributed: the train phase's (`run_training` at the same
    configuration), bit for bit. If they do not, two `cli train` runs
    without --distributed (together) decide: bit for bit where those two
    agree bit for bit, else within rtol 2e-4, atol 2e-5."""
    [(rd, pid, t_spawn)] = launch_all([
        ("train-dp1", dp_argv("dp1", DP_STEPS) + ["--profile"] + dp_flags(1, 0, free_port(), "auto"), {}),
    ])
    if (rd["dp"]["backend"], rd["dp"]["world"]) != ("nccl", 1):
        fail(f"train-dp1: report names {rd['dp']}, not NCCL over a world of one")
    d = dp_params(torch, "dp1", TRAIN_K)
    ref, repeatable, reference = FIRST_MEGASTEP_PARAMS, None, "train phase"
    if set(ref) != set(d):
        fail(f"train-dp1: parameter names differ from the train phase's: {sorted(set(ref) ^ set(d))[:4]}")
    if not all(torch.equal(ref[n], d[n]) for n in d):
        # To the same step count: the LR and PER-beta schedules follow it.
        launch_all([(f"train-dp1-plain-{x}", dp_argv(f"plain-{x}", DP_STEPS), {}) for x in "ab"])
        ref, reference = dp_params(torch, "plain-a", TRAIN_K), "cli train runs"
        b = dp_params(torch, "plain-b", TRAIN_K)
        repeatable = all(torch.equal(ref[n], b[n]) for n in ref)
        for name in ref:
            if repeatable and not torch.equal(ref[name], d[name]):
                fail(f"train-dp1: {name} after the first megastep differs from the undistributed run's "
                     "(which repeats bit for bit)")
            if not repeatable and not torch.allclose(d[name], ref[name], rtol=2e-4, atol=2e-5):
                fail(f"train-dp1: {name} after the first megastep is not within rtol 2e-4, atol 2e-5")
    run = RUN_ROOT / "dp" / "AlphaTriangleTPUTorch" / "runs" / "dp1"
    rank = dp_rank_figures(rd, pid, t_spawn, run, "train-dp1")
    return {
        "backend": "nccl", "world": 1, "reference": reference, "undistributed_repeatable": repeatable,
        "params_bit_equal": all(torch.equal(ref[n], d[n]) for n in d),
        "ranks": [rank], "launches": rank["launches"], "searched_moves": rank["searched_moves"],
        "megasteps": rank["megasteps"],
    }


def train_dp2_shared_phase(torch) -> tuple:
    """Two ranks sharing the card over gloo, each with 256 lanes, a batch
    of 128 and a 125,000-slot ring shard. Their parameter digests must
    agree after every megastep, each rank launch the search kernels 16 +
    2 times a searched move and the PER count once a megastep, rank 0
    alone write the run's singletons. Returns the report and the resume
    check: the checkpoint must resume in one process (`cli train
    --fused-megastep`) with both shards' rows."""
    port = free_port()
    results = launch_all([
        (f"train-dp2-rank{r}", dp_argv("dp2", DP_STEPS) + ["--profile"] + dp_flags(2, r, port, "gloo"), {})
        for r in range(2)
    ])
    (r0, pid0, _), (r1, _, _) = results
    if r0["dp"]["param_checksums"] != r1["dp"]["param_checksums"] or \
            len(r0["dp"]["param_checksums"]) != TRAIN_MEGASTEPS:
        fail(f"train-dp2-shared: parameter digests differ or miss a megastep: {r0['dp']} / {r1['dp']}")
    run = RUN_ROOT / "dp" / "AlphaTriangleTPUTorch" / "runs" / "dp2"
    ranks = [dp_rank_figures(r, pid, t, run, f"train-dp2-rank{i}") for i, (r, pid, t) in enumerate(results)]
    if [r["lanes"] for r in ranks] != [DP2_LANES, DP2_LANES]:
        fail(f"train-dp2-shared: lanes per rank {[r['lanes'] for r in ranks]}, not {DP2_LANES}")
    # Rank 0 alone writes the run directory's singletons.
    health = json.loads((run / "health.json").read_text())
    kinds = [json.loads(line).get("kind") for line in (run / "metrics.jsonl").read_text().splitlines()]
    steps = sorted(p.name for p in (run / "checkpoints").iterdir() if p.is_dir())
    want_steps = [f"step_{TRAIN_K * (i + 1):08d}" for i in range(TRAIN_MEGASTEPS)]
    meta = json.loads((run / "checkpoints" / f"step_{DP_STEPS:08d}.meta.json").read_text())
    if (health["pid"] != pid0 or r1["stats_writers"] or r1["live_metrics"] is not None
            or kinds.count("device_stats") != r0["warmup_chunks"] + r0["megasteps"]
            or steps != want_steps or meta["global_step"] != DP_STEPS
            or not (run / "configs.json").exists()):
        fail(f"train-dp2-shared: singletons not rank 0's alone: heartbeat pid {health['pid']} (rank 0 "
             f"{pid0}), rank 1 writers {r1['stats_writers']}, {kinds.count('device_stats')} device_stats "
             f"records, checkpoints {steps}, meta {meta}")
    rows = r0["buffer_size"] + r1["buffer_size"]
    launches = {k: ranks[0]["launches"][k] + ranks[1]["launches"][k] for k in ranks[0]["launches"]}
    report = {
        "backend": "gloo", "world": 2, "ranks": ranks, "launches": launches,
        "searched_moves": sum(r["searched_moves"] for r in ranks),
        "megasteps": sum(r["megasteps"] for r in ranks), "param_checksums": r0["dp"]["param_checksums"],
    }

    def resume() -> None:
        """The one-process resume (its own process: `run_phases` runs it
        beside the torch-free readers and the small reference checks)."""
        [(res, _, _)] = launch_all([("train-dp2-resume", dp_argv("dp2", DP_STEPS + TRAIN_K, fresh=False), {})])
        if (res["resumed_step"], res["restored_rows"], res["steps"]) != (DP_STEPS, rows, DP_STEPS + TRAIN_K) \
                or res["dp"]["backend"] is not None or res["kernel_launches"]["per_sample"] != 1:
            fail(f"train-dp2-shared: the one-process resume gave step {res['resumed_step']}, "
                 f"{res['restored_rows']} rows (want {DP_STEPS}, {rows}), launches {res['kernel_launches']}")
        check_report_losses(res, "train-dp2-resume")
        report["resume"] = {"resumed_step": res["resumed_step"], "restored_rows": res["restored_rows"],
                            "restore_s": res["restore_s"], "megastep_ms": res["timings"]["megastep_s"][0] * 1e3,
                            "beside": "doctor, readers and reference phases and the mesh pair"}

    return report, resume


def in_background(fn):
    """Run `fn` on a thread; returns a join that re-raises its failure."""
    box: dict = {}

    def run():
        try:
            fn()
        except BaseException as exc:  # a fail() in the thread ends the script at the join
            box["exc"] = exc

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def join() -> None:
        thread.join()
        if "exc" in box:
            raise box["exc"]

    return join


def say_dp(label: str, r: dict, card: str) -> None:
    for rk in r["ranks"]:
        tr = rk["trace"]
        dev = "" if tr["all_reduce_device_ms"] is None else f", device {tr['all_reduce_device_ms']:.2f} ms"
        say(
            f"{label} rank {rk['rank']} ({r['backend']}, world {r['world']}, {rk['lanes']} lanes): megastep "
            f"p50 {rk['megastep_ms_p50']:.1f} ms ({', '.join(f'{t:.1f}' for t in rk['megastep_ms'])}); "
            f"dp.all_reduce {tr['all_reduce_host_ms']:.2f} ms in {tr['calls']} calls a megastep{dev}, "
            f"{tr['all_reduce_share']:.2%} of the traced megasteps ({tr['megastep_ms']:.1f} ms each); peak "
            f"{rk['peak_gb']:.2f} GiB; spawn to first megastep {rk['spawn_to_first_megastep_s']:.1f} s; "
            f"launches {rk['launches']} [{card}]"
        )


# Slice sixteen: the overlapped loop over dp ranks, and the memory,
# roofline and build-cache plane. train-dp2-shared-async: the dp2 pair's
# widths (512 lanes over two gloo ranks on the card, 256 a rank, a batch
# of 256 over the ranks, a 125,000-slot shard each) in `cli train
# --distributed --async-rollouts --device-replay on`, two producer
# streams a rank, cut in depth: 4-move chunks (the auto-tune's two timed
# chunks then hold the 5-step returns' first rows, so the learner starts
# in the traced beats 1-2), a replay ratio of 0.25 (the learner then
# waits for the producers' rows past its first steps) and 4 learner
# steps.
ASYNC_DP_CHUNK_MOVES, ASYNC_DP_STREAMS, ASYNC_DP_RATIO, ASYNC_DP_STEPS = 4, 2, 0.25, 4


def async_dp_argv(rank: int, port: int) -> list:
    return [
        "train", "--async-rollouts", "--device-replay", "on", "--device", "cuda", "--seed", "0",
        "--workers", str(ASYNC_DP_STREAMS), "--rollout-chunk", str(ASYNC_DP_CHUNK_MOVES),
        "--min-buffer", str(TRAIN_MIN_BUFFER), "--replay-ratio", str(ASYNC_DP_RATIO),
        # A root of its own: train-dp2-shared's resume auto-resumes the newest
        # run under its root.
        "--max-steps", str(ASYNC_DP_STEPS), "--root-dir", str(RUN_ROOT / "dp-async"), "--run-name", "dp2-async",
        "--no-tensorboard", "--log-level", "WARNING", "--no-auto-resume", "--profile",
        *dp_flags(2, rank, port, "gloo"),
    ]


def beats_trace_share(run: Path, pid: int) -> dict:
    """Rank `pid`'s traced beats (the `--profile` window, beats 1-2 of the
    overlapped loop: from their first phase span to the trace's last
    event) and the `dp.all_reduce` label's host time inside them."""
    traces = list((run / "profile_data").glob(f"*_{pid}.*.pt.trace.json"))
    if len(traces) != 1:
        fail(f"train-dp2-shared-async: {len(traces)} traces of rank pid {pid} in {run / 'profile_data'}")
    events = [e for e in json.loads(traces[0].read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    start = min(e["ts"] for e in events
                if str(e.get("name", "")).startswith("phase/") and e.get("cat") == "user_annotation")
    wall = max(e["ts"] + e["dur"] for e in events) - start
    host = [e["dur"] for e in events if e.get("name") == "dp.all_reduce"
            and e.get("cat") == "user_annotation" and e["ts"] >= start]
    return {"traced_ms": wall / 1e3, "all_reduce_host_ms": sum(host) / 1e3,
            "all_reduce_share": sum(host) / wall, "calls": len(host)}


def train_dp2_shared_async_phase(torch) -> dict:
    """Two gloo ranks sharing the card run the overlapped loop to
    ASYNC_DP_STEPS learner steps. Both must report the same steps, beats
    and tuned chunk, the same parameter digest after every beat that
    trained, the search kernels 16 + 2 times a move of every chunk they
    played (no PER count: each shard samples on its host tree), and end
    within the phase's limit."""
    port = free_port()
    results = launch_all(
        [(f"train-dp2-async-rank{r}", async_dp_argv(r, port), {}) for r in range(2)], timeout=420,
    )
    (r0, pid0, _), (r1, _, _) = results
    agreed = [(r["steps"], r["iterations"], r["tuned_chunk_moves"]) for r in (r0, r1)]
    if agreed[0] != agreed[1] or r0["steps"] != ASYNC_DP_STEPS:
        fail(f"train-dp2-shared-async: (steps, beats, tuned chunk) per rank {agreed}, want equal at "
             f"{ASYNC_DP_STEPS} steps")
    digests = r0["dp"]["param_checksums"]
    if not digests or digests != r1["dp"]["param_checksums"]:
        fail(f"train-dp2-shared-async: parameter digests differ or are missing: {r0['dp']} / {r1['dp']}")
    run = RUN_ROOT / "dp-async" / "AlphaTriangleTPUTorch" / "runs" / "dp2-async"
    ranks = []
    for i, (r, pid, t_spawn) in enumerate(results):
        label = f"train-dp2-async-rank{i}"
        check_report_losses(r, label)
        moves = r["chunk_moves"]
        want = {"gather_rows": 16 * moves, "backup_update": 2 * moves, "per_sample": 0, "subtree_promote": 0}
        if r["kernel_launches"] != want or r["mode"] != "async" or r["replay_ring"] != "device":
            fail(f"{label}: launches {r['kernel_launches']} over {moves} searched moves (want {want}), "
                 f"mode {r['mode']}, ring {r['replay_ring']}")
        if r["lane_moves"] % DP2_LANES or set(r["harvests_by_stream"]) != {"0", "1"}:
            fail(f"{label}: {r['lane_moves']} lane moves (not a multiple of {DP2_LANES} lanes) or harvests "
                 f"by stream {r['harvests_by_stream']}")
        t = r["timings"]
        ranks.append({
            "rank": r["dp"]["rank"], "steps_per_s": t["learner_steps_per_s"], "run_s": t["run_s"],
            "queue_depth_max": r["queue_depth_max"], "producer_chunk_ms_p50":
                None if t["producer_chunk_s_p50"] is None else t["producer_chunk_s_p50"] * 1e3,
            "tuned_chunk_moves": r["tuned_chunk_moves"], "beats": r["iterations"],
            "harvests_by_stream": r["harvests_by_stream"], "replay_ratio": r["replay_ratio"],
            "searched_moves": moves, "launches": r["kernel_launches"], "lane_moves": r["lane_moves"],
            "peak_gb": r["peak_device_bytes"] / 2**30, "spawn_to_end_s": time.time() - t_spawn,
            "trace": beats_trace_share(run, pid),
        })
    utils = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    utils = [u for u in utils if u.get("kind") == "util"]
    launches = {k: ranks[0]["launches"][k] + ranks[1]["launches"][k] for k in ranks[0]["launches"]}
    return {
        "backend": "gloo", "world": 2, "ranks": ranks, "launches": launches,
        "searched_moves": sum(r["searched_moves"] for r in ranks), "param_checksums": digests,
        "digests_compared": len(digests), "run_dir": str(run),
        "compile_cache": {k: utils[-1].get(f"compile_cache_{k}") for k in ("hits", "misses")} if utils else None,
    }


def say_dp_async(r: dict, card: str) -> None:
    for rk in r["ranks"]:
        tr = rk["trace"]
        p50 = "n/a" if rk["producer_chunk_ms_p50"] is None else f"{rk['producer_chunk_ms_p50']:.1f} ms"
        say(
            f"train-dp2-shared-async rank {rk['rank']} (gloo, world 2, {DP2_LANES} lanes, "
            f"{ASYNC_DP_STREAMS} streams): {rk['steps_per_s']:.3f} learner steps/s over {rk['run_s']:.1f} s; "
            f"queue depth max {rk['queue_depth_max']}; producer chunk p50 {p50} (tuned to "
            f"{rk['tuned_chunk_moves']} moves); {rk['beats']} beats; harvests {rk['harvests_by_stream']}; "
            f"replay ratio {rk['replay_ratio']}; dp.all_reduce {tr['all_reduce_host_ms']:.2f} ms in "
            f"{tr['calls']} calls, {tr['all_reduce_share']:.2%} of the traced beats ({tr['traced_ms']:.1f} ms); "
            f"peak {rk['peak_gb']:.2f} GiB; launches {rk['launches']} [{card}]"
        )
    say(
        f"train-dp2-shared-async: parameter digests equal on both ranks after each of the "
        f"{r['digests_compared']} beats that trained; rank 0's util records count the build cache's "
        f"{r['compile_cache']} [{card}]"
    )


# The memory plane: `cli warm` and `cli fit` at the default plan (the
# card's flagship scale, `bench_config.py`: 512 lanes, 16-move chunks,
# Gumbel roots with playout caps, batch 256, K = 16, a 10,000-slot ring),
# `cli fit --limit-gb 1` (over; its measured programs cut to the search),
# and `cli mem` / `cli roofline` on the train-dp2-shared-async run and on
# the serve-run phase's service run.
H100_BALANCE = round(989.4e12 / 3350e9, 4)


def memory_plane_phase(torch) -> dict:
    """`cli warm` and `cli fit`, then `cli fit --limit-gb 1`; each in a
    process of its own. Returns their figures; `memory_readers` checks
    the run readers once the runs they read exist."""
    t0 = time.perf_counter()
    rc, warm = run_cli(["warm", "--device", "cuda"], "memplane-warm", 600)
    warm_s = time.perf_counter() - t0
    bad = [row for row in warm["programs"] if row["status"] != "ran"]
    if rc != 0 or bad:
        fail(f"memory-plane: cli warm exit {rc}, programs not run: {bad}")
    t0 = time.perf_counter()
    rc, fit = run_cli(["fit", "--device", "cuda", "--json"], "memplane-fit", 600)
    fit_s = time.perf_counter() - t0
    programs = [r for r in fit["records"] if r.get("category") == "program"]
    if rc != 0 or fit["exit"] != 0 or fit["limit_source"] != "device" or len(programs) < 5:
        fail(f"memory-plane: cli fit exit {rc} ({fit['reason']}), {len(programs)} measured programs")
    t0 = time.perf_counter()
    rc1, fit1 = run_cli(["fit", "--device", "cuda", "--json", "--limit-gb", "1", "--programs", "search"],
                        "memplane-fit-1gb", 600)
    fit1_s = time.perf_counter() - t0
    if rc1 != 1 or fit1["exit"] != 1 or fit1["bytes_limit"] != 2**30:
        fail(f"memory-plane: cli fit --limit-gb 1 exit {rc1} ({fit1['reason']}), want 1")
    return {
        "warm": {"seconds": warm_s, "programs": {r["program"]: r["seconds"] for r in warm["programs"]},
                 "hits": warm["stats"]["hits"], "misses": warm["stats"]["misses"]},
        "fit": {"seconds": fit_s, "budget": fit["budget"], "limit": fit["bytes_limit"],
                "reason": fit["reason"],
                "programs": {r["program"]: {"peak": r["peak"], "argument": r["bytes"]["argument"]}
                             for r in programs}},
        "fit_1gb": {"seconds": fit1_s, "exit": rc1, "reason": fit1["reason"],
                    "budget": fit1["budget"]["total_bytes"]},
    }


def memory_readers(train_run: str, serve_run: str) -> dict:
    """`cli mem` and `cli roofline` (torch-free) on the overlapped dp run
    and on the served run: exit 0; the train run's roofline has rows for
    its self-play and learner programs, the served run's for its search
    (`serve/b<B>`), both at the H100 table's machine balance."""
    out = {}
    rc, text = run_reader(["mem", train_run, "--json"], "memory-plane mem")
    mem = json.loads(text) if rc == 0 else None
    if rc != 0 or not mem["records"] or mem["budget"]["train_state_bytes"] <= 0:
        fail(f"memory-plane: cli mem exit {rc} on {train_run}")
    out["mem"] = {"budget": mem["budget"], "components": sorted({r["component"] for r in mem["records"]})}
    for name, run, families in (("train", train_run, ("rollout", "learner")), ("serve", serve_run, ("serve",))):
        rc, text = run_reader(["roofline", run, "--json"], f"memory-plane roofline {name}")
        roof = json.loads(text) if rc == 0 else None
        have = {p["family"] for p in (roof or {}).get("programs") or [] if p.get("flops")}
        if rc != 0 or not set(families) <= have or roof["machine_balance_flops_per_byte"] != H100_BALANCE \
                or roof["peak_hbm_source"] != "table":
            fail(f"memory-plane: cli roofline exit {rc} on {run}: families with costs {sorted(have)} (want "
                 f"{families}), balance {None if roof is None else roof['machine_balance_flops_per_byte']}")
        out[f"roofline_{name}"] = {
            "balance": roof["machine_balance_flops_per_byte"], "peak_hbm_gbps": roof["peak_hbm_gbps"],
            "attribution": roof["attribution"],
            "programs": {p["program"]: {k: p.get(k) for k in ("count", "wall_s_p50", "intensity", "bound",
                                                               "roofline_fraction")}
                         for p in roof["programs"]},
        }
    return out


def say_memory_plane(r: dict, train_peak_gb: float, card: str) -> None:
    w, f, f1 = r["warm"], r["fit"], r["fit_1gb"]
    say(f"memory-plane: cli warm exit 0 in {w['seconds']:.1f} s; seconds by program "
        f"{json.dumps(w['programs'])}; build cache hits {w['hits']}, misses {w['misses']} [{card}]")
    budget = f["budget"]["total_bytes"]
    say(f"memory-plane: cli fit exit 0 in {f['seconds']:.1f} s: budget {budget / 2**30:.3f} GiB ("
        + ", ".join(f"{k} {v / 2**30:.3f}" for k, v in f["budget"].items() if k.endswith("_bytes") and
                    k != "total_bytes")
        + f" GiB) of {f['limit'] / 2**30:.1f} GiB; the train phase's max_memory_allocated "
        f"{train_peak_gb:.3f} GiB, budget / peak {budget / 2**30 / train_peak_gb:.3f}; measured peaks "
        + json.dumps({k: round(v["peak"] / 2**30, 3) for k, v in f["programs"].items()}) + f" GiB [{card}]")
    say(f"memory-plane: cli fit --limit-gb 1 exit 1 in {f1['seconds']:.1f} s ({f1['reason']}) [{card}]")
    m = r["readers"]
    say(f"memory-plane: cli mem exit 0: {m['mem']['components']}, budget {json.dumps(m['mem']['budget'])}")
    for name in ("train", "serve"):
        roof = m[f"roofline_{name}"]
        say(f"memory-plane: cli roofline ({name} run) exit 0: balance {roof['balance']} FLOP/B at "
            f"{roof['peak_hbm_gbps']} GB/s; {json.dumps(roof['programs'])}; attribution "
            f"{json.dumps(roof['attribution'])} [{card}]")


# Slice seventeen: the autotuner and the single-state API. `cli tune` at
# the flagship plan (`bench_config.py`: 512 lanes, 16-move chunks, K = 16,
# a 10,000-row ring, megastep mode on the card) over a pinned space: B and
# B/2, the plan's chunk and K, the plan's capacity and TUNE_CAP_OVER, whose
# ring alone (~1,700 B a row) exceeds any card's memory. Then the tuned
# preset trains TUNE_TRAIN_STEPS learner steps (two megasteps of K), and
# `tune --calibrate` that run re-tunes under a limit of
# TUNE_LIMIT_FRACTION of the first tune's measured budget at B: the search's
# and the chunk's peaks grow with the lanes while the learner state and
# the small ring do not, so the budget at B/2 is a little over half of B's,
# and three quarters lies between the two.
TUNE_B, TUNE_CHUNK, TUNE_K, TUNE_CAP = 512, 16, 16, 10_000
TUNE_CAP_OVER = 100_000_000
TUNE_TRAIN_STEPS = 2 * TUNE_K
TUNE_LIMIT_FRACTION = 0.75
TUNE_SEARCH_KERNELS = ("gather_rows", "backup_update", "per_sample")
PLAY_SEED, PLAY_MOVES = 7, 6
PLAY_STATES = 6


def tune_argv(run: str, extra: list) -> list:
    return [
        "tune", "--device", "cuda", "--json", "--batches", f"{TUNE_B},{TUNE_B // 2}",
        "--chunks", str(TUNE_CHUNK), "--fused-k", str(TUNE_K),
        "--capacities", f"{TUNE_CAP},{TUNE_CAP_OVER}", "--run-name", run,
        "--root-dir", str(RUN_ROOT / "tune"), *extra,
    ]


def tune_rows(report: dict) -> dict:
    return {(r["sp_batch"], r["capacity"]): r for r in report["rows"]}


def check_tune(report: dict, rc: int, label: str, want: dict, calls: int) -> dict:
    """A tune report's exit, rows, oracle calls and release; returns its figures."""
    rows = tune_rows(report)
    got = {key: rows[key]["status"] for key in want if key in rows}
    if rc != 0 or report["exit"] != 0 or got != want or report["oracle_calls"] != calls \
            or len(report["oracle"]) != calls or report["limit_source"] not in ("device", "flag"):
        fail(f"{label}: exit {rc}, rows {got} (want {want}), {report['oracle_calls']} oracle calls (want "
             f"{calls}), limit from {report['limit_source']}; stderr: "
             f"{(RUN_ROOT / f'{label}.err').read_text()[-3000:]}")
    for call in report["oracle"]:
        if call["allocated_after"] != call["allocated_before"] or call["oom"] is not None:
            fail(f"{label}: oracle call {call['candidate']} left {call['allocated_after']} B allocated "
                 f"against {call['allocated_before']} before it (oom {call['oom']})")
    return {
        "rows": {f"B{b}/cap{c}": {"status": r["status"], "budget": r["budget_total_bytes"],
                                  "detail": r["detail"],
                                  "games_per_hour": (r["predicted"] or {}).get("games_per_hour")}
                 for (b, c), r in rows.items()},
        "oracle": [{k: c[k] for k in ("candidate", "seconds", "budget_total_bytes", "allocated_before",
                                      "allocated_after")} for c in report["oracle"]],
        "launches": report["kernel_launches"], "limit": report["bytes_limit"],
        "limit_source": report["limit_source"], "calibration": (report["best"] or {}).get("calibration"),
    }


def tune_phase(torch) -> dict:
    """`cli tune` at the flagship plan, `cli train --preset` of its
    winner, and `cli tune --calibrate` of that run; each in a process of
    its own. The oracle's programs launch the search kernels and, in
    megastep mode, the PER count; every oracle call leaves the card's
    allocated bytes where it found them."""
    b, half = TUNE_B, TUNE_B // 2
    t0 = time.perf_counter()
    rc, rep = run_cli(tune_argv("tuned", []), "tune", 600)
    tune_s = time.perf_counter() - t0
    want = {(b, TUNE_CAP): "fit", (half, TUNE_CAP): "dominated",
            (b, TUNE_CAP_OVER): "ring-over", (half, TUNE_CAP_OVER): "ring-over"}
    first = check_tune(rep, rc, "tune", want, 1)
    if rep["limit_source"] != "device" or rep["mode"] != "megastep":
        fail(f"tune: limit from {rep['limit_source']} in mode {rep['mode']}, want the device's, megastep")
    if not all(rep["kernel_launches"][k] > 0 for k in TUNE_SEARCH_KERNELS):
        fail(f"tune: the oracle's programs launched {rep['kernel_launches']}")
    budget_b = tune_rows(rep)[(b, TUNE_CAP)]["budget_total_bytes"]
    artifact = rep["artifact"]

    t0 = time.perf_counter()
    rc, tr = run_cli([
        "train", "--preset", artifact, "--device", "cuda", "--max-steps", str(TUNE_TRAIN_STEPS),
        "--root-dir", str(RUN_ROOT / "tune"), "--run-name", "tuned", "--no-auto-resume",
        "--no-tensorboard", "--log-level", "WARNING",
    ], "train-tuned", 600)
    train_s = time.perf_counter() - t0
    check_report_losses(tr, "train-tuned")
    outcome = tr.get("tune_outcome")
    if rc != 0 or not outcome or not isinstance(outcome.get("observed_moves_per_sec"), (int, float)) \
            or "observed_over_predicted" not in outcome:
        fail(f"train-tuned: exit {rc}, tune_outcome {outcome}; stderr: "
             f"{(RUN_ROOT / 'train-tuned.err').read_text()[-3000:]}")
    launches = tr["kernel_launches"]
    if launches["per_sample"] != tr["megasteps"] or not all(launches[k] > 0 for k in TUNE_SEARCH_KERNELS):
        fail(f"train-tuned: launches {launches} over {tr['megasteps']} megasteps")
    run_dir = RUN_ROOT / "tune" / "AlphaTriangleTPUTorch" / "runs" / "tuned"

    limit = TUNE_LIMIT_FRACTION * budget_b
    t0 = time.perf_counter()
    rc, cal = run_cli(tune_argv("tuned-cal", ["--calibrate", str(run_dir), "--limit-gb", repr(limit / 2**30)]),
                      "tune-calibrate", 600)
    cal_s = time.perf_counter() - t0
    want = {(b, TUNE_CAP): "over", (half, TUNE_CAP): "fit",
            (b, TUNE_CAP_OVER): "ring-over", (half, TUNE_CAP_OVER): "ring-over"}
    second = check_tune(cal, rc, "tune-calibrate", want, 2)
    sources = second["calibration"]["sources"]
    if "tune_outcome x1" not in sources:
        fail(f"tune-calibrate: calibration sources {sources}, want tune_outcome x1")
    moves = (tr["warmup_chunks"] + tr["megasteps"]) * TUNE_CHUNK
    return {
        "tune": {**first, "seconds": tune_s}, "calibrate": {**second, "seconds": cal_s},
        "train": {"seconds": train_s, "tune_outcome": outcome, "megasteps": tr["megasteps"],
                  "warmup_chunks": tr["warmup_chunks"], "launches": launches, "searched_moves": moves,
                  "megastep_ms": [t * 1e3 for t in tr["timings"]["megastep_s"]],
                  "peak_gb": tr["peak_device_bytes"] / 2**30},
        "budget_b": budget_b, "limit_fraction": TUNE_LIMIT_FRACTION,
        # The oracle's programs: a T-move chunk and a megastep of T moves
        # each call (its learner group searches nothing).
        "launches": {k: rep["kernel_launches"][k] + cal["kernel_launches"][k] for k in rep["kernel_launches"]},
        "searched_moves": 2 * TUNE_CHUNK * (rep["oracle_calls"] + cal["oracle_calls"]),
        "megasteps": rep["oracle_calls"] + cal["oracle_calls"],
    }


def play_transcript(args: list, label: str) -> list:
    """`cli play <args>` in a process of its own: its transcript's lines."""
    proc = subprocess.run([sys.executable, "-m", "alphatriangle_tpu_torch.cli", "play", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    (RUN_ROOT / f"{label}.out").write_text(proc.stdout)
    if proc.returncode != 0:
        fail(f"{label}: exit {proc.returncode}; stderr: {proc.stderr[-2000:]}")
    return proc.stdout.splitlines()


def script_of(actions: list, cfg) -> str:
    cells = cfg.ROWS * cfg.COLS
    return ";".join(f"{a // cells} {(a % cells) // cfg.COLS} {a % cfg.COLS}" for a in actions)


def play_phase(torch) -> dict:
    """`cli play` with either engine, the native engine against the tensor
    engine on the card, and `evaluate_batch` against `evaluate_state` at
    the flagship net on the card.

    The two engines draw their hands from different streams (threefry and
    xorshift), as in the JAX package, so their transcripts differ from the
    first hand on. So: the GameState engine's transcript on the card
    equals its transcript on the CPU line for line (a script of PLAY_MOVES
    legal moves, a 'v' and an illegal one between them); the native
    engine's plays its own PLAY_MOVES legal moves to exit 0; and native
    transitions without a refill equal the tensor engine's on the card."""
    import numpy as np

    from alphatriangle_tpu_torch import rng
    from alphatriangle_tpu_torch.bench_config import resolve_bench_plan
    from alphatriangle_tpu_torch.config import EnvConfig
    from alphatriangle_tpu_torch.env import GameState, TriangleEnv
    from alphatriangle_tpu_torch.env.native import NativeTriangleEnv, native_build_error
    from alphatriangle_tpu_torch.nn import NeuralNetwork

    t0 = time.perf_counter()
    cfg = EnvConfig()
    game = GameState(cfg, initial_seed=PLAY_SEED, device="cpu")
    actions = []
    for _ in range(PLAY_MOVES):
        valid = game.valid_actions()
        actions.append(valid[len(valid) // 2])
        game.step(actions[-1])
    script = script_of(actions[:2], cfg) + ";v;0 0 0;" + script_of(actions[2:], cfg)
    card = play_transcript(["--engine", "jax", "--device", "cuda", "--seed", str(PLAY_SEED),
                            "--script", script], "play-torch-cuda")
    host = play_transcript(["--engine", "jax", "--device", "cpu", "--seed", str(PLAY_SEED),
                            "--script", script], "play-torch-cpu")
    rewards = sum(line.startswith("reward ") for line in card)
    if card != host or rewards != PLAY_MOVES or "engine=torch" not in card[0]:
        fail(f"play: the card's transcript ({len(card)} lines, {rewards} moves) differs from the CPU's "
             f"({len(host)} lines)")

    env = TriangleEnv(cfg, device="cpu")
    try:
        native = NativeTriangleEnv(env)
    except RuntimeError:
        fail(f"play: the native engine does not build: {native_build_error()}")
    batch = native.new_batch(1, seed=PLAY_SEED)
    nactions = []
    for _ in range(PLAY_MOVES):
        valid = np.flatnonzero(native.valid_mask(batch)[0])
        nactions.append(int(valid[len(valid) // 2]))
        native.step(batch, np.asarray(nactions[-1:], np.int32))
    ntext = play_transcript(["--engine", "native", "--seed", str(PLAY_SEED), "--script",
                             script_of(nactions, cfg)], "play-native")
    if "engine=native" not in ntext[0] or sum(line.startswith("reward ") for line in ntext) != PLAY_MOVES \
            or ntext[1:11] != card[1:11]:
        fail(f"play: the native transcript has {len(ntext)} lines, its header or board differs")

    # Native transitions against the tensor engine on the card, refill-free.
    dev = torch.device("cuda")
    tenv = TriangleEnv(cfg, device=dev)
    n = 64
    gen = np.random.default_rng(PLAY_SEED)
    states = tenv.reset(rng.split(rng.PRNGKey(PLAY_SEED), n))
    compared = 0
    for _ in range(12):
        masks = tenv.valid_action_mask(states).cpu().numpy()
        nb = native.new_batch(n)
        nb.occupied[:] = states.occupied.cpu().numpy().astype(np.uint32)
        nb.color[:] = states.color.cpu().numpy().reshape(n, -1)
        nb.shape_idx[:] = states.shape_idx.cpu().numpy()
        nb.shape_color[:] = states.shape_color.cpu().numpy()
        nb.score[:] = states.score.cpu().numpy()
        nb.step_count[:] = states.step_count.cpu().numpy()
        nb.done[:] = states.done.cpu().numpy().astype(np.uint8)
        nb.last_cleared[:] = states.last_cleared.cpu().numpy()
        if not np.array_equal(native.valid_mask(nb), masks):
            fail("play: the native engine's valid masks differ from the card engine's")
        picks = np.array([int(np.flatnonzero(m)[gen.integers(m.sum())]) if m.any() else 0 for m in masks],
                         np.int32)
        keep = ((states.shape_idx.cpu().numpy() >= 0).sum(axis=1) > 1) | states.done.cpu().numpy()
        nrew, ndone = native.step(nb, picks, refill=False)
        states, trew, tdone = tenv.step(states, torch.from_numpy(picks).to(dev))
        same = (np.array_equal(nb.occupied, states.occupied.cpu().numpy().astype(np.uint32))
                and np.array_equal(nb.score, states.score.cpu().numpy())
                and np.array_equal(nrew[keep], trew.cpu().numpy()[keep])
                and np.array_equal(ndone[keep].astype(bool), tdone.cpu().numpy()[keep]))
        if not same:
            fail("play: a native transition differs from the card engine's")
        compared += int(keep.sum())
        if bool(states.done.all()):
            break

    # evaluate_batch of a few GameStates on the card at the flagship net
    # (bf16) against evaluate_state of each: within the bf16 forward's
    # tolerance (the parity tests' BF16_PROB_ATOL, BF16_VALUE_ATOL / RTOL).
    plan = resolve_bench_plan(False, "cuda", environ={})
    net = NeuralNetwork(plan.model, plan.env, seed=0, device=dev)
    games = []
    for seed in range(PLAY_STATES):
        g = GameState(plan.env, initial_seed=seed, device=dev)
        for _ in range(seed):
            valid = g.valid_actions()
            g.step(valid[len(valid) // 3])
        games.append(g)
    batched = net.evaluate_batch(games)
    prob_err = value_err = 0.0
    for g, (bp, bv) in zip(games, batched):
        sp, sv = net.evaluate_state(g)
        pb, ps = np.array([bp[a] for a in sorted(bp)]), np.array([sp[a] for a in sorted(sp)])
        if not (np.isfinite(pb).all() and abs(pb.sum() - 1.0) < 1e-3 and len(pb) == plan.env.action_dim):
            fail(f"play: evaluate_batch's policy is not a distribution over {plan.env.action_dim} actions")
        prob_err = max(prob_err, float(np.abs(pb - ps).max()))
        value_err = max(value_err, abs(bv - sv))
        if prob_err > 0.05 or abs(bv - sv) > 0.2 + 0.1 * abs(sv):
            fail(f"play: evaluate_batch differs from evaluate_state (policy {prob_err:.3g}, value "
                 f"{abs(bv - sv):.3g})")
    return {
        "transcript_lines": len(card), "moves": rewards, "native_moves": PLAY_MOVES,
        "native_transitions_compared": compared, "evaluate_states": PLAY_STATES,
        "evaluate_prob_max_abs_err": prob_err, "evaluate_value_max_abs_err": value_err,
        "seconds": time.perf_counter() - t0,
    }


def say_tune(r: dict, card: str) -> None:
    for label, part in (("tune", r["tune"]), ("tune --calibrate", r["calibrate"])):
        say(f"{label}: exit 0 in {part['seconds']:.1f} s, limit {part['limit'] / 2**30:.3f} GiB "
            f"[{part['limit_source']}]; rows {json.dumps(part['rows'])} [{card}]")
        for call in part["oracle"]:
            say(f"{label}: oracle {call['candidate']}: {call['seconds']:.2f} s, budget "
                f"{call['budget_total_bytes'] / 2**30:.3f} GiB, allocated {call['allocated_before']} B before, "
                f"{call['allocated_after']} B after [{card}]")
    t = r["train"]
    o = t["tune_outcome"]
    say(f"train-tuned: cli train --preset exit 0 in {t['seconds']:.1f} s, {t['warmup_chunks']} warm-up "
        f"chunks, {t['megasteps']} megasteps {[round(x, 1) for x in t['megastep_ms']]} ms, peak "
        f"{t['peak_gb']:.3f} GiB; predicted {o.get('predicted_moves_per_sec')} moves/s, observed "
        f"{o.get('observed_moves_per_sec')}, observed / predicted {o.get('observed_over_predicted')} "
        f"[{card}]")
    say(f"tune: the limit of the calibrated tune is {r['limit_fraction']} of the budget at B "
        f"({r['budget_b'] / 2**30:.3f} GiB); calibration {json.dumps(r['calibrate']['calibration'])}")


# Slice fifteen: tensor and sequence parallelism in the synchronous loop.
# One pair of rank processes shares the card over gloo (`python3
# chip_smoke.py --mesh-rank SPEC RANK`, this file run as a child) and runs
# both meshes in turn, each over a group of its own; each calls
# `run_training(mesh_config=...)`, as no CLI flag sets the mdl or sp axis,
# at the train default's widths (bf16 net, conv 32-64-128, two transformer
# layers of 128 with 4 heads, FC 256, 120 tokens; 64 simulations, batch
# 256), cut in depth: 3-move chunks (the 5-step returns leave the first
# chunk without rows), 1 learner step an iteration to 3 steps, so 4
# iterations; the third traced (`--profile`'s window of iterations 1-2
# narrowed to 2, `MESH_TRACED`): the second that trains (the first pays
# the learner's first use, on tp2 unequally across the ranks).
MESH_CHUNK_MOVES, MESH_STEPS_PER_ITERATION, MESH_STEPS, MESH_ITERATIONS = 3, 1, 3, 4
MESH_TRACED = 2  # the loop's iteration index the profiler traces
MESH_PHASES = {
    "train-tp2-shared": ({"MDL_SIZE": 2}, "tp.all_reduce", 512),
    "train-sp2-shared": ({"SP_SIZE": 2, "SP_ATTENTION": "ring"}, "sp.attention", 256),
}
# The learner's attention at the default widths: (batch, tokens, heads,
# head_dim); ring and Ulysses against dense at `tests/test_ring_attention.py`'s
# tolerances (float32 inputs, float32 accumulation).
ATTN_SHAPE = (256, 120, 4, 32)
ATTN_FWD_TOL, ATTN_GRAD_TOL = 2e-5, 5e-5
ATTN_TIMED = 5


def label_share(trace_path: str, label: str) -> dict:
    """A rank's traced iteration (from its `phase/rollout` span to the
    profiler's last event: the second that trains) and `label`'s host
    time inside it (the union of its spans), with its device range where
    the trace has one."""
    events = [e for e in json.loads(Path(trace_path).read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    start = max(e["ts"] for e in events
                if e.get("name") == "phase/rollout" and e.get("cat") == "user_annotation")
    wall = max(e["ts"] + e["dur"] for e in events) - start

    def union(spans) -> float:
        total, end = 0.0, float("-inf")
        for a, b in sorted(spans):
            if b > end:
                total += b - max(a, end)
                end = b
        return total

    def spans(cat: str) -> list:
        return [(e["ts"], e["ts"] + e["dur"]) for e in events
                if e.get("name") == label and e.get("cat") == cat and e["ts"] >= start]

    host, device = spans("user_annotation"), spans("gpu_user_annotation")
    return {"traced_ms": wall / 1e3, "host_ms": union(host) / 1e3, "share": union(host) / wall,
            "calls": len(host), "device_ms": union(device) / 1e3 if device else None}


def attention_check(torch, mesh_config, rank: int) -> dict:
    """Ring and Ulysses on the card at the learner's attention shape over
    the sp group: this rank's sequence shard's output and q / k / v
    gradients against dense attention on the whole inputs (float32); the
    largest errors beside their tolerances, and each one's fwd + bwd wall
    (median of a few, collectives included) beside dense's."""
    from alphatriangle_tpu_torch.parallel.distributed import attach_groups
    from alphatriangle_tpu_torch.parallel.ring_attention import (
        _dense_attention,
        ring_attention,
        ulysses_attention,
    )

    mesh = attach_groups(mesh_config.build_mesh(2, rank, "gloo"))
    gen = torch.Generator().manual_seed(0)
    full = {x: torch.randn(ATTN_SHAPE, generator=gen).cuda() for x in ("q", "k", "v", "dout")}
    scale = 1.0 / ATTN_SHAPE[-1] ** 0.5
    n, i = mesh.sp, mesh.sp_index

    def run(fn, part):
        q, k, v = (part(full[x]).clone().requires_grad_(True) for x in ("q", "k", "v"))
        y = fn(q, k, v)
        y.backward(part(full["dout"]))
        return {"out": y.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}

    def timed(fn, part) -> float:
        times = []
        for _ in range(ATTN_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(fn, part)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    whole = lambda t: t  # noqa: E731
    mine = lambda t: t.chunk(n, dim=1)[i]  # noqa: E731
    dense = lambda q, k, v: _dense_attention(q, k, v, scale)  # noqa: E731
    ref = {name: mine(t) for name, t in run(dense, whole).items()}
    out = {"shape": list(ATTN_SHAPE), "sp": n, "dense_ms": timed(dense, whole)}
    for kind, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
        got = run(lambda q, k, v, fn=fn: fn(q, k, v, mesh=mesh, scale=scale), mine)
        errs = {name: float((got[name] - ref[name]).abs().max()) for name in got}
        for name, g in got.items():
            tol = ATTN_FWD_TOL if name == "out" else ATTN_GRAD_TOL
            if not torch.allclose(g, ref[name], rtol=tol, atol=tol):
                fail(f"{kind} attention on rank {rank}: {name} off dense by {errs[name]:.3e} "
                     f"(tolerance {tol} relative and absolute)")
        out[kind] = {"max_abs_err": errs, "fwd_tol": ATTN_FWD_TOL, "grad_tol": ATTN_GRAD_TOL,
                     "ms": timed(lambda q, k, v, fn=fn: fn(q, k, v, mesh=mesh, scale=scale), mine)}
    return out


def mesh_rank_child(spec_path: str, rank: int) -> int:
    """One rank of the mesh pair (this file as a child): for each mesh in
    turn, over a group of its own (`run_training` leaves it at its end),
    the sp mesh's attention check, then `run_training`; writes each
    mesh's figures to the spec's output file."""
    import torch

    sys.path.insert(0, str(ROOT))
    spec = json.loads(Path(spec_path).read_text())
    global RUN_ROOT
    RUN_ROOT = Path(spec["root"])
    from alphatriangle_tpu_torch import profiling
    from alphatriangle_tpu_torch.config import MeshConfig
    from alphatriangle_tpu_torch.ops import KERNELS
    from alphatriangle_tpu_torch.parallel import DistributedConfig, initialize_distributed
    from alphatriangle_tpu_torch.training import LoopStatus, run_training

    real_init = profiling.ProfileSession.__init__

    def one_iteration(self, enabled, profile_dir, trace_start=1, trace_stop=3, tracer=None):
        real_init(self, enabled, profile_dir, MESH_TRACED, MESH_TRACED + 1, tracer)

    profiling.ProfileSession.__init__ = one_iteration
    for label, (mesh_fields, traced_label, _) in MESH_PHASES.items():
        t_start = time.time()
        dist_config = DistributedConfig(
            ENABLED=True, COORDINATOR_ADDRESS=f"localhost:{spec['ports'][label]}", NUM_PROCESSES=2,
            PROCESS_ID=rank, BACKEND="gloo",
        )
        mesh_config = MeshConfig(**mesh_fields)
        out = {"rank": rank, "start_unix": t_start}
        if mesh_config.SP_SIZE > 1:
            initialize_distributed(dist_config, "cuda")
            out["attention"] = attention_check(torch, mesh_config, rank)
        for kern in KERNELS.values():
            kern.launches = 0
        torch.cuda.reset_peak_memory_stats()
        # The run's name is TrainConfig's: every rank writes beside rank 0's choice.
        cfg = loop_config(MAX_TRAINING_STEPS=MESH_STEPS, ROLLOUT_CHUNK_MOVES=MESH_CHUNK_MOVES,
                          LEARNER_STEPS_PER_ROLLOUT=MESH_STEPS_PER_ITERATION, PROFILE_WORKERS=True,
                          RUN_NAME=label)
        loop = run_training(cfg, persistence_config=run_dir(label), device="cuda",
                            distributed_config=dist_config, mesh_config=mesh_config, log_level="WARNING")
        if loop.status is not LoopStatus.COMPLETED or loop.global_step != MESH_STEPS:
            fail(f"{label} rank {rank}: ended {loop.status.value} at step {loop.global_step} ({loop.error!r})")
        check_losses(loop, f"{label} rank {rank}")
        report = loop.report()
        out.update({
            "report": {k: report[k] for k in ("dp", "iterations", "steps", "episodes", "lane_moves",
                                               "buffer_size", "replay_ring", "rows_per_iteration",
                                               "steps_per_iteration", "peak_device_bytes", "losses")},
            "iteration_ms": [t * 1e3 for t in loop.timings["iteration_s"]],
            "learner_ms": [t * 1e3 for t in loop.timings["learner_s"]],
            "rollout_ms": [t * 1e3 for t in loop.timings["rollout_s"]],
            "first_iteration_unix": loop.first_iteration_unix,
            "launches": {name: kern.launches for name, kern in KERNELS.items()},
            "trace": label_share(str(loop.profile.trace_path), traced_label),
        })
        Path(spec["out"].format(label=label, rank=rank)).write_text(json.dumps(out))
        del loop
        torch.cuda.empty_cache()
    return 0


def mesh_phases(torch) -> tuple:
    """The pair of ranks sharing the card over gloo (`mesh_rank_child`)
    through both meshes; per mesh its checks (4 synchronous iterations,
    the gathered-parameter digests equal after every iteration, the
    search kernels 16 + 2 times a searched move on a rank that plays, at
    its lanes, none on an mdl replica past the line's first, no PER count:
    the mesh takes the host ring; the checkpoint's lane totals counting
    each lane once) and figures. Returns (reports by label, the pair's
    wall)."""
    spec = {"ports": {label: free_port() for label in MESH_PHASES}, "root": str(RUN_ROOT),
            "out": str(RUN_ROOT / "{label}-rank{rank}.json")}
    spec_path = RUN_ROOT / "mesh.spec.json"
    spec_path.write_text(json.dumps(spec))
    procs, files = [], []
    t0 = time.perf_counter()
    try:
        for r in range(2):
            out = open(RUN_ROOT / f"mesh-rank{r}.out", "w")
            err = open(RUN_ROOT / f"mesh-rank{r}.err", "w")
            files += [out, err]
            t_spawn = time.time()
            procs.append((subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-rank",
                                            str(spec_path), str(r)], cwd=ROOT, stdout=out, stderr=err,
                                           text=True), t_spawn))
        deadline = time.monotonic() + 600
        for proc, _ in procs:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in files:
            f.close()
    wall_s = time.perf_counter() - t0
    for r, (proc, _) in enumerate(procs):
        if proc.returncode != 0:
            tail = (RUN_ROOT / f"mesh-rank{r}.out").read_text()[-1500:]
            err = (RUN_ROOT / f"mesh-rank{r}.err").read_text()[-3000:]
            fail(f"mesh rank {r}: exit {proc.returncode}: {tail} {err}")
    reports = {}
    for i, (label, (mesh_fields, traced_label, lanes)) in enumerate(MESH_PHASES.items()):
        ranks = []
        for r, (proc, t_spawn) in enumerate(procs):
            rk = json.loads(Path(spec["out"].format(label=label, rank=r)).read_text())
            rep = rk["report"]
            moves = rep["iterations"] * MESH_CHUNK_MOVES
            # The mdl line's first rank plays; its replicas receive the rows.
            searched = moves if rep["dp"]["index"]["mdl"] == 0 else 0
            want = {"gather_rows": 16 * searched, "backup_update": 2 * searched, "per_sample": 0,
                    "subtree_promote": 0}
            if rep["iterations"] != MESH_ITERATIONS or rk["launches"] != want or rep["replay_ring"] != "host":
                fail(f"{label} rank {r}: {rep['iterations']} iterations, launches {rk['launches']} (want "
                     f"{want} over {searched} searched moves), {rep['replay_ring']} ring")
            shape = {"dp": 1, "mdl": mesh_fields.get("MDL_SIZE", 1), "sp": mesh_fields.get("SP_SIZE", 1)}
            if rep["lane_moves"] != lanes * moves or rep["dp"]["mesh"] != shape:
                fail(f"{label} rank {r}: {rep['lane_moves']} lane moves over {moves} moves (want {lanes} "
                     f"lanes), mesh {rep['dp']['mesh']}")
            ranks.append({
                "rank": r, "index": rep["dp"]["index"], "lanes": lanes, "searched_moves": searched,
                "launches": rk["launches"], "iteration_ms": rk["iteration_ms"],
                "iteration_ms_p50": statistics.median(rk["iteration_ms"]),
                "learner_ms_per_step_p50": statistics.median(
                    t / n for t, n in zip(rk["learner_ms"], rep["steps_per_iteration"]) if n),
                "rollout_ms_p50": statistics.median(rk["rollout_ms"]),
                "peak_gb": rep["peak_device_bytes"] / 2**30,
                # The pair spawns once, for the first mesh; a later mesh
                # counts from the start of its group.
                "to_first_iteration_from": "spawn" if i == 0 else "group start",
                "to_first_iteration_s": rk["first_iteration_unix"] - (t_spawn if i == 0 else rk["start_unix"]),
                "trace": rk["trace"], "episodes": rep["episodes"], "digests": rep["dp"]["param_checksums"],
                "rows_per_iteration": rep["rows_per_iteration"], "steps_per_iteration": rep["steps_per_iteration"],
                **({"attention": rk["attention"]} if "attention" in rk else {}),
            })
        if ranks[0]["digests"] != ranks[1]["digests"] or len(ranks[0]["digests"]) != MESH_ITERATIONS:
            fail(f"{label}: gathered-parameter digests differ or miss an iteration: "
                 f"{ranks[0]['digests']} / {ranks[1]['digests']}")
        if ranks[0]["trace"]["calls"] == 0:
            fail(f"{label}: no {traced_label} span in the traced training iteration of rank 0")
        meta = json.loads((RUN_ROOT / label / "AlphaTriangleTPUTorch" / "runs" / label / "checkpoints"
                           / f"step_{MESH_STEPS:08d}.meta.json").read_text())
        owners = [rk for rk in ranks if rk["index"]["mdl"] == 0]
        if meta["episodes_played"] != sum(rk["episodes"] for rk in owners):
            fail(f"{label}: the checkpoint counts {meta['episodes_played']} episodes, the lanes' owners "
                 f"{[rk['episodes'] for rk in owners]}")
        reports[label] = {
            "backend": "gloo", "world": 2, "mesh": mesh_fields, "label": traced_label, "ranks": ranks,
            "launches": {k: ranks[0]["launches"][k] + ranks[1]["launches"][k] for k in ranks[0]["launches"]},
            "searched_moves": sum(rk["searched_moves"] for rk in ranks), "digests": ranks[0]["digests"],
            "checkpoint_episodes": meta["episodes_played"],
        }
    return reports, wall_s


def say_mesh(label: str, r: dict, card: str) -> None:
    for rk in r["ranks"]:
        tr = rk["trace"]
        dev = "" if tr["device_ms"] is None else f", device {tr['device_ms']:.2f} ms"
        idx = rk["index"]
        say(
            f"{label} rank {rk['rank']} (gloo, mesh {r['mesh']}, index dp {idx['dp']} mdl {idx['mdl']} sp "
            f"{idx['sp']}, {rk['lanes']} lanes, {rk['searched_moves']} searched moves): iteration p50 "
            f"{rk['iteration_ms_p50']:.1f} ms "
            f"({', '.join(f'{t:.1f}' for t in rk['iteration_ms'])}; rows {rk['rows_per_iteration']}, steps "
            f"{rk['steps_per_iteration']}), rollout p50 {rk['rollout_ms_p50']:.1f} ms, learner "
            f"{rk['learner_ms_per_step_p50']:.1f} ms a step; {r['label']} {tr['host_ms']:.1f} ms in "
            f"{tr['calls']} spans{dev}, {tr['share']:.2%} of the traced training iteration "
            f"({tr['traced_ms']:.1f} ms); peak {rk['peak_gb']:.2f} GiB; {rk['to_first_iteration_from']} to "
            f"first iteration {rk['to_first_iteration_s']:.1f} s; launches {rk['launches']} [{card}]"
        )
        if "attention" in rk:
            at = rk["attention"]
            for kind in ("ring", "ulysses"):
                e = at[kind]["max_abs_err"]
                say(
                    f"{label} rank {rk['rank']} {kind} attention {tuple(at['shape'])} f32 against dense: "
                    f"max abs err out {e['out']:.2e} (tol {ATTN_FWD_TOL}), dq {e['dq']:.2e}, dk {e['dk']:.2e}, "
                    f"dv {e['dv']:.2e} (tol {ATTN_GRAD_TOL}); fwd + bwd {at[kind]['ms']:.1f} ms, dense on "
                    f"the whole {at['dense_ms']:.1f} ms [{card}]"
                )
    say(f"{label}: gathered-parameter digests equal on both ranks after each of {MESH_ITERATIONS} "
        f"iterations {r['digests']}; the checkpoint counts {r['checkpoint_episodes']} episodes, each lane once")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a CUDA card")
    if not (ROOT / "alphatriangle_tpu_torch" / "csrc").is_dir():
        fail(f"the port's sources are not beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    global RUN_ROOT
    RUN_ROOT = Path(tempfile.mkdtemp(prefix="chip_smoke_runs_"))
    try:
        return run_phases(torch)
    finally:
        shutil.rmtree(RUN_ROOT, ignore_errors=True)


def run_phases(torch) -> int:
    from alphatriangle_tpu_torch.ops import KERNELS
    from alphatriangle_tpu_torch.ops._cuda import build_all

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    search_cases = search_cases_in_background()
    say(f"card: {card}")
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    from alphatriangle_tpu_torch.ops import beacon as obeacon

    build_s = build_all([*KERNELS.values(), obeacon.KERNEL])
    say(f"kernel build: {build_s:.1f} s for {', '.join(KERNELS)}, beacon")
    for kern in [*KERNELS.values(), obeacon.KERNEL]:
        for line in kern.log.read_text().splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                say(f"  ptxas {kern.name}: {line.strip()}")

    rate = hbm_rate(kind)
    t0 = time.perf_counter()
    kreport = kernel_phase(torch, dev, rate)
    families = kreport.pop("families")
    empty_ms = kreport.pop("empty_kernel_ms")
    say(
        f"families: per_sample equal to plain on {', '.join(families['count_families'])}; "
        f"backup_update bit-equal to plain at 64 and 512 lanes on "
        f"{', '.join(families['backup_families'])}"
    )
    say(
        f"per_sample: the card's cumsum has {kreport['per_sample']['cumsum_descents']} descents; "
        f"torch.searchsorted differs from the count on {kreport['per_sample']['searchsorted_disagrees']} "
        f"of {TRAIN_K * 256} draws; the kernel counted "
        f"{kreport['per_sample']['tiles_counted_per_draw']:.2f} tiles element by element "
        "per draw"
    )
    for kr in kreport.values():
        say(
            f"kernel {kr['name']}: equal to plain; {kr['ms'] * 1e3:.1f} us "
            f"(plain {kr['plain_ms'] * 1e3:.1f} us, library {kr['library_ms'] * 1e3:.1f} us, "
            f"bound {kr['bound_ms'] * 1e3:.2f} us by {kr['bound_by']}) [{card}]"
        )
        if "at_512_lanes" in kr:
            at = kr["at_512_lanes"]
            say(
                f"kernel {kr['name']} at 512 lanes: equal to plain; {at['ms'] * 1e3:.1f} us "
                f"(plain {at['plain_ms'] * 1e3:.1f} us, library {at['library_ms'] * 1e3:.1f} us, "
                f"bound {at['bound_ms'] * 1e3:.2f} us by bytes) [{card}]"
            )
        if "worst_case" in kr:
            wc = kr["worst_case"]
            at512 = ""
            if "ms_at_512_lanes" in wc:
                at512 = f", {wc['ms_at_512_lanes'] * 1e3:.1f} us at 512 lanes"
            say(f"kernel {kr['name']} worst case ({wc['input']}): "
                f"{wc['ms'] * 1e3:.1f} us{at512} [{card}]")
    plan = kreport["subtree_promote"]
    say(
        f"subtree_promote plan (BFS rounds, sort, remap): {plan['plan_ms']:.3f} ms at 64 lanes, "
        f"{plan['at_512_lanes']['plan_ms']:.3f} ms at 512 lanes [{card}]"
    )
    by_lanes = ", ".join(
        f"{ms * 1e3:.2f} us at {b}"
        for b, ms in kreport["backup_update"]["ms_by_lanes"].items()
    )
    say(f"kernel backup_update against the games (family random): {by_lanes} [{card}]")
    say(f"an empty kernel timed the same way: {empty_ms * 1e3:.2f} us [{card}]")
    bkreport = beacon_kernel(torch, dev, rate, sleep_cycles_per_ms())
    say(
        f"kernel beacon (not a TPU kernel): equal to plain over {obeacon.RING_SLOTS + 100} rows; "
        f"{bkreport['ms'] * 1e3:.2f} us (plain {bkreport['plain_ms'] * 1e3:.2f} us, bound "
        f"{bkreport['bound_ms'] * 1e3:.4f} us by bytes) [{card}]"
    )
    shapes = search_shape_phase(torch, dev, rate, sleep_cycles_per_ms(), search_cases())
    for kname, by_shape in shapes.items():
        kreport[kname]["search_shapes"] = by_shape
        for shape, r in by_shape.items():
            say(
                f"kernel {kname} at the {shape} shape {r['shape']}: bit-equal to plain; "
                f"{r['ms'] * 1e3:.1f} us (bound {r['bound_ms'] * 1e3:.2f} us by bytes) [{card}]"
            )
    say(f"kernel phase: {time.perf_counter() - t0:.1f} s")

    recorded = {"serve": [], "train": [], "gumbel": [], "fast": []}
    t0 = time.perf_counter()
    sreport = serve_phase(torch, dev, KERNELS, record=recorded["serve"])
    say_serve("serve", sreport, card)
    say(f"profile reader: equal to torch's on the profiled dispatch's {TRACE_READER['events']} events "
        f"({TRACE_READER['runtime_calls']} runtime calls; {TRACE_READER['fast_s']:.2f} s, torch's "
        f"{TRACE_READER['torch_s']:.2f} s)")
    say(f"serve phase: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    treport = train_phase(torch, dev, KERNELS, record=recorded["train"])
    say_train("train", treport, card)
    say_telemetry("train", treport["telemetry"], card)
    ab = treport["stats_ab"]
    say(
        f"train stat-packs off / on (interleaved): megastep p50 {ab['megastep_ms_p50_off']:.1f} / "
        f"{ab['megastep_ms_p50_on']:.1f} ms ({', '.join(f'{t:.1f}' for t in ab['megastep_ms_off'])} / "
        f"{', '.join(f'{t:.1f}' for t in ab['megastep_ms_on'])}); profiled: {ab['device_launches_off']} / "
        f"{ab['device_launches_on']} kernels and copies ({ab['added_launches_per_searched_move']:.1f} more "
        f"a searched move), device {ab['device_ms_off']:.1f} / {ab['device_ms_on']:.1f} ms, search.stats "
        f"{ab['stats_device_ms']:.3f} ms on the card, host-blocking calls equal {ab['host_blocking_calls']}; "
        f"armed megastep {ab['armed_megastep_ms']:.1f} ms, {ab['armed_rows']} beacon rows equal to the "
        f"host's, {ab['beacon_launches']} beacon launches [{card}]"
    )
    say(f"train phase: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    p3report = train_preset3_phase(torch, dev, KERNELS, "sync", record=recorded)
    say_preset3("train-preset3", p3report, card)
    say(f"train-preset3 phase: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    wreport = real_wave_phase(torch, sleep_cycles_per_ms(), recorded)
    del recorded
    kreport["backup_update"]["real_waves"] = wreport
    for path, r in wreport.items():
        say(
            f"kernel backup_update on {r['waves']} real {path} waves ({r['lanes']} lanes, "
            f"{r['inactive_share']:.1%} of entries inactive): bit-equal to plain; "
            f"{r['ms'] * 1e3:.1f} us [{card}]"
        )
    say(f"real-wave phase: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    srreport = serve_phase(torch, dev, KERNELS, reuse=True)
    say_serve("serve-reuse", srreport, card)
    say(f"serve-reuse phase: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    trreport = train_phase(torch, dev, KERNELS, reuse=True)
    say_train("train-reuse", trreport, card)
    say_telemetry("train-reuse", trreport["telemetry"], card)
    say(f"train-reuse phase: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    syreport = train_sync_phase(torch, dev, KERNELS)
    say_loop("train-sync", syreport, card)
    say_telemetry("train-sync", syreport["telemetry"], card)
    say_profile("sync iteration", syreport["profile"], card)
    say(f"train-sync phase: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    shreport = train_sync_phase(torch, dev, KERNELS, host_ring=True)
    say_loop("train-sync-host", shreport, card)
    say_telemetry("train-sync-host", shreport["telemetry"], card)
    say(f"train-sync-host phase: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    asreport = train_async_phase(torch, dev, KERNELS)
    say_async(asreport, card)
    say_telemetry("train-async", asreport["telemetry"], card)
    say(f"train-async phase: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    prreport = preempt_resume_phase(torch)
    say(
        f"preempt-resume: SIGTERM after step {PREEMPT_FREQ} was committed -> exit 114 at step "
        f"{prreport['preempted_at_step']} ({prreport['sigterm_to_exit_s']:.1f} s from the signal); "
        f"saves {', '.join(f'{t:.1f}' for t in prreport['save_ms'])} ms, spills "
        f"{', '.join(f'{t:.1f}' for t in prreport['spill_ms'])} ms of {prreport['spill_bytes']} "
        f"bytes; resumed in run ckpt at step {prreport['preempted_at_step']} with the spill's "
        f"{prreport['spill_rows']} rows: restore {prreport['restore_ms']:.1f} ms (state "
        f"{prreport['restore_state_ms']:.1f} ms, ring {prreport['restore_ring_ms']:.1f} ms), first "
        f"resumed iteration {prreport['first_resumed_iteration_ms']:.1f} ms (p50 "
        f"{prreport['resumed_iteration_ms_p50']:.1f} ms), to step {PREEMPT_STEPS}; launches "
        f"{prreport['launches']} [{card}]"
    )
    pp = prreport["perf"]
    say(
        f"preempt-resume readers: cli health --probe while training {json.dumps(prreport['probe'])} "
        f"({prreport['probe_s']:.2f} s); cli health: {prreport['health'][0]}; cli perf: "
        f"{pp['ticks']} ticks, MFU {pp['mfu']:.4%} (max {pp['mfu_max']:.4%}) of "
        f"{pp['peak_bf16_tflops']} TFLOP/s [{pp['peak_source']}] on {pp['device_kind']}, "
        f"{pp['learner_steps_per_sec']:.2f} learner steps/s, step p50 {pp['step_time_ms_p50']} ms, "
        f"{pp['dispatches_per_iteration']:.2f} dispatches an iteration; programs "
        + ", ".join(f"{p['program']} {p['count']} x p50 {p['wall_s_p50'] * 1e3:.1f} ms"
                    for p in prreport["perf_programs"] or [])
        + f" [{card}]"
    )
    say(f"preempt-resume phase: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    mrreport, resumed_ring = megastep_resume_phase(torch, dev, KERNELS)
    say(
        f"megastep-resume: checkpoints every {MEGA_RESUME_FREQ} steps to {MEGA_RESUME_STEPS} (saves "
        f"{', '.join(f'{t:.1f}' for t in mrreport['save_ms'])} ms, spill "
        f"{', '.join(f'{t:.1f}' for t in mrreport['spill_ms'])} ms of {mrreport['spill_bytes']} "
        f"bytes), the file bit-equal on the card and the CPU; resumed learner bit-equal to the "
        f"file, first megastep's priorities the restored SumTree's ({mrreport['restored_rows']} "
        f"rows); restore {mrreport['restore_ms']:.1f} ms (state {mrreport['restore_state_ms']:.1f} "
        f"ms, ring {mrreport['restore_ring_ms']:.1f} ms), first resumed megastep "
        f"{mrreport['first_resumed_megastep_ms']:.1f} ms; launches {mrreport['launches']} [{card}]"
    )
    rtreport = ring_round_trip_phase(torch, dev, resumed_ring)
    del resumed_ring
    say(
        f"ring round trip: {rtreport['rows']} rows of {rtreport['row_bytes']} bytes ("
        f"{rtreport['source_rows']} harvested rows repeated), bit-equal after the restore; "
        f"get_state {rtreport['get_state_ms']:.1f} ms, save_buffer {rtreport['save_buffer_ms']:.1f} "
        f"ms ({rtreport['spill_bytes']} bytes), restore_buffer_path "
        f"{rtreport['restore_buffer_path_ms']:.1f} ms, set_state {rtreport['set_state_ms']:.1f} ms "
        f"[{card}]"
    )
    say(f"megastep-resume and ring phases: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    evreport = eval_phase(torch)
    say(
        f"eval: {EVAL_GAMES} games x {EVAL_SIMS} sims, up to {EVAL_MAX_MOVES} moves, of "
        f"{evreport['report']['source']}: {evreport['games_per_s']:.2f} games/s, "
        f"{evreport['dispatches']} dispatches, p50 {evreport['dispatch_ms_p50']:.1f} ms; random "
        f"side equal to the CPU's; {json.dumps(evreport['report'])}; launches "
        f"{evreport['launches']} [{card}]"
    )
    say(f"eval phase: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    egreport = eval_phase(torch, gumbel=True)
    say(
        f"eval-gumbel: {EVAL_GAMES} games x {EVAL_SIMS} sims of {egreport['report']['source']} "
        f"through GumbelMCTS(exploit=True): {egreport['games_per_s']:.2f} games/s, "
        f"{egreport['dispatches']} dispatches, p50 {egreport['dispatch_ms_p50']:.1f} ms; "
        f"{json.dumps(egreport['report'])}; launches {egreport['launches']} [{card}]"
    )
    say(f"eval-gumbel phase: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    sgreport = serve_phase(torch, dev, KERNELS, gumbel=True)
    say_serve("serve-gumbel", sgreport, card)
    say(f"serve-gumbel phase: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    p3mreport = train_preset3_phase(torch, dev, KERNELS, "megastep")
    say_preset3("train-preset3-megastep", p3mreport, card)
    say(f"train-preset3-megastep phase: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    p3areport = train_preset3_phase(torch, dev, KERNELS, "async")
    say_preset3("train-preset3-async", p3areport, card)
    say(f"train-preset3-async phase: {time.perf_counter() - t0:.1f} s")

    preset_reports = {}
    for n in sorted(PRESET_CHUNKS):
        t0 = time.perf_counter()
        r = preset_reports[n] = train_preset_phase(torch, KERNELS, n)
        say(
            f"train-preset{n}: {r['lanes']} lanes x {r['sims']} sims ({r['waves']} waves), board "
            f"{r['board'][0]}x{r['board'][1]}, {r['transformer_layers']} transformer layers"
            f"{' (REMAT)' if r['remat'] else ''}: one iteration of {r['searched_moves']} moves "
            f"and 1 learner step {r['iteration_ms']:.1f} ms (rollout {r['rollout_ms']:.1f} ms, "
            f"{r['rollout_moves_per_s']:.1f} moves/s; learner {r['learner_ms']:.1f} ms), peak "
            f"{r['peak_mem_gb']:.2f} GiB; launches {r['launches']} [{card}]"
        )
        say(f"train-preset{n} phase: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    amreport = attention_memory_phase(torch, dev)
    for name in ("sliced", "whole"):
        r = amreport[name]
        what = "out of memory" if r.get("out_of_memory") else f"{r['ms']:.1f} ms"
        say(
            f"preset 5 leaf evaluation ({amreport['leaves']} leaves x {amreport['tokens']} tokens, "
            f"attention {name}): {what}, peak {r['peak_gb']:.2f} GiB above the inputs [{card}]"
        )
        if "profile" in r:
            say_profile("preset 5 leaf evaluation", r["profile"], card)
    say(f"attention-memory phase: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    pbreport = train_precision_phase(
        torch, dev, KERNELS, "train-bn-bf16-megastep", "batch", "bfloat16", "megastep"
    )
    t_prec = time.perf_counter()
    say(f"train-bn-bf16-megastep phase: {t_prec - t0:.1f} s")
    say(
        f"train-bn-bf16-megastep: {pbreport['megasteps']} megasteps, p50 "
        f"{pbreport['megastep_ms_p50']:.1f} ms ({pbreport['megastep_moves_per_s_p50']:.1f} moves/s), "
        f"casts per megastep {pbreport['megastep_casts']}, one cast {pbreport['cast_ms_p50']:.2f} ms "
        f"(in the profiled megastep: host {pbreport['profile']['stages']['selfplay.cast']['host_ms']:.2f} "
        f"ms, device {pbreport['profile']['stages']['selfplay.cast']['device_ms']:.2f} ms), "
        f"{pbreport['running_stats']} running statistics moved and finite, peak "
        f"{pbreport['peak_mem_gb']:.2f} GiB; launches {pbreport['launches']} [{card}]"
    )
    say_profile("bn-bf16 megastep", pbreport["profile"], card)
    t_prec = time.perf_counter()
    pireport = train_precision_phase(torch, dev, KERNELS, "train-bn-int8-sync", "batch", "int8", "sync")
    say(f"train-bn-int8-sync phase: {time.perf_counter() - t_prec:.1f} s")
    say(
        f"train-bn-int8-sync: {pireport['iterations']} iterations {pireport['steps_per_iteration']}, "
        f"p50 at the fullest {pireport['iteration_ms_p50_full']:.1f} ms, rollout "
        f"{pireport['rollout_moves_per_s']:.1f} moves/s, {pireport['casts']} casts for versions "
        f"{pireport['chunk_versions']}, busy {pireport['profile']['device_busy_share']:.1%} of a "
        f"profiled iteration, peak {pireport['peak_mem_gb']:.2f} GiB; launches {pireport['launches']} "
        f"[{card}]"
    )
    say_profile("bn-int8 sync iteration", pireport["profile"], card)
    t_prec = time.perf_counter()
    pareport = train_precision_phase(torch, dev, KERNELS, "train-int8-async", "group", "int8", "async")
    say(f"train-int8-async phase: {time.perf_counter() - t_prec:.1f} s")
    say(
        f"train-int8-async: 1 producer stream, {pareport['iterations']} iterations, p50 "
        f"{pareport['iteration_ms_p50']:.1f} ms, producer chunk p50 "
        f"{pareport['producer_chunk_ms_p50']:.1f} ms, {pareport['lane_moves_per_s_run']:.1f} moves/s "
        f"over the run, {pareport['casts']} casts for versions {pareport['chunk_versions']}, busy "
        f"{pareport['profile']['device_busy_share']:.1%} of a profiled window of "
        f"{pareport['profile']['steps']} steps; launches {pareport['launches']} [{card}]"
    )
    t_prec = time.perf_counter()
    ebreport = eval_phase(
        torch, run="train-bn-int8-sync", root="train-bn-int8-sync", step=PREC_STEPS,
        label="eval-bn-int8", precision="int8",
    )
    say(
        f"eval-bn-int8: {EVAL_GAMES} games x {EVAL_SIMS} sims of {ebreport['report']['source']} "
        f"(batch norm, int8): {ebreport['games_per_s']:.2f} games/s, {ebreport['dispatches']} "
        f"dispatches, p50 {ebreport['dispatch_ms_p50']:.1f} ms; launches {ebreport['launches']} [{card}]"
    )
    say(f"eval-bn-int8 phase: {time.perf_counter() - t_prec:.1f} s")
    t_prec = time.perf_counter()
    srreport_run = serve_run_phase(torch, "train-bn-int8-sync")
    say(f"serve-run phase: {time.perf_counter() - t_prec:.1f} s")
    say(
        f"serve --run-name train-bn-int8-sync: {srreport_run['inference_precision']} "
        f"{srreport_run['norm_type']}-norm weights of step {srreport_run['served_step']}, hot-reloaded "
        f"{srreport_run['reloaded_steps']}; {srreport_run['dispatches']} dispatches, p50 "
        f"{srreport_run['dispatch_ms_p50']:.1f} ms, {srreport_run['moves_per_s']:.1f} moves/s; "
        f"launches {srreport_run['launches']} [{card}]"
    )
    t_prec = time.perf_counter()
    spreport = serve_precision_phase(torch, dev, KERNELS, sleep_cycles_per_ms())
    say(f"serve-precision phase: {time.perf_counter() - t_prec:.1f} s")
    for name, r in spreport.items():
        extra = ""
        if name == "int8":
            extra = (f"; dequantization {r['dequant_launches_per_evaluation']} launches, "
                     f"{r['dequant_us_per_evaluation']:.1f} us per evaluation")
        say(
            f"serve-{name}: dispatch p50 {r['dispatch_ms_p50']:.1f} ms (interleaved with the other "
            f"precisions), {r['moves_per_s']:.1f} moves/s, search.evaluate "
            f"{r['evaluate_device_ms_per_dispatch']:.2f} ms on the card a dispatch, busy "
            f"{r['profile']['device_busy_share']:.1%}, weights read from {r['resident_weight_bytes']} "
            f"bytes (leaf form {r['leaf_form_bytes']}){extra} [{card}]"
        )
    say(f"precision phases: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    slreport = serve_ladder_phase(torch, dev, KERNELS)
    say_ladder("serve-ladder", slreport, card)
    say(f"serve-ladder phase: {time.perf_counter() - t0:.1f} s")
    t_lad = time.perf_counter()
    slrreport = serve_ladder_phase(torch, dev, KERNELS, reuse=True)
    say_ladder("serve-ladder-reuse", slrreport, card)
    say(f"serve-ladder-reuse phase: {time.perf_counter() - t_lad:.1f} s")
    t_lad = time.perf_counter()
    lgreport = league_phase(torch, dev)
    say(
        f"league: pool of {lgreport['pool_size']} after {lgreport['promotions']} promotion(s), "
        f"{lgreport['rounds']} rounds to step {lgreport['steps']} ({lgreport['rounds_per_s']:.3f} "
        f"rounds/s, {lgreport['ingested_moves']} moves ingested at "
        f"{lgreport['ingested_moves_per_s']:.1f} moves/s, {lgreport['stale_dropped']} stale), league "
        f"dispatch p50 {lgreport['dispatch_ms_p50']:.1f} ms over {lgreport['dispatches']} dispatches, "
        f"ratings {lgreport['ratings']}; pool run {lgreport['pool_s']:.1f} s, league run "
        f"{lgreport['league_s']:.1f} s; gather_rows and backup_update bit-equal to plain at "
        f"{', '.join(f'b{b}' for b in lgreport['kernels_held_bit_equal'])} in process; "
        f"{lgreport['ledger_league_records']} kind:league records in the run's ledger; device_stats "
        f"{lgreport['device_stats']}; launches {lgreport['launches']} [{card}]"
    )
    say(f"league phase: {time.perf_counter() - t_lad:.1f} s")
    say(f"slice-nine phases: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    ssreport = serve_stats_phase(torch, dev)
    say(
        f"serve-stats: dispatch p50 off / on {ssreport['dispatch_ms_p50_off']:.1f} / "
        f"{ssreport['dispatch_ms_p50_on']:.1f} ms (interleaved: "
        f"{', '.join(f'{t:.1f}' for t in ssreport['dispatch_ms_off'])} / "
        f"{', '.join(f'{t:.1f}' for t in ssreport['dispatch_ms_on'])}); profiled "
        f"{ssreport['device_launches_off']} / {ssreport['device_launches_on']} kernels and copies "
        f"(+{ssreport['added_launches_per_dispatch']} a dispatch), device {ssreport['device_ms_off']:.2f} / "
        f"{ssreport['device_ms_on']:.2f} ms, search.stats {ssreport['stats_device_ms']:.3f} ms on the card "
        f"({ssreport['stats_host_ms']:.3f} ms host), host-blocking calls equal "
        f"{ssreport['host_blocking_calls']}; {ssreport['records']} serve legs ledgered, "
        f"{json.dumps(ssreport['serve_leg'])} [{card}]"
    )
    bnreport = beacon_phase(torch, dev, sleep_cycles_per_ms())
    say(
        f"beacons: a {bnreport['warn_dispatch_ms']:.0f} ms dispatch armed them once; "
        f"{bnreport['read_after_s']} s into a {BEACON_WEDGE_STALL_MS:.0f} ms stall the last beacon was "
        f"{bnreport['last_beacon_during_stall']} (the host had enqueued "
        f"{bnreport['enqueued_before_read']}); wedge report {bnreport['wedge_last_beacon']}, "
        f"{bnreport['verdict']}: {bnreport['verdict_detail']}; {bnreport['rows']} rows equal to the "
        f"host's ({bnreport['dropped']} dropped); dispatch p50 unarmed / armed "
        f"{bnreport['dispatch_ms_p50_unarmed']:.1f} / {bnreport['dispatch_ms_p50_armed']:.1f} ms; "
        f"{bnreport['launches']} beacon launches [{card}]"
    )
    pfreport = profile_phase(torch)
    say(
        f"profile: cli train --fused-megastep --profile, window {pfreport['window']}, phases "
        f"{pfreport['phase_timers']}; megasteps {[round(t, 1) for t in pfreport['megastep_ms_profiled']]} ms "
        f"in the window, {[round(t, 1) for t in pfreport['megastep_ms_unprofiled']]} ms after it; trace "
        f"{pfreport['trace_mb']:.1f} MiB, cli "
        f"analyze {pfreport['analyze_s']:.1f} s; device {pfreport['device_ms']:.1f} ms on "
        f"{pfreport['device_lines']}; kernels {pfreport['kernel_counts']}; top five "
        + ", ".join(f"{t['name'][:48]} {t['ms']:.1f} ms x{t['count']} ({t['share']:.1%})"
                    for t in pfreport["top5"])
        + f" [{card}]"
    )
    say(f"slice-twelve phases: {time.perf_counter() - t0:.1f} s")

    flreport = fleet_phase(torch, dev, KERNELS, kind)
    say_fleet(flreport, card)

    # The supervise drills (torch-free `cli supervise` parents and their
    # children) run beside the dp phases' rank processes: each side waits
    # on its own processes, and neither reads the other's launch counts.
    t_drills = time.perf_counter()
    drills: dict = {}

    def supervise_drills() -> None:
        t0 = time.perf_counter()
        drills["wedge"] = supervise_wedge_phase(torch, treport["warmup_chunks"])
        drills["wedge_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        drills["torn"] = supervise_torn_phase(torch)
        drills["torn_s"] = time.perf_counter() - t0

    join_drills = in_background(supervise_drills)
    # The overlapped dp pair, then the memory plane's commands (their own
    # processes, which read the pair's run), run beside them too.
    memplane: dict = {}

    def async_then_memory_plane() -> None:
        t0 = time.perf_counter()
        memplane["async"] = train_dp2_shared_async_phase(torch)
        memplane["async_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        memplane.update(memory_plane_phase(torch))
        memplane["seconds"] = time.perf_counter() - t0

    join_memplane = in_background(async_then_memory_plane)
    t0 = time.perf_counter()
    d1report = train_dp1_phase(torch)
    say_dp("train-dp1", d1report, card)
    repeat = d1report["undistributed_repeatable"]
    say(
        f"train-dp1: the parameters after the first megastep equal the undistributed run's "
        f"({d1report['reference']}"
        + ("" if repeat is None else f"; two of them {'repeat bit for bit' if repeat else 'differ'}")
        + f") {'bit for bit' if d1report['params_bit_equal'] else 'within rtol 2e-4, atol 2e-5'} [{card}]"
    )
    say(f"train-dp1 phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    d2report, d2resume = train_dp2_shared_phase(torch)
    say_dp("train-dp2-shared", d2report, card)
    say(f"train-dp2-shared phase (the ranks): {time.perf_counter() - t0:.1f} s")
    join_memplane()
    d2areport = memplane.pop("async")
    say_dp_async(d2areport, card)
    say(f"train-dp2-shared-async phase (the ranks, beside the dp phases): {memplane.pop('async_s'):.1f} s")
    memplane["readers"] = memory_readers(d2areport["run_dir"], srreport_run["serve_run_dir"])
    say_memory_plane(memplane, treport["peak_mem_gb"], card)
    say(f"memory-plane phase (cli warm, fit and fit --limit-gb 1 beside the dp phases): "
        f"{memplane['seconds']:.1f} s")
    join_drills()
    swreport, streport = drills["wedge"], drills["torn"]
    say_supervise("supervise-wedge", swreport, card)
    say(
        f"supervise-wedge: hang-dispatch at dispatch {swreport['hang_at_dispatch']} "
        f"({swreport['hung_program']}), wedge report at {swreport['wedge_elapsed_s']} s past its "
        f"{swreport['wedge_deadline_s']} s deadline, death {swreport['hang_to_death_s']:.1f} s after "
        f"the hung intent; doctor at the death {swreport['at_death']['doctor']['verdict']} "
        f"(exit {swreport['at_death']['doctor_rc']}); {swreport['beacon_rows']} beacon rows from "
        f"{swreport['beacon_launches']} launches in the respawn [{card}]"
    )
    say(f"supervise-wedge phase (beside the dp phases): {drills['wedge_s']:.1f} s")
    say_supervise("supervise-torn", streport, card)
    say(f"supervise-torn: the checkpoints at the death {json.dumps(streport['checkpoints_at_death'])} [{card}]")
    say(f"supervise-torn phase (beside the dp phases): {drills['torn_s']:.1f} s")
    say(f"supervise drills and dp phases: {time.perf_counter() - t_drills:.1f} s")
    t_resume = time.perf_counter()
    join_resume = in_background(d2resume)
    # The mesh pair's rank processes run beside the resume, the doctor,
    # the readers and the reference phases.
    mesh_out: dict = {}

    def mesh_pair() -> None:
        mesh_out["reports"], mesh_out["seconds"] = mesh_phases(torch)

    join_mesh = in_background(mesh_pair)
    # The tuner's commands (processes of their own) and the play phase (its
    # processes, and card work in this process that launches no kernel),
    # each on a thread of its own, beside them too.
    tuneplay: dict = {}

    def timed(name: str, phase) -> None:
        t0 = time.perf_counter()
        tuneplay[name] = phase(torch)
        tuneplay[f"{name}_s"] = time.perf_counter() - t0

    join_tune = in_background(lambda: timed("tune", tune_phase))
    join_play = in_background(lambda: timed("play", play_phase))

    t0 = time.perf_counter()
    dcreport = doctor_phase(prreport, flreport, swreport)
    say("doctor: " + "; ".join(
        f"{name} {v['verdict']} (exit {v['rc']})" for name, v in dcreport.items()
    ) + f"; fleet evidence {json.dumps(dcreport['fleet_parent']['evidence'])}")
    rdreport = readers_phase(kind)
    say(
        f"readers: trace {rdreport['trace_spans']}; trace --fleet {rdreport['trace_fleet']['events']} "
        f"events, {rdreport['trace_fleet']['processes']} processes ({', '.join(rdreport['trace_fleet']['replicas'])}), "
        f"{rdreport['trace_fleet']['flows']} flow arrows; watch {rdreport['watch_frame'][0]!r}; compare "
        f"parity on {rdreport['compare_rows']}; slo {rdreport['slo']}; perf fleet_deaths "
        f"{rdreport['perf_fleet'].get('fleet_deaths')}, fleet_respawns "
        f"{rdreport['perf_fleet'].get('fleet_respawns')}; devices {rdreport['devices']}"
    )
    say(f"doctor and readers phases: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    rsreport = reference_phase(torch, dev)
    say(
        "reference: card search equals the CPU search on a small input, its stat-pack too "
        f"(histogram {[int(v) for v in rsreport['depth_hist'][:6]]}..., entropy "
        f"{rsreport['root_entropy']:.6f}, occupancy {rsreport['occupancy']:.6f})"
    )
    rureport = reference_reuse_phase(torch, dev)
    say(
        f"reference: card carried search equals the CPU's over {rureport['moves']} moves "
        f"(inherited visits {rureport['reused']}, {rureport['valid_lanes']} lanes carried)"
    )
    rreport = reference_train_phase(torch, dev)
    say(
        f"reference: card megastep equals the CPU megastep (rows {rreport['rows']}, same slots; "
        f"return err {rreport['value_target_max_abs_err']:.2e}, loss err "
        f"{rreport['loss_max_abs_err']:.2e}, TD err {rreport['td_max_abs_err']:.2e})"
    )
    rreport["carried_search"] = rureport
    ryreport = reference_sync_phase(torch, dev)
    say(
        f"reference: card synchronous iteration equals the CPU's (rows {ryreport['rows']}, "
        f"{ryreport['steps']} steps, the same {ryreport['draws']} draws of slots; loss err "
        f"{ryreport['loss_max_abs_err']:.2e})"
    )
    rreport["sync_iteration"] = ryreport
    rgreport = reference_gumbel_phase(torch, dev)
    say(
        "reference: card Gumbel search equals the CPU's, explore and exploit (improved policy "
        f"err {rgreport['explore']['improved_policy_max_abs_err']:.2e} / "
        f"{rgreport['exploit']['improved_policy_max_abs_err']:.2e})"
    )
    rreport["gumbel_search"] = rgreport
    rpreport = reference_pcr_phase(torch, dev)
    say(
        f"reference: card playout-cap Gumbel chunk equals the CPU's (is_full {rpreport['is_full']}, "
        f"sims {rpreport['sims']}, {rpreport['rows']} rows)"
    )
    rreport["pcr_chunk"] = rpreport
    rqreport = reference_precision_phase(torch, dev)
    say(
        f"reference: the card's int8 q/scale ({rqreport['int8_leaves']} leaves) and dequantization "
        f"equal the CPU's bit for bit; a batch-norm learner step within "
        f"{rqreport['bn_step_loss_max_rel_err']:.2e} relative (running statistics "
        f"{rqreport['bn_running_stats_max_abs_err']:.2e}); bf16 / int8 searches within "
        f"{rqreport['search']['bfloat16']['root_prior_max_abs_err']:.2e} / "
        f"{rqreport['search']['int8']['root_prior_max_abs_err']:.2e} on the root priors"
    )
    rreport["precision"] = rqreport
    rreport["search_stat_pack"] = rsreport
    say(f"reference phase: {time.perf_counter() - t0:.1f} s")
    join_resume()
    rs = d2report["resume"]
    say(
        f"train-dp2-shared: parameter digests equal on both ranks after each of {TRAIN_MEGASTEPS} "
        f"megasteps; rank 0 alone wrote the checkpoints, meta.json, the ledger and the heartbeat; "
        f"one process resumed step {rs['resumed_step']} with both shards' {rs['restored_rows']} rows "
        f"(restore {rs['restore_s'] * 1e3:.1f} ms, first megastep {rs['megastep_ms']:.1f} ms, beside "
        f"{rs['beside']}) [{card}]"
    )
    say(f"train-dp2-shared resume, beside the doctor, readers and reference phases and the mesh pair: "
        f"{time.perf_counter() - t_resume:.1f} s")

    join_mesh()
    mesh_reports = mesh_out["reports"]
    for label, r in mesh_reports.items():
        say_mesh(label, r, card)
    say(f"{' and '.join(MESH_PHASES)} phases (one pair of ranks, beside the resume, doctor, readers and "
        f"reference phases): {mesh_out['seconds']:.1f} s")
    join_tune()
    join_play()
    tnreport, plreport = tuneplay["tune"], tuneplay["play"]
    say_tune(tnreport, card)
    say(f"tune phase (cli tune, train --preset, tune --calibrate beside the resume and the mesh pair): "
        f"{tuneplay['tune_s']:.1f} s")
    say(f"play: the GameState engine's transcript on the card equals the CPU's ({plreport['transcript_lines']} "
        f"lines, {plreport['moves']} moves); the native engine played {plreport['native_moves']} moves; "
        f"{plreport['native_transitions_compared']} native transitions equal the card engine's; "
        f"evaluate_batch of {plreport['evaluate_states']} states within {plreport['evaluate_prob_max_abs_err']:.3g} "
        f"(policy) / {plreport['evaluate_value_max_abs_err']:.3g} (value) of evaluate_state at the flagship "
        f"net [{card}]")
    say(f"play phase (beside the tune phase): {tuneplay['play_s']:.1f} s")
    say(f"from the drills to the mesh pair, the tune and play phases: {time.perf_counter() - t_drills:.1f} s")

    paths = {
        "serve": sreport, "train": treport, "serve_reuse": srreport, "train_reuse": trreport,
        "train_sync": syreport, "train_sync_host": shreport, "train_async": asreport,
        "preempt_resume": prreport, "megastep_resume": mrreport, "eval": evreport,
        "train_preset3": p3report, "eval_gumbel": egreport, "serve_gumbel": sgreport,
        "train_preset3_megastep": p3mreport, "train_preset3_async": p3areport,
        **{f"train_preset{n}": r for n, r in preset_reports.items()},
        "train_bn_bf16_megastep": pbreport, "train_bn_int8_sync": pireport,
        "train_int8_async": pareport, "eval_bn_int8": ebreport, "serve_run_int8": srreport_run,
        **{f"serve_{name}": r for name, r in spreport.items()},
        "serve_ladder": slreport, "serve_ladder_reuse": slrreport, "league": lgreport,
        "fleet": flreport,
        "supervise_wedge": supervised_path(swreport), "supervise_torn": supervised_path(streport),
        "train_dp1": d1report, "train_dp2_shared": d2report, "train_dp2_shared_async": d2areport,
        "train_tp2_shared": mesh_reports["train-tp2-shared"],
        "train_sp2_shared": mesh_reports["train-sp2-shared"],
        "tune": tnreport, "train_tuned": tnreport["train"],
    }
    kernels_line = []
    for kname, kr in kreport.items():
        entry = {key: kr[key] for key in (
            "name", "route", "source", "replaces", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms",
        ) + tuple(
            key for key in ("at_512_lanes", "at_dp2_rank", "worst_case", "real_waves", "ms_by_lanes",
                            "search_shapes")
            if key in kr
        )}
        by_path = {path: rep["launches"][kname] for path, rep in paths.items()}
        entry["launches"] = sum(by_path.values())
        entry["launches_by_path"] = by_path
        # The search kernels run once per searched move (warm-up chunks
        # and megasteps alike, every loop), the PER count once per megastep.
        per = {}
        for path, rep in paths.items():
            if "dispatches" in rep:
                per[f"{path}_dispatch"] = by_path[path] / rep["dispatches"]
            elif kname == "per_sample" and "megasteps" in rep:
                per[f"{path}_megastep"] = by_path[path] / rep["megasteps"]
            else:
                per[f"{path}_searched_move"] = by_path[path] / rep["searched_moves"]
        entry["launches_per"] = per
        kernels_line.append(entry)
    # The beacon writer runs on its own paths: armed beacons (the beacon
    # phase's dispatches and the train phase's armed megastep).
    beacon_entry = dict(bkreport)
    beacon_entry["launches_by_path"] = {
        "beacons": bnreport["launches"], "train_armed_megastep": treport["stats_ab"]["beacon_launches"],
        "supervise_wedge_respawn": swreport["beacon_launches"],
    }
    beacon_entry["launches"] = sum(beacon_entry["launches_by_path"].values())
    if not all(beacon_entry["launches_by_path"].values()):
        fail(f"the beacon writer was not launched on every beacon path: {beacon_entry['launches_by_path']}")
    kernels_line.append(beacon_entry)
    say(json.dumps({
        "kernels": kernels_line, **paths, "ring_round_trip": rtreport, "reference": rreport,
        "attention_memory": amreport, "empty_kernel_ms": empty_ms,
        "serve_stats": ssreport, "beacons": bnreport, "profile": pfreport,
        "doctor": dcreport, "readers": rdreport, "memory_plane": memplane, "play": plreport,
        "card": card,
    }))
    say(card)
    say("kernels: " + ", ".join(KERNELS) + ", beacon")
    say(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--mesh-rank":
        sys.exit(mesh_rank_child(sys.argv[2], int(sys.argv[3])))
    sys.exit(main())
