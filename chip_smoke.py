"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each:

  1. device    - the card's name and power limit (nvidia-smi);
  2. build     - compile both CUDA kernels from the sources in this checkout
                 (one nvcc per source, started together, sm_90a), and time it;
  3. check     - each kernel against its plain PyTorch version on the card:
                 fused_glm_grad within tolerance (and bitwise on a rerun)
                 at ragged, zero-weight, bfloat16 and main-path shapes, at
                 its edges (fewer flat rows than CTAs, R = 1, a CTA range
                 across slots whose weights all differ, the covtype width at
                 a small M, an odd width on a base that is not 16-byte
                 aligned: a contiguous X[1:]), and at the partial schemes'
                 [180, 1100, 128] and sparsegraph's [210, 4400, 128] stacks
                 with their round weights' zero pattern; fused_block_decode
                 bitwise at ragged, zero-weight and bfloat16 shapes, the deep
                 path's six leaves and deepmlp's W_in at the covtype width,
                 one leaf a launch; then the multi-leaf launch bitwise on deepmlp's and
                 moe's six leaves in the [30, 3, ...] slot layout, more slots
                 than one shared-memory stage holds, bfloat16, the covtype
                 width, the partition-major layout and more leaves than one
                 launch takes;
  4. main      - the paper's experiment through the CLI a user calls: approx
                 coding, W=30, s=2, num_collect=15, 132,000 x 128 synthetic
                 GMM rows, AGD, 100 rounds, faithful stack, on the card; the
                 kernel launch counts are set to 0 just before and read just
                 after; then the same run on the CPU, whose replayed training
                 loss the card's must match to relative 1e-4 in every round;
  5. deep      - the layer-coded deepmlp path at the same data width through
                 the CLI (100 rounds, fused block decode: one launch a round),
                 counts read as in ``main``; then its first 10 rounds on the
                 card and on the CPU, replayed losses within relative 1e-4, and
                 the same 10 rounds with ``--block-decode treewise`` on the
                 card, whose five artifacts must equal the fused run's
                 bitwise;
  6. moe, glm_layer - short layer-coded runs of the moe family and of the
                 logistic model at the same width, with their launch counts;
  7. schemes   - the other schemes of the registry through the CLI at the main
                 path's data and width: partialcyccoded and partialrepcoded
                 (--partitions-per-worker 6), randreg, expander and
                 sparsegraph (--num-collect 15), deadline (--deadline 0.5) and
                 approx --decode optimal; each 100 rounds on the card with
                 exactly 100 fused_glm_grad launches and none of the decode
                 kernel, its loss falling, then 10 rounds on the card and on
                 the CPU: replayed losses within relative 1e-4, simulated
                 clocks byte-equal;
  8. legacy    - the reference's 13-positional form and the named-flag form of
                 one run (approx, W=8, s=1, collect 4, 10 rounds) on one
                 reference layout written by data/io.write_reference_layout
                 (artificial preset, 4,096 x 100): bitwise-equal artifacts,
                 10 launches each;
  9. input_dir - the partialrepcoded run of ``schemes`` again, on a reference
                 layout of the same 132,000 x 128 data under
                 ``--input-dir`` (the ``partial/120`` leaf), read from its
                 ``.npy`` sidecars: 100 launches, five artifacts bitwise
                 equal to the generated-data run's, and the load's time;
  10. decode_ops - deepmlp's and moe's real per-slot leaves from
                 torch.func.vmap(grad) on the card: each must be contiguous
                 (the kernel reads them in place), and their decode must be
                 one kernel on the device and nothing else (no copy);
  11. time     - each kernel, its plain version, the library call where one
                 computes the same function, and the bound, at its path's
                 shapes (fused_glm_grad also at the partial and sparsegraph
                 stacks, and on sparsegraph's nonzero-weight slots alone:
                 the share of its time spent on zero-weight slots);
                 fused_glm_grad's column path (rows wider than a lane's
                 registers) at two widths off the main path; the decode per
                 leaf and per round (one launch against six cuBLAS GEMVs);
                 the decode off the deep path at one wide leaf on each side
                 of the width from which the kernel streams rows instead of
                 staging them is timed right after the checks (phase 3);
  12. profile  - device time by kernel over one more training run of the GLM
                 main path and of the deep path, from torch.profiler, and the
                 device's busy share of each round loop;
  13. cohort_check - the cohort decode (fused_block_decode_cohort, one launch
                 for every leaf of B trajectories) bitwise equal to its plain
                 version and to B one-trajectory launches: deepmlp's and moe's
                 leaves at [B, 30, 3, ...] for B = 1, 4, 28, float32 and
                 bfloat16, the [B, P] contract, 40 leaves (two launches), and
                 the leaves torch.func.vmap gives on the card for B = 4
                 (contiguous, or copied by the step: the copies are counted);
  14. compare_deduped - experiments.compare over the seven schemes of the
                 JAX cohort tests x seeds 0-3 (28 trajectories), deduped
                 [30, 4400, 128], 100 rounds, batch "auto": as many cohort
                 dispatches as plan_cohorts plans, no kernel launch; each
                 seed-0 row's replayed loss within relative 1e-4 of the same
                 scheme's sequential card run (compare, batch "off": 100
                 fused_glm_grad launches each), its simulated clock and
                 decode error the same bytes; the first 10 rounds of the
                 cohort on the card and on the CPU within relative 1e-4;
                 then ``transient``: the seven schemes, seed 0, 20 rounds,
                 as one cohort, undisturbed and under
                 ERASUREHEAD_CHAOS=raise:cohort:1:UNAVAILABLE (one
                 ``cohort.retry``, no split, the rows bitwise);
  15. compare_faithful - the seven schemes, seed 0, faithful: dispatches and
                 fused_glm_grad launches as plan_cohorts predicts (groups of
                 two or more batch, singletons run 100 launches each);
  16. straggler_sweep - {"approx": [1, 2], "cyccoded": [1, 2, 3]}, deduped:
                 the JAX labels and collect counts, losses falling;
  17. cohort_deep - deepmlp layer-coded (fused decode), GD, four trajectories
                 (lr 0.5 and 0.25 x seeds 0 and 1) on the faithful
                 [30, 3, 4400, 128] stack through trainer.train_cohort:
                 exactly one decode launch a round for the whole cohort, each
                 member's replayed loss within relative 1e-4 of its
                 sequential card run and its control-plane arrays the same
                 bytes, 5 rounds card vs CPU within 1e-4;
  18. time_cohort, profile_cohort - the cohort decode at B = 4 and 28 against
                 B one-trajectory launches, one torch.bmm per leaf and its
                 bound; 28 fused_glm_grad launches at [30, 4400, 128]; device
                 time per round of the 28-trajectory cohort (profiler) against
                 its bound (X read once), its busy share and steps/s.
  19. sparse   - a covtype-shaped one-hot CSR layout (generate_onehot:
                 396,120 x 15,509, 12 fields, seed 0) written by
                 data/io.write_reference_layout and trained through the CLI
                 (--dataset covtype --input-dir, approx, W=30, s=2, collect
                 15, --lr 1.0) as --sparse-format padded (per-slot),
                 padded --flat-grad on, fields (flat), fields with one-hot
                 scatter and margin, and fields --sparse-lanes 8: each 100
                 rounds on the card with no kernel launch and its loss
                 falling; its first 5 rounds (1 for the one-hot lowering)
                 on the card and on the CPU, replayed losses within relative
                 1e-4 and simulated clocks byte-equal; two card reruns of
                 as many rounds with bitwise-equal iterates (the script
                 fails otherwise); profiles of 20 and 40 rounds (2 and 4), whose
                 difference gives the loop's device time a round and busy
                 share, against the bound of reading the stack and labels
                 once;
  20. amazon_shaped - the same at 26,190 x 241,915 with 44 fields (every
                 pair table over the cap: the FieldOnehot plan is all
                 singles), --lr 0.2727, padded and fields, 10 rounds on the
                 card (no launch) and on the CPU;
  21. int8     - the main path with --stack-dtype int8: no kernel launch
                 under --use-pallas auto, --use-pallas on refused, 100
                 rounds on the card, 10 card vs CPU, reruns, a profile
                 against the bound of the int8 payload and scales read once;
  22. dense_lowerings - the main path with --flat-grad on and with
                 --margin-flat on: no kernel launch, 10 rounds card vs CPU;
  23. sparse_cohort - experiments.compare over the seven cohort schemes at
                 seed 0 on the covtype-shaped FieldOnehot stack, deduped: one
                 dispatch through the flat_vmap lowering, no launch, each
                 member within relative 1e-4 of its sequential card run.
  24. arrivals - the main path under each arrival model: ERASUREHEAD_REGIME
                 heavytail:50:1.2, adversary:30:4:5.0 and targeted:30:0:5.0
                 (on repcoded, whose partition groups are FRC's), then
                 --compute-time 0.1 --worker-speed-spread 0.3, then
                 --arrival-trace of a 20-round .npy trace this phase writes
                 (tiled to 100) with --worker-speed-spread 0.3: each 100
                 rounds on the card with exactly 100 fused_glm_grad
                 launches, its simulated clocks byte-equal to its first 10
                 rounds on the CPU and to the schedule the host builds from
                 trainer.default_arrivals, the model changing exactly the
                 rounds it should, replayed losses within relative 1e-4;
  25. attention - --model attention at the family's defaults (16 tokens of
                 8 features a row, d_model 16, 2 heads) on the main path's
                 data and AGD, layer-coded with the fused decode: 100 rounds
                 on the card with exactly 100 decode launches and no GLM
                 kernel, its loss falling; ATTN_SHORT_ROUNDS (2) rounds
                 card vs CPU within relative 1e-4; treewise bitwise equal
                 on the card over the same rounds; a
                 4-trajectory cohort (lr 10 and 5 x seeds 0 and 1), 30
                 rounds, in one dispatch with 30 decode launches, each
                 member within relative 1e-6 of its sequential card run;
  26. checkpoint - the main path saving every 25 rounds (artifacts bitwise
                 the uninterrupted run's); round_75's commit marker deleted
                 and round_50's state file cut in half, so --resume falls
                 back to round_25 with a warning and its artifacts are rows
                 25-99 bitwise (75 launches); a further resume from the
                 round_75 it wrote runs 25 rounds, bitwise; the attention run
                 saving every 50 rounds and resumed once, bitwise; the time
                 of a save, steps/s with and without checkpointing.
  27. data_cache - (27-29 run after cohort_deep) from an empty device data
                 cache, the seven schemes of the cohort phases, seed 0,
                 faithful at the flagship data, through
                 compare(batch="off"): 700 fused_glm_grad launches
                 a pass; data hits and misses as the layouts' stacking
                 signatures predict on the host (four distinct stacks);
                 again, all hits and rows bitwise the first pass's; again
                 with the cache off, the same rows; one run's set-up and
                 round-loop seconds on a miss and on a hit, the bytes reused;
  28. journal  - ERASUREHEAD_CHAOS=raise:trajectory:2 on the seven-scheme
                 deduped compare under batch off, auto and on, resumed from
                 its journal: bitwise under "off" (1,400 launches), the
                 largest loss difference of the cohorts; a real kill of
                 ``cli sweep --rounds 30`` in a subprocess
                 (kill:trajectory:3) exits 43, ``--resume-sweep`` finishes
                 with an uninterrupted run's science rows, two in-process
                 suite runs are bitwise equal, and a resume over the whole
                 journal launches no kernel; every journal validates;
  29. pipeline - the main path with --pipeline-depth 1 --update-rule GD: 100
                 fused_glm_grad launches, its schedule byte-equal to the
                 host's pipelined_schedule and to a 10-round CPU run's,
                 losses within relative 1e-4 of the CPU's, the loss falling,
                 the depth-0 run bitwise the synchronous one and parted from
                 the pipelined one from round 1; deepmlp layer-coded
                 pipelined, 20 rounds, 20 decode launches, within 1e-4 of
                 the CPU; the refusals of cyccoded, AGD and
                 --checkpoint-dir with their reasons.
  30. streamed - (after pipeline) the main path out of a shard store
                 (--stack-residency streamed): with no window (every
                 partition, the store spilled to a temporary directory) 100
                 fused_glm_grad launches and five artifacts bitwise the
                 resident main run's; --stream-window 6 (approx's groups
                 of s+1 workers make 3, 6 and 15 the window-uniform
                 windows: 5 slot-groups of 6 workers, B1 at
                 [18, 4400, 128]): 100 launches, two card reruns bitwise,
                 the loss falling, clocks byte-equal to and the first 10
                 rounds' replayed loss within relative 1e-4 of the CPU run,
                 the loop's peak device bytes at most depth + 2 windows;
                 the same for cyccoded --stream-window 10 (halo 2, the last
                 span wraps, B1 at [30, 4400, 128]), materialized and under
                 --stack-mode ring (12 partitions staged partition-major a
                 window, the [30, 4400, 128] slots rebuilt every round; the
                 peak within the bound plus those slots; the first launch
                 held against its plain version on its own inputs; bitwise
                 the materialized run) and auto (resolves to the ring,
                 bitwise the ring run; ``ring_window``); an
                 int8 store written by ``data.prepare --store
                 --store-dtype int8`` (13,200 x 128) trained windowed with
                 no launch; a 16x store (2,112,000 x 128 float32, about
                 1.09 GB, in a temporary directory) under an
                 ERASUREHEAD_STREAM_WINDOW budget of two 3-partition
                 windows, deduped: 100 launches at [3, 70400, 128], reruns
                 bitwise, steps/s, the prefetcher's staging and stall
                 seconds and overlap, peak windows, and a profile (busy
                 share); the seven cohort schemes deduped and streamed
                 (window 6) through compare in one dispatch, no launch.
                 B1 is also checked (``check``) and timed (``time_stream``)
                 at the three window shapes.
  31. dynamic  - (after streamed) trainer.train_dynamic at the main path's
                 config: arrivals drawn with JAX's threefry on the card,
                 the rule, the slot weights and the decode inside the round;
                 exactly 100 fused_glm_grad launches and none of the decode
                 kernel, the round loop under
                 torch.cuda.set_sync_debug_mode("error"), the replayed loss
                 falling; steps/s and device busy share beside train()'s on
                 the same config; 10 rounds on the card and the CPU (masks
                 equal or the differing rounds printed with both arrival
                 times, clocks within relative 1e-6, losses within 1e-4);
                 cyccoded through its float64 decode table (100 launches,
                 sync-free); deepmlp layer-coded, 20 rounds (20 decode
                 launches, sync-free); a 4 + 6 round split restart bitwise
                 the unsplit run; randreg collecting 15 of 30 (no table, the
                 float32 solve) under the "warn" mode, its synchronisations
                 counted;
  32. measured - the CLI with --arrival-mode measured at the main path, 20
                 rounds: exactly 20 decode launches (the per-worker messages'
                 decode) and no fused_glm_grad, the five artifacts,
                 worker_timeset real seconds (delay plus a positive measured
                 compute) or -1, the measured compute's median and p90 in
                 microseconds; avoidstragg without delays, workers 0 and 1
                 doing 400x the work: excluded in more than half of 10
                 rounds; then (``measured_device_list``) the queue replay
                 over ["cuda:0", "cuda:0"] in this process, avoidstragg at
                 W = 4 (workers 0 and 2 on device 0): both heavy, then
                 worker 0 alone heavy, workers 0 and 2 excluded in more
                 than half of 10 rounds each, 10 decode launches each;
  33. failures - workers 3, 7 and 11 killed at round 40 through the CLI:
                 --on-death failover --death-timeout 2.0 (100 launches at
                 [90, 4400, 128], rewritten rounds' clocks 2.0; naive too,
                 whose rounds from 40 on are all rewritten), --on-death
                 elastic (40 launches at [90, 4400, 128], 60 at the 27
                 survivors' [81, 4888, 128], dead columns -1 from round 40,
                 the loss step at the restart within twice the uninterrupted
                 run's), and failures.train_elastic(dynamic=True) (100
                 launches, the same shapes). B1 is checked at the
                 survivors' stack and B2 at the measured round's
                 [30, 3, 128] leaf (``check``), and that decode timed
                 (``time_round``, path measured).
  34. adapt    - (after failures) adaptive collection (adapt/) at the flagship
                 data, deduped, ERASUREHEAD_REGIME=adversary:50:0:8: the CLI
                 with --adapt on --adapt-chunk 10 (100 B1 at [30, 4400, 128],
                 no B2, at most one data-cache miss in ten chunks, the loss
                 falling), then the API under the progress reward (steps/s,
                 decision and driver overheads, total wall seconds, beside
                 plain train()'s steps/s) and under time_error with
                 shift_factor 1.4 (100 B1; its decisions bitwise those of the
                 CPU run over the first 60 rounds, a regime_shift among them);
  35. elastic  - online elastic membership (elastic/): the CLI with workers 3,
                 7 and 11 dead from round 40, --elastic on --death-timeout
                 2.0: 100 B1, at [90, 4400, 128] until the re-layout and at
                 [81, 4888, 128] after it, the re-layout round and dead
                 columns the CPU run's, the loss falling; the API run on the
                 card with the CPU's decisions and epochs; a chaos drill
                 (worker_death at boundary 2, a raise at the elastic site's
                 3rd boundary, 40 rounds, checkpoint and journal) resumed
                 bitwise; deepmlp layer-coded, 20 rounds, one death: 20 B2,
                 checked at the survivors' [29, 1, ...] slots. B1 is timed at
                 the survivors' [81, 4888, 128] beside its bound
                 (``time_survivors``).
  36. tune     - (after elastic; every phase before it reads an empty
                 tune cache file, so its auto knobs resolve as they did
                 before the tune plane) on its own cache: the glm_fused race
                 (B1 against the two-pass gradient) at the main stack
                 [30, 3, 4400, 128] and at cyccoded W = 3, s = 1, 6,600 x
                 15,509 ([3, 2, 2200, 15509], B1's column path), each
                 verdict in the cache and its 100-round auto run launching
                 100 B1 if it is "pallas" and none if "xla", with a tune
                 record of source "cache"; the deep path's block_decode and
                 layer_coding races at 8 rounds, then its 100-round run with
                 both knobs auto: 100 B2 if layer_coding resolved blockwise,
                 none if treewise, bitwise the forced run of the resolved
                 pair; ``cli tune --race all`` (all five races recorded, the
                 ring races at one process's one-hop ring); ERASUREHEAD_CHAOS=kill:tune_race:1
                 on a ``cli tune`` subprocess exits 43 with the cache's bytes
                 unchanged, and the rerun records the race's key; the warm
                 lookup's microseconds; every tune record validates;
  37. whatif   - approx c15, cyccoded and naive x exp:0.5 and adversary:8:0 at
                 the flagship data, W = 30, s = 2, 8 seeds x 30 rounds,
                 deduped (6 points, 48 trajectories): under batch auto one
                 cohort (the cohort matmul), no B1; under off 1,440 B1 at
                 [30, 4400, 128]; the surfaces agree (categorical fields
                 equal, numeric within relative 1e-4) and each run's runs/s;
                 a 2-seed, 10-round grid on the card and the CPU agrees the
                 same way, the sampler's blocks within 2 ulps; the sampler's
                 draw launches as many kernels for 1 seed as for 8 (the
                 profiler's count); ``cli whatif`` on the same --out
                 rehydrates bitwise with no launch; every whatif record
                 validates.
  38. telemetry - (after whatif) the run-telemetry plane: the main path
                 through the CLI with telemetry and tracing off, with
                 --telemetry on, and with --telemetry on --trace-dir: 100 B1
                 each, five artifacts bitwise the off run's, the event log
                 valid with one each of run_start, data_upload, compile,
                 rounds, decode, run_end, critical_path, eval and metrics,
                 run_end's steps/s the run's own; the torch.profiler trace
                 with 100 eh_scan/coded_step and 100 eh_scan/update host
                 spans and glm_grad_onepass device events (B1, one a call)
                 (between 1 and 100: a fresh window may drop its first
                 device records); ``cli report`` (and --validate) and ``cli
                 top`` on the log; the deep path traced, 20 rounds (20 B2,
                 block_decode_leaves events, eh_step/decode spans); a
                 four-scheme deduped cohort captured as ``sweep --events``
                 does (one cohort record, four trajectory streams, no B1);
                 the determinism audit at the main path, 30 rounds (60 B1,
                 bitwise); a windowed streamed run (one prefetch record per
                 staged window, the critical path's stall the prefetcher's);
                 the pipelined, cohort and streamed runs plain and under a
                 capture and a trace (bitwise, equal launches); the
                 registry's Prometheus text; the steps/s of the main runs,
                 of 40 off/on pairs of train() and 10 traced runs, and the
                 records' host cost after the loop.
  39. serve    - (after telemetry) the serve daemon (serve/) at the flagship
                 data on two dispatch threads: four tenants' eight GLM
                 requests packed (fewer dispatches, no B1, rows bitwise the
                 rows dispatched alone, losses within relative 1e-4 of
                 sequential train()); a use_pallas="on" request beside a
                 packed cohort (100 B1 at [90, 4400, 128], bitwise a direct
                 train()); four deepmlp layer-coded requests in one dispatch
                 (20 B2, bitwise alone); admission under 1.5 cohorts of
                 budget (defer, evict, admit; estimate against measured
                 peak); the HTTP front under three closed-loop tenants (429s,
                 no loss, /metrics, ``cli top``); the kill drill (``cli
                 serve`` exits 43 under kill:serve_dispatch:1, its restart
                 replays the WAL bitwise with no new kernel build); every
                 log valid, ``cli report``'s serve section. While the
                 drill's daemon builds, ``serve_ranks``: ``torchrun
                 --standalone --nproc-per-node 2`` of this script
                 (``--serve-child``), the daemon on two gloo ranks of the
                 one card, three wire requests (two packed, one
                 use_pallas="on"), 20 rounds: both ranks exit 0, every row
                 as a one-process daemon's (clocks equal, losses within
                 rtol 2e-5), 20 B1 on each rank.
  40. fleet    - (after serve) the serve fleet (serve/router.py,
                 serve/fleet.py): ``cli serve --device cuda`` replicas behind
                 the router sharing this process's kernel build directory
                 (its files unchanged: no replica builds); one replica's
                 rows bitwise an in-process daemon's (20 B1 at
                 [90, 4400, 128], 20 B2 there); three replicas and
                 kill:fleet_replica:2 on the one the ring routes a tenant
                 to (declared dead at a streak >= 3, its WAL adopted by its
                 ring peer, every row once and bitwise); a rolling deploy
                 of the survivors under closed-loop load (0 lost, 0
                 duplicates); one request set's goodput through one and
                 two replicas, boot seconds; every fleet record valid.
  41. native   - the native text parser on a 13,500 x 100 text matrix:
                 bitwise np.loadtxt, both timed, a cold load_dense_text on
                 the native path.
  42. mesh     - (after native) the worker axis across processes
                 (parallel/mesh.py, parallel/backend.py): a world-1 NCCL
                 group in this process from a FileStore runs the main path
                 materialized, ring with --ring-pipeline off and on, and the
                 deep path, each bitwise the same run with no group (100 B1,
                 or 100 B2), with peak device bytes and steps/s; then two
                 processes of this script (``--mesh-child``) on the one card
                 under gloo (NCCL refuses two ranks on one GPU): B1 at a
                 rank's [45, 4400, 128] against its plain version, the main
                 path materialized and ring off/on (100 B1 a rank, bitwise
                 each other and across the ranks, the replayed loss within
                 relative 1e-4 of world 1's), train_dynamic and the measured
                 cluster over 20 rounds. World 2's steps/s are two processes
                 time-slicing one card, not a multi-GPU speed. B1 is timed at
                 [45, 4400, 128] beside its bound (``time_mesh``). The same
                 two processes then run the model-internal axes
                 (``model_axes``): tensor-parallel mlp, pipeline-parallel
                 deepmlp, expert-parallel moe and sequence-parallel
                 attention under ring and Ulysses, each at its default
                 widths on the (workers 1, axis 2) mesh on the flagship
                 data for AXES_ROUNDS rounds: the ranks bitwise every round,
                 the first round's decoded gradient within rtol 2e-4 / atol
                 2e-5 of the unsharded card run's from the same params, the
                 replayed loss falling, 0 B1 / 0 B2; steps/s a rank, the
                 share of a profiled round in the axis collectives, peak
                 device bytes. Then (``stream_mesh``) each rank stages its
                 share of every window of one store the parent wrote, 20
                 rounds: deduped window 6 (B1 at [3, 4400, 128]),
                 materialized window 6 ([9, 4400, 128]) and the ring window
                 10 ([15, 4400, 128] on 6 of the 12 staged partitions), the
                 seven schemes' streamed cohort (no launch), train_adaptive,
                 train_elastic_online with worker 29 dead at round 5 (the 29
                 survivors re-fold onto one rank: 20 B1 on rank 0, 10 on
                 rank 1) and run_whatif (rank 0 writes the surface); each
                 held to the same run with no group in the parent: ranks
                 bitwise, the replayed loss within relative 1e-4, decisions
                 equal, B1's counts and shapes a rank, a rank's staged bytes
                 half of world 1's, each rank's first launch against its
                 plain version; B1 timed at the three rank shapes.
  43. graphs   - (after cohort_deep) the compiled round loop
                 (train/graphs.py): from empty caches, the main path, a
                 second run of its signature with another lr schedule and
                 seed (an executable hit), the deep path, train_dynamic, the
                 pipelined run, a checkpoint-chunked run and the
                 28-trajectory compare_deduped cohort, each replayed from
                 its captured CUDA graphs and held bitwise (params history,
                 final params, timeset, worker_times, collected,
                 decode_error) against the same run's eager loop
                 (graphs.disabled()), with the eager launch counts; B1's
                 and B2's 100 launches a run equal to one profiled graph
                 run's kernel events; B1 replayed in a one-round graph at
                 [90, 4400, 128] within tolerance of its plain version and
                 bitwise an eager launch, B2 bitwise its plain version under
                 replay; approx then repcoded on one stack 1 miss then 1 hit
                 with 1 data hit; a scan_unroll change one recompile warning
                 naming it; scan_unroll 1, 4, 7 and 100 bitwise at 100, 25,
                 15 and 1 replays; donate on and off bitwise, with their
                 peak bytes; steps/s, device ms a round and busy share,
                 graph and eager, of the main path, deep, train_dynamic and
                 the cohort. Every other phase runs its card runs through
                 the graph path too (the paths named eager in
                 train/trainer._loop_mode keep the eager loop).
Later, beside ``time`` and ``profile``: the attention run's per-slot leaves
through ``decode_ops``, its round's decode (one launch, six leaves of
[90, 913] floats) against its plain version, six GEMVs and the bound, and
its profile (device time a round, busy share, decode against the rest).
A ``profiler`` line lists every timing window that lost device records and
was taken again.

Then one ``{"kernels": [...]}`` line, the card's name and power limit, and as
the last line ``{"ok": true, "device": {...}}``. Any failed check raises and
exits non-zero; without a CUDA card, or without the erasurehead_tpu_torch
package beside this script, it exits non-zero before printing any result.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# the main path: the README Quickstart's approx run at the flagship width
MAIN_ARGS = [
    "--scheme", "approx", "--workers", "30", "--stragglers", "2",
    "--num-collect", "15", "--rounds", "100", "--rows", "132000",
    "--cols", "128", "--update-rule", "AGD", "--compute-mode", "faithful",
    "--add-delay", "--quiet",
]
ROUNDS = 100
MAIN_SHAPE = (90, 4400, 128)  # [W * (s+1), rows per partition, F]
# the layer-coded deep path: deepmlp (hidden 32, 4 layers) at the same data.
# GD, not the Quickstart's AGD: the reference's AGD starts its u sequence at
# 0 with theta_0 = 1, so its first iterate is -(lr/n) g_0, which puts a tanh
# network at the all-zero saddle, where its loss stays at log 2 (the JAX
# package's AGD does the same)
DEEP_ARGS = MAIN_ARGS[:MAIN_ARGS.index("--update-rule")] + [
    "--update-rule", "GD", "--lr", "0.5", "--compute-mode", "faithful",
    "--add-delay", "--quiet", "--model", "deepmlp", "--layer-coding", "on",
    "--block-decode", "fused",
]
SHORT_ROUNDS = 10  # the card-vs-CPU and fused-vs-treewise comparisons
# B1 against its plain version on the card (check phase; b1_ab.py too):
# (shape, dtype, zero every, leading slots cut off X)
B1_CASES = [
    ((6, 40, 32), torch.float32, 0, 0),  # fewer rows than a stage holds
    ((3, 17, 128), torch.float32, 0, 0),
    ((5, 300, 17), torch.float32, 2, 0),  # F % 4 != 0: scalar reads, ragged spans
    ((4, 33, 64), torch.bfloat16, 2, 0),
    ((7, 1000, 1000), torch.bfloat16, 3, 0),  # ragged R and F, 8 chunks a lane
    ((3, 600, 2048), torch.float32, 2, 0),  # the column path
    ((2, 300, 5001), torch.bfloat16, 0, 0),  # the column path, scalar reads
    (MAIN_SHAPE, torch.float32, 2, 0),
    (MAIN_SHAPE, torch.bfloat16, 2, 0),
    ((1, 3, 128), torch.float32, 0, 0),  # fewer flat rows than CTAs
    ((2, 1, 7), torch.float32, 0, 0),
    ((2, 1, 7), torch.bfloat16, 0, 0),
    ((2, 40, 15509), torch.float32, 0, 0),  # the covtype width at a small M
    ((2, 40, 15509), torch.bfloat16, 0, 0),
    ((3, 5, 17), torch.float32, 0, 1),  # X[1:]: odd F, base % 16 == 4
    ((4, 33, 17), torch.bfloat16, 0, 1),  # X[1:]: base % 16 == 2
    ((7, 1000, 96), torch.float32, 0, 0),  # ranges across slots, weights all differ
    ((7, 1000, 96), torch.bfloat16, 0, 0),
    ((300, 1, 64), torch.float32, 2, 0),  # R = 1: every row its own slot
    ((3, 7, 16384), torch.float32, 0, 1),  # the column path's widest rows, base offset
    ((2, 40, 20000), torch.float32, 0, 0),  # a cluster of two CTAs splits each row
    ((2, 40, 20000), torch.bfloat16, 0, 0),
    ((3, 7, 20001), torch.float32, 0, 1),  # the cluster path: odd F, base % 16 == 12
    ((16, 500, 16385), torch.bfloat16, 2, 1),  # many clusters, three tiles a row
    ((3, 7, 131072), torch.float32, 0, 1),  # a cluster of eight CTAs
    ((2, 3, 131073), torch.float32, 0, 1),  # wider than a cluster: the re-read path
    ((2, 3, 131075), torch.bfloat16, 0, 1),
]
# the trainer on rows wider than one CTA holds: naive W = 6, 1,200 x 20,000
WIDE_COLS_ARGS = [
    "--scheme", "naive", "--workers", "6", "--stragglers", "1", "--rounds", str(SHORT_ROUNDS),
    "--rows", "1200", "--cols", "20000", "--add-delay", "--quiet",
]
# the schemes phase: every other registry scheme at the main path's data
SCHEME_BASE = [
    "--workers", "30", "--stragglers", "2", "--rounds", "100", "--rows", "132000",
    "--cols", "128", "--update-rule", "AGD", "--compute-mode", "faithful",
    "--add-delay", "--quiet",
]
SCHEME_RUNS = (  # (name, scheme flags, B1's [M, R, F])
    ("partialcyccoded", ["--scheme", "partialcyccoded", "--partitions-per-worker", "6"],
     (180, 1100, 128)),
    ("partialrepcoded", ["--scheme", "partialrepcoded", "--partitions-per-worker", "6"],
     (180, 1100, 128)),
    ("randreg", ["--scheme", "randreg", "--num-collect", "15"], (90, 4400, 128)),
    ("expander", ["--scheme", "expander", "--num-collect", "15"], (90, 4400, 128)),
    ("sparsegraph", ["--scheme", "sparsegraph", "--num-collect", "15"], (210, 4400, 128)),
    ("deadline", ["--scheme", "deadline", "--deadline", "0.5"], (30, 4400, 128)),
    ("approx_optimal", ["--scheme", "approx", "--num-collect", "15", "--decode", "optimal"],
     (90, 4400, 128)),
)
PARTIAL_SHAPE, SPARSE_SHAPE = (180, 1100, 128), (210, 4400, 128)
# the legacy phase: approx, W = 8 (n_procs 9), s = 1, collect 4, on a written
# reference layout of the artificial preset (4,096 x 100)
LEGACY_ROWS, LEGACY_COLS, LEGACY_W = 4096, 100, 8
# the input_dir phase: this schemes run again, on its data written as a
# reference layout (partial/<(p - s) W> = partial/120)
INPUT_DIR_RUN = "partialrepcoded"
LAYER_ROUNDS = 20  # the moe and glm_layer runs
# M = 90 slots; per-slot leaf sizes of deepmlp at F = 128 in sorted-key order
# (W, W_in, b, b_in, b_out, w_out), and its W_in at the covtype preset's width
DEEP_LEAVES = (4096, 4096, 128, 32, 1, 32)
# the one-leaf decode timed at the widest and the narrowest of them (a deep
# round's six leaves are timed together by ``time_round``)
TIMED_LEAVES = (4096, 1)
COVTYPE_W_IN = 15509 * 32
# a [90, D] float32 leaf with 1 MiB rows: staged, where COVTYPE_W_IN's rows
# (1.9 MiB) stream (the kernel's kStreamMinRowBytes is 1.5 MiB)
STAGED_WIDE = 262144
SLOTS = (30, 3)  # the faithful stack's [W, S] slot layout
# rows wider than a lane's registers (B1's column path): 2,048 columns, and
# the covtype preset's width; rows a cluster of two CTAs splits (20,000
# columns), and rows wider than a cluster holds (140,000: the re-read path)
WIDE_SHAPES = ((30, 4400, 2048), (6, 2200, 15509), (6, 1700, 20000), (2, 1000, 140000))
# the cohort phases: the seven schemes of the JAX cohort tests at the main
# path's data, W = 30, s = 2, AGD at the artificial preset's lr (10)
COHORT_SCHEMES = {
    "naive": {}, "cyccoded": {}, "repcoded": {}, "approx": {"num_collect": 15},
    "avoidstragg": {}, "randreg": {"num_collect": 15}, "deadline": {"deadline": 0.5},
}
COHORT_BASE = dict(n_workers=30, n_stragglers=2, n_rows=132000, n_cols=128,
                   update_rule="AGD", add_delay=True)
COHORT_SEEDS = (0, 1, 2, 3)
DEDUPED_SHAPE = (30, 4400, 128)  # [P, rows per partition, F]
SWEEP_GRID = {"approx": [1, 2], "cyccoded": [1, 2, 3]}
# the JAX harness's labels and collect counts for SWEEP_GRID at W = 30
SWEEP_WANT = [("approx_s1", 15), ("approx_s2", 15), ("cyccoded_s1", 30),
              ("cyccoded_s2", 30), ("cyccoded_s3", 30)]
# the deep cohort: DEEP_ARGS' run at (lr, seed) = (0.5, 0), (0.5, 1), (0.25, 0), (0.25, 1)
DEEP_COHORT = [(lr, seed) for lr in (0.5, 0.25) for seed in (0, 1)]
# the sparse phases: one-hot CSR layouts shaped like the reference's covtype
# (396,112 rows rounded to the multiple of 30 that generate_onehot takes, 12
# fields, 15,509 columns) and amazon (44 fields of about 5.5k columns), the
# AGC run of the reference's real-data script at the stand-in lr of the JAX
# baseline suite (1.0 at nnz 12, 12/44 at nnz 44)
SPARSE_SHAPES = {"covtype": (396120, 15509, 12, "1.0"), "amazon": (26190, 241915, 44, "0.2727")}
SPARSE_BASE = [
    "--scheme", "approx", "--workers", "30", "--stragglers", "2", "--num-collect", "15",
    "--rounds", "100", "--update-rule", "AGD", "--compute-mode", "faithful", "--add-delay",
    "--quiet",
]
PROFILE_ROUNDS = 20  # the sparse, int8 and dense-lowering profiles
# the one-hot matmul lowering takes about 0.1 s a round on the card and
# seconds on the CPU at the covtype size: its card-vs-CPU comparison and
# reruns run ONEHOT_SHORT_ROUNDS (the others SPARSE_SHORT_ROUNDS), its profiles
# ONEHOT_PROFILE_ROUNDS
# (1 from PR 17, which paid so for the mesh phase's model axes)
ONEHOT_SHORT_ROUNDS, ONEHOT_PROFILE_ROUNDS = 1, 2
# the other covtype lowerings' card-vs-CPU comparison and reruns (5 from
# PR 18, which paid so for the ring stream windows and the world-2 streamed
# and driver runs; was SHORT_ROUNDS, 10)
SPARSE_SHORT_ROUNDS = 5
SPARSE_RUNS = (  # (name, flags, the trainer's lowering, short rounds, profile rounds)
    ("padded", ["--sparse-format", "padded"], "per_slot", SPARSE_SHORT_ROUNDS, PROFILE_ROUNDS),
    ("padded_flat", ["--sparse-format", "padded", "--flat-grad", "on"], "flat",
     SPARSE_SHORT_ROUNDS, PROFILE_ROUNDS),
    ("fields", ["--sparse-format", "fields"], "flat", SPARSE_SHORT_ROUNDS, PROFILE_ROUNDS),
    ("fields_onehot", ["--sparse-format", "fields", "--fields-scatter", "onehot",
                       "--fields-margin", "onehot"], "flat",
     ONEHOT_SHORT_ROUNDS, ONEHOT_PROFILE_ROUNDS),
    ("fields_lanes8", ["--sparse-format", "fields", "--sparse-lanes", "8"], "flat",
     SPARSE_SHORT_ROUNDS, PROFILE_ROUNDS),
)
# the arrivals phase: the main path under each arrival model (a regime
# armed by ERASUREHEAD_REGIME, or the heterogeneity and trace flags; the
# targeted attack on repcoded, whose partition groups are FRC's); TRACE is
# replaced by the .npy trace the phase writes (TRACE_ROUNDS rounds, tiled)
TRACE, TRACE_ROUNDS = "<trace>", 20
REPCODED_ARGS = ["--scheme", "repcoded"] + SCHEME_BASE
ARRIVAL_RUNS = (  # (name, ERASUREHEAD_REGIME or None, args, rows the model changes)
    ("heavytail", "heavytail:50:1.2", MAIN_ARGS, 50),
    ("adversary", "adversary:30:4:5.0", MAIN_ARGS, 70),
    ("targeted", "targeted:30:0:5.0", REPCODED_ARGS, 70),
    ("heterogeneous", None, MAIN_ARGS + ["--compute-time", "0.1", "--worker-speed-spread", "0.3"],
     100),
    ("trace", None, MAIN_ARGS + ["--arrival-trace", TRACE, "--worker-speed-spread", "0.3"], 100),
)
# the attention family at the repo's defaults (d_in 8: T = 16 tokens a row
# of the flagship's 128 features, d_model 16, 2 heads), layer-coded, fused
# decode, on the main path's flags
ATTN_ARGS = MAIN_ARGS + ["--model", "attention", "--layer-coding", "on", "--block-decode",
                         "fused"]
# its cohort: two lrs x two seeds
ATTN_COHORT = [(lr, seed) for lr in (10.0, 5.0) for seed in (0, 1)]
ATTN_COHORT_ROUNDS = 30
# its card-vs-CPU and treewise comparisons: the CPU runs about 0.3 rounds
# a second at this size (10 rounds until PR 17, which paid so for the mesh
# phase's model axes)
ATTN_SHORT_ROUNDS = 2
CKPT_EVERY, ATTN_CKPT_EVERY = 25, 50
# the sweep runner: the suite's rounds in the real-kill drill, and pipelined
# tau=1 training on the main path (GD: AGD is refused under pipelining) and
# on the deep path (LAYER_ROUNDS rounds)
SWEEP_ROUNDS = 30
PIPE_ARGS = MAIN_ARGS[:MAIN_ARGS.index("--update-rule")] + [
    "--update-rule", "GD", "--compute-mode", "faithful", "--add-delay", "--quiet",
    "--pipeline-depth", "1",
]
DEEP_PIPE_ARGS = [str(LAYER_ROUNDS) if prev == "--rounds" else a
                  for prev, a in zip([None] + DEEP_ARGS, DEEP_ARGS)] + ["--pipeline-depth", "1"]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12  # H100 SXM data sheet, float32 outside the tensor cores
ARTIFACTS = ("training_loss", "testing_loss", "auc", "timeset", "worker_timeset")


_T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line, stamped with the seconds since the script started
    (``at_s``: where the run's time went)."""
    print(json.dumps({"phase": phase, **fields,
                      "at_s": round(time.perf_counter() - _T0, 1)}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def import_port():
    """The port package from this checkout, and nowhere else."""
    import erasurehead_tpu_torch

    pkg = os.path.dirname(os.path.abspath(erasurehead_tpu_torch.__file__))
    if os.path.dirname(pkg) != HERE:
        raise RuntimeError(f"erasurehead_tpu_torch imported from {pkg}, not this checkout")
    from erasurehead_tpu_torch import cli
    from erasurehead_tpu_torch.ops import kernels
    from erasurehead_tpu_torch.utils.device import pin_float32_precision

    pin_float32_precision()
    return cli, kernels


def make_inputs(M, R, F, dtype, seed, zero_every=0, offset=0):
    """Seeded B1 inputs on the card; ``offset`` leading slots of X are made
    and cut off there (X[offset:]: contiguous, its base offset * R * F
    elements into its storage)."""
    g = torch.Generator().manual_seed(seed)
    X = (torch.randn(M + offset, R, F, generator=g) * (10 / F**0.5)).to(dtype).cuda()[offset:]
    y = torch.randn(M, R, generator=g).sign().cuda()
    b = (torch.randn(F, generator=g) * 0.1).cuda()
    w = torch.rand(M, generator=g).cuda()
    if zero_every:
        w[::zero_every] = 0.0
    return b, X, y, w


def check_glm(kernels, shape, dtype, kind, zero_every, seed, weights=None, offset=0):
    """Kernel vs plain version: |err| <= 1e-5 * sum_r |w s x| + 1e-6 per
    column, the float32 rounding of sums taken in another order.
    ``weights`` (a numpy [M] array) replaces the random slot weights."""
    b, X, y, w = make_inputs(*shape, dtype, seed, zero_every, offset)
    if weights is not None:
        w = torch.from_numpy(weights).cuda()
    return check_glm_inputs(kernels, b, X, y, w, kind)


def check_glm_inputs(kernels, b, X, y, w, kind, **fields) -> dict:
    """B1 against its plain version on these inputs, with check_glm's
    tolerance; ``fields`` ride the ``check`` record."""
    got = kernels.fused_glm_grad(b, X, y, w, kind)
    again = kernels.fused_glm_grad(b, X, y, w, kind)
    want = kernels.reference_glm_grad(b, X, y, w, kind)
    Xf = X.float()
    s = kernels._residual(kind, torch.einsum("mrf,f->mr", Xf, b), y) * w[:, None]
    scale = torch.einsum("mrf,mr->f", Xf.abs(), s.abs())
    torch.cuda.synchronize()
    err = (got - want).abs()
    tol = 1e-5 * scale + 1e-6
    ok = bool((err <= tol).all()) and bool(torch.isfinite(got).all())
    rec = dict(
        kernel="fused_glm_grad", shape=list(X.shape), dtype=str(X.dtype).split(".")[-1],
        kind=kind, zero_weight_slots=int((w == 0).sum()), x_base_mod16=X.data_ptr() % 16,
        max_abs_err=float(err.max()), max_err_over_tol=float((err / tol).max()),
        bitwise_rerun=bool(torch.equal(got, again)), ok=ok, **fields,
    )
    emit("check", **rec)
    if not ok or not rec["bitwise_rerun"]:
        raise AssertionError(f"fused_glm_grad disagrees with its plain version: {rec}")
    return rec


def time_ms(fn, n=50) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def glm_bound_ms(M, R, F, x_itemsize) -> tuple[float, str]:
    """Least time for the function on these inputs: each input read once and
    the output written once over HBM bandwidth, vs its float32 operations
    (2 FMAs per element of X) over the float32 peak."""
    nbytes = M * R * F * x_itemsize + M * R * 4 + F * 4 + M * 4 + F * 4
    flops = 4 * M * R * F
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def set_flag(args, flag, value):
    i = args.index(flag)
    return args[:i + 1] + [str(value)] + args[i + 2:]


def with_rounds(args, rounds):
    return set_flag(args, "--rounds", rounds)


def parse_config(cli, args):
    return cli._flags_to_config(cli._flags_parser().parse_args(args))


def run_main(cli, out_dir, device, args=MAIN_ARGS, prefix=None, workers=30, start=0) -> dict:
    """One CLI run; its five artifacts must exist, be finite and have the
    run's shape (rounds [start, rounds): a resumed run's window).
    ``prefix`` defaults to the named-flag run's artifact prefix."""
    if cli.main(args + ["--output-dir", out_dir, "--device", device]) != 0:
        raise AssertionError(f"cli.main failed on {device}: {args}")
    rounds = int(args[args.index("--rounds") + 1]) - start
    if prefix is None:
        from erasurehead_tpu_torch.train.artifacts import run_prefix

        prefix = run_prefix(parse_config(cli, args))
    paths = {a: os.path.join(out_dir, f"{prefix}_{a}.dat") for a in ARTIFACTS}
    missing = [p for p in paths.values() if not os.path.exists(p)]
    if missing:
        raise AssertionError(f"missing artifacts: {missing}")
    with open(os.path.join(out_dir, f"{prefix}_run_manifest.json")) as f:
        manifest = json.load(f)
    arts = {a: np.loadtxt(p, ndmin=2 if a == "worker_timeset" else 1)
            for a, p in paths.items()}  # a one-round [1, W] stays 2-D
    for a in ("training_loss", "testing_loss", "auc", "timeset"):
        if arts[a].shape != (rounds,) or not np.isfinite(arts[a]).all():
            raise AssertionError(f"{a}: shape {arts[a].shape} or non-finite values")
    if arts["worker_timeset"].shape != (rounds, workers):
        raise AssertionError(f"worker_timeset shape {arts['worker_timeset'].shape}")
    return dict(arts=arts, manifest=manifest)


def counted_run(cli, kernels, out_dir, args, want, **kw) -> dict:
    """A run on the card with every launch count set to 0 just before it
    and read just after; the counts must be exactly ``want``."""
    kernels.reset_launches()
    run = run_main(cli, out_dir, "cuda", args, **kw)
    run["launches"] = dict(kernels.LAUNCHES)
    if run["launches"] != want:
        raise AssertionError(f"{args} launched {run['launches']}, want {want}")
    return run


def compare_runs(gpu, cpu) -> dict:
    """The card's replayed training loss within relative 1e-4 of the CPU
    run's in every round, and byte-identical simulated clocks."""
    g_loss, c_loss = gpu["arts"]["training_loss"], cpu["arts"]["training_loss"]
    rel = np.abs(g_loss - c_loss) / np.abs(c_loss)
    same_clock = (
        gpu["arts"]["timeset"].tobytes() == cpu["arts"]["timeset"].tobytes()
        and gpu["arts"]["worker_timeset"].tobytes() == cpu["arts"]["worker_timeset"].tobytes()
    )
    if not (rel <= 1e-4).all():
        raise AssertionError(f"card vs CPU training loss differs by up to {rel.max():.3g}")
    if not same_clock:
        raise AssertionError("card and CPU runs disagree on the simulated clocks")
    return dict(max_rel_loss_diff_vs_cpu=float(rel.max()), same_clocks_as_cpu=same_clock)


def check_falls(run) -> list:
    loss = run["arts"]["training_loss"]
    if not loss[-1] < loss[0]:
        raise AssertionError(f"training loss did not fall: {loss[0]} -> {loss[-1]}")
    return [float(loss[0]), float(loss[-1])]


# idle seconds on each side of a profiled pass, inside its window
PROFILE_GUARD_S = 0.02
# device_ms's windows that lost records and were taken again (shown at the end)
LOST_WINDOWS: list = []


def profiled(body, guard_s=PROFILE_GUARD_S):
    """torch.profiler over ``body()`` run twice: a warm-up pass whose records
    are dropped, then the recorded pass. On the card a fresh profiler window
    loses its first device records (seen: 4 of 200 calls, and every record
    of a 20-call window); the warm-up pass takes that loss. The profiler
    keeps a device record only if its device timestamp falls inside the
    window's host-clock bounds, so an offset between the two clocks drops
    the records at the window's edges (seen late in a long run: 33 of 200
    calls in each of five windows). The recorded pass therefore starts
    ``guard_s`` after the window opens and the window closes ``guard_s``
    after the pass has synchronised; no caller's figure counts that idle
    time (they read device records and the run's own wall). Returns the
    profiler and the recorded pass's result."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for recorded in (False, True):
            if recorded:
                time.sleep(guard_s)
            out = body()
            torch.cuda.synchronize()
            if recorded:
                time.sleep(guard_s)
            prof.step()
    return prof, out


def device_events(prof) -> list:
    """The profile's device-side events (kernels, copies, memsets; a CPU
    op's device time repeats its kernels' time), without the profiler's own
    records (its buffers, the schedule's step markers)."""
    from torch.autograd import DeviceType

    return [ev for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA
            and not ev.key.startswith(("Activity Buffer", "ProfilerStep"))]


def profile_train(cli, args) -> dict:
    """profile_run of one path's trainer.train run."""
    from erasurehead_tpu_torch.train import trainer

    cfg = parse_config(cli, args)
    ds = cli.load_dataset(cfg)
    return profile_run(lambda: trainer.train(cfg, ds))


def profile_run(run) -> dict:
    """Where a round's time goes, over more runs of a path's training (after
    the launch counts were read): ``run()`` once warm without the profiler
    (steps/s), then once under torch.profiler, whose device activities in the
    round loop (kernels and device-to-device copies; the stack's upload
    before the loop and the profiler's own buffer events are left out) give
    the device's busy share of the loop. ``run`` returns a TrainResult (a
    cohort's first member: all share the cohort's clock)."""
    warm = run()
    prof, res = profiled(run)
    cfg = res.config
    rows = []
    for ev in device_events(prof):
        dev_us = device_us(ev)
        if dev_us and ev.key and not ev.key.startswith("Memcpy HtoD"):
            rows.append((ev.key, dev_us, ev.count))
    rows.sort(key=lambda r: -r[1])
    total_us = sum(r[1] for r in rows)
    return dict(
        rounds=cfg.rounds,
        warm_steps_per_sec=warm.steps_per_sec,
        profiled_loop_wall_ms=res.wall_time * 1e3,
        device_ms_in_loop=total_us / 1e3 if total_us else None,
        device_ms_per_round=total_us / 1e3 / cfg.rounds if total_us else None,
        device_busy_share=total_us / (res.wall_time * 1e6) if total_us else None,
        # device time of the port's own kernels; the rest is PyTorch's
        # (per-slot autodiff products, elementwise, optimizer, copies)
        kernel_ms={name: sum(us for k, us, _ in rows if tag in k) / 1e3
                   for name, tag in (("fused_glm_grad", "glm_grad"),
                                     ("fused_block_decode", "block_decode"))},
        top=[dict(name=k[:100], ms=us / 1e3, count=c) for k, us, c in rows[:16]],
        # every copy on the device in the loop (the decode makes none)
        copies=[dict(name=k[:100], ms=us / 1e3, count=c) for k, us, c in rows
                if "copy" in k.lower() or k.startswith("Memcpy")],
    )


def check_decode(kernels, M, D, dtype, seed, zero_every=0):
    """Kernel vs plain version: bitwise equal, and bitwise on a rerun. The
    max abs error is also shown against 1e-6 * sum_m |w_m g_md|."""
    gen = torch.Generator().manual_seed(seed)
    g = torch.randn(M, D, generator=gen).to(dtype).cuda()
    w = torch.randn(M, generator=gen).cuda()
    if zero_every:
        w[::zero_every] = 0.0
    got = kernels.fused_block_decode(w, g)
    again = kernels.fused_block_decode(w, g)
    want = kernels.reference_block_decode(w, g)
    scale = (w.to(dtype).float()[:, None] * g.float()).abs().sum(0)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    rec = dict(
        kernel="fused_block_decode", shape=[M, D], dtype=str(dtype).split(".")[-1],
        zero_weight_slots=int((w == 0).sum()), max_abs_err=float(err.max()),
        max_err_over_tol=float((err / (1e-6 * scale).clamp_min(1e-30)).max()),
        bitwise_vs_plain=bool(torch.equal(got, want)),
        bitwise_rerun=bool(torch.equal(got, again)),
    )
    emit("check", **rec)
    if not (rec["bitwise_vs_plain"] and rec["bitwise_rerun"]):
        raise AssertionError(f"fused_block_decode is not bitwise its plain version: {rec}")
    return rec


def decode_bound_ms(M, D, itemsize=4) -> tuple[float, str]:
    """Least time for one decode: g, w read once and out written once over
    HBM bandwidth, vs its 2 float32 operations per element of g."""
    nbytes = M * D * itemsize + 4 * M + D * itemsize
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, 2 * M * D / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_us(ev) -> float:
    """An event's device time in microseconds (the attribute's name moved
    between PyTorch versions)."""
    us = getattr(ev, "device_time_total", None)
    return us if us is not None else getattr(ev, "cuda_time_total", 0.0)


def device_ms(fn, n) -> float:
    """Device time of one call of ``fn`` from torch.profiler over ``n``
    calls: for each kernel (or copy) on the device, its mean time per
    record times its records per call. CUDA events around back-to-back calls
    would also count the gaps in which the card waits for the host to launch
    the next call, which is most of a small call's time. The profiler may
    lose a few records of a window (seen on the card: 199 and 196 of 200),
    which the mean does not feel; a profile that lost more than 2% is taken
    again, with a guard (``profiled``) twice as long as the last."""
    fn()
    torch.cuda.synchronize()
    attempts = []
    for i in range(5):
        prof, _ = profiled(lambda: [fn() for _ in range(n)], PROFILE_GUARD_S * 2 ** i)
        evs = device_events(prof)
        per_call = [round(ev.count / n) for ev in evs]
        if evs and all(k >= 1 and abs(ev.count - k * n) <= max(2, k * n // 50)
                       for ev, k in zip(evs, per_call)):
            return sum(device_us(ev) / ev.count * k for ev, k in zip(evs, per_call)) / 1e3
        attempts.append([(ev.key[:60], ev.count) for ev in evs])
        LOST_WINDOWS.append(dict(calls=n, guard_s=PROFILE_GUARD_S * 2 ** i, counts=attempts[-1]))
    raise AssertionError(f"the profiler lost device events of {n} calls: {attempts}")


def time_turns(fns) -> tuple[dict, dict]:
    """Each of ``fns`` ({name: (fn, calls)}) in turns a, b, ..., ..., b, a:
    device time per call (profiler) and time per call back to back (CUDA
    events), which a host-bound call's launch cost sets. The best of the
    two turns of each."""
    names = list(fns)
    dev, call = {}, {}
    for name in names + names[::-1]:
        fn, reps = fns[name]
        dev.setdefault(name, []).append(device_ms(fn, reps))
        call.setdefault(name, []).append(time_ms(fn, reps))
    return {k: min(v) for k, v in dev.items()}, {k: min(v) for k, v in call.items()}


def time_decode(kernels, M, D) -> dict:
    """The one-leaf kernel, its plain version and the library call
    ``g.t() @ w`` (one cuBLAS GEMV, never called by the port), float32."""
    gen = torch.Generator().manual_seed(7)
    g = torch.randn(M, D, generator=gen).cuda()
    w = torch.randn(M, generator=gen).cuda()
    n = 200 if D < 100_000 else 50
    dev, call = time_turns(dict(
        kernel=(lambda: kernels.fused_block_decode(w, g), n),
        plain=(lambda: kernels.reference_block_decode(w, g), max(5, n // 10)),
        library=(lambda: g.t() @ w, n),
    ))
    bound, by = decode_bound_ms(M, D)
    return dict(shape=[M, D], kernel_ms=dev["kernel"], plain_ms=dev["plain"],
                library_ms=dev["library"], bound_ms=bound, bound_by=by, call_ms=call)


def slot_leaves(shapes, dtype, seed, lead=SLOTS, zero_every=2):
    """Random [*lead] slot weights (every ``zero_every``-th 0) and leaves
    [*lead, *shape] on the card."""
    gen = torch.Generator().manual_seed(seed)
    ws = torch.randn(*lead, generator=gen)
    ws.view(-1)[::zero_every] = 0.0
    leaves = [torch.randn(*lead, *s, generator=gen).to(dtype).cuda() for s in shapes]
    return ws.cuda(), leaves


def check_decode_leaves(kernels, shapes, dtype, seed, lead=SLOTS) -> dict:
    """The multi-leaf wrapper the step calls vs its plain version: bitwise,
    bitwise on a rerun, one launch per 32 leaves."""
    ws, leaves = slot_leaves(shapes, dtype, seed, lead)
    before = kernels.LAUNCHES["fused_block_decode"]
    got = kernels.fused_block_decode_leaves(ws, leaves)
    again = kernels.fused_block_decode_leaves(ws, leaves)
    launches = (kernels.LAUNCHES["fused_block_decode"] - before) // 2
    want = kernels.reference_block_decode_leaves(ws, leaves)
    torch.cuda.synchronize()
    errs = [float((a.float() - b.float()).abs().max()) for a, b in zip(got, want)]
    rec = dict(
        kernel="fused_block_decode_leaves", slots=list(lead), leaves=len(shapes),
        leaf_shapes=[list(s) for s in shapes[:8]], dtype=str(dtype).split(".")[-1],
        zero_weight_slots=int((ws == 0).sum()), max_abs_err=max(errs),
        launches_per_call=launches,
        bitwise_vs_plain=all(torch.equal(a, b) for a, b in zip(got, want)),
        bitwise_rerun=all(torch.equal(a, b) for a, b in zip(got, again)),
    )
    emit("check", **rec)
    if not (rec["bitwise_vs_plain"] and rec["bitwise_rerun"]):
        raise AssertionError(f"fused_block_decode_leaves is not bitwise its plain version: {rec}")
    if launches != math.ceil(len(shapes) / kernels._library().eh_fused_block_decode_max_leaves()):
        raise AssertionError(f"{len(shapes)} leaves took {launches} launches")
    return rec


def time_round(kernels, shapes) -> dict:
    """A deep round's decode: the one multi-leaf launch, its plain version
    (s-major copies, then the slot loop), and the library yardstick, one
    cuBLAS GEMV ``g.t() @ w`` per leaf (summed), float32, [30, 3] slots."""
    ws, leaves = slot_leaves(shapes, torch.float32, seed=8)
    M, wf = ws.numel(), ws.reshape(-1)
    flat = [leaf.reshape(M, -1) for leaf in leaves]  # views, no copy
    dev, call = time_turns(dict(
        kernel=(lambda: kernels.fused_block_decode_leaves(ws, leaves), 200),
        plain=(lambda: kernels.reference_block_decode_leaves(ws, leaves), 5),
        library=(lambda: [g.t() @ wf for g in flat], 200),
    ))
    bound, by = decode_bound_ms(M, sum(g.shape[1] for g in flat))
    return dict(leaves=[g.shape[1] for g in flat], kernel_ms=dev["kernel"],
                plain_ms=dev["plain"], library_ms=dev["library"], bound_ms=bound,
                bound_by=by, call_ms=call)


def leaf_shapes(model_name) -> list:
    """Per-slot leaf shapes of a port model at the main path's width, in
    sorted-key order (the decode's leaf order)."""
    from erasurehead_tpu_torch.ops import blocks
    from erasurehead_tpu_torch.train import trainer
    from erasurehead_tpu_torch.utils.config import RunConfig

    model = trainer.build_model(RunConfig(model=model_name))
    return [tuple(leaf.shape) for leaf in blocks.tree_leaves(model.init_params(0, MAIN_SHAPE[2]))]


def decode_ops(kernels, model_name) -> dict:
    """A model's real per-slot leaves on the card, as torch.func.vmap(grad)
    returns them at the flagship [30, 3, 4400, 128] stack: each must be
    contiguous (the kernel reads them in place; the wrapper refuses any
    other), and their decode must be exactly one kernel on the device per
    call, with no copy beside it."""
    from erasurehead_tpu_torch.ops import blocks
    from erasurehead_tpu_torch.parallel import step
    from erasurehead_tpu_torch.train import trainer
    from erasurehead_tpu_torch.utils.config import RunConfig

    model = trainer.build_model(RunConfig(model=model_name))
    params = model.init_params(0, MAIN_SHAPE[2], "cuda")
    _, X, y, w = make_inputs(*MAIN_SHAPE, torch.float32, seed=300)
    lead = SLOTS
    leaves = blocks.tree_leaves(step.per_slot_grads(
        model, params, X.reshape(lead + MAIN_SHAPE[1:]), y.reshape(lead + MAIN_SHAPE[1:2]), 2))
    ws = w.reshape(lead)
    contiguous = [leaf.is_contiguous() for leaf in leaves]
    if not all(contiguous):
        raise AssertionError(f"{model_name}: non-contiguous per-slot leaves {contiguous}")
    got = kernels.fused_block_decode_leaves(ws, leaves)
    want = kernels.reference_block_decode_leaves(ws, leaves)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for a, b in zip(got, want))
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    if not bitwise:
        raise AssertionError(f"{model_name}: the decode of its real per-slot leaves is not "
                             f"bitwise its plain version (max abs err {err})")
    calls = 20
    # the profile may lose a record, or now and then a whole window (see
    # cohort_vmap_leaves): an empty window is taken again; the launch count
    # loses nothing
    for attempt in range(1, 6):
        before = kernels.LAUNCHES["fused_block_decode"]
        prof, _ = profiled(lambda: [kernels.fused_block_decode_leaves(ws, leaves)
                                    for _ in range(calls)])
        # the warm-up pass and the recorded pass
        launches = (kernels.LAUNCHES["fused_block_decode"] - before) // 2
        ops = {ev.key: ev.count for ev in device_events(prof)}
        if ops:
            break
    rec = dict(model=model_name, leaf_shapes=[list(leaf.shape) for leaf in leaves],
               contiguous=contiguous, calls=calls, launches=launches, device_ops=ops,
               profiles_taken=attempt, bitwise_vs_plain=bitwise, max_abs_err=err)
    emit("decode_ops", **rec)
    if launches != calls or len(ops) != 1 or "block_decode" not in next(iter(ops)):
        raise AssertionError(f"{model_name}: {calls} decodes ran {ops} on the device "
                             f"in {launches} launches, not one kernel a call")
    return rec


def scheme_slot_weights(cli, args) -> np.ndarray:
    """The run's [R, W * S] float32 slot weights, from the port's host
    control plane (layout, arrivals, collection rule, decode), as the trainer
    builds them."""
    from erasurehead_tpu_torch.parallel import step
    from erasurehead_tpu_torch.train import trainer

    cfg = parse_config(cli, args)
    layout = trainer.build_layout(cfg)
    sched = trainer.build_schedule(cfg, trainer.default_arrivals(cfg), layout)
    w = step.expand_slot_weights(sched.message_weights, layout.coeffs, layout.slot_is_coded)
    return w.reshape(cfg.rounds, -1).astype(np.float32)


def schemes_phase(cli, kernels, tmp, both0) -> list:
    """Each of SCHEME_RUNS through the CLI: 100 rounds on the card with the
    counts read as in ``main``, its loss falling; then 10 rounds on the card
    and on the CPU, held to each other."""
    rows = []
    for name, flags, shape in SCHEME_RUNS:
        args = flags + SCHEME_BASE
        w = scheme_slot_weights(cli, args)
        if w.shape[1] != shape[0]:
            raise AssertionError(f"{name}: {w.shape[1]} slots, want {shape[0]}")
        t0 = time.perf_counter()
        run = counted_run(cli, kernels, os.path.join(tmp, name), args,
                          {**both0, "fused_glm_grad": ROUNDS})
        short = with_rounds(args, SHORT_ROUNDS)
        gpu10 = run_main(cli, os.path.join(tmp, name + "10_cuda"), "cuda", short)
        cpu10 = run_main(cli, os.path.join(tmp, name + "10_cpu"), "cpu", short)
        rec = dict(
            run=name, args=args, launches=run["launches"], stack=list(shape),
            steps_per_sec=run["manifest"]["steps_per_sec"],
            wall_time_s=run["manifest"]["wall_time"],
            zero_weight_slot_share=float((w == 0).mean()),
            train_loss_first_last=check_falls(run),
            final_auc=float(run["arts"]["auc"][-1]),
            decode_error_mean=run["manifest"].get("decode_error_mean"),
            sim_total_time=run["manifest"]["sim_total_time"],
            **compare_runs(gpu10, cpu10),
            phase_seconds=time.perf_counter() - t0,
        )
        emit("schemes", **rec)
        rows.append(rec)
    return rows


def legacy_phase(cli, kernels, tmp, both0) -> dict:
    """The 13-positional form and the named-flag form of one run on one
    written reference layout: 10 launches each, bitwise-equal artifacts."""
    from erasurehead_tpu_torch.data import io as data_io
    from erasurehead_tpu_torch.data.synthetic import generate_gmm

    t0 = time.perf_counter()
    root = os.path.join(tmp, "legacy_data")
    layout_dir = os.path.join(root, "artificial-data", f"{LEGACY_ROWS}x{LEGACY_COLS}",
                              str(LEGACY_W))
    data_io.write_reference_layout(
        generate_gmm(LEGACY_ROWS, LEGACY_COLS, LEGACY_W, seed=0), layout_dir, LEGACY_W)
    write_s = time.perf_counter() - t0
    rounds = ["--rounds", str(SHORT_ROUNDS), "--quiet"]
    legacy_args = [str(LEGACY_W + 1), str(LEGACY_ROWS), str(LEGACY_COLS), root, "0",
                   "artificial", "1", "1", "0", "3", "4", "1", "AGD"] + rounds
    flag_args = ["--scheme", "approx", "--workers", str(LEGACY_W), "--stragglers", "1",
                 "--num-collect", "4", "--rows", str(LEGACY_ROWS), "--cols", str(LEGACY_COLS),
                 "--input-dir", root, "--add-delay", "--update-rule", "AGD"] + rounds
    want = {**both0, "fused_glm_grad": SHORT_ROUNDS}
    kw = dict(prefix="approx_acc_1", workers=LEGACY_W)
    legacy = counted_run(cli, kernels, os.path.join(tmp, "legacy_out"), legacy_args, want, **kw)
    if not os.path.exists(os.path.join(layout_dir, "1.dat.npy")):
        raise AssertionError("the legacy run did not read the written layout")
    flags = counted_run(cli, kernels, os.path.join(tmp, "flags_out"), flag_args, want, **kw)
    same = {a: legacy["arts"][a].tobytes() == flags["arts"][a].tobytes() for a in ARTIFACTS}
    same_files = all(
        open(os.path.join(tmp, "legacy_out", f"approx_acc_1_{a}.dat"), "rb").read()
        == open(os.path.join(tmp, "flags_out", f"approx_acc_1_{a}.dat"), "rb").read()
        for a in ARTIFACTS)
    rec = dict(legacy_args=legacy_args, flag_args=flag_args,
               launches=[legacy["launches"], flags["launches"]],
               artifacts_bitwise_equal=same, artifact_files_equal=same_files,
               train_loss_first_last=check_falls(legacy),
               write_layout_s=write_s, phase_seconds=time.perf_counter() - t0)
    emit("legacy", **rec)
    if not (all(same.values()) and same_files):
        raise AssertionError(f"legacy and named-flag artifacts differ: {same}")
    return rec


def write_sidecar_layout(dataset, out_dir, n_partitions) -> None:
    """A dense reference layout whose text files are empty placeholders and
    whose ``.npy`` sidecars hold what parsing the full text gives (float64),
    written after the placeholders so that data/io.load_dense_text takes its
    warm, memory-mapped path. Writing 132,000 x 128 values as text would take
    longer than the rest of the phase; the legacy phase covers the cold
    parse."""
    os.makedirs(out_dir, exist_ok=True)
    rows = dataset.n_samples // n_partitions
    files = {f"{i + 1}.dat": dataset.X_train[i * rows:(i + 1) * rows]
             for i in range(n_partitions)}
    files.update({"label.dat": dataset.y_train[:rows * n_partitions],
                  "test_data.dat": dataset.X_test, "label_test.dat": dataset.y_test})
    for fname in files:
        open(os.path.join(out_dir, fname), "w").close()
    for fname, m in files.items():
        np.save(os.path.join(out_dir, fname + ".npy"), np.asarray(m, dtype=np.float64))


def input_dir_phase(cli, kernels, tmp, both0) -> dict:
    """INPUT_DIR_RUN through ``--input-dir`` at the flagship width: the
    loaded data equals the generated data, 100 launches, and the five
    artifacts equal the schemes phase's generated-data run bitwise."""
    from erasurehead_tpu_torch.train.artifacts import run_prefix

    t0 = time.perf_counter()
    flags = {name: f for name, f, _ in SCHEME_RUNS}[INPUT_DIR_RUN]
    root = os.path.join(tmp, "input_dir_data")
    args = flags + SCHEME_BASE + ["--input-dir", root]
    cfg = parse_config(cli, args)
    path, n_parts = cli.dataset_dir(cfg), cli.n_partitions(cfg)
    generated = cli.load_dataset(dataclasses.replace(cfg, input_dir=None))
    write_sidecar_layout(generated, path, n_parts)
    write_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    loaded = cli.load_dataset(cfg)
    load_s = time.perf_counter() - t1
    fields = ("X_train", "y_train", "X_test", "y_test")
    same_data = {f: np.array_equal(np.asarray(getattr(loaded, f), np.float64),
                                   np.asarray(getattr(generated, f), np.float64))
                 for f in fields}
    del generated, loaded
    if not all(same_data.values()):
        raise AssertionError(f"the layout under --input-dir loads other data: {same_data}")
    out = os.path.join(tmp, "input_dir_out")
    run = counted_run(cli, kernels, out, args, {**both0, "fused_glm_grad": ROUNDS})
    prefix = run_prefix(cfg)
    same = {a: open(os.path.join(out, f"{prefix}_{a}.dat"), "rb").read()
            == open(os.path.join(tmp, INPUT_DIR_RUN, f"{prefix}_{a}.dat"), "rb").read()
            for a in ARTIFACTS}
    rec = dict(run=INPUT_DIR_RUN, args=args, layout=os.path.relpath(path, root),
               partitions=n_parts, launches=run["launches"], loaded_equals_generated=same_data,
               artifacts_bitwise_equal_generated=same,
               train_loss_first_last=check_falls(run),
               steps_per_sec=run["manifest"]["steps_per_sec"],
               write_sidecars_s=write_s, warm_load_s=load_s,
               phase_seconds=time.perf_counter() - t0)
    emit("input_dir", **rec)
    if not all(same.values()):
        raise AssertionError(f"--input-dir and generated-data artifacts differ: {same}")
    return rec


def time_scheme_stack(kernels, shape, w, label) -> dict:
    """B1, its plain version and its bound at a scheme's stack with one
    round's weights; on the sparsegraph stack also B1 on that round's
    nonzero-weight slots alone (what skipping zero-weight slots would leave)."""
    b, X, y, _ = make_inputs(*shape, torch.float32, seed=102)
    wt = torch.from_numpy(w).cuda()
    k = [time_ms(lambda: kernels.fused_glm_grad(b, X, y, wt, "logistic"))]
    p = [time_ms(lambda: kernels.reference_glm_grad(b, X, y, wt, "logistic"))]
    k.append(time_ms(lambda: kernels.fused_glm_grad(b, X, y, wt, "logistic")))
    p.append(time_ms(lambda: kernels.reference_glm_grad(b, X, y, wt, "logistic")))
    bound, by = glm_bound_ms(*shape, 4)
    rec = dict(kernel="fused_glm_grad", stack=label, shape=list(shape), kernel_ms=k,
               plain_ms=p, bound_ms=bound, bound_by=by,
               zero_weight_slots=int((wt == 0).sum()))
    if label == "sparsegraph":
        nz = (wt != 0).nonzero().reshape(-1)
        Xn, yn, wn = X[nz].contiguous(), y[nz].contiguous(), wt[nz].contiguous()
        nz_ms = time_ms(lambda: kernels.fused_glm_grad(b, Xn, yn, wn, "logistic"))
        rec.update(nonzero_slots=int(nz.numel()), nonzero_only_kernel_ms=nz_ms,
                   nonzero_only_bound_ms=glm_bound_ms(int(nz.numel()), *shape[1:], 4)[0],
                   zero_slot_time_share=1.0 - nz_ms / min(k))
        del Xn, yn
    emit("time", **rec)
    del X, y
    return rec


# ---------------------------------------------------------------------------
# trajectory cohorts


def cohort_leaves(shapes, dtype, seed, B, lead=SLOTS, zero_every=2):
    """Random [B, *lead] slot weights (every ``zero_every``-th of each
    trajectory 0) and leaves [B, *lead, *shape] on the card."""
    gen = torch.Generator().manual_seed(seed)
    ws = torch.randn(B, *lead, generator=gen)
    ws.view(B, -1)[:, ::zero_every] = 0.0
    leaves = [torch.randn(B, *lead, *s, generator=gen).to(dtype).cuda() for s in shapes]
    return ws.cuda(), leaves


def check_cohort_decode(kernels, ws, leaves, label) -> dict:
    """The cohort launch the step calls vs its plain version and vs B
    one-trajectory launches: bitwise, one launch per 32 leaves."""
    B, contract = ws.shape[0], "ws" if ws.dim() == 3 else "p"
    before = kernels.LAUNCHES["fused_block_decode"]
    got = kernels.fused_block_decode_cohort(ws, leaves, contract)
    launches = kernels.LAUNCHES["fused_block_decode"] - before
    want = kernels.reference_block_decode_cohort(ws, leaves, contract)
    per = [kernels.fused_block_decode_leaves(ws[b], [leaf[b] for leaf in leaves])
           for b in range(B)]
    torch.cuda.synchronize()
    rec = dict(
        kernel="fused_block_decode_cohort", case=label, B=B, slots=list(ws.shape[1:]),
        leaves=len(leaves), dtype=str(leaves[0].dtype).split(".")[-1],
        launches_per_call=launches,
        max_abs_err=max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want)),
        bitwise_vs_plain=all(torch.equal(a, b) for a, b in zip(got, want)),
        bitwise_vs_one_trajectory_launches=all(
            torch.equal(out[b], per[b][i]) for i, out in enumerate(got) for b in range(B)),
    )
    emit("cohort_check", **rec)
    if not (rec["bitwise_vs_plain"] and rec["bitwise_vs_one_trajectory_launches"]):
        raise AssertionError(f"fused_block_decode_cohort is not bitwise: {rec}")
    if launches != math.ceil(len(leaves) / kernels._library().eh_fused_block_decode_max_leaves()):
        raise AssertionError(f"{len(leaves)} leaves took {launches} launches")
    return rec


def cohort_vmap_leaves(kernels, model_name, B=4) -> dict:
    """A model's real per-slot leaves for a B-trajectory cohort on the card,
    as the step's torch.func.vmap over the params gives them at the flagship
    [30, 3, 4400, 128] stack: whether each is contiguous, the decode of the
    leaves the step hands the kernel (each made contiguous) bitwise equal to
    its plain version, and the device ops of that decode: one kernel a call,
    plus one copy per non-contiguous leaf."""
    from erasurehead_tpu_torch.ops import blocks
    from erasurehead_tpu_torch.parallel import step
    from erasurehead_tpu_torch.train import trainer
    from erasurehead_tpu_torch.utils.config import RunConfig

    model = trainer.build_model(RunConfig(model=model_name))
    params = blocks.tree_map(lambda *l: torch.stack(l), *[
        model.init_params(seed, MAIN_SHAPE[2], "cuda") for seed in range(B)])
    _, X, y, _ = make_inputs(*MAIN_SHAPE, torch.float32, seed=310)
    Xs, ys = X.reshape(SLOTS + MAIN_SHAPE[1:]), y.reshape(SLOTS + MAIN_SHAPE[1:2])
    ws, _ = cohort_leaves([], torch.float32, seed=311, B=B)
    leaves = blocks.tree_leaves(torch.func.vmap(
        lambda p: step.per_slot_grads(model, p, Xs, ys, 2))(params))
    contiguous = [leaf.is_contiguous() for leaf in leaves]
    rec = check_cohort_decode(kernels, ws, [leaf.contiguous() for leaf in leaves],
                              f"{model_name}_vmap")

    def decode():  # as the step calls it
        kernels.fused_block_decode_cohort(ws, [leaf.contiguous() for leaf in leaves], "ws")

    calls = 20
    decode()
    torch.cuda.synchronize()
    # the profile may lose a record or two of a window, and on the card a
    # whole window's records now and then (seen: none of 20 calls, after
    # the warm-up pass): a window that lost any kernel record is taken again
    for attempt in range(1, 6):
        prof, _ = profiled(lambda: [decode() for _ in range(calls)])
        ops = {ev.key: ev.count for ev in device_events(prof)}
        kernel_calls = sum(n for k, n in ops.items() if "block_decode" in k)
        copies = sum(n for k, n in ops.items() if "block_decode" not in k)
        if abs(kernel_calls - calls) <= 2:
            break
    out = dict(model=model_name, B=B, leaf_shapes=[list(leaf.shape) for leaf in leaves],
               contiguous=contiguous, calls=calls, device_ops=ops, profiles_taken=attempt,
               copies_per_call=copies / calls, bitwise_vs_plain=rec["bitwise_vs_plain"],
               max_abs_err=rec["max_abs_err"])
    emit("cohort_decode_ops", **out)
    if abs(kernel_calls - calls) > 2 or abs(copies - calls * contiguous.count(False)) > 2:
        raise AssertionError(f"{model_name}: {calls} cohort decodes ran {ops} on the device")
    return out


def cohort_configs(mode, seeds, rounds=ROUNDS) -> dict:
    """label -> RunConfig: the seven schemes x ``seeds`` at the main path's
    data, scheme-major."""
    from erasurehead_tpu_torch.utils.config import RunConfig

    return {f"{s}_seed{seed}": RunConfig(scheme=s, seed=seed, compute_mode=mode, rounds=rounds,
                                         **COHORT_BASE, **extra)
            for s, extra in COHORT_SCHEMES.items() for seed in seeds}


def planned(experiments, configs) -> tuple:
    """plan_cohorts' groups that dispatch as cohorts under batch "auto" (two
    or more), and the labels that run sequentially."""
    plan = experiments.plan_cohorts(configs)
    batched = [labels for labels, ok in plan if ok and len(labels) >= 2]
    sequential = [label for labels, ok in plan if not (ok and len(labels) >= 2)
                  for label in labels]
    return plan, batched, sequential


def counted_compare(kernels, experiments, configs, ds, want, **kw) -> dict:
    """experiments.compare on the card with every launch count and every
    harness counter set to 0 just before and read just after; the launch
    counts must be exactly ``want``."""
    experiments.reset_counters()
    kernels.reset_launches()
    t0 = time.perf_counter()
    rows = experiments.compare(configs, ds, **kw)
    out = dict(rows=rows, seconds=time.perf_counter() - t0, launches=dict(kernels.LAUNCHES),
               counters=dict(experiments.COUNTERS))
    if out["launches"] != want:
        raise AssertionError(f"compare launched {out['launches']}, want {want}")
    return out


def max_rel(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b)) / np.abs(np.asarray(b))))


def losses_fall(rows) -> dict:
    out = {r.label: [float(r.training_loss[0]), float(r.training_loss[-1])] for r in rows}
    bad = {k: v for k, v in out.items() if not v[1] < v[0]}
    if bad:
        raise AssertionError(f"training loss did not fall: {bad}")
    return out


def compare_deduped_phase(kernels, experiments, ds, both0) -> dict:
    """The 28-trajectory deduped compare as one planned cohort, held to the
    sequential seed-0 runs on the card and to the CPU for 10 rounds."""
    t0 = time.perf_counter()
    configs = cohort_configs("deduped", COHORT_SEEDS)
    plan, batched, sequential = planned(experiments, configs)
    run = counted_compare(kernels, experiments, configs, ds, both0, batch="auto")
    rows, counters = run["rows"], run["counters"]
    if (counters["cohort.dispatches"] != len(batched) or len(rows) != 28
            or counters["cohort.trajectories"] != 28 or sequential):
        raise AssertionError(f"compare_deduped planned {plan}, counted {counters}")
    seq_cfgs = {label: cfg for label, cfg in configs.items() if cfg.seed == 0}
    seq = counted_compare(kernels, experiments, seq_cfgs, ds,
                          {**both0, "fused_glm_grad": ROUNDS * len(seq_cfgs)}, batch="off")
    by_label = {r.label: r for r in rows}
    vs_seq = {r.label: max_rel(by_label[r.label].training_loss, r.training_loss)
              for r in seq["rows"]}
    # the control plane is the host's, per trajectory: the same bytes
    same_control = {r.label: by_label[r.label].timeset.tobytes() == r.timeset.tobytes()
                     and by_label[r.label].decode_error_mean == r.decode_error_mean
                     for r in seq["rows"]}
    short = cohort_configs("deduped", COHORT_SEEDS, SHORT_ROUNDS)
    gpu10 = experiments.compare(short, ds, batch="auto")
    cpu10 = experiments.compare(short, ds, batch="auto", device="cpu")
    vs_cpu = max(max_rel(g.training_loss, c.training_loss) for g, c in zip(gpu10, cpu10))
    rec = dict(
        trajectories=len(rows), plan=[[len(labels), ok] for labels, ok in plan],
        counters=counters, launches=run["launches"],
        sequential_launches=seq["launches"], sequential_counters=seq["counters"],
        cohort=rows[0].cache,
        # aggregate steps/s of the cohort (R * B / its wall clock), and the
        # sequential runs' own steps/s
        cohort_steps_per_sec=rows[0].real_steps_per_sec,
        sequential_steps_per_sec={r.label: r.real_steps_per_sec for r in seq["rows"]},
        compare_seconds=run["seconds"], sequential_compare_seconds=seq["seconds"],
        max_rel_loss_vs_sequential=vs_seq, max_rel_loss_vs_cpu_10_rounds=vs_cpu,
        control_plane_equal_sequential=same_control,
        decode_error_mean={r.label: r.decode_error_mean for r in rows if r.config.seed == 0},
        train_loss_first_last=losses_fall(rows),
        phase_seconds=time.perf_counter() - t0,
    )
    emit("compare_deduped", **rec)
    if max(vs_seq.values()) > 1e-4 or vs_cpu > 1e-4:
        raise AssertionError(f"cohort losses differ: {vs_seq}, card vs CPU {vs_cpu}")
    if not all(same_control.values()):
        raise AssertionError(f"cohort and sequential control planes differ: {same_control}")
    return rec


TRANSIENT_ROUNDS = 20
TRANSIENT_CHAOS = "raise:cohort:1:UNAVAILABLE"


def transient_phase(kernels, experiments, ds, both0) -> dict:
    """The guard's transient retry on the card: the seven deduped schemes
    (seed 0, TRANSIENT_ROUNDS rounds) as one cohort, undisturbed, then under
    ERASUREHEAD_CHAOS=TRANSIENT_CHAOS: the failed dispatch is retried once
    (one ``cohort.retry``, no ``cohort.split``) and the rows are bitwise the
    undisturbed compare's."""
    from erasurehead_tpu_torch.utils import chaos

    t0 = time.perf_counter()
    configs = cohort_configs("deduped", (0,), TRANSIENT_ROUNDS)
    clean = counted_compare(kernels, experiments, configs, ds, both0, batch="on")
    os.environ[chaos.CHAOS_ENV] = TRANSIENT_CHAOS
    chaos.reset()
    try:
        hit = counted_compare(kernels, experiments, configs, ds, both0, batch="on")
    finally:
        del os.environ[chaos.CHAOS_ENV]
        chaos.reset()
    c = hit["counters"]
    rec = dict(chaos=TRANSIENT_CHAOS, trajectories=len(hit["rows"]), counters=c,
               clean_counters=clean["counters"], launches=hit["launches"],
               rows_bitwise=rows_bitwise(hit["rows"], clean["rows"]),
               compare_seconds=hit["seconds"], clean_compare_seconds=clean["seconds"],
               seconds=time.perf_counter() - t0)
    emit("transient", **rec)
    if (c["cohort.retry"] != 1 or c["cohort.split"] != 0 or c["cohort.sequential_fallback"]
            or len(hit["rows"]) != len(configs)):
        raise AssertionError(f"the transient drill counted {c}")
    if not rec["rows_bitwise"]:
        raise AssertionError("the retried compare's rows differ from the undisturbed rows")
    return rec


def compare_faithful_phase(kernels, experiments, ds, both0) -> dict:
    """The seven schemes, seed 0, faithful: groups of two or more batch,
    singletons run sequentially through fused_glm_grad."""
    t0 = time.perf_counter()
    configs = cohort_configs("faithful", (0,))
    plan, batched, sequential = planned(experiments, configs)
    run = counted_compare(kernels, experiments, configs, ds,
                          {**both0, "fused_glm_grad": ROUNDS * len(sequential)}, batch="auto")
    counters = run["counters"]
    if (counters["cohort.dispatches"] != len(batched)
            or counters["cohort.sequential_runs"] != len(sequential)):
        raise AssertionError(f"compare_faithful planned {plan}, counted {counters}")
    rec = dict(plan=[[labels, ok] for labels, ok in plan], counters=counters,
               launches=run["launches"],
               lowering={r.label: r.cache and r.cache["cohort_lowering"] for r in run["rows"]},
               steps_per_sec={r.label: r.real_steps_per_sec for r in run["rows"]},
               train_loss_first_last=losses_fall(run["rows"]),
               compare_seconds=run["seconds"], phase_seconds=time.perf_counter() - t0)
    emit("compare_faithful", **rec)
    return rec


def straggler_sweep_phase(kernels, experiments, ds, both0) -> dict:
    """SWEEP_GRID through experiments.straggler_sweep, deduped: the JAX
    harness's labels and collect counts, one planned cohort, losses falling."""
    from erasurehead_tpu_torch.utils.config import RunConfig

    t0 = time.perf_counter()
    base = RunConfig(compute_mode="deduped", rounds=ROUNDS, **COHORT_BASE)
    experiments.reset_counters()
    kernels.reset_launches()
    rows = experiments.straggler_sweep(base, ds, SWEEP_GRID, batch="auto")
    launches, counters = dict(kernels.LAUNCHES), dict(experiments.COUNTERS)
    _, batched, _ = planned(experiments, {r.label: r.config for r in rows})
    got = [(r.label, r.config.num_collect) for r in rows]
    rec = dict(grid=SWEEP_GRID, labels_num_collect=got, launches=launches, counters=counters,
               time_to_target={r.label: r.time_to_target for r in rows},
               sim_total_time={r.label: r.sim_total_time for r in rows},
               train_loss_first_last=losses_fall(rows), phase_seconds=time.perf_counter() - t0)
    emit("straggler_sweep", **rec)
    if got != SWEEP_WANT or launches != both0 or counters["cohort.dispatches"] != len(batched):
        raise AssertionError(f"straggler_sweep: {rec}")
    return rec


def replayed_loss(res, ds) -> np.ndarray:
    from erasurehead_tpu_torch.train import evaluate, trainer

    n = res.n_train
    return evaluate.replay(trainer.build_model(res.config), res.config.model,
                           res.params_history, ds.X_train[:n], ds.y_train[:n],
                           ds.X_test, ds.y_test).training_loss


COHORT_DEEP_CPU_ROUNDS = 5


def cohort_deep_phase(cli, kernels, ds, both0) -> dict:
    """DEEP_ARGS' run at four (lr, seed) variants as one train_cohort on the
    faithful stack: one decode launch a round for the whole cohort, each
    member held to its sequential card run, COHORT_DEEP_CPU_ROUNDS rounds
    card vs CPU."""
    from erasurehead_tpu_torch.train import trainer

    t0 = time.perf_counter()
    base = parse_config(cli, DEEP_ARGS)
    cfgs = [dataclasses.replace(base, lr_schedule=lr, seed=seed) for lr, seed in DEEP_COHORT]
    kernels.reset_launches()
    res = trainer.train_cohort(cfgs, ds)
    launches = dict(kernels.LAUNCHES)
    if launches != {**both0, "fused_block_decode": ROUNDS}:
        raise AssertionError(f"cohort_deep launched {launches}")
    losses = [replayed_loss(r, ds) for r in res]
    seq = [trainer.train(c, ds) for c in cfgs]
    vs_seq = [max_rel(a, replayed_loss(s, ds)) for a, s in zip(losses, seq)]
    same_control = [all(np.asarray(getattr(a, f)).tobytes() == np.asarray(getattr(b, f)).tobytes()
                        for f in ("timeset", "worker_times", "collected", "decode_error"))
                    for a, b in zip(res, seq)]
    short = [dataclasses.replace(c, rounds=COHORT_DEEP_CPU_ROUNDS) for c in cfgs]
    gpu10 = trainer.train_cohort(short, ds)
    cpu10 = trainer.train_cohort(short, ds, device="cpu")
    vs_cpu = max(max_rel(replayed_loss(g, ds), replayed_loss(c, ds)) for g, c in zip(gpu10, cpu10))
    rec = dict(
        variants=[list(v) for v in DEEP_COHORT], stack=[*SLOTS, *MAIN_SHAPE[1:]],
        launches=launches, cohort=res[0].cohort,
        cohort_steps_per_sec=res[0].steps_per_sec,
        sequential_steps_per_sec=[s.steps_per_sec for s in seq],
        max_rel_loss_vs_sequential=vs_seq, cpu_rounds=COHORT_DEEP_CPU_ROUNDS,
        max_rel_loss_vs_cpu=vs_cpu, control_plane_equal_sequential=same_control,
        train_loss_first_last=[[float(l[0]), float(l[-1])] for l in losses],
        phase_seconds=time.perf_counter() - t0,
    )
    emit("cohort_deep", **rec)
    if max(vs_seq) > 1e-4 or vs_cpu > 1e-4:
        raise AssertionError(f"deep cohort losses differ: {vs_seq}, card vs CPU {vs_cpu}")
    if not all(l[-1] < l[0] for l in losses):
        raise AssertionError("a deep cohort member's training loss did not fall")
    if not all(same_control):
        raise AssertionError(f"deep cohort and sequential control planes differ: {same_control}")
    return rec


def time_cohort_decode(kernels, shapes, B) -> dict:
    """A deep cohort round's decode at B trajectories, float32 [B, 30, 3]
    slots: the one cohort launch, B one-trajectory launches, the library
    yardstick (one torch.bmm per leaf, never called by the port), the plain
    version (CUDA events: a host-bound Python loop) and the bound: each
    trajectory's bytes once."""
    ws, leaves = cohort_leaves(shapes, torch.float32, seed=9, B=B)
    M = ws[0].numel()
    flat = [leaf.reshape(B, M, -1) for leaf in leaves]  # views, no copy
    wrow = ws.reshape(B, 1, M)
    dev, call = time_turns(dict(
        kernel=(lambda: kernels.fused_block_decode_cohort(ws, leaves, "ws"), 200),
        per_trajectory=(lambda: [kernels.fused_block_decode_leaves(ws[b], [l[b] for l in leaves])
                                 for b in range(B)], max(20, 200 // B)),
        library=(lambda: [torch.bmm(wrow, g) for g in flat], 200),
    ))
    plain_ms = time_ms(lambda: kernels.reference_block_decode_cohort(ws, leaves, "ws"), n=2)
    D = sum(g.shape[2] for g in flat)
    nbytes = B * (M * D + M + D) * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, 2 * B * M * D / FP32_FLOPS * 1e3
    bound, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    rec = dict(B=B, leaves=[g.shape[2] for g in flat], kernel_ms=dev["kernel"],
               per_trajectory_launches_ms=dev["per_trajectory"], library_ms=dev["library"],
               plain_ms=plain_ms, bound_ms=bound, bound_by=by, bytes=nbytes, call_ms=call)
    emit("time_cohort", kernel="fused_block_decode_cohort", **rec)
    return rec


def time_cohort_glm(kernels, B=28) -> dict:
    """One deduped cohort round's gradient at B trajectories: the cohort
    matmul body the path runs (two float32 cuBLAS GEMMs) against B launches
    of fused_glm_grad at [30, 4400, 128], and the bound: X read once."""
    from erasurehead_tpu_torch.models.glm import LogisticModel
    from erasurehead_tpu_torch.parallel import step

    _, X, y, _ = make_inputs(*DEDUPED_SHAPE, torch.float32, seed=103)
    gen = torch.Generator().manual_seed(104)
    betas = (torch.randn(B, DEDUPED_SHAPE[2], generator=gen) * 0.1).cuda()
    ws = torch.rand(B, DEDUPED_SHAPE[0], generator=gen).cuda()
    grad = step.cohort_matmul_grad_fn(LogisticModel())
    dev, call = time_turns(dict(
        cohort_matmul=(lambda: grad(betas, X, y, ws), 50),
        b1_x_B=(lambda: [kernels.fused_glm_grad(betas[b], X, y, ws[b], "logistic")
                         for b in range(B)], 10),
    ))
    nbytes = X.numel() * 4 + y.numel() * 4 + (betas.numel() + ws.numel()) * 4 + betas.numel() * 4
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    rec = dict(B=B, shape=list(DEDUPED_SHAPE), cohort_matmul_ms=dev["cohort_matmul"],
               b1_x_B_ms=dev["b1_x_B"], bound_ms=bound, bound_by="bytes",
               b1_one_launch_bound_ms=glm_bound_ms(*DEDUPED_SHAPE, 4)[0], call_ms=call)
    emit("time_cohort", kernel="cohort_matmul", **rec)
    del X, y
    return rec


def sparse_args(shape_name, root, flags, rounds=ROUNDS) -> list:
    rows, cols, _, lr = SPARSE_SHAPES[shape_name]
    return with_rounds(SPARSE_BASE, rounds) + [
        "--dataset", shape_name, "--input-dir", root, "--rows", str(rows), "--cols", str(cols),
        "--lr", lr] + flags


def write_onehot_layout(root, shape_name) -> float:
    """generate_onehot at the shape, written as the reference's CSR layout
    under ``<root>/<shape_name>/30``; returns the seconds it took."""
    from erasurehead_tpu_torch.data import io, synthetic

    t0 = time.perf_counter()
    rows, cols, fields, _ = SPARSE_SHAPES[shape_name]
    ds = synthetic.generate_onehot(rows, cols, 30, n_fields=fields, seed=0)
    io.write_reference_layout(ds, os.path.join(root, shape_name, "30"), 30)
    return time.perf_counter() - t0


def stack_bytes(cli, args, ds) -> int:
    """Bytes of the run's device stack (every leaf: indices and values, the
    local codes, an int8 payload with its scales) plus its labels, built on
    the host from the run's dataset ``ds``."""
    from torch.utils import _pytree as pytree

    from erasurehead_tpu_torch.train import trainer

    cfg = parse_config(cli, args)
    X, y, _ = trainer._build_stack(cfg, ds, trainer.build_layout(cfg),
                                   cfg.compute_mode.value == "faithful", torch.device("cpu"))
    return sum(leaf.numel() * leaf.element_size() for leaf in pytree.tree_leaves(X)) + y.numel() * 4


def device_profile(run) -> tuple:
    """``run()`` under ``profiled``: the device time of its recorded pass
    (ms, every device event but the stack's upload), its loop's wall (ms)
    and its kernels by time."""
    prof, res = profiled(run)
    rows = sorted(((ev.key, device_us(ev), ev.count) for ev in device_events(prof)
                   if not ev.key.startswith("Memcpy HtoD")), key=lambda r: -r[1])
    top = [dict(name=k[:100], ms=us / 1e3, count=c) for k, us, c in rows[:6]]
    return sum(r[1] for r in rows) / 1e3, res.wall_time * 1e3, top


def rerun_and_profile(cli, args, ds, lowering, short=SHORT_ROUNDS,
                      rounds=PROFILE_ROUNDS) -> dict:
    """The run's first ``short`` rounds twice on the card through
    trainer.train on its dataset ``ds``, which must give the same bits; then
    profiles of ``rounds`` and 2 x ``rounds`` rounds: their difference is
    the device time of ``rounds`` rounds of the loop alone (a profile also
    holds the set-up: a sparse stack's scatter plans and one untimed
    gradient), and the busy share that time over the loop's wall."""
    from erasurehead_tpu_torch.train import trainer

    cfg = parse_config(cli, with_rounds(args, short))
    a, b = trainer.train(cfg, ds), trainer.train(cfg, ds)
    if a.lowering != lowering:
        raise AssertionError(f"{args}: lowering {a.lowering}, want {lowering}")
    diff = float((a.params_history - b.params_history).abs().max())
    if not torch.equal(a.params_history, b.params_history):
        # every sparse scatter here is fixed-order (sorted segment sums)
        raise AssertionError(f"{args}: two card reruns differ, max abs {diff:.3e}")
    (dev1, _, _), (dev2, wall2, top) = (
        device_profile(lambda r=r: trainer.train(dataclasses.replace(cfg, rounds=r), ds))
        for r in (rounds, 2 * rounds))
    per_round = (dev2 - dev1) / rounds if dev1 and dev2 else None
    return dict(lowering=a.lowering, rerun_max_abs_diff=diff, profile_rounds=[rounds, 2 * rounds],
                device_ms_per_round=per_round,
                device_busy_share=per_round / (wall2 / (2 * rounds)) if per_round else None,
                top=top)


def card_vs_cpu(cli, tmp, label, args, rounds) -> dict:
    short = with_rounds(args, rounds)
    gpu = run_main(cli, os.path.join(tmp, f"{label}_cuda{rounds}"), "cuda", short)
    cpu = run_main(cli, os.path.join(tmp, f"{label}_cpu{rounds}"), "cpu", short)
    return dict(short_rounds=rounds, cpu_steps_per_sec=cpu["manifest"]["steps_per_sec"],
                **compare_runs(gpu, cpu))


def sparse_phase(cli, kernels, tmp, both0) -> list:
    """The covtype-shaped layout through the CLI in every sparse lowering:
    100 rounds on the card with no kernel launch, the loss falling; the
    first rounds on the card and on the CPU (replayed losses within
    relative 1e-4, the same simulated clocks); two card reruns; a profile;
    the bound of reading the stack once."""
    out = []
    ds = cli.load_dataset(parse_config(cli, sparse_args("covtype", tmp, [])))
    for name, flags, lowering, short, prof_rounds in SPARSE_RUNS:
        t0 = time.perf_counter()
        args = sparse_args("covtype", tmp, flags)
        run = counted_run(cli, kernels, os.path.join(tmp, f"sparse_{name}"), args, both0)
        nbytes = stack_bytes(cli, args, ds)
        rec = dict(run=name, args=args, launches=run["launches"],
                   steps_per_sec=run["manifest"]["steps_per_sec"],
                   train_loss_first_last=check_falls(run),
                   final_auc=float(run["arts"]["auc"][-1]),
                   **card_vs_cpu(cli, tmp, f"sparse_{name}", args, short),
                   **rerun_and_profile(cli, args, ds, lowering, short, prof_rounds),
                   stack_bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
        rec["phase_seconds"] = time.perf_counter() - t0
        emit("sparse", **rec)
        out.append(rec)
    return out


def amazon_phase(cli, kernels, tmp, both0) -> list:
    """The amazon-shaped layout (44 fields of about 5.5k columns: every pair
    table is over the cap, so the FieldOnehot plan is all singles), padded
    and fields: SHORT_ROUNDS on the card (no launch) and on the CPU."""
    out = []
    for name, flags in (("padded", ["--sparse-format", "padded"]),
                        ("fields", ["--sparse-format", "fields"])):
        t0 = time.perf_counter()
        args = sparse_args("amazon", tmp, flags, SHORT_ROUNDS)
        gpu = counted_run(cli, kernels, os.path.join(tmp, f"amazon_{name}"), args, both0)
        cpu = run_main(cli, os.path.join(tmp, f"amazon_{name}_cpu"), "cpu", args)
        rec = dict(run=name, args=args, launches=gpu["launches"],
                   steps_per_sec=gpu["manifest"]["steps_per_sec"],
                   cpu_steps_per_sec=cpu["manifest"]["steps_per_sec"],
                   train_loss_first_last=check_falls(gpu), **compare_runs(gpu, cpu),
                   phase_seconds=time.perf_counter() - t0)
        emit("amazon_shaped", **rec)
        out.append(rec)
    return out


def int8_phase(cli, kernels, tmp, both0) -> dict:
    """MAIN_ARGS on the int8 stack: no kernel under use_pallas auto, the
    forced kernel refused; 100 rounds on the card, card vs CPU, a profile
    against the bound of the int8 payload and its scales read once."""
    t0 = time.perf_counter()
    args = MAIN_ARGS + ["--stack-dtype", "int8"]
    run = counted_run(cli, kernels, os.path.join(tmp, "int8"), args, both0)
    try:
        cli.main(args + ["--use-pallas", "on", "--device", "cpu"])
    except ValueError as e:
        refusal = str(e)
    else:
        raise AssertionError("--stack-dtype int8 --use-pallas on was not refused")
    ds = cli.load_dataset(parse_config(cli, args))
    nbytes = stack_bytes(cli, args, ds)
    rec = dict(args=args, launches=run["launches"], steps_per_sec=run["manifest"]["steps_per_sec"],
               train_loss_first_last=check_falls(run), use_pallas_on_refused=refusal,
               **card_vs_cpu(cli, tmp, "int8", args, SHORT_ROUNDS),
               **rerun_and_profile(cli, args, ds, "per_slot"),
               stack_bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
               phase_seconds=time.perf_counter() - t0)
    emit("int8", **rec)
    return rec


def dense_lowerings_phase(cli, kernels, tmp, both0) -> list:
    """MAIN_ARGS with a forced flat or margin-flat lowering: it wins over
    the kernel under use_pallas auto (no launch); card vs CPU."""
    out = []
    ds = cli.load_dataset(parse_config(cli, MAIN_ARGS))
    for name, flags, lowering in (("flat_grad", ["--flat-grad", "on"], "flat"),
                                  ("margin_flat", ["--margin-flat", "on"], "margin_flat")):
        t0 = time.perf_counter()
        args = with_rounds(MAIN_ARGS, SHORT_ROUNDS) + flags
        run = counted_run(cli, kernels, os.path.join(tmp, f"dense_{name}"), args, both0)
        rec = dict(run=name, args=args, launches=run["launches"],
                   steps_per_sec=run["manifest"]["steps_per_sec"],
                   **card_vs_cpu(cli, tmp, f"dense_{name}", args, SHORT_ROUNDS),
                   **rerun_and_profile(cli, args, ds, lowering),
                   phase_seconds=time.perf_counter() - t0)
        emit("dense_lowerings", **rec)
        out.append(rec)
    return out


def sparse_cohort_phase(cli, kernels, experiments, tmp, both0) -> dict:
    """experiments.compare over the seven cohort schemes at seed 0 on the
    covtype-shaped FieldOnehot stack, deduped: one dispatch through the
    flat_vmap lowering, no launch; each member within relative 1e-4 of its
    sequential card run, its simulated clock the same bytes."""
    from erasurehead_tpu_torch.utils.config import RunConfig

    t0 = time.perf_counter()
    rows, cols, _, lr = SPARSE_SHAPES["covtype"]
    configs = {s: RunConfig(scheme=s, seed=0, compute_mode="deduped", rounds=ROUNDS,
                            dataset="covtype", input_dir=tmp, is_real_data=True,
                            lr_schedule=float(lr), sparse_format="fields",
                            **{**COHORT_BASE, "n_rows": rows, "n_cols": cols}, **extra)
               for s, extra in COHORT_SCHEMES.items()}
    ds = cli.load_dataset(next(iter(configs.values())))
    plan, batched, sequential = planned(experiments, configs)
    run = counted_compare(kernels, experiments, configs, ds, both0, batch="auto")
    seq = counted_compare(kernels, experiments, configs, ds, both0, batch="off")
    by_label = {r.label: r for r in run["rows"]}
    lowering = {r.label: r.cache and r.cache["cohort_lowering"] for r in run["rows"]}
    vs_seq = {r.label: max_rel(by_label[r.label].training_loss, r.training_loss)
              for r in seq["rows"]}
    same_clock = {r.label: by_label[r.label].timeset.tobytes() == r.timeset.tobytes()
                  for r in seq["rows"]}
    rec = dict(plan=[[len(labels), ok] for labels, ok in plan], counters=run["counters"],
               launches=run["launches"], sequential_launches=seq["launches"], lowering=lowering,
               cohort_steps_per_sec=run["rows"][0].real_steps_per_sec,
               sequential_steps_per_sec={r.label: r.real_steps_per_sec for r in seq["rows"]},
               max_rel_loss_vs_sequential=vs_seq, control_plane_equal_sequential=same_clock,
               train_loss_first_last=losses_fall(run["rows"]),
               compare_seconds=run["seconds"], sequential_compare_seconds=seq["seconds"],
               phase_seconds=time.perf_counter() - t0)
    emit("sparse_cohort", **rec)
    if (run["counters"]["cohort.dispatches"] != 1 or len(batched) != 1 or sequential
            or set(lowering.values()) != {"flat_vmap"}):
        raise AssertionError(f"sparse_cohort planned {plan}, ran {run['counters']}, {lowering}")
    if max(vs_seq.values()) > 1e-4 or not all(same_clock.values()):
        raise AssertionError(
            f"sparse cohort members differ from their runs: {vs_seq}, {same_clock}")
    return rec


def arrivals_phase(cli, kernels, tmp, both0) -> list:
    """The main path under each of ARRIVAL_RUNS: 100 rounds on the card with
    exactly 100 fused_glm_grad launches; its simulated clocks byte-equal to
    its first 10 rounds on the CPU and to the schedule the host builds from
    trainer.default_arrivals; the arrival model changing exactly the rows it
    should against the stationary draw; replayed losses within relative
    1e-4 of the CPU run's."""
    from erasurehead_tpu_torch.train import trainer
    from erasurehead_tpu_torch.utils import chaos

    trace = os.path.join(tmp, "arrival_trace.npy")
    np.save(trace, np.random.default_rng(0).exponential(0.5, (TRACE_ROUNDS, 30)))
    out = []
    for name, regime, args, changed_want in ARRIVAL_RUNS:
        args = [trace if a == TRACE else a for a in args]
        cfg = parse_config(cli, args)
        base_cfg = dataclasses.replace(cfg, compute_time=0.0, worker_speed_spread=0.0,
                                       arrival_trace=None)
        stationary = trainer.default_arrivals(base_cfg)
        if regime:
            os.environ[chaos.REGIME_ENV] = regime
        try:
            run = counted_run(cli, kernels, os.path.join(tmp, f"arrivals_{name}"), args,
                              {**both0, "fused_glm_grad": ROUNDS})
            cpu = run_main(cli, os.path.join(tmp, f"arrivals_{name}_cpu"), "cpu",
                           with_rounds(args, SHORT_ROUNDS))
            arrivals = trainer.default_arrivals(cfg)
        finally:
            os.environ.pop(chaos.REGIME_ENV, None)
        sched = trainer.build_schedule(cfg, arrivals, trainer.build_layout(cfg))
        g, c = run["arts"], cpu["arts"]
        same_cpu = all(g[a][:SHORT_ROUNDS].tobytes() == c[a].tobytes()
                       for a in ("timeset", "worker_timeset"))
        same_host = (g["timeset"].tobytes() == np.asarray(sched.sim_time, np.float64).tobytes()
                     and g["worker_timeset"].tobytes()
                     == np.asarray(sched.worker_times, np.float64).tobytes())
        changed = int((arrivals != stationary).any(axis=1).sum())
        rel = float(max_rel(g["training_loss"][:SHORT_ROUNDS], c["training_loss"]))
        rec = dict(run=name, regime=regime, args=args, launches=run["launches"],
                   steps_per_sec=run["manifest"]["steps_per_sec"],
                   sim_total_time=run["manifest"]["sim_total_time"],
                   rounds_changed_by_the_model=changed, clocks_equal_cpu=same_cpu,
                   clocks_equal_host_schedule=same_host, max_rel_loss_diff_vs_cpu=rel,
                   train_loss_first_last=check_falls(run))
        emit("arrivals", **rec)
        if not (same_cpu and same_host) or changed != changed_want or rel > 1e-4:
            raise AssertionError(f"arrivals {name}: {rec}")
        out.append(rec)
    return out


def attention_phase(cli, kernels, tmp, both0) -> dict:
    """ATTN_ARGS through the CLI: 100 rounds on the card with exactly 100
    decode launches and none of the GLM kernel, the loss falling; its first
    ATTN_SHORT_ROUNDS rounds on the card and on the CPU within relative
    1e-4; the same rounds with --block-decode treewise bitwise equal on the
    card; then a
    4-trajectory cohort (ATTN_COHORT, ATTN_COHORT_ROUNDS rounds) in one
    dispatch and ATTN_COHORT_ROUNDS decode launches, each member's replayed
    loss within relative 1e-6 of its sequential card run."""
    from erasurehead_tpu_torch.train import trainer

    run = counted_run(cli, kernels, os.path.join(tmp, "attention"), ATTN_ARGS,
                      {**both0, "fused_block_decode": ROUNDS})
    short = with_rounds(ATTN_ARGS, ATTN_SHORT_ROUNDS)
    gpu10 = run_main(cli, os.path.join(tmp, "attention10_cuda"), "cuda", short)
    cpu10 = run_main(cli, os.path.join(tmp, "attention10_cpu"), "cpu", short)
    treewise = short[:short.index("fused")] + ["treewise"]
    tree10 = counted_run(cli, kernels, os.path.join(tmp, "attention10_treewise"), treewise,
                         {**both0, "fused_block_decode": ATTN_SHORT_ROUNDS})
    same = {a: tree10["arts"][a].tobytes() == gpu10["arts"][a].tobytes() for a in ARTIFACTS}
    if not all(same.values()):
        raise AssertionError(f"attention treewise vs fused artifacts differ on the card: {same}")
    rec = dict(args=ATTN_ARGS, launches=run["launches"],
               steps_per_sec=run["manifest"]["steps_per_sec"],
               wall_time_s=run["manifest"]["wall_time"],
               train_loss_first_last=check_falls(run), final_auc=float(run["arts"]["auc"][-1]),
               short_rounds=ATTN_SHORT_ROUNDS, cpu_steps_per_sec=cpu10["manifest"]["steps_per_sec"],
               **compare_runs(gpu10, cpu10), treewise_launches=tree10["launches"],
               treewise_artifacts_bitwise_equal_fused=same)

    t0 = time.perf_counter()
    base = parse_config(cli, with_rounds(ATTN_ARGS, ATTN_COHORT_ROUNDS))
    ds = cli.load_dataset(base)
    cfgs = [dataclasses.replace(base, lr_schedule=lr, seed=seed) for lr, seed in ATTN_COHORT]
    if not all(trainer.cohort_eligible(c) for c in cfgs):
        raise AssertionError("the attention cohort is not cohort-eligible")
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    res = trainer.train_cohort(cfgs, ds)
    cohort_launches = dict(kernels.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = [replayed_loss(r, ds) for r in res]
    seq = [trainer.train(c, ds) for c in cfgs]
    vs_seq = [max_rel(a, replayed_loss(s, ds)) for a, s in zip(losses, seq)]
    rec["cohort"] = dict(
        variants=[list(v) for v in ATTN_COHORT], launches=cohort_launches,
        dispatch=res[0].cohort, cohort_steps_per_sec=res[0].steps_per_sec,
        peak_allocated_gib=peak_gib,
        sequential_steps_per_sec=[r.steps_per_sec for r in seq],
        max_rel_loss_vs_sequential=vs_seq,
        train_loss_first_last=[[float(l[0]), float(l[-1])] for l in losses],
        phase_seconds=time.perf_counter() - t0,
    )
    emit("attention", **rec)
    rec["run"] = run
    if cohort_launches != {**both0, "fused_block_decode": ATTN_COHORT_ROUNDS}:
        raise AssertionError(f"the attention cohort launched {cohort_launches}")
    if res[0].cohort["cohort_dispatches"] != 1 or res[0].lowering != "layer_block_vmap":
        raise AssertionError(f"the attention cohort's dispatch: {res[0].cohort}")
    if max(vs_seq) > 1e-6:
        raise AssertionError(f"attention cohort members differ from sequential runs: {vs_seq}")
    return rec


def resumed_window(cli, kernels, out_dir, args, want, start, full) -> dict:
    """A resumed CLI run (``args`` carries --resume) on the card: its launch
    counts exactly ``want``, its manifest's start round ``start``, its five
    artifacts bitwise rows [start, 100) of the uninterrupted run ``full``.
    Returns the run with what it wrote to stderr (the fallback warnings)."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        run = counted_run(cli, kernels, out_dir, args, want, start=start)
    same = {a: run["arts"][a].tobytes() == full["arts"][a][start:].tobytes() for a in ARTIFACTS}
    if run["manifest"]["start_round"] != start or not all(same.values()):
        raise AssertionError(f"resume from round {start}: start_round "
                             f"{run['manifest']['start_round']}, artifacts equal {same}")
    run["stderr"] = err.getvalue()
    return run


def checkpoint_phase(cli, kernels, tmp, both0, main_run, attn_run) -> dict:
    """The main path saving every CKPT_EVERY rounds: artifacts bitwise the
    uninterrupted card run's (``main_run``) and round_25/50/75 on disk;
    then round_75's commit marker deleted and round_50's state file cut in
    half, so a resume (saving again every 25) falls back to round_25 with a
    warning and runs 75 rounds, rows 25-99 bitwise; one more resume from the
    round_75 it wrote runs 25 rounds, rows 75-99 bitwise. Then the attention
    run (``attn_run``) saving every 50 rounds and resumed once, bitwise. The
    time of one save of the main path's state, and steps/s with and without
    checkpointing (the clock leaves the saves out)."""
    from erasurehead_tpu_torch.train import checkpoint, optimizer

    b1 = lambda n: {**both0, "fused_glm_grad": n}  # noqa: E731
    b2 = lambda n: {**both0, "fused_block_decode": n}  # noqa: E731
    d = os.path.join(tmp, "ckpt_main")
    every = ["--checkpoint-dir", d, "--checkpoint-every", str(CKPT_EVERY)]
    t0 = time.perf_counter()
    saved = counted_run(cli, kernels, os.path.join(tmp, "ckpt_saved"), MAIN_ARGS + every,
                        b1(ROUNDS))
    saved_wall = time.perf_counter() - t0
    rounds_on_disk = sorted(os.listdir(d))
    same = {a: saved["arts"][a].tobytes() == main_run["arts"][a].tobytes() for a in ARTIFACTS}
    if rounds_on_disk != ["round_25", "round_50", "round_75"] or not all(same.values()):
        raise AssertionError(f"checkpointed run: {rounds_on_disk}, artifacts equal {same}")
    # the main path's AGD state ([128] params and momentum), restored on the card
    template = optimizer.init_state(torch.zeros(MAIN_SHAPE[2], device="cuda"), "AGD")
    state, next_round = checkpoint.restore(os.path.join(d, "round_25"), template)
    if next_round != 25 or state.params.device.type != "cuda":
        raise AssertionError(f"round_25 restored as round {next_round} on {state.params.device}")
    save_s = []
    for i in range(5):
        t1 = time.perf_counter()
        checkpoint.save(os.path.join(tmp, "ckpt_timing", f"round_{i}"), state, 25)
        save_s.append(time.perf_counter() - t1)

    os.remove(os.path.join(d, "round_75", checkpoint.COMMIT_MARKER))
    torn = os.path.join(d, "round_50", checkpoint.STATE_NAME)
    with open(torn, "r+b") as f:
        f.truncate(os.path.getsize(torn) // 2)
    fell_back = resumed_window(cli, kernels, os.path.join(tmp, "ckpt_resumed"),
                               MAIN_ARGS + every + ["--resume"], b1(ROUNDS - 25), 25, main_run)
    warned = [r for r in ("round_75", "round_50") if r in fell_back["stderr"]]
    if warned != ["round_75", "round_50"]:
        raise AssertionError(f"no fallback warning for {warned}: {fell_back['stderr']!r}")
    again = resumed_window(cli, kernels, os.path.join(tmp, "ckpt_resumed75"),
                           MAIN_ARGS + ["--checkpoint-dir", d, "--resume"], b1(ROUNDS - 75), 75,
                           main_run)

    da = os.path.join(tmp, "ckpt_attention")
    attn_every = ["--checkpoint-dir", da, "--checkpoint-every", str(ATTN_CKPT_EVERY)]
    attn_saved = counted_run(cli, kernels, os.path.join(tmp, "ckpt_attention_saved"),
                             ATTN_ARGS + attn_every, b2(ROUNDS))
    same_attn = {a: attn_saved["arts"][a].tobytes() == attn_run["arts"][a].tobytes()
                 for a in ARTIFACTS}
    if not all(same_attn.values()):
        raise AssertionError(f"checkpointed attention run differs: {same_attn}")
    attn_resumed = resumed_window(cli, kernels, os.path.join(tmp, "ckpt_attention_resumed"),
                                  ATTN_ARGS + ["--checkpoint-dir", da, "--resume"],
                                  b2(ROUNDS - ATTN_CKPT_EVERY), ATTN_CKPT_EVERY, attn_run)
    rec = dict(
        every=CKPT_EVERY, rounds_on_disk=rounds_on_disk,
        launches={"saved": saved["launches"], "fell_back": fell_back["launches"],
                  "resumed_75": again["launches"], "attention_saved": attn_saved["launches"],
                  "attention_resumed": attn_resumed["launches"]},
        fallback_warnings=fell_back["stderr"].strip().splitlines(),
        save_seconds=save_s, state_file_bytes=os.path.getsize(
            os.path.join(tmp, "ckpt_timing", "round_0", checkpoint.STATE_NAME)),
        steps_per_sec={"without": main_run["manifest"]["steps_per_sec"],
                       "with": saved["manifest"]["steps_per_sec"],
                       "resumed_from_25": fell_back["manifest"]["steps_per_sec"],
                       "attention_without": attn_run["manifest"]["steps_per_sec"],
                       "attention_with": attn_saved["manifest"]["steps_per_sec"]},
        checkpointed_cli_wall_s=saved_wall,
        artifacts_bitwise={"saved": same, "attention_saved": same_attn},
    )
    emit("checkpoint", **rec)
    return rec


# ---------------------------------------------------------------------------
# the sweep runner (the data cache, the journal) and pipelined tau=1 training


def rows_bitwise(a, b) -> bool:
    return all(x.label == y.label and x.training_loss.tobytes() == y.training_loss.tobytes()
               and x.timeset.tobytes() == y.timeset.tobytes() for x, y in zip(a, b))


def data_cache_phase(kernels, experiments, ds, both0) -> dict:
    """The seven reference schemes faithful at the flagship data through
    compare(batch="off"): seven sequential B1 runs (700 launches) a pass,
    from an empty cache. Data hits and misses as the layouts' stacking
    signatures predict on the host; a second pass all hits, its rows bitwise
    the first's; a third with the cache off, the same rows. Before that, one
    run missed and then hit: its set-up and round-loop seconds and the bytes
    reused."""
    from erasurehead_tpu_torch.train import cache, trainer

    t_phase = time.perf_counter()
    configs = cohort_configs("faithful", (0,))
    sigs = [trainer._stack_signature(c, trainer.build_layout(c)) for c in configs.values()]
    want_misses = len(set(sigs))
    cache.clear()
    kernels.reset_launches()
    cfg = configs["approx_seed0"]
    miss, hit = trainer.train(cfg, ds), trainer.train(cfg, ds)
    one_run_launches = dict(kernels.LAUNCHES)
    if (miss.cache_info["data_hit"], hit.cache_info["data_hit"]) != (False, True) \
            or hit.cache_info["bytes_reused"] != miss.cache_info["stack_bytes"] \
            or one_run_launches != {**both0, "fused_glm_grad": 2 * ROUNDS} \
            or not torch.equal(miss.params_history, hit.params_history):
        raise AssertionError(f"a miss then a hit: {miss.cache_info}, {hit.cache_info}, "
                             f"{one_run_launches}")
    per_run = {k: dict(setup_s=r.cache_info["setup_seconds"], round_loop_s=r.wall_time,
                       steps_per_sec=r.steps_per_sec, bytes_reused=r.cache_info["bytes_reused"],
                       stack_bytes=r.cache_info["stack_bytes"]) for k, r in (("miss", miss),
                                                                             ("hit", hit))}
    cache.clear()
    passes, rows = {}, {}
    try:
        for name, on in (("first", True), ("again", True), ("off", False)):
            cache.set_enabled(on)
            before = cache.stats().snapshot()
            run = counted_compare(kernels, experiments, configs, ds,
                                  {**both0, "fused_glm_grad": ROUNDS * len(configs)}, batch="off")
            after = cache.stats().snapshot()
            rows[name] = run["rows"]
            passes[name] = dict(compare_seconds=run["seconds"], launches=run["launches"],
                                **{k: after[k] - before[k] for k in after})
    finally:
        cache.set_enabled(True)
    want = {"first": (len(configs) - want_misses, want_misses), "again": (len(configs), 0),
            "off": (0, 0)}
    got = {k: (p["data_hits"], p["data_misses"]) for k, p in passes.items()}
    same = {k: rows_bitwise(rows["first"], rows[k]) for k in ("again", "off")}
    rec = dict(schemes=list(configs), predicted_hits_misses=want, hits_misses=got,
               distinct_stacks=want_misses, one_run=per_run, passes=passes,
               rows_bitwise_first=same, phase_seconds=time.perf_counter() - t_phase)
    emit("data_cache", **rec)
    if got != want or not all(same.values()):
        raise AssertionError(f"data cache: hits/misses {got}, want {want}; rows equal {same}")
    rec["launches"] = {"one_run": one_run_launches,
                       **{k: p["launches"] for k, p in passes.items()}}
    return rec


def sweep_cli(args, env=None) -> subprocess.CompletedProcess:
    """``python -m erasurehead_tpu_torch.cli sweep`` in a subprocess of this
    checkout, ``env`` over this process's environment."""
    full = {k: v for k, v in os.environ.items() if k != "ERASUREHEAD_CHAOS"}
    full.update(env or {})
    return subprocess.run(
        [sys.executable, "-m", "erasurehead_tpu_torch.cli", "sweep"] + args, cwd=HERE,
        env=full, capture_output=True, text=True, timeout=600,
    )


def science(path) -> list:
    from erasurehead_tpu_torch.train import journal

    with open(path) as f:
        return [journal.science_row(r) for r in json.load(f)]


def journal_phase(kernels, experiments, ds, tmp, both0) -> dict:
    """Three drills. (1) ERASUREHEAD_CHAOS=raise:trajectory:2 on the
    seven-scheme deduped compare under batch off, auto and on, resumed from
    its journal and held to the uninterrupted rows: bitwise under "off" (the
    script fails otherwise), the largest difference reported for the
    cohorts. (2) A real kill: ``cli sweep --rounds 30`` under
    kill:trajectory:3 exits 43; ``--resume-sweep`` finishes the suite with
    the science rows of an uninterrupted in-process run. (3) A third resume over the complete journal trains
    nothing: no launch of either kernel. The in-process uninterrupted suite
    runs twice: the two must be bitwise equal (the MLP on the covtype-shaped
    PaddedRows stand-in included, whose gather's gradient is a sorted segment
    sum, not atomics)."""
    from erasurehead_tpu_torch.obs import events
    from erasurehead_tpu_torch.obs.metrics import REGISTRY
    from erasurehead_tpu_torch.train import journal
    from erasurehead_tpu_torch.utils import chaos

    out, launches = {}, {}
    configs = cohort_configs("deduped", (0,))
    for batch in ("off", "auto", "on"):
        t0 = time.perf_counter()
        kernels.reset_launches()
        base = experiments.compare(configs, ds, batch=batch)
        jdir = os.path.join(tmp, f"journal_{batch}")
        os.environ[chaos.CHAOS_ENV] = "raise:trajectory:2"
        chaos.reset()
        j = journal.SweepJournal(jdir)
        try:
            experiments.compare(configs, ds, batch=batch, journal=j)
            raise AssertionError("the chaos spec did not fire")
        except chaos.ChaosInjection:
            pass
        finally:
            j.close()
            del os.environ[chaos.CHAOS_ENV]
            chaos.reset()
        j2 = journal.SweepJournal(jdir, resume=True)
        recorded = len(j2)
        resumed = experiments.compare(configs, ds, batch=batch, journal=j2)
        j2.close()
        launches[f"drill1_{batch}"] = dict(kernels.LAUNCHES)
        diff = max(float(np.max(np.abs(a.training_loss - b.training_loss)))
                   for a, b in zip(base, resumed))
        out[batch] = dict(
            recorded_before_fault=recorded, bitwise=rows_bitwise(base, resumed),
            science_rows_equal=[journal.science_row(s.row()) for s in base]
            == [journal.science_row(s.row()) for s in resumed],
            max_abs_loss_diff=diff, max_rel_loss_diff=max(
                max_rel(b.training_loss, a.training_loss) for a, b in zip(base, resumed)),
            journal_errors=events.validate_file(j2.path), launches=launches[f"drill1_{batch}"],
            wall_s=time.perf_counter() - t0)
        if recorded != 2 or out[batch]["journal_errors"]:
            raise AssertionError(f"journal drill ({batch}): {out[batch]}")
        if batch == "off" and not (out[batch]["bitwise"] and out[batch]["science_rows_equal"]):
            raise AssertionError(f"the sequential resume is not bitwise: {out[batch]}")
    # the uninterrupted seven, the two before the fault, the five resumed
    want_off = {**both0, "fused_glm_grad": ROUNDS * 2 * len(configs)}
    if launches["drill1_off"] != want_off:
        raise AssertionError(f"drill 1 off launched {launches['drill1_off']}, want {want_off}")

    # (2) a real kill in a subprocess, then --resume-sweep
    jdir, killed_out = os.path.join(tmp, "suite_journal"), os.path.join(tmp, "suite_a.json")
    args = ["--rounds", str(SWEEP_ROUNDS), "--sweep-journal", jdir, "--out", killed_out]
    t0 = time.perf_counter()
    killed = sweep_cli(args, {"ERASUREHEAD_CHAOS": "kill:trajectory:3"})
    kill_s = time.perf_counter() - t0
    journaled = len(journal.SweepJournal(jdir, resume=True))
    if killed.returncode != chaos.KILL_EXIT or os.path.exists(killed_out) or journaled != 3:
        raise AssertionError(f"the killed sweep exited {killed.returncode} with {journaled} "
                             f"rows journaled: {killed.stderr[-2000:]}")
    t0 = time.perf_counter()
    finished = sweep_cli(args + ["--resume-sweep"])
    resume_s = time.perf_counter() - t0
    if finished.returncode != 0:
        raise AssertionError(f"--resume-sweep failed: {finished.stderr[-2000:]}")
    kernels.reset_launches()
    t0 = time.perf_counter()
    whole = [s for rows in experiments.baseline_suite(rounds=SWEEP_ROUNDS).values() for s in rows]
    whole_s = time.perf_counter() - t0
    launches["suite"] = dict(kernels.LAUNCHES)
    rerun = [s for rows in experiments.baseline_suite(rounds=SWEEP_ROUNDS).values() for s in rows]
    rerun_bitwise = rows_bitwise(whole, rerun)
    whole_out = os.path.join(tmp, "suite_u.json")
    experiments.save_summaries(whole, whole_out)
    suite_rows = science(whole_out)
    if science(killed_out) != suite_rows:
        raise AssertionError("the resumed suite's science rows differ from an uninterrupted run's")

    # (3) a resume over the complete journal trains nothing
    kernels.reset_launches()
    resumed_before = REGISTRY.counter("sweep_journal.resumed").value
    again_out = os.path.join(tmp, "suite_c.json")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        experiments.main(args[:-1] + [again_out, "--resume-sweep"])
    again_s = time.perf_counter() - t0
    launches["full_resume"] = dict(kernels.LAUNCHES)
    rehydrated = REGISTRY.counter("sweep_journal.resumed").value - resumed_before
    journal_path = os.path.join(jdir, journal.JOURNAL_NAME)
    rec = dict(
        drill1=out, kill_exit=killed.returncode, journaled_before_kill=journaled,
        resumed_science_rows_equal=True, suite_rows=suite_rows,
        suite_rerun_bitwise=rerun_bitwise, full_resume_launches=launches["full_resume"],
        full_resume_rehydrated=rehydrated, journal_errors=events.validate_file(journal_path),
        wall_s={"kill": kill_s, "resume": resume_s, "uninterrupted": whole_s,
                "full_resume": again_s},
    )
    emit("journal", **rec)
    if launches["full_resume"] != both0 or rehydrated != len(suite_rows) \
            or science(again_out) != suite_rows or rec["journal_errors"]:
        raise AssertionError(f"the full resume trained or differs: {launches['full_resume']}, "
                             f"{rehydrated} rehydrated, {rec['journal_errors']}")
    if not rerun_bitwise:
        raise AssertionError("two card runs of the suite differ (a row is not deterministic)")
    rec["launches"] = launches
    return rec


def pipeline_phase(cli, kernels, tmp, both0) -> dict:
    """The main path pipelined (``--pipeline-depth 1 --update-rule GD``):
    100 B1 launches; its schedule byte-equal to pipelined_schedule on the
    host and, on the shared rounds, to a 10-round CPU run's; losses within
    relative 1e-4 of the CPU's; the loss falls; the depth-0 run is bitwise
    the run without the flag and parts from the pipelined one after round
    0. Then deepmlp layer-coded pipelined: 20 B2 launches, card vs CPU
    within 1e-4. The refusals of cyccoded, AGD and --checkpoint-dir."""
    from erasurehead_tpu_torch.parallel import pipeline
    from erasurehead_tpu_torch.train import trainer
    from erasurehead_tpu_torch.utils.config import PipelineRefusal

    def run(args, device, name):
        cfg = parse_config(cli, args)
        kernels.reset_launches()
        res, ev, _ = cli.run(cfg, output_dir=os.path.join(tmp, name), quiet=True, device=device)
        return dict(res=res, loss=np.asarray(ev.training_loss), launches=dict(kernels.LAUNCHES))

    fields = ("dispatch", "done", "dispatch_ahead", "staleness", "sim_time", "message_weights",
              "worker_times", "collected")
    gpu = run(PIPE_ARGS, "cuda", "pipe_cuda")
    cpu = run(with_rounds(PIPE_ARGS, SHORT_ROUNDS), "cpu", "pipe_cpu")
    cfg = gpu["res"].config
    host = pipeline.pipelined_schedule(cfg, trainer.default_arrivals(cfg), trainer.build_layout(cfg))
    sched = gpu["res"].schedule
    same_host = {f: getattr(sched, f).tobytes() == getattr(host, f).tobytes() for f in fields}
    same_cpu = {f: getattr(sched, f)[:SHORT_ROUNDS].tobytes()
                == getattr(cpu["res"].schedule, f).tobytes() for f in fields}
    rel = max_rel(gpu["loss"][:SHORT_ROUNDS], cpu["loss"])
    sync_args = PIPE_ARGS[:PIPE_ARGS.index("--pipeline-depth")]
    sync = run(sync_args, "cuda", "sync_cuda")
    sync0 = run(sync_args + ["--pipeline-depth", "0"], "cuda", "sync0_cuda")
    depth0_bitwise = torch.equal(sync["res"].params_history, sync0["res"].params_history)
    parts = [int(i) for i in np.flatnonzero(np.any(
        (sync["res"].params_history != gpu["res"].params_history).cpu().numpy(), axis=1))]
    b1 = {**both0, "fused_glm_grad": ROUNDS}
    deep = run(DEEP_PIPE_ARGS, "cuda", "pipe_deep_cuda")
    deep_cpu = run(with_rounds(DEEP_PIPE_ARGS, SHORT_ROUNDS), "cpu", "pipe_deep_cpu")
    deep_rel = max_rel(deep["loss"][:SHORT_ROUNDS], deep_cpu["loss"])
    refusals = {}
    for name, extra in (("cyccoded", ["--scheme", "cyccoded"]),
                        ("AGD", ["--update-rule", "AGD"]),
                        ("checkpoint_dir", ["--checkpoint-dir", os.path.join(tmp, "pipe_ck"),
                                            "--checkpoint-every", "10"])):
        try:
            cli.main(with_rounds(PIPE_ARGS, 2) + extra + ["--device", "cuda",
                                                           "--output-dir", tmp])
            raise AssertionError(f"--pipeline-depth 1 with {extra} was not refused")
        except PipelineRefusal as e:
            refusals[name] = dict(reason=e.reason, message=str(e))
    rec = dict(
        args=PIPE_ARGS, launches=gpu["launches"], steps_per_sec=gpu["res"].steps_per_sec,
        sync_steps_per_sec=sync["res"].steps_per_sec,
        sim_total_time=gpu["res"].sim_total_time, sync_sim_total_time=sync["res"].sim_total_time,
        overlap=pipeline.overlap_summary(sched), schedule_equal_host=same_host,
        schedule_equal_cpu_10_rounds=same_cpu, max_rel_loss_vs_cpu_10_rounds=rel,
        train_loss_first_last=[float(gpu["loss"][0]), float(gpu["loss"][-1])],
        sync_train_loss_first_last=[float(sync["loss"][0]), float(sync["loss"][-1])],
        depth0_bitwise_plain=depth0_bitwise, rounds_differing_from_sync=len(parts),
        first_round_differing=parts[0] if parts else None,
        sync_launches=[sync["launches"], sync0["launches"]],
        deep=dict(args=DEEP_PIPE_ARGS, launches=deep["launches"],
                  steps_per_sec=deep["res"].steps_per_sec, max_rel_loss_vs_cpu_10_rounds=deep_rel,
                  train_loss_first_last=[float(deep["loss"][0]), float(deep["loss"][-1])]),
        refusals=refusals,
    )
    emit("pipeline", **rec)
    if gpu["launches"] != b1 or sync["launches"] != b1 or sync0["launches"] != b1:
        raise AssertionError(f"pipelined/sync launches {gpu['launches']}, {sync['launches']}")
    if not (all(same_host.values()) and all(same_cpu.values())):
        raise AssertionError(f"pipelined schedule differs: host {same_host}, cpu {same_cpu}")
    if rel > 1e-4 or deep_rel > 1e-4:
        raise AssertionError(f"card vs CPU: GLM {rel}, deep {deep_rel}")
    if not depth0_bitwise or not parts or parts[0] != 1:
        raise AssertionError(f"depth 0 bitwise {depth0_bitwise}; rounds differing {parts[:3]}")
    if not gpu["loss"][-1] < gpu["loss"][0] or not deep["loss"][-1] < deep["loss"][0]:
        raise AssertionError("the pipelined loss did not fall")
    if deep["launches"] != {**both0, "fused_block_decode": LAYER_ROUNDS}:
        raise AssertionError(f"pipelined deep run launched {deep['launches']}")
    want_reasons = {"cyccoded": "exact_decode", "AGD": "momentum_unproven",
                    "checkpoint_dir": "checkpoint_restart"}
    if {k: v["reason"] for k, v in refusals.items()} != want_reasons:
        raise AssertionError(f"refusals {refusals}")
    rec["launches_by_run"] = {"pipelined": gpu["launches"], "sync": sync["launches"],
                              "sync_depth0": sync0["launches"], "deep": deep["launches"]}
    return rec


# the streamed phase: the main path out of a shard store
STREAM_ARGS = MAIN_ARGS + ["--stack-residency", "streamed"]
# approx's layout puts each partition on one group of s+1 = 3 workers, so a
# window is window-uniform only in multiples of 3 dividing 30: 6 gives 5
# slot-groups of 6 workers, halo 0, B1 at [18, 4400, 128]
STREAM_WINDOW = 6
STREAM_SHAPE = (18, 4400, 128)
# cyccoded's cyclic supports {w..w+2}: window 10 gives 3 slot-groups of 10
# workers with a halo of 2 (the last span wraps), B1 at [30, 4400, 128]
HALO_ARGS = STREAM_ARGS[:1] + ["cyccoded"] + STREAM_ARGS[2:STREAM_ARGS.index("--num-collect")] \
    + STREAM_ARGS[STREAM_ARGS.index("--num-collect") + 2:] + ["--stream-window", "10"]
HALO_SHAPE = (30, 4400, 128)
# the same windows under the ring transport (--stack-mode ring, or auto on
# this redundant layout): each stages its 12 partitions (window and halo)
# partition-major, and every round the ring fill rebuilds the slot-group's
# [30, 4400, 128] slots from them, B1 on those
RING_STAGED = (12, 4400, 128)
BIG_ROWS = 16 * 132000  # the 16x store: 2,112,000 x 128 float32, about 1.08 GB
BIG_SHAPE = (3, BIG_ROWS // 30, 128)  # a 3-partition deduped window
INT8_STORE_ROWS = 13200  # the prepare --store int8 run (W = 30, 440 rows a partition)


def stream_bound(res, slot_bytes=0) -> dict:
    """A streamed run's peak device bytes over its loop, in windows, against
    the prefetcher's bound (depth + 2 windows) plus ``slot_bytes``, what a
    round holds beside its windows (a ring window's rebuilt slots)."""
    from erasurehead_tpu_torch.data.prefetch import DEFAULT_DEPTH

    ci = res.cache_info
    peak_windows = ci["device_peak_bytes"] / ci["stack_bytes"]
    bound = DEFAULT_DEPTH + 2
    bound_bytes = bound * ci["stack_bytes"] + slot_bytes
    if ci["device_peak_bytes"] > bound_bytes:
        raise AssertionError(f"streamed loop peaked at {peak_windows} windows > {bound} "
                             f"and {slot_bytes} bytes of slots")
    return dict(peak_bytes=ci["device_peak_bytes"], window_bytes=ci["stack_bytes"],
                peak_windows=peak_windows, bound_windows=bound, slot_bytes=slot_bytes,
                bound_bytes=bound_bytes)


def windowed_runs(cli, kernels, tmp, args, shape, halo, want, slot_bytes=0) -> tuple:
    """A windowed streamed CLI run twice on the card and once on the CPU:
    ``want`` launches each on the card, windows of ``shape`` with ``halo``,
    reruns bitwise, the loss falling, clocks byte-equal to the CPU run's and
    the first 10 rounds' replayed loss within relative 1e-4 of it, the
    loop's peak device bytes within the prefetcher's bound."""
    runs = []
    for device in ("cuda", "cuda", "cpu"):
        kernels.reset_launches()
        res, ev, _ = cli.run(parse_config(cli, args), quiet=True, device=device,
                             output_dir=os.path.join(tmp, "win_" + device))
        runs.append(dict(res=res, loss=np.asarray(ev.training_loss),
                         launches=dict(kernels.LAUNCHES)))
    a, b, cpu = runs
    ci = a["res"].cache_info
    if a["launches"] != want or b["launches"] != want:
        raise AssertionError(f"windowed runs launched {a['launches']}, {b['launches']}")
    if ci["stack_bytes"] != shape[0] * shape[1] * (shape[2] + 1) * 4 or ci["stream_halo"] != halo:
        raise AssertionError(f"window of {ci['stack_bytes']} bytes, halo {ci['stream_halo']}: "
                             f"not {shape} with halo {halo}")
    bitwise = torch.equal(a["res"].params_history, b["res"].params_history)
    clocks = (a["res"].timeset.tobytes() == cpu["res"].timeset.tobytes()
              and a["res"].worker_times.tobytes() == cpu["res"].worker_times.tobytes())
    rel10 = max_rel(a["loss"][:SHORT_ROUNDS], cpu["loss"][:SHORT_ROUNDS])
    if not bitwise or not clocks or rel10 > 1e-4 or not a["loss"][-1] < a["loss"][0]:
        raise AssertionError(f"windowed {args}: bitwise {bitwise}, clocks {clocks}, "
                             f"rel {rel10}, loss {a['loss'][0]} -> {a['loss'][-1]}")
    rec = dict(
        args=args, launches=a["launches"], rerun_launches=b["launches"],
        window_shape=list(shape), lowering=a["res"].lowering, reruns_bitwise=bitwise,
        clocks_equal_cpu=clocks, max_rel_loss_vs_cpu_10_rounds=rel10,
        max_rel_loss_vs_cpu_100_rounds=max_rel(a["loss"], cpu["loss"]),
        train_loss_first_last=[float(a["loss"][0]), float(a["loss"][-1])],
        steps_per_sec=[r["res"].steps_per_sec for r in runs[:2]],
        cpu_steps_per_sec=cpu["res"].steps_per_sec,
        **{k: ci[k] for k in ("stream_window", "n_windows", "stream_halo",
                              "stream_group_workers", "setup_seconds")},
        prefetch=[r["res"].cache_info["prefetch"] for r in runs[:2]],
        **stream_bound(a["res"], slot_bytes),
    )
    return rec, a, b


def ring_windows(cli, kernels, tmp, halo, b1) -> tuple:
    """HALO_ARGS under the ring transport: ``--stack-mode ring`` through
    windowed_runs (two card reruns bitwise, the CPU run's clocks and first
    10 rounds' loss, 100 B1, the peak within the prefetcher's bound plus the
    round's rebuilt slots) with 12 staged partitions a window, and ``--stack-mode auto`` once on the
    card: both resolve to the ring, the auto run bitwise the ring run, every
    B1 launch at the rebuilt [30, 4400, 128] slots, the first one held
    against its plain version on its own inputs, the first 10 rounds' loss
    within relative 1e-4 of the materialized windowed run (``halo``)."""
    shapes, restore = record_glm_shapes(kernels)
    try:
        with first_glm_launch(kernels) as box:
            # beside its windows a round holds the rebuilt slots, X and y
            slots = HALO_SHAPE[0] * HALO_SHAPE[1] * (HALO_SHAPE[2] + 1) * 4
            rec, ring, ring_b = windowed_runs(cli, kernels, tmp, HALO_ARGS + ["--stack-mode", "ring"],
                                              RING_STAGED, 2, b1, slots)
        kernels.reset_launches()
        auto, auto_ev, _ = cli.run(parse_config(cli, HALO_ARGS + ["--stack-mode", "auto"]),
                                   quiet=True, device="cuda",
                                   output_dir=os.path.join(tmp, "win_auto"))
        auto_launches = dict(kernels.LAUNCHES)
    finally:
        restore()
    rec["check"] = check_first_launch(kernels, box, "ring_window")
    modes = [r.cache_info["stack_mode"] for r in (ring["res"], ring_b["res"], auto)]
    rec.update(
        stack_modes=modes, auto_launches=auto_launches,
        auto_bitwise_ring=torch.equal(auto.params_history, ring["res"].params_history),
        bitwise_materialized=torch.equal(ring["res"].params_history, halo["res"].params_history),
        max_rel_loss_vs_materialized_10_rounds=max_rel(ring["loss"][:SHORT_ROUNDS],
                                                       halo["loss"][:SHORT_ROUNDS]),
        b1_shapes=[list(sh) for sh in sorted(set(shapes))],
        materialized_window_bytes=halo["res"].cache_info["stack_bytes"],
        materialized_peak_bytes=halo["res"].cache_info["device_peak_bytes"],
        materialized_steps_per_sec=halo["res"].steps_per_sec,
        ring_pipeline=ring["res"].cache_info["ring_pipeline"],
    )
    emit("ring_window", **{k: v for k, v in rec.items() if k != "args"})
    if modes != ["ring"] * 3 or auto_launches != b1 or not rec["auto_bitwise_ring"] \
            or rec["max_rel_loss_vs_materialized_10_rounds"] > 1e-4 \
            or set(shapes) != {HALO_SHAPE}:
        raise AssertionError(f"ring windows: {rec}")
    return rec, ring, ring_b, auto_launches


def streamed_phase(cli, kernels, experiments, both0, main_gpu) -> dict:
    """The main path out of a shard store (``--stack-residency streamed``):
    with no window, artifacts bitwise the resident main run's and 100 B1;
    ``--stream-window 6``: 100 B1 on [18, 4400, 128] slot-group windows,
    two card reruns bitwise, the loss falling, clocks byte-equal to and the
    first 10 rounds' replayed loss within relative 1e-4 of the CPU run, the
    peak device bytes within the prefetcher's bound; the same for cyccoded
    at ``--stream-window 10`` (halo 2, a wrapping span, B1 on
    [30, 4400, 128]), materialized and under the ring transport
    (ring_windows); an int8 store written by ``prepare --store`` trains
    with no launch; a 16x store (about 1 GB)
    under an ERASUREHEAD_STREAM_WINDOW budget of a 3-partition window:
    steps/s, staging and stall seconds, overlap, peak windows, a profile;
    the seven cohort schemes deduped and streamed in one dispatch."""
    from erasurehead_tpu_torch.data import prepare, store as store_lib
    from erasurehead_tpu_torch.data.synthetic import generate_gmm
    from erasurehead_tpu_torch.train import trainer
    from erasurehead_tpu_torch.utils.config import STREAM_WINDOW_ENV

    t_phase = time.perf_counter()
    rec = {}
    b1 = {**both0, "fused_glm_grad": ROUNDS}
    with tempfile.TemporaryDirectory(prefix="eh-chip-smoke-stream-") as tmp:
        old_tempdir = tempfile.tempdir
        tempfile.tempdir = tmp  # the trainer's spilled stores land here
        try:
            full = counted_run(cli, kernels, os.path.join(tmp, "full"), STREAM_ARGS, b1)
            same = {a: full["arts"][a].tobytes() == main_gpu["arts"][a].tobytes()
                    for a in ARTIFACTS}
            if not all(same.values()):
                raise AssertionError(f"full-cover streamed artifacts differ: {same}")
            rec["full_cover"] = dict(launches=full["launches"], artifacts_bitwise_resident=same,
                                     steps_per_sec=full["manifest"]["steps_per_sec"])

            win_args = STREAM_ARGS + ["--stream-window", str(STREAM_WINDOW)]
            rec["window"], a, b = windowed_runs(cli, kernels, tmp, win_args, STREAM_SHAPE, 0, b1)
            rec["halo_window"], halo, halo_b = windowed_runs(cli, kernels, tmp, HALO_ARGS, HALO_SHAPE,
                                                        2, b1)
            rec["ring_window"], ring, ring_b, auto_launches = ring_windows(cli, kernels, tmp, halo,
                                                                         b1)

            # an int8 store written by the prepare CLI
            sdir = os.path.join(tmp, "int8_store")
            t0 = time.perf_counter()
            prepare.main(["synthetic", "--rows", str(INT8_STORE_ROWS), "--cols", "128",
                          "--workers", "30", "--out", os.path.join(tmp, "prep"),
                          "--store", sdir, "--store-dtype", "int8"])
            prep_s = time.perf_counter() - t0
            int8_args = with_rounds(win_args, ROUNDS) + ["--stack-dtype", "int8", "--rows",
                                                         str(INT8_STORE_ROWS)]
            cfg8 = parse_config(cli, int8_args)
            kernels.reset_launches()
            res8 = trainer.train(cfg8, store_lib.open_store(sdir).dataset())
            launches8 = dict(kernels.LAUNCHES)
            if launches8 != both0 or not bool(torch.isfinite(res8.params_history).all()):
                raise AssertionError(f"int8 store run launched {launches8}")
            rec["int8_store"] = dict(launches=launches8, lowering=res8.lowering,
                                     prepare_seconds=prep_s, steps_per_sec=res8.steps_per_sec,
                                     prefetch=res8.cache_info["prefetch"])

            # the 16x store under a byte budget of two 3-partition windows
            t0 = time.perf_counter()
            big = generate_gmm(BIG_ROWS, 128, 30, seed=0)
            gen_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            store = store_lib.write_store(big, os.path.join(tmp, "big"), 30)
            write_s = time.perf_counter() - t0
            del big
            big_ds = store.dataset()
            budget = 2 * 3 * store.partition_bytes()
            os.environ[STREAM_WINDOW_ENV] = str(budget)
            try:
                cfg = dataclasses.replace(
                    parse_config(cli, MAIN_ARGS + ["--stack-residency", "auto",
                                                   "--compute-mode", "deduped"]),
                    n_rows=BIG_ROWS)
                kernels.reset_launches()
                res = trainer.train(cfg, big_ds)
                launches = dict(kernels.LAUNCHES)
                again = trainer.train(cfg, big_ds)
                prof = profile_run(lambda: trainer.train(cfg, big_ds))
            finally:
                del os.environ[STREAM_WINDOW_ENV]
            ci = res.cache_info
            if launches != b1 or ci["stream_window"] != 3 or ci["stack_mode"] != "deduped":
                raise AssertionError(f"16x store: {launches}, window {ci['stream_window']}")
            if not torch.equal(res.params_history, again.params_history):
                raise AssertionError("16x store reruns differ")
            rec["big_store"] = dict(
                rows=BIG_ROWS, store_bytes=store.partition_bytes() * 30, budget_bytes=budget,
                generate_seconds=gen_s, write_seconds=write_s, launches=launches,
                window_shape=list(BIG_SHAPE), steps_per_sec=[res.steps_per_sec,
                                                             again.steps_per_sec],
                wall_time_s=[res.wall_time, again.wall_time],
                prefetch=[res.cache_info["prefetch"], again.cache_info["prefetch"]],
                **stream_bound(res),
                profile={k: prof[k] for k in ("warm_steps_per_sec", "profiled_loop_wall_ms",
                                              "device_ms_in_loop", "device_ms_per_round",
                                              "device_busy_share", "kernel_ms", "top")},
            )
            del big_ds, store

            # the seven cohort schemes, deduped and streamed, one dispatch
            ds = cli.load_dataset(parse_config(cli, MAIN_ARGS))
            configs = {k: dataclasses.replace(c, stack_residency="streamed",
                                              stream_window=STREAM_WINDOW)
                       for k, c in cohort_configs("deduped", (0,)).items()}
            plan, batched, sequential = planned(experiments, configs)
            run = counted_compare(kernels, experiments, configs, ds, both0, batch="auto")
            if run["counters"]["cohort.dispatches"] != 1 or len(batched) != 1 or sequential:
                raise AssertionError(f"streamed compare: {run['counters']}, plan {plan}")
            rec["compare"] = dict(launches=run["launches"], counters=run["counters"],
                                  seconds=run["seconds"],
                                  lowering=run["rows"][0].cache["cohort_lowering"],
                                  losses=losses_fall(run["rows"]))
        finally:
            tempfile.tempdir = old_tempdir
    rec["seconds"] = time.perf_counter() - t_phase
    emit("streamed", **rec)
    rec["launches_by_run"] = {"full_cover": full["launches"], "window": a["launches"],
                              "window_rerun": b["launches"], "halo_window": halo["launches"],
                              "halo_window_rerun": halo_b["launches"],
                              "ring_window": ring["launches"],
                              "ring_window_rerun": ring_b["launches"],
                              "auto_window": auto_launches,
                              "int8_store": launches8,
                              "big_store": launches, "compare": run["launches"]}
    return rec


# the on-device, measured and failure phases: the main path's config
DYN_SHORT = 10  # card vs CPU rounds of train_dynamic
DYN_SPLIT = 4  # the split restart: 4 + 6 rounds against the unsplit 10
CYC_ARGS = ["--scheme", "cyccoded"] + SCHEME_BASE  # W = 30, s = 2: C(30, 2) table rows
PINV_ARGS = ["--scheme", "randreg", "--num-collect", "15"] + SCHEME_BASE  # C(30, 15): no table
MEASURED_ROUNDS, SLOW_ROUNDS, SLOW_MULT = 20, 10, 400
# the measured queue replay over a device list in one process: two devices
# (both cuda:0), W = 4 so each device holds two workers (w % 2) as in the
# JAX package's multi-device tests; avoidstragg drops the s = 2 slowest
LIST_DEVICES = ["cuda:0", "cuda:0"]
LIST_ARGS = ["--scheme", "avoidstragg", "--workers", "4"] + SCHEME_BASE[2:]
MEASURED_ARGS = with_rounds(MAIN_ARGS, MEASURED_ROUNDS) + ["--arrival-mode", "measured"]
KILLS = {3: 40, 7: 40, 11: 40}
KILL_ARGS = ["--kill-workers", ",".join(f"{w}:{r}" for w, r in KILLS.items())]
DEATH_ROUND = 40
SURVIVOR_SHAPE = (81, 4888, 128)  # 27 survivors x 3 slots; 132000 // 27 rows a partition


def record_glm_shapes(kernels):
    """Record the fused GLM kernel's stack shape at each launch (the launch
    count stays the wrapper's own); returns the list and a function
    restoring the wrappers. An eager call is a launch; a call captured into
    a CUDA graph (train/graphs.py) launches at each replay of that graph,
    which adds the graph's tally (kernels.add_launches), so its shapes are
    kept with the tally and recorded per replay; a graph's warm-up call is
    no launch. The executable cache is emptied first, so every graph a
    recorded run replays is captured under the recorder."""
    from erasurehead_tpu_torch.train import cache

    cache.drop_executables()
    shapes, captured = [], {}
    orig, orig_recording, orig_add = (kernels.fused_glm_grad, kernels.recording,
                                      kernels.add_launches)

    def wrapped(beta, X, y, w, kind="logistic"):
        tally = getattr(kernels._RECORDING, "tally", None)
        (shapes if tally is None else captured[id(tally)]).append(tuple(X.shape))
        return orig(beta, X, y, w, kind)

    @contextlib.contextmanager
    def recording(tally):
        captured[id(tally)] = []  # a new tally: an id the collector freed
        with orig_recording(tally) as t:
            yield t

    def add_launches(tally):
        shapes.extend(captured.get(id(tally), ()))
        orig_add(tally)

    kernels.fused_glm_grad, kernels.recording, kernels.add_launches = (
        wrapped, recording, add_launches)

    def restore():
        kernels.fused_glm_grad, kernels.recording, kernels.add_launches = (
            orig, orig_recording, orig_add)

    return shapes, restore


@contextlib.contextmanager
def first_glm_launch(kernels):
    """Keep a copy of the inputs of the first fused_glm_grad call inside the
    block (its launch count stays the wrapper's own), in host memory, so
    that the copy adds nothing to the run's peak device bytes. Yields the
    dict it fills under ``"args"``: (beta, X, y, w, kind) and ``"device"``."""
    box, orig = {}, kernels.fused_glm_grad

    def wrapped(beta, X, y, w, kind="logistic"):
        if "args" not in box:
            box["device"] = X.device
            box["args"] = tuple(t.detach().to("cpu", copy=True)
                                for t in (beta, X, y, w)) + (kind,)
        return orig(beta, X, y, w, kind)

    kernels.fused_glm_grad = wrapped
    try:
        yield box
    finally:
        kernels.fused_glm_grad = orig


def check_first_launch(kernels, box, label) -> dict:
    """B1 against its plain version on the inputs of a run's first launch
    (first_glm_launch); this check's own launches are outside every count."""
    if "args" not in box:
        raise AssertionError(f"{label}: no B1 launch to check")
    *tensors, kind = box.pop("args")
    return check_glm_inputs(kernels, *(t.to(box["device"]) for t in tensors), kind, run=label)


def dynamic_phase(cli, kernels, both0) -> dict:
    """trainer.train_dynamic at MAIN_ARGS' config: exactly 100 B1 launches and
    no B2, its round loop under torch.cuda.set_sync_debug_mode("error"), the
    replayed loss falling; its steps/s and busy share beside train()'s on the
    same config (profile_run); its first 10 rounds on the card and the CPU
    (collected masks equal, or the differing rounds printed with their two
    arrival times; clocks within relative 1e-6, replayed loss within 1e-4);
    cyccoded through its decode table (100 B1, sync-free); deepmlp
    layer-coded, 20 rounds (20 B2, sync-free); a split restart (4 + 6
    rounds) bitwise the unsplit run; randreg collecting 15 of 30 (no table:
    the float32 solve) under the "warn" mode, its synchronisations counted."""
    import warnings

    from erasurehead_tpu_torch.parallel import straggler
    from erasurehead_tpu_torch.train import trainer
    from erasurehead_tpu_torch.utils import threefry

    t_phase = time.perf_counter()
    cfg = parse_config(cli, MAIN_ARGS)
    ds = cli.load_dataset(cfg)
    b1 = {**both0, "fused_glm_grad": ROUNDS}

    def counted(c, want, mode="error"):
        kernels.reset_launches()
        res = trainer.train_dynamic(c, ds, _sync_debug_mode=mode)
        launches = dict(kernels.LAUNCHES)
        if launches != want:
            raise AssertionError(f"train_dynamic {c.scheme.value} launched {launches}, want {want}")
        return res, launches

    main, main_launches = counted(cfg, b1)
    loss = replayed_loss(main, ds)
    if not loss[-1] < loss[0]:
        raise AssertionError(f"train_dynamic loss did not fall: {loss[0]} -> {loss[-1]}")
    prof_dyn = profile_run(lambda: trainer.train_dynamic(cfg, ds))
    prof_train = profile_run(lambda: trainer.train(cfg, ds))

    short = dataclasses.replace(cfg, rounds=DYN_SHORT)
    gpu10 = trainer.train_dynamic(short, ds)
    cpu10 = trainer.train_dynamic(short, ds, device="cpu")
    t_draw = straggler.threefry_delay_schedule(threefry.key(cfg.seed + 1), DYN_SHORT,
                                               cfg.n_workers, cfg.delay_mean, device="cuda")
    c_draw = straggler.threefry_delay_schedule(threefry.key(cfg.seed + 1), DYN_SHORT,
                                               cfg.n_workers, cfg.delay_mean)
    mask_diff = []
    for r in np.flatnonzero((gpu10.collected != cpu10.collected).any(axis=1)):
        w = np.flatnonzero(gpu10.collected[r] != cpu10.collected[r])
        mask_diff.append(dict(round=int(r), workers=w.tolist(),
                              cuda_arrivals=t_draw[r].cpu().numpy()[w].tolist(),
                              cpu_arrivals=c_draw[r].numpy()[w].tolist()))
    clock_rel = max_rel(gpu10.timeset, cpu10.timeset)
    loss_rel = max_rel(replayed_loss(gpu10, ds), replayed_loss(cpu10, ds))
    draw_rel = float(((t_draw.cpu() - c_draw).abs() / c_draw).max())

    cyc_cfg = parse_config(cli, CYC_ARGS)
    cyc, cyc_launches = counted(cyc_cfg, b1)
    cyc_loss = replayed_loss(cyc, ds)
    deep_cfg = parse_config(cli, with_rounds(DEEP_ARGS, LAYER_ROUNDS))
    deep, deep_launches = counted(deep_cfg, {**both0, "fused_block_decode": LAYER_ROUNDS})

    lr = short.resolve_lr_schedule()
    p1 = trainer.train_dynamic(dataclasses.replace(short, rounds=DYN_SPLIT,
                                                   lr_schedule=lr[:DYN_SPLIT]), ds)
    p2 = trainer.train_dynamic(dataclasses.replace(short, lr_schedule=lr), ds,
                               initial_state=p1.final_state, initial_round=DYN_SPLIT)
    split_bitwise = (torch.equal(p1.params_history, gpu10.params_history[:DYN_SPLIT])
                     and torch.equal(p2.params_history, gpu10.params_history[DYN_SPLIT:])
                     and p2.timeset[DYN_SPLIT:].tobytes() == gpu10.timeset[DYN_SPLIT:].tobytes())

    pinv_cfg = dataclasses.replace(parse_config(cli, PINV_ARGS), rounds=DYN_SHORT)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        pinv, pinv_launches = counted(pinv_cfg, {**both0, "fused_glm_grad": DYN_SHORT}, "warn")
    syncs = [str(w.message) for w in caught if "synchroniz" in str(w.message)]
    table_warned = any("too large for a decode table" in str(w.message) for w in caught)

    rec = dict(
        args=MAIN_ARGS, launches=main_launches, sync_debug_mode="error",
        steps_per_sec=main.steps_per_sec, train_loss_first_last=[float(loss[0]), float(loss[-1])],
        profile=dict(train_dynamic={k: prof_dyn[k] for k in (
            "warm_steps_per_sec", "device_ms_per_round", "device_busy_share", "kernel_ms")},
            train={k: prof_train[k] for k in (
                "warm_steps_per_sec", "device_ms_per_round", "device_busy_share", "kernel_ms")},
            train_dynamic_top=prof_dyn["top"][:8]),
        card_vs_cpu=dict(rounds=DYN_SHORT, masks_equal=not mask_diff, differing_rounds=mask_diff,
                         max_rel_timeset=clock_rel, max_rel_loss=loss_rel,
                         max_rel_draw=draw_rel),
        cyccoded=dict(launches=cyc_launches, steps_per_sec=cyc.steps_per_sec,
                      train_loss_first_last=[float(cyc_loss[0]), float(cyc_loss[-1])]),
        deep=dict(launches=deep_launches, steps_per_sec=deep.steps_per_sec),
        split_restart=dict(rounds=[DYN_SPLIT, DYN_SHORT - DYN_SPLIT], bitwise=split_bitwise),
        randreg_float32_solve=dict(rounds=DYN_SHORT, launches=pinv_launches,
                                   table_fallback_warned=table_warned,
                                   synchronisations=len(syncs),
                                   per_round=len(syncs) / DYN_SHORT,
                                   first=syncs[0][:200] if syncs else None),
        seconds=time.perf_counter() - t_phase,
    )
    emit("dynamic", **rec)
    if clock_rel > 1e-6 or loss_rel > 1e-4:
        raise AssertionError(f"train_dynamic card vs CPU: clocks {clock_rel}, loss {loss_rel}")
    if not split_bitwise:
        raise AssertionError("the split train_dynamic run is not bitwise the unsplit one")
    if not cyc_loss[-1] < cyc_loss[0]:
        raise AssertionError("cyccoded train_dynamic loss did not fall")
    rec["launches_by_run"] = {"dynamic_main": main_launches, "dynamic_cyccoded": cyc_launches,
                              "dynamic_deep": deep_launches, "dynamic_randreg": pinv_launches}
    return rec


def measured_phase(cli, kernels, tmp, both0) -> dict:
    """The CLI with --arrival-mode measured at MAIN_ARGS, 20 rounds: exactly 20
    B2 launches and no B1, the five artifacts written, worker_timeset real
    seconds (the injected delay plus a positive measured compute) where a
    worker was collected and -1 where not; a worker's measured compute
    (median, p90 in microseconds). Then avoidstragg without delays, workers
    0 and 1 doing 400x the work: excluded in more than half the rounds.
    Then the queue replay over LIST_DEVICES in one process (W = 4, no
    delays, SLOW_ROUNDS rounds, each exactly SLOW_ROUNDS B2 launches on
    device 0): workers 0 and 2, device 0's queue, both heavy, are excluded
    and the light workers collected in more than half the rounds (JAX's
    multi-device imbalance test); with worker 0 alone heavy, the light
    worker 2 queued behind it is excluded with it in more than half the
    rounds (JAX's queue-contention test)."""
    from erasurehead_tpu_torch.parallel import straggler
    from erasurehead_tpu_torch.train import trainer

    t_phase = time.perf_counter()
    out = os.path.join(tmp, "measured")
    kernels.reset_launches()
    run = run_main(cli, out, "cuda", MEASURED_ARGS)
    launches = dict(kernels.LAUNCHES)
    if launches != {**both0, "fused_block_decode": MEASURED_ROUNDS}:
        raise AssertionError(f"measured run launched {launches}")
    wt = run["arts"]["worker_timeset"]
    cfg = parse_config(cli, MEASURED_ARGS)
    delays = straggler.arrival_schedule(MEASURED_ROUNDS, cfg.n_workers, True, cfg.delay_mean)
    collected = wt != -1.0
    compute_us = (wt - delays)[collected] * 1e6
    if not ((wt[collected] > 0).all() and (compute_us > 0).all()):
        raise AssertionError("measured worker_timeset is not delay plus a positive compute")
    loss = run["arts"]["training_loss"]

    slow_cfg = dataclasses.replace(
        parse_config(cli, ["--scheme", "avoidstragg"] + with_rounds(SCHEME_BASE, SLOW_ROUNDS)),
        add_delay=False, arrival_mode="measured")
    ds = cli.load_dataset(slow_cfg)
    mult = np.ones(slow_cfg.n_workers, dtype=np.int64)
    mult[:2] = SLOW_MULT
    kernels.reset_launches()
    slow = trainer.train_measured(slow_cfg, ds, work_multiplier=mult)
    slow_launches = dict(kernels.LAUNCHES)
    excluded = (slow.worker_times[:, :2] == -1.0).all(axis=1)
    rec = dict(
        args=MEASURED_ARGS, launches=launches, steps_per_sec=run["manifest"]["steps_per_sec"],
        artifacts=sorted(run["arts"]), train_loss_first_last=[float(loss[0]), float(loss[-1])],
        collected_per_round=collected.sum(axis=1).tolist(),
        compute_us=dict(median=float(np.median(compute_us)),
                        p90=float(np.percentile(compute_us, 90)),
                        min=float(compute_us.min()), max=float(compute_us.max()),
                        samples=int(compute_us.size)),
        slow_workers=dict(mult=SLOW_MULT, rounds=SLOW_ROUNDS, launches=slow_launches,
                          excluded_rounds=int(excluded.sum()),
                          fast_collected_when_excluded=bool(slow.collected[excluded][:, 2:].all()),
                          timeset_ms=(slow.timeset * 1e3).tolist(),
                          steps_per_sec=slow.steps_per_sec),
        seconds=time.perf_counter() - t_phase,
    )
    emit("measured", **rec)
    if slow_launches != {**both0, "fused_block_decode": SLOW_ROUNDS}:
        raise AssertionError(f"the slow-worker run launched {slow_launches}")
    if not excluded.sum() > SLOW_ROUNDS // 2:
        raise AssertionError(f"slow workers excluded in {int(excluded.sum())} of {SLOW_ROUNDS}")
    rec["launches_by_run"] = {"measured_main": launches, "measured_slow": slow_launches}
    rec["device_list"] = device_list_runs(cli, kernels, both0)
    for name, run in rec["device_list"].items():
        rec["launches_by_run"][f"measured_list_{name}"] = run["launches"]
    return rec


def device_list_runs(cli, kernels, both0) -> dict:
    """The measured queue replay over LIST_DEVICES (measured_phase's last
    part): the heavy-device run and the queue-contention run."""
    from erasurehead_tpu_torch.train import trainer

    cfg = dataclasses.replace(parse_config(cli, with_rounds(LIST_ARGS, SLOW_ROUNDS)),
                              add_delay=False, arrival_mode="measured")
    ds = cli.load_dataset(cfg)
    out = {}
    for name, heavy, excluded_pair in (("heavy_device", [0, 2], [0, 2]),
                                       ("queue", [0], [0, 2])):
        mult = np.ones(cfg.n_workers, dtype=np.int64)
        mult[heavy] = SLOW_MULT
        kernels.reset_launches()
        res = trainer.train_measured(cfg, ds, device=LIST_DEVICES, work_multiplier=mult)
        launches = dict(kernels.LAUNCHES)
        excluded = (res.worker_times[:, excluded_pair] == -1.0).all(axis=1)
        light = [w for w in range(cfg.n_workers) if w not in excluded_pair]
        out[name] = dict(heavy=heavy, launches=launches, excluded_rounds=int(excluded.sum()),
                         light_collected_when_excluded=bool(res.collected[excluded][:, light].all()),
                         worker_times_s=res.worker_times.tolist(),
                         steps_per_sec=res.steps_per_sec)
        if launches != {**both0, "fused_block_decode": SLOW_ROUNDS}:
            raise AssertionError(f"the device-list {name} run launched {launches}")
        if not (excluded.sum() > SLOW_ROUNDS // 2 and out[name]["light_collected_when_excluded"]):
            raise AssertionError(f"device-list {name} run: workers {excluded_pair} excluded in "
                                 f"{int(excluded.sum())} of {SLOW_ROUNDS} rounds: "
                                 f"{res.worker_times.tolist()}")
    emit("measured_device_list", devices=LIST_DEVICES, args=LIST_ARGS, **out)
    return out


def failures_phase(cli, kernels, tmp, both0, main_gpu) -> dict:
    """The CLI at MAIN_ARGS with workers 3, 7 and 11 killed at round 40:
    ``--on-death failover --death-timeout 2.0`` (100 B1 at [90, 4400, 128];
    every rewritten round's clock 2.0), the same deaths on naive (whose
    rounds from 40 on are all rewritten); ``--on-death elastic`` (40 B1 at
    [90, 4400, 128], 60 at the 27 survivors' [81, 4888, 128]; the dead
    columns -1 from round 40; the loss step at the restart within twice the
    uninterrupted run's step from round 39 to 40); then
    failures.train_elastic(dynamic=True) on the same deaths (100 B1)."""
    from erasurehead_tpu_torch.parallel import failures
    from erasurehead_tpu_torch.train import trainer

    t_phase = time.perf_counter()
    b1 = {**both0, "fused_glm_grad": ROUNDS}
    cfg = parse_config(cli, MAIN_ARGS)
    arrivals = failures.inject_worker_death(trainer.default_arrivals(cfg), KILLS)
    report = failures.analyze(cfg.scheme, trainer.build_layout(cfg), arrivals,
                              num_collect=cfg.num_collect, timeout=2.0)
    fail_args = MAIN_ARGS + KILL_ARGS + ["--on-death", "failover", "--death-timeout", "2.0"]
    shapes, restore = record_glm_shapes(kernels)
    try:
        failover = counted_run(cli, kernels, os.path.join(tmp, "failover"), fail_args, b1)
        rewritten = np.flatnonzero(~report.feasible)
        ts = failover["arts"]["timeset"]
        naive_args = ["--scheme", "naive"] + SCHEME_BASE + KILL_ARGS + [
            "--on-death", "failover", "--death-timeout", "2.0"]
        naive = counted_run(cli, kernels, os.path.join(tmp, "failover_naive"), naive_args, b1)
        nts = naive["arts"]["timeset"]
        fail_shapes = sorted(set(shapes))
        shapes.clear()
        elastic = counted_run(cli, kernels, os.path.join(tmp, "elastic"),
                              MAIN_ARGS + KILL_ARGS + ["--on-death", "elastic"], b1)
        elastic_shapes = list(shapes)
        shapes.clear()
        ds = cli.load_dataset(cfg)
        kernels.reset_launches()
        dyn, dyn_report = failures.train_elastic(cfg, ds, KILLS, dynamic=True)
        dyn_launches = dict(kernels.LAUNCHES)
        dyn_shapes = list(shapes)
    finally:
        restore()
    want_shapes = [MAIN_SHAPE] * DEATH_ROUND + [SURVIVOR_SHAPE] * (ROUNDS - DEATH_ROUND)
    ewt = elastic["arts"]["worker_timeset"]
    dead = sorted(KILLS)
    eloss, mloss = elastic["arts"]["training_loss"], main_gpu["arts"]["training_loss"]
    jump = abs(float(eloss[DEATH_ROUND] - eloss[DEATH_ROUND - 1]))
    main_jump = abs(float(mloss[DEATH_ROUND] - mloss[DEATH_ROUND - 1]))
    rec = dict(
        kills=KILLS,
        failover=dict(args=fail_args, launches=failover["launches"], shapes=fail_shapes,
                      rewritten_rounds=len(rewritten), reason=report.reason,
                      rewritten_timeset_2s=bool((ts[rewritten] == 2.0).all()),
                      train_loss_first_last=check_falls(failover)),
        failover_naive=dict(launches=naive["launches"],
                            rewritten_timeset_2s=bool((nts[DEATH_ROUND:] == 2.0).all()),
                            dead_columns_minus1=bool(
                                (naive["arts"]["worker_timeset"][DEATH_ROUND:, dead] == -1).all()),
                            train_loss_first_last=check_falls(naive)),
        elastic=dict(launches=elastic["launches"],
                     shapes={str(s): elastic_shapes.count(s) for s in set(elastic_shapes)},
                     dead_columns_minus1=bool((ewt[DEATH_ROUND:, dead] == -1.0).all()),
                     # rounds 0-39 train as the main run did; the replay
                     # reads the common prefix of both phases' rows
                     phase1_max_rel_loss_vs_main=max_rel(eloss[:DEATH_ROUND],
                                                         mloss[:DEATH_ROUND]),
                     loss_step_at_restart=jump, main_loss_step_39_40=main_jump,
                     train_loss_first_last=check_falls(elastic)),
        elastic_dynamic=dict(launches=dyn_launches, report=dataclasses.asdict(dyn_report),
                             shapes={str(s): dyn_shapes.count(s) for s in set(dyn_shapes)},
                             dead_columns_minus1=bool(
                                 (dyn.worker_times[DEATH_ROUND:, dead] == -1.0).all())),
        seconds=time.perf_counter() - t_phase,
    )
    emit("failures", **rec)
    if not (rec["failover"]["rewritten_timeset_2s"] and rec["failover_naive"]["rewritten_timeset_2s"]
            and rec["failover_naive"]["dead_columns_minus1"]):
        raise AssertionError("failover rounds' clocks or stamps are wrong")
    if elastic_shapes != want_shapes or dyn_shapes != want_shapes:
        raise AssertionError(f"elastic B1 shapes {rec['elastic']['shapes']}, "
                             f"dynamic {rec['elastic_dynamic']['shapes']}")
    if not (rec["elastic"]["dead_columns_minus1"] and rec["elastic_dynamic"]["dead_columns_minus1"]):
        raise AssertionError("elastic dead columns are not -1 after the restart")
    if dyn_launches != b1:
        raise AssertionError(f"train_elastic(dynamic=True) launched {dyn_launches}")
    if jump > 2 * main_jump:
        raise AssertionError(f"elastic loss step at the restart {jump} vs {main_jump} uninterrupted")
    rec["launches_by_run"] = {"failover": failover["launches"], "failover_naive": naive["launches"],
                              "elastic": elastic["launches"], "elastic_dynamic": dyn_launches}
    return rec


ADAPT_REGIME = "adversary:50:0:8"  # worker 0 eight seconds slower from round 50
ADAPT_CHUNK = 10
ADAPT_ARGS = MAIN_ARGS[:MAIN_ARGS.index("--compute-mode")] + [
    "--compute-mode", "deduped", "--add-delay", "--quiet", "--adapt", "on",
    "--adapt-chunk", str(ADAPT_CHUNK)]
ADAPT_CPU_ROUNDS = 60  # the CPU run covers the shift at round 50
# one 8 s straggler among 30 workers lifts a chunk's mean arrival about 1.6x
# (0.46 s to 0.73 s), under the controller's default jump factor of 2.5; the
# time_error run asks for 1.4, which no chunk before the shift reaches (at
# most 1.22x)
ADAPT_SHIFT_FACTOR = 1.4
ELASTIC_ARGS = MAIN_ARGS + KILL_ARGS + ["--elastic", "on", "--death-timeout", "2.0"]
ELASTIC_CHUNK = 10
RESUME_ROUNDS = 40  # the kill -> resume drill: chunks 0-1, a raise, then 2-3
RESUME_CHAOS = "5:worker_death:2"  # worker 5 dies at boundary 2 (round 10)


def cache_delta(cache_lib, before) -> dict:
    after = cache_lib.stats().snapshot()
    return {k: after[k] - before[k] for k in ("data_hits", "data_misses")}


def adapt_phase(cli, kernels, tmp, both0) -> dict:
    """Adaptive collection at the flagship data, deduped, under an adversary
    from round 50 (ERASUREHEAD_REGIME=adversary:50:0:8). Through the CLI
    (--adapt on --adapt-chunk 10: approx c15, naive, avoidstragg under the
    progress reward): exactly 100 B1 launches, every one at [30, 4400, 128],
    no B2, one data-cache miss (or none) and hits for the other chunks, the
    loss falling. Through the API the same config under the progress reward
    (steps/s, decision and driver overheads, total wall seconds, beside plain
    train()'s steps/s in this process) and under time_error with
    shift_factor 1.4 (100 B1 again): its decisions bitwise those of the CPU
    run of the same config over the first 60 rounds, a regime_shift among
    them, the loss falling."""
    from erasurehead_tpu_torch import adapt
    from erasurehead_tpu_torch.train import cache as cache_lib
    from erasurehead_tpu_torch.train import trainer
    from erasurehead_tpu_torch.utils import chaos as chaos_lib

    t_phase = time.perf_counter()
    b1 = {**both0, "fused_glm_grad": ROUNDS}
    want_shapes = [DEDUPED_SHAPE] * ROUNDS
    chunks = ROUNDS // ADAPT_CHUNK
    os.environ[chaos_lib.REGIME_ENV] = ADAPT_REGIME
    shapes, restore = record_glm_shapes(kernels)
    try:
        before = cache_lib.stats().snapshot()
        cli_run = counted_run(cli, kernels, os.path.join(tmp, "adapt"), ADAPT_ARGS, b1)
        runs = {"cli": dict(launches=cli_run["launches"], cache=cache_delta(cache_lib, before),
                            shapes=list(shapes))}
        cfg = parse_config(cli, ADAPT_ARGS)
        ds = cli.load_dataset(cfg)
        arrivals = trainer.default_arrivals(cfg)
        ctl = {"progress": adapt.ControllerConfig(chunk_rounds=ADAPT_CHUNK, seed=cfg.seed),
               "time_error": adapt.ControllerConfig(
                   chunk_rounds=ADAPT_CHUNK, seed=cfg.seed, reward_mode="time_error",
                   shift_factor=ADAPT_SHIFT_FACTOR)}
        res = {}
        for mode, c in ctl.items():
            shapes.clear()
            before = cache_lib.stats().snapshot()
            kernels.reset_launches()
            res[mode] = adapt.train_adaptive(cfg, ds, controller=c, arrivals=arrivals)
            runs[mode] = dict(launches=dict(kernels.LAUNCHES),
                              cache=cache_delta(cache_lib, before), shapes=list(shapes))
    finally:
        restore()
        os.environ.pop(chaos_lib.REGIME_ENV, None)
    plain = trainer.train(cfg, ds, arrivals=arrivals)
    cpu_cfg = dataclasses.replace(cfg, rounds=ADAPT_CPU_ROUNDS,
                                  lr_schedule=cfg.resolve_lr_schedule()[:ADAPT_CPU_ROUNDS])
    cpu = adapt.train_adaptive(cpu_cfg, ds, controller=ctl["time_error"],
                               arrivals=arrivals[:ADAPT_CPU_ROUNDS], device="cpu")
    te = res["time_error"]
    prefix_equal = te.decisions[:len(cpu.decisions)] == cpu.decisions
    losses = {mode: replayed_loss(r.result, ds) for mode, r in res.items()}
    rec = dict(
        regime=ADAPT_REGIME, args=ADAPT_ARGS,
        runs={k: dict(launches=v["launches"], cache=v["cache"],
                      shapes_all_deduped=v["shapes"] == want_shapes) for k, v in runs.items()},
        cli_steps_per_sec=cli_run["manifest"]["steps_per_sec"],
        cli_train_loss_first_last=check_falls(cli_run),
        **{mode: dict(
            steps_per_sec=r.result.steps_per_sec, train_wall_s=r.train_wall_s,
            decision_overhead_s=r.decision_overhead_s, driver_overhead_s=r.driver_overhead_s,
            total_wall_s=r.total_wall_s,
            driver_overhead_per_chunk_s=r.driver_overhead_s / chunks,
            decision_overhead_per_chunk_s=r.decision_overhead_s / chunks,
            arms=[d["arm"] for d in r.decisions], reasons=[d["reason"] for d in r.decisions],
            train_loss_first_last=[float(losses[mode][0]), float(losses[mode][-1])])
           for mode, r in res.items()},
        plain_train_steps_per_sec=plain.steps_per_sec,
        plain_train_setup_s=plain.cache_info["setup_seconds"],
        cpu_rounds=ADAPT_CPU_ROUNDS, cpu_decisions=len(cpu.decisions),
        decisions_equal_cpu=prefix_equal,
        seconds=time.perf_counter() - t_phase,
    )
    emit("adapt", **rec)
    for name, r in runs.items():
        if r["launches"] != b1 or r["shapes"] != want_shapes:
            raise AssertionError(f"adapt {name}: launches {r['launches']}, shapes "
                                 f"{sorted(set(r['shapes']))}")
        c = r["cache"]
        if c["data_misses"] > 1 or c["data_misses"] + c["data_hits"] != chunks:
            raise AssertionError(f"adapt {name}: data cache {c}, want <= 1 miss of {chunks}")
    if not prefix_equal:
        raise AssertionError("adapt time_error decisions differ from the CPU run's")
    if "regime_shift" not in rec["time_error"]["reasons"]:
        raise AssertionError(f"no regime_shift decision: {rec['time_error']['reasons']}")
    for mode in res:
        if not losses[mode][-1] < losses[mode][0]:
            raise AssertionError(f"adapt {mode}: loss did not fall")
    rec["launches_by_run"] = {f"adapt_{k}": v["launches"] for k, v in runs.items()}
    return rec


def elastic_phase(cli, kernels, tmp, both0) -> dict:
    """Online elastic membership: the CLI at MAIN_ARGS with workers 3, 7 and
    11 dead from round 40 and --elastic on --death-timeout 2.0: B1 at
    [90, 4400, 128] until the re-layout and at the 27 survivors'
    [81, 4888, 128] after it, a launch a round, the re-layout round and the
    dead columns (-1 from it on) those of the CPU run of the same config,
    the loss falling; the same config through the API on the card, its
    decisions and epochs the CPU's. Then a chaos drill through the API (a
    worker_death spec plus a raise at the elastic site, 40 rounds, with a
    checkpoint and a journal) resumed: rows and final params bitwise the
    uninterrupted run's. Then deepmlp layer-coded, 20 rounds, one death
    (re-laid at round 10): B2 once a round, B1 never, B2 checked at the
    survivors' [29, 1, ...] slots."""
    from erasurehead_tpu_torch import elastic
    from erasurehead_tpu_torch.utils import chaos as chaos_lib

    t_phase = time.perf_counter()
    b1 = {**both0, "fused_glm_grad": ROUNDS}
    cfg = parse_config(cli, ELASTIC_ARGS)
    ecfg = elastic.ElasticConfig(chunk_rounds=ELASTIC_CHUNK, death_rounds=3, timeout=2.0,
                                 seed=cfg.seed)
    shapes, restore = record_glm_shapes(kernels)
    try:
        run = counted_run(cli, kernels, os.path.join(tmp, "elastic_online"), ELASTIC_ARGS, b1)
        cli_shapes = list(shapes)
        shapes.clear()
        ds = cli.load_dataset(cfg)
        kernels.reset_launches()
        gpu = elastic.train_elastic_online(cfg, ds, elastic=ecfg, deaths=KILLS)
        api_launches = dict(kernels.LAUNCHES)
        api_shapes = list(shapes)
    finally:
        restore()
    cpu = elastic.train_elastic_online(cfg, ds, elastic=ecfg, deaths=KILLS, device="cpu")
    relayout = cpu.epochs[1]["start_round"] if len(cpu.epochs) > 1 else None
    want_shapes = [MAIN_SHAPE] * relayout + [SURVIVOR_SHAPE] * (ROUNDS - relayout)
    wt = run["arts"]["worker_timeset"]
    dead_cols = np.flatnonzero((wt[relayout:] == -1.0).all(axis=0)).tolist()
    survivors = [w for w in range(cfg.n_workers) if w not in dead_cols]

    # kill -> resume through the API: the world changes by chaos at
    # boundary 2, a raise stops the run at boundary 3
    lr = cfg.resolve_lr_schedule()
    short = dataclasses.replace(cfg, rounds=RESUME_ROUNDS, lr_schedule=lr[:RESUME_ROUNDS])
    drill = os.path.join(tmp, "elastic_drill")
    kw = dict(elastic=ecfg, journal_dir=drill, checkpoint_dir=os.path.join(drill, "ck"))
    try:
        os.environ[chaos_lib.CHAOS_ENV] = RESUME_CHAOS
        chaos_lib.reset()
        base = elastic.train_elastic_online(short, ds, elastic=ecfg)
        os.environ[chaos_lib.CHAOS_ENV] = RESUME_CHAOS + ",raise:elastic:3:PREEMPTED"
        chaos_lib.reset()
        try:
            elastic.train_elastic_online(short, ds, **kw)
            raise AssertionError("the chaos raise at the elastic site never fired")
        except chaos_lib.ChaosInjection:
            pass
        os.environ[chaos_lib.CHAOS_ENV] = RESUME_CHAOS
        chaos_lib.reset()
        resumed = elastic.train_elastic_online(short, ds, resume=True, **kw)
    finally:
        os.environ.pop(chaos_lib.CHAOS_ENV, None)
        chaos_lib.reset()
    rows_equal = ([elastic.science_fields(r) for r in resumed.rows]
                  == [elastic.science_fields(r) for r in base.rows])
    params_equal = torch.equal(resumed.result.final_params, base.result.final_params)

    deep_cfg = parse_config(cli, with_rounds(DEEP_ARGS, LAYER_ROUNDS))
    deep_ecfg = elastic.ElasticConfig(chunk_rounds=ELASTIC_CHUNK, death_rounds=2, timeout=2.0)
    kernels.reset_launches()
    deep = elastic.train_elastic_online(deep_cfg, ds, elastic=deep_ecfg, deaths={5: 0})
    deep_launches = dict(kernels.LAUNCHES)
    deep_lead = (deep.epochs[-1]["n_workers"], deep.epochs[-1]["n_stragglers"] + 1)
    deep_check = check_decode_leaves(kernels, leaf_shapes("deepmlp"), torch.float32, 260,
                                     lead=deep_lead)
    deep_loss = replayed_loss(deep.result, ds)

    rec = dict(
        args=ELASTIC_ARGS, launches=run["launches"],
        shapes={str(s): cli_shapes.count(s) for s in set(cli_shapes)},
        relayout_round=relayout, cpu_epochs=[(e["start_round"], e["n_workers"])
                                             for e in cpu.epochs],
        cpu_deaths=[(d["worker"], d["round"], d["rule"]) for d in cpu.decisions
                    if d["action"] == "death"],
        dead_columns=dead_cols, steps_per_sec=run["manifest"]["steps_per_sec"],
        train_loss_first_last=check_falls(run),
        api=dict(launches=api_launches, decisions_equal_cpu=gpu.decisions == cpu.decisions,
                 epochs_equal_cpu=gpu.epochs == cpu.epochs, steps_per_sec=gpu.result.steps_per_sec,
                 shapes_as_cli=api_shapes == cli_shapes),
        drill=dict(rounds=RESUME_ROUNDS, chaos=RESUME_CHAOS, resumed_from=resumed.resumed_from,
                   epochs=[(e["start_round"], e["n_workers"]) for e in base.epochs],
                   rows=len(resumed.rows), rows_bitwise=rows_equal,
                   final_params_bitwise=params_equal),
        deep=dict(launches=deep_launches, epochs=[(e["start_round"], e["n_workers"])
                                                  for e in deep.epochs],
                  survivor_slots=list(deep_lead),
                  train_loss_first_last=[float(deep_loss[0]), float(deep_loss[-1])]),
        seconds=time.perf_counter() - t_phase,
    )
    emit("elastic", **rec)
    if relayout is None or cli_shapes != want_shapes or api_shapes != want_shapes:
        raise AssertionError(f"elastic B1 shapes {rec['shapes']}, re-layout {relayout}")
    if not (rec["api"]["decisions_equal_cpu"] and rec["api"]["epochs_equal_cpu"]):
        raise AssertionError("elastic decisions or epochs on the card differ from the CPU's")
    if list(cpu.epochs[1]["workers"]) != survivors or dead_cols != sorted(KILLS):
        raise AssertionError(f"dead columns {dead_cols} vs the CPU's survivors")
    if api_launches != b1:
        raise AssertionError(f"elastic API run launched {api_launches}")
    if not (rows_equal and params_equal and resumed.resumed_from == 2 * ELASTIC_CHUNK):
        raise AssertionError(f"elastic kill -> resume not bitwise: {rec['drill']}")
    if deep_launches != {**both0, "fused_block_decode": LAYER_ROUNDS} or len(deep.epochs) != 2:
        raise AssertionError(f"deep elastic: launches {deep_launches}, epochs {rec['deep']}")
    rec["launches_by_run"] = {"elastic_online": run["launches"], "elastic_online_api":
                              api_launches, "elastic_deep": deep_launches}
    rec["check"] = deep_check
    return rec


# the tune phase: glm_fused races at the main stack and at the wide
# cyccoded stack (W = 3, s = 1, 6,600 x 15,509: B1's column path at
# [6, 2200, 15509], where the two-pass path once beat B1's earlier design), the
# deep path's block_decode and layer_coding races at 8 rounds, then the
# auto runs each verdict resolves
WIDE_ARGS = ["--scheme", "cyccoded", "--workers", "3", "--stragglers", "1", "--rounds", "100",
             "--rows", "6600", "--cols", "15509", "--update-rule", "AGD", "--compute-mode",
             "faithful", "--add-delay", "--quiet"]
WIDE_STACK = (3, 2, 2200, 15509)
RACE_ROUNDS = 8
DEEP_AUTO_ARGS = [a for a in DEEP_ARGS if a not in ("--layer-coding", "--block-decode", "on",
                                                    "fused")]
# `tune --race all` at a small GLM shape, and the kill drill at the main
# path's (the CLI's flags)
TUNE_SMALL = ["--model", "logistic", "--workers", "8", "--stragglers", "1", "--num-collect",
              "6", "--rows", "2048", "--cols", "64", "--rounds", "4", "--reps", "1"]
TUNE_MAIN = ["--race", "glm_fused", "--model", "logistic", "--scheme", "approx", "--workers",
             "30", "--stragglers", "2", "--num-collect", "15", "--rows", "132000", "--cols",
             "128", "--rounds", "8"]
# the whatif phase: three policies x two regimes at the flagship data,
# deduped (B1 at [30, 4400, 128] in a sequential run), 8 seeds x 30 rounds
WHATIF_FLAGS = ["--policies", "approx:c15,cyccoded,naive", "--workers", "30", "--stragglers",
                "2", "--regimes", "exp:0.5,adversary:8:0", "--seeds", "8", "--rounds", "30",
                "--rows", "132000", "--cols", "128", "--model", "logistic"]
WHATIF_POINTS, WHATIF_SEEDS, WHATIF_ROUNDS = 6, 8, 30
WHATIF_CPU_SEEDS, WHATIF_CPU_ROUNDS = 2, 10  # the card-vs-CPU grid


def tune_events(path) -> list:
    with open(path) as f:
        return [r for r in map(json.loads, f) if r["type"] == "tune"]


def tuned_glm_run(cli, kernels, tune_lib, races, events_lib, tmp, label, args, stack):
    """A glm_fused race at the stack of ``args``' config, its verdict in the
    cache, then ``args``' 100-round auto run under that cache (counts set to
    0 just before it): 100 B1 at the stack if the verdict is "pallas", none
    if it is "xla", and a ``tune`` record with source "cache" saying so."""
    cfg = parse_config(cli, args)
    ds = cli.load_dataset(cfg)
    t0 = time.perf_counter()
    res = races.race_glm_fused(cfg, ds)
    race_s = time.perf_counter() - t0
    if res.shape != tune_lib.glm_fused_signature(stack, "float32", "logistic"):
        raise AssertionError(f"{label}: raced at {res.shape}, want the stack {stack}")
    if tune_lib.get_cache().lookup(res.device_kind, "glm_fused", res.shape) != res.choice:
        raise AssertionError(f"{label}: the cache does not hold the verdict {res.choice}")
    m = math.prod(stack[:-2])
    want = {name: 0 for name in kernels.LAUNCHES}
    if res.choice == "pallas":
        want["fused_glm_grad"] = ROUNDS
    path = os.path.join(tmp, f"{label}_events.jsonl")
    shapes, restore = record_glm_shapes(kernels)
    tune_lib.reset_emitted()  # records are deduplicated per process
    try:
        with events_lib.capture(path):
            run = counted_run(cli, kernels, os.path.join(tmp, label), args, want,
                              workers=cfg.n_workers)
    finally:
        restore()
    cached = [(r["choice"], r["shape"]) for r in tune_events(path)
              if r["race"] == "glm_fused" and r["source"] == "cache"]
    if cached != [(res.choice, res.shape)]:
        raise AssertionError(f"{label}: the auto run's glm_fused records {cached}")
    if set(shapes) - {(m,) + stack[-2:]}:
        raise AssertionError(f"{label}: B1 at {sorted(set(shapes))}")
    return dict(stack=list(stack), choice=res.choice, decisive=res.decisive,
                timings_ms={k: v * 1e3 for k, v in res.timings.items()}, race_wall_s=race_s,
                launches=run["launches"], steps_per_sec=run["manifest"]["steps_per_sec"],
                lowering_records=cached, events=path)


def tune_phase(cli, kernels, tmp, both0) -> dict:
    """The tune plane on its own cache file (the script's other phases keep
    their empty one). glm_fused at the main stack [30, 3, 4400, 128] and at
    the wide cyccoded stack [3, 2, 2200, 15509]: each race's candidates'
    times and verdict, the verdict in the cache, and the 100-round auto run
    under it launching B1 exactly as the verdict says (``tuned_glm_run``).
    The deep path's block_decode and layer_coding races at 8 rounds, then
    its 100-round run with both knobs "auto": B2 once a round if
    layer_coding resolved blockwise (either decode lowering launches it),
    none if treewise, bitwise the forced run of the resolved pair.
    ``cli tune --race all``: all five races run and record a verdict (the
    ring races race the one-hop ring, a local gather, in one process). A
    chaos kill at tune_race (a subprocess of ``cli
    tune``) exits 43 with the cache's bytes unchanged; the rerun records
    the key the race keys. The warm lookup's cost in microseconds. Every
    tune record validates."""
    from erasurehead_tpu_torch import tune as tune_lib
    from erasurehead_tpu_torch.obs import events as events_lib
    from erasurehead_tpu_torch.tune import races
    from erasurehead_tpu_torch.utils import chaos as chaos_lib

    t_phase = time.perf_counter()
    prev = os.environ[tune_lib.ENV_PATH]
    cache_path = os.path.join(tmp, "tune.json")
    os.environ[tune_lib.ENV_PATH] = cache_path
    tune_lib.reset()
    tune_lib.reset_emitted()
    try:
        glm = {label: tuned_glm_run(cli, kernels, tune_lib, races, events_lib, tmp, label,
                                    args, stack)
               for label, args, stack in (("main", MAIN_ARGS, (30, 3, 4400, 128)),
                                          ("wide", WIDE_ARGS, WIDE_STACK))}

        deep_cfg = parse_config(cli, with_rounds(DEEP_AUTO_ARGS, RACE_ROUNDS))
        ds = cli.load_dataset(deep_cfg)
        deep_races = {}
        for name in ("block_decode", "layer_coding"):
            t0 = time.perf_counter()
            res = races.RACE_FNS[name](deep_cfg, ds)
            deep_races[name] = dict(choice=res.choice, decisive=res.decisive,
                                    timings_ms={k: v * 1e3 for k, v in res.timings.items()},
                                    race_wall_s=time.perf_counter() - t0, shape=res.shape)
        blockwise = deep_races["layer_coding"]["choice"] == "blockwise"
        want = {**both0, "fused_block_decode": ROUNDS if blockwise else 0}
        deep_path = os.path.join(tmp, "deep_auto_events.jsonl")
        # the layer_coding race's blockwise runs resolved block_decode
        # already; records are deduplicated per process
        tune_lib.reset_emitted()
        with events_lib.capture(deep_path):
            auto = counted_run(cli, kernels, os.path.join(tmp, "deep_auto"), DEEP_AUTO_ARGS,
                               want)
        forced_args = DEEP_AUTO_ARGS + [
            "--layer-coding", "on" if blockwise else "off",
            "--block-decode", deep_races["block_decode"]["choice"]]
        forced = counted_run(cli, kernels, os.path.join(tmp, "deep_forced"), forced_args, want)
        same = {a: auto["arts"][a].tobytes() == forced["arts"][a].tobytes() for a in ARTIFACTS}
        deep_cached = sorted((r["race"], r["choice"]) for r in tune_events(deep_path)
                             if r["source"] == "cache")

        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli.main(["tune", "--race", "all"] + TUNE_SMALL)
        race_all = out.getvalue()
        raced_kinds = {k.split("|")[1] for k in tune_lib.get_cache().decisions()}

        # the kill drill, in subprocesses of `cli tune` on this cache file
        before = open(cache_path, "rb").read()
        killed = tune_cli(TUNE_MAIN, cache_path, chaos="kill:tune_race:1")
        after_kill = open(cache_path, "rb").read()
        rerun = tune_cli(TUNE_MAIN + ["--json"], cache_path)
        rerun_out = json.loads(rerun.stdout.strip().splitlines()[-1]) if rerun.stdout else {}
        rerun_key = tune_lib.decision_key(rerun_out.get("device_kind", "?"), "glm_fused",
                                          (rerun_out.get("races", {}).get("glm_fused") or {})
                                          .get("shape", "?"))

        sig = glm["main"]["lowering_records"][0][1]
        dk = tune_lib.default_device_kind()
        n = 10000
        t0 = time.perf_counter()
        for _ in range(n):
            tune_lib.lookup("glm_fused", sig, device_kind=dk, fallback="pallas")
        lookup_us = (time.perf_counter() - t0) / n * 1e6
        t0 = time.perf_counter()
        for _ in range(n):
            tune_lib.lookup("glm_fused", sig, device_kind=tune_lib.default_device_kind("cuda"),
                            fallback="pallas")
        resolve_us = (time.perf_counter() - t0) / n * 1e6

        paths = [g["events"] for g in glm.values()] + [deep_path]
        errors = [e for p in paths for e in events_lib.validate_file(p)]
        n_records = sum(len(tune_events(p)) for p in paths)
    finally:
        os.environ[tune_lib.ENV_PATH] = prev
        tune_lib.reset()
        tune_lib.reset_emitted()
    rec = dict(
        glm_fused={k: {f: v for f, v in g.items() if f != "events"} for k, g in glm.items()},
        deep=dict(races=deep_races, rounds=RACE_ROUNDS, auto_launches=auto["launches"],
                  forced_args=forced_args[len(DEEP_AUTO_ARGS):],
                  auto_bitwise_forced=same, cached_records=deep_cached,
                  auto_steps_per_sec=auto["manifest"]["steps_per_sec"]),
        race_all_lines=[ln for ln in race_all.splitlines() if "choice=" in ln],
        race_all_recorded=sorted(raced_kinds),
        kill=dict(exit_code=killed.returncode, cache_bytes_unchanged=after_kill == before,
                  rerun_exit_code=rerun.returncode, rerun_key=rerun_key,
                  rerun_recorded=rerun_key in json.loads(open(cache_path).read())["decisions"]),
        warm_lookup_us=lookup_us, warm_resolve_us=resolve_us,
        tune_records=n_records, validation_errors=errors,
        seconds=time.perf_counter() - t_phase,
    )
    emit("tune", **rec)
    if not all(same.values()):
        raise AssertionError(f"deep auto run vs forced {forced_args}: {same}")
    if deep_cached != sorted((n, r["choice"]) for n, r in deep_races.items()
                             if n == "layer_coding" or blockwise):
        raise AssertionError(f"deep auto run resolved {deep_cached}, raced {deep_races}")
    if "SKIPPED" in race_all or not {"ring_pipeline", "stack_mode"} <= raced_kinds:
        raise AssertionError(f"race all: {race_all!r}, recorded {raced_kinds}")
    if killed.returncode != chaos_lib.KILL_EXIT or after_kill != before:
        raise AssertionError(f"kill drill: exit {killed.returncode}, cache changed "
                             f"{after_kill != before}: {killed.stderr[-2000:]}")
    if rerun.returncode != 0 or not rec["kill"]["rerun_recorded"] \
            or rerun_key.split("|", 2)[2] != sig:
        raise AssertionError(f"kill drill rerun: {rec['kill']}: {rerun.stderr[-2000:]}")
    if lookup_us >= 1000 or errors or not n_records:
        raise AssertionError(f"warm lookup {lookup_us} us, {n_records} records, {errors}")
    rec["launches_by_run"] = {**{f"tune_{k}_auto": g["launches"] for k, g in glm.items()},
                              "tune_deep_auto": auto["launches"],
                              "tune_deep_forced": forced["launches"]}
    return rec


def tune_cli(args, cache_path, chaos=None) -> subprocess.CompletedProcess:
    """``python -m erasurehead_tpu_torch.cli tune`` in a subprocess of this
    checkout, on ``cache_path``, with ERASUREHEAD_CHAOS=``chaos``."""
    env = {k: v for k, v in os.environ.items() if k != "ERASUREHEAD_CHAOS"}
    env["ERASUREHEAD_TUNE_CACHE"] = cache_path
    if chaos:
        env["ERASUREHEAD_CHAOS"] = chaos
    return subprocess.run([sys.executable, "-m", "erasurehead_tpu_torch.cli", "tune"] + args,
                          cwd=HERE, env=env, capture_output=True, text=True, timeout=300)


def draw_kernels(sampler, regime, seeds) -> int:
    """Device kernels of one sampler draw ([len(seeds), 30, 30]), counted by
    the profiler after a warm-up draw."""
    def draw():
        sampler.sample_arrivals(regime, WHATIF_ROUNDS, 30, seeds)
        torch.cuda.synchronize()

    prof, _ = profiled(draw)
    return sum(ev.count for ev in device_events(prof))


def surfaces_agree(a, b) -> float:
    """Categorical row fields equal, numeric ones within relative 1e-4;
    returns the largest relative difference."""
    worst = 0.0
    for ra, rb in zip(a.rows, b.rows, strict=True):
        for k, v in rb.items():
            if isinstance(v, float) and isinstance(ra[k], float):
                rel = abs(ra[k] - v) / max(abs(v), 1e-12)
                if rel > 1e-4:
                    raise AssertionError(f"{rb['label']} {k}: {ra[k]} vs {v}")
                worst = max(worst, rel)
            elif ra[k] != v:
                raise AssertionError(f"{rb['label']} {k}: {ra[k]!r} vs {v!r}")
    return worst


def whatif_phase(cli, kernels, tmp, both0) -> dict:
    """The what-if engine at the flagship data: approx c15, cyccoded and
    naive x exp:0.5 and adversary:8:0 at W = 30, s = 2, 8 seeds x 30 rounds
    (6 points, 48 trajectories, deduped). Under batch "auto" (saved to an
    --out directory) the 48 ride one cohort through the cohort matmul: no
    B1. Under "off" (the loss target pinned to the auto run's) each is a
    sequential train(): 1,440 B1 at [30, 4400, 128]. The two surfaces
    agree (categorical fields equal, numeric within relative 1e-4); runs/s
    of each. A 2-seed, 10-round grid on the card and on the CPU agrees the
    same way, and the sampler's blocks there within 2 ulps; the sampler's
    draw launches as many kernels for 1 seed as for 8 (the profiler's
    count). ``cli whatif`` with the same --out rehydrates bitwise and
    launches nothing. Every whatif record validates."""
    import dataclasses as dc

    from erasurehead_tpu_torch.obs import events as events_lib
    from erasurehead_tpu_torch.whatif import Surface, run_whatif, sampler
    from erasurehead_tpu_torch.whatif import spec as spec_lib

    t_phase = time.perf_counter()
    ns = dict(zip(WHATIF_FLAGS[::2], WHATIF_FLAGS[1::2]))
    grid = spec_lib.GridSpec(
        policies=spec_lib.parse_policies(ns["--policies"]),
        n_workers=spec_lib.parse_ints(ns["--workers"]),
        n_stragglers=spec_lib.parse_ints(ns["--stragglers"]),
        regimes=spec_lib.parse_regimes(ns["--regimes"]),
        n_seeds=WHATIF_SEEDS, rounds=WHATIF_ROUNDS, n_rows=132000, n_cols=128,
        model="logistic")
    out = os.path.join(tmp, "surface")
    path = os.path.join(tmp, "whatif_events.jsonl")
    shapes, restore = record_glm_shapes(kernels)
    try:
        with events_lib.capture(path):
            kernels.reset_launches()
            auto = run_whatif(grid, out_dir=out, batch="auto")
            auto_launches = dict(kernels.LAUNCHES)
            kernels.reset_launches()
            off = run_whatif(dc.replace(grid, target_loss=auto.target_loss), batch="off")
            off_launches = dict(kernels.LAUNCHES)
            files = {n: open(os.path.join(out, n), "rb").read()
                     for n in ("surface_rows.jsonl", "surface.npz")}
            kernels.reset_launches()
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                rc = cli.main(["whatif"] + WHATIF_FLAGS + ["--out", out])
            rerun_launches = dict(kernels.LAUNCHES)
    finally:
        restore()
    rehydrated = Surface.load(out)
    same_files = all(open(os.path.join(out, n), "rb").read() == b for n, b in files.items())
    max_rel_auto_off = surfaces_agree(off, auto)

    small = dc.replace(grid, n_seeds=WHATIF_CPU_SEEDS, rounds=WHATIF_CPU_ROUNDS)
    card = run_whatif(small)
    cpu = run_whatif(dc.replace(small, target_loss=card.target_loss), device="cpu")
    max_rel_cpu = surfaces_agree(card, cpu)
    ulps = {}
    for reg in grid.regimes:
        a = sampler.sample_arrivals(reg, WHATIF_ROUNDS, 30, range(WHATIF_SEEDS))
        b = sampler.sample_arrivals(reg, WHATIF_ROUNDS, 30, range(WHATIF_SEEDS), device="cpu")
        ia = a.astype(np.float32).view(np.int32).astype(np.int64)
        ib = b.astype(np.float32).view(np.int32).astype(np.int64)
        ulps[reg.tag] = int(np.abs(ia - ib).max())
    draws = {s: draw_kernels(sampler, grid.regimes[1], list(range(s))) for s in (1, WHATIF_SEEDS)}
    # the CLI's rerun logs into its --out directory
    kinds = []
    errors = []
    for p in (path, os.path.join(out, "events.jsonl")):
        errors += events_lib.validate_file(p)
        with open(p) as f:
            kinds += [r["kind"] for r in map(json.loads, f) if r["type"] == "whatif"]

    want_off = {**both0, "fused_glm_grad": WHATIF_POINTS * WHATIF_SEEDS * WHATIF_ROUNDS}
    rec = dict(
        flags=WHATIF_FLAGS, spec_hash=auto.spec_hash, target_loss=auto.target_loss,
        n_trajectories=auto.stats["n_trajectories"],
        auto=dict(launches=auto_launches, runs_per_sec=auto.stats["runs_per_sec"],
                  wall_s=auto.stats["wall_s"]),
        off=dict(launches=off_launches, runs_per_sec=off.stats["runs_per_sec"],
                 wall_s=off.stats["wall_s"],
                 b1_shapes={str(s): shapes.count(s) for s in set(shapes)}),
        max_rel_off_vs_auto=max_rel_auto_off,
        card_vs_cpu=dict(seeds=WHATIF_CPU_SEEDS, rounds=WHATIF_CPU_ROUNDS,
                         max_rel=max_rel_cpu, card_runs_per_sec=card.stats["runs_per_sec"],
                         cpu_runs_per_sec=cpu.stats["runs_per_sec"]),
        sampler_max_ulps_vs_cpu=ulps, draw_kernels_by_seeds=draws,
        rerun=dict(exit_code=rc, launches=rerun_launches, rehydrated="(rehydrated)" in
                   printed.getvalue(), files_bitwise=same_files,
                   rows_equal=rehydrated.rows == auto.rows),
        record_kinds={k: kinds.count(k) for k in sorted(set(kinds))},
        validation_errors=errors, seconds=time.perf_counter() - t_phase,
        rows=[{k: r[k] for k in ("label", "expected_time_to_target", "reach_fraction",
                                  "sim_time_per_round", "final_loss_mean")} for r in auto.rows],
    )
    emit("whatif", **rec)
    if auto_launches != both0 or off_launches != want_off:
        raise AssertionError(f"whatif launches: auto {auto_launches}, off {off_launches}")
    if set(shapes) != {DEDUPED_SHAPE} or auto.stats["n_trajectories"] != 48:
        raise AssertionError(f"whatif B1 shapes {rec['off']['b1_shapes']}")
    if max(ulps.values()) > 2 or draws[1] != draws[WHATIF_SEEDS] or not draws[1]:
        raise AssertionError(f"sampler: ulps {ulps}, draw kernels {draws}")
    if rc != 0 or rerun_launches != both0 or not all(
            (rec["rerun"]["rehydrated"], same_files, rec["rerun"]["rows_equal"])):
        raise AssertionError(f"whatif rerun: {rec['rerun']}")
    if errors or kinds.count("point") != 2 * WHATIF_POINTS or "rehydrate" not in kinds:
        raise AssertionError(f"whatif records {rec['record_kinds']}: {errors}")
    rec["launches_by_run"] = {"whatif_auto": auto_launches, "whatif_off": off_launches}
    return rec

# the telemetry phase: the run-telemetry plane on the paths above
TELEMETRY_COHORT = ("approx", "naive", "cyccoded", "avoidstragg")  # deduped: one stack
TELEMETRY_SHORT = 30  # the cohort's and the audit's rounds
TELEMETRY_STREAM_ROUNDS = 20  # the windowed run: 5 windows of 4 rounds
# steps/s of train() at the main path, telemetry off against on in
# alternating pairs (the order flips each pair), then traced runs
# (60 and 15 until PR 18, which paid so, with the sparse comparisons'
# rounds, for its ring stream windows and world-2 streamed and driver runs)
TELEMETRY_PAIRS, TELEMETRY_TRACED = 40, 10
ONE_EACH = ("run_start", "data_upload", "compile", "rounds", "decode", "run_end",
            "critical_path", "eval", "metrics")


def read_records(path) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def read_trace(trace_dir) -> list:
    """The one Chrome trace a --trace-dir run wrote (it must parse)."""
    names = [n for n in os.listdir(trace_dir) if n.endswith(".pt.trace.json")]
    if len(names) != 1:
        raise AssertionError(f"{trace_dir}: want one trace, found {names}")
    with open(os.path.join(trace_dir, names[0])) as f:
        return json.load(f)["traceEvents"]


def trace_counts(events, spans, kernels_by_tag) -> dict:
    """Host spans (record_function regions) by name and device kernel
    events by substring of their symbol."""
    host = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    dev = [e["name"] for e in events if e.get("cat") == "kernel"]
    return dict(host_spans={n: host.count(n) for n in spans},
                device_events={t: sum(t in n for n in dev) for t in kernels_by_tag},
                device_kernel_events=len(dev))


def launches_of(kernels, run) -> tuple:
    """``run()``'s result and the launches it made (counts set to 0 just
    before and read just after)."""
    kernels.reset_launches()
    out = run()
    return out, dict(kernels.LAUNCHES)


def post_loop_ms(trainer, cfg, ds) -> float:
    """A train() call's host seconds after its round loop (result assembly,
    and under a capture the records), in ms."""
    t0 = time.perf_counter()
    res = trainer.train(cfg, ds)
    total = time.perf_counter() - t0
    return (total - res.cache_info["setup_seconds"] - res.wall_time) * 1e3


def telemetry_phase(cli, kernels, experiments, tmp, both0) -> dict:
    """The run-telemetry plane (obs/, utils/tracing.py, utils/audit.py) on
    the card. The main path through the CLI three times: telemetry and
    tracing off, ``--telemetry on``, and ``--telemetry on --trace-dir``:
    100 B1 each, five artifacts bitwise the off run's, the log valid with
    one each of its run's records and ``run_end.steps_per_sec`` the run's
    own, the trace holding 100 ``eh_scan/coded_step`` and 100
    ``eh_scan/update`` host spans and B1 by its device symbols (at least
    one event and at most 100: a fresh profiler window may drop its first
    device records; the launch count is ``LAUNCHES``'). ``cli report``
    (and ``--validate``) and ``cli top`` read the log. The deep path, 20
    rounds, traced: 20 B2, ``block_decode_leaves`` device events and
    ``eh_step/decode`` spans. A four-trajectory deduped cohort at the
    flagship data, 30 rounds, captured as ``sweep --events`` captures its
    suite: one ``cohort`` record per planned cohort, four trajectory-tagged
    streams, no B1. The determinism audit at the main path, 30 rounds: the
    schedule and training replays bitwise (60 B1). A windowed streamed run
    (window 6, 20 rounds) under a capture: one ``prefetch`` record per
    staged window, the critical path's stall the prefetcher's. The
    pipelined main path, the cohort and the streamed run, each plain and
    under a capture and a trace: bitwise, the same launches. The registry's
    Prometheus text parses and holds the data-cache counters. Steps/s of
    the main runs, of train() at the main path with telemetry off and on in
    60 alternating pairs and of 15 traced runs, and the records' cost after
    the loop, with nothing asserted about speed."""
    import re

    from erasurehead_tpu_torch.obs import events as events_lib
    from erasurehead_tpu_torch.obs.exporter import render_prometheus
    from erasurehead_tpu_torch.obs.metrics import REGISTRY
    from erasurehead_tpu_torch.train import trainer
    from erasurehead_tpu_torch.utils import audit, tracing

    t_phase = time.perf_counter()
    b1 = {**both0, "fused_glm_grad": ROUNDS}
    runs = {}
    for label, extra in (("off", ["--telemetry", "off"]), ("telemetry", ["--telemetry", "on"]),
                         ("traced", ["--telemetry", "on", "--trace-dir",
                                     os.path.join(tmp, "trace_main")]),
                         ("off_again", ["--telemetry", "off"])):
        runs[label] = counted_run(cli, kernels, os.path.join(tmp, label), MAIN_ARGS + extra, b1)
    same = {a: all(r["arts"][a].tobytes() == runs["off"]["arts"][a].tobytes()
                   for r in runs.values()) for a in ARTIFACTS}
    if not all(same.values()):
        raise AssertionError(f"telemetry changed the main run's artifacts: {same}")
    if any(os.path.exists(os.path.join(tmp, k, "events.jsonl")) for k in ("off", "off_again")):
        raise AssertionError("--telemetry off wrote an event log")
    log = os.path.join(tmp, "traced", "events.jsonl")
    recs = read_records(log)
    errors = events_lib.validate_file(log)
    counts = {t: sum(r["type"] == t for r in recs) for t in ONE_EACH}
    end = next(r for r in recs if r["type"] == "run_end")
    sps = runs["traced"]["manifest"]["steps_per_sec"]
    if errors or any(n != 1 for n in counts.values()) or end["steps_per_sec"] != round(sps, 4):
        raise AssertionError(f"main log: {errors} {counts} {end['steps_per_sec']} vs {sps}")
    compile_rec = next(r for r in recs if r["type"] == "compile")
    main_trace = trace_counts(read_trace(os.path.join(tmp, "trace_main")),
                              ("eh_scan/coded_step", "eh_scan/update", "eh_step/partial_grads"),
                              ("glm_grad_onepass",))
    spans = main_trace["host_spans"]
    dev = main_trace["device_events"]
    if spans["eh_scan/coded_step"] != ROUNDS or spans["eh_scan/update"] != ROUNDS \
            or not all(1 <= n <= ROUNDS for n in dev.values()):
        raise AssertionError(f"main trace: {main_trace}")

    # the log, read back: report, report --validate, top
    printed = {}
    for key, argv in (("report", ["report", log]), ("validate", ["report", "--validate", log]),
                      ("top", ["top", log])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        if rc != 0:
            raise AssertionError(f"cli {argv[0]} exited {rc}: {buf.getvalue()[-2000:]}")
        printed[key] = buf.getvalue()
    if "approx" not in printed["report"] or "critical path" not in printed["report"] \
            or not printed["top"].startswith("erasurehead-tpu top"):
        raise AssertionError(f"report/top output: {printed['report'][-1500:]}")

    # the deep path, traced
    deep_args = with_rounds(DEEP_ARGS, LAYER_ROUNDS) + [
        "--telemetry", "on", "--trace-dir", os.path.join(tmp, "trace_deep")]
    b2 = {**both0, "fused_block_decode": LAYER_ROUNDS}
    deep = counted_run(cli, kernels, os.path.join(tmp, "deep"), deep_args, b2)
    deep_off = counted_run(cli, kernels, os.path.join(tmp, "deep_off"),
                           with_rounds(DEEP_ARGS, LAYER_ROUNDS), b2)
    if not all(deep["arts"][a].tobytes() == deep_off["arts"][a].tobytes() for a in ARTIFACTS):
        raise AssertionError("telemetry and tracing changed the deep run's artifacts")
    deep_errors = events_lib.validate_file(os.path.join(tmp, "deep", "events.jsonl"))
    deep_trace = trace_counts(read_trace(os.path.join(tmp, "trace_deep")),
                              ("eh_step/decode", "eh_scan/coded_step"),
                              ("block_decode_leaves",))
    if deep_errors or deep_trace["host_spans"]["eh_step/decode"] != LAYER_ROUNDS \
            or not 1 <= deep_trace["device_events"]["block_decode_leaves"] <= LAYER_ROUNDS:
        raise AssertionError(f"deep log/trace: {deep_errors} {deep_trace}")

    # a cohort captured as sweep --events captures its suite
    ds = cli.load_dataset(parse_config(cli, MAIN_ARGS))
    configs = {k: c for k, c in cohort_configs("deduped", (0,), TELEMETRY_SHORT).items()
               if k.split("_seed")[0] in TELEMETRY_COHORT}
    _, batched, sequential = planned(experiments, configs)
    cohort_log = os.path.join(tmp, "cohort_events.jsonl")
    with events_lib.capture(cohort_log):
        cohort = counted_compare(kernels, experiments, configs, ds, both0, batch="auto")
    crecs = read_records(cohort_log)
    cohort_recs = [r for r in crecs if r["type"] == "cohort"]
    streams = {r.get("trajectory") for r in crecs if r["type"] == "rounds"}
    cohort_errors = events_lib.validate_file(cohort_log)
    if cohort_errors or sequential or len(batched) != 1 or len(cohort_recs) != len(batched) \
            or sum(r["dispatches"] for r in cohort_recs) != len(batched) \
            or len(streams) != len(TELEMETRY_COHORT) or None in streams:
        raise AssertionError(f"cohort log: {cohort_errors} {cohort_recs} {streams}")

    # the determinism audit on the card
    audit_cfg = parse_config(cli, with_rounds(MAIN_ARGS, TELEMETRY_SHORT))
    kernels.reset_launches()
    audited = audit.audit(audit_cfg, ds, device="cuda")
    audit_launches = dict(kernels.LAUNCHES)
    if not all(audited.values()) or audit_launches != {**both0,
                                                       "fused_glm_grad": 2 * TELEMETRY_SHORT}:
        raise AssertionError(f"audit: {audited} {audit_launches}")

    # a windowed streamed run under a capture
    s_cfg = parse_config(cli, with_rounds(STREAM_ARGS, TELEMETRY_STREAM_ROUNDS)
                         + ["--stream-window", str(STREAM_WINDOW)])

    def stream_run():
        old_tempdir = tempfile.tempdir
        tempfile.tempdir = tmp  # a spilled store lands here
        try:
            return trainer.train(s_cfg, ds)
        finally:
            tempfile.tempdir = old_tempdir

    s_log = os.path.join(tmp, "stream_events.jsonl")
    with events_lib.capture(s_log):
        s_res, s_launches = launches_of(kernels, stream_run)
    srecs = read_records(s_log)
    pf = s_res.cache_info["prefetch"]
    cp = next(r for r in srecs if r["type"] == "critical_path")
    n_prefetch = sum(r["type"] == "prefetch" for r in srecs)
    stall_want = round(min(pf["blocked_s"], s_res.wall_time), 6)
    s_errors = events_lib.validate_file(s_log)
    if s_errors or n_prefetch != pf["windows"] or n_prefetch != s_res.cache_info["n_windows"] \
            or cp["components"]["prefetch_stall_s"] != stall_want \
            or s_launches != {**both0, "fused_glm_grad": TELEMETRY_STREAM_ROUNDS}:
        raise AssertionError(f"streamed log: {s_errors} {n_prefetch} {pf} {cp} {s_launches}")

    # observation only, on the card: the pipelined main path, the cohort and
    # the windowed streamed run, each plain and under a capture and a trace
    pipe_cfg = parse_config(cli, PIPE_ARGS)
    cohort_cfgs = list(configs.values())
    observed = {}
    for label, run in (("pipelined", lambda: [trainer.train(pipe_cfg, ds)]),
                       ("cohort", lambda: trainer.train_cohort(cohort_cfgs, ds)),
                       ("streamed", lambda: [stream_run()])):
        plain, plain_launches = launches_of(kernels, run)
        with events_lib.capture(os.path.join(tmp, f"{label}_observed.jsonl")), \
                tracing.device_trace(os.path.join(tmp, f"trace_{label}"), device="cuda"):
            seen, seen_launches = launches_of(kernels, run)
        bitwise = all(torch.equal(a.params_history, b.params_history)
                      and a.timeset.tobytes() == b.timeset.tobytes()
                      and a.worker_times.tobytes() == b.worker_times.tobytes()
                      and a.collected.tobytes() == b.collected.tobytes()
                      for a, b in zip(plain, seen))
        observed[label] = dict(launches=plain_launches, observed_launches=seen_launches,
                               bitwise=bitwise, run_ids=sorted({r.run_id for r in seen}))
        if not bitwise or plain_launches != seen_launches or None in observed[label]["run_ids"]:
            raise AssertionError(f"{label} under telemetry and a trace: {observed[label]}")

    # the records' cost after the loop: train() with and without a capture
    main_cfg = parse_config(cli, MAIN_ARGS)
    post_off = [post_loop_ms(trainer, main_cfg, ds) for _ in range(3)]
    with events_lib.capture(os.path.join(tmp, "post_events.jsonl")):
        post_on = [post_loop_ms(trainer, main_cfg, ds) for _ in range(3)]

    # steps/s, off against on in alternating pairs, then traced
    pairs = {"off": [], "on": [], "traced": []}
    pair_log = os.path.join(tmp, "pair_events.jsonl")
    for i in range(TELEMETRY_PAIRS):
        for side in (("off", "on") if i % 2 == 0 else ("on", "off")):
            sink = events_lib.capture(pair_log, mode="a") if side == "on" \
                else contextlib.nullcontext()
            with sink:
                pairs[side].append(trainer.train(main_cfg, ds).steps_per_sec)
    for i in range(TELEMETRY_TRACED):
        with tracing.device_trace(os.path.join(tmp, f"trace_pair_{i}"), device="cuda"):
            pairs["traced"].append(trainer.train(main_cfg, ds).steps_per_sec)
    pair_stats = {k: dict(median=float(np.median(v)), q1=float(np.percentile(v, 25)),
                          q3=float(np.percentile(v, 75)), runs=v) for k, v in pairs.items()}
    pair_stats["on_wins"] = sum(b > a for a, b in zip(pairs["off"], pairs["on"]))

    prom = render_prometheus(REGISTRY)
    bad = [ln for ln in prom.splitlines() if ln and not ln.startswith("# TYPE ")
           and not re.fullmatch(r"[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? \S+", ln)]
    if bad or "erasurehead_sweep_cache_data_hits" not in prom:
        raise AssertionError(f"prometheus text: {bad[:5]}")

    rec = dict(
        steps_per_sec={k: r["manifest"]["steps_per_sec"] for k, r in runs.items()},
        artifacts_bitwise_off=same, record_counts=counts,
        compile=dict(seconds=compile_rec["seconds"], cache_hit=compile_rec["cache_hit"]),
        main_trace=main_trace, report_lines=len(printed["report"].splitlines()),
        deep_trace=deep_trace, deep_launches=deep["launches"],
        deep_steps_per_sec={"traced": deep["manifest"]["steps_per_sec"],
                            "off": deep_off["manifest"]["steps_per_sec"]},
        observed=observed,
        cohort=dict(records=[{k: r[k] for k in ("n_trajectories", "schemes", "dispatches",
                                                 "lowering")} for r in cohort_recs],
                    planned_cohorts=len(batched), streams=sorted(streams),
                    launches=cohort["launches"]),
        audit={k: dict(bitwise_equal=v.bitwise_equal, max_abs_diff=v.max_abs_diff)
               for k, v in audited.items()},
        audit_launches=audit_launches,
        streamed=dict(prefetch_records=n_prefetch, windows=pf["windows"],
                      blocked_s=pf["blocked_s"], prefetch_stall_s=stall_want,
                      launches=s_launches),
        post_loop_ms=dict(off=post_off, on=post_on,
                          records_ms=min(post_on) - min(post_off)),
        paired_steps_per_sec=pair_stats,
        prometheus_lines=len(prom.splitlines()),
        seconds=time.perf_counter() - t_phase,
    )
    emit("telemetry", **rec)
    rec["launches_by_run"] = {f"telemetry_{k}": r["launches"] for k, r in runs.items()}
    rec["launches_by_run"].update(
        telemetry_deep=deep["launches"], telemetry_deep_off=deep_off["launches"],
        **{f"telemetry_{k}_{side}": o[key] for k, o in observed.items()
           for side, key in (("plain", "launches"), ("observed", "observed_launches"))},
                                  telemetry_cohort=cohort["launches"],
                                  telemetry_audit=audit_launches,
                                  telemetry_streamed=s_launches)
    return rec


# the serve phase: the daemon at the flagship data on the card
SERVE_SCHEMES = (("approx", 15), ("repcoded", None))  # one faithful stack: FRC's assignment
SERVE_TENANTS = 4
ADMIT_ROUNDS, LOAD_ROUNDS, DRILL_ROUNDS = 30, 30, 20
LOAD_TENANTS, LOAD_JOBS, LOAD_DEPTH, LOAD_MAX_PENDING = ("la", "lb", "lc"), 12, 4, 8


def serve_science(summary) -> str:
    """A row's science columns (the journal row without the run-local
    ``real_steps_per_sec`` and ``cache``), canonical JSON."""
    from erasurehead_tpu_torch.train import journal as journal_lib

    return json.dumps(journal_lib.science_row(journal_lib.summary_payload(summary)),
                      sort_keys=True)


def wire_science(row) -> str:
    from erasurehead_tpu_torch.train import journal as journal_lib

    return json.dumps(journal_lib.science_row(row), sort_keys=True)


def served(srv, specs, ds, timeout=900) -> dict:
    """Submit ``(tenant, label, cfg)`` specs from one thread per tenant at
    once; every row must come back ``ok``. Returns label -> ServeResult."""
    import threading

    handles, lock = [], threading.Lock()

    def client(tenant):
        for tn, label, cfg in specs:
            if tn == tenant:
                h = srv.submit(tenant=tn, label=label, config=cfg, dataset=ds)
                with lock:
                    handles.append(h)

    threads = [threading.Thread(target=client, args=(t,)) for t in sorted({s[0] for s in specs})]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    rows = {h.result(timeout=timeout).label: h.result() for h in handles}
    bad = {label: (r.status, r.error) for label, r in rows.items() if r.status != "ok"}
    if bad or len(rows) != len(specs):
        raise AssertionError(f"serve rows not ok: {bad} ({len(rows)} of {len(specs)})")
    return rows


def alone_rows(server, specs, ds, max_cohort) -> dict:
    """Each spec dispatched alone (column 0 of its own padded dispatch)."""
    with server.serving(device="cuda", max_cohort=max_cohort, window_s=0.001) as srv:
        rows = {label: srv.submit(tenant=tn, label=label, config=cfg, dataset=ds).result(
            timeout=900) for tn, label, cfg in specs}
    bad = {label: r.status for label, r in rows.items() if r.status != "ok"}
    if bad:
        raise AssertionError(f"rows dispatched alone not ok: {bad}")
    return rows


def pack_columns(path) -> dict:
    """label -> (dispatch id, column) from a log's pack records."""
    return {label: (r["dispatch_id"], i)
            for r in (json.loads(line) for line in open(path))
            if r["type"] == "pack" for i, label in enumerate(r["labels"])}


def spawn_daemon(args, env, log_lines):
    """``cli serve --device cuda`` in a subprocess, its output drained into
    ``log_lines`` by a thread; returns the process and a function that waits
    until it listens (or fails if it exits first)."""
    import threading

    proc = subprocess.Popen([sys.executable, "-m", "erasurehead_tpu_torch.cli", "serve",
                             "--device", "cuda", *args],
                            cwd=HERE, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    listening, t_spawn, boot = threading.Event(), time.perf_counter(), []

    def drain():
        for line in proc.stdout:
            log_lines.append(line.rstrip())
            if line.startswith("serve: listening on"):
                boot.append(time.perf_counter() - t_spawn)
                listening.set()

    threading.Thread(target=drain, daemon=True).start()

    def wait(timeout=600):
        """Block until the daemon listens; returns its boot seconds (spawn
        to the listening line: interpreter, card, kernel library)."""
        deadline = time.monotonic() + timeout
        while not listening.wait(0.1):
            if proc.poll() is not None or time.monotonic() > deadline:
                raise AssertionError(f"cli serve exited {proc.poll()} before listening: "
                                     f"{log_lines[-20:]}")
        return boot[0]

    return proc, wait


def serve_phase(cli, kernels, tmp, both0, ds) -> dict:
    """The serve daemon (serve/) on the card, at the flagship data (132,000
    x 128 GMM, W = 30, s = 2, approx collect 15, AGD, faithful), one
    resolved dataset object for the in-process daemons:

      1. packing: four tenants on four threads submit two GLM requests each
         (approx c15 and repcoded, whose faithful stacks are one, seeds
         varying, 100 rounds) to ``serving(device="cuda", max_cohort=8,
         dispatch_workers=2)``, twice (the second set, other seeds, timed
         warm): fewer dispatches than requests, no B1 (the cohort matmul),
         every first-set row ok and bitwise the row of the same request
         dispatched alone through a second daemon (column 0 there, other
         columns here), and each row's training loss within relative 1e-4
         of the same config's sequential train() on the card (100 B1 each);
         the packed and sequential aggregate steps/s;
      2. B1 through the daemon: a ``use_pallas="on"`` request at the main
         config beside a packed cohort: exactly 100 B1, all at
         [90, 4400, 128], its loss curve and clock bitwise a direct
         train()'s on the same dataset object, replayed as the daemon does;
      3. B2 through the daemon: four deepmlp layer-coded requests (DEEP_ARGS,
         20 rounds) from two tenants, max_cohort 4: one dispatch, 20 B2, rows
         ok and bitwise each one dispatched alone (20 B2 each);
      4. admission: a budget of 1.5 x one GLM cohort's estimate, two cohorts
         of different stacks (approx and cyccoded, 30 rounds): the second is
         deferred while the first runs and admitted after it released, by an
         eviction of the data cache's pins; each signature's estimate, its
         measured peak and their ratio;
      5. the fronts under load: an HttpFront and loadgen.run_fleet (three
         closed-loop tenants, 12 requests each, 4 in flight, 30 rounds,
         ``max_pending`` 8 so some submissions get 429): no loss, no
         duplicate, every row ok; ``GET /metrics`` parses and holds the
         ``serve.*`` counters; ``cli top http://...`` renders a frame;
         time-to-first-row p50/p99, goodput, 429s;
      6. the kill drill: ``cli serve --device cuda --cache-dir C`` in a
         subprocess (started after the timed steps 1-2 and waited for
         before the timed step 5: its boot and its nvcc build into C
         overlap only the untimed steps 3-4 and the serve daemon across
         ranks (:func:`serve_ranks_phase`, which times nothing; its record
         is this one's ``serve_ranks``), so ``cold_boot_s`` is a boot under
         that contention) under
         ERASUREHEAD_CHAOS=kill:serve_dispatch:1 takes
         3 requests and exits 43; restarted on the same journal and C it
         replays its WAL (the restart record splits it), the resubmissions'
         rows are bitwise an uninterrupted daemon's, and C's files are
         unchanged (no build);
      7. every log of the phase validates; ``cli report`` renders the serve
         section.
    """
    import contextlib
    import dataclasses
    import io
    import signal

    from erasurehead_tpu_torch.obs import events as events_lib
    from erasurehead_tpu_torch.obs.metrics import REGISTRY
    from erasurehead_tpu_torch.serve import loadgen, packer, server
    from erasurehead_tpu_torch.serve import queue as serve_queue
    from erasurehead_tpu_torch.serve.client import ServeClient
    from erasurehead_tpu_torch.serve.http_front import HttpFront
    from erasurehead_tpu_torch.train import cache as cache_lib
    from erasurehead_tpu_torch.train import trainer
    from erasurehead_tpu_torch.utils import chaos

    t_phase = time.perf_counter()
    base = parse_config(cli, MAIN_ARGS)

    def dispatches():
        return REGISTRY.counter("serve.dispatches").value

    # 1. packing
    specs = [(f"t{k}", f"{scheme}_{k}", dataclasses.replace(
        base, scheme=scheme, num_collect=nc, seed=k + 10 * i))
        for k in range(SERVE_TENANTS) for i, (scheme, nc) in enumerate(SERVE_SCHEMES)]
    keys = {packer.pack_key(serve_queue.RunRequest(tenant="x", label="x", config=c, dataset=ds))
            for _, _, c in specs}
    pack_log = os.path.join(tmp, "serve_pack.jsonl")
    kernels.reset_launches()
    d0 = dispatches()
    # the same eight again with other seeds, timed warm (the first pass pays
    # the daemon's first dispatch: new threads, the stack upload)
    warm_specs = [(tn, f"warm_{label}", dataclasses.replace(cfg, seed=cfg.seed + 100))
                  for tn, label, cfg in specs]
    with events_lib.capture(pack_log):
        with server.serving(device="cuda", max_cohort=8, dispatch_workers=2,
                            window_s=0.5) as srv:
            t0 = time.perf_counter()
            packed = served(srv, specs, ds)
            cold_wall = time.perf_counter() - t0
            t0 = time.perf_counter()
            warm_rows = served(srv, warm_specs, ds)
            packed_wall = time.perf_counter() - t0
    packed_launches, packed_dispatches = dict(kernels.LAUNCHES), dispatches() - d0
    if packed_launches != both0 or not packed_dispatches < 2 * len(specs):
        raise AssertionError(f"packing: {packed_dispatches} dispatches for {len(specs)} "
                             f"requests, launches {packed_launches}")
    columns = pack_columns(pack_log)
    if not any(col for _, col in columns.values()):
        raise AssertionError(f"no request packed beyond column 0: {columns}")
    kernels.reset_launches()
    alone = alone_rows(server, specs, ds, 8)
    alone_launches = dict(kernels.LAUNCHES)
    differ = [label for label in packed
              if serve_science(alone[label].summary) != serve_science(packed[label].summary)]
    if differ or alone_launches != both0:
        raise AssertionError(f"packed rows differ from alone: {differ} ({alone_launches})")
    kernels.reset_launches()
    seq_rel, seq_wall, seq_loop = {}, 0.0, 0.0
    for _, label, cfg in specs:
        # timed with its replay, as the daemon's row is (its eval replay)
        t0 = time.perf_counter()
        res = trainer.train(cfg, ds)
        loss = replayed_loss(res, ds)
        seq_wall += time.perf_counter() - t0
        seq_loop += res.wall_time
        seq_rel[label] = max_rel(packed[label].summary.training_loss, loss)
    seq_launches = dict(kernels.LAUNCHES)
    if max(seq_rel.values()) > 1e-4 or seq_launches != {
            **both0, "fused_glm_grad": ROUNDS * len(specs)}:
        raise AssertionError(f"packed vs sequential train(): {seq_rel}, {seq_launches}")
    warm_cache = next(iter(warm_rows.values())).summary.cache
    emit("serve_pack", requests=2 * len(specs), pack_keys=len(keys),
         dispatches=packed_dispatches,
         columns=columns, launches=packed_launches, alone_launches=alone_launches,
         sequential_launches=seq_launches, rows_bitwise_alone=True,
         max_rel_loss_vs_sequential=max(seq_rel.values()),
         cold_wall_s=cold_wall, packed_wall_s=packed_wall, sequential_wall_s=seq_wall,
         warm_setup_s=warm_cache["setup_seconds"],
         # the first set pays the daemon's first dispatch (new threads, the
         # stack upload): end to end and its round loop
         cold_aggregate_steps_per_sec=ROUNDS * len(specs) / cold_wall,
         cold_loop_steps_per_sec=sorted({r.summary.real_steps_per_sec
                                         for r in packed.values()}),
         packed_aggregate_steps_per_sec=ROUNDS * len(specs) / packed_wall,
         sequential_aggregate_steps_per_sec=ROUNDS * len(specs) / seq_wall,
         # the round loops alone: the cohort's R * B / wall (B = 8, no pad)
         # against R * 8 over the eight train() loops' seconds
         cohort_loop_steps_per_sec=sorted({r.summary.real_steps_per_sec
                                           for r in warm_rows.values()}),
         sequential_loop_steps_per_sec=ROUNDS * len(specs) / seq_loop)

    # 2. B1 through the daemon, beside a packed cohort
    fused_cfg = dataclasses.replace(base, use_pallas="on")
    beside = [("p", f"beside_{k}", dataclasses.replace(base, seed=20 + k)) for k in range(4)]
    b1_log = os.path.join(tmp, "serve_b1.jsonl")
    shapes, restore = record_glm_shapes(kernels)
    kernels.reset_launches()
    try:
        with events_lib.capture(b1_log):
            with server.serving(device="cuda", max_cohort=8, dispatch_workers=2,
                                window_s=0.5) as srv:
                b1_rows = served(srv, beside + [("b1", "fused", fused_cfg)], ds)
    finally:
        restore()
    b1_launches = dict(kernels.LAUNCHES)
    packs = [json.loads(line) for line in open(b1_log)]
    packs = [r for r in packs if r["type"] == "pack"]
    if (b1_launches != {**both0, "fused_glm_grad": ROUNDS} or set(shapes) != {MAIN_SHAPE}
            or sorted(p["batchable"] for p in packs) != [False, True]):
        raise AssertionError(f"B1 through the daemon: {b1_launches}, {set(shapes)}, {packs}")
    kernels.reset_launches()
    direct = trainer.train(fused_cfg, ds)
    direct_launches = dict(kernels.LAUNCHES)
    got = b1_rows["fused"].summary
    same = (got.training_loss.tobytes() == replayed_loss(direct, ds).tobytes()
            and got.timeset.tobytes() == direct.timeset.tobytes())
    if not same or direct.lowering != "fused":
        raise AssertionError("the daemon's forced-kernel row is not a direct train()'s bitwise")
    emit("serve_b1", launches=b1_launches, shapes=[list(s) for s in sorted(set(shapes))],
         dispatch_ids=[p["dispatch_id"] for p in packs], direct_launches=direct_launches,
         bitwise_direct_train=same, steps_per_sec=got.real_steps_per_sec)

    # 6, started here: the daemon's boot and its nvcc build into its own
    # directory (CPU-heavy) overlap the untimed steps 3-4, never a timing
    drill_dir = os.path.join(tmp, "drill")
    jdir, cdir = os.path.join(drill_dir, "journal"), os.path.join(drill_dir, "build")
    sock, drill_log = os.path.join(drill_dir, "s.sock"), os.path.join(drill_dir, "events.jsonl")
    os.makedirs(drill_dir)
    daemon_args = ["--socket", sock, "--journal-dir", jdir, "--cache-dir", cdir,
                   "--events", drill_log, "--window-ms", "200"]
    env = {k: v for k, v in os.environ.items() if k != chaos.CHAOS_ENV}
    drill_out: list = []
    killed, killed_listening = spawn_daemon(
        daemon_args, {**env, chaos.CHAOS_ENV: "kill:serve_dispatch:1"}, drill_out)

    # 3. B2 through the daemon: a packed deep cohort
    deep_base = parse_config(cli, with_rounds(DEEP_ARGS, LAYER_ROUNDS))
    deep_specs = [(f"d{k % 2}", f"deep{k}", dataclasses.replace(deep_base, seed=k))
                  for k in range(4)]
    kernels.reset_launches()
    d0 = dispatches()
    with server.serving(device="cuda", max_cohort=4, window_s=0.5) as srv:
        deep_rows = served(srv, deep_specs, ds)
    deep_launches, deep_dispatches = dict(kernels.LAUNCHES), dispatches() - d0
    kernels.reset_launches()
    deep_alone = alone_rows(server, deep_specs, ds, 4)
    deep_alone_launches = dict(kernels.LAUNCHES)
    differ = [label for label in deep_rows if serve_science(deep_alone[label].summary)
              != serve_science(deep_rows[label].summary)]
    want_alone = {**both0, "fused_block_decode": LAYER_ROUNDS * len(deep_specs)}
    if (deep_launches != {**both0, "fused_block_decode": LAYER_ROUNDS} or deep_dispatches != 1
            or differ or deep_alone_launches != want_alone):
        raise AssertionError(f"deep cohort: {deep_launches}, {deep_dispatches} dispatches, "
                             f"differ {differ}, alone {deep_alone_launches}")
    emit("serve_deep", launches=deep_launches, dispatches=deep_dispatches,
         alone_launches=deep_alone_launches, rows_bitwise_alone=True)

    # 4. admission under a budget of 1.5 cohorts
    from erasurehead_tpu_torch.serve import admission

    a_specs = [("a", f"adm_approx{k}", dataclasses.replace(base, rounds=ADMIT_ROUNDS, seed=k))
               for k in range(4)]
    b_specs = [("b", f"adm_cyc{k}", dataclasses.replace(base, rounds=ADMIT_ROUNDS, seed=k,
                                                         scheme="cyccoded", num_collect=None))
               for k in range(4)]
    cohorts = {name: packer.plan_packs([serve_queue.RunRequest(tenant=t, label=label, config=c,
                                                               dataset=ds)
                                        for t, label, c in sp])[0]
               for name, sp in (("approx", a_specs), ("cyccoded", b_specs))}
    est = {name: admission.estimate_cohort_bytes(c, width=4) for name, c in cohorts.items()}
    budget = int(1.5 * est["approx"])
    adm_log = os.path.join(tmp, "serve_admission.jsonl")
    cache_lib.drop_data_cache()  # the first cohort uploads its stack (a measured miss)
    kernels.reset_launches()
    with events_lib.capture(adm_log):
        with server.serving(device="cuda", budget_bytes=budget, max_cohort=4,
                            window_s=0.5) as srv:
            served(srv, a_specs + b_specs, ds)
            measured = {name: srv.admission.measured_bytes(c.key_digest)
                        for name, c in cohorts.items()}
    adm_launches = dict(kernels.LAUNCHES)
    recs = [json.loads(line) for line in open(adm_log)]
    # the verdicts in order: T admitted, F deferred, e an eviction. The
    # first cohort admits; the second defers while it runs, then admits
    # once it released, after an eviction of the data cache's pins
    trail = "".join("e" if r["type"] == "evict" else "TF"[not r["admitted"]]
                    for r in recs if r["type"] in ("admit", "evict"))
    if (not trail.startswith("T") or "F" not in trail or not trail.endswith("eT")
            or any(m is None for m in measured.values()) or adm_launches != both0):
        raise AssertionError(f"admission trail {trail}, measured {measured}, "
                             f"launches {adm_launches}")
    emit("serve_admission", budget_bytes=budget, trail=trail,
         footprint={name: dict(est_bytes=est[name], measured_peak_bytes=measured[name],
                               est_over_peak=est[name] / measured[name])
                    for name in est},
         launches=adm_launches)

    # the drill daemon listens before the timed step 5 starts; the serve
    # daemon across ranks runs while it builds
    try:
        ranks_rec = serve_ranks_phase(cli, kernels, tmp, both0)
    except BaseException:
        killed.kill()
        killed.wait()
        raise
    t0 = time.perf_counter()
    cold_boot_s = killed_listening()
    drill_wait_s = time.perf_counter() - t0

    # 5. the HTTP front under closed-loop load
    payload = serve_queue.config_payload(dataclasses.replace(base, rounds=LOAD_ROUNDS))
    if payload is None:
        raise AssertionError("the main config has no wire payload")
    jobs = {t: [(f"{t}{k}", {**payload, "seed": k}) for k in range(LOAD_JOBS)]
            for t in LOAD_TENANTS}
    load_log = os.path.join(tmp, "serve_load.jsonl")
    kernels.reset_launches()
    with events_lib.capture(load_log):
        with server.serving(device="cuda", max_cohort=8, max_pending=LOAD_MAX_PENDING,
                            window_s=0.05) as srv:
            front = HttpFront(srv)
            try:
                t0 = time.perf_counter()
                load = loadgen.run_fleet(front.host, front.port, jobs,
                                         concurrency=LOAD_DEPTH, timeout=600)
                load_wall = time.perf_counter() - t0
                import urllib.request

                with urllib.request.urlopen(f"http://{front.host}:{front.port}/metrics",
                                            timeout=30) as resp:
                    prom = resp.read().decode()
                top_out = io.StringIO()
                with contextlib.redirect_stdout(top_out):
                    top_rc = cli.main(["top", f"http://{front.host}:{front.port}"])
            finally:
                front.close()
    load_launches = dict(kernels.LAUNCHES)
    ledgers = load["tenants"].values()
    statuses = {r["status"] for led in ledgers for r in led["rows_by_label"].values()}
    prom_names = {line.split("{")[0].split(" ")[0] for line in prom.splitlines()
                  if line and not line.startswith("#")}
    bad_lines = []
    for line in prom.splitlines():
        if line and not line.startswith("#"):
            try:
                float(line.rsplit(" ", 1)[1])
            except (IndexError, ValueError):
                bad_lines.append(line)
    want_names = {"erasurehead_serve_requests", "erasurehead_serve_dispatches",
                  "erasurehead_serve_rejected", "erasurehead_serve_results"}
    if (load["lost"] or load["duplicates"] or statuses != {"ok"}
            or any(led["rejected_final"] or led["rows"] != LOAD_JOBS for led in ledgers)
            or not load["rejected_429s"] or bad_lines or not want_names <= prom_names
            or top_rc != 0 or "erasurehead_serve_requests" not in top_out.getvalue()
            or load_launches != both0):
        raise AssertionError(f"load: lost {load['lost']}, dups {load['duplicates']}, "
                             f"statuses {statuses}, 429s {load['rejected_429s']}, "
                             f"prom missing {want_names - prom_names}, top {top_rc}, "
                             f"launches {load_launches}")
    rows_total = sum(led["rows"] for led in ledgers)
    emit("serve_load", tenants=len(jobs), requests=rows_total,
         ttfr_p50_s=load["latency_p50_s"], ttfr_p99_s=load["latency_p99_s"],
         ttlr_p99_s=load["ttlr_p99_s"], goodput_rows_per_s=rows_total / load_wall,
         rejected_429s=load["rejected_429s"], retries=load["retries"], wall_s=load_wall,
         prometheus_lines=len(prom.splitlines()), launches=load_launches)

    # 6. the kill drill: accepted requests survive the daemon's death
    drill_cfgs = {f"k{k}": dataclasses.replace(base, rounds=DRILL_ROUNDS, seed=k)
                  for k in range(3)}
    wire = {label: serve_queue.config_payload(c) for label, c in drill_cfgs.items()}
    client = ServeClient(sock)
    for label, p in wire.items():
        client.submit("drill", label, p)
    killed_rc = killed.wait(timeout=600)
    client.close()
    files_cold = sorted(os.listdir(cdir))
    if killed_rc != chaos.KILL_EXIT or not any(f.endswith(".so") for f in files_cold):
        raise AssertionError(f"kill drill: exit {killed_rc}, build dir {files_cold}, "
                             f"{drill_out[-20:]}")
    drill_out.append("-- restart --")
    warm, warm_listening = spawn_daemon(daemon_args, env, drill_out)
    warm_boot_s = warm_listening()
    try:
        client = ServeClient(sock)
        rids = {client.submit("drill", label, p): label for label, p in wire.items()}
        wire_rows = {}
        for _ in rids:
            res = client.result(timeout=600)
            wire_rows[rids[res["request_id"]]] = res
        client.close()
        warm.send_signal(signal.SIGINT)
        warm_rc = warm.wait(timeout=120)
    finally:
        if warm.poll() is None:
            warm.kill()
            warm.wait()
    with server.serving(device="cuda", window_s=0.2) as srv:
        clean = {label: srv.submit(tenant="drill", label=label, config=c, dataset=ds).result(
            timeout=900) for label, c in drill_cfgs.items()}
    restart = [json.loads(line) for line in open(drill_log)]
    restart = [r for r in restart if r["type"] == "restart"]
    differ = [label for label in wire if wire_rows[label]["status"] != "ok"
              or wire_science(wire_rows[label]["row"]) != serve_science(clean[label].summary)]
    files_warm = sorted(os.listdir(cdir))
    if (warm_rc != 0 or differ or files_warm != files_cold or len(restart) != 1
            or restart[0]["wal_records"] != len(wire)
            or restart[0]["rehydrated"] + restart[0]["resubmitted"] != len(wire)):
        raise AssertionError(f"restart: exit {warm_rc}, rows differ {differ}, build dir "
                             f"{files_cold} -> {files_warm}, restart {restart}, "
                             f"{drill_out[-20:]}")
    emit("serve_drill", killed_exit=killed_rc, restart_exit=warm_rc,
         restart={k: restart[0][k] for k in ("wal_records", "rehydrated", "resubmitted")},
         build_files=files_cold, build_files_unchanged=True, rows_bitwise_uninterrupted=True,
         cold_boot_s=cold_boot_s, drill_wait_s=drill_wait_s, warm_boot_s=warm_boot_s)

    # 7. every log validates; the report's serve section
    journals = [os.path.join(jdir, t, "sweep_journal.jsonl") for t in os.listdir(jdir)
                if os.path.isdir(os.path.join(jdir, t))]
    logs = [pack_log, b1_log, adm_log, load_log, drill_log,
            os.path.join(jdir, "intake_wal.jsonl")] + journals
    invalid = {p: events_lib.validate_file(p)[:3] for p in logs if events_lib.validate_file(p)}
    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        report_rc = cli.main(["report", load_log, "--validate"])
    if invalid or report_rc != 0 or "serve (multi-tenant cohort packing)" not in report.getvalue():
        raise AssertionError(f"serve logs: invalid {invalid}, report rc {report_rc}")
    seconds = time.perf_counter() - t_phase
    emit("serve", seconds=seconds, logs_valid=len(logs))
    return dict(
        seconds=seconds,
        packed_aggregate_steps_per_sec=ROUNDS * len(specs) / packed_wall,
        sequential_aggregate_steps_per_sec=ROUNDS * len(specs) / seq_wall,
        cohort_loop_steps_per_sec=max(r.summary.real_steps_per_sec
                                      for r in warm_rows.values()),
        sequential_loop_steps_per_sec=ROUNDS * len(specs) / seq_loop,
        est_over_peak={name: est[name] / measured[name] for name in est},
        ttfr_p50_s=load["latency_p50_s"], ttfr_p99_s=load["latency_p99_s"],
        launches_by_run={"serve_packed": packed_launches, "serve_alone": alone_launches,
                         "serve_sequential": seq_launches, "serve_b1": b1_launches,
                         "serve_b1_direct": direct_launches, "serve_deep": deep_launches,
                         "serve_deep_alone": deep_alone_launches,
                         "serve_admission": adm_launches, "serve_load": load_launches},
        serve_ranks=ranks_rec,
    )


# the daemon across ranks: two gloo ranks of this script on the one card
# under torchrun, wire requests on rank 0's socket
SERVE_RANKS_ROUNDS, SERVE_RANKS_COHORT, SERVE_RANKS_WINDOW_S = 20, 4, 0.5
SERVE_RANKS_WIRE = (  # (label, RunConfig fields over MAIN_ARGS's): two pack, one alone
    ("approx_s0", dict(compute_mode="deduped")),
    ("approx_s1", dict(compute_mode="deduped", seed=1)),
    ("fused", dict(use_pallas="on", seed=2)),  # faithful, forced B1: sequential train()
)
SERVE_RANKS_TIMEOUT_S = 600
#: the one-process daemon's rows against a local compare() (tests/test_torch_serve.py)
SERVE_RANKS_TOL = dict(rtol=2e-5, atol=1e-6)


def serve_ranks_wire(cli) -> list:
    """``(label, wire payload)`` of SERVE_RANKS_WIRE."""
    from erasurehead_tpu_torch.serve import queue as serve_queue

    base = parse_config(cli, with_rounds(MAIN_ARGS, SERVE_RANKS_ROUNDS))
    out = []
    for label, kw in SERVE_RANKS_WIRE:
        payload = serve_queue.config_payload(dataclasses.replace(base, **kw))
        if payload is None:
            raise AssertionError(f"{label}: the wire cannot carry {kw}")
        out.append((label, payload))
    return out


def serve_child(out_dir: str) -> int:
    """One rank of the serve daemon across ranks (``torchrun --standalone
    --nproc-per-node 2 chip_smoke.py --serve-child DIR``): gloo on the card,
    both ranks on cuda:0. Rank 0 serves SERVE_RANKS_WIRE through its socket
    front to a client in its own process, then stops the daemon, which
    releases rank 1; rank 1 follows rank 0's dispatches. Each rank's
    launches (rank 0's rows too) into ``DIR/rank<r>.json``; both leave the
    group cleanly (parallel/backend.joined)."""
    import torch.distributed as dist

    cli, kernels = import_port()
    from erasurehead_tpu_torch.parallel import backend
    from erasurehead_tpu_torch.serve import server
    from erasurehead_tpu_torch.serve.client import ServeClient

    with backend.joined(device="cuda", backend="gloo", local_rank=0):
        rank = dist.get_rank()
        kernels.load_library()  # built by the parent in this checkout: no nvcc here
        kernels.reset_launches()
        rec = {"rank": rank, "world": dist.get_world_size()}
        t0 = time.perf_counter()
        if rank == 0:
            srv = server.SweepServer(device="cuda", max_cohort=SERVE_RANKS_COHORT,
                                     window_s=SERVE_RANKS_WINDOW_S)
            srv.start()
            sock = os.path.join(out_dir, "serve.sock")
            try:
                front = server.SocketFront(srv, sock)
                try:
                    client = ServeClient(sock)
                    for label, payload in serve_ranks_wire(cli):
                        client.submit("t", label, payload, timeout=120)
                    rows = [client.result(timeout=SERVE_RANKS_TIMEOUT_S)
                            for _ in SERVE_RANKS_WIRE]
                    client.close()
                finally:
                    front.close()
            finally:
                srv.stop()
            rec["rows"] = {r["label"]: r for r in rows}
        else:
            rec["followed"] = server.SweepServer(device="cuda").follow()
        rec["seconds"] = time.perf_counter() - t0
        rec["launches"] = dict(kernels.LAUNCHES)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(rec, f)
    return 0


def serve_ranks_phase(cli, kernels, tmp, both0) -> dict:
    """The serve daemon across two ranks on the card: ``torchrun
    --standalone --nproc-per-node 2`` of :func:`serve_child`, which must
    exit 0 (both ranks did); every wire row ok and equal to the row of a
    one-process daemon on the card served the same requests at the same
    width (statuses, clocks and decode error exactly, losses within
    SERVE_RANKS_TOL); B1 launched on both ranks, SERVE_RANKS_ROUNDS times
    each (the forced-kernel request's rounds on the rank's [45, 4400, 128]
    slice), and rank 1 followed both dispatches."""
    from erasurehead_tpu_torch.serve import queue as serve_queue
    from erasurehead_tpu_torch.serve import server
    from erasurehead_tpu_torch.train import journal as journal_lib

    t_phase = time.perf_counter()
    out_dir = os.path.join(tmp, "serve_ranks")
    os.makedirs(out_dir)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "2", os.path.abspath(__file__), "--serve-child", out_dir]
    proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                          timeout=SERVE_RANKS_TIMEOUT_S)
    children_s = time.perf_counter() - t_phase
    if proc.returncode != 0:
        raise AssertionError(f"serve ranks exited {proc.returncode}: "
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    ranks = [json.load(open(os.path.join(out_dir, f"rank{r}.json"))) for r in range(2)]
    wire = serve_ranks_wire(cli)
    kernels.reset_launches()
    with server.serving(device="cuda", max_cohort=SERVE_RANKS_COHORT,
                        window_s=SERVE_RANKS_WINDOW_S) as srv:
        handles = {label: srv.submit(tenant="t", label=label,
                                     config=serve_queue.config_from_payload(payload))
                   for label, payload in wire}
        one = {label: h.result(timeout=900) for label, h in handles.items()}
    one_launches = dict(kernels.LAUNCHES)
    rows, worst = {}, 0.0
    for label, payload in wire:
        got, want = ranks[0]["rows"][label], one[label]
        if got["status"] != "ok" or want.status != "ok":
            raise AssertionError(f"serve ranks {label}: {got['status']} {got.get('error')}, "
                                 f"one process {want.status} {want.error}")
        g = journal_lib.rehydrate_summary(got["row"], want.summary.config)
        w = want.summary
        same = (g.sim_total_time == w.sim_total_time and g.timeset.tobytes() == w.timeset.tobytes()
                and g.decode_error_mean == w.decode_error_mean)
        rel = max_rel(g.training_loss, w.training_loss)
        worst = max(worst, rel)
        rows[label] = dict(control_plane_equal=same, max_rel_loss=rel,
                           within_tol=bool(np.allclose(g.training_loss, w.training_loss,
                                                       **SERVE_RANKS_TOL)),
                           final_train_loss=[g.final_train_loss, w.final_train_loss])
    b1 = [r["launches"].get("fused_glm_grad", 0) for r in ranks]
    rec = dict(requests=[label for label, _ in wire], rows=rows, max_rel_loss=worst,
               launches_by_rank=[r["launches"] for r in ranks], one_process_launches=one_launches,
               followed=ranks[1]["followed"], rank_seconds=[r["seconds"] for r in ranks],
               children_s=children_s, seconds=time.perf_counter() - t_phase)
    emit("serve_ranks", **rec)
    bad = {label: r for label, r in rows.items()
           if not (r["control_plane_equal"] and r["within_tol"])}
    if bad:
        raise AssertionError(f"serve rows across ranks differ from one process: {bad}")
    if b1 != [SERVE_RANKS_ROUNDS, SERVE_RANKS_ROUNDS] or ranks[1]["followed"] != 2:
        raise AssertionError(f"serve ranks launched B1 {b1}, rank 1 followed "
                             f"{ranks[1]['followed']} dispatches")
    rec["launches_by_run"] = {f"serve_ranks_rank{r}": ranks[r]["launches"] for r in range(2)}
    return rec


# the fleet phase: serve replicas on the card behind the router
FLEET_ROUNDS, FLEET_K, FLEET_MAX_COHORT = 20, 3, 8
FLEET_GLM = (("fa", (0, 1, 2)), ("fb", (3, 4)))  # tenant -> seeds of the packed GLM set
# the deploy's load: closed-loop batches of the same 4 tenants x
# FLEET_LOAD_JOBS, until a batch ends after the deploy is done (the last
# batch's requests reach the bounced replicas)
FLEET_LOAD_TENANTS, FLEET_LOAD_JOBS, FLEET_LOAD_DEPTH = ("la", "lb", "lc", "ld"), 4, 2
FLEET_LOAD_MAX_BATCHES = 200
# the goodput window: this many fleet_specs sets back to back (seeds moved
# by 100 + 10 k, below the survivors' warm-up set's 300: no row is served
# from a journal), a few seconds at either fleet size
FLEET_GOODPUT_SETS = 2
# the deep path as the wire carries it: ``block_decode`` is not a wire field
# (the JAX protocol's), so the request leaves it at auto; on the card the
# decode is B2 either way (``deep``'s treewise run launches it too)
_BD = DEEP_ARGS.index("--block-decode")
FLEET_DEEP_ARGS = DEEP_ARGS[:_BD] + DEEP_ARGS[_BD + 2:]


def fleet_specs(cli, shift=0) -> list:
    """The fleet's request set, ``(tenant, label, RunConfig)``: a packed GLM
    set (approx c15, FLEET_ROUNDS rounds, two tenants), one
    ``use_pallas="on"`` request at the main config (B1 at [90, 4400, 128]
    once a round) and one deep request (FLEET_DEEP_ARGS, LAYER_ROUNDS
    rounds: B2 once a round). ``shift`` moves every seed (a new digest each
    set, so no row rehydrates from a journal)."""
    base = parse_config(cli, with_rounds(MAIN_ARGS, FLEET_ROUNDS))
    deep = parse_config(cli, with_rounds(FLEET_DEEP_ARGS, LAYER_ROUNDS))
    specs = [(t, f"glm_s{s + shift}", dataclasses.replace(base, seed=s + shift))
             for t, seeds in FLEET_GLM for s in seeds]
    specs.append(("fb1", f"fused_{shift}", dataclasses.replace(base, use_pallas="on",
                                                                seed=shift)))
    specs.append(("fdeep", f"deep_{shift}", dataclasses.replace(deep, seed=shift)))
    return specs


def fleet_clients(host, port, tenants) -> tuple:
    """One HttpServeClient a tenant on the router, and the count of raw
    result lines their streams carried by request_id (before the clients'
    dedup)."""
    from erasurehead_tpu_torch.serve.client import HttpServeClient

    raw: dict = {}

    def on_line(msg):
        if msg.get("type") == "result":
            raw[msg["request_id"]] = raw.get(msg["request_id"], 0) + 1

    return {t: HttpServeClient(host, port, t, on_line=on_line) for t in tenants}, raw


def fleet_serve(host, port, specs, grace_s=1.0, timeout=600, clients=None) -> dict:
    """Submit ``specs`` through the router, one HttpServeClient a tenant
    (``clients``, a fleet_clients pair, to reuse; else new ones, closed at
    the end), and wait for every row; then ``grace_s`` more for any
    duplicate. Rows must be ok. Returns rows by label, the deliveries the
    clients made (deduplicated by request_id, as a caller sees them), the
    raw result lines the streams carried, and the wall from the first
    submit to the last row."""
    from erasurehead_tpu_torch.serve import queue as serve_queue

    own = clients is None
    if own:
        clients = fleet_clients(host, port, sorted({t for t, _, _ in specs}))
    clients, raw = clients
    raw_before = sum(raw.values())
    try:
        payloads = {label: serve_queue.config_payload(cfg) for _, label, cfg in specs}
        if any(p is None for p in payloads.values()):
            raise AssertionError(f"configs with no wire payload: {payloads}")
        t0 = time.perf_counter()
        for t, label, _ in specs:
            clients[t].submit(label, payloads[label], max_retries=16)
        rows, delivered = {}, 0
        deadline = time.monotonic() + timeout
        for t, c in clients.items():
            want = {label for tn, label, _ in specs if tn == t}
            while want - set(rows):
                if time.monotonic() > deadline:
                    raise AssertionError(f"fleet rows missing: {sorted(want - set(rows))}")
                try:
                    res = c.result(timeout=5)
                except Exception:  # noqa: BLE001 — queue.Empty while a peer adopts
                    continue
                rows[res["label"]] = res
                delivered += 1
        wall = time.perf_counter() - t0
        end = time.monotonic() + grace_s
        for c in clients.values():
            while time.monotonic() < end:
                try:
                    c.result(timeout=max(0.05, end - time.monotonic()))
                    delivered += 1
                except Exception:  # noqa: BLE001 — nothing more is the success case
                    break
    finally:
        if own:
            for c in clients.values():
                c.close()
    bad = {label: r.get("status") for label, r in rows.items() if r.get("status") != "ok"}
    if bad or len(rows) != len(specs):
        raise AssertionError(f"fleet rows not ok: {bad} ({len(rows)} of {len(specs)})")
    return dict(rows=rows, delivered=delivered, raw_lines=sum(raw.values()) - raw_before,
                wall_s=wall)


def fleet_goodput(cli, host, port) -> dict:
    """FLEET_GOODPUT_SETS fleet_specs sets back to back through the router
    (one client a tenant for the whole window; each set submitted once
    the last one's rows are in): aggregate steps/s and rows/s over the
    window, from the first submit to the last row, and each set's wall."""
    sets = [fleet_specs(cli, shift=100 + 10 * k) for k in range(FLEET_GOODPUT_SETS)]
    clients = fleet_clients(host, port, sorted({t for t, _, _ in sets[0]}))
    try:
        t0 = time.perf_counter()
        served_sets = [fleet_serve(host, port, specs, grace_s=0, clients=clients)
                       for specs in sets]
        wall = time.perf_counter() - t0
    finally:
        for c in clients[0].values():
            c.close()
    walls = [x["wall_s"] for x in served_sets]
    resumed = [label for x in served_sets for label, r in x["rows"].items() if r.get("resumed")]
    if resumed:
        raise AssertionError(f"goodput rows served from a journal: {resumed}")
    steps = sum(cfg.rounds for specs in sets for _, _, cfg in specs)
    rows = sum(len(specs) for specs in sets)
    return dict(wall_s=wall, sets=len(sets), requests=rows, steps=steps,
                aggregate_steps_per_sec=steps / wall, rows_per_sec=rows / wall,
                set_wall_s_min=min(walls), set_wall_s_max=max(walls))


def slowest_served(events_paths, labels) -> dict | None:
    """Of ``labels``, the request with the longest span from its first
    intake record to its ``done`` record across the replicas' event logs
    (wall clock, ms): which replica accepted it, when, when a cohort took
    it (its ``pack`` record), which replica finished it, and what the
    accepting replica packed and finished meanwhile."""
    seen: dict = {}
    recs = {name: [json.loads(line) for line in open(path)]
            for name, path in events_paths.items()}
    for name, rs in recs.items():
        for r in rs:
            if r["type"] == "pack":
                for label in set(r["labels"]) & labels:
                    got = seen.setdefault(label, {})
                    got["pack"] = min(got.get("pack", (r["t"], name)), (r["t"], name))
            if r["type"] != "request" or r.get("label") not in labels:
                continue
            got = seen.setdefault(r["label"], {})
            key = "done" if r.get("phase") == "done" else "intake"
            got[key] = min(got.get(key, (r["t"], name)), (r["t"], name))
    spans = {label: g["done"][0] - g["intake"][0] for label, g in seen.items()
             if "done" in g and "intake" in g}
    if not spans:
        return None
    label = max(spans, key=spans.get)
    g = seen[label]
    (t_in, by), t_done = g["intake"], g["done"][0]
    between = [r for r in recs[by] if t_in < r["t"] < t_done]
    return dict(label=label, span_s=spans[label], accepted_by=by, accepted_t=t_in,
                packed_t=g.get("pack", (None,))[0], finished_by=g["done"][1],
                finished_t=t_done,
                packs_meanwhile=sum(r["type"] == "pack" for r in between),
                done_meanwhile=sum(r["type"] == "request" and r.get("phase") == "done"
                                   for r in between),
                other_records_meanwhile=sorted({r["type"] for r in between} - {"pack", "request"}))


def fleet_phase(cli, kernels, tmp, both0, ds) -> dict:
    """The serve fleet (serve/router.py, serve/fleet.py) on the card, at the
    flagship data (132,000 x 128 GMM, W = 30, s = 2, f32): every replica a
    ``cli serve --device cuda`` process with ``--max-cohort 8``, its
    ``--cache-dir`` the build directory this process loaded the kernel
    library from (no replica runs nvcc: the directory's files are the same
    after the phase), each replica's data generated in its own process.

      1. one replica (the baseline): the fleet_specs set through the router
         (five packed GLM requests from two tenants, a use_pallas="on"
         request, a deep request); every row ok and bitwise the same
         request's row from an in-process daemon on the card (max_cohort 8:
         the same dispatch; the forced-kernel request is
         experiments._train_one there), whose launches are exactly 30 B1
         at [90, 4400, 128] and 20 B2; the replica's compile records are
         its CUDA-graph programs (train/graphs.py: captures and hits; the
         build directory's unchanged files show it built no kernel); then
         the same set
         FLEET_GOODPUT_SETS times back to back with other seeds, timed
         (the one-replica goodput);
      2. three replicas and a kill: ``kill:fleet_replica:2`` armed on the
         replica the ring routes tenant fa to; fa's first request is
         served, the next two are accepted and the replica dies in its
         second dispatch (exit 43); the supervisor declares it dead at a
         streak >= K = 3, the next replica in its ring order adopts its
         WAL, and every row reaches fa exactly once through the router,
         bitwise step 1's; death-to-adoption seconds;
      3. rolling deploy under load on the two survivors: batches of the
         same four closed-loop tenants (4 requests each, 2 in flight,
         FLEET_ROUNDS rounds) through the router while rolling_deploy()
         bounces both, until a batch ends after the deploy is done: no
         loss, no duplicate, every row ok; the
         slowest request's accepting replica and times beside the deploy's
         phases;
      4. goodput: step 1's timed sets through the two survivors (after a
         warm-up set); every replica's boot seconds. Recorded, not
         gated.

    Every replica's and the supervisor's records pass the validator, which
    refuses an early death.
    """
    import threading

    from erasurehead_tpu_torch.obs import events as events_lib
    from erasurehead_tpu_torch.serve import loadgen, server
    from erasurehead_tpu_torch.serve import queue as serve_queue
    from erasurehead_tpu_torch.serve.fleet import FleetSupervisor
    from erasurehead_tpu_torch.serve.router import HashRing, affinity_key
    from erasurehead_tpu_torch.utils import chaos

    t_phase = time.perf_counter()
    build_dir = str(kernels.library_path().parent)
    files_before = sorted(os.listdir(build_dir))
    extra = ("--max-cohort", str(FLEET_MAX_COHORT), "--dispatch-workers", "1")
    env_chaos = os.environ.pop(chaos.CHAOS_ENV, None)
    if env_chaos is not None:
        raise AssertionError(f"{chaos.CHAOS_ENV} is set in the smoke's environment")
    specs = fleet_specs(cli)

    # 1. one replica: the baseline rows and the one-replica goodput
    one = FleetSupervisor(n=1, base_dir=os.path.join(tmp, "one"), k=FLEET_K,
                          probe_interval_s=0.3, cache_dir=build_dir, device="cuda",
                          extra_args=extra)
    one.start()
    try:
        baseline = fleet_serve(one.router.host, one.router.port, specs)
        goodput_one = fleet_goodput(cli, one.router.host, one.router.port)
    finally:
        one.stop()
    boot_one = one.replicas["r0"].boot_s
    compiles = [json.loads(line) for line in open(one.replicas["r0"].events_path)]
    compiles = [r for r in compiles if r["type"] == "compile"]
    shapes, restore = record_glm_shapes(kernels)
    kernels.reset_launches()
    try:
        with server.serving(device="cuda", max_cohort=FLEET_MAX_COHORT, dispatch_workers=1,
                            window_s=0.05) as srv:
            ref = served(srv, specs, ds)
    finally:
        restore()
    ref_launches = dict(kernels.LAUNCHES)
    want_launches = {**both0, "fused_glm_grad": FLEET_ROUNDS, "fused_block_decode": LAYER_ROUNDS}
    differ = [label for label, r in baseline["rows"].items()
              if wire_science(r["row"]) != serve_science(ref[label].summary)]
    if (differ or baseline["delivered"] != len(specs) or ref_launches != want_launches
            or set(shapes) != {MAIN_SHAPE} or not compiles
            or any(r["memory_analysis"]["executor"] != "graph" for r in compiles)):
        raise AssertionError(f"one-replica fleet: rows differ {differ}, delivered "
                             f"{baseline['delivered']}, in-process {ref_launches} at "
                             f"{set(shapes)}, compile records {compiles[:3]}")
    emit("fleet_one", replicas=1, requests=len(specs), rows_bitwise_in_process=True,
         in_process_launches=ref_launches, b1_shapes=[list(s) for s in sorted(set(shapes))],
         graph_captures=sum(not r["cache_hit"] for r in compiles),
         graph_hits=sum(r["cache_hit"] for r in compiles), boot_s=boot_one, goodput=goodput_one)

    # 2. three replicas; the one fa routes to dies in its second dispatch
    fa = [(t, label, cfg) for t, label, cfg in specs if t == "fa"]
    victim = HashRing(["r0", "r1", "r2"]).lookup(
        affinity_key("fa", serve_queue.config_payload(fa[0][2])))
    sup_log = os.path.join(tmp, "supervisor.jsonl")
    with events_lib.capture(sup_log):
        sup = FleetSupervisor(n=3, base_dir=os.path.join(tmp, "three"), k=FLEET_K,
                              probe_interval_s=0.3, cache_dir=build_dir, device="cuda",
                              chaos={victim: "kill:fleet_replica:2"}, extra_args=extra)
        sup.start()
        try:
            boots = {name: rep.boot_s for name, rep in sup.replicas.items()}
            survivors = sorted(set(sup.replicas) - {victim})
            adopter = HashRing(survivors).lookup(victim)
            vrep = sup.replicas[victim]
            marks = {}

            def watch():
                while "adopted" not in marks and time.monotonic() < deadline:
                    if "death" not in marks and vrep.proc.poll() is not None:
                        marks["death"] = time.monotonic()
                    if os.path.exists(vrep.wal_path + ".adopted"):
                        marks["adopted"] = time.monotonic()
                    time.sleep(0.005)

            deadline = time.monotonic() + 600
            watcher = threading.Thread(target=watch, daemon=True)
            watcher.start()
            # one client for fa throughout: the adopter replays the dead
            # WAL's first (finished) acceptance too, under its request_id,
            # which the client has delivered already
            fa_clients = fleet_clients(sup.router.host, sup.router.port, ["fa"])
            try:
                first = fleet_serve(sup.router.host, sup.router.port, fa[:1], grace_s=0,
                                    clients=fa_clients)
                rest = fleet_serve(sup.router.host, sup.router.port, fa[1:], grace_s=3.0,
                                   clients=fa_clients)
            finally:
                fa_clients[0]["fa"].close()
            watcher.join(timeout=60)
            rows = {**first["rows"], **rest["rows"]}
            if "adopted" not in marks:
                raise AssertionError(f"no adoption of {victim}'s WAL: {marks}")
            differ = [label for label, r in rows.items()
                      if wire_science(r["row"]) != wire_science(baseline["rows"][label]["row"])]
            victim_rc = vrep.proc.poll()
            if (differ or victim_rc != chaos.KILL_EXIT or victim not in sup._dead_handled
                    or first["delivered"] + rest["delivered"] != len(fa)
                    or "adopted" not in marks):
                raise AssertionError(f"kill: victim {victim} exit {victim_rc}, rows differ "
                                     f"{differ}, delivered {first['delivered']} + "
                                     f"{rest['delivered']}, marks {marks}")

            # 3. rolling deploy under closed-loop load through the router:
            # batches of closed-loop requests until one ends after the
            # deploy is done
            payload = serve_queue.config_payload(fa[0][2])
            deploy: dict = {}
            deployed = threading.Event()

            def do_deploy():
                time.sleep(1.0)  # the load is going first
                try:
                    deploy.update(sup.rolling_deploy())
                finally:
                    deployed.set()

            batches, window_rows = [], None
            t0 = time.perf_counter()
            deployer = threading.Thread(target=do_deploy)
            deployer.start()
            while window_rows is None:
                b = len(batches)
                if b >= FLEET_LOAD_MAX_BATCHES:
                    raise AssertionError(f"deploy load: {b} batches, window rows {window_rows}")
                # the same tenants in every batch: a restarted replica's WAL
                # replay republishes earlier batches' rows to their streams,
                # which a batch's ledger skips (not its request ids)
                jobs = {t: [(f"{t}{b}_{k}", {**payload, "seed": 1000 + 4096 * b + 64 * i + k})
                            for k in range(FLEET_LOAD_JOBS)]
                        for i, t in enumerate(FLEET_LOAD_TENANTS)}
                batches.append(loadgen.run_fleet(
                    sup.router.host, sup.router.port, jobs, concurrency=FLEET_LOAD_DEPTH,
                    max_retries=16, timeout=120))
                if deployed.is_set():
                    window_rows = sum(led["rows"] for o in batches
                                      for led in o["tenants"].values())
            load_wall = time.perf_counter() - t0
            deployer.join(timeout=600)
            ledgers = [led for o in batches for led in o["tenants"].values()]
            statuses = {r["status"] for led in ledgers for r in led["rows_by_label"].values()}
            load = {k: sum(o[k] for o in batches) for k in ("lost", "duplicates")}
            load["rejected_429s"] = sum(led["rejected_429s"] for led in ledgers)
            lat = [x for led in ledgers for x in led["latencies_s"]]
            load["latency_p50_s"] = loadgen.percentile(lat, 50)
            load["latency_p99_s"] = loadgen.percentile(lat, 99)
            short = [{k: led.get(k) for k in ("tenant", "accepted", "rows", "lost",
                                              "rejected_final", "client_error")}
                     for led in ledgers if led["rows"] != FLEET_LOAD_JOBS]
            if (deployer.is_alive() or load["lost"] or load["duplicates"] or statuses != {"ok"}
                    or sorted(deploy) != survivors or short
                    or len(ledgers) != len(batches) * len(FLEET_LOAD_TENANTS)):
                raise AssertionError(f"rolling deploy: {deploy}, lost {load['lost']}, dups "
                                     f"{load['duplicates']}, statuses {statuses}, short {short}")
            rebooted = {name: sup.replicas[name].boot_s for name in survivors}

            # 4. the same sets through the two survivors, after a warm-up set
            fleet_serve(sup.router.host, sup.router.port, fleet_specs(cli, shift=300),
                        grace_s=0)
            goodput_two = fleet_goodput(cli, sup.router.host, sup.router.port)
        finally:
            sup.stop()
    recs = [json.loads(line) for line in open(sup_log)]
    deaths = [r for r in recs if r["type"] == "fleet" and r["action"] == "declare_dead"]
    phases = {(r["replica"], r.get("phase")) for r in recs
              if r["type"] == "fleet" and r["action"] == "deploy_phase"}
    adopts = {name: [r for r in map(json.loads, open(sup.replicas[name].events_path))
                     if r["type"] == "fleet" and r["action"] == "adopt"]
              for name in survivors}
    logs = [sup_log] + [rep.events_path for rep in sup.replicas.values()] + [
        one.replicas["r0"].events_path]
    invalid = {p: events_lib.validate_file(p)[:3] for p in logs if events_lib.validate_file(p)}
    files_after = sorted(os.listdir(build_dir))
    if (invalid or [r["replica"] for r in deaths] != [victim]
            or deaths[0]["streak"] < FLEET_K or [len(adopts[n]) for n in survivors]
            != [int(n == adopter) for n in survivors]
            or adopts[adopter][0]["records"] < 1
            or any((n, p) not in phases for n in survivors for p in ("drain", "stop", "ready"))
            or files_after != files_before):
        raise AssertionError(f"fleet records: invalid {invalid}, deaths {deaths}, adopter "
                             f"{adopter} adopts {adopts}, deploy phases {sorted(phases)}, "
                             f"build dir {files_before} -> {files_after}")
    emit("fleet_kill", replicas=3, victim=victim, victim_exit=victim_rc, adopter=adopter,
         declare_dead_streak=deaths[0]["streak"], k=FLEET_K,
         adopted_records=adopts[adopter][0]["records"], rows_bitwise_one_replica=True,
         delivered=first["delivered"] + rest["delivered"],
         raw_result_lines=first["raw_lines"] + rest["raw_lines"],
         death_to_adoption_s=marks["adopted"] - marks["death"], boot_s=boots)
    load_labels = {label for led in ledgers for label in led["rows_by_label"]}
    slowest = slowest_served({n: sup.replicas[n].events_path for n in survivors}, load_labels)
    deploy_t = {f"{r['replica']}_{r['phase']}": r["t"] for r in recs
                if r["type"] == "fleet" and r["action"] == "deploy_phase"}
    emit("fleet_deploy", survivors=survivors, deploy=deploy, load_wall_s=load_wall,
         requests=sum(led["rows"] for led in ledgers), window_rows=window_rows,
         batches=len(batches), lost=load["lost"],
         duplicates=load["duplicates"], rejected_429s=load["rejected_429s"],
         ttfr_p50_s=load["latency_p50_s"], ttfr_p99_s=load["latency_p99_s"],
         boot_s_after_bounce=rebooted, slowest=slowest, deploy_phase_t=deploy_t)
    goodput = {"one_replica": goodput_one, "two_survivors": goodput_two}
    seconds = time.perf_counter() - t_phase
    emit("fleet", seconds=seconds, goodput=goodput, build_files=files_after,
         build_files_unchanged=True, logs_valid=len(logs), card=card_line(),
         # the rows' real_steps_per_sec are shared-device figures: every
         # replica's loop runs on the one card, time-sliced with its peers
         note="row real_steps_per_sec is per replica on a shared card")
    return dict(seconds=seconds, goodput=goodput, boot_s={"one": boot_one, **boots},
                death_to_adoption_s=marks["adopted"] - marks["death"],
                deploy_load_wall_s=load_wall, launches_by_run={"fleet_in_process": ref_launches})


# the native phase: the text loader's cold parse at a reference shape
NATIVE_ROWS, NATIVE_COLS = 13500, 100


def native_phase(tmp) -> dict:
    """The native text parser (data/native) on the card's host: a 13,500 x
    100 dense text matrix written with np.savetxt (``%.18g``) parsed
    natively and with np.loadtxt, bitwise equal, both timed; then a cold
    ``data/io.load_dense_text`` of it takes the native path (its counter
    rises, the fallback's does not)."""
    from erasurehead_tpu_torch.data import io as data_io
    from erasurehead_tpu_torch.data import native

    t_phase = time.perf_counter()
    m = np.random.default_rng(0).standard_normal((NATIVE_ROWS, NATIVE_COLS))
    path = os.path.join(tmp, "native.dat")
    t0 = time.perf_counter()
    data_io.save_dense_text(path, m)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lib = native.get_lib()
    build_s = time.perf_counter() - t0
    if lib is None:
        raise AssertionError("the native parser did not build (g++)")
    native.reset_counts()
    t0 = time.perf_counter()
    got = native.load_dense_text_native(path)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = np.loadtxt(path, dtype=np.float64)
    loadtxt_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got2 = native.load_dense_text_native(path)
    native_s2 = time.perf_counter() - t0
    before = dict(native.COUNTS)
    cold = data_io.load_dense_text(path)
    after = dict(native.COUNTS)
    bitwise = (got is not None and got.shape == want.shape == m.shape
               and got.tobytes() == want.tobytes() == got2.tobytes() == m.tobytes()
               and np.asarray(cold).tobytes() == want.tobytes())
    if (not bitwise or after["native"] != before["native"] + 1
            or after["fallback"] != before["fallback"]):
        raise AssertionError(f"native parse: bitwise {bitwise}, counts {before} -> {after}")
    seconds = time.perf_counter() - t_phase
    rec = dict(shape=[NATIVE_ROWS, NATIVE_COLS], bytes=os.path.getsize(path),
               native_s=[native_s, native_s2], loadtxt_s=loadtxt_s,
               loadtxt_over_native=loadtxt_s / min(native_s, native_s2), build_s=build_s,
               write_s=write_s, bitwise_loadtxt=True, counts=after, seconds=seconds)
    emit("native", **rec)
    return rec


# the mesh phase: the worker axis across processes (parallel/mesh.py,
# parallel/backend.py). (a) a world of one process on the card under NCCL;
# (b) two processes on the one card under gloo (NCCL refuses two ranks on
# one GPU), each holding 15 of the 30 workers: B1 at [45, 4400, 128]
MESH_SHAPE = (45, 4400, 128)
MESH_VARIANTS = (  # (name, RunConfig fields): the transports of the main path
    ("materialized", {}),
    ("ring_off", {"stack_mode": "ring", "ring_pipeline": "off"}),
    ("ring_on", {"stack_mode": "ring", "ring_pipeline": "on"}),
)
MESH_SHORT = 20  # rounds of the world-2 train_dynamic and measured-cluster runs
# the model-internal axes in the same two processes: each family at its
# default widths (mlp hidden 64; deepmlp hidden 32, 4 layers; moe hidden 16,
# 4 experts; attention d_in 8, d_model 16, 2 heads) at 2 shards on the
# (workers 1, axis 2) mesh, on the flagship data, with its update rule of the
# deep and attention phases (GD lr 0.5; AGD at the preset's lr 10)
AXES_ROUNDS = 3
_AXES_GD = with_rounds(DEEP_ARGS[:DEEP_ARGS.index("--model")], AXES_ROUNDS)
_AXES_ATTN = with_rounds(MAIN_ARGS, AXES_ROUNDS) + ["--model", "attention"]
AXES_RUNS = (  # (name, flags)
    ("tp_mlp", _AXES_GD + ["--model", "mlp", "--tp-shards", "2"]),
    ("pp_deepmlp", _AXES_GD + ["--model", "deepmlp", "--pp-shards", "2"]),
    ("ep_moe", _AXES_GD + ["--model", "moe", "--ep-shards", "2"]),
    ("seq_ring", _AXES_ATTN + ["--seq-shards", "2", "--sp-form", "ring"]),
    ("seq_ulysses", _AXES_ATTN + ["--seq-shards", "2", "--sp-form", "ulysses"]),
)
AXES_GRAD_TOL = dict(rtol=2e-4, atol=2e-5)  # the JAX package's tests/test_train.py
DEEP_DECODE_FLOATS = sum(DEEP_LEAVES)  # a deep round's decoded gradient, 8,385 floats
MESH_CHILD_TIMEOUT_S = 600


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def counted_library_run(kernels, fn) -> tuple:
    """``fn()``'s result and the launches it made (counts set to 0 just
    before, read just after a synchronise)."""
    kernels.reset_launches()
    res = fn()
    torch.cuda.synchronize()
    return res, dict(kernels.LAUNCHES)


def all_reduce_us(mesh, sizes=(MAIN_SHAPE[2], DEEP_DECODE_FLOATS), reps=200) -> dict:
    """Microseconds of one ``mesh.all_reduce`` of a float32 vector on the
    card, synchronised around ``reps`` calls after a warm-up: the GLM
    round's [128] gradient and the deep round's 8,385 decoded floats."""
    out = {}
    for n in sizes:
        t = torch.zeros(n, device="cuda")
        for _ in range(10):
            mesh.all_reduce(t)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            mesh.all_reduce(t)
        torch.cuda.synchronize()
        out[str(n)] = (time.perf_counter() - t0) / reps * 1e6
    return out


def _history_leaves(res) -> list:
    h = res.params_history
    return [h[k] for k in sorted(h)] if isinstance(h, dict) else [h]


def _bitwise_runs(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(_history_leaves(a), _history_leaves(b)))


@contextlib.contextmanager
def first_gradient(trainer):
    """Observe a run's first decoded gradient: the grad fn the trainer
    resolves (trainer._grad_lowering) is wrapped to keep a copy of its first
    result, a dict of leaves. Yields the dict it fills under ``"g"``."""
    resolve, box = trainer._grad_lowering, {}

    def lowering(*args, **kw):
        fn, name = resolve(*args, **kw)

        def grad(*a):
            g = fn(*a)
            box.setdefault("g", {k: v.detach().clone() for k, v in g.items()})
            return g

        return grad, name

    trainer._grad_lowering = lowering
    try:
        yield box
    finally:
        trainer._grad_lowering = resolve


def axis_share(trace_path: str) -> dict:
    """Host seconds of a traced run's rounds (``eh_scan/*`` spans) and of the
    axis collectives inside them (``eh_axis/*``, forward and backward), from
    its Chrome trace."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    dur = lambda prefix: sum(e.get("dur", 0) for e in events
                             if str(e.get("name", "")).startswith(prefix)) / 1e6
    rounds, axis = dur("eh_scan/"), dur("eh_axis/")
    return dict(round_s=rounds, axis_s=axis, share=axis / rounds if rounds else None)


def model_axes_child(cli, kernels, ds) -> tuple:
    """The AXES_RUNS in this rank of the world-2 group: each run's params
    history and first decoded gradient, its launches, steps/s, peak device
    bytes above the run's start, and the share of a traced round's time
    spent in the axis collectives."""
    from erasurehead_tpu_torch.train import trainer
    from erasurehead_tpu_torch.utils import tracing

    t0 = time.perf_counter()
    rec, hist = {}, {}
    for name, args in AXES_RUNS:
        cfg = parse_config(cli, args)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with first_gradient(trainer) as box:
            res, launches = counted_library_run(kernels, lambda: trainer.train(cfg, ds))
        peak = torch.cuda.max_memory_allocated() - base
        for k, v in res.params_history.items():
            hist[f"axes/{name}/{k}"] = v.cpu().numpy()
        for k, v in box["g"].items():
            hist[f"axes_g0/{name}/{k}"] = v.cpu().numpy()
        with tempfile.TemporaryDirectory(prefix="eh-chip-smoke-axes-") as tdir:
            # host spans only: the collectives block the host under gloo
            with tracing.device_trace(tdir, device="cpu") as trace:
                trainer.train(dataclasses.replace(cfg, rounds=1), ds)
            share = axis_share(trace.path)
        rec[name] = dict(launches=launches, steps_per_sec=res.steps_per_sec, peak_bytes=peak,
                         lowering=res.lowering, collectives=share)
    rec["seconds"] = time.perf_counter() - t0
    return rec, hist


def model_axes_check(cli, kernels, ds, ranks, hists, both0) -> dict:
    """The parent's half of ``model_axes``: the unsharded card runs of
    AXES_RUNS from the same params (the port's seeded init), their first
    decoded gradients against rank 0's, the ranks' histories bitwise, the
    replayed loss falling, 0 B1 / 0 B2 a rank."""
    from erasurehead_tpu_torch.train import trainer

    out, bad = {}, []
    for name, args in AXES_RUNS:
        cfg = parse_config(cli, args)
        plain = dataclasses.replace(cfg, tp_shards=1, pp_shards=1, ep_shards=1, seq_shards=1)
        with first_gradient(trainer) as box:
            ref, ref_launches = counted_library_run(kernels, lambda: trainer.train(plain, ds))
        keys = sorted(ref.params_history)
        bitwise = all(np.array_equal(hists[0][f"axes/{name}/{k}"], hists[1][f"axes/{name}/{k}"])
                      for k in keys)
        grad_err = {}
        for k in keys:
            got, want = hists[0][f"axes_g0/{name}/{k}"], box["g"][k].cpu().numpy()
            grad_err[k] = float(np.max(np.abs(got - want) / (AXES_GRAD_TOL["atol"]
                                                             + AXES_GRAD_TOL["rtol"] * np.abs(want))))
        sharded = dataclasses.replace(ref, params_history={
            k: torch.from_numpy(hists[0][f"axes/{name}/{k}"]).cuda() for k in keys})
        loss = replayed_loss(sharded, ds)
        launches = [r["model_axes"][name]["launches"] for r in ranks]
        out[name] = dict(
            ranks_bitwise=bitwise, grad_err_over_tol=max(grad_err.values()),
            loss_first_last=[float(loss[0]), float(loss[-1])],
            unsharded_loss_last=float(replayed_loss(ref, ds)[-1]),
            unsharded_steps_per_sec=ref.steps_per_sec, launches=launches,
            steps_per_sec=[r["model_axes"][name]["steps_per_sec"] for r in ranks],
            peak_bytes=[r["model_axes"][name]["peak_bytes"] for r in ranks],
            collectives=[r["model_axes"][name]["collectives"] for r in ranks],
        )
        if not bitwise or out[name]["grad_err_over_tol"] > 1.0 or not loss[-1] < loss[0] \
                or any(v != both0 for v in launches) or ref_launches != both0:
            bad.append(name)
    if bad:
        raise AssertionError(f"model_axes runs failed their checks: {bad}: {out}")
    return out


# streamed windows and the drivers over train() across ranks, in the same two
# processes: each rank stages its share of every window from one store the
# parent writes (the flagship data); STREAM_MESH_ROUNDS rounds a run
STREAM_MESH_ROUNDS = 20
STREAM_MESH_RUNS = (  # (name, flags, B1's [M, R, F] on a rank)
    ("dedup", set_flag(with_rounds(STREAM_ARGS, STREAM_MESH_ROUNDS), "--compute-mode", "deduped")
     + ["--stream-window", str(STREAM_WINDOW)], (3, 4400, 128)),  # 3 of the 6 partitions
    ("mat", with_rounds(STREAM_ARGS, STREAM_MESH_ROUNDS) + ["--stream-window", str(STREAM_WINDOW)],
     (9, 4400, 128)),  # 3 of the 6 workers, 3 slots each
    ("ring", with_rounds(HALO_ARGS, STREAM_MESH_ROUNDS) + ["--stack-mode", "ring"],
     (15, 4400, 128)),  # 6 of the 12 staged partitions, 5 of the 10 workers' slots
)
MESH_ADAPT_CHUNK = 5
# naive (every worker awaited): a dead worker costs failover rounds at the
# 2 s timeout, so death_rounds 3 sees worker 29 (dead at round 5) by the
# boundary at 10; 29 survivors do not fold onto 2 ranks and re-fold to 1
MESH_ELASTIC_ARGS = ["--scheme", "naive"] + with_rounds(SCHEME_BASE, STREAM_MESH_ROUNDS)
MESH_ELASTIC_DEATHS = {29: 5}
MESH_ELASTIC_SHAPES = ((15, 4400, 128), (29, 4551, 128))  # a rank of 2; the one rank of 29
MESH_WHATIF = dict(policies="approx:c15,naive", workers="30", stragglers="2", regimes="exp:0.5",
                   seeds=2, rounds=10)


def mesh_whatif_grid(spec_lib, target_loss=None):
    """The small what-if grid both worlds run: 2 policies x 2 seeds x 10
    rounds at the flagship data."""
    return spec_lib.GridSpec(
        policies=spec_lib.parse_policies(MESH_WHATIF["policies"]),
        n_workers=spec_lib.parse_ints(MESH_WHATIF["workers"]),
        n_stragglers=spec_lib.parse_ints(MESH_WHATIF["stragglers"]),
        regimes=spec_lib.parse_regimes(MESH_WHATIF["regimes"]),
        n_seeds=MESH_WHATIF["seeds"], rounds=MESH_WHATIF["rounds"],
        n_rows=COHORT_BASE["n_rows"], n_cols=COHORT_BASE["n_cols"], model="logistic",
        target_loss=target_loss)


def stream_mesh_cohort(cli) -> list:
    """The seven cohort schemes, deduped and streamed in windows of 6."""
    return [dataclasses.replace(c, stack_residency="streamed", stream_window=STREAM_WINDOW)
            for c in cohort_configs("deduped", (0,), rounds=STREAM_MESH_ROUNDS).values()]


def stream_mesh_child(cli, kernels, ds, out_dir) -> tuple:
    """This rank's half of the streamed and driver runs of the world-2 group:
    STREAM_MESH_RUNS from the shared store (launches, B1's shapes, the first
    launch held against its plain version, steps/s, the staged window's
    bytes and partitions, the prefetcher's staging and stall seconds, the
    peak device bytes), the streamed cohort of the seven schemes,
    train_adaptive (progress reward, chunks of 5), train_elastic_online
    (MESH_ELASTIC_DEATHS, its journal in ``out_dir``) and run_whatif (its
    surface in ``out_dir``; the loss target the parent's world-1 grid's)."""
    from erasurehead_tpu_torch import adapt, elastic
    from erasurehead_tpu_torch.data import store as store_lib
    from erasurehead_tpu_torch.train import trainer
    from erasurehead_tpu_torch.whatif import run_whatif
    from erasurehead_tpu_torch.whatif import spec as spec_lib

    t0 = time.perf_counter()
    sds = store_lib.open_store(os.path.join(out_dir, "store")).dataset()
    rec, hist = {}, {}
    for name, args, _ in STREAM_MESH_RUNS:
        cfg = parse_config(cli, args)
        shapes, restore = record_glm_shapes(kernels)
        try:
            with first_glm_launch(kernels) as box:
                res, launches = counted_library_run(kernels, lambda: trainer.train(cfg, sds))
        finally:
            restore()
        ci = res.cache_info
        hist[f"stream/{name}"] = res.params_history.cpu().numpy()
        rec[name] = dict(
            launches=launches, b1_shapes=[list(x) for x in sorted(set(shapes))],
            check=check_first_launch(kernels, box, f"stream_{name}"),
            steps_per_sec=res.steps_per_sec, stack_mode=ci["stack_mode"],
            stack_bytes=ci["stack_bytes"], staged_partitions=ci["stream_staged_partitions"],
            prefetch=ci["prefetch"], peak_bytes=ci["device_peak_bytes"], lowering=res.lowering)
    configs = stream_mesh_cohort(cli)
    res, launches = counted_library_run(kernels, lambda: trainer.train_cohort(configs, sds))
    for c, r in zip(configs, res):
        hist[f"stream/cohort_{c.scheme.value}"] = r.params_history.cpu().numpy()
    rec["cohort"] = dict(launches=launches, lowering=res[0].lowering,
                         steps_per_sec=res[0].steps_per_sec,
                         stack_bytes=res[0].cache_info["stack_bytes"],
                         prefetch=res[0].cache_info["prefetch"])
    acfg = parse_config(cli, with_rounds(ADAPT_ARGS, STREAM_MESH_ROUNDS))
    with first_glm_launch(kernels) as box:
        ares, launches = counted_library_run(kernels, lambda: adapt.train_adaptive(
            acfg, ds, controller=adapt.ControllerConfig(chunk_rounds=MESH_ADAPT_CHUNK,
                                                        seed=acfg.seed)))
    hist["stream/adapt"] = ares.result.params_history.cpu().numpy()
    rec["adapt"] = dict(launches=launches, check=check_first_launch(kernels, box, "adapt"),
                        decisions=[[d["arm"], d["reason"]] for d in ares.decisions],
                        steps_per_sec=ares.result.steps_per_sec,
                        decision_overhead_s=ares.decision_overhead_s,
                        total_wall_s=ares.total_wall_s)
    ecfg = parse_config(cli, MESH_ELASTIC_ARGS)
    shapes, restore = record_glm_shapes(kernels)
    try:
        eres, launches = counted_library_run(kernels, lambda: elastic.train_elastic_online(
            ecfg, ds, elastic=elastic.ElasticConfig(chunk_rounds=MESH_ADAPT_CHUNK, death_rounds=3,
                                                    timeout=2.0),
            deaths=MESH_ELASTIC_DEATHS, journal_dir=os.path.join(out_dir, "journal")))
    finally:
        restore()
    hist["stream/elastic"] = eres.result.params_history.cpu().numpy()
    rec["elastic"] = dict(launches=launches, b1_shapes={str(x): shapes.count(x) for x in set(shapes)},
                          decisions=json.loads(json.dumps(eres.decisions)),
                          epochs=[e["n_workers"] for e in eres.epochs],
                          steps_per_sec=eres.result.steps_per_sec)
    with open(os.path.join(out_dir, "whatif_target.json")) as f:
        target = json.load(f)["target_loss"]
    surf, launches = counted_library_run(kernels, lambda: run_whatif(
        mesh_whatif_grid(spec_lib, target), out_dir=os.path.join(out_dir, "surface")))
    rec["whatif"] = dict(launches=launches, rows=surf.rows, runs_per_sec=surf.stats["runs_per_sec"])
    rec["seconds"] = time.perf_counter() - t0
    return rec, hist


def stream_mesh_check(cli, kernels, ds, sds, ranks, hists, whatif1, out_dir, both0) -> dict:
    """The parent's half of the world-2 streamed and driver runs: each run
    again in this process with no group (world 1), and against it the
    ranks' params bitwise each other, the replayed loss within relative
    1e-4 in every round, B1's launches a rank (20 at its share's shape;
    the rank left out of the re-folded elastic epoch 10) and the rank's
    staged window half of world 1's, the first launch a rank within its
    plain version's tolerance; adapt's and elastic's decisions those of
    world 1; the what-if rows within relative 1e-4 of world 1's, one copy
    of the journal's rows and of the surface (rank 0 writes)."""
    from types import SimpleNamespace

    from erasurehead_tpu_torch import adapt, elastic
    from erasurehead_tpu_torch.train import trainer

    t0 = time.perf_counter()
    per = [r["stream"] for r in ranks]
    b1 = {**both0, "fused_glm_grad": STREAM_MESH_ROUNDS}
    out, bad = {}, []

    def loss_rel(ref, key, data):
        two = dataclasses.replace(ref, params_history=torch.from_numpy(hists[0][key]).to(
            ref.params_history.device))
        return max_rel(replayed_loss(two, data), replayed_loss(ref, data))

    bitwise = {k: bool(np.array_equal(hists[0][k], hists[1][k]))
               for k in hists[0] if k.startswith("stream/")}
    for name, args, shape in STREAM_MESH_RUNS:
        cfg = parse_config(cli, args)
        ref, launches = counted_library_run(kernels, lambda: trainer.train(cfg, sds))
        ci = ref.cache_info
        o = out[name] = dict(
            world1_launches=launches,
            world1=dict(steps_per_sec=ref.steps_per_sec,
                        stack_bytes=ci["stack_bytes"], staged_partitions=ci["stream_staged_partitions"],
                        prefetch=ci["prefetch"], peak_bytes=ci["device_peak_bytes"]),
            loss_max_rel_vs_world1=loss_rel(ref, f"stream/{name}", sds),
            **{k: [p[name][k] for p in per] for k in (
                "launches", "b1_shapes", "steps_per_sec", "stack_mode", "stack_bytes",
                "staged_partitions", "prefetch", "peak_bytes")},
            max_abs_err=[p[name]["check"]["max_abs_err"] for p in per])
        if launches != b1 or any(n != b1 for n in o["launches"]) \
                or any(sh != [list(shape)] for sh in o["b1_shapes"]) \
                or o["loss_max_rel_vs_world1"] > 1e-4 or not bitwise[f"stream/{name}"] \
                or any(2 * b != ci["stack_bytes"] for b in o["stack_bytes"]):
            bad.append(name)
    configs = stream_mesh_cohort(cli)
    ref, launches = counted_library_run(kernels, lambda: trainer.train_cohort(configs, sds))
    rels = {c.scheme.value: loss_rel(r, f"stream/cohort_{c.scheme.value}", sds)
            for c, r in zip(configs, ref)}
    out["cohort"] = dict(world1_launches=launches, world1_steps_per_sec=ref[0].steps_per_sec,
                         loss_max_rel_vs_world1=max(rels.values()),
                         **{k: [p["cohort"][k] for p in per] for k in (
                             "launches", "lowering", "steps_per_sec", "stack_bytes", "prefetch")})
    if launches != both0 or any(n != both0 for n in out["cohort"]["launches"]) \
            or max(rels.values()) > 1e-4:
        bad.append("cohort")
    acfg = parse_config(cli, with_rounds(ADAPT_ARGS, STREAM_MESH_ROUNDS))
    aref, launches = counted_library_run(kernels, lambda: adapt.train_adaptive(
        acfg, ds, controller=adapt.ControllerConfig(chunk_rounds=MESH_ADAPT_CHUNK,
                                                    seed=acfg.seed)))
    decisions = [[d["arm"], d["reason"]] for d in aref.decisions]
    out["adapt"] = dict(world1_launches=launches, world1_steps_per_sec=aref.result.steps_per_sec,
                        decisions_equal_world1=[p["adapt"]["decisions"] == decisions for p in per],
                        loss_max_rel_vs_world1=loss_rel(aref.result, "stream/adapt", ds),
                        **{k: [p["adapt"][k] for p in per] for k in (
                            "launches", "steps_per_sec", "decision_overhead_s", "total_wall_s")},
                        max_abs_err=[p["adapt"]["check"]["max_abs_err"] for p in per])
    if launches != b1 or any(n != b1 for n in out["adapt"]["launches"]) \
            or not all(out["adapt"]["decisions_equal_world1"]) \
            or out["adapt"]["loss_max_rel_vs_world1"] > 1e-4:
        bad.append("adapt")
    ecfg = parse_config(cli, MESH_ELASTIC_ARGS)
    eref, launches = counted_library_run(kernels, lambda: elastic.train_elastic_online(
        ecfg, ds, elastic=elastic.ElasticConfig(chunk_rounds=MESH_ADAPT_CHUNK, death_rounds=3,
                                                timeout=2.0), deaths=MESH_ELASTIC_DEATHS))
    with open(os.path.join(out_dir, "journal", "elastic_journal.jsonl")) as f:
        chunk_rows = sum(1 for r in map(json.loads, f) if r.get("action") == "chunk")
    want_rank = [{**both0, "fused_glm_grad": STREAM_MESH_ROUNDS},
                 {**both0, "fused_glm_grad": STREAM_MESH_ROUNDS // 2}]
    out["elastic"] = dict(
        world1_launches=launches, world1_steps_per_sec=eref.result.steps_per_sec,
        epochs=per[0]["elastic"]["epochs"], journal_chunk_rows=chunk_rows,
        decisions_equal_world1=[p["elastic"]["decisions"] == json.loads(json.dumps(eref.decisions))
                                for p in per],
        loss_max_rel_vs_world1=loss_rel(eref.result, "stream/elastic", ds),
        **{k: [p["elastic"][k] for p in per] for k in ("launches", "b1_shapes", "steps_per_sec")})
    first, after = (str(sh) for sh in MESH_ELASTIC_SHAPES)
    half = STREAM_MESH_ROUNDS // 2
    want_shapes = [{first: half, after: half}, {first: half}]
    if launches != b1 or out["elastic"]["launches"] != want_rank \
            or out["elastic"]["b1_shapes"] != want_shapes \
            or not all(out["elastic"]["decisions_equal_world1"]) \
            or out["elastic"]["epochs"] != [30, 29] or chunk_rows != 4 \
            or out["elastic"]["loss_max_rel_vs_world1"] > 1e-4:
        bad.append("elastic")
    surface = sorted(os.listdir(os.path.join(out_dir, "surface")))
    out["whatif"] = dict(
        world1_launches=whatif1["launches"], world1_runs_per_sec=whatif1["runs_per_sec"],
        max_rel_vs_world1=surfaces_agree(SimpleNamespace(rows=per[0]["whatif"]["rows"]),
                                         whatif1["surface"]),
        rows_equal_across_ranks=per[0]["whatif"]["rows"] == per[1]["whatif"]["rows"],
        surface_files=surface,
        **{k: [p["whatif"][k] for p in per] for k in ("launches", "runs_per_sec")})
    if not out["whatif"]["rows_equal_across_ranks"] or "surface_rows.jsonl" not in surface \
            or any(n != whatif1["launches"] for n in out["whatif"]["launches"]):
        bad.append("whatif")
    out.update(ranks_bitwise=bitwise, child_seconds=[p["seconds"] for p in per],
               check_seconds=time.perf_counter() - t0)
    emit("stream_mesh", note="two processes time-slicing one card over gloo; not a "
         "multi-GPU speed", rounds=STREAM_MESH_ROUNDS, **out)
    if bad or not all(bitwise.values()):
        raise AssertionError(f"world-2 streamed and driver runs failed {bad}: {out}")
    return out


def mesh_child(out_dir: str) -> int:
    """One rank of the world-2 group (``python3 chip_smoke.py --mesh-child
    DIR``, torchrun's environment from the parent): gloo on the card, B1 at
    the rank's [45, 4400, 128] against its plain version, the main path
    materialized and ring-transported (off and on), then train_dynamic and
    the measured cluster at MESH_SHORT rounds; histories and counts into
    ``DIR/rank<r>.npz`` and ``.json``; then the model-internal axes
    (:func:`model_axes_child`), and the streamed windows and the drivers
    (:func:`stream_mesh_child`)."""
    import torch.distributed as dist

    cli, kernels = import_port()
    from erasurehead_tpu_torch.parallel import backend, mesh as mesh_lib
    from erasurehead_tpu_torch.train import trainer

    backend.initialize_distributed(device="cuda", backend="gloo")
    rank = dist.get_rank()
    mesh = mesh_lib.worker_mesh()
    kernels.load_library()  # built by the parent in this checkout: no nvcc here
    rec = {"rank": rank, "world": mesh.world, "backend": mesh.backend,
           "device": str(mesh.device), "kind": torch.cuda.get_device_name(0)}
    rec["check"] = check_glm(kernels, MESH_SHAPE, torch.float32, "logistic", 2, seed=60 + rank)
    cfg = parse_config(cli, MAIN_ARGS)
    ds = cli.load_dataset(cfg)
    hist = {}
    for name, kw in MESH_VARIANTS:
        res, launches = counted_library_run(
            kernels, lambda kw=kw: trainer.train(dataclasses.replace(cfg, **kw), ds))
        hist[name] = res.params_history.cpu().numpy()
        rec[name] = dict(launches=launches, steps_per_sec=res.steps_per_sec,
                         stack_mode=res.cache_info["stack_mode"],
                         ring_pipeline=res.cache_info["ring_pipeline"],
                         stack_bytes=res.cache_info["stack_bytes"], lowering=res.lowering)
    short = dataclasses.replace(cfg, rounds=MESH_SHORT)
    res, launches = counted_library_run(kernels, lambda: trainer.train_dynamic(short, ds))
    hist["dynamic"] = res.params_history.cpu().numpy()
    rec["dynamic"] = dict(launches=launches, steps_per_sec=res.steps_per_sec)
    mcfg = parse_config(cli, with_rounds(MEASURED_ARGS, MESH_SHORT))
    res, launches = counted_library_run(kernels, lambda: trainer.train_measured(mcfg, ds))
    hist["measured"] = res.params_history.cpu().numpy()
    hist["measured_worker_times"] = res.worker_times
    rec["measured"] = dict(launches=launches, steps_per_sec=res.steps_per_sec)
    rec["all_reduce_us"] = all_reduce_us(mesh)
    rec["model_axes"], axes_hist = model_axes_child(cli, kernels, ds)
    hist.update(axes_hist)
    rec["stream"], stream_hist = stream_mesh_child(cli, kernels, ds, out_dir)
    hist.update(stream_hist)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **hist)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    backend.leave()  # a barrier, then the group's teardown
    return 0


def _spawn_mesh_children(out_dir: str, n: int = 2) -> list:
    """The world-2 group as two processes of this script (torchrun's
    environment, both on the one card); every child is killed if one fails
    or the time limit passes. Returns ``[(exit code, output tail)]``."""
    env = {**os.environ, "WORLD_SIZE": str(n), "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(_free_port()), "LOCAL_RANK": "0"}
    procs = []
    try:
        for r in range(n):
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--mesh-child", out_dir],
                env={**env, "RANK": str(r)}, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, cwd=HERE,
            ))
        deadline = time.monotonic() + MESH_CHILD_TIMEOUT_S
        logs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0].decode()
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, log[-4000:]) for p, log in zip(procs, logs)]


def mesh_phase(cli, kernels, ds, both0) -> dict:
    """The worker mesh on the card.

    (a) World size 1, in this process, under NCCL from a FileStore: the
    main path at full width (materialized, ring with ring_pipeline off and
    on) and the deep path, each bitwise the same run with no group, with
    exact launch counts; the peak device memory (the data cache dropped
    first, so each run builds its own stack) and steps/s of materialized
    against ring.

    (b) World size 2: two processes of this script on the one card under
    gloo. Each rank runs B1 at its [45, 4400, 128] against the plain
    version, and the main path materialized and ring off/on (100 B1 each a
    rank, bitwise each other); the two ranks' params are bitwise equal and
    their replayed loss within relative 1e-4 of (a)'s in every round; one
    train_dynamic and one measured-cluster run. Its steps/s are two
    processes time-slicing one card over gloo, not a multi-GPU speed."""
    import torch.distributed as dist

    from erasurehead_tpu_torch.parallel import backend, mesh as mesh_lib
    from erasurehead_tpu_torch.train import cache as cache_lib, trainer

    t_phase = time.perf_counter()
    cfg, deep_cfg = parse_config(cli, MAIN_ARGS), parse_config(cli, DEEP_ARGS)
    want_b1, want_b2 = {**both0, "fused_glm_grad": ROUNDS}, {**both0, "fused_block_decode": ROUNDS}
    ref, ref_launches = counted_library_run(kernels, lambda: trainer.train(cfg, ds))
    ref_deep, deep_launches = counted_library_run(kernels, lambda: trainer.train(deep_cfg, ds))
    if ref_launches != want_b1 or deep_launches != want_b2:
        raise AssertionError(f"mesh references: {ref_launches}, {deep_launches}")

    with tempfile.TemporaryDirectory(prefix="eh-chip-smoke-mesh-") as tmp:
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        backend.initialize_distributed(world_size=1, rank=0, store=store, device="cuda")
        try:
            mesh = mesh_lib.worker_mesh()
            if not (mesh.distributed and mesh.backend == "nccl" and mesh.world == 1):
                raise AssertionError(f"world-1 group: {mesh}")
            one = {}
            for name, kw in MESH_VARIANTS:
                cache_lib.clear()
                torch.cuda.empty_cache()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                res, launches = counted_library_run(
                    kernels, lambda kw=kw: trainer.train(dataclasses.replace(cfg, **kw), ds))
                one[name] = dict(
                    launches=launches, bitwise_no_group=_bitwise_runs(res, ref),
                    steps_per_sec=res.steps_per_sec, stack_mode=res.cache_info["stack_mode"],
                    ring_pipeline=res.cache_info["ring_pipeline"],
                    stack_bytes=res.cache_info["stack_bytes"],
                    peak_bytes=torch.cuda.max_memory_allocated() - base,
                    lowering=res.lowering)
                if name == "materialized":
                    world1 = res
            res, launches = counted_library_run(kernels, lambda: trainer.train(deep_cfg, ds))
            one["deep"] = dict(launches=launches, bitwise_no_group=_bitwise_runs(res, ref_deep),
                               steps_per_sec=res.steps_per_sec)
            nccl_us = all_reduce_us(mesh)
        finally:
            backend.shutdown()
            cache_lib.clear()
    # the no-group runs again, after the group's: steps/s in turns
    again, again_launches = counted_library_run(kernels, lambda: trainer.train(cfg, ds))
    again_deep, again_deep_launches = counted_library_run(
        kernels, lambda: trainer.train(deep_cfg, ds))
    if again_launches != want_b1 or again_deep_launches != want_b2 \
            or not _bitwise_runs(again, ref) or not _bitwise_runs(again_deep, ref_deep):
        raise AssertionError(f"no-group reruns: {again_launches}, {again_deep_launches}")
    emit("mesh_world1", backend="nccl", world=1, runs=one, all_reduce_us=nccl_us,
         no_group_steps_per_sec=[ref.steps_per_sec, again.steps_per_sec],
         no_group_deep_steps_per_sec=[ref_deep.steps_per_sec, again_deep.steps_per_sec])
    bad = {k: r for k, r in one.items()
           if not r["bitwise_no_group"] or r["launches"] != (want_b2 if k == "deep" else want_b1)}
    if bad:
        raise AssertionError(f"world-1 group runs: {bad}")

    from erasurehead_tpu_torch.data import store as store_lib
    from erasurehead_tpu_torch.whatif import run_whatif
    from erasurehead_tpu_torch.whatif import spec as spec_lib

    with tempfile.TemporaryDirectory(prefix="eh-chip-smoke-mesh2-") as out_dir:
        # the children's shared store, and the world-1 what-if grid whose
        # loss target the children's grid takes
        sds = store_lib.write_store(ds, os.path.join(out_dir, "store"), 30).dataset()
        surf1, w1_launches = counted_library_run(kernels, lambda: run_whatif(
            mesh_whatif_grid(spec_lib)))
        whatif1 = dict(surface=surf1, launches=w1_launches,
                       runs_per_sec=surf1.stats["runs_per_sec"])
        with open(os.path.join(out_dir, "whatif_target.json"), "w") as f:
            json.dump({"target_loss": surf1.target_loss}, f)
        t0 = time.perf_counter()
        children = _spawn_mesh_children(out_dir)
        children_s = time.perf_counter() - t0
        failed = [(r, rc, log) for r, (rc, log) in enumerate(children) if rc != 0]
        if failed:
            raise AssertionError(f"world-2 children failed: {failed}")
        ranks = [json.load(open(os.path.join(out_dir, f"rank{r}.json"))) for r in (0, 1)]
        hists = [dict(np.load(os.path.join(out_dir, f"rank{r}.npz"))) for r in (0, 1)]
        stream = stream_mesh_check(cli, kernels, ds, sds, ranks, hists, whatif1, out_dir, both0)
        del sds
    hists = [{k: v for k, v in h.items() if not k.startswith("stream/")} for h in hists]
    t_axes = time.perf_counter()
    axes = model_axes_check(cli, kernels, ds, ranks, hists, both0)
    emit("model_axes", note="two processes time-slicing one card over gloo; not a "
         "multi-GPU speed", rounds=AXES_ROUNDS, runs=axes,
         child_seconds=[r["model_axes"]["seconds"] for r in ranks],
         check_seconds=time.perf_counter() - t_axes)
    hists = [{k: v for k, v in h.items() if not k.startswith("axes")} for h in hists]
    ranks_bitwise = {k: bool(np.array_equal(hists[0][k], hists[1][k])) for k in hists[0]}
    ring_bitwise = {name: bool(np.array_equal(h[name], h["materialized"]))
                    for h in hists for name, _ in MESH_VARIANTS[1:]}
    two = dataclasses.replace(world1, params_history=torch.from_numpy(
        hists[0]["materialized"]).to(world1.params_history.device))
    loss1, loss2 = replayed_loss(world1, ds), replayed_loss(two, ds)
    loss_rel = float(np.max(np.abs(loss2 - loss1) / np.abs(loss1)))
    want_ranks = {name: want_b1 for name, _ in MESH_VARIANTS}
    want_ranks.update(dynamic={**both0, "fused_glm_grad": MESH_SHORT},
                      measured={**both0, "fused_block_decode": MESH_SHORT})
    launches = {f"rank{r['rank']}": {k: r[k]["launches"] for k in want_ranks} for r in ranks}
    rec = dict(
        backend=ranks[0]["backend"], world=ranks[0]["world"], device=ranks[0]["device"],
        note="two processes time-slicing one card over gloo; not a multi-GPU speed",
        check=[r["check"] for r in ranks], launches=launches,
        ranks_bitwise=ranks_bitwise, ring_bitwise_materialized=ring_bitwise,
        loss_max_rel_vs_world1=loss_rel,
        steps_per_sec={f"rank{r['rank']}": {k: r[k]["steps_per_sec"] for k in want_ranks}
                       for r in ranks},
        world1_steps_per_sec=one["materialized"]["steps_per_sec"],
        gloo_all_reduce_us={f"rank{r['rank']}": r["all_reduce_us"] for r in ranks},
        stack_bytes={r_name: ranks[0][r_name]["stack_bytes"] for r_name, _ in MESH_VARIANTS},
        children_s=children_s, seconds=time.perf_counter() - t_phase,
    )
    emit("mesh_world2", **rec)
    if not all(ranks_bitwise.values()) or not all(ring_bitwise.values()) or loss_rel > 1e-4:
        raise AssertionError(f"world-2 runs: {rec}")
    if any(v != want_ranks for v in ({k: r[k]["launches"] for k in want_ranks}
                                     for r in ranks)):
        raise AssertionError(f"world-2 launches: {launches}")
    return dict(world1=one, world2=rec, nccl_all_reduce_us=nccl_us, model_axes=axes,
                stream=stream, no_group_steps_per_sec=[ref.steps_per_sec, again.steps_per_sec],
                seconds=time.perf_counter() - t_phase,
                launches_by_run={
                    **{f"stream_mesh_world1_{k}": stream[k]["world1_launches"]
                       for k in ("dedup", "mat", "ring", "cohort", "adapt", "elastic", "whatif")},
                    **{f"stream_mesh_rank{r}_{k}": stream[k]["launches"][r]
                       for k in ("dedup", "mat", "ring", "cohort", "adapt", "elastic", "whatif")
                       for r in (0, 1)},
                    **{f"mesh_world1_{k}": r["launches"] for k, r in one.items()},
                    "mesh_reference_main": ref_launches, "mesh_reference_deep": deep_launches,
                    "mesh_rerun_main": again_launches, "mesh_rerun_deep": again_deep_launches,
                    **{f"mesh_world2_{rk}_{k}": n for rk, by in launches.items()
                       for k, n in by.items()},
                    **{f"model_axes_rank{r}_{name}": a["launches"][r]
                       for name, a in axes.items() for r in (0, 1)}})


# ---------------------------------------------------------------------------
# the compiled round loop: CUDA graphs from the executable cache


def result_artifacts_equal(a, b) -> dict:
    """Two TrainResults' artifacts, each compared bitwise: the params
    history, the final params, the simulated clock, the workers' times,
    the collected sets and the decode error."""
    def leaves_equal(x, y):
        lx, ly = torch.utils._pytree.tree_leaves(x), torch.utils._pytree.tree_leaves(y)
        return len(lx) == len(ly) and all(torch.equal(p, q) for p, q in zip(lx, ly))

    same = lambda x, y: (x is None and y is None) or (  # noqa: E731
        x is not None and y is not None and np.array_equal(x, y))
    return dict(params_history=leaves_equal(a.params_history, b.params_history),
                final_params=leaves_equal(a.final_params, b.final_params),
                timeset=same(a.timeset, b.timeset), worker_times=same(a.worker_times, b.worker_times),
                collected=same(a.collected, b.collected),
                decode_error=same(a.decode_error, b.decode_error))


def graph_vs_eager(kernels, graphs, name, run, want, count=1) -> dict:
    """``run()`` on the graph path, then under ``graphs.disabled()`` (the
    eager loop on the card): each must launch exactly ``want``, and every
    artifact must be bitwise (a list of results: member for member).
    ``count`` more graph runs first make the compared graph run a hit."""
    warm = [launches_of(kernels, run) for _ in range(count)]
    g, g_l = launches_of(kernels, run)
    first, first_l = warm[0] if warm else (g, g_l)
    with graphs.disabled():
        e, e_l = launches_of(kernels, run)
    pairs = list(zip(g, e)) if isinstance(g, list) else [(g, e)]
    eq = [result_artifacts_equal(a, b) for a, b in pairs]
    bitwise = {k: all(x[k] for x in eq) for k in eq[0]}
    g0 = g[0] if isinstance(g, list) else g
    e0 = e[0] if isinstance(e, list) else e
    f0 = first[0] if isinstance(first, list) else first
    rec = dict(run=name, launches=g_l, warm_launches=first_l if warm else None,
               eager_launches=e_l, bitwise=bitwise,
               graph_steps_per_sec=g0.steps_per_sec, eager_steps_per_sec=e0.steps_per_sec,
               executor=g0.cache_info["executor"], eager_executor=e0.cache_info["executor"],
               first_exec=[f0.cache_info["exec_hits"], f0.cache_info["exec_misses"]],
               exec=[g0.cache_info["exec_hits"], g0.cache_info["exec_misses"]],
               capture_seconds=f0.cache_info["compile_seconds"],
               memory_analysis=f0.cache_info["memory_analysis"])
    emit("graphs_run", **rec)
    if first_l != want or g_l != want or e_l != want:
        raise AssertionError(f"graphs {name}: launches {first_l} {g_l} {e_l}, want {want}")
    if not all(bitwise.values()) or rec["executor"] != "graph" or rec["eager_executor"] != "eager":
        raise AssertionError(f"graphs {name}: graph run is not its eager run: {rec}")
    return rec


def replay_checks(kernels) -> dict:
    """B1 captured in a one-round graph at the main shape and replayed:
    within check_glm's tolerance of its plain version and bitwise an eager
    launch; B2 on the deep path's six leaves replayed: bitwise its plain
    version. Each capture records one launch into its tally."""
    def capture(fn):
        cur = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side), kernels.recording({}):
            fn()
        cur.wait_stream(side)
        graph, tally = torch.cuda.CUDAGraph(), {}
        with kernels.recording(tally), torch.cuda.graph(graph):
            out = fn()
        graph.replay()
        torch.cuda.synchronize()
        return out, tally

    b, X, y, w = make_inputs(*MAIN_SHAPE, torch.float32, seed=140, zero_every=2)
    eager = kernels.fused_glm_grad(b, X, y, w, "logistic")
    want = kernels.reference_glm_grad(b, X, y, w, "logistic")
    got, b1_tally = capture(lambda: kernels.fused_glm_grad(b, X, y, w, "logistic"))
    Xf = X.float()
    s = kernels._residual("logistic", torch.einsum("mrf,f->mr", Xf, b), y) * w[:, None]
    tol = 1e-5 * torch.einsum("mrf,mr->f", Xf.abs(), s.abs()) + 1e-6
    err = (got - want).abs()
    b1 = dict(shape=list(MAIN_SHAPE), tally=b1_tally, max_abs_err=float(err.max()),
              max_err_over_tol=float((err / tol).max()), bitwise_eager=bool(torch.equal(got, eager)))
    del b, X, y, w, Xf, s
    ws, leaves = slot_leaves(leaf_shapes("deepmlp"), torch.float32, seed=141)
    plain = kernels.reference_block_decode_leaves(ws, leaves)
    outs, b2_tally = capture(lambda: kernels.fused_block_decode_leaves(ws, leaves))
    b2 = dict(leaves=len(leaves), tally=b2_tally,
              bitwise_plain=all(torch.equal(a, p) for a, p in zip(outs, plain)))
    rec = dict(fused_glm_grad=b1, fused_block_decode=b2)
    emit("graphs_replay_check", **rec)
    if not (b1["max_err_over_tol"] <= 1 and b1["bitwise_eager"] and b2["bitwise_plain"]
            and b1_tally == {"fused_glm_grad": 1} and b2_tally == {"fused_block_decode": 1}):
        raise AssertionError(f"a kernel under replay disagrees: {rec}")
    return rec


def profiled_kernel_events(run, tag) -> int:
    """Device events of the kernel named by ``tag`` in one profiled run."""
    prof, _ = profiled(run)
    return sum(ev.count for ev in device_events(prof) if tag in ev.key)


def graphs_phase(cli, kernels, ds, both0) -> dict:
    """The round loop as CUDA graphs (train/graphs.py) against the eager
    loop on the card (graphs.disabled()), from empty caches:

      - bitwise, every artifact (params history, final params, timeset,
        worker_times, collected, decode_error), with the eager launch
        counts, on the main path, a second signature's run with another lr
        schedule and seed (an executable hit), the deep path,
        train_dynamic, the pipelined run, a checkpoint-chunked run (30
        rounds a chunk: two programs) and the 28-trajectory compare_deduped
        cohort;
      - B1's and B2's 100 launches a run, counted by the replay tally,
        equal to one profiled run's kernel events; B1 replayed in a
        one-round graph within tolerance of its plain version and bitwise
        an eager launch, B2 bitwise its plain version under replay;
      - the cache: approx then repcoded on one stack make 1 miss then 1 hit
        with 1 data hit; a scan_unroll change emits one recompile warning
        naming it; scan_unroll 1, 4, 7 and 100 bitwise each other at
        ceil(100/u) replays; donate on and off bitwise, with their peak
        bytes above the loop's start;
      - steps/s, the profiled device ms a round and busy share, graph and
        eager, on the main path, deep, train_dynamic and the cohort; each
        first capture's seconds and graph-pool bytes."""
    from erasurehead_tpu_torch.obs import events as events_lib
    from erasurehead_tpu_torch.train import cache, graphs, trainer

    t_phase = time.perf_counter()
    cache.clear()
    cfg, dcfg, pcfg = (parse_config(cli, a) for a in (MAIN_ARGS, DEEP_ARGS, PIPE_ARGS))
    b1 = {**both0, "fused_glm_grad": ROUNDS}
    b2 = {**both0, "fused_block_decode": ROUNDS}
    runs = {}
    runs["main"] = graph_vs_eager(kernels, graphs, "main", lambda: trainer.train(cfg, ds), b1)
    other = dataclasses.replace(cfg, seed=5, lr_schedule=np.linspace(12.0, 6.0, ROUNDS))
    runs["main_other_lr_seed"] = graph_vs_eager(
        kernels, graphs, "main_other_lr_seed", lambda: trainer.train(other, ds), b1, count=0)
    runs["deep"] = graph_vs_eager(kernels, graphs, "deep", lambda: trainer.train(dcfg, ds), b2)
    runs["dynamic"] = graph_vs_eager(kernels, graphs, "dynamic",
                                     lambda: trainer.train_dynamic(cfg, ds), b1)
    runs["pipelined"] = graph_vs_eager(kernels, graphs, "pipelined",
                                       lambda: trainer.train(pcfg, ds), b1)
    with tempfile.TemporaryDirectory(prefix="eh-chip-smoke-graphs-") as ck:
        runs["chunked"] = graph_vs_eager(
            kernels, graphs, "chunked",
            lambda: trainer.train(cfg, ds, checkpoint_dir=tempfile.mkdtemp(dir=ck),
                                  checkpoint_every=30), b1)
    cohort_cfgs = list(cohort_configs("deduped", COHORT_SEEDS).values())
    runs["cohort28"] = graph_vs_eager(kernels, graphs, "cohort28",
                                      lambda: trainer.train_cohort(cohort_cfgs, ds), both0)
    if runs["main_other_lr_seed"]["first_exec"] != [1, 0] \
            or runs["chunked"]["first_exec"] != [0, 2]:
        raise AssertionError(f"graphs: exec counts {runs['main_other_lr_seed']} "
                             f"{runs['chunked']}")

    # the launches a replay tally counts are the kernels the device ran
    events = {"fused_glm_grad": profiled_kernel_events(lambda: trainer.train(cfg, ds),
                                                       "glm_grad_onepass"),
              "fused_block_decode": profiled_kernel_events(lambda: trainer.train(dcfg, ds),
                                                           "block_decode")}
    if events != {"fused_glm_grad": ROUNDS, "fused_block_decode": ROUNDS}:
        raise AssertionError(f"graphs: profiled kernel events {events}, want {ROUNDS} each")
    replay = replay_checks(kernels)

    # the executable cache, as the JAX package's sweep tests hold it
    cache.clear()
    approx_cfg = dataclasses.replace(cfg, rounds=20)
    rep_cfg = dataclasses.replace(approx_cfg, scheme="repcoded", num_collect=None)
    a = trainer.train(approx_cfg, ds)
    r = trainer.train(rep_cfg, ds)
    cache_seq = dict(approx=[a.cache_info[k] for k in ("exec_hits", "exec_misses", "data_hit")],
                     repcoded=[r.cache_info[k] for k in ("exec_hits", "exec_misses", "data_hit")])
    if cache_seq != {"approx": [0, 1, False], "repcoded": [1, 0, True]}:
        raise AssertionError(f"graphs: approx then repcoded {cache_seq}")
    with tempfile.TemporaryDirectory(prefix="eh-chip-smoke-graphs-") as tmp:
        log = os.path.join(tmp, "events.jsonl")
        with events_lib.capture(log):
            trainer.train(dataclasses.replace(approx_cfg, scan_unroll=4), ds)
        warns = [rec for rec in read_records(log) if rec["type"] == "warning"
                 and rec["kind"] == "recompile"]
    if len(warns) != 1 or warns[0]["changed"] != ["scan_unroll"]:
        raise AssertionError(f"graphs: recompile warnings {warns}")
    unroll = {}
    for u in (1, 4, 7, 100):
        res, launched = launches_of(kernels, lambda u=u: trainer.train(
            dataclasses.replace(cfg, scan_unroll=u), ds))
        unroll[u] = dict(res=res, launches=launched,
                         replays=res.cache_info["memory_analysis"]["replays"])
    same_unroll = {u: all(result_artifacts_equal(unroll[1]["res"], v["res"]).values())
                   for u, v in unroll.items()}
    replays = {u: v["replays"] for u, v in unroll.items()}
    if not all(same_unroll.values()) or replays != {1: 100, 4: 25, 7: 15, 100: 1} \
            or any(v["launches"] != b1 for v in unroll.values()):
        raise AssertionError(f"graphs: scan_unroll {same_unroll} {replays}")
    donate = {}
    for d in ("on", "off"):
        dcfg_d = dataclasses.replace(cfg, donate=d)
        trainer.train(dcfg_d, ds)  # captured: the peak below is a hit's
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        res = trainer.train(dcfg_d, ds)
        donate[d] = dict(res=res, peak_above_start_bytes=torch.cuda.max_memory_allocated() - base,
                         donation=res.cache_info["donation"])
    donate_bitwise = all(result_artifacts_equal(donate["on"]["res"], donate["off"]["res"]).values())
    if not donate_bitwise or [donate[d]["donation"] for d in ("on", "off")] != [True, False]:
        raise AssertionError(f"graphs: donate on/off {donate_bitwise}")

    # where a round's time goes, graph and eager, each profiled once warm
    profiles = {}
    for path, run in (("main", lambda: trainer.train(cfg, ds)),
                      ("deep", lambda: trainer.train(dcfg, ds)),
                      ("dynamic", lambda: trainer.train_dynamic(cfg, ds)),
                      ("cohort28", lambda: trainer.train_cohort(cohort_cfgs, ds)[0])):
        for mode in ("graph", "eager"):
            with (graphs.disabled() if mode == "eager" else contextlib.nullcontext()):
                p = profile_run(run)
            profiles[f"{path}_{mode}"] = {k: p[k] for k in (
                "warm_steps_per_sec", "profiled_loop_wall_ms", "device_ms_per_round",
                "device_busy_share")}
            emit("graphs_profile", path=path, mode=mode, **profiles[f"{path}_{mode}"])
    rec = dict(
        runs={k: {f: v for f, v in r.items() if f != "run"} for k, r in runs.items()},
        profiled_kernel_events=events, replay=replay, cache_sequence=cache_seq,
        recompile_warning=warns[0]["changed"], unroll_replays=replays,
        unroll_bitwise=same_unroll,
        donate={d: {k: v for k, v in r.items() if k != "res"} for d, r in donate.items()},
        donate_bitwise=donate_bitwise, profiles=profiles,
        seconds=time.perf_counter() - t_phase,
    )
    emit("graphs", **{k: v for k, v in rec.items() if k != "runs"})
    # each path's graph runs (the warm capture run's count added where it
    # has one) and its eager run, and the unroll runs; the cache-sequence,
    # donate and profiled runs stay outside the line
    rec["launches_by_run"] = {
        **{f"graphs_{k}": {n: v + (r["warm_launches"] or {}).get(n, 0)
                           for n, v in r["launches"].items()}
           for k, r in runs.items()},
        **{f"graphs_{k}_eager": dict(r["eager_launches"]) for k, r in runs.items()},
        **{f"graphs_unroll{u}": v["launches"] for u, v in unroll.items()},
    }
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    # every phase before ``tune`` resolves its auto knobs with no measured
    # verdict, whatever cache this host holds: an empty cache file
    cache_dir = tempfile.TemporaryDirectory(prefix="eh-chip-smoke-tune-")
    open(os.path.join(cache_dir.name, "tune.json"), "w").close()
    os.environ["ERASUREHEAD_TUNE_CACHE"] = os.path.join(cache_dir.name, "tune.json")
    cli, kernels = import_port()
    card = card_line()
    name = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda,
         kind=name, count=torch.cuda.device_count())

    t0 = time.perf_counter()
    kernels.load_library()
    emit("build", kernels=sorted(kernels.LAUNCHES), seconds=time.perf_counter() - t0,
         library=os.path.relpath(str(kernels.library_path()), HERE))

    checks = []
    for i, (shape, dtype, zero_every, offset) in enumerate(B1_CASES):
        for kind in kernels.GLM_KINDS:
            checks.append(check_glm(kernels, shape, dtype, kind, zero_every, seed=i,
                                    offset=offset))
    main_err = max(
        c["max_abs_err"] for c in checks
        if c["shape"] == list(MAIN_SHAPE) and c["dtype"] == "float32" and c["kind"] == "logistic"
    )
    decode_checks = []
    for i, (M, D) in enumerate(((1, 7), (3, 128), (9, 515), (6, 200))):
        for dtype in (torch.float32, torch.bfloat16):
            decode_checks.append(check_decode(kernels, M, D, dtype, seed=200 + i))
    decode_checks.append(check_decode(kernels, 9, 515, torch.float32, 210, zero_every=2))
    decode_checks.append(check_decode(kernels, 90, 4096, torch.bfloat16, 211, zero_every=2))
    for i, D in enumerate(DEEP_LEAVES + (COVTYPE_W_IN,)):
        decode_checks.append(check_decode(kernels, 90, D, torch.float32, 220 + i, zero_every=2))
    deep_shapes, moe_shapes = leaf_shapes("deepmlp"), leaf_shapes("moe")
    # (), (8, 16), (16,), (16, 16) x 3: a 0-d leaf and leaves narrower
    # than a 64-column slab, at float offsets 0, 1, 129, 145, 401, 657 of
    # a 913-float slot
    attn_shapes = leaf_shapes("attention")
    leaf_cases = [
        (deep_shapes, torch.float32, SLOTS),  # the deep path's round
        (deep_shapes, torch.bfloat16, SLOTS),
        (moe_shapes, torch.float32, SLOTS),  # the moe run's round
        (attn_shapes, torch.float32, SLOTS),  # the attention run's round
        (attn_shapes, torch.bfloat16, SLOTS),
        (deep_shapes, torch.float32, (200, 3)),  # M = 600: ten stages
        (deep_shapes, torch.bfloat16, (200, 3)),
        ([(7,), (4098,), ()], torch.float32, (43, 3)),  # M = 129: one past a stage
        ([(COVTYPE_W_IN,)], torch.float32, SLOTS),
        (deep_shapes, torch.float32, (90,)),  # partition-major
        ([(d,) for d in range(1, 41)], torch.float32, SLOTS),  # two launches
        ([(128,)], torch.float32, SLOTS),  # the measured GLM round's decode
    ]
    for i, (shapes, dtype, lead) in enumerate(leaf_cases):
        decode_checks.append(check_decode_leaves(kernels, shapes, dtype, 240 + i, lead))
    decode_err = max(c["max_abs_err"] for c in decode_checks)
    # B2 off the deep path at one wide leaf on each side of the width from
    # which it streams rows, beside its plain version and one cuBLAS GEMV:
    # timed here, early, because late in a whole run the profiler has kept
    # fewer than 98% of the GEMV's records in every window (PERF.md §7)
    for D, path in ((STAGED_WIDE, "staged"), (COVTYPE_W_IN, "streamed")):
        emit("time_wide", kernel="fused_block_decode", path=path, **time_decode(kernels, 90, D))
    attn_errs = [c["max_abs_err"] for c in decode_checks
                 if c["kernel"] == "fused_block_decode_leaves"
                 and c["leaf_shapes"] == [list(s) for s in attn_shapes]]
    # B1 at the new schemes' stacks, with round 0's weights of each
    stack_w = {}
    flags_of = {name: flags for name, flags, _ in SCHEME_RUNS}
    for label, flags, shape in (("partial", flags_of["partialcyccoded"], PARTIAL_SHAPE),
                                ("sparsegraph", flags_of["sparsegraph"], SPARSE_SHAPE)):
        stack_w[label] = scheme_slot_weights(cli, flags + with_rounds(SCHEME_BASE, 1))[0]
        for i, dtype in enumerate((torch.float32, torch.bfloat16)):
            for kind in kernels.GLM_KINDS:
                checks.append(check_glm(kernels, shape, dtype, kind, 0, 30 + i,
                                        weights=stack_w[label]))
    # B1 at the streamed phase's window stacks and the elastic survivors'
    for i, shape in enumerate((STREAM_SHAPE, HALO_SHAPE, BIG_SHAPE, SURVIVOR_SHAPE)):
        for kind in kernels.GLM_KINDS:
            checks.append(check_glm(kernels, shape, torch.float32, kind, 2, seed=50 + i))
    main_err = max(main_err, max(c["max_abs_err"] for c in checks
                                 if c["shape"] in (list(PARTIAL_SHAPE), list(SPARSE_SHAPE),
                                                   list(STREAM_SHAPE), list(HALO_SHAPE),
                                                   list(BIG_SHAPE), list(SURVIVOR_SHAPE))
                                 and c["dtype"] == "float32" and c["kind"] == "logistic"))

    both0 = {name: 0 for name in kernels.LAUNCHES}
    with tempfile.TemporaryDirectory(prefix="eh-chip-smoke-") as tmp:
        gpu = counted_run(cli, kernels, os.path.join(tmp, "cuda"), MAIN_ARGS,
                          {**both0, "fused_glm_grad": ROUNDS})
        launches = gpu["launches"]
        cpu = run_main(cli, os.path.join(tmp, "cpu"), "cpu")
        emit(
            "main", args=MAIN_ARGS, launches=launches,
            steps_per_sec=gpu["manifest"]["steps_per_sec"],
            wall_time_s=gpu["manifest"]["wall_time"],
            cpu_steps_per_sec=cpu["manifest"]["steps_per_sec"],
            train_loss_first_last=check_falls(gpu),
            final_auc=float(gpu["arts"]["auc"][-1]),
            decode_error_mean=gpu["manifest"].get("decode_error_mean"),
            **compare_runs(gpu, cpu),
        )

        # rows wider than one CTA holds through the trainer: 20,000 columns,
        # which a cluster of two CTAs splits, one B1 launch a round
        wide = counted_run(cli, kernels, os.path.join(tmp, "wide_cuda"), WIDE_COLS_ARGS,
                           {**both0, "fused_glm_grad": SHORT_ROUNDS}, workers=6)
        wide_cpu = run_main(cli, os.path.join(tmp, "wide_cpu"), "cpu", WIDE_COLS_ARGS, workers=6)
        emit("wide_cols", args=WIDE_COLS_ARGS, launches=wide["launches"],
             train_loss_first_last=check_falls(wide), **compare_runs(wide, wide_cpu))

        # one decode launch a round, whatever the leaf count
        deep = counted_run(cli, kernels, os.path.join(tmp, "deep"), DEEP_ARGS,
                           {**both0, "fused_block_decode": ROUNDS})
        short = with_rounds(DEEP_ARGS, SHORT_ROUNDS)
        deep_gpu10 = run_main(cli, os.path.join(tmp, "deep10_cuda"), "cuda", short)
        deep_cpu10 = run_main(cli, os.path.join(tmp, "deep10_cpu"), "cpu", short)
        treewise = short[:short.index("fused")] + ["treewise"]
        deep_tree10 = counted_run(cli, kernels, os.path.join(tmp, "deep10_treewise"), treewise,
                                  {**both0, "fused_block_decode": SHORT_ROUNDS})
        same = {a: deep_tree10["arts"][a].tobytes() == deep_gpu10["arts"][a].tobytes()
                for a in ARTIFACTS}
        if not all(same.values()):
            raise AssertionError(f"treewise vs fused artifacts differ on the card: {same}")
        emit(
            "deep", args=DEEP_ARGS, launches=deep["launches"],
            steps_per_sec=deep["manifest"]["steps_per_sec"],
            wall_time_s=deep["manifest"]["wall_time"],
            train_loss_first_last=check_falls(deep),
            final_auc=float(deep["arts"]["auc"][-1]),
            short_rounds=SHORT_ROUNDS,
            cpu_steps_per_sec=deep_cpu10["manifest"]["steps_per_sec"],
            **compare_runs(deep_gpu10, deep_cpu10),
            treewise_launches=deep_tree10["launches"],
            treewise_artifacts_bitwise_equal_fused=same,
        )

        for phase, model_args in (("moe", ["--model", "moe"]),
                                  ("glm_layer", ["--model", "logistic"])):
            args = with_rounds(MAIN_ARGS, LAYER_ROUNDS) + model_args + ["--layer-coding", "on"]
            run = counted_run(cli, kernels, os.path.join(tmp, phase), args,
                              {**both0, "fused_block_decode": LAYER_ROUNDS})
            emit(phase, args=args, launches=run["launches"],
                 steps_per_sec=run["manifest"]["steps_per_sec"],
                 train_loss_first_last=[float(run["arts"]["training_loss"][0]),
                                        float(run["arts"]["training_loss"][-1])],
                 final_auc=float(run["arts"]["auc"][-1]))

        t_schemes = time.perf_counter()
        scheme_rows = schemes_phase(cli, kernels, tmp, both0)
        legacy = legacy_phase(cli, kernels, tmp, both0)
        on_disk = input_dir_phase(cli, kernels, tmp, both0)
        new_phases_s = time.perf_counter() - t_schemes

        # the arrival models, the attention family, checkpoint/resume
        t_slice = time.perf_counter()
        arrivals = arrivals_phase(cli, kernels, tmp, both0)
        attention = attention_phase(cli, kernels, tmp, both0)
        ckpt = checkpoint_phase(cli, kernels, tmp, both0, gpu, attention.pop("run"))
        slice_phases_s = time.perf_counter() - t_slice
        emit("arrivals_attention_checkpoint", seconds=slice_phases_s)

    # trajectory cohorts: the decode's trajectory axis, then the harness
    from erasurehead_tpu_torch.train import experiments

    t_cohort = time.perf_counter()
    cohort_checks = []
    for i, (model_name, shapes) in enumerate((("deepmlp", deep_shapes), ("moe", moe_shapes))):
        for B in (1, 4, 28):
            for dtype in (torch.float32, torch.bfloat16):
                ws, leaves = cohort_leaves(shapes, dtype, seed=400 + 40 * i + B, B=B)
                cohort_checks.append(check_cohort_decode(kernels, ws, leaves, f"{model_name}_B{B}"))
    for i, dtype in enumerate((torch.float32, torch.bfloat16)):  # the attention cohort's B
        ws, leaves = cohort_leaves(attn_shapes, dtype, seed=480 + i, B=4)
        cohort_checks.append(check_cohort_decode(kernels, ws, leaves, "attention_B4"))
    attn_errs += [c["max_abs_err"] for c in cohort_checks if c["case"] == "attention_B4"]
    ws, leaves = cohort_leaves(deep_shapes, torch.float32, seed=490, B=4, lead=(90,))
    cohort_checks.append(check_cohort_decode(kernels, ws, leaves, "deepmlp_partition_major"))
    ws, leaves = cohort_leaves([(d,) for d in range(1, 41)], torch.float32, seed=491, B=3)
    cohort_checks.append(check_cohort_decode(kernels, ws, leaves, "40_leaves"))
    del ws, leaves
    vmap_ops = [cohort_vmap_leaves(kernels, m) for m in ("deepmlp", "moe", "attention")]
    attn_errs += [r["max_abs_err"] for r in vmap_ops if r["model"] == "attention"]
    cohort_ds = cli.load_dataset(parse_config(cli, MAIN_ARGS))
    deduped = compare_deduped_phase(kernels, experiments, cohort_ds, both0)
    transient = transient_phase(kernels, experiments, cohort_ds, both0)
    faithful = compare_faithful_phase(kernels, experiments, cohort_ds, both0)
    sweep = straggler_sweep_phase(kernels, experiments, cohort_ds, both0)
    deep_cohort = cohort_deep_phase(cli, kernels, cohort_ds, both0)
    cohort_phases_s = time.perf_counter() - t_cohort

    # the compiled round loop: graph runs against the eager loop on the card
    graphs_rec = graphs_phase(cli, kernels, cohort_ds, both0)

    # the sweep runner and pipelined training
    t_sweep = time.perf_counter()
    data_cache = data_cache_phase(kernels, experiments, cohort_ds, both0)
    with tempfile.TemporaryDirectory(prefix="eh-chip-smoke-sweep-") as tmp:
        journal_rec = journal_phase(kernels, experiments, cohort_ds, tmp, both0)
        pipe = pipeline_phase(cli, kernels, tmp, both0)
    sweep_phases_s = time.perf_counter() - t_sweep
    emit("sweep_runner", seconds=sweep_phases_s)
    sweep_launches = {
        **{f"data_cache_{k}": n for k, n in data_cache["launches"].items()},
        **{f"journal_{k}": n for k, n in journal_rec["launches"].items()},
        **{f"pipeline_{k}": n for k, n in pipe["launches_by_run"].items()},
    }
    sweep_launches.update(graphs_rec["launches_by_run"])
    # out-of-core streaming: the main path out of a shard store
    streamed = streamed_phase(cli, kernels, experiments, both0, gpu)
    sweep_launches.update({f"streamed_{k}": n for k, n in streamed["launches_by_run"].items()})

    # the on-device control plane, measured arrivals, worker failures
    t_dyn = time.perf_counter()
    dynamic = dynamic_phase(cli, kernels, both0)
    with tempfile.TemporaryDirectory(prefix="eh-chip-smoke-failures-") as tmp:
        measured = measured_phase(cli, kernels, tmp, both0)
        failed = failures_phase(cli, kernels, tmp, both0, gpu)
    dyn_phases_s = time.perf_counter() - t_dyn
    emit("dynamic_measured_failures", seconds=dyn_phases_s)
    for rec in (dynamic, measured, failed):
        sweep_launches.update(rec["launches_by_run"])

    # adaptive collection and online elastic membership
    t_online = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="eh-chip-smoke-online-") as tmp:
        adapted = adapt_phase(cli, kernels, tmp, both0)
        online = elastic_phase(cli, kernels, tmp, both0)
    online_phases_s = time.perf_counter() - t_online
    emit("adapt_elastic", seconds=online_phases_s)
    for rec in (adapted, online):
        sweep_launches.update(rec["launches_by_run"])

    # the measured autotuning plane and the what-if engine
    t_planes = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="eh-chip-smoke-planes-") as tmp:
        tuned = tune_phase(cli, kernels, tmp, both0)
        whatif = whatif_phase(cli, kernels, tmp, both0)
    planes_phases_s = time.perf_counter() - t_planes
    emit("tune_whatif", seconds=planes_phases_s)
    for rec in (tuned, whatif):
        sweep_launches.update(rec["launches_by_run"])

    # the run-telemetry plane: logs, traces, the audit
    with tempfile.TemporaryDirectory(prefix="eh-chip-smoke-telemetry-") as tmp:
        telemetry = telemetry_phase(cli, kernels, experiments, tmp, both0)
    sweep_launches.update(telemetry["launches_by_run"])

    # the serve daemon: packing, both kernels from dispatch threads, admission,
    # the fronts under load, the kill drill
    with tempfile.TemporaryDirectory(prefix="eh-chip-smoke-serve-") as tmp:
        served_rec = serve_phase(cli, kernels, tmp, both0, cohort_ds)
        serve_ranks = served_rec["serve_ranks"]
    sweep_launches.update(served_rec["launches_by_run"])
    sweep_launches.update(serve_ranks["launches_by_run"])

    # the serve fleet: replica processes on the card behind the router
    # (baseline, kill and adoption, rolling deploy under load, goodput);
    # then the native text parser's cold load
    with tempfile.TemporaryDirectory(prefix="eh-chip-smoke-fleet-") as tmp:
        fleet_rec = fleet_phase(cli, kernels, tmp, both0, cohort_ds)
        native_rec = native_phase(tmp)
    sweep_launches.update(fleet_rec["launches_by_run"])

    # the worker mesh: a world-1 NCCL group in this process, then two
    # processes on the one card under gloo
    mesh_rec = mesh_phase(cli, kernels, cohort_ds, both0)
    sweep_launches.update(mesh_rec["launches_by_run"])

    # the sparse and compressed stacks: no kernel takes them
    t_sparse = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="eh-chip-smoke-sparse-") as tmp:
        layout_s = {name: write_onehot_layout(tmp, name) for name in SPARSE_SHAPES}
        emit("sparse_layouts", shapes=SPARSE_SHAPES, write_seconds=layout_s)
        sparse = sparse_phase(cli, kernels, tmp, both0)
        amazon = amazon_phase(cli, kernels, tmp, both0)
        int8 = int8_phase(cli, kernels, tmp, both0)
        dense_low = dense_lowerings_phase(cli, kernels, tmp, both0)
        sparse_cohort = sparse_cohort_phase(cli, kernels, experiments, tmp, both0)
    sparse_phases_s = time.perf_counter() - t_sparse
    # no kernel launched on any of them: {path: {kernel: launches}}
    no_kernel_paths = {
        **{f"sparse_{r['run']}": r["launches"] for r in sparse},
        **{f"amazon_{r['run']}": r["launches"] for r in amazon},
        "int8": int8["launches"],
        **{f"dense_{r['run']}": r["launches"] for r in dense_low},
        "sparse_cohort": sparse_cohort["launches"],
        "sparse_cohort_sequential": sparse_cohort["sequential_launches"],
    }
    emit("sparse_summary", seconds=sparse_phases_s, launches=no_kernel_paths,
         rerun_max_abs_diff={r.get("run", "int8"): r["rerun_max_abs_diff"]
                             for r in sparse + [int8] + dense_low})

    # times at the main path's shapes (compare launches do not count)
    b, X, y, w = make_inputs(*MAIN_SHAPE, torch.float32, seed=100)
    Xb = X.to(torch.bfloat16)
    kernel_ms = time_ms(lambda: kernels.fused_glm_grad(b, X, y, w, "logistic"))
    plain_ms = time_ms(lambda: kernels.reference_glm_grad(b, X, y, w, "logistic"))
    kernel_bf16_ms = time_ms(lambda: kernels.fused_glm_grad(b, Xb, y, w, "logistic"))
    plain_ms_2 = time_ms(lambda: kernels.reference_glm_grad(b, X, y, w, "logistic"))
    kernel_ms_2 = time_ms(lambda: kernels.fused_glm_grad(b, X, y, w, "logistic"))
    bound_ms, bound_by = glm_bound_ms(*MAIN_SHAPE, 4)
    bound_bf16_ms, _ = glm_bound_ms(*MAIN_SHAPE, 2)
    emit("time", kernel="fused_glm_grad", shape=list(MAIN_SHAPE),
         kernel_ms=[kernel_ms, kernel_ms_2], plain_ms=[plain_ms, plain_ms_2],
         kernel_bf16_ms=kernel_bf16_ms, bound_ms=bound_ms, bound_bf16_ms=bound_bf16_ms,
         achieved_tb_per_s=(bound_ms / min(kernel_ms, kernel_ms_2)) * HBM_BYTES_PER_S / 1e12)
    del b, X, y, w, Xb
    stream_times = {}
    for label, shape in (("approx_window_6", STREAM_SHAPE), ("cyccoded_window_10", HALO_SHAPE),
                         ("window_3_of_16x", BIG_SHAPE),
                         *((f"world2_{name}_rank", shape) for name, _, shape in STREAM_MESH_RUNS)):
        b, X, y, w = make_inputs(*shape, torch.float32, seed=102)
        k1 = time_ms(lambda: kernels.fused_glm_grad(b, X, y, w, "logistic"))
        p1 = time_ms(lambda: kernels.reference_glm_grad(b, X, y, w, "logistic"))
        k2 = time_ms(lambda: kernels.fused_glm_grad(b, X, y, w, "logistic"))
        bound, by = glm_bound_ms(*shape, 4)
        stream_times[label] = dict(shape=list(shape), ms=min(k1, k2), kernel_ms=[k1, k2],
                                   plain_ms=p1, bound_ms=bound, bound_by=by)
        emit("time_stream", kernel="fused_glm_grad", **stream_times[label])
        del b, X, y, w
    # the 27 elastic survivors' stack, [81, 4888, 128]: 202.7 MB read once
    b, X, y, w = make_inputs(*SURVIVOR_SHAPE, torch.float32, seed=103)
    k1 = time_ms(lambda: kernels.fused_glm_grad(b, X, y, w, "logistic"))
    p1 = time_ms(lambda: kernels.reference_glm_grad(b, X, y, w, "logistic"))
    k2 = time_ms(lambda: kernels.fused_glm_grad(b, X, y, w, "logistic"))
    bound, by = glm_bound_ms(*SURVIVOR_SHAPE, 4)
    survivor_time = dict(shape=list(SURVIVOR_SHAPE), ms=min(k1, k2), kernel_ms=[k1, k2],
                         plain_ms=p1, bound_ms=bound, bound_by=by,
                         stack_mb=X.numel() * X.element_size() / 1e6,
                         bound_share=bound / min(k1, k2))
    emit("time_survivors", kernel="fused_glm_grad", **survivor_time)
    del b, X, y, w
    # a rank's stack at world size 2, [45, 4400, 128]: half the main stack
    b, X, y, w = make_inputs(*MESH_SHAPE, torch.float32, seed=104)
    k1 = time_ms(lambda: kernels.fused_glm_grad(b, X, y, w, "logistic"))
    p1 = time_ms(lambda: kernels.reference_glm_grad(b, X, y, w, "logistic"))
    k2 = time_ms(lambda: kernels.fused_glm_grad(b, X, y, w, "logistic"))
    bound, by = glm_bound_ms(*MESH_SHAPE, 4)
    mesh_time = dict(shape=list(MESH_SHAPE), ms=min(k1, k2), kernel_ms=[k1, k2], plain_ms=p1,
                     bound_ms=bound, bound_by=by, bound_share=bound / min(k1, k2))
    emit("time_mesh", kernel="fused_glm_grad", **mesh_time)
    del b, X, y, w
    for shape in WIDE_SHAPES:  # off the main path: the wide kernel's cost
        b, X, y, w = make_inputs(*shape, torch.float32, seed=101)
        k_ms = time_ms(lambda: kernels.fused_glm_grad(b, X, y, w, "logistic"), n=20)
        p_ms = time_ms(lambda: kernels.reference_glm_grad(b, X, y, w, "logistic"), n=20)
        bound, by = glm_bound_ms(*shape, 4)
        emit("time_wide", kernel="fused_glm_grad", shape=list(shape), kernel_ms=k_ms,
             plain_ms=p_ms, bound_ms=bound, bound_by=by)
        del b, X, y, w

    stack_times = {label: time_scheme_stack(kernels, shape, stack_w[label], label)
                   for label, shape in (("partial", PARTIAL_SHAPE), ("sparsegraph", SPARSE_SHAPE))}

    ops = [decode_ops(kernels, m) for m in ("deepmlp", "moe", "attention")]
    attn_errs += [r["max_abs_err"] for r in ops if r["model"] == "attention"]
    for D in TIMED_LEAVES:
        emit("time", kernel="fused_block_decode", **time_decode(kernels, 90, D))
    per_round = time_round(kernels, deep_shapes)
    emit("time_round", kernel="fused_block_decode_leaves", **per_round)
    attn_round = time_round(kernels, leaf_shapes("attention"))
    emit("time_round", kernel="fused_block_decode_leaves", path="attention", **attn_round)
    measured_round = time_round(kernels, [(MAIN_SHAPE[2],)])
    emit("time_round", kernel="fused_block_decode_leaves", path="measured", **measured_round)

    emit("profile", path="main", **profile_train(cli, MAIN_ARGS))
    deep_profile = profile_train(cli, DEEP_ARGS)
    emit("profile", path="deep", **deep_profile)
    attn_profile = profile_train(cli, ATTN_ARGS)
    if attn_profile["device_ms_per_round"]:
        # the round's split: the decode kernel, and everything else (the
        # per-slot autodiff, the update, the history copy)
        decode_ms = attn_profile["kernel_ms"]["fused_block_decode"] / ROUNDS
        attn_profile["decode_ms_per_round"] = decode_ms
        attn_profile["rest_ms_per_round"] = attn_profile["device_ms_per_round"] - decode_ms
    emit("profile", path="attention", **attn_profile)

    cohort_decode_times = {B: time_cohort_decode(kernels, deep_shapes, B) for B in (4, 28)}
    cohort_glm_time = time_cohort_glm(kernels)
    from erasurehead_tpu_torch.train import trainer

    cohort_cfgs = list(cohort_configs("deduped", COHORT_SEEDS).values())
    cohort_profile = profile_run(lambda: trainer.train_cohort(cohort_cfgs, cohort_ds)[0])
    cohort_profile["bound_ms_per_round"] = cohort_glm_time["bound_ms"]
    cohort_profile["aggregate_steps_per_sec"] = cohort_profile["warm_steps_per_sec"]
    emit("profile", path="compare_deduped_cohort", **cohort_profile)
    emit("profiler", lost_windows=LOST_WINDOWS)

    kernel_ms_best = min(kernel_ms, kernel_ms_2)
    line = {"kernels": [{
        "name": "fused_glm_grad",
        "route": "cuda",
        "source": "erasurehead_tpu_torch/csrc/fused_glm_grad.cu",
        "replaces": "erasurehead_tpu/ops/kernels.py:68",
        "tpu_kernel": "erasurehead_tpu/ops/kernels.py:_kernel",
        # the kernel's design (the source's header has the whole account)
        "design": "one launch a call (a memset node zeroes its tickets first): a persistent "
                  "grid, one or two CTAs an SM, each over one contiguous range of flat rows; "
                  "one producer warp feeds a ring of shared-memory stages by TMA bulk copies "
                  "(ragged head and tail loaded directly, y and w by cp.async); X crosses HBM "
                  "once up to 131,072 columns (row path F <= 1024, column path F <= 16384, "
                  "then a cluster of up to 8 CTAs splits each row by columns and adds their "
                  "margins through distributed shared memory), and wider rows are read twice, "
                  "four at a time; the last CTA of each group sums the partials in a "
                  "fixed order, no float atomics",
        # the main path's 100, each schemes run's 100, the input_dir run's,
        # and the cohort harness's sequential runs (compare_deduped's seed-0
        # runs with batch "off", compare_faithful's singletons)
        "launches": launches["fused_glm_grad"]
        + wide["launches"]["fused_glm_grad"]
        + sum(r["launches"]["fused_glm_grad"] for r in scheme_rows)
        + on_disk["launches"]["fused_glm_grad"]
        + deduped["sequential_launches"]["fused_glm_grad"]
        + faithful["launches"]["fused_glm_grad"]
        + sum(r["launches"]["fused_glm_grad"] for r in arrivals)
        + sum(n["fused_glm_grad"] for n in ckpt["launches"].values())
        + sum(n["fused_glm_grad"] for n in sweep_launches.values()),
        "launches_by_path": {"main": launches["fused_glm_grad"],
                             "wide_cols": wide["launches"]["fused_glm_grad"],
                             **{r["run"]: r["launches"]["fused_glm_grad"] for r in scheme_rows},
                             "legacy": [n["fused_glm_grad"] for n in legacy["launches"]],
                             "input_dir": on_disk["launches"]["fused_glm_grad"],
                             "compare_deduped_cohort": deduped["launches"]["fused_glm_grad"],
                             "compare_deduped_sequential":
                                 deduped["sequential_launches"]["fused_glm_grad"],
                             "compare_faithful": faithful["launches"]["fused_glm_grad"],
                             "straggler_sweep": sweep["launches"]["fused_glm_grad"],
                             "cohort_deep": deep_cohort["launches"]["fused_glm_grad"],
                             **{p: n["fused_glm_grad"] for p, n in no_kernel_paths.items()},
                             **{f"arrivals_{r['run']}": r["launches"]["fused_glm_grad"]
                                for r in arrivals},
                             "attention": attention["launches"]["fused_glm_grad"],
                             "attention_cohort": attention["cohort"]["launches"]["fused_glm_grad"],
                             **{f"checkpoint_{k}": n["fused_glm_grad"]
                                for k, n in ckpt["launches"].items()},
                             **{k: n["fused_glm_grad"] for k, n in sweep_launches.items()}},
        "max_abs_err": max(main_err, max(c["max_abs_err"] for c in mesh_rec["world2"]["check"]),
                           streamed["ring_window"]["check"]["max_abs_err"],
                           *(e for k in ("dedup", "mat", "ring", "adapt")
                             for e in mesh_rec["stream"][k]["max_abs_err"])),
        "ms": kernel_ms_best,
        "plain_ms": min(plain_ms, plain_ms_2),  # the two-pass torch yardstick
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "steps_per_sec": gpu["manifest"]["steps_per_sec"],
        # the compiled round loop: B1 replayed in a one-round graph, each
        # path's graph and eager steps/s, the profiled kernel events of a
        # graph run, the first captures' seconds and graph-pool bytes
        "graphs": {"replay": graphs_rec["replay"]["fused_glm_grad"],
                   "profiled_kernel_events": graphs_rec["profiled_kernel_events"],
                   "steps_per_sec": {k: [r["graph_steps_per_sec"], r["eager_steps_per_sec"]]
                                     for k, r in graphs_rec["runs"].items()},
                   "capture": {k: {**r["memory_analysis"], "seconds": r["capture_seconds"]}
                               for k, r in graphs_rec["runs"].items()},
                   "phase_s": graphs_rec["seconds"]},
        "scheme_stacks": {label: dict(shape=r["shape"], ms=min(r["kernel_ms"]),
                                      plain_ms=min(r["plain_ms"]), bound_ms=r["bound_ms"])
                          for label, r in stack_times.items()},
        "sparsegraph_zero_slot_time_share": stack_times["sparsegraph"]["zero_slot_time_share"],
        "schemes_legacy_input_dir_phase_s": new_phases_s,
        "sweep_runner_phases_s": sweep_phases_s,
        "pipelined_steps_per_sec": pipe["steps_per_sec"],
        # train_dynamic (arrivals, masks and weights on the card) against
        # train() on the main path's config, same process
        "dynamic_steps_per_sec": dynamic["profile"]["train_dynamic"]["warm_steps_per_sec"],
        "dynamic_vs_train_steps_per_sec": dynamic["profile"]["train"]["warm_steps_per_sec"],
        # the streamed phase's windows: B1 at each, its launches,
        # steps/s, staging overlap and peak device windows
        "stream_windows": stream_times,
        # the ring transport of the cyccoded window 10 (12 staged
        # partitions, the [30, 4400, 128] slots rebuilt a round) against the
        # materialized window; then the world-2 ranks' streamed windows and
        # drivers (two processes time-slicing one card over gloo, not a
        # multi-GPU speed): steps/s, staged bytes and partitions, staging
        # and stall seconds, peak device bytes a rank, beside world 1's
        "ring_window": {k: streamed["ring_window"][k] for k in (
            "steps_per_sec", "materialized_steps_per_sec", "window_bytes",
            "materialized_window_bytes", "peak_bytes", "materialized_peak_bytes",
            "prefetch", "bitwise_materialized")},
        "stream_mesh": {k: {f: v for f, v in r.items() if f not in ("b1_shapes", "max_abs_err")}
                        for k, r in mesh_rec["stream"].items()
                        if k in ("dedup", "mat", "ring", "cohort", "adapt", "elastic", "whatif")},
        "streamed": {"window_steps_per_sec": streamed["window"]["steps_per_sec"],
                     "window_peak_windows": streamed["window"]["peak_windows"],
                     "big_store_steps_per_sec": streamed["big_store"]["steps_per_sec"],
                     "big_store_prefetch": streamed["big_store"]["prefetch"],
                     "big_store_peak_windows": streamed["big_store"]["peak_windows"],
                     "phase_s": streamed["seconds"]},
        "sparse_phases_s": sparse_phases_s,
        # the elastic survivors' stack after the re-layout
        "elastic_survivors": survivor_time,
        # adaptive collection: the chunk loop's steps/s and overheads (the
        # progress reward's boundary probes are in the decision overhead)
        # beside plain train()'s steps/s in this process
        "adapt": {**{mode: {k: adapted[mode][k] for k in (
            "steps_per_sec", "decision_overhead_s", "driver_overhead_s", "total_wall_s")}
            for mode in ("progress", "time_error")},
            "plain_train_steps_per_sec": adapted["plain_train_steps_per_sec"]},
        "elastic": {"relayout_round": online["relayout_round"],
                    "steps_per_sec": online["steps_per_sec"]},
        "adapt_elastic_phases_s": online_phases_s,
        # the glm_fused races (B1 against the two-pass path) at the main
        # and wide stacks, the warm lookup, and the what-if grid's runs/s
        # with cohorts (no launch) and sequential (1,440 launches)
        "tune": {**{k: {f: g[f] for f in ("stack", "choice", "decisive", "timings_ms",
                                          "race_wall_s", "launches")}
                    for k, g in tuned["glm_fused"].items()},
                 "warm_lookup_us": tuned["warm_lookup_us"]},
        "whatif": {"auto_runs_per_sec": whatif["auto"]["runs_per_sec"],
                   "off_runs_per_sec": whatif["off"]["runs_per_sec"],
                   "draw_kernels_by_seeds": whatif["draw_kernels_by_seeds"]},
        "tune_whatif_phases_s": planes_phases_s,
        # the main path with telemetry and tracing off, on, and traced; the
        # trace's B1 device events (at most the launches: a fresh profiler
        # window may drop some) and the records' host ms after the loop
        "telemetry": {"steps_per_sec": telemetry["steps_per_sec"],
                      "paired_median_steps_per_sec": {
                          k: telemetry["paired_steps_per_sec"][k]["median"]
                          for k in ("off", "on", "traced")},
                      "trace_device_events": telemetry["main_trace"]["device_events"],
                      "records_ms": telemetry["post_loop_ms"]["records_ms"],
                      "phase_s": telemetry["seconds"]},
        # a 28-trajectory deduped cohort round: the cohort matmul the path
        # runs instead, against 28 launches of this kernel
        "cohort_round": {k: cohort_glm_time[k] for k in (
            "B", "shape", "cohort_matmul_ms", "b1_x_B_ms", "bound_ms")},
        # the serve daemon: eight packed requests' aggregate steps/s against
        # the same eight sequential train() runs (B1), each admitted
        # signature's estimate over its measured peak, the fronts'
        # time-to-first-row under load, the phase's seconds
        "serve": {k: served_rec[k] for k in (
            "packed_aggregate_steps_per_sec", "sequential_aggregate_steps_per_sec",
            "cohort_loop_steps_per_sec", "sequential_loop_steps_per_sec",
            "est_over_peak", "ttfr_p50_s", "ttfr_p99_s", "seconds")},
        # the serve fleet: the same request set's aggregate steps/s and
        # rows/s through one replica and through the two survivors (shared
        # card), boot seconds, death to adoption; the native parser's
        # cold parse against np.loadtxt's
        "fleet": {k: fleet_rec[k] for k in (
            "goodput", "boot_s", "death_to_adoption_s", "deploy_load_wall_s", "seconds")},
        "native": {k: native_rec[k] for k in ("native_s", "loadtxt_s", "loadtxt_over_native")},
        # the worker mesh: a rank's stack at world size 2 (B1 there), the
        # main path's steps/s and peak bytes at world 1 under NCCL
        # (materialized against the one-hop ring), and world 2's steps/s:
        # two processes time-slicing one card over gloo, not a multi-GPU speed
        "mesh": {"world2_rank_stack": mesh_time,
                 "world1": {k: {f: r[f] for f in ("steps_per_sec", "stack_bytes", "peak_bytes")}
                            for k, r in mesh_rec["world1"].items() if k != "deep"},
                 "world1_no_group_steps_per_sec": mesh_rec["no_group_steps_per_sec"],
                 "world1_nccl_all_reduce_us": mesh_rec["nccl_all_reduce_us"],
                 "world2_steps_per_sec": mesh_rec["world2"]["steps_per_sec"],
                 "world2_gloo_all_reduce_us": mesh_rec["world2"]["gloo_all_reduce_us"],
                 "world2_loss_max_rel_vs_world1": mesh_rec["world2"]["loss_max_rel_vs_world1"],
                 # the model axes in the same two processes (same caveat):
                 # steps/s a rank, the collectives' share of a traced round,
                 # peak device bytes a rank
                 "model_axes": {name: {f: a[f] for f in (
                     "steps_per_sec", "collectives", "peak_bytes", "unsharded_steps_per_sec")}
                     for name, a in mesh_rec["model_axes"].items()},
                 "phase_s": mesh_rec["seconds"]},
    }, {
        "name": "fused_block_decode",
        "route": "cuda",
        "source": "erasurehead_tpu_torch/csrc/fused_block_decode.cu",
        "replaces": "erasurehead_tpu/ops/kernels.py:252",
        "tpu_kernel": "erasurehead_tpu/ops/kernels.py:_decode_kernel",
        # the deep path's 100 and the deep cohort's 100 (one a round for
        # its four trajectories)
        "launches": deep["launches"]["fused_block_decode"]
        + deep_cohort["launches"]["fused_block_decode"]
        + attention["launches"]["fused_block_decode"]
        + attention["cohort"]["launches"]["fused_block_decode"]
        + sum(n["fused_block_decode"] for n in ckpt["launches"].values())
        + sum(n["fused_block_decode"] for n in sweep_launches.values()),
        "launches_by_path": {"deep": deep["launches"]["fused_block_decode"],
                             "cohort_deep": deep_cohort["launches"]["fused_block_decode"],
                             "compare_deduped": deduped["launches"]["fused_block_decode"],
                             "compare_faithful": faithful["launches"]["fused_block_decode"],
                             **{p: n["fused_block_decode"] for p, n in no_kernel_paths.items()},
                             **{f"arrivals_{r['run']}": r["launches"]["fused_block_decode"]
                                for r in arrivals},
                             "attention": attention["launches"]["fused_block_decode"],
                             "attention_cohort":
                                 attention["cohort"]["launches"]["fused_block_decode"],
                             **{f"checkpoint_{k}": n["fused_block_decode"]
                                for k, n in ckpt["launches"].items()},
                             **{k: n["fused_block_decode"] for k, n in sweep_launches.items()}},
        "max_abs_err": max(decode_err, max(c["max_abs_err"] for c in cohort_checks),
                           max(r["max_abs_err"] for r in ops + vmap_ops),
                           online["check"]["max_abs_err"]),
        # a deep round's decode: one launch for its six leaves
        "ms": per_round["kernel_ms"],
        "plain_ms": per_round["plain_ms"],
        # bytes of one round's decode moved once: 90 x 8385 floats in one pass
        "bound_ms": per_round["bound_ms"],
        "bound_by": per_round["bound_by"],
        # six cuBLAS GEMVs, one per leaf
        "library_ms": per_round["library_ms"],
        "steps_per_sec": deep["manifest"]["steps_per_sec"],
        "leaves_contiguous": all(all(r["contiguous"]) for r in ops),
        "cohort_leaves_contiguous": all(all(r["contiguous"]) for r in vmap_ops),
        # a deep cohort round's decode: one launch for B trajectories
        "cohort": {f"B{B}": {k: r[k] for k in (
            "kernel_ms", "per_trajectory_launches_ms", "library_ms", "plain_ms", "bound_ms")}
            for B, r in cohort_decode_times.items()},
        "cohort_phases_s": cohort_phases_s,
        # an attention round's decode: one launch for its six leaves
        # ([90, 913] floats), its plain version, six cuBLAS GEMVs, the bound
        # and the largest error of every check at attention's leaves (the
        # leaf sets f32/bf16, the B=4 cohort, the real per-slot leaves)
        "attention_round": {**{k: attn_round[k] for k in (
            "leaves", "kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
            "max_abs_err": max(attn_errs), "checks": len(attn_errs)},
        "attention_steps_per_sec": attention["steps_per_sec"],
        "arrivals_attention_checkpoint_phases_s": slice_phases_s,
        # the measured GLM round's decode: one launch for the [30, 3, 128]
        # per-worker messages
        "measured_round": {k: measured_round[k] for k in (
            "kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
        "measured_steps_per_sec": measured["steps_per_sec"],
        "measured_compute_us": measured["compute_us"],
        "dynamic_measured_failures_phases_s": dyn_phases_s,
        # the deep path's block_decode and layer_coding races
        "tune": tuned["deep"]["races"],
        # the traced deep run's B2 device events
        "telemetry_trace_device_events": telemetry["deep_trace"]["device_events"],
        # B2 replayed on the deep round's six leaves
        "graphs_replay": graphs_rec["replay"]["fused_block_decode"],
    }]}
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-child"]:
        sys.exit(mesh_child(sys.argv[2]))
    if sys.argv[1:2] == ["--serve-child"]:
        sys.exit(serve_child(sys.argv[2]))
    sys.exit(main())
