"""Drive the PyTorch/CUDA port's main paths on one GPU and check them.

    python3 chip_smoke.py

Twelve main paths. The rule-profile fleet rollout: a batch of clusters
gets one simulated day (T = 2880 ticks of 30 s) of synthetic price, carbon
and demand signals, is stepped under the Peak/Off-Peak rule, and is
folded into one EpisodeSummary per cluster. The three-policy scoreboard:
the rule, the carbon teacher and the shipped learned flagship scored on
one packed multiregion fleet-day, paired world for world. The fault and
workload boards: the same three policies and diff-MPC (the quick
receding-horizon planner on the calm world, its plan played back by the
plan kernel) on streams widened with fault lanes (four intensities) and
workload-family lanes (four scenarios). The streaming path: the same
policies and a plan over a day synthesized block by block beside the
kernels, the rollout resumed at each block from its carried state, and a
fleet of 262144 clusters in chunks whose whole stream would not fit the
card. The closed control loop: one cluster's scrape, decide, render,
apply, verify and estimate a tick, on the card, under four backends,
killed and resumed. The command line: preroll, simulate, evaluate, the
boards, train and observe through `ccka_tpu_torch.cli.main` on the card.
Replayed streams: windows of a stored trace sampled on the card and
rolled out by the same kernels. The fleet controller: N clusters decided
at once, one CUDA graph a tick, with the decision ledger, the shadow
tournament and the incident log riding beside it. The multi-tenant
service: the fleet behind per-tenant breakers, admission shedding and a
tick deadline, its lanes selected inside one graph replayed for the
whole fleet or for every tenant chunk, the overload board and the
fleet-scale record. Geo arbitrage: a fleet-day widened by per-region
lanes under the rollout kernels, the migration policies' expectation
dynamics over those lanes, and their Pareto fronts. The adversarial
scenario search: a population of scenario parameterizations folded into
one fleet-width stream, scored by one kernel launch an iteration of a
CEM search, the worst case minted and replayed. The continual-learning
flywheel: a generation recorded on the graphed service, its weak cells
mined, labeled by the factory and distilled into a challenger, evaluated
by the MLP kernel on the cells' worlds, shadowed and gated, promoted and
rolled back.
Phases, in order; any failure ends the run with a nonzero exit code:

1. the card: nvidia-smi's name and power limit, device properties;
2. build every CUDA source in each lane variant with nvcc (8 processes,
   all started together), printing registers and spill, and every kernel
   function's SASS counts (`cuobjdump -sass`, `kernels/build.py::
   sass_counts`: instructions, those of the tick loop, tensor-core HMMA,
   warp shuffles SHFL, special-function MUFU, slow-path CALLs, global
   loads LDG, spill loads and stores LDL/STL); a build whose MLP kernels
   hold no HMMA fails, and so does a profile build whose
   rollout_profiles_kernel instantiations hold no SHFL (the pair of lanes
   a cluster is then absent);
3. philox_uniform_kernel against `sim/random.uniforms`, bitwise. This
   kernel is on no rollout path (the rollout kernels inline the same
   device function); its launch count is this phase's;
4. default preset B = 8192 and multiregion B = 1024, T = 360, both
   modes: the rule kernel and the carbon kernel, each against its plain
   version (deterministic: batch means within 1e-4 relative, at least
   99.9 % of clusters within 2e-3 on every field; stochastic:
   `mean_parity_violations` empty, at least 99 % of clusters within
   2e-3), with whether they are bitwise equal; then the carbon kernel
   with other constants (sharpness 40, min_weight 0.2, stickiness 0)
   against the plain version under the same constants, and that they
   change `carbon_kg`;
4b. the plan kernel (the profile kernel's PLAN instantiation) against its
   plain version (`rollout_actions`' loop under the plan): default
   B = 8192 and multiregion B = 1024, T = 360, both modes, a random
   decoded plan per cluster and one broadcast to every cluster, at phase
   4's standard; a rule-equivalent plan bitwise the rule kernel; its time
   at multiregion B = 32768 x T = 2880 on a random plan;
5. the MLP kernel against `kernel_numerics_action_fn` (the tensor cores
   add the torso's sums in another order than the plain chains; the
   kernel rounds each hidden unit to the chain's side): (a) the shipped
   multiregion flagship, B = 1024 x T = 32, deterministic, every field's
   largest per-cluster relative difference within 1e-3 (five near-zero-
   denominator fields 2e-2); (d) the same with the replay checkpoint on
   the default preset; (b) multiregion B = 8192 x T = 360, both modes,
   `mean_parity_violations(..., NEURAL_MEAN_PARITY_TOLERANCES)` empty;
   (c) two stacked members: member 0 bitwise the single run, member 1
   (weights halved) another policy;
5b. the zero gates: on "off" fault lanes, on zero-rate workload lanes and
   on both, every lane instantiation of the three kernels gives bitwise
   what the plain-stream kernel gives (both presets, B = 8192 x T = 2880,
   both modes);
5c. each lane instantiation against its plain version (the plain rollout
   with the lanes threaded through): rule, carbon and the plan (a random
   decoded plan per cluster) on the severe, flash-crowd and mixed streams,
   multiregion B = 8192 x T = 360, both modes, at phase 4's standard; the
   MLP on the same streams at B = 1024 x T = 32 per cluster (phase 5's
   standard; denials, stale ticks, shed load and deadline misses among
   the near-zero fields) and at B = 8192 x T = 360 by
   NEURAL_MEAN_PARITY_TOLERANCES;
5e. the MLP kernel's forward layer by layer (`mlp_forward`, the C entry
   `ccka_mlp_forward` running the rollout kernel's device functions):
   the observations of the plain multiregion rollout's states on the
   calm stream at ticks 0, 60, 120 and 180, B = 32768, through the
   shipped flagship; `check_mlp_forward`: each pre-activation within
   2^-16 x sum_k |w[k][j] x[k]| of the plain float32 chain, x, h1, h2 and
   u bitwise given the kernel's own input to each layer; then
   `mlp_forward_departures`: every sum within 2^-20 x sum_k |w[k][j]
   x[k]| of the chain (the kernel's near-tie window, the premise of its
   bitwise rounding) and h1, h2 and u wholly bitwise the plain end-to-end
   forward; u's largest difference; the entry's time. Its launches are
   this phase's;
6. the rule path at default B = 32768 x T = 2880, stochastic: trace
   synthesis and `megakernel_rollout_summary`, with the launch counters
   zeroed just before and read just after; then the plain version on the
   same traces, held against it (the one plain check whose horizon
   reaches the peak hours, 09:00-21:00); the pack's and the kernel's
   time, its bound and its issue floor (the tick loop's SASS
   instructions x T x the launch's warps over the card's 4 x 132 warp
   schedulers at the SM clock nvidia-smi reads under load; also in
   phases 4b, 7 and 8);
7. the three-policy path at multiregion B = 32768 x T = 2880, stochastic:
   trace synthesis, one `_pack_exo`, then the rule, carbon and neural
   `*_summary_from_packed` entries on that stream and seed, with all
   launch counters zeroed just before and read just after, before any
   plain version runs; then all three results held against their plain
   versions on the same stream; the three policies' fleet means;
   each kernel's median time of 5 launches, its bound and cluster-days/s
   (the plain versions at T = 360 on the stream's first ticks, the kernels
   re-run there);
8. the rule kernel's time across fleet sizes B = 8192 ... 65536, both
   modes, against its bound and issue floor, with the lanes a cluster,
   the warps per SM the launch gives and those an SM holds at once;
9. the boards: first the graphed planner against the eager one, bitwise
   (multiregion N = 1024 x T = 96); then `fault_scoreboard` and
   `workload_scoreboard` at multiregion B = 32768 x T = 2880, stochastic,
   rule, carbon, flagship and mpc, each with the counters (by entry and
   by instantiation) zeroed just before and read just after; the
   planner's time; the boards' fleet means; then every stream once more
   from the same seed (its rows checked equal to the board's), timed:
   synthesis, each entry, each kernel as the median of 5 (the plan kernel
   on the board's plan, made again from the same calm rows); on severe
   and mixed each policy's result
   held against its plain version at T = 360 on the stream's first ticks
   (stochastic standard; the flagship's by
   NEURAL_MEAN_PARITY_TOLERANCES);
10. carried-state streaming (the main path of the fifth slice): (a)
   every CARRY instantiation (rule, carbon, MLP, plan x the plain,
   severe, flash-crowd and mixed streams x both modes), multiregion
   B = 8192 x T = 720 in blocks of 180: bitwise the non-carry kernel on
   the concatenated stream, its day timed against it; (b) at B = 1024
   x T = 32 in blocks of 16, both modes: the carried state after every
   block bitwise its plain version's `pack_carry`; (c) the streaming
   path at multiregion B = 32768 x T = 2880, stochastic, the mixed
   stream in 8 blocks of 360, rule, carbon, flagship and a per-cluster
   plan, each through the synchronous and the double-buffered drive,
   the CARRY counters zeroed just before and read just after, both
   drives bitwise each other and the unblocked reference, the walls, the
   occupancy and the two stream buffers; a day of 8 CARRY launches timed
   against one non-carry launch; the carried state after each of the
   day's first two blocks bitwise its plain version's at B = 32768; (d)
   the cluster-chunked rule drive at
   B = 262144 (8 chunks of 32768): wall, peak memory against two blocks
   and against the whole stream, the last chunk bitwise a single-chunk
   run;
11. the training path (the main path of the eighth slice), multiregion
   with the shipped net's widths (36 -> 128 -> 128 -> 18): (a) the carbon
   teacher distilled (`collect_dataset` at B = 256 x T = 256, `imitate`
   300 iterations at minibatch 4096; both losses finite and falling);
   (b) two CEM generations on the mega engine from (a)'s params, NP = 64
   members x G = 256 traces x T = 2880, the counters zeroed just before
   and read just after: one rule, one carbon and one population launch a
   generation; generation 0's population launch held member by member
   against `population_plain_summary` (the batched
   `kernel_numerics_action_fn`) at T = 720 by
   NEURAL_MEAN_PARITY_TOLERANCES, its rule and carbon bars at phase 4's
   stochastic standard; the generation's stages timed alone (synthesis,
   the three launches, the host's rest) and the population launch's
   bound; (c) three PPO iterations at B = 256 x T = 64, diagnostics
   finite, seconds each; (d) one `produce_cell` at its defaults (64 pairs
   x 96 ticks in blocks of 48, diurnal-inference under moderate faults):
   its CARRY playback and rule column bitwise
   `unblocked_reference_summary`, its pairs/s against
   `naive_lax_pair_rate`, one pair timed on its first 4 of 12 plan
   segments (32 ticks; each segment plans the same horizon of 32 at the
   same iterations, so a 96-tick pair takes 3 times as long); a
   selection evaluation timed (5 x 2880 eager ticks); (e)
   `train_flagship` through `main` (distill:carbon, cem on the mega engine, 2 generations, selection on
   5 x 2880) with the counters around it, the npz loaded back and its
   digest checked;
12. the closed control loop (the main path of the ninth slice; no
   kernel on it: the controller's step is the eager plain step), the
   multiregion preset with the shipped flagship: (a) `controller_from_
   config(device="cuda")` drives 96 ticks from the synthetic source
   started at 08:36 (ticks 0-47 off-peak, 48-95 peak) for rule, carbon,
   ppo and mpc (oracle windows, replan every 8), each through dry-run
   sinks, one shared SpanTracer, a MetricsExporter on port 0 scraped once
   over 127.0.0.1, JSONL telemetry and a snapshot every tick; each
   stage's median and p99 ms (scrape, decide, render, apply, verify,
   estimate, the whole tick, the mpc replan ticks' decide); the Chrome
   trace through `validate_chrome_trace` (must be empty);
   `compile_report()`, failing on a hot entry captured again after its
   warm-up; (b) the same four sessions on the CPU: rule and carbon must
   give byte-identical command streams and every report float within
   1e-5 relative (pending pods at the demand's scale); ppo and mpc print
   the ticks whose patches differ and the largest field difference
   (mpc's CPU session runs in a process of its own beside (a), (c) and
   (d), and is read after them); (c)
   each card run killed at three seeded ticks and resumed from its
   snapshot in a fresh Controller with a fresh backend (mpc's sharing
   (a)'s captured planner graph, a pure function): fingerprints
   (`harness/recovery.py::_fingerprint`) and command streams bitwise the
   uninterrupted run's; (d) `recovery_scoreboard` at bench_recovery's
   size cut to 4 runs a cell (rule and flagship x off, mild, moderate,
   severe x 4 runs x 32 ticks, seed 101; 8 runs there) on the card: 0 duplicate and 0 lost patches, a
   bitwise-resume share of 1.0, every usd_per_slo_hr_vs_baseline 1.0; its
   wall. It writes `runs/chip_smoke_loop/`;
13. the command line (the main path of the tenth slice), each
   subcommand through `ccka_tpu_torch.cli.main` with its default device:
   (a) `preroll` exits 0, its device row names the card and its kernel
   row launched the rule kernel once; (b) `simulate` at the default
   preset, `--clusters 32768 --days 1 --stochastic --device-traces`,
   under rule, carbon and neutral: one profile kernel launch a run (the
   carbon instantiation for carbon) and no call of a plain version, each
   run timed; then `--clusters 1024 --days 0.125` on host traces, each
   policy: the report bitwise the direct kernel entry's means on the same
   traces, the entry held against its plain version at phase 4's
   deterministic standard; (c) `evaluate --backends rule,carbon,ppo
   --days 0.0625 --traces 4 --deterministic` (multiregion) on the card
   and with `--device cpu`: every field within 1e-5 relative (rule,
   carbon) and 1e-3 (ppo; its SLO-gated fields may differ by one flipped
   cluster-tick, counted and printed); (d) `chaos-eval --policies
   rule,carbon,flagship --intensities off,severe` (the board needs its
   calm denominator) and `scenario-eval --scenarios mixed`, both at
   `--traces 32768 --steps 2880`: each JSON bitwise a direct
   `fault_scoreboard` / `workload_scoreboard` call with the same
   arguments, the launch counters read by instantiation; (e) `train
   --backend ppo --iterations 1` writes `runs/chip_smoke_cli/ppo`, and
   `observe --backend ppo --checkpoint` on the card agrees with `--device
   cpu` within 1e-6; (f) the profile commands' and operator tools'
   output, printed as `# cli` lines and checked to be non-empty;
14. the fleet controller and replayed streams (the main paths of the
   eleventh slice): (a) the replay device samplers on the default
   preset's 9-day store (`data/replay_train_9day.npz`): 256 windows of
   a day bitwise the host slices at the same offsets, the packed stream
   (B = 32768 x T = 2880) bitwise `_pack_exo` of its windows, 8 blocks
   of 360 bitwise the unblocked stream; on that replayed day, stochastic,
   the rule, carbon and MLP (the replay flagship) kernels with the
   counters zeroed just before and read just after (one launch each),
   each timed (median of 5) with its bound and held against its plain
   version (B = 1024 x T = 360 both modes at phase 4's standard, the MLP
   at B = 1024 x T = 32 at phase 5a's); the same three on a replayed
   stream with mild faults and the mixed families (the
   <FAULTS,WL_D=16> instantiations, at phase 5c's standard: B = 8192 x
   T = 360, the MLP per cluster at B = 1024 x T = 32); the rule CARRY
   drive over the replayed day in 8 blocks, and the same day through the
   streaming pipeline (`sim/streaming.py`, sync and double-buffered, its
   stream buffers reused), each bitwise the unblocked kernel; two CEM
   generations on the replay source (NP = 64 x G = 256 x T = 2880), the
   second writing its stream into the first's buffer: one rule, one
   carbon and one population launch each; (b) the batched fleet tick (`harness/fleet.py`,
   one CUDA graph a tick), multiregion with the shipped flagship, under
   rule, carbon and ppo (mpc is refused, naming itself): N = 1, 1024,
   10240 at horizon 2880, 32 chained ticks through the graph and its
   eager body, every output bitwise, each tick's time (median, p99);
   N = 1024: each backend's 8 full ticks with the dry-run fan-out,
   pipelined bitwise sequential, the fleet.dispatch/harvest/fanout
   spans; the card against the CPU over 4 ticks on the same traces (rows
   within 1e-5 relative, the flagship's 1e-3 and its actions 5e-3; rule
   and carbon command streams byte-identical);
   ledger-on (DecisionLedger, and a TournamentLedger over rule, carbon,
   carbon-sharp) bitwise ledger-off, term shares summing to 1, the rule
   fleet's divergence 0; killed at tick 4 and restored into a fresh
   controller, bitwise; `compile_report()`: one fleet.tick capture per
   key, no recapture; (c) the controller's ledgers: multiregion, ppo, 48
   ticks through a severe ChaosSink per region, incident log (with its
   flight recorder) and decision ledger on, then off: command streams
   and fingerprints bitwise, every incident count equal to its trigger's
   counter; then `incidents list|show|timeline`, `decisions
   list|explain` and `tournament list|board` through `cli.main` on the
   files written (`runs/chip_smoke_fleet/`);
15. the multi-tenant service (the main path of the twelfth slice; no
   kernel: the service tick is plain PyTorch captured as a CUDA graph):
   (a) multiregion with the shipped flagship, rule, carbon and ppo,
   horizon 2880 (mpc refused, naming itself): N = 1024 as one graph and
   N = 10240 as one 256-tenant chunk graph replayed 40 times a tick, 16
   chained ticks whose lane vectors mix fresh, held and fallback rows,
   every replay bitwise its eager body, the N = 1024 chunk graph's rows
   bitwise the whole graph's; ms a tick (median, p99), graphed and
   eager; the service's dispatch a tick, the bytes it copies, and the
   stream copied into each graph once; (b) the card against the CPU,
   N = 64 x 8 ticks on one world, a stressed tenant mix on the
   deterministic clock: report counters and lanes equal, rows within
   1e-5 relative (the flagship's 1e-3, actions 5e-3), rule and carbon
   command streams byte-identical; (c) `overload_scoreboard` at
   bench_overload's grid (multiregion; 16 and 64 tenants; off, moderate,
   severe; slow fractions 0, 0.25, 0.5; rule and flagship; 48 ticks;
   seed 211) on the real clock: every healthy tenant's paired ratio
   exactly 1.0, each cell's p50/p99 against the 250 ms deadline and its
   counters; (d) `fleet_scale_record` at its defaults (default preset,
   N = 16 ... 10240, 12 ticks): vectorized bitwise object, chunked
   bitwise unchunked, the healthy ratio exactly 1.0, the speedup and
   the host us per tenant; (e) obs on (recorder, burn rate, decision and
   tournament ledgers) against off, 16 tenants x 48 ticks, ppo: rows,
   states and command streams bitwise, every incident dump verifies;
   `fleet --service default --obs ...` and `overload-eval` through
   `cli.main`; `compile_report()`: one service.tick capture per key,
   one service.tick_chunk capture per (key, chunk), none again
   (`runs/chip_smoke_service/`);
16. geo arbitrage (the main path of the thirteenth slice; no new kernel:
   the rollout kernels on a stream widened by the region block), multi-
   region, the spot-storm GeoConfig: (a) a day of B = 32768 widened to 80
   rows, its first 16 bitwise the plain stream, the region block's
   synthesis timed; the rule, carbon, MLP and plan kernels on it, counted
   and timed, bitwise the plain stream's, every field; the
   <FAULTS,WL_D=16> instantiations on 104 rows (faults, workloads and
   regions, B = 8192) bitwise on the 40-row stream; each kernel against
   its plain version on a widened stream (B = 1024 x T = 360, the MLP
   also at T = 32); (b) the widened day in 8 blocks through the
   synchronous and double-buffered drives (rule, carbon, flagship: the
   CARRY kernels), bitwise the plain stream's drives; (c) the Pareto
   suite at the command line's shape, its lanes drawn on the card,
   card against CPU on those lanes (every number but the residuals
   within 1e-4 relative, fronts equal, residuals within 0.01 pods),
   then every migration policy on the 16a block (T = 2880 x
   B = 32768): `none` bitwise a zero override, seconds a rollout,
   residual within 0.01 pods (with the queues' rounding ledger; the
   JAX package's formula without it reported), dominance reported;
   (d) `geo --json` in a process of its own equal to the direct call, a
   service's geo gauges {} before the publish and the snapshot after it,
   with both exporter series;
17. the scenario axis and the adversarial search (the main path of the
   fourteenth slice; no new kernel: the rule and carbon <FAULTS,WL_D=16>
   instantiations on a 104-row stream of S cells), default preset (Z = 3,
   one region): (a) an S = 1 axis stream at B = 8192 x T = 2880 bitwise
   the baked source's; cell 5 of the 12 x 2048 population stream
   (29.4 GB) bitwise its baked source's; (b) both kernels on the
   population stream, counted, timed against their bounds, and held
   against their plain versions at S = 4 x inner 256 x T = 360, both
   modes (phase 4's standard); (c) `search_scenarios` (rule, 5 x 12 at
   inner 2048 x T = 2880), the counters zeroed just before and read just
   after (10 launches): each iteration's synthesis, kernel and host
   seconds, peak bytes, the minted value and dominance, `replay_minted`
   exactly equal; 12 cells in one launch against 3 through baked sources
   one at a time, reported; (d) `scenario-search --iters 2 --pop 4
   --mint-out` in a process of its own, `scenarios --minted-dir` listing
   the mint, a tampered copy refused; (e) a blocked axis day (8 x 360,
   S = 4 x 2048) through the double-buffered drive on the rule CARRY
   kernel, bitwise the unblocked reference, S = 1 blocks bitwise the
   baked blocks. It writes `runs/chip_smoke_search/`;
18. the continual-learning flywheel (the main path of the fifteenth
   slice; no new kernel: the factory's plan and rule CARRY
   instantiations and the MLP kernel on the cells' lane streams), the
   default preset at bench_flywheel's geometry (6 tenants, 16 record and
   shadow ticks, 10 watch ticks, top 3 cells, 3 to 6 pairs x 40 ticks,
   150 Adam iterations, seed 23, runner seed 211): (a) generation 1
   through a `FlywheelRunner` on a `Flywheel(device="cuda")`, each
   stage timed (record, mine, distill with each cell's
   gen/plan/label/collect and `imitate`, evaluate, shadow, gates), the
   counters zeroed just before and read just after (per cell one plan
   and one rule CARRY launch a block and one MLP launch), the service's
   graph captures and the memory the tick cache keeps; (b) each
   evaluated cell's challenger summary, the MLP kernel's on the
   regenerated stream, equal to its row and held against its plain
   version per cluster (phases 5c/14a's standard), the rule column
   bitwise `unblocked_reference_summary`, and the rule and teacher
   columns (the CARRY launches at the cells' B = 3-6) held against their
   plain versions by the same standard; (c) generation 1 recorded,
   mined and distilled again in a fresh root: the same cells,
   curriculum digest and checkpoint digest; (d) an eligible decision
   promoted and demoted by one policy_divergence incident of the watch,
   or an ineligible one refused by `promote`; the gates and mean_ratio
   printed; (e) `flywheel status --device cuda` from the shell equal to
   `Flywheel.status()`. It writes `runs/chip_smoke_flywheel/`;
19. the device mesh (the main path of the sixteenth slice,
   `ccka_tpu_torch/parallel/`; no new kernel: every launch takes its
   first cluster's global index, ``b0``), a [4, 1] mesh over cuda:0 at
   B = 32768 x T = 2880, 8192 clusters a shard, the counters zeroed just
   before each mesh run and read just after (the "mesh path (phase 19)"
   entries): (a) rule, carbon, the MLP with a population of 2 and a
   per-cluster plan, default and multiregion, shard-local synthesis
   bitwise the generator on each shard's key and every field of every
   cluster bitwise the single launch on the gathered stream, with the
   rule shards' times and imbalance; (b) the streamed mixed day over the
   mesh, four routes, bitwise the single-device drive over the same
   shard blocks; (c) a CEM mega generation over the mesh bitwise a
   single-device one on the same draws; (d) the planner over the mesh
   with its plans donated, bitwise the unsharded call; (e) a PPO
   iteration on a [2, 2] mesh within rtol 2e-4 / atol 2e-5 of the
   unsharded one, and `simulate --mesh` from the shell equal to
   `simulate`;
20. one JSON line listing every kernel and lane instantiation, the
   card's line, and the result.


Cut for time (the plain version's eager tick and the planner of the mpc
rows set most of the run): phases 7 and 9 hold their kernels against
the plain versions on the full-size streams' first ticks (they held all
2880 ticks before); phases 4-5c, 7 and 9 hold them over 360 ticks from
midnight (720 before; neither reaches the peak hours, which phase 6's
full day covers); phase 11d times the naive pair on a third of its
segments.

The bound of a call is the larger of its bytes (each input row the kernel
reads, once, its weights, the plan rows it reads and its output) over
HBM's rate and its
operations over the card's peak rate for their type: the float operations
of the plain version's tick, counted by dispatch, at the float32 rate for
multiplies and adds that are not fused; for the MLP kernel also the
torso's products at the dense bf16 tensor-core rate and the head's at the
float32 rate. Operations of one execution unit add up (the tick and the
head both need the float32 pipes); the tensor cores, the float32 pipes
and HBM work side by side, so the slowest of them sets the bound. The
terms, each unit's sum and the unit that sets the bound are printed
beside it.

It needs no network and runs no JAX.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time
import types

import numpy as np
import torch

# H100 SXM published peaks (dense, no sparsity). The 67 TFLOP/s float32
# rate counts a fused multiply-add as two operations; the kernels are built
# with -fmad=false, so each multiply and add of the tick issues alone, at
# half of it.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F32_UNFUSED_OPS_PER_S = F32_OPS_PER_S / 2
BF16_TENSOR_OPS_PER_S = 989e12

T_DAY = 2880
T_SHORT = 32
# The depth of the plain versions held from midnight in phases 4-5c, 7
# and 9 (the plain version's eager tick sets their time).
T_PARITY = 360
T_BLOCKED = 720  # phase 10a's blocked day (4 blocks of 180)
T_POP = 720      # phase 11b's population held member by member
B_PARITY = 8192
B_MULTI = 1024
B_MAIN = 32768
SWEEP = (8192, 16384, 32768, 65536)
N_TIMED = 5
OUT_ROWS = 24
CARBON_OTHER = dict(sharpness=40.0, min_weight=0.2, stickiness=0.0)
# tests/test_megakernel.py::test_short_horizon_exact's standard.
SHORT_TOL, SHORT_LOOSE_TOL = 1e-3, 2e-2
SHORT_LOOSE = ("evictions", "queue_depth_mean", "interruptions",
               "spot_exposure", "waste_frac")


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, n: int = 1) -> list[float]:
    """Times of ``n`` calls of ``fn`` on the current stream (CUDA events)."""
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def median_ms(fn) -> float:
    """Median of N_TIMED calls of ``fn``, after a warm-up."""
    cuda_ms(fn, 1)
    return float(np.median(cuda_ms(fn, N_TIMED)))


def field_rel(a, b) -> dict:
    """Every field's largest per-cluster relative difference,
    ``|a - b| / (|b| + 1e-6)``; fails on a non-finite value."""
    out = {}
    for f in a._fields:
        x = getattr(a, f).double()
        y = getattr(b, f).double()
        if not (torch.isfinite(x).all() and torch.isfinite(y).all()):
            fail(f"non-finite values in field {f}")
        out[f] = float(((x - y).abs() / (y.abs() + 1e-6)).max())
    return out


def per_cluster_share(a, b, tol: float = 2e-3):
    """Share of clusters whose every field agrees within ``tol`` relative,
    the worst field, and the largest absolute difference."""
    ok = None
    max_abs = 0.0
    for f in a._fields:
        x = getattr(a, f).double()
        y = getattr(b, f).double()
        good = (x - y).abs() / (y.abs() + 1e-6) <= tol
        ok = good if ok is None else ok & good
        max_abs = max(max_abs, float((x - y).abs().max()))
    rel = field_rel(a, b)
    worst = max(rel, key=rel.get)
    return float(ok.double().mean()), worst, rel[worst], max_abs


def bitwise(a, b) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in a._fields)


def mean_rel(a, b) -> dict:
    out = {}
    for f in a._fields:
        x = getattr(a, f).double().mean().item()
        y = getattr(b, f).double().mean().item()
        out[f] = abs(x - y) / (abs(y) + 1e-9)
    return out


def bound(nbytes: float, op_terms: dict) -> tuple[float, str, dict]:
    """(least time in ms, "bytes" or "operations", every term in ms) for a
    call that moves ``nbytes`` and does ``op_terms``: name -> (operations,
    the card's rate for their type, the unit that executes them). Terms of
    one unit add up; the units (HBM, the float32 pipes, the tensor cores)
    run side by side, so the bound is the slowest unit's time. The dict
    also gives each unit's sum under ``unit:<name>`` and the unit that
    sets the bound under ``set_by``."""
    terms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3}
    units: dict = {}
    for name, (ops, rate, unit) in op_terms.items():
        terms[name] = ops / rate * 1e3
        units[unit] = units.get(unit, 0.0) + terms[name]
    slowest = max(units, key=units.get)
    by_bytes = terms["bytes"] >= units[slowest]
    terms.update({f"unit:{u}": ms for u, ms in units.items()})
    terms["set_by"] = "hbm" if by_bytes else slowest
    return (max(terms["bytes"], units[slowest]),
            "bytes" if by_bytes else "operations", terms)


def rollout_bytes(Z: int, B: int, T: int, weight_bytes: int = 0,
                  faults: bool = False, workloads: bool = False,
                  plan_rows: int = 0) -> int:
    """Bytes a rollout kernel must move: the stream rows it reads (spot,
    od, carbon per zone, two demands, is_peak; with faults the Z+3 fault
    rows, with workloads the 3 arrival rows; not the padding rows) once
    per tick, a per-cluster plan's used rows, its weights, and its
    [24, B] output."""
    rows = (3 * Z + 3 + (Z + 3 if faults else 0) + (3 if workloads else 0)
            + plan_rows)
    return (rows * T + OUT_ROWS) * B * 4 + weight_bytes


# rollout_profiles_kernel's layout (csrc/rollout_profiles.cu: kGroup lanes
# a cluster, kBlock threads a block); four warp schedulers an SM.
PAIR, PROFILE_BLOCK, SCHEDULERS_PER_SM = 2, 64, 4
_POLICY_NAMES = ("rule", "carbon", "plan")


def profile_key(name: str) -> tuple | None:
    """(policy, Z, stochastic, faults, wl_depth, carry) of a
    rollout_profiles_kernel function name, mangled or demangled."""
    m = re.search(r"rollout_profiles_kernel<2, (\d+), 3, (true|false), "
                  r"(\d+), (true|false), (\d+), (true|false)>", name)
    if m:
        z, st, pol, fa, wl, ca = m.groups()
        flags = [v == "true" for v in (st, fa, ca)]
    else:
        m = re.search(r"rollout_profiles_kernelILi2ELi(\d+)ELi3ELb(\d)ELi"
                      r"(\d+)ELb(\d)ELi(\d+)ELb(\d)E", name)
        if not m:
            return None
        z, st, pol, fa, wl, ca = m.groups()
        flags = [v == "1" for v in (st, fa, ca)]
    return (_POLICY_NAMES[int(pol)], int(z), flags[0], flags[1], int(wl),
            flags[2])


class ProfileBuilds:
    """What phase 2 reads off every rollout_profiles_kernel instantiation,
    keyed by profile_key: its tick loop's SASS instructions (``loop``) and
    its registers (``regs``, ptxas); and the SM clock nvidia-smi reads
    under load, read once."""

    def __init__(self):
        self.loop: dict = {}
        self.regs: dict = {}
        self.clock_mhz: float | None = None

    def sm_clock_mhz(self, fn) -> float:
        """The SM clock while 40 launches of ``fn`` run (the first
        reading is kept for the whole run)."""
        if self.clock_mhz is None:
            for _ in range(40):
                fn()
            self.clock_mhz = float(subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True, check=True, timeout=60).stdout.split()[0])
            torch.cuda.synchronize()
            log(f"# SM clock under load: {self.clock_mhz:.0f} MHz")
        return self.clock_mhz

    def issue_floor_ms(self, key: tuple, B: int, T: int, fn) -> float:
        """The least time the warp schedulers take to issue the profile
        kernel's tick loop for B clusters x T ticks, one instruction a
        cycle each: the loop's SASS instructions x T x the launch's warps
        (PAIR lanes a cluster) over the card's schedulers at the SM clock
        read while ``fn`` runs. A pair issues each cluster's shared work
        twice, so this says how far the layout is from what its
        instruction stream allows."""
        warps = math.ceil(PAIR * B / 32)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        return (self.loop[key] * T * warps
                / (SCHEDULERS_PER_SM * sms * self.sm_clock_mhz(fn) * 1e6)
                * 1e3)

    def resident_warps_per_sm(self, key: tuple, B: int) -> float:
        """Warps of a B-cluster launch an SM holds at once: the launch's
        warps per SM, capped by what the instantiation's registers
        (allocated in units of 8) leave room for."""
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        regs = -(-self.regs[key] // 8) * 8
        blocks = min(32, 65536 // (regs * PROFILE_BLOCK))
        return min(math.ceil(PAIR * B / 32) / sms,
                   blocks * PROFILE_BLOCK / 32)


def float_ops_per_cluster_tick(cfg, stochastic: bool, policy: str = "rule",
                               net_params=None, faults: bool = False,
                               workloads: bool = False) -> int:
    """Floating-point pointwise operations of one tick of the plain step
    for one cluster under ``policy`` (with its uniforms' conversion in
    stochastic mode; with ``faults`` the fault branch and the held
    observation, with ``workloads`` the D = 16 queues), counted by
    dispatching it on the CPU. The MLP's chained products (`addcmul`) are
    left out: the bound counts them from the layer widths."""
    from ccka_tpu_torch.faults.types import FaultStep
    from ccka_tpu_torch.policy.carbon import CarbonAwarePolicy
    from ccka_tpu_torch.policy.rule import RulePolicy
    from ccka_tpu_torch.sim import megakernel as mk
    from ccka_tpu_torch.sim.dynamics import ExoStep, step
    from ccka_tpu_torch.sim.random import uniforms
    from ccka_tpu_torch.sim.rollout import initial_state, observed_exo
    from ccka_tpu_torch.sim.types import SimParams
    from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource
    from ccka_tpu_torch.workloads.types import WorkloadState, WorkloadStep

    params = SimParams.from_config(cfg, device="cpu")
    src = SyntheticSignalSource(cfg.cluster, cfg.workload, cfg.sim,
                                cfg.signals)
    tr = src.batch_trace(1, [0], device="cpu")
    exo = ExoStep(*(x[:, 0] for x in tr))
    state = initial_state(cfg, 1, device="cpu")
    P, Z = cfg.cluster.n_pools, cfg.cluster.n_zones
    action_fn = {
        "rule": lambda: RulePolicy(cfg.cluster, device="cpu").action_fn(),
        "carbon": lambda: CarbonAwarePolicy(cfg.cluster,
                                            device="cpu").action_fn(),
        "mlp": lambda: mk.kernel_numerics_action_fn(net_params, cfg.cluster,
                                                    params),
        # A plan's action is loaded, not computed.
        "plan": lambda: (lambda s, e, t, a=RulePolicy(
            cfg.cluster, device="cpu").off: a),
    }[policy]()
    one = torch.ones((1,))
    fault = (FaultStep(torch.full((1, Z), 2.0), 0.5 * one, 0.5 * one, one)
             if faults else None)
    lanes = (dict(workload=WorkloadStep(one, one, one),
                  wl_state=WorkloadState.zero(16, 1, "cpu"))
             if workloads else {})
    def one_tick():
        u3 = (uniforms(0, torch.zeros((1, 1), dtype=torch.int64), 0,
                       torch.arange(P * Z)[None, :]).reshape(3, 1, P, Z)
              if stochastic else None)
        obs = (observed_exo(exo, exo, fault.signal_stale)
               if faults and policy in ("carbon", "mlp") else exo)
        action = action_fn(state, obs, 0)
        step(params, state, action, exo, u3, stochastic=stochastic,
             fault=fault, **lanes)

    return pointwise_ops(one_tick)


def pointwise_ops(fn) -> int:
    """Elements written by the floating-point pointwise operations that
    ``fn()`` dispatches (on the CPU), the chained products' `addcmul`s
    left out: a bound counts those from the layer widths."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if (torch.Tag.pointwise in func.tags
                    and isinstance(out, torch.Tensor)
                    and out.dtype.is_floating_point
                    and func is not torch.ops.aten.addcmul.default):
                Count.n += out.numel()
            return out

    with Count():
        fn()
    return Count.n


# ---- the fault- and workload-widened paths (phases 5b, 5c, 9)

LANE_SEED = 5
BOARD_SEED, BOARD_TRACE_SEED = 31, 97
POLICIES = ("rule", "carbon", "mlp")
# The boards' rows and their kernels: "plan" is the mpc row's.
BOARD_POLICIES = POLICIES + ("plan",)
BOARD_ROW = {"rule": "rule", "carbon": "carbon", "mlp": "flagship",
             "plan": "mpc"}
PLAN_REPLACES = "ccka_tpu/sim/megakernel.py:1657"
PLAN_SEED = 79
FAULT_LEVELS = ("off", "mild", "moderate", "severe")
SCENARIOS = ("diurnal-inference", "flash-crowd", "batch-backfill", "mixed")
# The TPU kernel's lines of each branch (ccka_tpu/sim/megakernel.py).
REPLACES = {"FAULTS": "ccka_tpu/sim/megakernel.py:400",
            "WL_D=16": "ccka_tpu/sim/megakernel.py:780"}


def lane_source(cfg, name: str):
    """(source, its WorkloadsConfig or None) of a fault intensity or a
    workload scenario."""
    from ccka_tpu_torch.config import FAULT_PRESETS
    from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource
    from ccka_tpu_torch.workloads.scenarios import (WORKLOAD_SCENARIOS,
                                                    scenario_source)

    if name in WORKLOAD_SCENARIOS:
        sc = WORKLOAD_SCENARIOS[name]
        return scenario_source(cfg, sc), sc.workloads
    return SyntheticSignalSource(cfg.cluster, cfg.workload, cfg.sim,
                                 cfg.signals,
                                 faults=FAULT_PRESETS[name]), None


def lane_params(cfg, workloads, dev):
    """SimParams of ``cfg`` under a scenario's WorkloadsConfig."""
    import dataclasses

    from ccka_tpu_torch.sim.types import SimParams

    if workloads is not None:
        cfg = dataclasses.replace(cfg, workloads=workloads)
    return SimParams.from_config(cfg, device=dev)


def random_plan(cfg, B: int, T: int, T_pad: int, dev, seed=PLAN_SEED):
    """A per-cluster plan [T_pad, plan_rows, B]: latents 0.3 * N(0, 1),
    decoded by the codec, packed."""
    from ccka_tpu_torch.models.nets import latent_dim, latent_to_action
    from ccka_tpu_torch.sim import megakernel as mk

    lat = 0.3 * torch.randn((B, T, latent_dim(cfg.cluster)), device=dev,
                            generator=torch.Generator(
                                device=dev).manual_seed(seed))
    return mk.pack_plan(latent_to_action(lat, cfg.cluster), T_pad)


def run_entry(policy, cfg, params, net, stream, T, stochastic,
              seed=LANE_SEED, plan=None):
    """The packed entry of ``policy`` (the kernel on a CUDA stream);
    "plan" plays ``plan`` back."""
    from ccka_tpu_torch.policy.rule import offpeak_action, peak_action
    from ccka_tpu_torch.sim import megakernel as mk

    dev = stream.device
    off, peak = offpeak_action(cfg.cluster, dev), peak_action(cfg.cluster,
                                                              dev)
    kw = dict(seed=seed, stochastic=stochastic)
    if policy == "plan":
        return mk.plan_megakernel_summary_from_packed(
            params, cfg.cluster, plan, stream, T, **kw)
    if policy == "rule":
        return mk.megakernel_summary_from_packed(params, off, peak, stream,
                                                 T, **kw)
    if policy == "carbon":
        return mk.carbon_megakernel_summary_from_packed(
            params, off, peak, stream, T, **kw)
    return mk.neural_megakernel_summary_from_packed(params, cfg.cluster, net,
                                                    stream, T, **kw)


def lane_plain(policy, cfg, params, net, stream, T, stochastic,
               seed=LANE_SEED, plan=None):
    """The plain version on the card: `batched_rollout_summary` under the
    policy's action function (for "plan", tick t's row of ``plan``), the
    stream's lanes threaded through."""
    from ccka_tpu_torch.faults.process import unpack_fault_lanes
    from ccka_tpu_torch.policy.carbon import CarbonAwarePolicy
    from ccka_tpu_torch.policy.rule import RulePolicy
    from ccka_tpu_torch.sim import megakernel as mk
    from ccka_tpu_torch.sim.lanes import resolve_layout
    from ccka_tpu_torch.sim.rollout import (batched_rollout_summary,
                                            initial_state)
    from ccka_tpu_torch.workloads.process import unpack_workload_lanes

    dev = stream.device
    Z = cfg.cluster.n_zones
    layout = resolve_layout(stream.shape[1], Z)
    action_fn = {
        "rule": lambda: RulePolicy(cfg.cluster, dev).action_fn(),
        "carbon": lambda: CarbonAwarePolicy(cfg.cluster,
                                            device=dev).action_fn(),
        "mlp": lambda: mk.kernel_numerics_action_fn(net, cfg.cluster,
                                                    params),
        "plan": lambda: mk.plan_action_fn(
            mk.unpack_plan(plan, T, cfg.cluster.n_pools, Z),
            plan.dim() == 3)}[policy]()
    return batched_rollout_summary(
        params, initial_state(cfg, stream.shape[2], dev), action_fn,
        mk.unpack_exo(stream, T, Z), seed, stochastic=stochastic,
        faults=(unpack_fault_lanes(stream, T, Z) if layout.has("faults")
                else None),
        workloads=(unpack_workload_lanes(stream, T, Z)
                   if layout.has("workloads") else None))[1]


def instantiation_name(policy: str, name: str) -> str:
    """The kernel instantiation a policy runs on a lane stream."""
    from ccka_tpu_torch.kernels import build
    from ccka_tpu_torch.workloads.scenarios import WORKLOAD_SCENARIOS

    sc = WORKLOAD_SCENARIOS.get(name)
    faults = sc is None or bool(sc.fault_preset)
    suffix = build.instantiation(policy, faults,
                                 16 if sc is not None else 0)
    return ("rollout_mlp_kernel" if policy == "mlp"
            else "rollout_profiles_kernel") + suffix


def lane_phases(dev, setup, hold) -> dict:
    """5b: the zero gates: on "off" fault lanes and on zero-rate workload
    lanes every lane instantiation gives, bitwise, what the plain-stream
    kernel gives (both presets, both modes). 5c: each lane instantiation
    against its plain version: rule, carbon and a random per-cluster plan
    on severe, flash-crowd and mixed (multiregion B = 8192 x T = 360, both
    modes); the MLP on the
    same streams per cluster at B = 1024 x T = 32 and by
    NEURAL_MEAN_PARITY_TOLERANCES at B = 8192 x T = 360, deterministic.
    Returns {instantiation: parity record}."""
    from ccka_tpu_torch.config import FAULT_PRESETS, WorkloadsConfig
    from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource
    from ccka_tpu_torch.sim import megakernel as mk

    zero = WorkloadsConfig(enabled=True, inference_rate_pods=0.0,
                           batch_rate_pods=0.0, background_rate_pods=0.0)
    for preset, variant in (("default", "replay"), ("multiregion", "")):
        cfg, _, params, _, _, net = setup(preset, variant)

        def stream(**kw):
            return SyntheticSignalSource(
                cfg.cluster, cfg.workload, cfg.sim, cfg.signals, **kw
            ).packed_trace_device(T_DAY, 61, B_PARITY, device=dev)

        base = stream()
        widened = {"off faults": stream(faults=FAULT_PRESETS["off"]),
                   "zero-rate workloads": stream(workloads=zero),
                   "both": stream(faults=FAULT_PRESETS["off"],
                                  workloads=zero)}
        n = 0
        for policy in POLICIES:
            for st in (False, True):
                want = run_entry(policy, cfg, params, net, base, T_DAY, st)
                for name, s in widened.items():
                    got = run_entry(policy, cfg, params, net, s, T_DAY, st)
                    torch.cuda.synchronize()
                    n += 1
                    if not bitwise(got, want):
                        fail(f"zero gate: {policy} on {name} ({preset}, "
                             f"stochastic={st}) is not bitwise the "
                             f"plain-stream kernel")
        log(f"# zero gates {preset} B={B_PARITY} T={T_DAY}: {n} lane runs "
            f"(rule, carbon, mlp x off faults, zero-rate workloads, both x "
            f"two modes), every one bitwise the plain-stream kernel")
        del base, widened
        torch.cuda.empty_cache()

    found: dict = {}
    cfg, _, _, _, _, net = setup("multiregion")
    plan = random_plan(cfg, B_PARITY, T_PARITY, T_PARITY, dev)
    for name in ("severe", "flash-crowd", "mixed"):
        source, wl = lane_source(cfg, name)
        params = lane_params(cfg, wl, dev)
        stream = source.packed_trace_device(T_PARITY, 67, B_PARITY,
                                            device=dev)
        for policy in ("rule", "carbon", "plan"):
            label = instantiation_name(policy, name)
            for st in (False, True):
                k = run_entry(policy, cfg, params, net, stream, T_PARITY, st,
                              plan=plan)
                t0 = time.perf_counter()
                p = lane_plain(policy, cfg, params, net, stream, T_PARITY, st,
                               plan=plan)
                torch.cuda.synchronize()
                plain_s = time.perf_counter() - t0
                same, max_abs = hold(
                    f"{label} {name} multiregion B={B_PARITY} T={T_PARITY} "
                    f"{'stochastic' if st else 'deterministic'}", k, p, st)
                rec = found.setdefault(label, {"bitwise": True,
                                               "max_abs_err": 0.0})
                rec["bitwise"] &= same
                rec["max_abs_err"] = max(rec["max_abs_err"], max_abs)
                rec["plain_ms"] = plain_s * 1e3
                rec["shape"] = (f"{name} multiregion B={B_PARITY} "
                                f"T={T_PARITY} "
                                f"{'stochastic' if st else 'deterministic'}")
        label = instantiation_name("mlp", name)
        short = source.packed_trace_device(T_SHORT, 71, B_MULTI, device=dev)
        k = run_entry("mlp", cfg, params, net, short, T_SHORT, False)
        p = lane_plain("mlp", cfg, params, net, short, T_SHORT, False)
        rel = field_rel(k, p)
        loose = SHORT_LOOSE + ("denials", "stale_ticks", "inf_dropped",
                               "batch_deadline_misses")
        bad = {f: r for f, r in rel.items()
               if r > (SHORT_LOOSE_TOL if f in loose else SHORT_TOL)}
        worst = max(rel, key=rel.get)
        log(f"# parity {label} {name} multiregion B={B_MULTI} T={T_SHORT} "
            f"deterministic: bitwise {bitwise(k, p)}; largest per-cluster "
            f"rel diff {worst} {rel[worst]:.3g}")
        if bad:
            fail(f"mlp short-horizon parity on {name}: {bad}")
        k = run_entry("mlp", cfg, params, net, stream, T_PARITY, False)
        t0 = time.perf_counter()
        p = lane_plain("mlp", cfg, params, net, stream, T_PARITY, False)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        share, worst, worst_rel, max_abs = per_cluster_share(k, p)
        viol = mk.mean_parity_violations(k, p,
                                         mk.NEURAL_MEAN_PARITY_TOLERANCES)
        same = bitwise(k, p)
        log(f"# parity {label} {name} multiregion B={B_PARITY} T={T_PARITY} "
            f"deterministic: bitwise {same}; {share * 100:.4f} % of clusters "
            f"within 2e-3; worst {worst} (rel {worst_rel:.3g}); max abs diff "
            f"{max_abs:.4g}; mean_parity_violations {viol}")
        if viol:
            fail(f"mlp mean parity on {name}")
        found[label] = {"bitwise": same, "max_abs_err": max_abs,
                        "plain_ms": plain_s * 1e3,
                        "shape": f"{name} multiregion B={B_PARITY} "
                                 f"T={T_PARITY} deterministic"}
        del stream, short, k, p
        torch.cuda.empty_cache()
    return found


def plan_phase(dev, setup, hold, profiles) -> dict:
    """4b: the plan kernel against its plain version: default B = 8192 and
    multiregion B = 1024 at T = 360, both modes, a random decoded plan per
    cluster and the same plan's first cluster broadcast to every cluster;
    a rule-equivalent per-cluster plan bitwise the rule kernel. Then the
    plain-stream PLAN instantiation's time and issue floor at multiregion
    B = 32768 x T = 2880, stochastic, on a random plan. Returns its
    `kernels` row."""
    from ccka_tpu_torch.kernels import build
    from ccka_tpu_torch.sim import megakernel as mk

    before = sum(build.launch_rollout_plan.launches.values())
    rec = {"bitwise": True, "max_abs_err": 0.0, "plain_ms": 0.0}
    for preset, B in (("default", B_PARITY), ("multiregion", B_MULTI)):
        cfg, src, params, off, peak, _ = setup(preset)
        P, Z = cfg.cluster.n_pools, cfg.cluster.n_zones
        stream = src.packed_trace_device(T_PARITY, 73, B, device=dev)
        per = random_plan(cfg, B, T_PARITY, T_PARITY, dev)
        broadcast = per[..., 0].contiguous()
        is_peak = mk.unpack_exo(stream, T_PARITY, Z).is_peak > 0.5
        rule_eq = mk.pack_plan(type(off)(*(
            torch.where(is_peak.reshape(B, T_PARITY, *([1] * o.dim())), q,
                        o) for o, q in zip(off, peak))), T_PARITY)
        for st in (False, True):
            mode = "stochastic" if st else "deterministic"
            for form, plan in (("per-cluster", per),
                               ("broadcast", broadcast)):
                k = run_entry("plan", cfg, params, None, stream, T_PARITY,
                              st, plan=plan)
                t0 = time.perf_counter()
                p = lane_plain("plan", cfg, params, None, stream, T_PARITY,
                               st, plan=plan)
                torch.cuda.synchronize()
                plain_ms = (time.perf_counter() - t0) * 1e3
                same, max_abs = hold(f"plan {form} {preset} B={B} "
                                     f"T={T_PARITY} {mode}", k, p, st)
                rec["bitwise"] &= same
                rec["max_abs_err"] = max(rec["max_abs_err"], max_abs)
                if preset == "multiregion" and form == "per-cluster":
                    rec["plain_ms"] = plain_ms
            k = run_entry("plan", cfg, params, None, stream, T_PARITY, st,
                          plan=rule_eq)
            want = run_entry("rule", cfg, params, None, stream, T_PARITY, st)
            torch.cuda.synchronize()
            log(f"# plan rule-equivalent {preset} B={B} T={T_PARITY} {mode}: "
                f"bitwise the rule kernel {bitwise(k, want)}")
            if not bitwise(k, want):
                fail(f"the rule-equivalent plan is not bitwise the rule "
                     f"kernel ({preset}, {mode})")
        del stream, per, broadcast, rule_eq
        torch.cuda.empty_cache()
    rec["launches"] = sum(build.launch_rollout_plan.launches.values()) - before

    cfg, src, params, _, _, _ = setup("multiregion")
    stream = src.packed_trace_device(T_DAY, 83, B_MAIN, device=dev)
    plan = random_plan(cfg, B_MAIN, T_DAY, T_DAY, dev)
    torch.cuda.empty_cache()
    def timed():
        return run_entry("plan", cfg, params, None, stream, T_DAY, True,
                         plan=plan)

    rec["ms"] = median_ms(timed)
    b_ms, b_by, terms, ops = lane_bound(cfg, "plan", "plain")
    floor = profiles.issue_floor_ms(("plan", cfg.cluster.n_zones, True,
                                     False, 0, False), B_MAIN, T_DAY, timed)
    rec.update(bound_ms=b_ms, bound_by=b_by, bound_unit=terms["set_by"],
               ops_per_cluster_tick=ops, issue_floor_ms=floor)
    log(f"# plan kernel (plain stream) multiregion B={B_MAIN} T={T_DAY} "
        f"stochastic, random plan: {rec['ms']:.4f} ms median of {N_TIMED}; "
        f"bound {b_ms:.4f} ms ({b_by}; terms in ms {terms}; {ops} float ops "
        f"per cluster-tick); issue floor {floor:.4f} ms")
    del stream, plan
    torch.cuda.empty_cache()
    return rec


def planner_check(dev, setup) -> None:
    """The graphed receding-horizon planner against the eager one, bitwise
    (multiregion N = 1024 x T = 96, the boards' quick planner)."""
    from ccka_tpu_torch.faults.scoreboard import QUICK_PLANNER
    from ccka_tpu_torch.sim import megakernel as mk
    from ccka_tpu_torch.sim.rollout import initial_state
    from ccka_tpu_torch.train import mpc

    cfg, src, params, _, _, _ = setup("multiregion")
    N, T = B_MULTI, 96
    traces = mk.unpack_exo(src.packed_trace_device(T, 89, N, device=dev), T,
                           cfg.cluster.n_zones)
    lat0 = mpc.zero_latent(cfg.cluster, dev)
    lat0 = lat0.expand(N, QUICK_PLANNER["horizon"], *lat0.shape)
    got, secs = {}, {}
    for graph in (False, True):
        t0 = time.perf_counter()
        got[graph] = mpc.receding_horizon_plan_batch(
            params, cfg.cluster, cfg.train, initial_state(cfg, N, dev),
            traces, lat0, graph=graph, **QUICK_PLANNER)
        torch.cuda.synchronize()
        secs[graph] = time.perf_counter() - t0
    same = torch.equal(got[True], got[False])
    log(f"# planner N={N} T={T}: graphed {secs[True]:.3f} s (capture "
        f"included), eager {secs[False]:.3f} s; bitwise {same}; largest "
        f"|latent| {float(got[True].abs().max()):.4g}; "
        f"{planner_ops(cfg)} operations dispatched a segment (counted on "
        f"the CPU, views included)")
    if not same:
        fail("the graphed planner differs from the eager one")


def planner_ops(cfg) -> int:
    """Operations one segment of the quick planner dispatches (its two
    Adam iterations, forward and backward, and its executed ticks),
    counted on the CPU at N = 4."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from ccka_tpu_torch.faults.scoreboard import QUICK_PLANNER
    from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource
    from ccka_tpu_torch.sim.rollout import initial_state
    from ccka_tpu_torch.sim.types import SimParams
    from ccka_tpu_torch.train import mpc

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    H, R = QUICK_PLANNER["horizon"], QUICK_PLANNER["replan_every"]
    traces = SyntheticSignalSource(
        cfg.cluster, cfg.workload, cfg.sim, cfg.signals).batch_trace(
        H, [1, 2, 3, 4], device="cpu")
    window, seg = next(mpc._segment_windows(traces, H, R))
    lat0 = mpc.zero_latent(cfg.cluster, "cpu")
    with Count():
        mpc._segment(SimParams.from_config(cfg, device="cpu"), cfg.cluster,
                     cfg.train, initial_state(cfg, 4, "cpu"),
                     lat0.expand(4, H, *lat0.shape).contiguous(), window,
                     seg, QUICK_PLANNER["iters"], R)
    return Count.n


def lane_bound(cfg, policy: str, name: str, net=None, B: int = B_MAIN,
               T: int = T_DAY, extra_bytes: int = 0):
    """(bound ms, "bytes" or "operations", terms) of a lane kernel at the
    boards' size (multiregion B = 32768 x T = 2880, stochastic) or at
    ``B`` x ``T``, with ``extra_bytes`` moved besides (a carried state's
    round trips); ``name`` a fault intensity, a workload scenario or
    "plain"."""
    from ccka_tpu_torch.sim import megakernel as mk
    from ccka_tpu_torch.workloads.scenarios import WORKLOAD_SCENARIOS

    sc = WORKLOAD_SCENARIOS.get(name)
    faults = (sc is None and name != "plain") or bool(sc and sc.fault_preset)
    wl = sc is not None
    Z = cfg.cluster.n_zones
    ops = float_ops_per_cluster_tick(cfg, True, policy, net, faults, wl)
    terms = {"tick": (ops * B * T, F32_UNFUSED_OPS_PER_S, "float32")}
    weight_bytes = extra_bytes
    plan_rows = mk._act_rows(cfg.cluster.n_pools, Z) if policy == "plan" \
        else 0
    if policy == "mlp":
        F, H, A = mk._mlp_dims(net, P=cfg.cluster.n_pools, Z=Z)[0]
        weight_bytes += (F * H + H * H + 2 * H) * 2 + (H * A + A) * 4
        terms["torso"] = (2 * (F * H + H * H) * B * T,
                          BF16_TENSOR_OPS_PER_S, "tensor cores")
        terms["head"] = (2 * H * A * B * T, F32_OPS_PER_S, "float32")
    return bound(rollout_bytes(Z, B, T, weight_bytes, faults, wl,
                               plan_rows), terms) + (ops,)


def board_phase(dev, setup, zero_counters, read_counters) -> dict:
    """9: the main path of this slice. The graphed planner against the
    eager one; then `fault_scoreboard` (four intensities) and
    `workload_scoreboard` (four scenarios) on the multiregion preset at
    B = 32768 x T = 2880, stochastic, rule, carbon, flagship and mpc,
    each with the launch counters zeroed just before and read just after,
    and then its :func:`stage_times` on the plan it made."""
    from ccka_tpu_torch.faults.scoreboard import fault_scoreboard
    from ccka_tpu_torch.kernels import build
    from ccka_tpu_torch.sim import megakernel as mk
    from ccka_tpu_torch.workloads.scoreboard import workload_scoreboard

    planner_check(dev, setup)
    cfg, _, _, _, _, net = setup("multiregion")
    policies = ("rule", "carbon", "flagship", "mpc")
    out: dict = {"launches": {}, "rows": {}, "planner_s": {}}
    out["synth_ms"], out["kernels"] = {}, {}
    runs = (("fault board", FAULT_LEVELS, "intensities", fault_scoreboard),
            ("workload board", SCENARIOS, "scenarios", workload_scoreboard))
    for board_name, names, key, scoreboard in runs:
        kept: dict = {}
        torch.cuda.synchronize()
        zero_counters()
        for counter in (build.launch_rollout_profiles,
                        build.launch_rollout_mlp, build.launch_rollout_plan):
            counter.launches.clear()
        t0 = time.perf_counter()
        board = scoreboard(cfg, policies=policies, n_traces=B_MAIN,
                           seed=BOARD_SEED, trace_seed=BOARD_TRACE_SEED,
                           device=dev, plan_out=kept)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(read_counters())
        for kernel, counter in (
                ("rollout_profiles_kernel", build.launch_rollout_profiles),
                ("rollout_profiles_kernel", build.launch_rollout_plan),
                ("rollout_mlp_kernel", build.launch_rollout_mlp)):
            launches.update({kernel + k: v
                             for k, v in counter.launches.items()})
        out["launches"][board_name] = launches
        out["planner_s"][board_name] = board["mpc_planner"]["seconds"]
        log(f"# {board_name} multiregion B={B_MAIN} T={T_DAY} stochastic: "
            f"{secs:.3f} s from a seed, of which the planner "
            f"{board['mpc_planner']['seconds']:.3f} s "
            f"({board['mpc_planner']}); launches {launches}")
        if not (board["stochastic"] and board["eval_steps"] == T_DAY
                and board["n_traces"] == B_MAIN):
            fail(f"{board_name}: not the full-size stochastic board")
        check_board(board_name, board[key], names, launches, out)
        del board
        stage_times(dev, cfg, net, out, board_name, names,
                    kept.pop("plan_packed"))
    return out


def check_board(board_name: str, boards: dict, names, launches: dict,
                out: dict) -> None:
    """Every row of a board finite and logged; every instantiation of its
    streams launched, each entry once per intensity or scenario."""
    for name in names:
        rows = boards[name]["rows"]
        if set(rows) != {"rule", "carbon", "flagship", "mpc"}:
            fail(f"{board_name} {name}: rows {sorted(rows)}")
        for policy, row in rows.items():
            if not all(math.isfinite(v) for v in row.values()):
                fail(f"{board_name} {name} {policy}: {row}")
            out["rows"][(name, policy)] = row
        log(f"#   {name}: " + "; ".join(
            f"{p} $/SLO-hr {r['usd_per_slo_hour']} SLO "
            f"{r['slo_attainment']}"
            + (f" vs calm {r['vs_calm_usd_per_slo_hour']}"
               if "vs_calm_usd_per_slo_hour" in r else
               f" inf viol {r['inf_slo_violations']} batch miss "
               f"{r['batch_deadline_misses']}")
            for p, r in rows.items()))
        for policy in BOARD_POLICIES:
            label = instantiation_name(policy, name)
            if launches.get(label, 0) < 1:
                fail(f"{board_name} never launched {label}")
    for entry in ("rollout_profiles_kernel",
                  "rollout_profiles_kernel<CARBON>",
                  "rollout_mlp_kernel", "plan entry"):
        if launches[entry] != len(names):
            fail(f"{board_name}: {entry} launched {launches[entry]} "
                 f"times, expected {len(names)}")


def stage_times(dev, cfg, net, out: dict, board_name: str, names,
                plan: torch.Tensor) -> None:
    """Each of a board's streams once more from the same seed, timed:
    synthesis, each entry, each kernel as the median of 5 (the plan
    kernel on the packed plan the board made; each row, the mpc row
    included, is checked to reproduce the board's); on severe and mixed
    each row held against its plain version at T = 360."""
    from ccka_tpu_torch.faults.scoreboard import summary_mean
    from ccka_tpu_torch.sim import megakernel as mk

    stage = {}
    for name in names:
        source, wl = lane_source(cfg, name)
        params = lane_params(cfg, wl, dev)
        held = []
        out["synth_ms"][name] = cuda_ms(lambda: held.append(
            source.packed_trace_device(T_DAY, BOARD_TRACE_SEED, B_MAIN,
                                       device=dev)))[0]
        stream = held.pop()
        log(f"# {name}: packed_trace_device {out['synth_ms'][name]:.4f} ms "
            f"([{T_DAY}, {stream.shape[1]}, {B_MAIN}])")
        for policy in BOARD_POLICIES:
            label = instantiation_name(policy, name)

            def entry(T=T_DAY):
                return run_entry(policy, cfg, params, net, stream, T, True,
                                 seed=BOARD_SEED, plan=plan)

            got = []
            entry_ms = cuda_ms(lambda: got.append(entry()))[0]
            k = got.pop()
            row = out["rows"][(name, BOARD_ROW[policy])]
            if summary_mean(k.usd_per_slo_hour) != row["usd_per_slo_hour"]:
                fail(f"{name} {policy}: the regenerated stream does not "
                     f"reproduce the board's row")
            k_ms = median_ms(entry)
            stage[(name, policy)] = k_ms
            if name not in ("severe", "flash-crowd", "mixed"):
                log(f"#   {label} on {name}: entry {entry_ms:.4f} ms, "
                    f"kernel {k_ms:.4f} ms median of {N_TIMED}")
                continue
            b_ms, b_by, terms, ops = lane_bound(cfg, policy, name, net)
            rec = {"ms": k_ms, "entry_ms": entry_ms, "bound_ms": b_ms,
                   "bound_by": b_by, "bound_unit": terms["set_by"],
                   "ops_per_cluster_tick": ops,
                   "shape": f"{name} multiregion B={B_MAIN} T={T_DAY} "
                            f"stochastic"}
            log(f"#   {label} on {name}: entry {entry_ms:.4f} ms, kernel "
                f"{k_ms:.4f} ms median of {N_TIMED}; bound {b_ms:.4f} ms "
                f"({b_by}; terms in ms {terms}; {ops} float ops per "
                f"cluster-tick)")
            if name != "flash-crowd":
                k = entry(T_PARITY)
                t0 = time.perf_counter()
                p = lane_plain(policy, cfg, params, net, stream, T_PARITY,
                               True, seed=BOARD_SEED, plan=plan)
                torch.cuda.synchronize()
                rec["plain_ms"] = (time.perf_counter() - t0) * 1e3
                rec["plain_shape"] = (f"{name} multiregion B={B_MAIN} "
                                      f"T={T_PARITY} stochastic")
                share, worst, worst_rel, max_abs = per_cluster_share(k, p)
                tol = (mk.NEURAL_MEAN_PARITY_TOLERANCES if policy == "mlp"
                       else None)
                viol = mk.mean_parity_violations(k, p, tol)
                rec.update(max_abs_err=max_abs, bitwise=bitwise(k, p))
                log(f"#   {label} vs plain at T={T_PARITY} "
                    f"({rec['plain_ms']:.4f} ms): "
                    f"bitwise {rec['bitwise']}; {share * 100:.4f} % of "
                    f"clusters within 2e-3; worst {worst} (rel "
                    f"{worst_rel:.3g}); max abs diff {max_abs:.4g}; "
                    f"mean_parity_violations {viol}")
                if viol or (policy != "mlp" and share < 0.99):
                    fail(f"{name} {policy}: kernel and plain version "
                         f"disagree")
                del p
            out["kernels"][label] = rec
        del stream
        torch.cuda.empty_cache()
    del plan
    torch.cuda.empty_cache()
    synth = sum(out["synth_ms"][n] for n in names)
    kern = {p: sum(stage[(n, p)] for n in names) for p in BOARD_POLICIES}
    planner_ms = out["planner_s"][board_name] * 1e3
    log(f"# {board_name} stages, timed one by one: synthesis "
        f"{synth:.4f} ms, planner {planner_ms:.4f} ms, kernels "
        + ", ".join(f"{p} {ms:.4f} ms" for p, ms in kern.items())
        + f"; sum {synth + planner_ms + sum(kern.values()):.4f} ms")


def lane_kernel_rows(boards: dict, found: dict) -> list:
    """The `kernels` line's entries of the lane instantiations."""
    rows = []
    for name in ("severe", "flash-crowd", "mixed"):
        for policy in BOARD_POLICIES:
            label = instantiation_name(policy, name)
            rec = dict(boards["kernels"][label])
            parity = found[label]
            if "plain_ms" not in rec:   # flash-crowd: from phase 5c
                rec.update(plain_ms=parity["plain_ms"],
                           max_abs_err=parity["max_abs_err"],
                           bitwise=parity["bitwise"],
                           parity_shape=parity["shape"])
            else:
                rec["bitwise_in_phase_5c"] = parity["bitwise"]
            by_path = {b: n.get(label, 0)
                       for b, n in boards["launches"].items()}
            rows.append({
                "name": label, "route": "cuda",
                "source": ("ccka_tpu_torch/csrc/rollout_mlp.cu"
                           if policy == "mlp" else
                           "ccka_tpu_torch/csrc/rollout_profiles.cu"),
                "replaces": (PLAN_REPLACES if policy == "plan" else
                             REPLACES["FAULTS" if "FAULTS" in label
                                      else "WL_D=16"]),
                "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "max_abs_err": rec.pop("max_abs_err"),
                "ms": rec.pop("ms"), "plain_ms": rec.pop("plain_ms"),
                "bound_ms": rec.pop("bound_ms"),
                "bound_by": rec.pop("bound_by"), "library_ms": None,
                **rec})
    return rows


# ---- the MLP kernel's forward, layer by layer (phase 5e)

FWD_TICKS = (0, 60, 120, 180)
FWD_REPLACES = "ccka_tpu/sim/megakernel.py:509"


def forward_ops(net) -> int:
    """Floating-point pointwise operations of the plain forward on one
    observation (:func:`pointwise_ops`)."""
    from ccka_tpu_torch.sim import megakernel as mk

    weights = tuple(w[0] for w in mk._pack_mlp_tensors(net, "cpu"))
    obs = torch.ones((1, weights[0].shape[0]))
    return pointwise_ops(lambda: mk.mlp_stages(obs, weights))


def forward_phase(dev, setup) -> dict:
    """5e: the observations of the plain multiregion rollout's states on
    the calm stream (B = 32768, `kernel_numerics_action_fn`) at
    FWD_TICKS through `mlp_forward` on the card, each held by
    `check_mlp_forward` and `mlp_forward_departures`; the entry's time, its plain version's and its
    bound at N = 32768. Returns its `kernels` row."""
    from ccka_tpu_torch.kernels import build
    from ccka_tpu_torch.policy.base import observe
    from ccka_tpu_torch.sim import megakernel as mk
    from ccka_tpu_torch.sim.rollout import (batched_rollout_summary,
                                            initial_state)

    cfg, src, params, _, _, net = setup("multiregion")
    T = max(FWD_TICKS) + 1
    traces = src.batch_trace_device(
        T, torch.Generator(device=dev).manual_seed(59), B_MAIN, device=dev)
    plain = mk.kernel_numerics_action_fn(net, cfg.cluster, params)
    seen = {}

    def action_fn(state, exo, t):
        if t in FWD_TICKS:
            seen[t] = observe(params, state, exo).flatten().contiguous()
        return plain(state, exo, t)

    batched_rollout_summary(params, initial_state(cfg, B_MAIN, dev),
                            action_fn, traces, 5, stochastic=False)
    del traces
    weights = mk._pack_mlp_tensors(net, dev)
    build.launch_mlp_forward.launches = 0
    worst: dict = {"u_max_abs_diff": 0.0}
    for t in FWD_TICKS:
        got = mk.mlp_forward(seen[t], weights)
        torch.cuda.synchronize()
        rep = mk.check_mlp_forward(got, seen[t], weights)
        log(f"# 5e forward multiregion N={B_MAIN} tick {t}: {rep}")
        if any(rep["violations"].values()):
            fail(f"5e: the MLP kernel's forward at tick {t} breaks its "
                 f"standard: {rep['violations']}")
        departures = mk.mlp_forward_departures(rep)
        if departures:
            fail(f"5e: the MLP kernel's forward at tick {t} is not "
                 f"bitwise its plain version, or its sums leave the "
                 f"near-tie window: {departures}")
        worst["u_max_abs_diff"] = max(worst["u_max_abs_diff"],
                                      rep["u_max_abs_diff"])
        for f, v in rep["bitwise_share"].items():
            worst[f"min_bitwise_share_{f}"] = min(
                worst.get(f"min_bitwise_share_{f}", 1.0), v)
        for key in ("sum_bound_use", "near_tie_share"):
            for f, v in rep[key].items():
                worst[f"max_{key}_{f}"] = max(
                    worst.get(f"max_{key}_{f}", 0.0), v)
    launches = build.launch_mlp_forward.launches
    if launches != len(FWD_TICKS):
        fail(f"5e launched the forward {launches} times, expected "
             f"{len(FWD_TICKS)}")
    obs = seen[FWD_TICKS[-1]]
    ms = median_ms(lambda: mk.mlp_forward(obs, weights))
    member = tuple(w[0] for w in weights)
    plain_ms = median_ms(lambda: mk.mlp_stages(obs, member))
    F, H, A = mk._mlp_dims(net, P=cfg.cluster.n_pools,
                           Z=cfg.cluster.n_zones)[0]
    N = B_MAIN
    ops = forward_ops(net)
    nbytes = (N * F * 4 + N * F * 2 + 2 * N * H * (4 + 2) + N * A * 4
              + (F * H + H * H + 2 * H) * 2 + (H * A + A) * 4)
    b_ms, b_by, terms = bound(nbytes, {
        "pointwise": (ops * N, F32_UNFUSED_OPS_PER_S, "float32"),
        "torso": (2 * (F * H + H * H) * N, BF16_TENSOR_OPS_PER_S,
                  "tensor cores"),
        "head": (2 * H * A * N, F32_OPS_PER_S, "float32")})
    log(f"# 5e forward N={N}: {ms:.4f} ms median of {N_TIMED}, plain "
        f"{plain_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}; terms in ms "
        f"{terms}; {ops} pointwise float ops per observation); over the "
        f"{len(FWD_TICKS)} ticks {worst}")
    return {"name": "mlp_forward_kernel", "route": "cuda",
            "source": "ccka_tpu_torch/csrc/rollout_mlp.cu",
            "replaces": FWD_REPLACES, "launches": launches,
            "launches_from": "phase 5e, its check: the rollout kernel "
                             "inlines the same device functions (0 "
                             "launches on every path)",
            "max_abs_err": worst["u_max_abs_diff"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
            "shape": f"multiregion N={N}, F={F} H={H} A={A}, the plain "
                     f"rollout's observations at tick {FWD_TICKS[-1]}",
            **{k: v for k, v in worst.items() if k != "u_max_abs_diff"}}


# ---- carried-state streaming (phase 10)

STREAM_KEY, STREAM_SEED = 83, 41    # the blocked stream's seed; Philox's
BLOCK_DAY = 360                     # 8 blocks a day (phase 10c, 10d)
BLOCK_PARITY = 180                  # 4 blocks of T_BLOCKED (phase 10a)
HELD_BLOCKS = 2                     # full-width blocks held to plain (10c)
# The port's kernels have no time chunk; 20 ticks divide every block here,
# so the splits pass the JAX package's own checks.
T_CHUNK_STREAM = 20
B_CHUNKED, CHUNK = 262144, 32768    # phase 10d: 8 chunks
CARRY_REPLACES = "ccka_tpu/sim/megakernel.py:340"
ROUTES = ("rule", "carbon", "mlp", "plan")
BLOCK_MODE = {"rule": "rule", "carbon": "carbon", "mlp": "neural",
              "plan": "plan"}
STREAM_NAMES = ("plain", "severe", "flash-crowd", "mixed")


def stream_source(cfg, name: str):
    """(source, WorkloadsConfig or None) of the plain stream or a lane
    stream."""
    from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource

    if name == "plain":
        return SyntheticSignalSource(cfg.cluster, cfg.workload, cfg.sim,
                                     cfg.signals), None
    return lane_source(cfg, name)


def carry_label(route: str, name: str) -> str:
    """The CARRY instantiation a route runs on a stream."""
    from ccka_tpu_torch.kernels import build
    from ccka_tpu_torch.workloads.scenarios import WORKLOAD_SCENARIOS

    sc = WORKLOAD_SCENARIOS.get(name)
    faults = (name in FAULT_LEVELS) or bool(sc and sc.fault_preset)
    suffix = build.instantiation(route, faults, 16 if sc else 0, carry=True)
    return ("rollout_mlp_kernel" if route == "mlp"
            else "rollout_profiles_kernel") + suffix


def block_fns(cfg, params, route: str, T: int, block_T: int, stochastic,
              net=None, plan=None):
    from ccka_tpu_torch.sim import megakernel as mk

    return mk.packed_mode_block_summary_fn(
        params, cfg.cluster, BLOCK_MODE[route], T=T, block_T=block_T,
        t_chunk=T_CHUNK_STREAM if block_T % 16 else 16,
        stochastic=stochastic, net_params=net if route == "mlp" else None,
        plan_packed=plan if route == "plan" else None)


def carry_day(fns, blocks, seed: int = STREAM_SEED):
    """Every block through the CARRY kernel from a fresh state, the state
    alternating between two buffers; returns the last block's accumulator
    rows."""
    first = fns.init_state(blocks[0].shape[1], blocks[0].shape[2],
                           device=blocks[0].device)
    states = [first, torch.zeros_like(first)]
    out = None
    for j, blk in enumerate(blocks):
        out, _ = fns.step(blk, states[j % 2], j, seed,
                          state_out=states[(j + 1) % 2])
    return out


def hold_carry(fns, blocks, what: str) -> tuple[float, float]:
    """Each block through the CARRY kernel and through its plain version
    (`plain_step` on the card) from the same carried state; fails unless
    the two states after every block are bitwise equal. Returns (the plain
    version's seconds over all blocks, the largest absolute difference)."""
    state = fns.init_state(blocks[0].shape[1], blocks[0].shape[2],
                           device=blocks[0].device)
    k_state, p_state = torch.zeros_like(state), torch.zeros_like(state)
    plain_s = err = 0.0
    for j, blk in enumerate(blocks):
        fns.step(blk, state, j, STREAM_SEED, state_out=k_state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fns.plain_step(blk, state, j, STREAM_SEED, state_out=p_state)
        torch.cuda.synchronize()
        plain_s += time.perf_counter() - t0
        diff = (k_state - p_state).abs()
        err = max(err, float(diff.max()))
        if not torch.equal(k_state, p_state):
            rows = sorted(set(torch.nonzero(diff)[:, -2].tolist()))
            fail(f"{what}: the carried state after block {j} differs from "
                 f"its plain version in rows {rows[:12]} (max abs "
                 f"{float(diff.max()):.4g})")
        state, p_state = p_state, state
    return plain_s, err


def state_bytes(cfg, params, route: str, rows: int, B: int,
                n_blocks: int) -> int:
    """Bytes a blocked day moves in carried state: the used rows read and
    written once a block."""
    from ccka_tpu_torch.sim import megakernel as mk

    layout = mk._carry_layout(params, cfg.cluster, BLOCK_MODE[route], rows)
    return layout.blocks()["queues"][1] * 4 * B * 2 * n_blocks


def carry_phase(dev, setup) -> dict:
    """10a: every CARRY instantiation (4 routes x plain, severe,
    flash-crowd, mixed x both modes), multiregion B = 8192 x T = 720 in
    blocks of 180: its last state's summary bitwise the non-carry
    kernel's on the concatenated stream; the stochastic day's time (4
    launches) against the non-carry launch's. 10b: at B = 1024 x T = 32
    in blocks of 16, both modes, the carried state after every block
    bitwise its plain version's `pack_carry` (`plain_step` on the card);
    the plain version's time (10c holds the mixed stream's at full
    width). Returns {instantiation: record}."""
    from ccka_tpu_torch.sim import megakernel as mk

    t_phase = time.perf_counter()
    cfg, _, _, _, _, net = setup("multiregion")
    found: dict = {}
    plan = random_plan(cfg, B_PARITY, T_BLOCKED, T_BLOCKED, dev)
    n_bitwise = 0
    for name in STREAM_NAMES:
        source, wl = stream_source(cfg, name)
        params = lane_params(cfg, wl, dev)
        blocks = [source.packed_block_trace_device(
            BLOCK_PARITY, STREAM_KEY, B_PARITY, j, t_chunk=T_CHUNK_STREAM,
            device=dev) for j in range(T_BLOCKED // BLOCK_PARITY)]
        full = torch.cat(blocks)
        for route in ROUTES:
            label = carry_label(route, name)
            rec = found.setdefault(label, {"route": route, "stream": name})
            for st in (False, True):
                fns = block_fns(cfg, params, route, T_BLOCKED, BLOCK_PARITY,
                                st, net, plan)

                def noncarry():
                    return mk.packed_mode_summary(
                        params, cfg.cluster, BLOCK_MODE[route], full,
                        T_BLOCKED, STREAM_SEED, stochastic=st,
                        net_params=net if route == "mlp" else None,
                        plan_packed=plan)

                got = fns.finalize(carry_day(fns, blocks))
                want = noncarry()
                torch.cuda.synchronize()
                if not bitwise(got, want):
                    bad = [f for f in got._fields if not torch.equal(
                        getattr(got, f), getattr(want, f))]
                    fail(f"10a: {label} on {name} (stochastic={st}) is not "
                         f"bitwise the non-carry kernel: {bad}")
                n_bitwise += 1
                if st:
                    rec["a_ms"] = median_ms(lambda: carry_day(fns, blocks))
                    rec["a_noncarry_ms"] = median_ms(noncarry)
                    rec["a_bound"] = lane_bound(
                        cfg, route, name, net, B_PARITY, T_BLOCKED,
                        state_bytes(cfg, params, route, full.shape[1],
                                    B_PARITY, len(blocks)))
        del blocks, full
        torch.cuda.empty_cache()
    log(f"# 10a carry: {n_bitwise} blocked days (4 routes x "
        f"{len(STREAM_NAMES)} streams x 2 modes, multiregion B={B_PARITY} "
        f"T={T_BLOCKED}, blocks of {BLOCK_PARITY}), every one bitwise the "
        f"non-carry kernel on the concatenated stream "
        f"({time.perf_counter() - t_phase:.1f} s)")
    for label, rec in found.items():
        log(f"#   {label} ({rec['stream']}): day of 4 CARRY launches "
            f"{rec['a_ms']:.4f} ms, non-carry {rec['a_noncarry_ms']:.4f} ms "
            f"(x {rec['a_ms'] / rec['a_noncarry_ms']:.4f}); bound "
            f"{rec['a_bound'][0]:.4f} ms ({rec['a_bound'][1]})")

    # 10b: the carried state against its plain version after every block.
    n_states = 0
    T, bT = T_SHORT, 16
    bplan = random_plan(cfg, B_MULTI, T, T, dev)
    for name in STREAM_NAMES:
        source, wl = stream_source(cfg, name)
        params = lane_params(cfg, wl, dev)
        blocks = [source.packed_block_trace_device(
            bT, STREAM_KEY, B_MULTI, j, t_chunk=16, device=dev)
            for j in range(T // bT)]
        for route in ROUTES:
            label = carry_label(route, name)
            rec = found[label]
            for st in (False, True):
                fns = block_fns(cfg, params, route, T, bT, st, net, bplan)
                plain_s, err = hold_carry(
                    fns, blocks, f"10b: {label} on {name} (stochastic={st})")
                n_states += len(blocks)
                rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), err)
                if st:
                    rec["plain_ms"] = plain_s * 1e3
                    rec["plain_shape"] = (f"{name} multiregion B={B_MULTI} "
                                          f"T={T} in blocks of {bT}, "
                                          f"stochastic, the plain version on "
                                          f"the card (plain_step)")
        del blocks
    log(f"# 10b carry: {n_states} carried states (every block of 4 routes x "
        f"{len(STREAM_NAMES)} streams x 2 modes at B={B_MULTI}), every one "
        f"bitwise its plain version's pack_carry (10a and 10b "
        f"{time.perf_counter() - t_phase:.1f} s)")
    torch.cuda.empty_cache()
    return found


def streaming_phase(dev, setup, found: dict) -> dict:
    """10c: the main path of this slice: multiregion B = 32768 x T = 2880,
    stochastic, the mixed stream in 8 blocks of 360, rule, carbon, the
    shipped flagship and a decoded per-cluster plan, each through the
    synchronous and the double-buffered drive of
    `streaming_rollout_summary`, the CARRY counters zeroed just before and
    read just after; both drives bitwise each other and
    `unblocked_reference_summary`; a day of 8 CARRY launches timed against
    the non-carry launch on the same stream; the CARRY kernels held
    against `plain_step` on the day's first two blocks at full width,
    their carried state bitwise after each. 10d: the cluster-chunked
    rule drive at B = 262144 (8 chunks of 32768), its peak memory, its
    last chunk bitwise a single-chunk run. Returns the phase's record."""
    from ccka_tpu_torch.kernels import build
    from ccka_tpu_torch.sim import megakernel as mk
    from ccka_tpu_torch.sim import streaming as stm

    cfg, _, _, _, _, net = setup("multiregion")
    source, wl = stream_source(cfg, "mixed")
    params = lane_params(cfg, wl, dev)
    plan = random_plan(cfg, B_MAIN, T_DAY, T_DAY, dev)
    kw = dict(key=STREAM_KEY, batch=B_MAIN, T=T_DAY, block_T=BLOCK_DAY,
              seed=STREAM_SEED, t_chunk=T_CHUNK_STREAM, stochastic=True,
              device=dev)

    def route_kw(route):
        return dict(kw, net_params=net if route == "mlp" else None,
                    plan_packed=plan if route == "plan" else None)

    counters = (build.launch_rollout_profiles, build.launch_rollout_plan,
                build.launch_rollout_mlp)
    rec: dict = {"drives": {}}
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    for counter in counters:
        counter.launches.clear()
    runs = {}
    for route in ROUTES:
        # Each drive twice, in turns: sync, double-buffered, then the other
        # way round.
        for pipelined in (False, True, True, False):
            runs.setdefault((route, pipelined), []).append(
                stm.streaming_rollout_summary(
                    source, params, cfg.cluster, BLOCK_MODE[route],
                    pipelined=pipelined, **route_kw(route)))
    torch.cuda.synchronize()
    launches: dict = {}
    for counter, kernel in zip(counters, ("rollout_profiles_kernel",
                                          "rollout_profiles_kernel",
                                          "rollout_mlp_kernel")):
        launches.update({kernel + k: v for k, v in counter.launches.items()})
    rec["launches"] = launches
    log(f"# 10c streaming path multiregion B={B_MAIN} T={T_DAY} stochastic, "
        f"mixed stream in {T_DAY // BLOCK_DAY} blocks of {BLOCK_DAY}: "
        f"launches {launches}")
    for route in ROUTES:
        label = carry_label(route, "mixed")
        if launches.get(label, 0) != 4 * (T_DAY // BLOCK_DAY):
            fail(f"10c: {label} launched {launches.get(label, 0)} times, "
                 f"expected {4 * (T_DAY // BLOCK_DAY)}")
    if any("CARRY" not in k for k in launches):
        fail(f"10c: a non-carry kernel ran on the streaming path: "
             f"{launches}")
    for route in ROUTES:
        ref = stm.unblocked_reference_summary(
            source, params, cfg.cluster, BLOCK_MODE[route],
            **{k: v for k, v in route_kw(route).items()})
        for summary, rep in runs[route, False] + runs[route, True]:
            if not bitwise(summary, ref):
                fail(f"10c: {route}: the {rep['pipeline']} drive is not "
                     f"bitwise the unblocked reference")
        pipe = runs[route, True][0][0]
        buffers = [rep["stream_buffers"] for _, rep in runs[route, True]]
        if buffers != [2, 2]:
            fail(f"10c: {route}: the double-buffered drives used {buffers} "
                 f"stream buffers")
        for f in ("usd_per_slo_hour", "g_co2_per_kreq", "slo_attainment",
                  "inf_slo_violations", "batch_deadline_misses"):
            v = getattr(pipe, f)
            if v.shape != (B_MAIN,) or not torch.isfinite(v).all():
                fail(f"10c: {route}.{f} malformed")
        rec["drives"][route] = {
            "sync": [{"wall_s": rep["wall_s"],
                      "seconds": rep["occupancy"]["seconds"],
                      "fractions": rep["occupancy"]["fractions"]}
                     for _, rep in runs[route, False]],
            "double_buffered": [{"wall_s": rep["wall_s"],
                                 "pipeline_s": rep["pipeline_s"],
                                 "host_s": rep["host_s"],
                                 "stream_buffers": rep["stream_buffers"]}
                                for _, rep in runs[route, True]]}
        log(f"#   {route}: " + "; ".join(
            f"sync wall {d['wall_s']} s (stages {d['seconds']}, fractions "
            f"{d['fractions']})" for d in rec["drives"][route]["sync"])
            + "; " + "; ".join(
            f"double-buffered wall {d['wall_s']} s (pipeline "
            f"{d['pipeline_s']} s, host {d['host_s']} s, "
            f"{d['stream_buffers']} stream buffers)"
            for d in rec["drives"][route]["double_buffered"])
            + f"; all four bitwise the unblocked reference; $/SLO-hr "
            f"{pipe.usd_per_slo_hour.mean().item():.6f}, SLO attainment "
            f"{pipe.slo_attainment.mean().item():.6f}")
    del runs, ref, pipe
    torch.cuda.empty_cache()
    log(f"#   10c drives and references: "
        f"{time.perf_counter() - t_phase:.1f} s")

    # A day of 8 CARRY launches against one non-carry launch, same stream.
    blocks = [source.packed_block_trace_device(
        BLOCK_DAY, STREAM_KEY, B_MAIN, j, t_chunk=T_CHUNK_STREAM,
        device=dev) for j in range(T_DAY // BLOCK_DAY)]
    full = torch.cat(blocks)
    del blocks
    torch.cuda.empty_cache()
    views = [full[j * BLOCK_DAY:(j + 1) * BLOCK_DAY]
             for j in range(T_DAY // BLOCK_DAY)]
    for route in ROUTES:
        fns = block_fns(cfg, params, route, T_DAY, BLOCK_DAY, True, net,
                        plan)
        r = found[carry_label(route, "mixed")]
        r["ms"] = median_ms(lambda: carry_day(fns, views))
        r["noncarry_ms"] = median_ms(lambda: mk.packed_mode_summary(
            params, cfg.cluster, BLOCK_MODE[route], full, T_DAY,
            STREAM_SEED, net_params=net if route == "mlp" else None,
            plan_packed=plan))
        r["bound"] = lane_bound(
            cfg, route, "mixed", net, B_MAIN, T_DAY,
            state_bytes(cfg, params, route, full.shape[1], B_MAIN,
                        len(views)))
        log(f"#   {route}: day of {len(views)} CARRY launches "
            f"{r['ms']:.4f} ms, non-carry {r['noncarry_ms']:.4f} ms "
            f"(x {r['ms'] / r['noncarry_ms']:.4f}); bound "
            f"{r['bound'][0]:.4f} ms ({r['bound'][1]}; terms "
            f"{r['bound'][2]})")
        # The main path's shape held against the plain version: the day's
        # first blocks, across a block boundary.
        label = carry_label(route, "mixed")
        plain_s, err = hold_carry(fns, views[:HELD_BLOCKS],
                                  f"10c: {label} at full width")
        r["max_abs_err"] = max(r.get("max_abs_err", 0.0), err)
        r["plain_ms"] = plain_s * 1e3
        r["plain_shape"] = (f"mixed multiregion B={B_MAIN}, the day's first "
                            f"{HELD_BLOCKS} blocks of {BLOCK_DAY} (T="
                            f"{HELD_BLOCKS * BLOCK_DAY}), stochastic, the "
                            f"plain version on the card (plain_step)")
        log(f"#   {route}: the carried state after each of the first "
            f"{HELD_BLOCKS} blocks bitwise its plain version's at B={B_MAIN} "
            f"(max abs {err}); plain version {r['plain_ms']:.4f} ms")
    del full, views, plan, fns
    torch.cuda.empty_cache()

    # 10d: the cluster-chunked rule drive.
    torch.cuda.synchronize()
    chunked, rep = stm.chunked_streaming_summary(
        source, params, cfg.cluster, "rule", key=STREAM_KEY,
        batch=B_CHUNKED, chunk=CHUNK, T=T_DAY, block_T=BLOCK_DAY,
        seed=STREAM_SEED, t_chunk=T_CHUNK_STREAM, stochastic=True,
        device=dev)
    last = B_CHUNKED // CHUNK - 1
    single, _ = stm.streaming_rollout_summary(
        source, params, cfg.cluster, "rule", **dict(
            kw, batch=CHUNK, shard=last, cluster0=last * CHUNK))
    tail = type(chunked)(*(x[last * CHUNK:] for x in chunked))
    if not bitwise(tail, single):
        fail("10d: the chunked drive's last chunk is not bitwise a "
             "single-chunk run")
    if rep["stream_buffers"] != 2:
        fail(f"10d: {rep['stream_buffers']} stream buffers")
    if not all(torch.isfinite(x).all() for x in chunked) or \
            chunked.cost_usd.shape != (B_CHUNKED,):
        fail("10d: malformed chunked summary")
    rec["chunked"] = rep
    log(f"# 10d chunked rule drive B={B_CHUNKED} ({rep['chunks']} chunks of "
        f"{CHUNK}) T={T_DAY} stochastic, mixed stream: wall "
        f"{rep['wall_s']:.6f} s; peak memory {rep['peak_bytes']} bytes "
        f"against two live blocks {rep['live_block_bytes']} bytes and the "
        f"unchunked stream {rep['stream_bytes']} bytes; "
        f"{rep['stream_buffers']} stream buffers; the last chunk bitwise a "
        f"single-chunk run; $/SLO-hr "
        f"{chunked.usd_per_slo_hour.mean().item():.6f}")
    del chunked, single, tail
    torch.cuda.empty_cache()
    log(f"#   10c and 10d: {time.perf_counter() - t_phase:.1f} s")
    return rec


def carry_kernel_rows(found: dict, stream_rec: dict) -> list:
    """The `kernels` line's entries of the CARRY instantiations: on the
    mixed stream (the streaming path's), times at full size; on the
    others, at phase 10a's B = 8192 x T = 720."""
    rows = []
    n_day, n_parity = T_DAY // BLOCK_DAY, T_BLOCKED // BLOCK_PARITY
    for label, rec in found.items():
        main = rec["stream"] == "mixed"
        b_ms, b_by, _, _ = rec["bound"] if main else rec["a_bound"]
        rows.append({
            "name": label, "route": "cuda",
            "source": ("ccka_tpu_torch/csrc/rollout_mlp.cu"
                       if rec["route"] == "mlp" else
                       "ccka_tpu_torch/csrc/rollout_profiles.cu"),
            "replaces": CARRY_REPLACES,
            "launches": stream_rec["launches"].get(label, 0),
            "launches_from": ("phase 10c, the streaming path (sync and "
                              "double-buffered drives)" if main else
                              "phase 10a, its checks (not on the streaming "
                              "path, whose stream is mixed)"),
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"] if main else rec["a_ms"],
            "noncarry_ms": (rec["noncarry_ms"] if main
                            else rec["a_noncarry_ms"]),
            "plain_ms": rec["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "bitwise": True,
            "shape": (f"{rec['stream']} multiregion B="
                      f"{B_MAIN if main else B_PARITY} T="
                      f"{T_DAY if main else T_BLOCKED} stochastic, a day of "
                      f"{n_day if main else n_parity} CARRY launches (ms) "
                      f"against one non-carry launch (noncarry_ms)"),
            "plain_shape": rec["plain_shape"]})
    return rows


# ---- the training path (phase 11)

TRAIN_SEED = 11
TRAIN_G, TRAIN_POP = 256, 64        # the mega engine's generation
DISTILL_B, DISTILL_T = 256, 256     # collect_dataset's batch and ticks
DISTILL_ITERS, DISTILL_MB = 300, 4096
CEM_GENS = 2
PPO_ITERS = 3                       # at the config's 256 x 64
FACTORY_SCENARIO, FACTORY_INTENSITY = "diurnal-inference", "moderate"
NAIVE_PAIRS = 1
NAIVE_STEPS = 32                    # 4 of a 96-tick pair's 12 segments
FLAGSHIP_GENS, FLAGSHIP_DISTILL = 2, 200
N_SELECT = 5                        # selection traces of a full day


def synced(fn):
    """``(fn(), seconds)`` on the host clock between two synchronizes."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def training_phase(dev, setup, hold, plain, rule_fn, carbon_fn,
                   zero_counters, read_counters) -> dict:
    """Phase 11, the training path at multiregion with the shipped net's
    widths: (a) the carbon teacher distilled; (b) two CEM generations on
    the mega engine from (a)'s params, each one rule, one carbon and one
    64-member population launch, generation 0's launches held against
    their plain versions on the stream's first T_POP ticks; (c) three
    PPO iterations; (d) one factory cell, its CARRY playback and rule
    column bitwise the unblocked references, its pairs/s against the
    naive per-pair loop; (e) `train_flagship` through `main` with the
    mega engine, the npz loaded back and its digest checked. Returns the
    phase's record."""
    import contextlib
    import io

    from ccka_tpu_torch.kernels import build
    from ccka_tpu_torch.models.nets import latent_to_action
    from ccka_tpu_torch.policy.carbon import CarbonAwarePolicy
    from ccka_tpu_torch.sim import megakernel as mk
    from ccka_tpu_torch.sim import streaming as stm
    from ccka_tpu_torch.train import cem, factory, flagship, imitate
    from ccka_tpu_torch.train.checkpoint import (PARAMS_DIGEST_KEY,
                                                 load_params_npz,
                                                 params_digest)
    from ccka_tpu_torch.obs.runlog import read_runlog
    from ccka_tpu_torch.train.ppo import PPOTrainer
    from ccka_tpu_torch.workloads.scenarios import resolve_scenarios

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg, src, params, off, peak, _ = setup("multiregion")
    Zm = cfg.cluster.n_zones
    teacher = CarbonAwarePolicy(cfg.cluster, device=dev)
    rec: dict = {}

    # 11a: distil the carbon teacher.
    data, collect_s = synced(lambda: imitate.collect_dataset(
        cfg, teacher, src, batch_clusters=DISTILL_B, steps=DISTILL_T,
        seed=TRAIN_SEED, device=dev))
    (net, hist), imitate_s = synced(lambda: imitate.imitate(
        cfg, teacher, src, iterations=DISTILL_ITERS, minibatch=DISTILL_MB,
        dataset=data, seed=TRAIN_SEED, device=dev))
    for k in ("actor_mse", "critic_mse"):
        vals = [h[k] for h in hist]
        if not np.isfinite(vals).all() or not vals[-1] < vals[0]:
            fail(f"11a: {k} not finite and falling: {vals}")
    rec["distill"] = {"collect_s": collect_s, "imitate_s": imitate_s,
                      "rows": int(data.obs.shape[0]), "history": hist}
    log(f"# 11a distil: collect_dataset B={DISTILL_B} x T={DISTILL_T} "
        f"{collect_s:.3f} s ({data.obs.shape[0]} rows), imitate "
        f"{DISTILL_ITERS} iterations at minibatch {DISTILL_MB} "
        f"{imitate_s:.3f} s; actor_mse {hist[0]['actor_mse']:.4f} -> "
        f"{hist[-1]['actor_mse']:.4f}, critic_mse "
        f"{hist[0]['critic_mse']:.4f} -> {hist[-1]['critic_mse']:.4f}")
    del data

    # 11b: CEM on the mega engine, its draws kept for the checks.
    ccfg = cem.CEMConfig(generations=CEM_GENS, popsize=TRAIN_POP,
                         traces_per_gen=TRAIN_G, eval_steps=T_DAY,
                         sigma_min=1e-3)
    flat0, spec = cem._flatten(net, dev)
    rng = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
    draws = []

    def draw(g):
        seed_g = int(torch.randint(2 ** 30, (1,), generator=rng, device=dev))
        d = cem.CEMDraws(
            src.packed_trace_device(T_DAY, seed_g, TRAIN_G, device=dev),
            int(torch.randint(2 ** 30, (1,), generator=rng, device=dev)),
            torch.randn((TRAIN_POP - 1, flat0.shape[0]), generator=rng,
                        device=dev))
        draws.append(d)
        return d

    zero_counters()
    (best, chist, info), cem_s = synced(lambda: cem.cem_refine(
        cfg, net, src, cem=ccfg, engine="mega", teacher_policy=teacher,
        draws=draw, device=dev))
    cem_launches = read_counters()
    for name in ("rollout_profiles_kernel", "rollout_profiles_kernel<CARBON>",
                 "rollout_mlp_kernel"):
        if cem_launches[name] != CEM_GENS:
            fail(f"11b: {CEM_GENS} generations launched {name} "
                 f"{cem_launches[name]} times, not once a generation")
    for r in chist:
        if not np.isfinite(r["incumbent_fitness"]):
            fail(f"11b: generation {r['generation']} fitness not finite")
    gens = [(r["incumbent_fitness"], r["best_fitness"], r["improved"])
            for r in chist]
    log(f"# 11b CEM mega engine NP={TRAIN_POP} x G={TRAIN_G} x T={T_DAY}: "
        f"{CEM_GENS} generations {cem_s:.3f} s; launches {cem_launches}; "
        f"(incumbent, best, improved) by generation {gens}")

    d0 = draws[0]
    mask = cem.perturbation_mask(net, ccfg, cfg.cluster, dev)
    cand = cem.candidates(flat0, torch.tensor(ccfg.sigma0,
                                              dtype=torch.float32,
                                              device=dev), d0.noise, mask)
    stacked = cem._unflatten(cand, spec)
    k_pop = mk.neural_megakernel_summary_from_packed(
        params, cfg.cluster, stacked, d0.worlds, T_POP, d0.world_seed)
    p_pop, pop_plain_s = synced(lambda: mk.population_plain_summary(
        params, cfg.cluster, stacked, d0.worlds, T_POP, d0.world_seed))
    pop_abs, worst, n_bitwise = 0.0, {}, 0
    for m in range(TRAIN_POP):
        km = type(k_pop)(*(x[m] for x in k_pop))
        pm = type(p_pop)(*(x[m] for x in p_pop))
        viol = mk.mean_parity_violations(km, pm,
                                         mk.NEURAL_MEAN_PARITY_TOLERANCES)
        if viol:
            fail(f"11b: member {m} of the population launch and its plain "
                 f"version disagree: {viol}")
        n_bitwise += bitwise(km, pm)
        pop_abs = max(pop_abs, per_cluster_share(km, pm)[3])
        rel = mean_rel(km, pm)
        for f, v in rel.items():
            worst[f] = max(worst.get(f, 0.0), v)
    f_max = max(worst, key=worst.get)
    log(f"#   population launch vs population_plain_summary at "
        f"T={T_POP} ({pop_plain_s:.3f} s plain): {TRAIN_POP} members "
        f"within NEURAL_MEAN_PARITY_TOLERANCES, {n_bitwise} bitwise; "
        f"largest batch-mean rel diff {f_max} {worst[f_max]:.3g}; max abs "
        f"diff {pop_abs:.4g}")
    views = mk.unpack_exo(d0.worlds, T_POP, Zm)
    bars = {}
    for name, entry, fn in (
            ("rule", lambda: mk.megakernel_summary_from_packed(
                params, off, peak, d0.worlds, T_POP, d0.world_seed),
             rule_fn(cfg)),
            ("carbon", lambda: mk.carbon_megakernel_summary_from_packed(
                params, off, peak, d0.worlds, T_POP, d0.world_seed),
             carbon_fn(cfg))):
        p, p_s = synced(lambda: plain(cfg, params, views, d0.world_seed,
                                      True, fn))
        same, max_abs = hold(f"11b {name} bar G={TRAIN_G} T={T_POP}",
                             entry(), p, True)
        bars[name] = {"bitwise": same, "max_abs_err": max_abs,
                      "plain_s": p_s}
    del views, k_pop, p_pop

    # The generation's stages on the card, timed alone.
    buf = torch.empty_like(d0.worlds)
    synth_ms = float(np.median(cuda_ms(lambda: src.packed_trace_device(
        T_DAY, 7, TRAIN_G, out=buf, device=dev), N_TIMED)))
    rule_ms = median_ms(lambda: mk.megakernel_summary_from_packed(
        params, off, peak, d0.worlds, T_DAY, d0.world_seed))
    carbon_ms = median_ms(lambda: mk.carbon_megakernel_summary_from_packed(
        params, off, peak, d0.worlds, T_DAY, d0.world_seed))
    pop_ms = median_ms(lambda: mk.neural_megakernel_summary_from_packed(
        params, cfg.cluster, stacked, d0.worlds, T_DAY, d0.world_seed))
    F, H, A = mk._mlp_dims(net, P=cfg.cluster.n_pools, Z=Zm)[0]
    weight_bytes = (F * H + H * H + 2 * H) * 2 + (H * A + A) * 4
    cells = TRAIN_POP * TRAIN_G * T_DAY
    pop_bound = bound(
        rollout_bytes(Zm, TRAIN_G, T_DAY) + (TRAIN_POP - 1) * OUT_ROWS
        * TRAIN_G * 4 + TRAIN_POP * weight_bytes,
        {"tick": (float_ops_per_cluster_tick(cfg, True, "mlp", net) * cells,
                  F32_UNFUSED_OPS_PER_S, "float32"),
         "torso": (2 * (F * H + H * H) * cells, BF16_TENSOR_OPS_PER_S,
                   "tensor cores"),
         "head": (2 * H * A * cells, F32_OPS_PER_S, "float32")})
    gen_s = cem_s / CEM_GENS
    host_s = gen_s - (synth_ms + rule_ms + carbon_ms + pop_ms) / 1e3
    rec["cem"] = {
        "generations": CEM_GENS, "wall_s": cem_s, "generation_s": gen_s,
        "synthesis_ms": synth_ms, "rule_ms": rule_ms,
        "carbon_ms": carbon_ms, "population_ms": pop_ms,
        "host_s": host_s, "launches": cem_launches,
        "population_bound_ms": pop_bound[0],
        "population_bound_by": pop_bound[1],
        "population_plain_s": pop_plain_s,
        "population_max_abs_err": pop_abs,
        "population_bitwise_members": n_bitwise, "bars": bars,
        "history": chist}
    log(f"#   a generation {gen_s:.3f} s: synthesis {synth_ms:.4f} ms, "
        f"rule {rule_ms:.4f} ms, carbon {carbon_ms:.4f} ms, population "
        f"{pop_ms:.4f} ms (median of {N_TIMED}; bound {pop_bound[0]:.4f} ms,"
        f" {pop_bound[1]}; terms in ms {pop_bound[2]}; {TRAIN_POP} x "
        f"{TRAIN_G} = {TRAIN_POP * TRAIN_G // 32} warps), host and the "
        f"rest {host_s:.3f} s")
    del draws, d0, buf, stacked
    torch.cuda.empty_cache()

    # 11c: PPO at the config's batch and window.
    trainer = PPOTrainer(cfg, device=dev)
    ts = trainer.fresh_state(best, TRAIN_SEED)
    t_len = cfg.train.unroll_steps
    windows = trainer.make_windows(src, PPO_ITERS, seed=TRAIN_SEED)
    ppo_s = []
    for it in range(PPO_ITERS):
        (ts, diag), secs = synced(lambda: trainer.iteration(
            ts, windows.slice_steps(it * t_len, t_len + 1)))
        ppo_s.append(secs)
        d = {k: float(v) for k, v in diag._asdict().items()}
        if not all(np.isfinite(list(d.values()))):
            fail(f"11c: PPO iteration {it} diagnostics not finite: {d}")
    rec["ppo"] = {"batch": cfg.train.batch_clusters, "window": t_len,
                  "iteration_s": ppo_s, "last": d}
    log(f"# 11c PPO B={cfg.train.batch_clusters} x T={t_len}: iterations "
        f"{[round(x, 4) for x in ppo_s]} s; last diagnostics {d}")
    del trainer, ts, windows

    # 11d: one factory cell at its defaults.
    scen = resolve_scenarios([FACTORY_SCENARIO])[FACTORY_SCENARIO]
    for counter in (build.launch_rollout_profiles, build.launch_rollout_plan):
        counter.launches.clear()
    zero_counters()
    cell, cell_s = synced(lambda: factory.produce_cell(
        cfg, scen, FACTORY_INTENSITY, seed=TRAIN_SEED, device=dev))
    carry = {"rollout_profiles_kernel" + k: v for counter in (
        build.launch_rollout_profiles, build.launch_rollout_plan)
        for k, v in counter.launches.items()}
    if not any("PLAN" in k and "CARRY" in k for k in carry) or not any(
            "PLAN" not in k and "CARRY" in k for k in carry):
        fail(f"11d: the factory's playback launched no plan and rule CARRY "
             f"instantiation: {carry}")
    rp = cell.report
    fsrc = factory._cell_source(cfg, scen, FACTORY_INTENSITY)
    kw = dict(key=TRAIN_SEED, batch=rp["pairs"], T=rp["steps"],
              block_T=rp["block_T"], seed=TRAIN_SEED, t_chunk=rp["t_chunk"],
              device=dev)
    n_blocks = rp["playback"]["n_blocks"]
    plan_packed = mk.pack_plan(latent_to_action(cell.plan_latents,
                                                cfg.cluster),
                               n_blocks * rp["block_T"])
    ref_play = stm.unblocked_reference_summary(
        fsrc, params, cfg.cluster, "plan", plan_packed=plan_packed, **kw)
    ref_rule = stm.unblocked_reference_summary(fsrc, params, cfg.cluster,
                                               "rule", **kw)
    if not (bitwise(cell.teacher_summary, ref_play)
            and bitwise(cell.rule_summary, ref_rule)):
        fail("11d: the factory's streamed labels differ from the unblocked "
             "references")
    for f in ("obs", "target", "returns"):
        if not torch.isfinite(getattr(cell.dataset, f)).all():
            fail(f"11d: dataset {f} not finite")
    naive, naive_s = synced(lambda: factory.naive_lax_pair_rate(
        cfg, scen, FACTORY_INTENSITY, pairs=NAIVE_PAIRS, steps=NAIVE_STEPS,
        block_T=rp["block_T"], t_chunk=rp["t_chunk"], seed=TRAIN_SEED,
        warm=False, device=dev))
    if naive["mpc_horizon"] != min(cfg.train.mpc_horizon, rp["steps"]):
        fail(f"11d: the shortened naive pair plans another horizon: {naive}")
    # A pair of rp["steps"] ticks runs steps/NAIVE_STEPS times the
    # segments timed, each the same plan over the same horizon.
    naive_pair_s = naive["wall_s"] / NAIVE_PAIRS * rp["steps"] / NAIVE_STEPS
    ratio = rp["pairs_per_sec"] * naive_pair_s
    rec["factory"] = {"report": {k: v for k, v in rp.items()
                                 if k != "playback_occupancy"},
                      "wall_s": cell_s, "launches": carry, "naive": naive,
                      "naive_pair_s": naive_pair_s, "ratio_to_naive": ratio,
                      "bitwise_references": True}
    log(f"# 11d factory cell {FACTORY_SCENARIO}/{FACTORY_INTENSITY} "
        f"{rp['pairs']} pairs x {rp['steps']} ticks in blocks of "
        f"{rp['block_T']}: {cell_s:.3f} s (gen {rp['gen_s']}, plan "
        f"{rp['plan_s']}, label {rp['label_s']}, collect "
        f"{rp['collect_s']}); {rp['pairs_per_sec']} pairs/s against the "
        f"naive per-pair loop's {1 / naive_pair_s:.4f} ({NAIVE_PAIRS} pair "
        f"of {NAIVE_STEPS} ticks in {naive['wall_s']} s ({naive_s:.3f} s "
        f"fenced), {naive_pair_s:.3f} s for {rp['steps']} ticks; no "
        f"warm-up pair: the planner ran just before): x{ratio:.2f}; CARRY "
        f"launches {carry}; playback and rule column bitwise the unblocked "
        f"references")
    del cell, ref_play, ref_rule

    # 11e: train_flagship end to end through main, saved and loaded back.
    path = "runs/chip_smoke_flagship_multiregion.npz"
    runlog = "runs/chip_smoke_flagship_multiregion.jsonl"
    if os.path.exists(runlog):
        os.remove(runlog)
    zero_counters()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc, flag_s = synced(lambda: flagship.main([
            "--preset", "multiregion", "--init-from", "distill:carbon",
            "--refine", "cem", "--cem-engine", "mega",
            "--iterations", str(FLAGSHIP_GENS), "--eval-steps", str(T_DAY),
            "--traces", str(N_SELECT), "--distill-iterations",
            str(FLAGSHIP_DISTILL), "--seed", str(TRAIN_SEED), "--out", path,
            "--runlog", runlog]))
    flag_launches = read_counters()
    saved = json.loads(out.getvalue())
    back, meta = load_params_npz(saved["checkpoint"])   # verifies the digest
    if (rc != 0 or meta["cem_engine"] != "mega"
            or meta[PARAMS_DIGEST_KEY] != params_digest(back)):
        fail(f"11e: train_flagship's checkpoint does not check: rc {rc}, "
             f"meta {meta}")
    for name in ("rollout_profiles_kernel", "rollout_profiles_kernel<CARBON>",
                 "rollout_mlp_kernel"):
        if flag_launches[name] != FLAGSHIP_GENS:
            fail(f"11e: train_flagship launched {name} "
                 f"{flag_launches[name]} times in {FLAGSHIP_GENS} "
                 f"generations")
    # The run log's clock: the init candidate's selection evaluation (a
    # PPOBackend on N_SELECT full days, eager) is the span between the
    # teacher's note and the first "eval" event.
    recs = read_runlog(runlog)
    t_teacher = next(r["elapsed_s"] for r in recs
                     if r["event"] == "note" and r["msg"].startswith(
                         "teacher"))
    t_eval0 = next(r["elapsed_s"] for r in recs if r["event"] == "eval")
    rec["selection_eval_s"] = t_eval0 - t_teacher
    rec["flagship"] = {"wall_s": flag_s, "launches": flag_launches,
                       "selected_iteration": meta["selected_iteration"],
                       "wins_both": meta["wins_both"],
                       "scoreboard": meta["selection_scoreboard"]}
    log(f"# 11e train_flagship (distill:carbon {FLAGSHIP_DISTILL} "
        f"iterations, cem mega {FLAGSHIP_GENS} generations, selection "
        f"{N_SELECT} x {T_DAY}) through main: {flag_s:.3f} s; launches "
        f"{flag_launches}; saved and loaded back, digest "
        f"{meta[PARAMS_DIGEST_KEY][:12]} checks; selected iteration "
        f"{meta['selected_iteration']}, wins_both {meta['wins_both']}; a "
        f"selection evaluation ({N_SELECT} x {T_DAY} ticks, eager) "
        f"{rec['selection_eval_s']:.3f} s by its run log")
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"# 11: {rec['seconds']:.1f} s")
    return rec


LOOP_TICKS = 96
LOOP_START_S = 8 * 3600 + 36 * 60   # 08:36: ticks 0-47 off-peak, 48+ peak
LOOP_SEED = 7
LOOP_KILLS = 3
LOOP_STAGES = ("scrape", "decide", "render", "apply", "verify", "estimate")
LOOP_FLOATS = ("cost_usd_hr", "carbon_g_hr", "nodes_spot", "nodes_od",
               "pending_pods", "latency_p95_ms", "usd_per_kreq",
               "g_co2_per_kreq", "waste_frac")
# bench.py::bench_recovery's size is 8 runs a cell; cut to 4 for time
# (phase 12 took 171 s with 8, the board 42 s of it; PERF.md §4).
RECOVERY_RUNS = 4
RECOVERY_TICKS = 32


def loop_backend(cfg, name: str, device):
    """The phase's backends: the rule, the carbon teacher, the shipped
    flagship and diff-MPC at its defaults (oracle windows)."""
    from ccka_tpu_torch.cli import make_backend

    return make_backend(cfg, {"flagship": "ppo"}.get(name, name),
                        device=device)


def loop_source(cfg):
    from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource

    return SyntheticSignalSource(cfg.cluster, cfg.workload, cfg.sim,
                                 cfg.signals, start_unix_s=LOOP_START_S)


def drive_loop(ctrl, t0: int, t1: int, sinks: dict) -> tuple[list, list]:
    """Ticks t0..t1-1 of ``ctrl``; returns the reports and each tick's
    rendered commands (every region's, in region order)."""
    reports, cmds = [], []
    for t in range(t0, t1):
        before = {r: len(s.commands) for r, s in sinks.items()}
        reports.append(ctrl.tick(t))
        cmds.append([c.render() for r, s in sinks.items()
                     for c in s.commands[before[r]:]])
    return reports, cmds


def start_side_process(args: list, **env) -> dict:
    """Start ``python3 <args>`` from the checkout's root in a process of
    its own (killed at exit if still running), ``env`` added to this
    process's environment; a thread waits for it and fills in "rc",
    "out", "err" and its wall "s" (join "thread" first)."""
    import atexit
    import threading

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]), **env)
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, *args], cwd=root, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    side: dict = {}

    def wait() -> None:
        out, err = proc.communicate()
        side.update(rc=proc.returncode, out=out, err=err,
                    s=time.perf_counter() - t0)

    side["thread"] = threading.Thread(target=wait, daemon=True)
    side["thread"].start()
    return side


def join_side_process(side: dict, what: str, timeout_s: float) -> str:
    """The standard output of a :func:`start_side_process` process once it
    has ended; fails if it runs past ``timeout_s`` or exits nonzero."""
    side["thread"].join(timeout=timeout_s)
    if side["thread"].is_alive() or "rc" not in side:
        fail(f"{what} did not end within {timeout_s:.0f} s")
    if side["rc"] != 0:
        fail(f"{what} exited {side['rc']}: {side['err'][-2000:]}")
    return side["out"]


LOOP_REPORT_FIELDS = ("t", "profile", "is_peak", "slo_ok", "applied",
                      "verified") + LOOP_FLOATS


def cpu_loop_session(name: str) -> None:
    """12b's CPU session of backend ``name`` (96 ticks from 08:36), as
    loop_phase drives it, printed as one JSON line: each tick's report
    fields, its rendered commands and the session's wall. Run by
    loop_phase in a process of its own, on the CPU only."""
    from ccka_tpu_torch import PRESETS
    from ccka_tpu_torch.harness.controller import controller_from_config

    cfg = PRESETS["multiregion"]()
    ctrl = controller_from_config(cfg, loop_backend(cfg, name, "cpu"),
                                  device="cpu", interval_s=0.0,
                                  log_fn=lambda s: None, seed=LOOP_SEED)
    ctrl.source = loop_source(cfg)
    t0 = time.perf_counter()
    reports, cmds = drive_loop(ctrl, 0, LOOP_TICKS, ctrl.region_sinks)
    wall = time.perf_counter() - t0
    ctrl.close()
    kinds = dict(t=int, profile=str, is_peak=bool, slo_ok=bool,
                 applied=bool, verified=bool)
    rows = [{f: kinds.get(f, float)(getattr(r, f))
             for f in LOOP_REPORT_FIELDS} for r in reports]
    print(json.dumps({"reports": rows, "cmds": cmds, "cpu_wall_s": wall}))


def pct(vals, q) -> float:
    return float(np.percentile(np.asarray(vals, np.float64), q))


def loop_phase(dev, card: str) -> dict:
    """Phase 12, the closed control loop on the card (multiregion, the
    shipped flagship): (a) `controller_from_config(device=dev)` drives
    96 ticks through the 09:00 peak edge for rule, carbon, ppo and mpc,
    with dry-run sinks, one shared SpanTracer, a MetricsExporter scraped
    once over 127.0.0.1, JSONL telemetry and a snapshot every tick; each
    stage's median and p99; the Chrome trace validated; compile_report
    with no hot entry captured again after its warm-up; (b) the same four
    sessions on the CPU: rule and carbon byte-identical command streams
    and every report float within 1e-5 relative, ppo and mpc reported
    (mpc's eager planner, the longest of them, runs in a process of its
    own from the phase's start and is read after (d));
    (c) each card run killed at three seeded ticks and resumed from its
    snapshot in a fresh Controller (a fresh backend; mpc's reuses (a)'s
    captured planner graph), bitwise; (d) the recovery scoreboard at
    bench_recovery's size but 4 runs a cell (8 there), on the card."""
    import dataclasses
    import random
    import urllib.request

    from ccka_tpu_torch import PRESETS
    from ccka_tpu_torch.actuation.sink import DryRunSink
    from ccka_tpu_torch.harness.controller import (Controller,
                                                   controller_from_config)
    from ccka_tpu_torch.harness.promexport import MetricsExporter
    from ccka_tpu_torch.harness.recovery import (_fingerprint,
                                                 recovery_scoreboard)
    from ccka_tpu_torch.harness.snapshot import load_snapshot
    from ccka_tpu_torch.harness.telemetry import read_telemetry
    from ccka_tpu_torch.obs.compile import compile_report
    from ccka_tpu_torch.obs.trace import SpanTracer, validate_chrome_trace

    cfg = PRESETS["multiregion"]()
    out_dir = "runs/chip_smoke_loop"
    os.makedirs(out_dir, exist_ok=True)
    names = ("rule", "carbon", "ppo", "mpc")
    quiet = dict(interval_s=0.0, log_fn=lambda s: None, seed=LOOP_SEED)
    rec: dict = {"card": card, "ticks": LOOP_TICKS, "stages": {}}
    # (b)'s mpc session on the CPU: its eager planner, by far the longest
    # CPU session, runs beside (a), (c) and (d) and is read after them.
    cpu_mpc = start_side_process(
        ["-c", "import chip_smoke; chip_smoke.cpu_loop_session('mpc')"],
        CUDA_VISIBLE_DEVICES="")

    # ---- (a) the loop on the card
    tracer = SpanTracer()
    runs, backends = {}, {}
    for name in names:
        backend = backends[name] = loop_backend(cfg, name, dev)
        exporter = MetricsExporter(port=0, cluster=cfg.cluster.name)
        snap = f"{out_dir}/{name}.snap"
        tel = f"{out_dir}/{name}.jsonl"
        for p in (snap, tel):
            if os.path.exists(p):
                os.unlink(p)
        try:
            ctrl = controller_from_config(
                cfg, backend, device=dev, tracer=tracer,
                exporter=exporter, telemetry_path=tel, snapshot_path=snap,
                snapshot_every=1, **quiet)
            # The configured source starts at midnight; the phase's world
            # starts at 08:36 to cross the peak edge.
            ctrl.source = loop_source(cfg)
            t0 = time.perf_counter()
            reports, cmds = drive_loop(ctrl, 0, LOOP_TICKS,
                                       ctrl.region_sinks)
            synced(lambda: None)
            wall = time.perf_counter() - t0
            ctrl.close()
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{exporter.port}/metrics",
                    timeout=30) as resp:
                scrape = resp.read().decode()
        finally:
            exporter.close()
        if "ccka_tick_decide_ms" not in scrape or "ccka_cost_usd_hr" \
                not in scrape:
            fail(f"phase 12a: the {name} exporter's scrape lacks the tick "
                 f"series")
        edge = int((9 * 3600 - LOOP_START_S) / cfg.sim.dt_s)
        if [r.is_peak for r in reports] != [t >= edge
                                            for t in range(LOOP_TICKS)]:
            fail(f"phase 12a: {name} did not cross the 09:00 edge at tick "
                 f"{edge}")
        if not all(r.applied and r.verified for r in reports):
            fail(f"phase 12a: {name} left a tick unapplied or unverified")
        if len(read_telemetry(tel)) != LOOP_TICKS:
            fail(f"phase 12a: {name} telemetry holds no line per tick")
        runs[name] = (reports, cmds, {r: [c.render() for c in s.commands]
                                      for r, s in ctrl.region_sinks.items()})
        stages = {}
        for st in LOOP_STAGES + ("tick",):
            vals = [sum(r.timings_ms.values()) if st == "tick"
                    else r.timings_ms[st] for r in reports]
            stages[st] = {"median_ms": pct(vals, 50), "p99_ms": pct(vals, 99)}
        if name == "mpc":
            every = backend.replan_every
            rep = [r.timings_ms["decide"] for r in reports
                   if r.t % every == 0]
            stages["replan_decide"] = {"median_ms": pct(rep, 50),
                                       "p99_ms": pct(rep, 99),
                                       "n": len(rep)}
        stages["wall_s"] = wall
        stages["ms_per_tick"] = wall / LOOP_TICKS * 1e3
        rec["stages"][name] = stages
        log(f"# loop[{name}] " + json.dumps(stages))
        log(f"#   {name}: mean cost {np.mean([r.cost_usd_hr for r in reports]):.5f} $/hr, "
            f"slo_ok {np.mean([r.slo_ok for r in reports]):.3f}, "
            f"profiles {sorted({r.profile for r in reports})}")
    doc = tracer.chrome_trace()
    problems = validate_chrome_trace(doc)
    log(f"# chrome trace: {len(doc['traceEvents'])} events, "
        f"validate_chrome_trace -> {problems}")
    tracer.write_chrome_trace(f"{out_dir}/trace.json")
    if problems:
        fail(f"phase 12a: the Chrome trace is not loadable: {problems[:5]}")
    report = compile_report()
    log("# compile_report " + json.dumps(report))
    late = {k: v["recompiles"] for k, v in report.items()
            if v["recompiles"]}
    if late:
        fail(f"phase 12a: hot entries captured again after warm-up: {late}")
    if report.get("mpc.replan", {}).get("compiles", 0) < 1:
        fail("phase 12a: the mpc replan never ran through its graph")
    rec["compile_report"] = report

    # ---- (b) the same sessions on the CPU
    rec["cpu"] = {}

    def against_cpu(name, reports, cmds, cpu_wall) -> None:
        g_reports, g_cmds, _ = runs[name]
        diff_ticks = [t for t in range(LOOP_TICKS) if cmds[t] != g_cmds[t]]
        worst, worst_at = 0.0, None
        for a, b in zip(reports, g_reports):
            for f in LOOP_FLOATS:
                x, y = getattr(a, f), getattr(b, f)
                d = abs(y - x) / max(abs(x), 1e-6)
                if f == "pending_pods":
                    # A remainder of the demand: held at its scale.
                    d = abs(y - x) / max(abs(x), cfg.workload.total_pods)
                if d > worst:
                    worst, worst_at = d, (a.t, f, x, y)
        same_exact = all(
            (a.profile, a.is_peak, a.slo_ok, a.applied, a.verified) ==
            (b.profile, b.is_peak, b.slo_ok, b.applied, b.verified)
            for a, b in zip(reports, g_reports))
        rec["cpu"][name] = {"ticks_with_different_patches": diff_ticks,
                            "max_rel_field_diff": worst,
                            "at": worst_at, "cpu_wall_s": cpu_wall}
        log(f"# card vs cpu [{name}]: {len(diff_ticks)} ticks with other "
            f"patches {diff_ticks[:20]}; largest field rel diff "
            f"{worst:.3g} at {worst_at}; cpu wall {cpu_wall:.2f} s")
        if name in ("rule", "carbon") and (
                diff_ticks or worst > 1e-5 or not same_exact):
            fail(f"phase 12b: {name} on the card is not the CPU run")

    for name in names:
        if name == "mpc":
            continue              # in its own process: read after (d)
        backend = loop_backend(cfg, name, "cpu")
        ctrl = controller_from_config(cfg, backend, device="cpu", **quiet)
        ctrl.source = loop_source(cfg)
        t0 = time.perf_counter()
        reports, cmds = drive_loop(ctrl, 0, LOOP_TICKS, ctrl.region_sinks)
        cpu_wall = time.perf_counter() - t0
        ctrl.close()
        against_cpu(name, reports, cmds, cpu_wall)

    # ---- (c) kill and resume, bitwise
    def fresh(name):
        b = loop_backend(cfg, name, dev)
        if name == "mpc":
            # The captured planner is a pure function of its inputs,
            # bitwise the eager one; a new process captures its own (20-30
            # s, timed in (a)), so the fresh backends share (a)'s.
            b._graphs = backends["mpc"]._graphs
        return b

    rng = random.Random(LOOP_SEED)
    rec["kills"] = {}
    for name in names:
        g_reports, _, g_stream = runs[name]
        kills = sorted(rng.sample(range(1, LOOP_TICKS - 1), LOOP_KILLS))
        for kill in kills:
            sinks = {r.name: DryRunSink() for r in cfg.cluster.regions}
            snap = f"{out_dir}/{name}-kill{kill}.snap"
            if os.path.exists(snap):
                os.unlink(snap)
            kw = dict(device=dev, snapshot_path=snap, **quiet)
            c1 = Controller(cfg, fresh(name), loop_source(cfg), sinks,
                            **kw)
            pre, _ = drive_loop(c1, 0, kill, sinks)
            c1.close()
            del c1
            c2 = Controller(cfg, fresh(name), loop_source(cfg), sinks,
                            **kw)
            start = c2.restore(load_snapshot(snap))
            post, _ = drive_loop(c2, start, LOOP_TICKS, sinks)
            c2.close()
            ok = ([_fingerprint(r) for r in pre + post]
                  == [_fingerprint(r) for r in g_reports]
                  and {r: [c.render() for c in s.commands]
                       for r, s in sinks.items()} == g_stream)
            log(f"# kill/resume [{name}] at tick {kill}: resumed at "
                f"{start}, bitwise {ok}")
            if start != kill or not ok:
                fail(f"phase 12c: {name} killed at {kill} did not resume "
                     f"bitwise")
        rec["kills"][name] = kills

    # ---- (d) the recovery scoreboard on the card
    t0 = time.perf_counter()
    board = recovery_scoreboard(cfg, policies=("rule", "flagship"),
                                runs_per_cell=RECOVERY_RUNS,
                                ticks=RECOVERY_TICKS, seed=101, device=dev)
    synced(lambda: None)
    board_s = time.perf_counter() - t0
    ratios = {f"{cell}/{p}": row["usd_per_slo_hr_vs_baseline"]
              for cell, sec in board["cells"].items()
              for p, row in sec["rows"].items()}
    log(f"# recovery board: {board['n_paired_runs']} pairs, "
        f"{board_s:.2f} s wall; invariants {board['invariants']}; "
        f"ratios {ratios}; flagship {board.get('flagship_source')}")
    inv = board["invariants"]
    if (inv["duplicate_patches_total"] or inv["lost_patches_total"]
            or inv["resume_bitwise_frac"] != 1.0
            or any(v != 1.0 for v in ratios.values())
            or len(ratios) != 8):
        fail("phase 12d: the recovery board broke its invariants")
    rec["recovery"] = {"wall_s": board_s, "invariants": inv,
                       "n_paired_runs": board["n_paired_runs"]}

    # (b)'s mpc session, from its own process.
    got = json.loads(join_side_process(cpu_mpc, "phase 12b: the CPU mpc "
                                       "session", 900).splitlines()[-1])
    against_cpu("mpc", [types.SimpleNamespace(**r) for r in got["reports"]],
                got["cmds"], got["cpu_wall_s"])
    rec["cpu"]["mpc"]["process_wall_s"] = cpu_mpc["s"]
    with open(f"{out_dir}/loop_record.json", "w") as fh:
        json.dump(rec, fh, indent=1, default=str)
    return rec


# ---- the command line on the card (phase 13)

CLI_SEED = 3
CLI_FULL_DAYS = 1
CLI_B = 1024
CLI_DAYS = 0.125                    # 360 ticks of 30 s
CLI_POLICIES = ("rule", "carbon", "neutral")
CLI_KERNEL = {"rule": "rollout_profiles_kernel",
              "neutral": "rollout_profiles_kernel",
              "carbon": "rollout_profiles_kernel<CARBON>"}
CLI_EVAL = ["--preset", "multiregion", "evaluate", "--backends",
            "rule,carbon,ppo", "--days", "0.0625", "--traces", "4",
            "--deterministic"]
# Fields of an evaluate row that read the per-tick SLO gate: a tick whose
# latency sits at the gate may flip on a last-bit difference of the
# flagship's policy (tests/test_torch_cli.py measures one such flip
# across frameworks); at most one flipped cluster-tick is allowed there.
CLI_GATED = ("slo_attainment", "slo_hours", "usd_per_slo_hour",
             "objective_usd", "vs_rule_objective", "vs_rule_usd_per_slo_hour")
CLI_BOARDS = (
    ("chaos-eval", ["--preset", "multiregion", "chaos-eval", "--policies",
                    "rule,carbon,flagship", "--intensities", "off,severe"],
     "intensities", ("off", "severe")),
    ("scenario-eval", ["--preset", "multiregion", "scenario-eval",
                       "--policies", "rule,carbon,flagship", "--scenarios",
                       "mixed"], "scenarios", ("mixed",)))
CLI_SHOWN = (["offpeak", "--json"], ["peak", "--json"], ["reset", "--json"],
             ["bootstrap", "--json"], ["guardrails", "--json"],
             ["burst", "--json"], ["watch"], ["dashboard", "--json"],
             ["pipeline", "--json"])


def run_cli(argv: list) -> tuple[int, str, str]:
    """``ccka_tpu_torch.cli.main(argv)`` with its stdout and stderr
    captured; fails on a nonzero exit."""
    import contextlib
    import io

    from ccka_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(list(argv))
    if rc != 0:
        fail(f"`{' '.join(argv)}` exited {rc}: {err.getvalue()[-2000:]}")
    return rc, out.getvalue(), err.getvalue()


def cli_json(argv: list) -> dict:
    text = run_cli(argv)[1]
    return json.loads(text[text.index("{"):])


class PlainCalls:
    """Counts calls of the profile kernel's plain versions
    (`sim/megakernel.py::_plain_summary`, `_plain_rollout`) while
    installed; the entries look them up at each call."""

    def __init__(self):
        from ccka_tpu_torch.sim import megakernel as mk

        self.mk, self.calls = mk, 0
        self.saved = {n: getattr(mk, n)
                      for n in ("_plain_summary", "_plain_rollout")}

    def __enter__(self):
        for name, fn in self.saved.items():
            def counted(*a, _fn=fn, **k):
                self.calls += 1
                return _fn(*a, **k)
            setattr(self.mk, name, counted)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.mk, name, fn)


def rel_diff(got, want, path: str = "") -> list:
    """(path, |a - b| / max(|b|, 1e-9)) for every number of two JSON
    documents of one shape; fails on a shape or text difference."""
    if isinstance(want, dict):
        if set(got) != set(want):
            fail(f"phase 13: keys differ at {path}: "
                 f"{sorted(set(got) ^ set(want))}")
        return [d for k in want for d in rel_diff(got[k], want[k],
                                                   f"{path}.{k}")]
    if isinstance(want, list):
        if len(got) != len(want):
            fail(f"phase 13: lengths differ at {path}")
        return [d for i, (g, w) in enumerate(zip(got, want))
                for d in rel_diff(g, w, f"{path}[{i}]")]
    if isinstance(want, (int, float)) and not isinstance(want, bool):
        return [(path, abs(got - want) / max(abs(want), 1e-9))]
    if got != want:
        fail(f"phase 13: {path} is {got!r} on the card, {want!r} on the "
             f"CPU")
    return []


def cli_phase(dev, card: str, hold, plain, zero_counters,
              read_counters) -> dict:
    """Phase 13, the command line on the card: each subcommand through
    `ccka_tpu_torch.cli.main` with its default device. (a) preroll; (b)
    simulate at default B = 32768 x T = 2880 stochastic on device traces
    under rule, carbon and neutral (one profile kernel launch a run, no
    plain version), then at B = 1024 x T = 360 on host traces, each
    report bitwise the direct kernel entry's means and the entry held
    against its plain version at phase 4's deterministic standard; (c)
    evaluate on the card and on the CPU; (d) chaos-eval and
    scenario-eval at B = 32768 x T = 2880, each bitwise a direct board
    call, launches by instantiation; (e) train ppo for one iteration,
    observe its state directory on the card and the CPU; (f) the profile
    commands' and operator tools' output. Returns the phase's record."""
    from ccka_tpu_torch.cli import simulate_report
    from ccka_tpu_torch.config import PRESETS
    from ccka_tpu_torch.faults.scoreboard import fault_scoreboard
    from ccka_tpu_torch.kernels import build
    from ccka_tpu_torch.policy.carbon import CarbonAwarePolicy
    from ccka_tpu_torch.policy.rule import (neutral_action, offpeak_action,
                                            peak_action)
    from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource
    from ccka_tpu_torch.sim import megakernel as mk
    from ccka_tpu_torch.sim.types import SimParams
    from ccka_tpu_torch.workloads.scoreboard import workload_scoreboard

    t_phase = time.perf_counter()
    rec: dict = {"seconds": {}, "launches": {}}

    def timed(name: str, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        rec["seconds"][name] = time.perf_counter() - t0
        return out

    # ---- (a) preroll under the default device
    zero_counters()
    _, text, _ = timed("preroll", lambda: run_cli(["preroll"]))
    rec["launches"]["preroll"] = read_counters()["rollout_profiles_kernel"]
    rows = [ln for ln in text.splitlines() if ln.startswith("[")]
    for ln in rows:
        log(f"# cli preroll: {ln}")
    name = torch.cuda.get_device_name(0)
    if not any(ln.startswith("[PASS] torch-device") and name in ln
               for ln in rows):
        fail(f"phase 13a: preroll's device row does not name {name}")
    if not any(ln.startswith("[PASS] kernels-build") for ln in rows):
        fail("phase 13a: preroll's kernel row did not pass")
    if rec["launches"]["preroll"] != 1:
        fail(f"phase 13a: preroll launched the rule kernel "
             f"{rec['launches']['preroll']} times, not once")

    # ---- (b) simulate: the fleet at full size, then against the entries
    rec["simulate"] = {}
    for policy in CLI_POLICIES:
        argv = ["simulate", "--backend", policy, "--clusters", str(B_MAIN),
                "--days", str(CLI_FULL_DAYS), "--stochastic",
                "--device-traces"]
        zero_counters()
        with PlainCalls() as pc:
            report = timed(f"simulate {policy} B={B_MAIN}",
                           lambda: cli_json(argv))
        launches = read_counters()
        rec["launches"][f"simulate {policy}"] = launches[CLI_KERNEL[policy]]
        others = {k: v for k, v in launches.items()
                  if k != CLI_KERNEL[policy] and v}
        log(f"# cli simulate {policy} default B={B_MAIN} "
            f"T={int(CLI_FULL_DAYS * T_DAY)} "
            f"stochastic --device-traces: "
            f"{rec['seconds'][f'simulate {policy} B={B_MAIN}']:.3f} s; "
            f"launches {launches}; plain calls {pc.calls}; $/SLO-hr "
            f"{report['usd_per_slo_hour']:.6f}, SLO attainment "
            f"{report['slo_attainment']:.6f}")
        if launches[CLI_KERNEL[policy]] != 1 or others or pc.calls:
            fail(f"phase 13b: simulate {policy} launched {launches} with "
                 f"{pc.calls} plain calls, not one {CLI_KERNEL[policy]} "
                 f"launch and no plain version")
        if report["clusters"] != B_MAIN or not all(
                math.isfinite(v) for v in report.values()
                if isinstance(v, float)):
            fail(f"phase 13b: simulate {policy} report malformed")
        rec["simulate"][policy] = report

    cfg = PRESETS["default"]()
    src = SyntheticSignalSource(cfg.cluster, cfg.workload, cfg.sim,
                                cfg.signals)
    params = SimParams.from_config(cfg, device=dev)
    T = int(CLI_DAYS * 86400.0 / cfg.sim.dt_s)
    traces = src.batch_trace(T, [CLI_SEED + i for i in range(CLI_B)],
                             device=dev)
    off, peak = offpeak_action(cfg.cluster, dev), peak_action(cfg.cluster,
                                                              dev)
    neutral = neutral_action(cfg.cluster, dev)
    cp = CarbonAwarePolicy(cfg.cluster, device=dev)
    direct = {
        "rule": lambda: mk.megakernel_rollout_summary(
            params, off, peak, traces, CLI_SEED, stochastic=False,
            device=dev),
        "neutral": lambda: mk.megakernel_rollout_summary(
            params, neutral, neutral, traces, CLI_SEED, stochastic=False,
            device=dev),
        "carbon": lambda: mk.carbon_megakernel_rollout_summary(
            params, off, peak, traces, CLI_SEED, sharpness=cp.sharpness,
            min_weight=cp.min_weight, stickiness=cp.stickiness,
            stochastic=False, device=dev)}
    action_fns = {
        "rule": mk._profile_action_fn(off, peak, None),
        "neutral": mk._profile_action_fn(neutral, neutral, None),
        "carbon": mk._profile_action_fn(
            off, peak, (cp.sharpness, cp.min_weight, cp.stickiness))}
    rec["held"] = {}
    for policy in CLI_POLICIES:
        argv = ["simulate", "--backend", policy, "--clusters", str(CLI_B),
                "--days", str(CLI_DAYS), "--seed", str(CLI_SEED)]
        got = timed(f"simulate {policy} B={CLI_B}", lambda: cli_json(argv))
        entry = timed(f"direct entry {policy} B={CLI_B}", direct[policy])
        want = json.loads(json.dumps(simulate_report(entry, policy, CLI_B,
                                                     CLI_DAYS)))
        if got != want:
            bad = [k for k in want if got.get(k) != want[k]]
            fail(f"phase 13b: simulate {policy} B={CLI_B} is not the "
                 f"direct entry's means: {bad}")
        reference = timed(f"plain {policy} B={CLI_B}", lambda: plain(
            cfg, params, traces, CLI_SEED, False, action_fns[policy]))
        same, max_abs = hold(f"cli simulate {policy} default B={CLI_B} "
                             f"T={T} deterministic (host traces)", entry,
                             reference, False)
        rec["held"][policy] = {"bitwise": same, "max_abs_err": max_abs}
    del traces
    torch.cuda.empty_cache()

    # ---- (c) evaluate on the card and on the CPU
    card_board = timed("evaluate card", lambda: cli_json(CLI_EVAL))
    cpu_board = timed("evaluate cpu",
                      lambda: cli_json(CLI_EVAL + ["--device", "cpu"]))
    worst = {}
    ticks = int(0.0625 * 86400.0 / cfg.sim.dt_s)
    for name, row in cpu_board.items():
        got = dict(card_board[name])
        if got.pop("backend") != row.get("backend"):
            fail(f"phase 13c: evaluate {name}: another backend")
        want = {k: v for k, v in row.items() if k != "backend"}
        diffs = rel_diff(got, want, name)
        tol = 1e-3 if name == "ppo" else 1e-5
        gated = [d for d in diffs if d[0].split(".")[1] in CLI_GATED
                 or ".per_trace." in d[0]]
        flips = (abs(got["slo_attainment"] - want["slo_attainment"])
                 * 4 * ticks)
        if name == "ppo" and flips > 0.5:
            log(f"#   evaluate ppo: {flips:.2f} cluster-ticks flipped at "
                f"the SLO gate between the card and the CPU")
            if flips > 1.001:
                fail("phase 13c: evaluate ppo flipped more than one "
                     "cluster-tick at the SLO gate")
            diffs = [d for d in diffs if d not in gated]
        worst[name] = max(diffs, key=lambda d: d[1]) if diffs else ("", 0.0)
        bad = [d for d in diffs if d[1] > tol]
        if bad:
            fail(f"phase 13c: evaluate {name} card against CPU beyond "
                 f"{tol}: {bad[:5]}")
    rec["evaluate_worst"] = worst
    log(f"# cli evaluate multiregion 4 x {ticks} deterministic: card "
        f"{rec['seconds']['evaluate card']:.3f} s, CPU "
        f"{rec['seconds']['evaluate cpu']:.3f} s; worst field card against "
        f"CPU {worst}")

    # ---- (d) the boards through the command line, against direct calls
    mcfg = PRESETS["multiregion"]()
    rec["boards"] = {}
    for name, argv, key, names in CLI_BOARDS:
        argv = argv + ["--traces", str(B_MAIN), "--steps", str(T_DAY)]
        torch.cuda.synchronize()
        zero_counters()
        for counter in (build.launch_rollout_profiles,
                        build.launch_rollout_mlp, build.launch_rollout_plan):
            counter.launches.clear()
        got = timed(name, lambda: cli_json(argv))
        launches = dict(read_counters())
        for kernel, counter in (
                ("rollout_profiles_kernel", build.launch_rollout_profiles),
                ("rollout_mlp_kernel", build.launch_rollout_mlp)):
            launches.update({kernel + k: v
                             for k, v in counter.launches.items()})
        rec["launches"][name] = launches
        kw = dict(policies=("rule", "carbon", "flagship"), n_traces=B_MAIN,
                  eval_steps=T_DAY, seed=31, device=dev)
        want = json.loads(json.dumps(timed(
            f"{name} direct", lambda: fault_scoreboard(
                mcfg, intensities=names, **kw) if name == "chaos-eval"
            else workload_scoreboard(mcfg, scenarios=names, **kw))))
        if json.dumps(got, sort_keys=True) != json.dumps(want,
                                                         sort_keys=True):
            fail(f"phase 13d: {name}'s JSON is not the direct board's")
        for entry in ("rollout_profiles_kernel",
                      "rollout_profiles_kernel<CARBON>",
                      "rollout_mlp_kernel"):
            if launches[entry] != len(names):
                fail(f"phase 13d: {name} launched {entry} "
                     f"{launches[entry]} times, not {len(names)}")
        for policy in POLICIES:
            for stream in names:
                label = instantiation_name(policy, stream)
                if launches.get(label, 0) < 1:
                    fail(f"phase 13d: {name} never launched {label}")
        rows = {(s, p): got[key][s]["rows"][p] for s in names
                for p in got[key][s]["rows"]}
        rec["boards"][name] = {f"{s} {p}": r["usd_per_slo_hour"]
                               for (s, p), r in rows.items()}
        log(f"# cli {name} multiregion B={B_MAIN} T={T_DAY} stochastic: "
            f"{rec['seconds'][name]:.3f} s; bitwise the direct board; "
            f"launches {launches}; $/SLO-hr {rec['boards'][name]}")

    # ---- (e) train ppo one iteration, observe its state directory
    ckpt = os.path.join("runs", "chip_smoke_cli", "ppo")
    timed("train ppo", lambda: run_cli(["train", "--iterations", "1",
                                        "--checkpoint-dir", ckpt]))
    views = [timed(f"observe ppo {where}", lambda: cli_json(
        ["observe", "--backend", "ppo", "--checkpoint", ckpt] + extra))
        for where, extra in (("card", []), ("cpu", ["--device", "cpu"]))]
    diffs = rel_diff(views[0], views[1], "observe")
    obs_worst = max((d[1] for d in diffs), default=0.0)
    if obs_worst > 1e-6:
        fail(f"phase 13e: observe ppo on the card against the CPU: "
             f"{obs_worst:.3g}")
    rec["observe_ppo_worst"] = obs_worst
    log(f"# cli train ppo (1 iteration, default 256 x 64) "
        f"{rec['seconds']['train ppo']:.3f} s -> {ckpt}; observe card "
        f"against CPU worst {obs_worst:.3g}")

    # ---- (f) the profile commands and the operator tools
    t_tools = time.perf_counter()
    for argv in CLI_SHOWN:
        _, out, err = run_cli(argv)
        if not (out.strip() or err.strip()):
            fail(f"phase 13f: `{' '.join(argv)}` printed nothing")
        for ln in (out + err).splitlines():
            log(f"# cli {argv[0]}| {ln}")
    rec["seconds"]["operator tools"] = time.perf_counter() - t_tools
    rec["seconds"]["phase"] = time.perf_counter() - t_phase
    log(f"# phase 13 seconds: "
        + json.dumps({k: round(v, 3) for k, v in rec["seconds"].items()}))
    log(f"# card: {card}")
    return rec


# ---- the fleet controller and replayed streams on the card (phase 14)

REPLAY_STORE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "data", "replay_train_9day.npz")
REPLAY_SEED = 113
REPLAY_WINDOWS = 256                # host-checked windows of phase 14a
REPLAY_CEM_GENS = 2                 # 14a's CEM generations on the store
FLEET_NS = (1, 1024, 10240)
FLEET_N = 1024                      # the full ticks, CPU and ledger checks
FLEET_CHAIN = 32                    # chained dispatches (bench.py's chain)
FLEET_TICKS, FLEET_CPU_TICKS, FLEET_KILL = 8, 4, 4
FLEET_SEED = 17
FLEET_BACKENDS = ("rule", "carbon", "ppo")
FLEET_ROSTER = ("rule", "carbon", "carbon-sharp")
LEDGER_TICKS = 48


def replay_phase(dev, setup, hold, plain, rule_fn, carbon_fn,
                 zero_counters, read_counters) -> dict:
    """14a: the replay device samplers on the default preset's 9-day
    store, and the rollout kernels on replayed streams. Windows bitwise
    the host slices at the same offsets; the packed stream's exo rows
    bitwise `_pack_exo` of those windows; 8 blocks of 360 bitwise the
    unblocked stream. Then at B = 32768 x T = 2880, stochastic, one
    replayed stream: the rule, carbon and MLP (the replay flagship)
    kernels with the counters zeroed just before and read just after,
    each timed (median of 5) with its bound, each held against its plain
    version (B = 1024 x T = 360 both modes at phase 4's standard, the MLP
    at B = 1024 x T = 32 at phase 5a's). The same on a replayed stream
    with mild faults and the mixed families (the <FAULTS,WL_D=16>
    instantiations, held at phase 5c's standard: B = 8192 x T = 360, the
    MLP per cluster at B = 1024 x T = 32). The rule CARRY drive over the
    replayed day in 8 blocks, then the same day through the streaming
    pipeline, sync and double-buffered (the samplers write into the
    drives' reused buffers), each bitwise the unblocked kernel. Two CEM
    generations on the replay source (NP = 64 x G = 256 x T = 2880), the
    second reusing the first's stream buffer: one rule, one carbon and
    one population launch each."""
    from ccka_tpu_torch.config import FAULT_PRESETS
    from ccka_tpu_torch.kernels import build
    from ccka_tpu_torch.policy.carbon import CarbonAwarePolicy
    from ccka_tpu_torch.signals.replay import ReplaySignalSource
    from ccka_tpu_torch.signals.synthetic import family_generator
    from ccka_tpu_torch.sim import megakernel as mk
    from ccka_tpu_torch.train import cem
    from ccka_tpu_torch.workloads.scenarios import WORKLOAD_SCENARIOS

    t_phase = time.perf_counter()
    laps = [t_phase]

    def lap() -> str:
        """Seconds since the previous lap, for the sub-steps' lines."""
        torch.cuda.synchronize()
        laps.append(time.perf_counter())
        return f"({laps[-1] - laps[-2]:.2f} s)"

    cfg, _, params, off, peak, net = setup("default", "replay")
    Z = cfg.cluster.n_zones
    src = ReplaySignalSource.from_file(REPLAY_STORE)
    stored = src._trace.steps
    rec: dict = {"store": os.path.relpath(REPLAY_STORE), "stored_ticks":
                 stored}

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    # The samplers against the host store.
    tr = src.batch_trace_device(T_DAY, gen(REPLAY_SEED), REPLAY_WINDOWS,
                                device=dev)
    offs = src._window_offsets(gen(REPLAY_SEED), REPLAY_WINDOWS).cpu()
    ext = src._trace_at(0, stored + T_DAY)
    for i, o in enumerate(offs.tolist()):
        host = ext.slice_steps(int(o), T_DAY)
        if not all(torch.equal(x[i].cpu(), h) for x, h in zip(tr, host)):
            fail(f"14a: replayed window {i} (offset {o}) is not the host "
                 f"slice of the store")
    stream, synth_s = synced(lambda: src.packed_trace_device(
        T_DAY, REPLAY_SEED, B_MAIN, device=dev))
    windows = src.batch_trace_device(T_DAY, family_generator(
        REPLAY_SEED, None, dev), B_MAIN, device=dev)
    if not torch.equal(stream, mk._pack_exo(windows, T_DAY)):
        fail("14a: packed_trace_device is not _pack_exo of its windows")
    del windows
    blocks = [src.packed_block_trace_device(
        BLOCK_DAY, REPLAY_SEED, B_MAIN, j, total_steps=T_DAY,
        t_chunk=T_CHUNK_STREAM, device=dev)
        for j in range(T_DAY // BLOCK_DAY)]
    if not torch.equal(torch.cat(blocks), stream):
        fail("14a: the blocked replayed stream does not concatenate to the "
             "unblocked one")
    log(f"# 14a replay samplers ({rec['store']}, {stored} ticks): "
        f"{REPLAY_WINDOWS} "
        f"windows of {T_DAY} bitwise the host slices; the packed stream "
        f"B={B_MAIN} ({synth_s * 1e3:.3f} ms) bitwise _pack_exo of its "
        f"windows; {len(blocks)} blocks of {BLOCK_DAY} bitwise the "
        f"unblocked stream {lap()}")

    # The kernels on the replayed stream, counted, then timed.
    torch.cuda.synchronize()
    zero_counters()
    main = {
        "rule": mk.megakernel_summary_from_packed(
            params, off, peak, stream, T_DAY, seed=5, stochastic=True),
        "carbon": mk.carbon_megakernel_summary_from_packed(
            params, off, peak, stream, T_DAY, seed=5, stochastic=True),
        "mlp": mk.neural_megakernel_summary_from_packed(
            params, cfg.cluster, net, stream, T_DAY, seed=5,
            stochastic=True)}
    torch.cuda.synchronize()
    rec["launches"] = read_counters()
    for name, kernel in (("rule", "rollout_profiles_kernel"),
                         ("carbon", "rollout_profiles_kernel<CARBON>"),
                         ("mlp", "rollout_mlp_kernel")):
        if rec["launches"][kernel] != 1:
            fail(f"14a: the replayed stream launched {kernel} "
                 f"{rec['launches'][kernel]} times, not once")
        for f in ("usd_per_slo_hour", "g_co2_per_kreq", "slo_attainment"):
            v = getattr(main[name], f)
            if v.shape != (B_MAIN,) or not torch.isfinite(v).all():
                fail(f"14a: {name}.{f} malformed on the replayed stream")
    log(f"#   the three launches {lap()}")
    rec["kernels"] = {}
    for name in ("rule", "carbon", "mlp"):
        ms = median_ms(lambda: run_entry(name, cfg, params, net, stream,
                                         T_DAY, True, seed=5))
        b_ms, b_by, _terms, _ops = lane_bound(cfg, name, "plain", net)
        rec["kernels"][name] = {"ms": ms, "bound_ms": b_ms, "bound_by": b_by}
        log(f"#   {name} on the replayed day B={B_MAIN} T={T_DAY}: "
            f"{ms:.4f} ms median of {N_TIMED}; bound {b_ms:.4f} ms "
            f"({b_by}); fleet $/SLO-hr "
            f"{main[name].usd_per_slo_hour.mean().item():.6f}")
    log(f"#   the three kernels on the replayed day {lap()}")
    del main

    # The streamed replayed day: 8 CARRY launches, bitwise the unblocked.
    fns = block_fns(cfg, params, "rule", T_DAY, BLOCK_DAY, True)
    build.launch_rollout_profiles.launches.clear()
    got = fns.finalize(carry_day(fns, blocks))
    want = mk.packed_mode_summary(params, cfg.cluster, "rule", stream,
                                  T_DAY, STREAM_SEED, stochastic=True)
    torch.cuda.synchronize()
    carry_launches = dict(build.launch_rollout_profiles.launches)
    if not bitwise(got, want):
        fail("14a: the streamed replayed day is not bitwise the unblocked "
             "kernel")
    if carry_launches.get("<CARRY>", 0) != len(blocks):
        fail(f"14a: the streamed replayed day launched {carry_launches}")
    rec["carry_launches"] = carry_launches
    log(f"#   streamed replayed day: {carry_launches} launches, bitwise the "
        f"unblocked kernel {lap()}")
    # The same day through the streaming pipeline (`sim/streaming.py`):
    # both drives write each block into the buffers they reuse.
    from ccka_tpu_torch.sim import streaming as stm

    want_host = type(want)(*(x.cpu() for x in want))
    build.launch_rollout_profiles.launches.clear()
    for pipelined in (False, True):
        summary, srep = stm.streaming_rollout_summary(
            src, params, cfg.cluster, "rule", key=REPLAY_SEED, batch=B_MAIN,
            T=T_DAY, block_T=BLOCK_DAY, seed=STREAM_SEED,
            t_chunk=T_CHUNK_STREAM, stochastic=True, pipelined=pipelined,
            device=dev)
        if not bitwise(summary, want_host):
            fail(f"14a: the replayed day through the streaming pipeline "
                 f"(pipelined={pipelined}) is not bitwise the unblocked "
                 f"kernel")
    torch.cuda.synchronize()
    stream_launches = dict(build.launch_rollout_profiles.launches)
    if stream_launches != {"<CARRY>": 2 * len(blocks)}:
        fail(f"14a: the streaming pipeline on the replayed day launched "
             f"{stream_launches}")
    rec["streaming_launches"] = stream_launches
    log(f"#   the replayed day through the streaming pipeline (sync and "
        f"double-buffered, {srep.get('stream_buffers')} stream buffers): "
        f"{stream_launches} launches, both bitwise the unblocked kernel "
        f"{lap()}")
    del blocks, stream, got, want, want_host, summary
    torch.cuda.empty_cache()

    # Each kernel against its plain version on a replayed stream.
    short = src.packed_trace_device(T_PARITY, REPLAY_SEED + 1, B_MULTI,
                                    device=dev)
    views = mk.unpack_exo(short, T_PARITY, Z)
    rec["parity"] = {}
    for name, fn in (("rule", rule_fn(cfg)), ("carbon", carbon_fn(cfg))):
        for st in (False, True):
            k = run_entry(name, cfg, params, net, short, T_PARITY, st)
            p, p_s = synced(lambda: plain(cfg, params, views, LANE_SEED, st,
                                          fn))
            same, max_abs = hold(f"14a {name} replay B={B_MULTI} "
                                 f"T={T_PARITY} "
                                 f"{'stochastic' if st else 'deterministic'}",
                                 k, p, st)
            rec["parity"][name] = {"bitwise": same, "max_abs_err": max_abs,
                                   "plain_ms": p_s * 1e3}
    mshort = src.packed_trace_device(T_SHORT, REPLAY_SEED + 2, B_MULTI,
                                     device=dev)
    k = run_entry("mlp", cfg, params, net, mshort, T_SHORT, False)
    p, p_s = synced(lambda: lane_plain("mlp", cfg, params, net, mshort,
                                       T_SHORT, False))
    rel = field_rel(k, p)
    bad = {f: r for f, r in rel.items()
           if r > (SHORT_LOOSE_TOL if f in SHORT_LOOSE else SHORT_TOL)}
    worst = max(rel, key=rel.get)
    log(f"# parity 14a mlp replay B={B_MULTI} T={T_SHORT} deterministic: "
        f"bitwise {bitwise(k, p)}; largest per-cluster rel diff {worst} "
        f"{rel[worst]:.3g}")
    if bad:
        fail(f"14a: mlp parity on the replayed stream: {bad}")
    rec["parity"]["mlp"] = {"max_abs_err": float(max(
        (getattr(k, f).double() - getattr(p, f).double()).abs().max()
        for f in k._fields)), "plain_ms": p_s * 1e3}
    log(f"#   plain versions on the replayed stream {lap()}")
    del short, views, mshort

    # The widened replayed stream: mild faults and the mixed families.
    wl = WORKLOAD_SCENARIOS["mixed"].workloads
    wsrc = ReplaySignalSource.from_file(REPLAY_STORE,
                                        faults=FAULT_PRESETS["mild"],
                                        workloads=wl)
    wparams = lane_params(cfg, wl, dev)
    wide = wsrc.packed_trace_device(T_DAY, REPLAY_SEED, B_MAIN, device=dev)
    for counter in (build.launch_rollout_profiles, build.launch_rollout_mlp):
        counter.launches.clear()
    for name in ("rule", "carbon", "mlp"):
        run_entry(name, cfg, wparams, net, wide, T_DAY, True, seed=5)
    torch.cuda.synchronize()
    wl_launches = {**{"rollout_profiles_kernel" + k: v for k, v in
                      build.launch_rollout_profiles.launches.items()},
                   **{"rollout_mlp_kernel" + k: v for k, v in
                      build.launch_rollout_mlp.launches.items()}}
    rec["wide_launches"] = wl_launches
    rec["wide"] = {}
    for name in ("rule", "carbon", "mlp"):
        label = instantiation_name(name, "mixed")
        if wl_launches.get(label, 0) != 1:
            fail(f"14a: the widened replayed stream launched {label} "
                 f"{wl_launches.get(label, 0)} times: {wl_launches}")
        ms = median_ms(lambda: run_entry(name, cfg, wparams, net, wide,
                                         T_DAY, True, seed=5))
        b_ms, b_by, _terms, _ops = lane_bound(cfg, name, "mixed", net)
        rec["wide"][label] = {"ms": ms, "bound_ms": b_ms, "bound_by": b_by}
        log(f"#   {label} on the widened replayed day B={B_MAIN} "
            f"T={T_DAY}: {ms:.4f} ms median of {N_TIMED}; bound "
            f"{b_ms:.4f} ms ({b_by})")
    log(f"#   the widened replayed day {lap()}")
    del wide
    torch.cuda.empty_cache()
    wshort = wsrc.packed_trace_device(T_PARITY, REPLAY_SEED + 3, B_PARITY,
                                      device=dev)
    for name in ("rule", "carbon"):
        for st in (False, True):
            k = run_entry(name, cfg, wparams, net, wshort, T_PARITY, st)
            p = lane_plain(name, cfg, wparams, net, wshort, T_PARITY, st)
            hold(f"14a {instantiation_name(name, 'mixed')} widened replay "
                 f"B={B_PARITY} T={T_PARITY} "
                 f"{'stochastic' if st else 'deterministic'}", k, p, st)
    label = instantiation_name("mlp", "mixed")
    wmshort = wsrc.packed_trace_device(T_SHORT, REPLAY_SEED + 4, B_MULTI,
                                       device=dev)
    k = run_entry("mlp", cfg, wparams, net, wmshort, T_SHORT, False)
    p = lane_plain("mlp", cfg, wparams, net, wmshort, T_SHORT, False)
    rel = field_rel(k, p)
    loose = SHORT_LOOSE + ("denials", "stale_ticks", "inf_dropped",
                           "batch_deadline_misses")
    bad = {f: r for f, r in rel.items()
           if r > (SHORT_LOOSE_TOL if f in loose else SHORT_TOL)}
    worst = max(rel, key=rel.get)
    log(f"# parity 14a {label} widened replay B={B_MULTI} T={T_SHORT} "
        f"deterministic: bitwise {bitwise(k, p)}; largest per-cluster rel "
        f"diff {worst} {rel[worst]:.3g}")
    if bad:
        fail(f"14a: {label} parity on the widened replayed stream: {bad}")
    k = run_entry("mlp", cfg, wparams, net, wshort, T_PARITY, False)
    p = lane_plain("mlp", cfg, wparams, net, wshort, T_PARITY, False)
    viol = mk.mean_parity_violations(k, p, mk.NEURAL_MEAN_PARITY_TOLERANCES)
    log(f"# parity 14a {label} widened replay B={B_PARITY} T={T_PARITY} "
        f"deterministic: bitwise {bitwise(k, p)}; mean_parity_violations "
        f"{viol}")
    if viol:
        fail("14a: mlp mean parity on the widened replayed stream")
    log(f"#   plain versions on the widened replayed stream {lap()}")
    del wshort, wmshort, k, p
    torch.cuda.empty_cache()

    # CEM generations on the replay source: from the second on, each
    # writes its stream into the buffer the first allocated.
    teacher = CarbonAwarePolicy(cfg.cluster, device=dev)
    ccfg = cem.CEMConfig(generations=REPLAY_CEM_GENS, popsize=TRAIN_POP,
                         traces_per_gen=TRAIN_G, eval_steps=T_DAY,
                         sigma_min=1e-3)
    zero_counters()
    (_best, chist, _info), cem_s = synced(lambda: cem.cem_refine(
        cfg, net, src, cem=ccfg, engine="mega", teacher_policy=teacher,
        seed=TRAIN_SEED, device=dev))
    rec["cem_launches"] = read_counters()
    for kernel in ("rollout_profiles_kernel",
                   "rollout_profiles_kernel<CARBON>", "rollout_mlp_kernel"):
        if rec["cem_launches"][kernel] != REPLAY_CEM_GENS:
            fail(f"14a: {REPLAY_CEM_GENS} CEM generations on the replay "
                 f"source launched {kernel} "
                 f"{rec['cem_launches'][kernel]} times")
    if len(chist) != REPLAY_CEM_GENS or not all(
            np.isfinite(h["incumbent_fitness"]) for h in chist):
        fail("14a: a replay CEM generation's fitness is not finite")
    rec["cem_s"] = cem_s
    log(f"#   {REPLAY_CEM_GENS} CEM generations on the replay source "
        f"NP={TRAIN_POP} x G={TRAIN_G} x T={T_DAY}: {cem_s:.3f} s, "
        f"launches {rec['cem_launches']}")
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"# 14a: {rec['seconds']:.1f} s")
    torch.cuda.empty_cache()
    return rec


class FixedTraces:
    """A device-batched source that serves given [N, T, ...] traces (the
    card's and the CPU's fleets then see the same worlds)."""

    def __init__(self, traces):
        self.traces = traces

    def batch_trace_device(self, steps, generator, batch, device=None):
        return type(self.traces)(*(x[:batch, :steps].to(device)
                                   for x in self.traces))


def fleet_rows(ctrl, t0: int, t1: int) -> list:
    """Ticks t0..t1-1 one by one; each tick's (packed, per) host rows."""
    rows = []
    for t in range(t0, t1):
        ctrl.tick(t)
        rows.append(ctrl.last_rows[1:])
    return rows


def sink_commands(ctrl) -> list:
    """Per-sink rendered command streams (through any chaos wrap)."""
    return [[c.render() for c in getattr(s, "inner", s).commands]
            for s in ctrl.sinks]


def same_states(a, b) -> bool:
    return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))


def fleet_phase(dev, card: str) -> dict:
    """14b: the batched fleet tick, multiregion with the shipped flagship,
    under rule, carbon and ppo (the backends that capture; mpc is refused,
    naming itself). N = 1, 1024, 10240 at horizon 2880: 32 chained
    ticks, each through the eager body and the graph, every output
    bitwise, each one's time on the stream (median, p99 of ticks 1-31;
    tick 0 holds the capture), and the controller's own dispatch chain.
    Then N = 1024: each backend's 8 full ticks with the dry-run fan-out,
    pipelined against sequential (bitwise reports, command streams and
    states), the fleet.dispatch/harvest/fanout spans; the card against
    the CPU over 4 ticks on the same traces (packed and per-cluster rows
    within 1e-5 relative; the flagship's within 1e-3, its actions and
    divergences 5e-3; rule and carbon command streams byte-identical); ledger-on (a DecisionLedger
    and a TournamentLedger over the roster rule, carbon, carbon-sharp)
    against ledger-off, bitwise; a kill at tick 4 restored into a fresh
    controller, bitwise; compile_report: one fleet.tick capture per key,
    no recapture."""
    from ccka_tpu_torch import PRESETS
    from ccka_tpu_torch.harness import fleet as fl
    from ccka_tpu_torch.harness.snapshot import load_snapshot
    from ccka_tpu_torch.obs.compile import stats_for
    from ccka_tpu_torch.obs.decisions import (DECISION_COLS, DecisionLedger,
                                              decision_row_layout,
                                              flat_action_names)
    from ccka_tpu_torch.obs.tournament import TournamentLedger
    from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource

    t_phase = time.perf_counter()
    laps = [t_phase]

    def lap() -> str:
        torch.cuda.synchronize()
        laps.append(time.perf_counter())
        return f"({laps[-1] - laps[-2]:.2f} s)"

    cfg = PRESETS["multiregion"]()
    out_dir = "runs/chip_smoke_fleet"
    os.makedirs(out_dir, exist_ok=True)
    rec: dict = {"card": card, "chain": {}, "ticks": {}}
    before = stats_for("fleet.tick")
    caps0 = before.compiles if before else 0
    keys = set()

    def fleet(backend, n, *, c=cfg, source=None, sinks=None, device=dev,
              workers=8):
        from ccka_tpu_torch.actuation.sink import DryRunSink

        source = source or SyntheticSignalSource(c.cluster, c.workload,
                                                 c.sim, c.signals)
        ctrl = fl.FleetController(
            c, backend, source, sinks or [DryRunSink() for _ in range(n)],
            horizon_ticks=T_DAY, seed=FLEET_SEED, fanout_workers=workers,
            device=device)
        if device.type == "cuda":
            keys.add((c, id(backend), n))
        return ctrl

    try:
        fleet(loop_backend(cfg, "mpc", dev), 8)
        fail("14b: the mpc backend was not refused by the fleet graph")
    except (ValueError, RuntimeError) as e:
        if "MPCBackend" not in str(e):
            raise
        log(f"# 14b mpc refused: {e}")

    backends = {name: loop_backend(cfg, name, dev) for name in
                FLEET_BACKENDS}
    syn = SyntheticSignalSource(cfg.cluster, cfg.workload, cfg.sim,
                                cfg.signals)
    for n in FLEET_NS:
        # One sample of N traces serves the three backends.
        traces, synth_s = synced(lambda: syn.batch_trace_device(
            T_DAY, torch.Generator(device=dev).manual_seed(FLEET_SEED), n,
            device=dev))
        log(f"# 14b N={n}: batch_trace_device x {T_DAY} {synth_s:.3f} s")
        for name, backend in backends.items():
            ctrl = fleet(backend, n, source=FixedTraces(traces))
            tick, xs = ctrl._tick_fn, ctrl._xs_all
            s_e = s_g = ctrl.states
            ev = [[torch.cuda.Event(enable_timing=True) for _ in range(3)]
                  for _ in range(FLEET_CHAIN)]
            for t in range(FLEET_CHAIN):
                # Each chained tick timed on the stream: the eager body
                # (its launches), then the graph's replay behind it.
                ev[t][0].record()
                e = tick.eager(s_e, xs, t)
                ev[t][1].record()
                g = tick(s_g, xs, t)
                ev[t][2].record()
                if not (torch.equal(e[0], g[0]) and torch.equal(e[2], g[2])
                        and same_states(e[1], g[1])):
                    fail(f"14b: {name} N={n}: the graph differs from its "
                         f"eager body at tick {t}")
                s_e = e[1]
                s_g = type(g[1])(*(x.clone() for x in g[1]))
            # Tick 0 holds the capture: the times are ticks 1-31's.
            eager = [ev[t][0].elapsed_time(ev[t][1])
                     for t in range(1, FLEET_CHAIN)]
            graph = [ev[t][1].elapsed_time(ev[t][2])
                     for t in range(1, FLEET_CHAIN)]
            # The controller's own dispatch (replay + copies), 32 queued,
            # after a round that allocates their pinned slots.
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                disp = [ctrl._dispatch(t) for t in range(FLEET_CHAIN)]
                torch.cuda.synchronize()
                dispatch_ms = (time.perf_counter() - t0) * 1e3 / FLEET_CHAIN
                ctrl._slots.extend(d.slot for d in disp)
            r = {"eager_ms": [float(np.median(eager)), pct(eager, 99)],
                 "graph_ms": [float(np.median(graph)), pct(graph, 99)],
                 "dispatch_chain_ms": dispatch_ms}
            rec["chain"][f"{name} N={n}"] = r
            log(f"# 14b {name} N={n}: {FLEET_CHAIN} chained ticks bitwise "
                f"the eager body; ms a tick (median, p99): eager "
                f"{r['eager_ms'][0]:.4f}, {r['eager_ms'][1]:.4f}; graph "
                f"{r['graph_ms'][0]:.4f}, {r['graph_ms'][1]:.4f}; the "
                f"controller's dispatch chain {dispatch_ms:.4f} ms a tick")
            ctrl.close()
            del ctrl, tick, xs, s_e, s_g, e, g, disp
        del traces
        torch.cuda.empty_cache()

    log(f"# 14b the chains {lap()}")

    # Full ticks at N = 1024: pipelined against sequential. The flagship's
    # sequential run is also the uninterrupted run the kill is held to.
    spans = {}
    for name in FLEET_BACKENDS:
        backend = backends[name]
        seq = fleet(backend, FLEET_N, workers=1)
        pipe = fleet(backend, FLEET_N)
        seq_reports, seq_rows = [], []
        for t in range(FLEET_TICKS):
            seq_reports.append(seq.tick(t))
            seq_rows.append(seq.last_rows[1:])
        pipe_reports = pipe.run(FLEET_TICKS)
        for a, b in zip(seq_reports, pipe_reports):
            if ((a.t, a.applied, a.slo_ok, a.cost_usd_hr, a.carbon_g_hr,
                 a.pending_pods) != (b.t, b.applied, b.slo_ok, b.cost_usd_hr,
                                     b.carbon_g_hr, b.pending_pods)):
                fail(f"14b: {name}: pipelined tick {a.t} differs from the "
                     f"sequential one")
        if sink_commands(seq) != sink_commands(pipe) or \
                not same_states(seq.states, pipe.states):
            fail(f"14b: {name}: the pipelined run's commands or states "
                 f"differ from sequential ticks")
        if any(r.applied != FLEET_N for r in pipe_reports):
            fail(f"14b: {name}: a dry-run apply failed")
        for sp in pipe.tracer.spans():
            spans.setdefault(f"{name} {sp.name}", []).append(sp.dur_ms)
        pipe.close()
        if name == "ppo":
            full, full_rows = seq, seq_rows
        else:
            seq.close()
    rec["spans"] = {k: [float(np.median(v)), pct(v, 99)]
                    for k, v in spans.items()}
    log(f"# 14b N={FLEET_N} {FLEET_TICKS} full ticks, pipelined bitwise "
        f"sequential; spans ms (median, p99): {json.dumps(rec['spans'])} "
        f"{lap()}")

    # The card against the CPU on the same traces.
    traces = syn.batch_trace_device(T_DAY, torch.Generator(
        device=dev).manual_seed(FLEET_SEED), FLEET_N, device=dev)
    rec["cpu"] = {}
    layout = decision_row_layout(cfg.cluster)
    per_names = (["slo_ok", "cost_usd", "carbon_g", "pending"]
                 + list(DECISION_COLS)
                 + [f"shadow {a}" for a in flat_action_names(cfg.cluster)])
    packed_names = flat_action_names(cfg.cluster) + ["is_peak"]
    # Pending pods are remainders of the demand: held at its scale, as in
    # phase 12b.
    pend = {per_names.index(c) for c in ("pending", "pend_c0", "pend_c1",
                                         "shadow_pend_c0", "shadow_pend_c1")}
    floor_per = np.array([cfg.workload.total_pods if i in pend else 1e-6
                          for i in range(layout.width)])
    # The flagship's standard (tests/test_torch_fleet.py): a bf16 torso
    # whose sums the two devices add in other orders holds its actions,
    # and the divergence columns made of them, within 5e-3 relative, its
    # other columns within 1e-3.
    act_cols = [layout.col("div_max_abs"), layout.col("div_l2")]
    for name in FLEET_BACKENDS:
        t0 = time.perf_counter()
        card_f = fleet(backends[name], FLEET_N, source=FixedTraces(traces))
        cpu_f = fleet(loop_backend(cfg, name, torch.device("cpu")), FLEET_N,
                      source=FixedTraces(traces), device=torch.device("cpu"))
        a = fleet_rows(card_f, 0, FLEET_CPU_TICKS)
        b = fleet_rows(cpu_f, 0, FLEET_CPU_TICKS)
        flag = name == "ppo"
        lim_packed = 5e-3 if flag else 1e-5
        lim_per = np.full(layout.width, 1e-3 if flag else 1e-5)
        lim_per[act_cols] = lim_packed
        worst, at = 0.0, None     # the largest difference over its limit
        for t, ((pa, qa), (pb, qb)) in enumerate(zip(a, b)):
            for x, y, floor, lim, cols in (
                    (pa, pb, 1e-6, lim_packed, packed_names),
                    (qa, qb, floor_per, lim_per, per_names)):
                d = (np.abs(x.astype(np.float64) - y)
                     / np.maximum(np.abs(y), floor))
                r = d / lim
                i = np.unravel_index(int(r.argmax()), r.shape)
                if r[i] > worst:
                    worst, at = float(r[i]), (t, int(i[0]), cols[i[1]],
                                              float(d[i]), float(x[i]),
                                              float(y[i]))
        same_cmds = sink_commands(card_f) == sink_commands(cpu_f)
        rec["cpu"][name] = {"share_of_standard": worst, "at": at,
                            "commands_identical": same_cmds}
        log(f"# 14b {name} card vs CPU N={FLEET_N} x {FLEET_CPU_TICKS} "
            f"ticks: the largest row difference is {worst:.3g} of its "
            f"standard ({'1e-3, actions and divergences 5e-3' if flag else '1e-5'}"
            f" relative; at tick, cluster, column, rel, card, cpu: {at}); "
            f"command streams identical {same_cmds} "
            f"({time.perf_counter() - t0:.2f} s)")
        if worst > 1.0 or (not flag and not same_cmds):
            fail(f"14b: {name}: the card's fleet and the CPU's disagree")
        card_f.close()
        cpu_f.close()

    log(f"# 14b card against CPU {lap()}")

    # Ledger-on against ledger-off, with the tournament roster; these
    # fleets and the kill's take the traces sampled above (the same
    # draw as a controller's own from FLEET_SEED).
    import dataclasses
    ck = cfg.with_overrides(**{"obs.tournament_roster": FLEET_ROSTER})
    rec["ledger"] = {}
    for name in ("rule", "ppo"):
        off_f = fleet(backends[name], FLEET_N, c=ck,
                      source=FixedTraces(traces))
        off_rows = fleet_rows(off_f, 0, FLEET_TICKS)
        obs = dataclasses.replace(
            ck.obs, enabled=True,
            decision_log_path=f"{out_dir}/decisions_{name}.jsonl",
            tournament_log_path=f"{out_dir}/tournament_{name}.jsonl")
        for p in (obs.decision_log_path, obs.tournament_log_path):
            if os.path.exists(p):
                os.remove(p)
        dec = DecisionLedger(obs, ck.train, policy=name)
        tour = TournamentLedger(obs, ck.train, FLEET_ROSTER, policy=name)
        on_f = fleet(backends[name], FLEET_N, c=ck,
                      source=FixedTraces(traces))
        on_f.ledger = dec
        on_rows = []
        for t in range(FLEET_TICKS):
            on_f.tick(t)
            on_rows.append(on_f.last_rows[1:])
            tour.observe_tick(t, on_f.last_rows[2], on_f._dec_layout)
        dec.close()
        tour.close()
        bit = (all(np.array_equal(x, y) for ra, rb in zip(on_rows, off_rows)
                   for x, y in zip(ra, rb))
               and same_states(on_f.states, off_f.states)
               and sink_commands(on_f) == sink_commands(off_f))
        if not bit:
            fail(f"14b: {name}: ledger-on and ledger-off fleets differ")
        shares = [sum(r["objective"]["shares"].values()) for r in dec.rows]
        if not all(abs(s - 1.0) <= 1e-9 for s in shares):
            fail(f"14b: {name}: a decision row's term shares do not sum "
                 f"to 1")
        div = max(r["shadow"]["div_max_abs"] for r in dec.rows)
        if name == "rule" and div != 0.0:
            fail(f"14b: the rule fleet diverges from its rule shadow "
                 f"({div})")
        rec["ledger"][name] = {"rows": dec.rows_total,
                               "div_max_abs": div,
                               "board_ticks": tour.ticks_total}
        log(f"# 14b {name} ledger-on vs off N={FLEET_N} x {FLEET_TICKS} "
            f"ticks, roster {FLEET_ROSTER}: bitwise; {dec.rows_total} "
            f"decision rows, shares sum to 1, largest divergence {div:.4g}")
        off_f.close()
        on_f.close()

    log(f"# 14b ledgers {lap()}")

    # Kill at tick 4, restore into a fresh controller; held to the
    # flagship's sequential run of the full ticks above.
    first = fleet(backends["ppo"], FLEET_N, source=FixedTraces(traces))
    fleet_rows(first, 0, FLEET_KILL)
    snap = first.write_snapshot(f"{out_dir}/fleet.snap", FLEET_KILL)
    first.close()
    # The restarted controller drives the same clusters (sinks).
    resumed = fleet(backends["ppo"], FLEET_N, sinks=first.sinks,
                    source=FixedTraces(traces))
    t_next = resumed.restore(load_snapshot(snap))
    res_rows = fleet_rows(resumed, t_next, FLEET_TICKS)
    checks = {
        "tick": t_next == FLEET_KILL,
        "rows": all(np.array_equal(x, y)
                    for ra, rb in zip(res_rows, full_rows[FLEET_KILL:])
                    for x, y in zip(ra, rb)),
        "states": same_states(resumed.states, full.states),
        "commands": sink_commands(resumed) == sink_commands(full)}
    if not all(checks.values()):
        fail(f"14b: the resumed fleet is not bitwise the uninterrupted run: "
             f"{checks}")
    log(f"# 14b ppo N={FLEET_N} killed at tick {FLEET_KILL}, restored into a "
        f"fresh controller: ticks {FLEET_KILL}-{FLEET_TICKS - 1} bitwise the "
        f"uninterrupted run")
    full.close()
    resumed.close()
    del traces

    st = stats_for("fleet.tick")
    caps = st.compiles - caps0
    rec["compile"] = st.to_dict()
    log(f"# 14b compile_report fleet.tick: {st.to_dict()}; {len(keys)} keys "
        f"built on the card")
    if caps != len(keys) or st.recompiles:
        fail(f"14b: {caps} fleet.tick captures for {len(keys)} keys, "
             f"{st.recompiles} recaptures")
    fl._compiled_fleet_tick.cache_clear()
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"# 14b: {rec['seconds']:.1f} s")
    return rec


def ledger_phase(dev) -> dict:
    """14c: the controller's ledgers: multiregion, the shipped flagship,
    48 ticks through a severe ChaosSink per region on the card, with
    incident_log= (and its flight recorder) and decision_ledger= on, then
    off: command streams and fingerprints bitwise; every incident count
    equal to its trigger's counter. Then incidents list/show/timeline,
    decisions list/explain and tournament list/board through cli.main on
    the files written."""
    import dataclasses

    from ccka_tpu_torch import PRESETS
    from ccka_tpu_torch.actuation.chaos import ChaosSink
    from ccka_tpu_torch.actuation.sink import DryRunSink
    from ccka_tpu_torch.config import CHAOS_PRESETS
    from ccka_tpu_torch.harness.controller import Controller
    from ccka_tpu_torch.harness.recovery import _fingerprint
    from ccka_tpu_torch.obs.decisions import DecisionLedger
    from ccka_tpu_torch.obs.incidents import IncidentLog
    from ccka_tpu_torch.obs.recorder import FlightRecorder

    t_phase = time.perf_counter()
    cfg = PRESETS["multiregion"]()
    out_dir = "runs/chip_smoke_fleet"
    obs = dataclasses.replace(
        cfg.obs, enabled=True, dump_dir=f"{out_dir}/dumps",
        incident_log_path=f"{out_dir}/incidents.jsonl",
        decision_log_path=f"{out_dir}/decisions.jsonl")
    for p in (obs.incident_log_path, obs.decision_log_path):
        if os.path.exists(p):
            os.remove(p)

    def session(ledgers: bool):
        sinks = {r.name: DryRunSink() for r in cfg.cluster.regions}
        chaos = {r: ChaosSink(s, CHAOS_PRESETS["severe"], seed=i + 3)
                 for i, (r, s) in enumerate(sinks.items())}
        kw = {}
        if ledgers:
            kw = dict(incident_log=IncidentLog(
                obs.incident_log_path, recorder=FlightRecorder(obs)),
                decision_ledger=DecisionLedger(obs, cfg.train, policy="ppo"))
        ctrl = Controller(cfg, loop_backend(cfg, "ppo", dev), loop_source(cfg),
                          chaos, device=dev, interval_s=0.0,
                          reconcile_backoff_s=0.0, seed=LOOP_SEED,
                          log_fn=lambda s: None, **kw)
        reports, cmds = drive_loop(ctrl, 0, LEDGER_TICKS, sinks)
        ctrl.close()
        return ctrl, reports, cmds

    (_off, r_off, c_off), s_off = synced(lambda: session(False))
    (on, r_on, c_on), s_on = synced(lambda: session(True))
    if c_on != c_off or [_fingerprint(r) for r in r_on] != \
            [_fingerprint(r) for r in r_off]:
        fail("14c: the controller with its ledgers on differs from the one "
             "without")
    log_ = on.incident_log
    on.decision_ledger.close()
    log_.close()
    modes = [r.degraded for r in r_on]
    want = {
        "hold_fallback": sum(1 for i, m in enumerate(modes)
                             if m == "fallback"
                             and (i == 0 or modes[i - 1] != "fallback")),
        "reconcile_giveup": sum(rc.giveups_total for rc in
                                {id(x): x for x in
                                 on._reconcilers.values()}.values()),
        "policy_divergence": on.decision_ledger.spikes_total}
    got = {k: log_.counts().get(k, 0) for k in want}
    log(f"# 14c ppo multiregion {LEDGER_TICKS} ticks, severe chaos: ledgers "
        f"off {s_off:.3f} s (the first session: loads included), on "
        f"{s_on:.3f} s; command streams and "
        f"fingerprints bitwise; incidents {got}, trigger counters {want}; "
        f"{on.decision_ledger.rows_total} decision rows")
    if got != want or not sum(got.values()):
        fail(f"14c: incident counts {got} are not the trigger counters "
             f"{want}")

    t_row = on.decision_ledger.rows[-1]["t"]
    tour = f"{out_dir}/tournament_ppo.jsonl"
    for argv in (["incidents", "list", obs.incident_log_path],
                 ["incidents", "show", obs.incident_log_path, "--id", "1"],
                 ["incidents", "timeline", obs.incident_log_path],
                 ["--preset", "multiregion", "decisions", "list",
                  obs.decision_log_path],
                 ["--preset", "multiregion", "decisions", "explain",
                  obs.decision_log_path, "--t", str(t_row)],
                 ["tournament", "list"],
                 ["tournament", "board", tour]):
        _rc, text, _err = run_cli(argv)
        log(f"# 14c cli {' '.join(argv[:3])}: {len(text.splitlines())} "
            f"lines")
    rec = {"incidents": got, "on_s": s_on, "off_s": s_off,
           "seconds": time.perf_counter() - t_phase}
    log(f"# 14c: {rec['seconds']:.1f} s")
    return rec


# ---- the multi-tenant service on the card (phase 15) ------------------------

SVC_NS = (1024, 10240)              # 15a: whole fleet, and in chunks
SVC_CHUNK = 256                     # fleetscale._CHUNK
SVC_CHAIN = 16                      # 15a: chained ticks a key
SVC_SEED = 23
SVC_CPU_N, SVC_CPU_TICKS = 64, 8    # 15b
SVC_OBS_N, SVC_OBS_TICKS = 16, 48   # 15e
# 15b's stressed mix (the fleet-scale parity gate's tenants); the
# flagship's tenants carry no kubectl chaos (its rendered patches may
# differ in a whole second of consolidateAfter across devices).
SVC_MIX = ("healthy", "batch", "jittery", "slow", "flaky", "healthy")
SVC_MIX_PPO = ("healthy", "batch", "jittery", "slow", "healthy", "batch")


def zero_clock():
    """The deterministic clock: scrape delays advance it, nothing else."""
    from ccka_tpu_torch.harness.service import VirtualClock

    return VirtualClock(base=lambda: 0.0)


def service_rows(svc) -> list:
    """Wrap ``svc._dispatch`` to keep each tick's host (packed, per)."""
    rows = []
    inner = svc._dispatch

    def spy(t, lanes):
        out = inner(t, lanes)
        rows.append(out)
        return out
    svc._dispatch = spy
    return rows


def service_phase(dev, card: str) -> dict:
    """15: the multi-tenant service (`harness/service.py`) on the card.
    (a) the lane-selecting service tick, multiregion with the shipped
    flagship, rule, carbon and ppo, horizon 2880: N = 1024 as one graph
    and N = 10240 as one 256-tenant chunk graph replayed per chunk, 16
    chained ticks with lane vectors mixing fresh, held and fallback rows,
    every output of every replay bitwise its eager body, the N = 1024
    chunk graph's rows bitwise the whole-fleet graph's; ms a tick
    (median, p99), graphed and eager; the service's own dispatch (copies
    in, replays, copies out) a tick, the bytes it copies, and the stream
    copied into each graph once; (b) card against CPU, N = 64 x 8 ticks
    on one world, the stressed mix, det clock: report counters, lanes,
    rows within 1e-5 (the flagship's 1e-3, actions 5e-3), rule and carbon
    command streams byte-identical; (c) `overload_scoreboard` at
    bench_overload's grid on the real clock: the healthy ratio exactly
    1.0 in every cell, each cell's p50/p99 against the deadline and its
    counters; (d) `fleet_scale_record` at its defaults: its parity gates;
    (e) obs on against off (recorder, burn rate, decision and tournament
    ledgers), 16 tenants x 48 ticks, ppo: bitwise, every dump verifies;
    `fleet --service ... --obs` and `overload-eval` through `cli.main`.
    `compile_report()`: one capture per key, none again."""
    import dataclasses

    from ccka_tpu_torch import PRESETS
    from ccka_tpu_torch.actuation.sink import DryRunSink
    from ccka_tpu_torch.config import SERVICE_PRESETS
    from ccka_tpu_torch.harness import service as sv
    from ccka_tpu_torch.harness.fleetscale import (_report_counters,
                                                   fleet_scale_record)
    from ccka_tpu_torch.harness.overload import overload_scoreboard
    from ccka_tpu_torch.obs.compile import stats_for
    from ccka_tpu_torch.obs.decisions import decision_row_layout
    from ccka_tpu_torch.obs.recorder import verify_dump
    from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource

    t_phase = time.perf_counter()
    laps = [t_phase]

    def lap() -> str:
        torch.cuda.synchronize()
        laps.append(time.perf_counter())
        return f"({laps[-1] - laps[-2]:.2f} s)"

    sv._compiled_service_tick.cache_clear()
    sv._compiled_service_tick_chunk.cache_clear()
    caps0 = {k: (stats_for(k).compiles if stats_for(k) else 0)
             for k in ("service.tick", "service.tick_chunk")}
    cfg = PRESETS["multiregion"]()
    out_dir = "runs/chip_smoke_service"
    os.makedirs(out_dir, exist_ok=True)
    rec: dict = {"card": card, "chain": {}, "sections": {}}
    cpu_keys = 0

    def service(c, backend, n, source, *, device=dev, **kw):
        return sv.FleetService(
            c, backend, source, [DryRunSink() for _ in range(n)],
            horizon_ticks=T_DAY, seed=SVC_SEED, device=device, **kw)

    # ---- (a) the service graph, whole and chunked
    syn = SyntheticSignalSource(cfg.cluster, cfg.workload, cfg.sim,
                                cfg.signals)
    traces, synth_s = synced(lambda: syn.batch_trace_device(
        T_DAY, torch.Generator(device=dev).manual_seed(SVC_SEED),
        max(SVC_NS), device=dev))
    stream_b = sum(x.numel() * x.element_size() for x in traces)
    log(f"# 15a multiregion N={max(SVC_NS)} x {T_DAY}: batch_trace_device "
        f"{synth_s:.3f} s, the stream {stream_b / 1e9:.3f} GB")
    try:
        service(cfg, loop_backend(cfg, "mpc", dev), 8, FixedTraces(traces))
        fail("15a: the mpc backend was not refused by the service graph")
    except (ValueError, RuntimeError) as e:
        if "MPCBackend" not in str(e):
            raise
        log(f"# 15a mpc refused: {e}")
    backends = {name: loop_backend(cfg, name, dev) for name in
                FLEET_BACKENDS}
    gen = torch.Generator(device=dev).manual_seed(SVC_SEED)
    lane_p = torch.tensor([0.6, 0.25, 0.15], device=dev)
    a_dim = decision_row_layout(cfg.cluster).a_dim
    for name, backend in backends.items():
        whole = service(cfg, backend, SVC_NS[0], FixedTraces(traces),
                        service=SERVICE_PRESETS["default"])
        part = service(cfg, backend, SVC_NS[0], FixedTraces(traces),
                       service=SERVICE_PRESETS["default"],
                       dispatch_chunk=SVC_CHUNK)
        big = service(cfg, backend, SVC_NS[1], FixedTraces(traces),
                       service=SERVICE_PRESETS["default"],
                       dispatch_chunk=SVC_CHUNK)
        for n, svc in ((SVC_NS[0], whole), (SVC_NS[1], big)):
            tick, xs = svc._tick_fn, svc._xs
            k = svc._chunk
            s_g = type(svc.states)(*(x.clone() for x in svc.states))
            ev = [[torch.cuda.Event(enable_timing=True) for _ in range(3)]
                  for _ in range(SVC_CHAIN)]
            counts = [0, 0, 0]
            for t in range(SVC_CHAIN):
                lanes = torch.multinomial(lane_p, n, replacement=True,
                                          generator=gen).to(torch.int32)
                held = torch.rand((n, a_dim), generator=gen, device=dev)
                for j in range(3):
                    counts[j] += int((lanes == j).sum())
                chunks = [(lo, lo + k) for lo in range(0, n, k)]
                args = [((t, lanes, held) if svc._n_chunks == 1 else
                         (t, lo, lanes[lo:hi], held[lo:hi]))
                        for lo, hi in chunks]
                ev[t][0].record()
                eager = [tick.eager(sv._rows(s_g, lo, hi), xs, *a)
                         for (lo, hi), a in zip(chunks, args)]
                ev[t][1].record()
                graph = []
                for (lo, hi), a in zip(chunks, args):
                    g = tick(sv._rows(s_g, lo, hi), xs, *a)
                    graph.append((g[0].clone(),
                                  type(g[1])(*(x.clone() for x in g[1])),
                                  g[2].clone()))
                ev[t][2].record()
                for e, g in zip(eager, graph):
                    if not (torch.equal(e[0], g[0]) and torch.equal(e[2], g[2])
                            and same_states(e[1], g[1])):
                        fail(f"15a: {name} N={n}: a replay differs from its "
                             f"eager body at tick {t}")
                if n == SVC_NS[0]:
                    # The chunk graph over the same inputs: the whole
                    # graph's rows, bitwise.
                    for lo in range(0, n, SVC_CHUNK):
                        hi = lo + SVC_CHUNK
                        c = part._tick_fn(sv._rows(s_g, lo, hi), part._xs, t,
                                          lo, lanes[lo:hi], held[lo:hi])
                        if not (torch.equal(c[0], graph[0][0][lo:hi])
                                and torch.equal(c[2], graph[0][2][lo:hi])
                                and same_states(c[1], sv._rows(
                                    graph[0][1], lo, hi))):
                            fail(f"15a: {name}: the N={n} chunk graph "
                                 f"differs from the whole fleet's at tick "
                                 f"{t}, rows {lo}-{hi}")
                s_g = type(s_g)(*(torch.cat(xs_, 0) for xs_ in
                                  zip(*(g[1] for g in graph))))
            # Tick 0 holds the captures: the times are ticks 1-15's.
            e_ms = [ev[t][0].elapsed_time(ev[t][1])
                    for t in range(1, SVC_CHAIN)]
            g_ms = [ev[t][1].elapsed_time(ev[t][2])
                    for t in range(1, SVC_CHAIN)]
            # The service's own dispatch: lanes and held rows in, every
            # chunk's replay, states and rows out, one synchronize.
            lanes_np = np.zeros(n, np.int32)
            svc._dispatch(0, lanes_np)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for t in range(1, 5):
                svc._dispatch(t, lanes_np)
            disp_ms = (time.perf_counter() - t0) * 1e3 / 4
            w = svc._dec_layout.width
            state_b = sum(x[:1].numel() * x.element_size()
                          for x in svc.states) * n
            moved = (4 * n + 4 * n * a_dim            # lanes, held in
                     + 2 * 2 * state_b                # states in, out
                     + 4 * n * (a_dim + 1 + w))       # packed, per out
            r = {"eager_ms": [float(np.median(e_ms)), pct(e_ms, 99)],
                 "graph_ms": [float(np.median(g_ms)), pct(g_ms, 99)],
                 "dispatch_ms": disp_ms, "chunks": svc._n_chunks,
                 "bytes_a_tick": moved,
                 "stream_copies": tick.stream_copies,
                 "lanes": counts}
            rec["chain"][f"{name} N={n}"] = r
            log(f"# 15a {name} N={n} ({svc._n_chunks} x {k}): {SVC_CHAIN} "
                f"chained ticks, lanes fresh/held/fallback {counts}, every "
                f"replay bitwise its eager body"
                f"{', the chunk graph bitwise the whole' if n == SVC_NS[0] else ''}"
                f"; ms a tick (median, p99): eager {r['eager_ms'][0]:.4f}, "
                f"{r['eager_ms'][1]:.4f}; graph {r['graph_ms'][0]:.4f}, "
                f"{r['graph_ms'][1]:.4f}; the service's dispatch "
                f"{disp_ms:.4f} ms a tick, {moved / 1e6:.3f} MB copied a "
                f"tick against the {n * stream_b / max(SVC_NS) / 1e9:.3f} GB "
                f"stream, copied into its graph {tick.stream_copies} time(s)")
            if tick.stream_copies != 1:
                fail(f"15a: {name} N={n}: the stream was copied "
                     f"{tick.stream_copies} times")
        for s in (whole, part, big):
            s.close()
        del whole, part, big, s_g, eager, graph
        torch.cuda.empty_cache()
    rec["sections"]["a"] = time.perf_counter() - laps[-1]
    log(f"# 15a {lap()}")

    # ---- (b) card against CPU on one world
    rec["cpu"] = {}
    layout = decision_row_layout(cfg.cluster)
    pend = [3] + [layout.col(c) for c in ("pend_c0", "pend_c1",
                                          "shadow_pend_c0", "shadow_pend_c1")]
    small = type(traces)(*(x[:SVC_CPU_N, :T_DAY].contiguous().cpu()
                           for x in traces))
    del traces
    torch.cuda.empty_cache()
    for name in FLEET_BACKENDS:
        flag = name == "ppo"
        mix = SVC_MIX_PPO if flag else SVC_MIX
        profiles = [mix[i % len(mix)] for i in range(SVC_CPU_N)]
        post = dataclasses.replace(SERVICE_PRESETS["default"],
                                   admission_queue_cap=SVC_CPU_N - 8,
                                   breaker_failures=2)
        runs = []
        for d in (dev, torch.device("cpu")):
            b = backends[name] if d.type == "cuda" else \
                loop_backend(cfg, name, d)
            s = service(cfg, b, SVC_CPU_N, FixedTraces(small), device=d,
                        profiles=profiles, service=post, clock=zero_clock())
            cpu_keys += d.type == "cpu"
            rows = service_rows(s)
            s.warmup()
            reps, lanes = [], []
            for t in range(SVC_CPU_TICKS):
                reps.append(s.tick(t))
                lanes.append(s.last_lanes.copy())
            runs.append((reps, lanes, rows, sink_commands(s)))
            s.close()
        (ra, la, qa, ca), (rb, lb, qb, cb) = runs
        ints_equal = all(
            {k: v for k, v in _report_counters(x).items()
             if k not in ("cost_usd_hr", "carbon_g_hr", "pending_pods",
                          "program_dispatches_total")}
            == {k: v for k, v in _report_counters(y).items()
                if k not in ("cost_usd_hr", "carbon_g_hr", "pending_pods",
                             "program_dispatches_total")}
            for x, y in zip(ra, rb))
        lanes_equal = all(np.array_equal(x, y) for x, y in zip(la, lb))
        lim_p = 5e-3 if flag else 1e-5
        lim_q = np.full(layout.width, 1e-3 if flag else 1e-5)
        lim_q[[layout.col("div_max_abs"), layout.col("div_l2")]] = lim_p
        floor_q = np.full(layout.width, 1e-6)
        floor_q[pend] = float(cfg.workload.total_pods)
        worst = 0.0
        for (pa, qa_), (pb, qb_) in zip(qa, qb):
            worst = max(worst, float(np.max(
                np.abs(pa.astype(np.float64) - pb)
                / np.maximum(np.abs(pb), 1e-6) / lim_p)))
            worst = max(worst, float(np.max(
                np.abs(qa_.astype(np.float64) - qb_)
                / np.maximum(np.abs(qb_), floor_q) / lim_q)))
        same = ca == cb
        n_lanes = sorted({int(x) for l_ in la for x in l_})
        rec["cpu"][name] = {"counters_equal": ints_equal,
                            "lanes_equal": lanes_equal,
                            "share_of_standard": worst,
                            "commands_identical": same, "lanes": n_lanes}
        log(f"# 15b {name} card vs CPU N={SVC_CPU_N} x {SVC_CPU_TICKS} "
            f"ticks, mix {mix}: counters equal {ints_equal}, lanes equal "
            f"{lanes_equal} (lanes seen {n_lanes}); the largest row "
            f"difference {worst:.3g} of its standard "
            f"({'1e-3, actions 5e-3' if flag else '1e-5'}); command streams "
            f"identical {same}")
        if not (ints_equal and lanes_equal and worst <= 1.0
                and (flag or same)):
            fail(f"15b: {name}: the card's service and the CPU's disagree")
    rec["sections"]["b"] = time.perf_counter() - laps[-1]
    log(f"# 15b {lap()}")

    # ---- (c) the overload board at bench_overload's grid
    board = overload_scoreboard(cfg, device=dev)
    with open(f"{out_dir}/overload.json", "w") as fh:
        json.dump(board, fh, indent=1)
    rec["overload"] = {"invariants": board["invariants"], "cells": {}}
    for key, cell in board["cells"].items():
        for p, row in cell["rows"].items():
            rec["overload"]["cells"][f"{key}/{p}"] = [
                row["latency_ms"]["p50"], row["latency_ms"]["p99"],
                row["deadline_violations"], row["sheds_total"],
                row["deferrals_total"], row["bulkhead_skips_total"],
                row["breaker_transitions"]["opened"]]
            if row["healthy_usd_ratio_max"] != 1.0 or \
                    row["healthy_usd_ratio_mean"] != 1.0:
                fail(f"15c: {key}/{p}: healthy tenants' ratio "
                     f"{row['healthy_usd_ratio_max']} is not 1.0")
    log(f"# 15c overload board ({card}; deadline "
        f"{SERVICE_PRESETS['default'].tick_deadline_ms} ms): "
        f"{json.dumps(board['invariants'])}; per cell [p50 ms, p99 ms, "
        f"deadline violations, sheds, deferrals, bulkhead skips, breakers "
        f"opened]: {json.dumps(rec['overload']['cells'])}")
    rec["sections"]["c"] = time.perf_counter() - laps[-1]
    log(f"# 15c {lap()}")

    # ---- (d) the fleet-scale record at its defaults
    fsr = fleet_scale_record(PRESETS["default"](), device=dev)
    with open(f"{out_dir}/fleet_scale.json", "w") as fh:
        json.dump(fsr, fh, indent=1)
    inv = fsr["invariants"]
    rec["fleet_scale"] = {
        "invariants": inv, "speedup": fsr["speedup"],
        "cells": {k: [c["latency_ms"]["p50"], c["latency_ms"]["p99"],
                      c["host_loop_us_per_tenant"], c["sheds_total"],
                      c["deadline_violations"]]
                  for k, c in fsr["cells"].items()}}
    log(f"# 15d fleet-scale record ({card}): {json.dumps(inv)}; speedup "
        f"{json.dumps(fsr['speedup'])}; per cell [p50 ms, p99 ms, host "
        f"us/tenant, sheds, deadline violations]: "
        f"{json.dumps(rec['fleet_scale']['cells'])}")
    if not (inv["parity_bitwise"] and inv["chunk_parity_bitwise"]
            and inv["healthy_ratio_exact_all"]):
        fail(f"15d: a fleet-scale gate failed: {inv}")
    rec["sections"]["d"] = time.perf_counter() - laps[-1]
    log(f"# 15d {lap()}")

    # ---- (e) obs on against off, and the command line
    ck = cfg.with_overrides(**{"obs.tournament_roster": FLEET_ROSTER})
    obs_on = dataclasses.replace(
        ck.obs, enabled=True, dump_dir=f"{out_dir}/dumps",
        incident_log_path=f"{out_dir}/incidents.jsonl",
        decision_log_path=f"{out_dir}/decisions.jsonl",
        tournament_log_path=f"{out_dir}/tournament.jsonl")
    for p in (obs_on.incident_log_path, obs_on.decision_log_path,
              obs_on.tournament_log_path):
        if os.path.exists(p):
            os.remove(p)
    syn_k = SyntheticSignalSource(ck.cluster, ck.workload, ck.sim,
                                  ck.signals)
    profiles = [("healthy", "slow", "flaky", "healthy")[i % 4]
                for i in range(SVC_OBS_N)]
    runs = []
    for obs in (None, obs_on):
        s = service(ck, backends["ppo"], SVC_OBS_N, syn_k, obs=obs,
                    profiles=profiles, clock=zero_clock(),
                    service=SERVICE_PRESETS["default"])
        rows = service_rows(s)
        s.warmup()
        s.run(SVC_OBS_TICKS)
        runs.append((rows, [x.cpu() for x in s.states],
                     sink_commands(s), s))
        s.close()
    (qa, sa, ca, _off), (qb, sb, cb, on) = runs
    bit = (all(np.array_equal(x, y) for ra_, rb_ in zip(qa, qb)
               for x, y in zip(ra_, rb_))
           and same_states(sa, sb) and ca == cb)
    if not bit:
        fail("15e: the service with its obs layer on differs from off")
    dumps = [verify_dump(i.dump_path)["t"] == i.t
             for i in on.incidents.incidents]
    if not dumps or not all(dumps):
        fail(f"15e: incident dumps do not verify ({len(dumps)} incidents)")
    rec["obs"] = {"incidents": on.incidents.counts(),
                  "decision_rows": on.decisions.rows_total,
                  "tournament_ticks": on.tournament.ticks_total}
    log(f"# 15e ppo N={SVC_OBS_N} x {SVC_OBS_TICKS}, mix healthy/slow/flaky, "
        f"roster {FLEET_ROSTER}: obs on bitwise off (rows, states, command "
        f"streams); incidents {on.incidents.counts()}, every dump verifies; "
        f"{on.decisions.rows_total} decision rows")
    for argv in (["--preset", "multiregion", "fleet", "--service", "default",
                  "--clusters", "16", "--ticks", "8", "--backend", "ppo",
                  "--profiles", "healthy,slow,flaky", "--obs", "default",
                  "--incidents-out", f"{out_dir}/cli_incidents.jsonl",
                  "--decisions-out", f"{out_dir}/cli_decisions.jsonl"],
                 ["--preset", "multiregion", "overload-eval", "--tenants",
                  "16", "--intensities", "off,severe", "--slow-fracs",
                  "0,0.5", "--policies", "rule,flagship", "--ticks", "8"]):
        _rc, text, _err = run_cli(argv)
        out = json.loads(text[text.index("{"):])
        log(f"# 15e cli {' '.join(argv[2:4])}: exit 0, "
            f"{json.dumps(out.get('invariants', out))}")
    rec["sections"]["e"] = time.perf_counter() - laps[-1]
    log(f"# 15e {lap()}")

    caps, keys = {}, {}
    for name, fn in (("service.tick", sv._compiled_service_tick),
                     ("service.tick_chunk", sv._compiled_service_tick_chunk)):
        st = stats_for(name)
        caps[name] = (st.compiles - caps0[name], st.recompiles)
        keys[name] = fn.cache_info().currsize
    keys["service.tick"] -= cpu_keys
    rec["compile"] = {"captures": caps, "keys": keys}
    log(f"# 15 compile_report: service.tick "
        f"{stats_for('service.tick').to_dict()}; service.tick_chunk "
        f"{stats_for('service.tick_chunk').to_dict()}; captures (this "
        f"phase, recaptures) {caps}, keys built on the card {keys}")
    for name in caps:
        if caps[name] != (keys[name], 0):
            fail(f"15: {name}: {caps[name][0]} captures and {caps[name][1]} "
                 f"recaptures for {keys[name]} keys")
    sv._compiled_service_tick.cache_clear()
    sv._compiled_service_tick_chunk.cache_clear()
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"# 15: {rec['seconds']:.1f} s (a {rec['sections']['a']:.1f}, b "
        f"{rec['sections']['b']:.1f}, c {rec['sections']['c']:.1f}, d "
        f"{rec['sections']['d']:.1f}, e {rec['sections']['e']:.1f})")
    return rec



# ---- geo arbitrage on the card (phase 16) -----------------------------------

GEO_SEED = 131                      # the widened day's stream seed
GEO_SCENARIO = "spot-storm"         # the 16a block's GeoConfig
GEO_KERNELS = ("rule", "carbon", "mlp", "plan")
GEO_ROUTES = ("rule", "carbon", "mlp")   # 16b's CARRY drives
GEO_LANE_B = 8192                   # 16a: faults + workloads + regions
GEO_SVC_N = 4                       # 16d: the service whose gauges read
# 16c at the command line's shape (`geo`'s defaults): every number of the
# card's record but the residuals within this relative standard of the
# CPU's (the float32 sums of the tick loop in another order), fronts and
# dominance equal, the residuals of both within the gate.
GEO_CLI_STEPS, GEO_CLI_BATCH = 192, 8
GEO_CARD_CPU_RTOL = 1e-4
# The JAX bench's conservation gate, in pods, held on the residual that
# counts the queues' float32 rounding (`conservation_residual`); the
# residual without it (JAX's formula, `ledger=False`) is reported beside.
GEO_RESIDUAL_GATE = 0.01


def geo_label(policy: str, faults: bool, wl_depth: int,
              carry: bool = False) -> str:
    from ccka_tpu_torch.kernels import build

    return (("rollout_mlp_kernel" if policy == "mlp"
             else "rollout_profiles_kernel")
            + build.instantiation(policy, faults, wl_depth, carry))


def kernel_counts(clear: bool = False) -> dict:
    """The launch counters of every rollout kernel instantiation, by the
    `kernels` line's names (``clear``: set them to 0 first)."""
    from ccka_tpu_torch.kernels import build

    out: dict = {}
    for counter, prefix in (
            (build.launch_rollout_profiles, "rollout_profiles_kernel"),
            (build.launch_rollout_plan, "rollout_profiles_kernel"),
            (build.launch_rollout_mlp, "rollout_mlp_kernel")):
        if clear:
            counter.launches.clear()
        for k, v in counter.launches.items():
            out[prefix + k] = out.get(prefix + k, 0) + v
    return out


def suite_numbers(rec, path: str = "") -> dict:
    """{path: number} of every number in a suite record."""
    out = {}
    if isinstance(rec, dict):
        for k, v in rec.items():
            out.update(suite_numbers(v, f"{path}.{k}"))
    elif isinstance(rec, list):
        for i, v in enumerate(rec):
            out.update(suite_numbers(v, f"{path}[{i}]"))
    elif isinstance(rec, (int, float)) and not isinstance(rec, bool):
        out[path] = float(rec)
    return out


def geo_phase(dev, card: str, setup, hold, plain, rule_fn,
              carbon_fn) -> dict:
    """16: geo arbitrage (`regions/`) on the card, multiregion (Z = 4 in
    R = 2 regions), the spot-storm GeoConfig.
    (a) a day of B = 32768 synthesized widened by the region block (80
    rows, 30.2 GB), its first 16 rows bitwise the plain stream of the
    same seed; the region block's own synthesis timed; the rule, carbon,
    MLP (shipped flagship) and plan kernels on it, counted (each once),
    timed, and bitwise the same kernels on the plain stream, every field;
    the <FAULTS,WL_D=16> instantiations on the mixed scenario's stream
    widened by the block (104 rows, B = 8192) bitwise on the 40-row one;
    each kernel against its plain version on a widened stream, rule and
    carbon at B = 1024 x T = 360 both modes, the plan stochastic (phase
    4's standard), the MLP per cluster at T = 32 (5a's) and at T = 360
    by NEURAL_MEAN_PARITY_TOLERANCES.
    (b) the widened day in 8 blocks of 360 through the synchronous and
    the double-buffered drive (`sim/streaming.py`), rule, carbon and the
    flagship: CARRY launches counted, each drive bitwise the same drive
    on the plain stream.
    (c) the suite (`regions/pareto.py::run_geo_suite`) at the command
    line's shape, its lanes drawn on the card, card against CPU on the
    same lanes; then on the 16a block (T = 2880 x B = 32768): `none`
    bitwise a zero override, its migration term 0.0, every policy timed
    a rollout, its residual within 0.01 pods with the queues' rounding
    ledger (the raw residual, JAX's formula, reported), dominance
    reported.
    (d) `python -m ccka_tpu_torch --preset multiregion geo --json` in a
    process of its own (started beside 16a's plain versions) equal to
    16c's direct call; a service on the card
    (obs on) reports {} gauges before any publish, then the published
    snapshot and both exporter series."""
    import dataclasses

    from ccka_tpu_torch.config import ObsConfig, ServiceConfig
    from ccka_tpu_torch.harness.promexport import render_exposition
    from ccka_tpu_torch.harness.service import fleet_service_from_config
    from ccka_tpu_torch.policy.rule import RulePolicy
    from ccka_tpu_torch.regions import geo as geo_dyn
    from ccka_tpu_torch.regions.migrate import GEO_POLICIES
    from ccka_tpu_torch.regions.pareto import (GEO_SCENARIOS, fronts,
                                               run_geo_suite, scenario_lanes)
    from ccka_tpu_torch.regions.process import (REGION_KEY_TAG,
                                                packed_region_lanes,
                                                unpack_region_lanes)
    from ccka_tpu_torch.signals.synthetic import (SyntheticSignalSource,
                                                  family_generator)
    from ccka_tpu_torch.sim import lanes
    from ccka_tpu_torch.sim import megakernel as mk
    from ccka_tpu_torch.sim import streaming as stm

    t_phase = time.perf_counter()
    laps = [t_phase]

    def lap() -> str:
        torch.cuda.synchronize()
        laps.append(time.perf_counter())
        return f"({laps[-1] - laps[-2]:.2f} s)"

    rec: dict = {"launches_by_path": {}}
    cfg, _, params, _off, _peak, net = setup("multiregion")
    Z = cfg.cluster.n_zones
    geo = GEO_SCENARIOS[GEO_SCENARIO].geo.bound_to(cfg.cluster)

    def sources(**kw):
        def make(**extra):
            return SyntheticSignalSource(cfg.cluster, cfg.workload, cfg.sim,
                                         cfg.signals, **kw, **extra)
        return make(), make(extra_lanes={"regions": geo})

    # The service's gauges before any publish: the skip values.
    svc = fleet_service_from_config(
        cfg, RulePolicy(cfg.cluster, dev), GEO_SVC_N,
        service=ServiceConfig(enabled=True), obs=ObsConfig(enabled=True),
        horizon_ticks=64, device=dev, log_fn=lambda *a: None)
    if geo_dyn.geo_snapshot() is not None:
        fail("16: a geo snapshot was published before phase 16")
    before = svc.tick(0)
    if before.region_migration_rate or before.region_carbon_intensity:
        fail(f"16d: the service's geo gauges before a publish: "
             f"{before.region_migration_rate}, "
             f"{before.region_carbon_intensity}")

    # ---- 16a: the widened day
    plain_src, wide_src = sources()
    plain_s, plain_sec = synced(lambda: plain_src.packed_trace_device(
        T_DAY, GEO_SEED, B_MAIN, device=dev))
    wide_s, wide_sec = synced(lambda: wide_src.packed_trace_device(
        T_DAY, GEO_SEED, B_MAIN, device=dev))
    rows = plain_s.shape[1]
    lo, hi = lanes.resolve_layout(wide_s.shape[1], Z).block("regions")
    if (rows, wide_s.shape[1], lo, hi) != (16, 80, 16, 80):
        fail(f"16a: stream rows {rows} / {wide_s.shape[1]}, region block "
             f"{lo}:{hi}")
    if not torch.equal(wide_s[:, :rows], plain_s):
        fail("16a: the widened stream's first 16 rows are not the plain "
             "stream of the same seed")
    probe = wide_s[:, lo:hi, :1024].clone()
    block_ms = cuda_ms(lambda: packed_region_lanes(
        geo, family_generator(GEO_SEED, REGION_KEY_TAG, dev), T_DAY, T_DAY,
        Z, B_MAIN, dt_s=cfg.sim.dt_s, out=wide_s[:, lo:hi]), 3)
    if not torch.equal(wide_s[:, lo:hi, :1024], probe):
        fail("16a: the region block synthesized again differs")
    used = wide_s[:T_DAY, lo:lo + 6 * Z]
    if not bool(torch.isfinite(used).all()) or float(used.abs().max()) == 0:
        fail("16a: the region block is not finite, or all zero")
    del probe, used
    rec["synthesis"] = {"plain_s": plain_sec, "widened_s": wide_sec,
                        "region_block_ms": float(np.median(block_ms)),
                        "stream_gb": wide_s.numel() * 4 / 1e9}
    log(f"# 16a widened day B={B_MAIN} T={T_DAY}: {wide_s.shape[1]} rows "
        f"({rec['synthesis']['stream_gb']:.1f} GB), the first {rows} "
        f"bitwise the plain stream; synthesis plain {plain_sec:.3f} s, "
        f"widened {wide_sec:.3f} s, the region block alone "
        f"{rec['synthesis']['region_block_ms']:.2f} ms (median of 3) "
        f"{lap()}")

    plan = random_plan(cfg, B_MAIN, T_DAY, T_DAY, dev)
    kernel_counts(clear=True)
    wide_out = {p: run_entry(p, cfg, params, net, wide_s, T_DAY, True,
                             seed=5, plan=plan) for p in GEO_KERNELS}
    torch.cuda.synchronize()
    counts = kernel_counts()
    want = {geo_label(p, False, 0): 1 for p in GEO_KERNELS}
    if counts != want:
        fail(f"16a: the widened day launched {counts}, not {want}")
    rec["launches_by_path"]["widened geo day (phase 16a)"] = counts
    rec["kernels"] = {}
    for p in GEO_KERNELS:
        got = run_entry(p, cfg, params, net, plain_s, T_DAY, True, seed=5,
                        plan=plan)
        if not bitwise(wide_out[p], got):
            bad = [f for f in got._fields if not torch.equal(
                getattr(got, f), getattr(wide_out[p], f))]
            fail(f"16a: {p} on the widened day differs from the plain "
                 f"stream's in {bad}")
        for f in ("usd_per_slo_hour", "g_co2_per_kreq", "slo_attainment"):
            v = getattr(got, f)
            if v.shape != (B_MAIN,) or not bool(torch.isfinite(v).all()):
                fail(f"16a: {p}.{f} malformed")
        ms_w = median_ms(lambda: run_entry(p, cfg, params, net, wide_s,
                                           T_DAY, True, seed=5, plan=plan))
        ms_p = median_ms(lambda: run_entry(p, cfg, params, net, plain_s,
                                           T_DAY, True, seed=5, plan=plan))
        b_ms, b_by, _terms, _ops = lane_bound(cfg, p, "plain", net)
        rec["kernels"][geo_label(p, False, 0)] = {
            "ms": ms_w, "plain_stream_ms": ms_p, "bound_ms": b_ms,
            "bound_by": b_by}
        log(f"#   {geo_label(p, False, 0)}: bitwise the plain stream's, "
            f"every field; {ms_w:.4f} ms on the widened day, {ms_p:.4f} "
            f"ms on the plain one (median of {N_TIMED}); bound "
            f"{b_ms:.4f} ms ({b_by})")
    step = unpack_region_lanes(wide_s, T_DAY, Z, geo)   # 16c's block
    del wide_out, got, wide_s, plain_s, plan
    torch.cuda.empty_cache()
    log(f"#   the four kernels on the widened day {lap()}")

    # <FAULTS,WL_D=16> on faults + workloads + regions, B = 8192.
    msrc, wl = lane_source(cfg, "mixed")
    p40, p104 = sources(faults=msrc.faults, workloads=wl)
    wparams = lane_params(cfg, wl, dev)
    s40 = p40.packed_trace_device(T_DAY, GEO_SEED, GEO_LANE_B, device=dev)
    s104 = p104.packed_trace_device(T_DAY, GEO_SEED, GEO_LANE_B,
                                    device=dev)
    if (s40.shape[1], s104.shape[1]) != (40, 104) or not torch.equal(
            s104[:, :40], s40):
        fail(f"16a: the {s104.shape[1]}-row stream's first rows are not "
             f"the {s40.shape[1]}-row stream")
    plan = random_plan(cfg, GEO_LANE_B, T_DAY, T_DAY, dev)
    kernel_counts(clear=True)
    out104 = {p: run_entry(p, cfg, wparams, net, s104, T_DAY, True, seed=5,
                           plan=plan) for p in GEO_KERNELS}
    torch.cuda.synchronize()
    counts = kernel_counts()
    want = {geo_label(p, True, 16): 1 for p in GEO_KERNELS}
    if counts != want:
        fail(f"16a: the 104-row stream launched {counts}, not {want}")
    rec["launches_by_path"]["faults + workloads + regions stream, B=8192 "
                            "(phase 16a)"] = counts
    for p in GEO_KERNELS:
        got = run_entry(p, cfg, wparams, net, s40, T_DAY, True, seed=5,
                        plan=plan)
        if not bitwise(out104[p], got):
            fail(f"16a: {geo_label(p, True, 16)} on the 104-row stream "
                 f"differs from the 40-row stream's")
        ms = median_ms(lambda: run_entry(p, cfg, wparams, net, s104, T_DAY,
                                         True, seed=5, plan=plan))
        rec["kernels"][geo_label(p, True, 16)] = {"ms_104_rows_b8192": ms}
        log(f"#   {geo_label(p, True, 16)}: bitwise on 104 rows and on 40, "
            f"B={GEO_LANE_B}; {ms:.4f} ms on 104 rows")
    del out104, got, s40, s104, plan
    torch.cuda.empty_cache()
    log(f"#   the lane instantiations on the 104-row stream {lap()}")

    # 16d's `geo --json` runs in a process of its own beside the plain
    # versions (host-bound, like its start-up); it is read in 16d.
    shell = start_side_process(["-m", "ccka_tpu_torch", "--preset",
                                "multiregion", "geo", "--json"])

    # Each kernel against its plain version on a widened stream.
    short = wide_src.packed_trace_device(T_PARITY, GEO_SEED + 1, B_MULTI,
                                         device=dev)
    views = mk.unpack_exo(short, T_PARITY, Z)
    rec["parity"] = {}
    for p, fn in (("rule", rule_fn(cfg)), ("carbon", carbon_fn(cfg))):
        for st in (False, True):
            k = run_entry(p, cfg, params, net, short, T_PARITY, st)
            pv, p_s = synced(lambda: plain(cfg, params, views, LANE_SEED,
                                           st, fn))
            same, max_abs = hold(
                f"16a {p} widened B={B_MULTI} T={T_PARITY} "
                f"{'stochastic' if st else 'deterministic'}", k, pv, st)
            rec["parity"][f"{p} {'stochastic' if st else 'deterministic'}"] \
                = {"bitwise": same, "max_abs_err": max_abs,
                   "plain_ms": p_s * 1e3}
    plan = random_plan(cfg, B_MULTI, T_PARITY, T_PARITY, dev)
    k = run_entry("plan", cfg, params, net, short, T_PARITY, True, plan=plan)
    pv, p_s = synced(lambda: lane_plain("plan", cfg, params, net, short,
                                        T_PARITY, True, plan=plan))
    same, max_abs = hold(f"16a plan widened B={B_MULTI} T={T_PARITY} "
                         f"stochastic", k, pv, True)
    rec["parity"]["plan stochastic"] = {"bitwise": same,
                                        "max_abs_err": max_abs,
                                        "plain_ms": p_s * 1e3}
    mshort = wide_src.packed_trace_device(T_SHORT, GEO_SEED + 2, B_MULTI,
                                          device=dev)
    k = run_entry("mlp", cfg, params, net, mshort, T_SHORT, False)
    pv = lane_plain("mlp", cfg, params, net, mshort, T_SHORT, False)
    rel = field_rel(k, pv)
    bad = {f: r for f, r in rel.items()
           if r > (SHORT_LOOSE_TOL if f in SHORT_LOOSE else SHORT_TOL)}
    worst = max(rel, key=rel.get)
    log(f"# parity 16a mlp widened B={B_MULTI} T={T_SHORT} deterministic: "
        f"bitwise {bitwise(k, pv)}; largest per-cluster rel diff {worst} "
        f"{rel[worst]:.3g}")
    if bad:
        fail(f"16a: mlp parity on the widened stream: {bad}")
    k = run_entry("mlp", cfg, params, net, short, T_PARITY, False)
    pv, p_s = synced(lambda: lane_plain("mlp", cfg, params, net, short,
                                        T_PARITY, False))
    viol = mk.mean_parity_violations(k, pv, mk.NEURAL_MEAN_PARITY_TOLERANCES)
    log(f"# parity 16a mlp widened B={B_MULTI} T={T_PARITY} deterministic: "
        f"bitwise {bitwise(k, pv)}; mean_parity_violations {viol}")
    if viol:
        fail("16a: mlp mean parity on the widened stream")
    rec["parity"]["mlp deterministic"] = {
        "bitwise": bitwise(k, pv), "plain_ms": p_s * 1e3,
        "max_abs_err": float(max((getattr(k, f).double()
                                  - getattr(pv, f).double()).abs().max()
                                 for f in k._fields))}
    del short, views, mshort, k, pv, plan
    torch.cuda.empty_cache()
    rec["seconds_a"] = time.perf_counter() - t_phase
    log(f"#   plain versions on the widened stream {lap()}")

    # ---- 16b: the widened day streamed in 8 blocks
    t_b = time.perf_counter()
    rec["streamed"] = {}
    carry_counts: dict = {}
    for route in GEO_ROUTES:
        for pipelined in (False, True):
            kw = dict(key=GEO_SEED, batch=B_MAIN, T=T_DAY, block_T=BLOCK_DAY,
                      seed=STREAM_SEED, t_chunk=T_CHUNK_STREAM,
                      stochastic=True, pipelined=pipelined,
                      net_params=net if route == "mlp" else None, device=dev)
            kernel_counts(clear=True)
            (ws, wrep), w_s = synced(lambda: stm.streaming_rollout_summary(
                wide_src, params, cfg.cluster, BLOCK_MODE[route], **kw))
            for label, n in kernel_counts().items():
                carry_counts[label] = carry_counts.get(label, 0) + n
            (ps, _), p_s = synced(lambda: stm.streaming_rollout_summary(
                plain_src, params, cfg.cluster, BLOCK_MODE[route], **kw))
            drive = "double-buffered" if pipelined else "sync"
            if not bitwise(ws, ps):
                fail(f"16b: {route} {drive} drive on the widened day is not "
                     f"bitwise the plain stream's")
            rec["streamed"][f"{route} {drive}"] = {
                "widened_s": w_s, "plain_s": p_s,
                "stream_buffers": wrep.get("stream_buffers")}
            log(f"# 16b {route} {drive}: bitwise the plain stream's drive; "
                f"wall {w_s:.4f} s widened, {p_s:.4f} s plain")
    want = {geo_label(r, False, 0, carry=True): 2 * (T_DAY // BLOCK_DAY)
            for r in GEO_ROUTES}
    if carry_counts != want:
        fail(f"16b: the widened drives launched {carry_counts}, not {want}")
    rec["launches_by_path"]["streamed widened geo day, sync and "
                            "double-buffered (phase 16b)"] = carry_counts
    rec["seconds_b"] = time.perf_counter() - t_b
    torch.cuda.empty_cache()
    log(f"#   16b {rec['seconds_b']:.1f} s {lap()}")

    # ---- 16c: the suite on the card
    t_c = time.perf_counter()
    suite_kw = dict(scenarios=sorted(GEO_SCENARIOS),
                    policies=sorted(GEO_POLICIES),
                    zone_region_index=cfg.cluster.zone_region_index, seed=0,
                    steps=GEO_CLI_STEPS, batch=GEO_CLI_BATCH,
                    dt_s=cfg.sim.dt_s)
    # The card's suite draws its lanes on the card (as `geo` does); the
    # CPU scores the same lanes, drawn again on the card and copied over.
    card_suite, card_s = synced(lambda: run_geo_suite(device=dev,
                                                      **suite_kw))
    drawn = scenario_lanes(device=dev, **{
        k: v for k, v in suite_kw.items() if k != "policies"})
    cpu_suite, cpu_s = synced(lambda: run_geo_suite(
        device="cpu", lanes={k: v.cpu() for k, v in drawn.items()},
        **suite_kw))
    del drawn
    a, b = suite_numbers(card_suite), suite_numbers(cpu_suite)
    if set(a) != set(b):
        fail(f"16c: the card's suite record has other keys: "
             f"{sorted(set(a) ^ set(b))[:8]}")
    # The residuals are float32 rounding noise themselves: each is held
    # to the gate, not to the other device's.
    rel = {k: abs(a[k] - b[k]) / max(abs(b[k]), 1e-6) for k in a
           if "conservation_residual" not in k}
    worst = max(rel, key=rel.get)
    if rel[worst] > GEO_CARD_CPU_RTOL:
        fail(f"16c: the suite on the card against the CPU: {worst} "
             f"{a[worst]} vs {b[worst]} (rel {rel[worst]:.3g})")
    for sc_a, sc_b in zip(card_suite["scenarios"], cpu_suite["scenarios"]):
        for klass, fr in sc_a["pareto"].items():
            other = sc_b["pareto"][klass]
            if (fr["front"], fr["dominates_none"]) != (
                    other["front"], other["dominates_none"]):
                fail(f"16c: {sc_a['scenario']}/{klass}: front or dominance "
                     f"differs card against CPU")
    for suite in (card_suite, cpu_suite):
        if suite["max_conservation_residual"] > GEO_RESIDUAL_GATE:
            fail(f"16c: the suite's residual on {suite['device']}: "
                 f"{suite['max_conservation_residual']} pods")
    rec["suite_cli_shape"] = {
        "card_s": card_s, "cpu_s": cpu_s, "worst_rel": rel[worst],
        "worst_field": worst,
        "max_conservation_residual": card_suite["max_conservation_residual"],
        "max_conservation_residual_raw":
            card_suite["max_conservation_residual_raw"],
        "dominance_found": card_suite["dominance_found"]}
    log(f"# 16c suite, {len(suite_kw['scenarios'])} scenarios x "
        f"{len(suite_kw['policies'])} policies, steps {GEO_CLI_STEPS} x "
        f"batch {GEO_CLI_BATCH}: card {card_s:.3f} s, CPU {cpu_s:.3f} s; "
        f"largest rel diff {rel[worst]:.3g} ({worst}); fronts and dominance "
        f"equal; residual {card_suite['max_conservation_residual']:.3g} "
        f"pods ({card_suite['max_conservation_residual_raw']:.3g} without "
        f"the rounding ledger); dominance_found {card_suite['dominance_found']} {lap()}")

    R = geo.n_regions
    summaries, residuals, raw, roll_s = {}, {}, {}, {}
    for pname, pol in sorted(GEO_POLICIES.items()):
        torch.cuda.reset_peak_memory_stats()
        roll, roll_s[pname] = synced(lambda: geo_dyn.geo_rollout(
            geo, pol, step))
        summaries[pname] = geo_dyn.rollout_summary(geo, roll)
        residuals[pname] = geo_dyn.conservation_residual(step, roll)
        raw[pname] = geo_dyn.conservation_residual(step, roll, ledger=False)
        if pname != "none":
            snap = geo_dyn.publish_geo_snapshot(geo, step, roll)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if pname == "none":
            zero = geo_dyn.geo_rollout(
                geo, GEO_POLICIES["balanced"], step,
                rates_override=torch.zeros((R, R, 3), device=dev))
            if not bitwise(roll, zero):
                fail("16c: `none` is not bitwise the zero-rate override on "
                     "the day")
            if float(roll.migration_cost_usd.abs().max()) != 0.0:
                fail("16c: `none`'s migration term is not exactly 0.0")
            del zero
        del roll
        torch.cuda.empty_cache()
        log(f"#   16c {pname} on the day (T={T_DAY} x B={B_MAIN}): "
            f"{roll_s[pname]:.3f} s a rollout ({T_DAY} eager ticks), "
            f"residual {residuals[pname]:.3g} pods "
            f"({raw[pname]:.3g} without the rounding ledger), total $ "
            f"{summaries[pname]['total_cost_usd']:.4f}, kg "
            f"{summaries[pname]['carbon_kg']:.4f}, peak {peak_gb:.2f} GB")
        if residuals[pname] > GEO_RESIDUAL_GATE:
            fail(f"16c: {pname}'s residual {residuals[pname]} pods on the "
                 f"day")
    day_fronts = fronts(summaries)
    rec["suite_day"] = {
        "rollout_s": roll_s, "residuals": residuals, "residuals_raw": raw,
        "dominance_found": any(f["dominates_none"]
                               for f in day_fronts.values()),
        "dominates_none": {k: f["dominates_none"]
                           for k, f in day_fronts.items()}}
    rec["seconds_c"] = time.perf_counter() - t_c
    log(f"# 16c the day's policies dominating none: "
        f"{json.dumps(rec['suite_day']['dominates_none'])}; dominance_found "
        f"{rec['suite_day']['dominance_found']} (reported, not gated); "
        f"`none` bitwise the zero override {lap()}")
    del step

    # ---- 16d: the shell, and the service's gauges after the publish
    t_d = time.perf_counter()
    shell_out = join_side_process(shell, "16d: `geo --json`", 600)
    shell_s = shell["s"]
    if json.loads(shell_out) != json.loads(json.dumps(card_suite)):
        fail("16d: `geo --json` from the shell is not the direct call's "
             "record")
    after = svc.tick(1)
    if (after.region_migration_rate != snap["migration_rate"]
            or after.region_carbon_intensity != snap["carbon_intensity"]):
        fail(f"16d: the service's gauges after the publish: "
             f"{after.region_migration_rate}, "
             f"{after.region_carbon_intensity} against {snap}")
    text = render_exposition(dataclasses.asdict(after))
    for series in ("ccka_region_migration_rate",
                   "ccka_region_carbon_intensity"):
        if f"\n{series} " not in text:
            fail(f"16d: the exporter emits no {series}")
    svc.close()
    rec["shell_s"] = shell_s
    rec["seconds_d"] = time.perf_counter() - t_d
    log(f"# 16d `geo --json` from the shell ({shell_s:.2f} s, beside 16a's "
        f"plain versions) equals the direct call; the service's gauges "
        f"read the published snapshot "
        f"({after.region_migration_rate}, "
        f"{after.region_carbon_intensity}) and the exporter emits both "
        f"series {lap()}")
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"# phase 16: {rec['seconds']:.1f} s (16a {rec['seconds_a']:.1f}, "
        f"16b {rec['seconds_b']:.1f}, 16c {rec['seconds_c']:.1f}, 16d "
        f"{rec['seconds_d']:.1f}); card {card}")
    return rec


# ---- the scenario axis and the adversarial search (phase 17) ---------------

SEARCH_SEED = 151                   # the stream seed of every search stream
SEARCH_POP, SEARCH_INNER = 12, 2048  # 17a-17c: the population at fleet width
SEARCH_ITERS = 5
SEARCH_CELL = 5                     # 17a: the cell held against its source
SEARCH_S1_B = 8192                  # 17a, 17e: the S = 1 streams
SEARCH_PARITY_S, SEARCH_PARITY_INNER = 4, 256   # 17b: the plain versions
SEARCH_LOOP_CELLS = 3               # 17c: cells scored one source at a time
SEARCH_DAY_S = 4                    # 17e: the blocked axis day, S x 2048
SEARCH_DIR = os.path.join("runs", "chip_smoke_search")
SEARCH_POLICIES = ("rule", "carbon")


def search_cells(n: int, seed: int):
    """``n`` cells uniform in the middle of the search box (every
    searchable mechanism live)."""
    from ccka_tpu_torch.search.params import (PARAM_NAMES, SEARCH_BOUNDS,
                                              ScenarioParams)

    rng = np.random.default_rng(seed)
    lo = np.asarray([SEARCH_BOUNDS[k][0] for k in PARAM_NAMES])
    hi = np.asarray([SEARCH_BOUNDS[k][1] for k in PARAM_NAMES])
    nat = lo + (0.2 + 0.6 * rng.uniform(size=(n, len(PARAM_NAMES)))) * (
        hi - lo)
    return ScenarioParams.from_array(nat).clip_to_bounds()


def search_phase(dev, card: str, hold) -> dict:
    """17: the scenario axis and the adversarial search
    (`ccka_tpu_torch/search/`) on the card, default preset (Z = 3, one
    region), every stream 104 rows (exo, faults, workloads, regions).
    (a) an S = 1 axis stream at B = 8192 x T = 2880 bitwise the baked
    source's of the same cell and seed; cell 5 of the 12 x 2048
    population stream (29.4 GB) bitwise its baked source's at B = 2048.
    (b) the rule and carbon <FAULTS,WL_D=16> kernels on the population
    stream, counted and timed against their bounds; each held against its
    plain version at S = 4 x inner 256 x T = 360, both modes (phase 4's
    standard).
    (c) `search_scenarios` (rule, 5 iterations of 12 at inner 2048 x
    T = 2880, stochastic) with the counters zeroed just before and read
    just after (10 launches: 5 populations, the S = 1 re-score, the four
    hand-named cells): each iteration's synthesis, kernel and host
    seconds, the peak bytes, the minted value and dominance;
    `replay_minted` exactly the minted value; reported, not gated, 12
    cells in one stream and launch against 3 cells through baked sources
    one at a time.
    (d) `python -m ccka_tpu_torch scenario-search --iters 2 --pop 4
    --mint-out` in a process of its own (started beside (b)'s plain
    versions), its document read back, `scenarios --minted-dir` listing
    it, a tampered copy refused naming the digest.
    (e) a blocked axis day (8 blocks of 360, S = 4 x inner 2048) through
    the double-buffered streaming drive on the rule CARRY kernel, bitwise
    the unblocked reference; S = 1 blocks bitwise the baked blocks."""
    from ccka_tpu_torch import PRESETS
    from ccka_tpu_torch import cli
    from ccka_tpu_torch.search.adversarial import (ScenarioScorer,
                                                   replay_minted,
                                                   search_scenarios)
    from ccka_tpu_torch.search.axis import ScenarioAxisSource
    from ccka_tpu_torch.search.params import ScenarioParams
    from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource
    from ccka_tpu_torch.sim import megakernel as mk
    from ccka_tpu_torch.sim import streaming as stm

    t_phase = time.perf_counter()
    laps = [t_phase]

    def lap() -> str:
        torch.cuda.synchronize()
        laps.append(time.perf_counter())
        return f"({laps[-1] - laps[-2]:.2f} s)"

    rec: dict = {"launches_by_path": {}, "kernels": {}}
    cfg = PRESETS["default"]()
    cells = search_cells(SEARCH_POP, SEARCH_SEED)
    scorer = ScenarioScorer(cfg, policy="rule", inner_batch=SEARCH_INNER,
                            seed=SEARCH_SEED, device=dev)
    params = scorer.sim_params
    sections = dict(base_faults=scorer.base_faults,
                    base_workloads=scorer.base_workloads,
                    base_geo=scorer.base_geo)

    def baked(s: int, src_cells=cells):
        fa, wl, geo = src_cells.to_config(s, **sections)
        return SyntheticSignalSource(cfg.cluster, cfg.workload, cfg.sim,
                                     cfg.signals, faults=fa, workloads=wl,
                                     extra_lanes={"regions": geo})

    def axis(src_cells):
        return ScenarioAxisSource(
            cfg.cluster, cfg.workload, cfg.sim, cfg.signals, src_cells,
            faults=sections["base_faults"],
            workloads=sections["base_workloads"],
            geo=sections["base_geo"])

    # ---- 17a: S = 1 and one cell of the population, bitwise
    one, one_s = synced(lambda: axis(cells.row(0)).packed_trace_device(
        T_DAY, SEARCH_SEED, SEARCH_S1_B, device=dev))
    ref, ref_s = synced(lambda: baked(0).packed_trace_device(
        T_DAY, SEARCH_SEED, SEARCH_S1_B, device=dev))
    if one.shape[1] != 104 or not torch.equal(one, ref):
        fail(f"17a: the S = 1 axis stream ({one.shape[1]} rows) is not "
             f"bitwise the baked stream at B={SEARCH_S1_B}")
    del one, ref
    scorer.source.set_params(cells)
    torch.cuda.reset_peak_memory_stats()
    pop, pop_s = synced(lambda: scorer.source.packed_trace_device(
        T_DAY, SEARCH_SEED, SEARCH_POP * SEARCH_INNER, device=dev))
    pop_peak = torch.cuda.max_memory_allocated()
    cell = baked(SEARCH_CELL).packed_trace_device(T_DAY, SEARCH_SEED,
                                                  SEARCH_INNER, device=dev)
    lo = SEARCH_CELL * SEARCH_INNER
    if not torch.equal(pop[:, :, lo:lo + SEARCH_INNER], cell):
        fail(f"17a: cell {SEARCH_CELL} of the population stream is not "
             f"bitwise its baked source's stream")
    del cell
    rec["synthesis"] = {"s1_axis_s": one_s, "s1_baked_s": ref_s,
                        "population_s": pop_s,
                        "population_gb": pop.numel() * 4 / 1e9,
                        "population_peak_gb": pop_peak / 1e9}
    log(f"# 17a default (Z=3, one region), 104 rows: S=1 B={SEARCH_S1_B} "
        f"T={T_DAY} bitwise the baked stream (axis {one_s:.3f} s, baked "
        f"{ref_s:.3f} s); population {SEARCH_POP} x {SEARCH_INNER} "
        f"({pop.numel() * 4 / 1e9:.1f} GB, peak {pop_peak / 1e9:.1f} GB) "
        f"in {pop_s:.3f} s, cell {SEARCH_CELL} bitwise its baked source "
        f"{lap()}")

    # ---- 17b: the kernels on the population stream
    B_pop = SEARCH_POP * SEARCH_INNER
    kernel_counts(clear=True)
    outs = {p: mk.packed_mode_summary(params, cfg.cluster, p, pop, T_DAY,
                                      SEARCH_SEED) for p in SEARCH_POLICIES}
    torch.cuda.synchronize()
    counts = kernel_counts()
    labels = {p: geo_label(p, True, 16) for p in SEARCH_POLICIES}
    if counts != {labels[p]: 1 for p in SEARCH_POLICIES}:
        fail(f"17b: the population stream launched {counts}")
    rec["launches_by_path"]["scenario population stream, 12 x 2048 "
                            "(phase 17b)"] = counts
    for p in SEARCH_POLICIES:
        for f in ("usd_per_slo_hour", "slo_attainment", "inf_queue_mean"):
            v = getattr(outs[p], f)
            if v.shape != (B_pop,) or not bool(torch.isfinite(v).all()):
                fail(f"17b: {p}.{f} malformed on the population stream")
        ms = median_ms(lambda: mk.packed_mode_summary(
            params, cfg.cluster, p, pop, T_DAY, SEARCH_SEED))
        b_ms, b_by, _terms, _ops = lane_bound(cfg, p, "mixed", B=B_pop)
        rec["kernels"][labels[p]] = {"ms": ms, "bound_ms": b_ms,
                                     "bound_by": b_by}
        log(f"#   {labels[p]} on the population stream (B={B_pop} "
            f"T={T_DAY}): {ms:.4f} ms (median of {N_TIMED}), bound "
            f"{b_ms:.4f} ms ({b_by})")
    del outs, pop
    torch.cuda.empty_cache()

    # 17d's shell runs beside the plain versions (host-bound).
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           SEARCH_DIR)
    os.makedirs(out_dir, exist_ok=True)
    mint_path = os.path.join(out_dir, "mint.json")
    shell = start_side_process(["-m", "ccka_tpu_torch", "scenario-search",
                                "--iters", "2", "--pop", "4",
                                "--mint-out", mint_path])

    short = axis(ScenarioParams.from_array(
        cells.to_array()[:SEARCH_PARITY_S]))
    stream = short.packed_trace_device(
        T_PARITY, SEARCH_SEED + 1, SEARCH_PARITY_S * SEARCH_PARITY_INNER,
        device=dev)
    for p in SEARCH_POLICIES:
        for st in (False, True):
            mode = "stochastic" if st else "deterministic"
            k = mk.packed_mode_summary(params, cfg.cluster, p, stream,
                                       T_PARITY, SEARCH_SEED, stochastic=st)
            pv, p_s = synced(lambda: lane_plain(
                p, cfg, params, None, stream, T_PARITY, st,
                seed=SEARCH_SEED))
            same, max_abs = hold(
                f"17b {p} scenario axis S={SEARCH_PARITY_S} x inner "
                f"{SEARCH_PARITY_INNER} T={T_PARITY} {mode}", k, pv, st)
            rec["kernels"][labels[p]][f"parity {mode}"] = {
                "bitwise": same, "max_abs_err": max_abs,
                "plain_ms": p_s * 1e3,
                "shape": f"S={SEARCH_PARITY_S} x inner "
                         f"{SEARCH_PARITY_INNER} T={T_PARITY}"}
    del stream, k, pv
    log(f"#   plain versions on the axis stream {lap()}")

    # ---- 17c: the search at fleet width
    kernel_counts(clear=True)
    torch.cuda.reset_peak_memory_stats()
    res, search_s = synced(lambda: search_scenarios(
        cfg, policy="rule", iters=SEARCH_ITERS, pop=SEARCH_POP,
        seed=SEARCH_SEED, scorer=scorer))
    peak = torch.cuda.max_memory_allocated()
    counts = kernel_counts()
    want = {labels["rule"]: SEARCH_ITERS + 1 + 4}
    if counts != want:
        fail(f"17c: the search launched {counts}, not {want}")
    rec["launches_by_path"]["adversarial search, 5 x 12 at 2048 and 5 "
                            "S = 1 scores (phase 17c)"] = counts
    stages = scorer.stages[-(SEARCH_ITERS + 5):]
    iters = stages[:SEARCH_ITERS]
    if any(s["S"] != SEARCH_POP for s in iters) or any(
            s["S"] != 1 for s in stages[SEARCH_ITERS:]):
        fail(f"17c: the search's scores ran S = {[s['S'] for s in stages]}")
    synth = sum(s["synthesis_s"] for s in stages)
    kern = sum(s["kernel_s"] for s in stages)
    doc = json.loads(json.dumps(res.to_doc()))
    replay, replay_s = synced(lambda: replay_minted(cfg, doc, device=dev))
    if replay[res.objective] != res.best_value or replay != res.best_cells:
        fail(f"17c: replay_minted gave {replay[res.objective]!r}, the mint "
             f"recorded {res.best_value!r}")
    if doc["eval"]["backend"] != "cuda" or not math.isfinite(res.best_value):
        fail(f"17c: the minted document's eval {doc['eval']}")
    rec["search"] = {
        "seconds": search_s, "peak_gb": peak / 1e9,
        "iteration_synthesis_s": [s["synthesis_s"] for s in iters],
        "iteration_kernel_s": [s["kernel_s"] for s in iters],
        "iteration_host_s": [s["host_s"] for s in iters],
        "s1_scores_s": [s["synthesis_s"] + s["kernel_s"] + s["host_s"]
                        for s in stages[SEARCH_ITERS:]],
        "host_rest_s": search_s - synth - kern,
        "best_value": res.best_value, "dominates": res.dominates,
        "hand_named": res.hand_named, "history": res.history,
        "digest": res.scenario.params_digest, "replay_s": replay_s}
    log(f"# 17c search rule {SEARCH_ITERS} x {SEARCH_POP} at inner "
        f"{SEARCH_INNER} x T={T_DAY}: {search_s:.3f} s, peak "
        f"{peak / 1e9:.2f} GB; an iteration: synthesis "
        f"{np.median(rec['search']['iteration_synthesis_s']):.4f} s, "
        f"kernel {np.median(rec['search']['iteration_kernel_s']):.4f} s, "
        f"host {np.median(rec['search']['iteration_host_s']):.4f} s "
        f"(medians); the S=1 scores "
        f"{sum(rec['search']['s1_scores_s']):.3f} s; the rest on the host "
        f"{rec['search']['host_rest_s']:.3f} s; minted "
        f"{res.scenario.name} usd_per_slo_hour={res.best_value!r}, "
        f"dominates {res.dominates} ({json.dumps(res.hand_named)}); "
        f"replay_minted equal ({replay_s:.3f} s) {lap()}")

    # 12 cells in one stream and launch, against 3 through baked sources.
    scorer.release()
    one_go = []
    for _ in range(3):
        _, s_ = synced(lambda: scorer.score(cells))
        one_go.append(s_)
    scorer.release()
    loop_s = 0.0
    for s in range(SEARCH_LOOP_CELLS):
        def loop_cell(s=s):
            src = baked(s)
            stream = src.packed_trace_device(T_DAY, SEARCH_SEED,
                                             SEARCH_INNER, device=dev)
            return mk.packed_mode_summary(params, cfg.cluster, "rule",
                                          stream, T_DAY, SEARCH_SEED)
        _, s_ = synced(loop_cell)
        loop_s += s_
    traced_cps = SEARCH_POP / float(np.median(one_go))
    loop_cps = SEARCH_LOOP_CELLS / loop_s
    rec["traced_vs_loop"] = {"traced_s": float(np.median(one_go)),
                             "loop_s": loop_s, "ratio": traced_cps
                             / loop_cps}
    log(f"#   {SEARCH_POP} cells in one stream and launch "
        f"{np.median(one_go):.3f} s (median of 3) against "
        f"{SEARCH_LOOP_CELLS} through baked sources one at a time "
        f"{loop_s:.3f} s: x{traced_cps / loop_cps:.2f} cells/s (reported, "
        f"not gated) {lap()}")
    scorer.release()
    torch.cuda.empty_cache()

    # ---- 17e: the blocked axis day through the streaming drive
    src4 = axis(ScenarioParams.from_array(
        cells.to_array()[:SEARCH_DAY_S]))
    kw = dict(key=SEARCH_SEED, batch=SEARCH_DAY_S * SEARCH_INNER, T=T_DAY,
              block_T=BLOCK_DAY, seed=STREAM_SEED, t_chunk=T_CHUNK_STREAM,
              stochastic=True, device=dev)
    kernel_counts(clear=True)
    (day, drep), day_s = synced(lambda: stm.streaming_rollout_summary(
        src4, params, cfg.cluster, "rule", pipelined=True, **kw))
    counts = kernel_counts()
    carry = geo_label("rule", True, 16, carry=True)
    if counts != {carry: T_DAY // BLOCK_DAY}:
        fail(f"17e: the blocked axis day launched {counts}")
    rec["launches_by_path"]["blocked scenario-axis day, 4 x 2048 "
                            "(phase 17e)"] = counts
    ref = stm.unblocked_reference_summary(src4, params, cfg.cluster, "rule",
                                          **kw)
    if not bitwise(day, ref):
        fail("17e: the streamed axis day is not bitwise the unblocked "
             "reference")
    one_b, ref_b = axis(cells.row(0)), baked(0)
    for j in (0, T_DAY // BLOCK_DAY - 1):
        a = one_b.packed_block_trace_device(
            BLOCK_DAY, SEARCH_SEED, SEARCH_S1_B, j,
            t_chunk=T_CHUNK_STREAM, device=dev)
        b = ref_b.packed_block_trace_device(
            BLOCK_DAY, SEARCH_SEED, SEARCH_S1_B, j,
            t_chunk=T_CHUNK_STREAM, device=dev)
        if not torch.equal(a, b):
            fail(f"17e: S = 1 block {j} is not bitwise the baked block")
    del a, b, day, ref
    rec["streamed_day_s"] = day_s
    rec["stream_buffers"] = drep.get("stream_buffers")
    log(f"# 17e blocked axis day ({T_DAY // BLOCK_DAY} x {BLOCK_DAY}, "
        f"{SEARCH_DAY_S} x {SEARCH_INNER}) double-buffered: {day_s:.3f} s, "
        f"{T_DAY // BLOCK_DAY} {carry} launches, bitwise the unblocked "
        f"reference; S=1 blocks 0 and {T_DAY // BLOCK_DAY - 1} at "
        f"B={SEARCH_S1_B} bitwise the baked blocks {lap()}")

    # ---- 17d: the shell
    shell_out = join_side_process(shell, "17d: `scenario-search`", 600)
    sdoc = json.loads(shell_out)
    with open(mint_path, encoding="utf-8") as fh:
        if json.load(fh) != sdoc:
            fail("17d: the --mint-out file is not the printed document")
    if (sdoc["eval"]["backend"], sdoc["eval"]["steps"],
            sdoc["eval"]["inner_batch"]) != ("cuda", T_DAY, 64):
        fail(f"17d: the shell's search ran {sdoc['eval']}")
    listing = cli_json(["scenarios", "--minted-dir", mint_path])
    last = listing["scenarios"][-1]
    if (last["name"], (last["minted"] or {}).get("params_digest")) != (
            sdoc["scenario"]["name"], sdoc["scenario"]["params_digest"]):
        fail(f"17d: `scenarios --minted-dir` lists {last}")
    vals = json.loads(sdoc["scenario"]["params_json"])
    vals["inf_rate"] = [vals["inf_rate"][0] + 1.0]
    sdoc["scenario"]["params_json"] = json.dumps(vals, sort_keys=True,
                                                 separators=(",", ":"))
    bad = os.path.join(out_dir, "tampered")
    os.makedirs(bad, exist_ok=True)
    with open(os.path.join(bad, "mint.json"), "w", encoding="utf-8") as fh:
        json.dump(sdoc, fh)
    try:
        run_cli(["scenarios", "--minted-dir", bad])
        fail("17d: a tampered minted document was listed")
    except SystemExit as e:
        if "tampered" not in str(e):
            raise
    rec["shell_s"] = shell["s"]
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"# 17d `scenario-search --iters 2 --pop 4` from the shell "
        f"({shell['s']:.2f} s, beside 17b's plain versions): minted "
        f"{sdoc['scenario']['name']}, listed by `scenarios --minted-dir`; "
        f"a tampered copy refused {lap()}")
    log(f"# phase 17: {rec['seconds']:.1f} s; card {card}")
    return rec


# ---- the continual-learning flywheel (phase 18)

# bench.py::bench_flywheel's geometry (the JAX package's recorded
# flywheel run): the default preset, its shipped network widths.
FLY = dict(steps=40, block_T=40, t_chunk=40, pairs_base=3, pairs_max=6,
           iterations=150, seed=23)
FLY_RUNNER = dict(n_tenants=6, record_ticks=16, shadow_ticks=16,
                  watch_ticks=10, top_k=3, seed=211)
FLY_DIR = "runs/chip_smoke_flywheel"
# The MLP's per-cluster standard on a lane stream (phases 5c and 14a):
# denials, stale ticks, shed load and deadline misses among the loose.
FLY_LOOSE = SHORT_LOOSE + ("denials", "stale_ticks", "inf_dropped",
                           "batch_deadline_misses")


def flywheel_phase(dev, card: str) -> dict:
    """18: the continual-learning flywheel (`train/flywheel.py`,
    `harness/flywheel.py`) on the card at bench_flywheel's geometry.
    (a) a `FlywheelRunner` on a `Flywheel(device="cuda")` runs
    generation 1 (record on the graphed service, mine, distill: each
    curriculum cell's `produce_cell` and then `imitate`, evaluate,
    shadow, gates), each stage timed, the launch counters zeroed just
    before and read just after: per cell one plan and one rule CARRY
    launch a block and one MLP launch, nothing else; the service's graph
    captures, their seconds and the memory the tick cache keeps.
    (b) each evaluated cell's challenger summary, recomputed by the MLP
    kernel on the cell's regenerated stream, equal to the row's numbers
    and held against `kernel_numerics_action_fn` under
    `batched_rollout_summary` per cluster (phases 5c/14a's standard);
    the cell's rule column bitwise `unblocked_reference_summary`; the
    rule and teacher columns (the plan and rule CARRY launches at the
    cell's own B x T) against `lane_plain` on the regenerated stream, the
    teacher's with the cell's plan, by the same standard.
    (c) generation 1 recorded, mined and distilled again in a fresh root
    under the same seeds: the same mined cells, curriculum digest and
    checkpoint digest.
    (d) an eligible decision was promoted: `divergence_rollback` must
    stamp one policy_divergence incident and clear the live files (the
    parent is the rule); an ineligible one: `promote` refuses it and
    live.* stays absent. The gates and mean_ratio on a `# 18` line.
    (e) `python -m ccka_tpu_torch flywheel status --device cuda` in a
    process of its own (started after (a), read before (d)): its JSON
    equal to `Flywheel.status()`."""
    import gc
    import shutil

    from ccka_tpu_torch import PRESETS
    from ccka_tpu_torch.harness import service
    from ccka_tpu_torch.harness.flywheel import FlywheelRunner
    from ccka_tpu_torch.kernels import build
    from ccka_tpu_torch.models.nets import latent_to_action
    from ccka_tpu_torch.obs.compile import stats_for
    from ccka_tpu_torch.sim import lanes
    from ccka_tpu_torch.sim import megakernel as mk
    from ccka_tpu_torch.sim import streaming as stm
    from ccka_tpu_torch.sim.types import SimParams
    from ccka_tpu_torch.train import factory
    from ccka_tpu_torch.train import flywheel as tfw
    from ccka_tpu_torch.train import imitate as imitate_mod
    from ccka_tpu_torch.train.checkpoint import load_params_npz

    t_phase = time.perf_counter()
    laps = [t_phase]

    def lap() -> str:
        torch.cuda.synchronize()
        laps.append(time.perf_counter())
        return f"({laps[-1] - laps[-2]:.2f} s)"

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           FLY_DIR)
    shutil.rmtree(out_dir, ignore_errors=True)
    cfg = PRESETS["default"]()
    params = SimParams.from_config(cfg, device=dev)
    Z = cfg.cluster.n_zones
    rec: dict = {"launches_by_path": {}}

    def runner(tag: str):
        fw = tfw.Flywheel(cfg, os.path.join(out_dir, tag, "root"),
                          device=dev, **FLY)
        return FlywheelRunner(cfg, fw,
                              scratch=os.path.join(out_dir, tag, "runs"),
                              **FLY_RUNNER)

    stages: dict = {}
    kept: dict = {}

    def timed(name: str, fn, keep: bool = False):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*a, **k)
            torch.cuda.synchronize()
            stages[name] = stages.get(name, 0.0) + time.perf_counter() - t0
            if keep:
                kept[name] = res
            return res
        return run

    # ---- 18a: one generation through the runner
    a = runner("a")
    a.record = timed("record", a.record)
    a.shadow = timed("shadow", a.shadow)
    a.fw.mine = timed("mine", a.fw.mine)
    a.fw.distill = timed("distill", a.fw.distill, keep=True)
    a.fw.evaluate = timed("evaluate", a.fw.evaluate)
    imitate = imitate_mod.imitate
    imitate_mod.imitate = timed("imitate", imitate)
    st0 = stats_for("service.tick")
    caps0 = (st0.compiles, st0.compile_s) if st0 else (0, 0.0)
    gc.collect()
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_reserved()
    kernel_counts(clear=True)
    try:
        g1, gen_s = synced(lambda: a.generation(1))
    finally:
        imitate_mod.imitate = imitate
    counts = kernel_counts()
    st = stats_for("service.tick")
    captures = st.compiles - caps0[0]
    capture_s = st.compile_s - caps0[1]
    mem1 = torch.cuda.memory_reserved()
    rep = kept["distill"]
    want: dict = {}
    for cell in rep["produced"]:
        r = cell.report
        rows = factory._cell_source(
            cfg, a.fw._resolve_scenario(cell.scenario),
            cell.intensity).packed_rows()
        faults, wl = lanes.stream_layout(rows, Z)
        wl = 16 if wl else 0
        n_blocks = r["playback"]["n_blocks"]
        for policy, carry, n in (("rule", True, n_blocks),
                                 ("plan", True, n_blocks),
                                 ("mlp", False, 1)):
            label = geo_label(policy, faults, wl, carry=carry)
            want[label] = want.get(label, 0) + n
    if counts != want:
        fail(f"18a: the generation launched {counts}, not {want}")
    if captures != 2:
        fail(f"18a: the generation's record and shadow runs captured "
             f"{captures} service.tick graphs, not 2")
    rec["launches_by_path"]["flywheel generation, record to gates "
                            "(phase 18a)"] = counts
    cells = rep["produced"]
    cell_stage = {k: sum(c.report[k] for c in cells)
                  for k in ("gen_s", "plan_s", "label_s", "collect_s")}
    stages["gates and the rest"] = gen_s - sum(
        v for k, v in stages.items() if k != "imitate")
    rec.update(generation_s=gen_s, stages=dict(stages),
               cell_stages=cell_stage,
               cells=[c.report for c in cells],
               captures=captures, capture_s=capture_s,
               reserved_gb=(mem0 / 1e9, mem1 / 1e9),
               mined=g1["mined_cells"], eval=g1["eval"],
               decision=g1["decision"], shadow_board=g1["shadow_board"])
    log(f"# 18a flywheel generation 1 (default, {FLY_RUNNER['n_tenants']} "
        f"tenants, {len(cells)} cells, pairs "
        f"{[c.report['pairs'] for c in cells]} x {FLY['steps']} ticks, "
        f"{FLY['iterations']} Adam iterations): {gen_s:.3f} s; stages "
        f"{json.dumps({k: round(v, 4) for k, v in stages.items()})}; the "
        f"cells' gen/plan/label/collect "
        f"{json.dumps({k: round(v, 4) for k, v in cell_stage.items()})}; "
        f"launches {json.dumps(counts)}; {captures} service.tick captures "
        f"in {capture_s:.3f} s, reserved {mem0 / 1e9:.3f} -> "
        f"{mem1 / 1e9:.3f} GB {lap()}")
    shell = start_side_process(["-m", "ccka_tpu_torch", "flywheel",
                                "status", "--root", a.fw.root,
                                "--device", "cuda"])
    status_a = a.fw.status()

    # ---- 18b: the challenger column against its plain version, the
    # rule column against the unblocked reference
    ch_params, _ = load_params_npz(rep["checkpoint"])
    worst: dict = {}
    for cell, row in zip(cells, g1["eval"]):
        r = cell.report
        src = factory._cell_source(
            cfg, a.fw._resolve_scenario(cell.scenario), cell.intensity)
        kw = dict(key=r["seed"], batch=r["pairs"], T=r["steps"],
                  block_T=r["block_T"], seed=r["seed"],
                  t_chunk=r["t_chunk"], stochastic=r["stochastic"],
                  device=dev)
        ref = stm.unblocked_reference_summary(src, params, cfg.cluster,
                                              "rule", **kw)
        if not bitwise(cell.rule_summary, ref):
            fail(f"18b: {cell.scenario}/{cell.intensity}: the rule column "
                 f"is not bitwise the unblocked reference")
        stream = factory._cell_stream(
            src, steps=r["steps"], block_T=r["block_T"],
            t_chunk=r["t_chunk"], pairs=r["pairs"], key=r["seed"],
            device=dev)
        # The CARRY launches behind the rule and teacher columns against
        # their plain versions, at the cell's own shapes (one partly
        # masked thread block); the streamed columns are on the host.
        plan = mk.pack_plan(latent_to_action(cell.plan_latents,
                                             cfg.cluster), stream.shape[0])
        for col, policy, summary in (("rule", "rule", cell.rule_summary),
                                     ("teacher", "plan",
                                      cell.teacher_summary)):
            summary = type(summary)(*(x.to(dev) for x in summary))
            p = lane_plain(policy, cfg, params, None, stream, r["steps"],
                           r["stochastic"], seed=r["seed"],
                           plan=plan if policy == "plan" else None)
            rel = field_rel(summary, p)
            bad = {f: v for f, v in rel.items()
                   if v > (SHORT_LOOSE_TOL if f in FLY_LOOSE
                           else SHORT_TOL)}
            top = max(rel, key=rel.get)
            worst[f"{cell.scenario}/{cell.intensity} {col}"] = {
                "bitwise": bitwise(summary, p), "worst_field": top,
                "rel": rel[top],
                "max_abs_err": per_cluster_share(summary, p)[3]}
            log(f"# parity 18b {cell.scenario}/{cell.intensity} {col} "
                f"column ({policy} CARRY) B={r['pairs']} T={r['steps']} "
                f"stochastic={r['stochastic']}: bitwise "
                f"{bitwise(summary, p)}; largest per-cluster rel diff "
                f"{top} {rel[top]:.3g}")
            if bad:
                fail(f"18b: {cell.scenario}/{cell.intensity}: the {col} "
                     f"column against its plain version: {bad}")
        k = mk.neural_megakernel_summary_from_packed(
            params, cfg.cluster, ch_params, stream, r["steps"], r["seed"],
            stochastic=r["stochastic"])
        for cls, metric in tfw.CLASS_METRICS.items():
            got = round(tfw._mean64(getattr(k, metric)), 6)
            if got != row["class_deltas"][cls]["challenger"]:
                fail(f"18b: {cell.scenario}/{cell.intensity} {metric}: the "
                     f"kernel gives {got}, the row "
                     f"{row['class_deltas'][cls]['challenger']}")
        p = lane_plain("mlp", cfg, params, ch_params, stream, r["steps"],
                       r["stochastic"], seed=r["seed"])
        rel = field_rel(k, p)
        bad = {f: v for f, v in rel.items()
               if v > (SHORT_LOOSE_TOL if f in FLY_LOOSE else SHORT_TOL)}
        top = max(rel, key=rel.get)
        worst[f"{cell.scenario}/{cell.intensity} challenger"] = {
            "bitwise": bitwise(k, p), "worst_field": top,
            "rel": rel[top], "max_abs_err": per_cluster_share(k, p)[3]}
        log(f"# parity 18b {cell.scenario}/{cell.intensity} challenger "
            f"B={r['pairs']} T={r['steps']} stochastic={r['stochastic']}: "
            f"bitwise {bitwise(k, p)}; largest per-cluster rel diff {top} "
            f"{rel[top]:.3g}; the rule column bitwise the unblocked "
            f"reference")
        if bad:
            fail(f"18b: {cell.scenario}/{cell.intensity}: the challenger "
                 f"summary against its plain version: {bad}")
    rec["parity"] = worst
    log(f"# 18b {len(cells)} cells held {lap()}")

    # ---- 18c: generation 1 again in a fresh root, same seeds
    b = runner("b")
    kernel_counts(clear=True)
    rec_b = b.record()
    cells_b = b.fw.mine(decisions_path=rec_b["paths"]["decisions"],
                        tournament_path=rec_b["paths"]["tournament"],
                        incidents_path=rec_b["paths"]["incidents"],
                        top_k=b.top_k)
    window = {"ticks": rec_b["ticks"], "rows": rec_b["decision_rows"],
              "diverged": rec_b["diverged_total"],
              "incidents": rec_b["incidents"], "seed": b.seed}
    (rep_b, rerun_s) = synced(lambda: b.fw.distill(
        cells_b, generation=1, ledger_window=window))
    counts_b = kernel_counts()
    rec["launches_by_path"]["flywheel rerun of generation 1's distill "
                            "(phase 18c)"] = counts_b
    mined_b = [{"scenario": c.scenario, "intensity": c.intensity,
                "class": c.workload_class, "regime": c.tenant_regime,
                "score": c.score} for c in cells_b]
    same = {"mined_cells": mined_b == g1["mined_cells"],
            "curriculum_digest": rep_b["curriculum_digest"]
            == g1["curriculum_digest"],
            "checkpoint_digest": rep_b["checkpoint_digest"]
            == g1["checkpoint_digest"],
            "ledger_window": window == g1["ledger_window"]}
    rec["rerun"] = dict(same, distill_s=rerun_s)
    log(f"# 18c generation 1 recorded, mined and distilled again in a "
        f"fresh root: {json.dumps(same)} (distill {rerun_s:.3f} s) "
        f"{lap()}")
    if not all(same.values()):
        fail(f"18c: the seeded rerun differs: {same}; checkpoint "
             f"{rep_b['checkpoint_digest'][:12]} against "
             f"{g1['checkpoint_digest'][:12]}")

    # ---- 18e: the shell's status, read before 18d changes the root
    sdoc = json.loads(join_side_process(shell, "18e: `flywheel status`",
                                        300))
    if sdoc != json.loads(json.dumps(status_a, default=str)):
        fail(f"18e: `flywheel status` printed {sdoc}, Flywheel.status() "
             f"gives {status_a}")
    rec["shell_s"] = shell["s"]
    log(f"# 18e `flywheel status --device cuda` from the shell "
        f"({shell['s']:.2f} s, beside 18b and 18c): equal to "
        f"Flywheel.status() (incumbent {sdoc['incumbent']}, "
        f"{len(sdoc['generations'])} generation, provenance "
        f"{sdoc['generations'][0]['provenance']})")

    # ---- 18d: promote and roll back, or the refusal
    decision = g1["decision"]
    gates = {k: v for k, v in decision["gates"].items()}
    if decision["eligible"]:
        if not g1["promoted"] or a.fw.incumbent()[0] != "gen-001":
            fail("18d: an eligible decision was not promoted")
        rb = a.divergence_rollback()
        incidents = rb["watch"]["incidents"]
        if (not rb["rolled_back"] or incidents.get("policy_divergence") != 1
                or os.path.exists(a.fw.live_npz)
                or os.path.exists(a.fw.live_json)
                or a.fw.status()["incumbent"] != "rule"):
            fail(f"18d: the divergence watch did not demote the "
                 f"challenger to its rule parent: {rb}")
        rec["rollback"] = rb
        outcome = (f"promoted, then demoted by one policy_divergence "
                   f"incident at tick {rb['incident']['t']} to "
                   f"{rb['restored']['name']}")
    else:
        try:
            a.fw.promote(1, decision)
            fail("18d: an ineligible decision was promoted")
        except ValueError as e:
            if "promotion refused" not in str(e):
                raise
        if os.path.exists(a.fw.live_npz) or os.path.exists(a.fw.live_json):
            fail("18d: a refused promotion left live files")
        outcome = "not eligible: promote refused it, live.* absent"
    rec["outcome"] = outcome
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"# 18 flywheel gates {json.dumps(gates)}; eligible "
        f"{decision['eligible']}, mean_ratio {gates['mean_ratio']}; "
        f"{outcome} {lap()}")

    # What the tick cache keeps: the phase's service graphs and pools.
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved()
    entries = service._compiled_service_tick.cache_info().currsize
    service._compiled_service_tick.cache_clear()
    gc.collect()
    torch.cuda.empty_cache()
    freed = held - torch.cuda.memory_reserved()
    rec["tick_cache"] = {"entries": entries, "freed_gb": freed / 1e9}
    log(f"# phase 18: {rec['seconds']:.1f} s; clearing the tick cache "
        f"({entries} entries) freed {freed / 1e9:.3f} GB reserved; card "
        f"{card}")
    return rec


# ---- the mesh (phase 19)

# A [4, 1] mesh over cuda:0: the main path's B = 32768 as 4 shards of
# 8192, the counterpart of the JAX package's virtual host devices.
MESH_SHARDS = 4
MESH_KEY, MESH_SEED = 97, 43
MESH_CEM = dict(generations=1, popsize=16, traces_per_gen=512,
                eval_steps=T_DAY, seed=7)     # 19c: 128 traces a shard
# 19d: a planner segment of the boards' mpc rows
# (`faults/scoreboard.py::QUICK_PLANNER`: horizon 8, 2 Adam iterations).
MESH_PLAN = dict(horizon=8, iters=2)
MESH_PPO_TOL = dict(rtol=2e-4, atol=2e-5)     # tests/test_parallel.py


def mesh_phase(dev, card: str, setup) -> dict:
    """19: the device mesh (`parallel/`) on a [4, 1] mesh over cuda:0 at
    B = 32768 x T = 2880, stochastic, 8192 clusters a shard; the launch
    counters zeroed just before each mesh run and read just after.
    (a) the four `*_summary_from_packed` families (rule, carbon, the MLP
    with a population of 2, a per-cluster plan) on the default and
    multiregion presets: shard-local synthesis bitwise the generator on
    each shard's key; every field of every cluster bitwise the single
    launch on the gathered stream; `measure_shard_times` and
    `shard_imbalance` of the rule launch, the mesh's rule pipeline through
    `measure_packed_pipeline`, both published for the service's gauges
    (`obs/costmodel.py::publish_pipeline_snapshot`). (b) `streaming_rollout_summary
    (mesh=)` on the multiregion mixed day in 8 blocks of 360, rule,
    carbon, the flagship and a per-cluster plan, bitwise the
    single-device drive over the same shard blocks (`ShardBlocks`).
    (c) one `cem_refine(engine="mega", mesh=)` generation (16 members x
    512 traces, the carbon teacher) bitwise a single-device generation
    fed the gathered stream, the same world seed and noise. (d)
    `optimize_plan_batch(mesh=, donate_plans=True)` at the boards'
    segment geometry (N = 32768, horizon 8, 2 iterations; one graph
    captured at the shard geometry, replayed per shard) bitwise the
    eager unsharded call; the plans alias the buffer. (e) one PPO
    iteration on a [2, 2] mesh (data x model) at the config's 256 x 64
    against the unsharded iteration at rtol 2e-4, atol 2e-5, the params
    and the diagnostics (policy and value loss, KL, mean reward,
    attainment); `simulate
    --mesh` from the shell (a process of its own, started after (b))
    equal to `simulate` without it. Returns the phase's record."""
    from ccka_tpu_torch.config import MeshConfig
    from ccka_tpu_torch.obs.costmodel import (pipeline_snapshot,
                                              publish_pipeline_snapshot)
    from ccka_tpu_torch.obs.occupancy import (measure_packed_pipeline,
                                              measure_shard_times,
                                              shard_imbalance)
    from ccka_tpu_torch.parallel import (gather, make_mesh, shard_params,
                                         shard_ppo_state)
    from ccka_tpu_torch.parallel import sharded_kernel as sk
    from ccka_tpu_torch.policy.carbon import CarbonAwarePolicy
    from ccka_tpu_torch.sim import megakernel as mk
    from ccka_tpu_torch.sim import streaming as stm
    from ccka_tpu_torch.sim.rollout import initial_state
    from ccka_tpu_torch.train import cem
    from ccka_tpu_torch.train.mpc import optimize_plan_batch, zero_latent
    from ccka_tpu_torch.train.ppo import PPOTrainer

    t_phase = time.perf_counter()
    laps = [t_phase]

    def lap() -> float:
        torch.cuda.synchronize()
        laps.append(time.perf_counter())
        return laps[-1] - laps[-2]

    card0 = torch.device("cuda", 0)
    mesh = make_mesh(devices=[card0] * MESH_SHARDS)
    b_loc = B_MAIN // MESH_SHARDS
    rec: dict = {"seconds": {}, "by_subphase": {}, "shard_ms": {},
                 "imbalance": {}}
    path: dict = {}

    def count(sub: str) -> None:
        torch.cuda.synchronize()
        counts = kernel_counts()
        rec["by_subphase"][sub] = counts
        for k, v in counts.items():
            path[k] = path.get(k, 0) + v
        log(f"# 19{sub} launches: {counts}")

    def same(a, b, what: str) -> None:
        torch.cuda.synchronize()
        if not bitwise(a, b):
            bad = [f for f in a._fields
                   if not torch.equal(getattr(a, f), getattr(b, f))]
            fail(f"19: {what} is not bitwise the single-device result "
                 f"(fields {bad})")

    # -- (a) the four packed families on two presets
    for preset, variant in (("default", "replay"), ("multiregion", "")):
        cfg, src, params, off, peak, net = setup(preset, variant)
        pop = mk._tree_map(lambda x: np.stack([x, 0.5 * np.asarray(x)]),
                           net)
        plan = random_plan(cfg, B_MAIN, T_DAY, T_DAY, dev)
        torch.cuda.synchronize()
        kernel_counts(clear=True)
        st = sk.sharded_packed_trace(mesh, src, T_DAY, MESH_KEY, B_MAIN)
        kw = dict(seed=MESH_SEED)
        got = {
            "rule": sk.sharded_megakernel_summary_from_packed(
                mesh, params, off, peak, st, T_DAY, **kw),
            "carbon": sk.sharded_carbon_summary_from_packed(
                mesh, params, off, peak, st, T_DAY, **kw),
            "mlp": sk.sharded_neural_summary_from_packed(
                mesh, params, cfg.cluster, pop, st, T_DAY, **kw),
            "plan": sk.sharded_plan_summary_from_packed(
                mesh, params, cfg.cluster, plan, st, T_DAY, **kw)}
        count(f"a {preset}")
        rec["seconds"][f"19a {preset} mesh"] = lap()
        for i in range(MESH_SHARDS):
            local = src.packed_trace_device(T_DAY, sk.shard_key(MESH_KEY, i),
                                            b_loc, device=card0)
            if not torch.equal(local, st.parts[i]):
                fail(f"19a {preset}: shard {i}'s stream is not the "
                     f"generator's on its key")
            del local
        times = measure_shard_times(
            lambda i: mk.megakernel_summary_from_packed(
                params, off, peak, st.parts[i], T_DAY, MESH_SEED,
                cluster0=st.offsets[i]), MESH_SHARDS,
            label=f"mesh.{preset}")
        rec["shard_ms"][preset] = [t * 1e3 for t in times]
        rec["imbalance"][preset] = shard_imbalance(times)
        # The mesh's rule pipeline through the occupancy ledger (the same
        # stream synthesized again into its buffers), published for the
        # service's gauges.
        ledger, _ = measure_packed_pipeline(
            lambda i: sk.sharded_packed_trace(mesh, src, T_DAY, MESH_KEY,
                                              B_MAIN, recycle=st),
            lambda stream, i: sk.sharded_megakernel_summary_from_packed(
                mesh, params, off, peak, stream, T_DAY, seed=MESH_SEED),
            lambda out: float(gather(out).usd_per_slo_hour.mean()),
            label=f"mesh.{preset}.pipeline")
        rec.setdefault("occupancy", {})[preset] = ledger.to_dict()
        publish_pipeline_snapshot(occupancy=ledger.fractions(),
                                  shard_imbalance=rec["imbalance"][preset])
        if pipeline_snapshot()["shard_imbalance"] != rec["imbalance"][preset]:
            fail("19a: the published shard imbalance does not read back")
        full = gather(st)
        del st
        torch.cuda.empty_cache()
        want = {
            "rule": mk.megakernel_summary_from_packed(
                params, off, peak, full, T_DAY, MESH_SEED),
            "carbon": mk.carbon_megakernel_summary_from_packed(
                params, off, peak, full, T_DAY, MESH_SEED),
            "mlp": mk.neural_megakernel_summary_from_packed(
                params, cfg.cluster, pop, full, T_DAY, MESH_SEED),
            "plan": mk.plan_megakernel_summary_from_packed(
                params, cfg.cluster, plan, full, T_DAY, MESH_SEED)}
        for name in got:
            same(gather(got[name]), want[name], f"19a {preset} {name}")
        log(f"# 19a {preset} B={B_MAIN} T={T_DAY} on {MESH_SHARDS} shards "
            f"of {b_loc}: rule, carbon, mlp (2 members), plan bitwise the "
            f"single launch; shard-local synthesis bitwise; rule per-shard "
            f"ms {[round(t * 1e3, 4) for t in times]}, imbalance "
            f"{rec['imbalance'][preset]:.4f}; the mesh's rule pipeline "
            f"{ledger.to_dict()} ({card})")
        del full, plan, got, want
        torch.cuda.empty_cache()
        rec["seconds"][f"19a {preset} checks"] = lap()

    # -- (b) the streamed mixed day over the mesh
    cfg, _, _, _, _, net = setup("multiregion")
    source, wl = stream_source(cfg, "mixed")
    params = lane_params(cfg, wl, dev)
    plan = random_plan(cfg, B_MAIN, T_DAY, T_DAY, dev)
    kw = dict(key=STREAM_KEY, batch=B_MAIN, T=T_DAY, block_T=BLOCK_DAY,
              seed=STREAM_SEED, t_chunk=T_CHUNK_STREAM, stochastic=True,
              device=dev)

    def route_kw(route):
        return dict(kw, net_params=net if route == "mlp" else None,
                    plan_packed=plan if route == "plan" else None)

    torch.cuda.synchronize()
    kernel_counts(clear=True)
    streamed = {route: stm.streaming_rollout_summary(
        source, params, cfg.cluster, BLOCK_MODE[route], mesh=mesh,
        **route_kw(route)) for route in ROUTES}
    count("b")
    rec["seconds"]["19b mesh"] = lap()
    rec["stream_wall_s"] = {r: v[1]["wall_s"] for r, v in streamed.items()}
    shell = {name: start_side_process(
        ["-m", "ccka_tpu_torch", "simulate", "--clusters", str(B_MAIN),
         "--stochastic", "--device-traces", *extra])
        for name, extra in (("plain", []), ("mesh", ["--mesh"]))}
    for route in ROUTES:
        one, _ = stm.streaming_rollout_summary(
            sk.ShardBlocks(source, MESH_SHARDS), params, cfg.cluster,
            BLOCK_MODE[route], **route_kw(route))
        same(streamed[route][0], one, f"19b {route} streamed day")
    log(f"# 19b mixed day B={B_MAIN} T={T_DAY} in {T_DAY // BLOCK_DAY} "
        f"blocks on {MESH_SHARDS} shards: rule, carbon, mlp, plan bitwise "
        f"the single-device drive; walls s {rec['stream_wall_s']}")
    del plan, streamed
    torch.cuda.empty_cache()
    rec["seconds"]["19b checks"] = lap()

    # -- (c) one CEM mega generation over the mesh
    cfg, src, _, _, _, net = setup("multiregion")
    teacher = CarbonAwarePolicy(cfg.cluster, device=dev)
    ccfg = cem.CEMConfig(**{k: v for k, v in MESH_CEM.items()
                            if k != "seed"})
    torch.cuda.synchronize()
    kernel_counts(clear=True)
    best_m, hist_m, _ = cem.cem_refine(
        cfg, net, src, cem=ccfg, engine="mega", teacher_policy=teacher,
        mesh=mesh, seed=MESH_CEM["seed"], device=dev)
    count("c")
    rec["seconds"]["19c mesh"] = lap()
    # The mesh generation's draws, as `cem_refine` makes them.
    g = torch.Generator(device=dev).manual_seed(MESH_CEM["seed"])

    def draw() -> int:
        return int(torch.randint(2 ** 30, (1,), generator=g, device=dev))

    stream = gather(sk.sharded_packed_trace(
        mesh, src, T_DAY, draw(), MESH_CEM["traces_per_gen"]))
    ws = draw()
    noise = torch.randn((ccfg.popsize - 1, cem._flatten(net)[0].shape[0]),
                        generator=g, device=dev)
    best_1, hist_1, _ = cem.cem_refine(
        cfg, net, src, cem=ccfg, engine="mega", teacher_policy=teacher,
        device=dev, draws=lambda gen: cem.CEMDraws(stream, ws, noise))
    if hist_m != hist_1 or not torch.equal(cem._flatten(best_m)[0],
                                           cem._flatten(best_1)[0]):
        fail(f"19c: the mesh generation is not the single-device one: "
             f"{hist_m} against {hist_1}")
    log(f"# 19c CEM generation {ccfg.popsize} x "
        f"{ccfg.traces_per_gen} x {T_DAY} on {MESH_SHARDS} shards: fitness "
        f"and members bitwise the single-device generation "
        f"({hist_m[0]['incumbent_fitness']:.6f})")
    del stream, noise
    torch.cuda.empty_cache()
    rec["seconds"]["19c checks"] = lap()

    # -- (d) the planner over the mesh, plans donated
    cfg, src, params, _, _, _ = setup("multiregion")
    H = MESH_PLAN["horizon"]
    traces = mk.unpack_exo(src.packed_trace_device(H, MESH_KEY, B_MAIN,
                                                   device=dev),
                           H, cfg.cluster.n_zones)
    states = initial_state(cfg, B_MAIN, dev)
    lat0 = zero_latent(cfg.cluster, dev)
    buf = lat0.expand(B_MAIN, H, *lat0.shape).contiguous()
    init = buf.clone()
    torch.cuda.synchronize()
    kernel_counts(clear=True)
    got = optimize_plan_batch(params, cfg.cluster, cfg.train, states, traces,
                              buf, iters=MESH_PLAN["iters"], mesh=mesh,
                              donate_plans=True)
    count("d")
    rec["seconds"]["19d mesh"] = lap()
    want = optimize_plan_batch(params, cfg.cluster, cfg.train, states, traces,
                               init, iters=MESH_PLAN["iters"])
    torch.cuda.synchronize()
    for name, a, b in (("plans", gather(got.plan_latent), want.plan_latent),
                       ("losses", gather(got.losses), want.losses)):
        if not torch.equal(a, b):
            fail(f"19d: the mesh planner's {name} differ from the "
                 f"unsharded call in {int((a != b).sum())} values (max abs "
                 f"{float((a - b).abs().max()):.4g})")
    if not (torch.equal(buf, want.plan_latent) and all(
            p.data_ptr() == buf[o].data_ptr()
            for p, o in zip(got.plan_latent.parts, got.plan_latent.offsets))):
        fail("19d: the donated plans do not alias the warm-start buffer")
    log(f"# 19d optimize_plan_batch N={B_MAIN} H={H} iters="
        f"{MESH_PLAN['iters']} on {MESH_SHARDS} shards (one graph, "
        f"replayed a shard): plans and losses bitwise the unsharded call; "
        f"the plans alias the buffer")
    del traces, states, buf, init, got, want
    torch.cuda.empty_cache()
    rec["seconds"]["19d checks"] = lap()

    # -- (e) PPO on a [2, 2] mesh; simulate --mesh from the shell
    cfg, src, _, _, _, _ = setup("multiregion")
    trainer = PPOTrainer(cfg, device=dev)
    window = trainer.make_windows(src, 1, seed=TRAIN_SEED)
    g_noise = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
    noise = torch.randn((cfg.train.batch_clusters, cfg.train.unroll_steps,
                         trainer.act_dim), generator=g_noise, device=dev)
    m22 = make_mesh(MeshConfig(data_parallel=2, model_parallel=2),
                    devices=[card0] * 4)
    ts = shard_ppo_state(m22, trainer.init_state(0))
    ts = ts._replace(params=shard_params(m22, ts.params))
    torch.cuda.synchronize()
    kernel_counts(clear=True)
    ts_m, diag_m = trainer.iteration(ts, window, noise)
    count("e")
    rec["seconds"]["19e mesh PPO"] = lap()
    ts_1, diag_1 = trainer.iteration(trainer.init_state(0), window, noise)
    worst, where = 0.0, ""
    for k, v in ts_1.params.items():
        got_k = gather(ts_m.params[k], v.device)
        share = float(((got_k - v).abs() / (MESH_PPO_TOL["atol"]
                       + MESH_PPO_TOL["rtol"] * v.abs())).max())
        if share > worst:
            worst, where = share, k
    diag_share = {}
    for f in ("policy_loss", "value_loss", "approx_kl", "mean_reward",
              "attainment"):
        a, b = float(getattr(diag_m, f)), float(getattr(diag_1, f))
        diag_share[f] = abs(a - b) / (MESH_PPO_TOL["atol"]
                                      + MESH_PPO_TOL["rtol"] * abs(b))
        if diag_share[f] > worst:
            worst, where = diag_share[f], f
    rec["ppo_tol_share"] = worst
    rec["ppo_diag"] = {f: [float(getattr(d, f)) for d in (diag_m, diag_1)]
                       for f in diag_share}
    log(f"# 19e PPO iteration {cfg.train.batch_clusters} x "
        f"{cfg.train.unroll_steps} on a [2, 2] mesh: params and diagnostics "
        f"within {worst:.4f} of rtol 2e-4 / atol 2e-5 of the unsharded "
        f"iteration (worst {where}); diagnostics mesh / unsharded "
        f"{rec['ppo_diag']}")
    if worst > 1.0:
        fail(f"19e: the [2, 2] PPO iteration's {where} is beyond rtol "
             f"2e-4 / atol 2e-5 of the unsharded iteration")
    rec["seconds"]["19e checks"] = lap()
    outs = {name: join_side_process(side, f"19e simulate ({name})", 300)
            for name, side in shell.items()}
    rec["seconds"]["19e shell wait"] = lap()
    rec["shell_s"] = {name: side["s"] for name, side in shell.items()}
    if outs["mesh"] != outs["plain"]:
        fail(f"19e: `simulate --mesh` printed {outs['mesh'][:400]} and "
             f"`simulate` {outs['plain'][:400]}")
    log(f"# 19e `simulate --clusters {B_MAIN} --stochastic --device-traces "
        f"--mesh` from the shell equals it without --mesh (one card: a "
        f"one-shard mesh); shell s {rec['shell_s']}")
    rec["launches_by_path"] = {"mesh path (phase 19)": path}
    rec["seconds"]["phase"] = time.perf_counter() - t_phase
    log(f"# phase 19 seconds: {json.dumps(rec['seconds'])} ({card})")
    return rec


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    from ccka_tpu_torch import PRESETS
    from ccka_tpu_torch.kernels import build
    from ccka_tpu_torch.policy.carbon import CarbonAwarePolicy
    from ccka_tpu_torch.policy.rule import (RulePolicy, offpeak_action,
                                            peak_action)
    from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource
    from ccka_tpu_torch.sim import random as prandom
    from ccka_tpu_torch.sim import megakernel as mk
    from ccka_tpu_torch.sim.rollout import (batched_rollout_summary,
                                            initial_state)
    from ccka_tpu_torch.sim.types import SimParams
    from ccka_tpu_torch.train.flagship import load_flagship_backend

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def clock(phase: str) -> None:
        """The run's clock at the start of a phase: where its time goes."""
        log(f"# clock {time.perf_counter() - t_start:.1f} s: phase {phase}")

    clock("1")
    # ---- 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    props = torch.cuda.get_device_properties(0)
    log(f"# card: {smi}")
    log(f"# device: {props.name}, {props.multi_processor_count} SMs, "
        f"{props.total_memory / 2**30:.1f} GiB, capability "
        f"{props.major}.{props.minor}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    clock("2")
    # ---- 2. build
    t0 = time.perf_counter()
    built = build.build_all()
    profiles = ProfileBuilds()
    build_s = time.perf_counter() - t0
    log(f"# build: {build_s:.2f} s wall, {len(built)} nvcc processes")
    # Every library's SASS at once: one cuobjdump process each.
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(built)) as pool:
        sass = dict(zip(built, pool.map(build.sass_summary,
                                        [lib for lib, _, _ in
                                         built.values()])))
    for unit, (lib, text, secs) in built.items():
        log(f"#   {unit} -> {lib.name} ({secs:.2f} s nvcc)")
        entry = None
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"#   ptxas: {line.strip()}")
            if "Compiling entry function" in line:
                entry = profile_key(line)
            elif entry is not None and "Used" in line and "registers" in line:
                profiles.regs[entry] = int(line.split("Used")[1].split()[0])
        build.library(*unit)
        for fn, counts in sass[unit].items():
            log(f"#   sass: {fn}: {counts}")
            key = profile_key(fn)
            if unit[0] == "rollout_mlp.cu" and counts["HMMA"] < 1:
                fail(f"{fn} in {lib.name} runs no tensor-core instruction")
            if key is not None:
                profiles.loop[key] = counts["loop"]
                if counts["SHFL"] < 1:
                    fail(f"{fn} in {lib.name} exchanges nothing between "
                         f"lanes: the pair layout is absent")
    if len(profiles.loop) != 96 or set(profiles.loop) != set(profiles.regs):
        fail(f"phase 2 found {len(profiles.loop)} rollout_profiles_kernel "
             f"instantiations in the SASS and {len(profiles.regs)} in the "
             f"ptxas lines, not 96")

    def gen(seed: int) -> torch.Generator:
        return torch.Generator(device=dev).manual_seed(seed)

    clock("3")
    # ---- 3. Philox: the kernel against the torch stream, bitwise. The
    # first grid is one tick of the rule path's draws (B_MAIN x 6 rows).
    def philox_plain(seed, nb, tick0, nt, nr):
        ar = lambda n: torch.arange(n, device=dev)  # noqa: E731
        return prandom.uniforms(seed, ar(nb)[None, None, :],
                                (tick0 + ar(nt))[:, None, None],
                                ar(nr)[None, :, None])

    checks = [(7, B_MAIN, 0, 1, 6), (2**40 + 3, 97, 2**20, 33, 8)]
    prandom.uniform_grid.launches = 0
    philox_abs = 0.0
    for seed, nb, tick0, nt, nr in checks:
        got = prandom.uniform_grid(seed, nb, tick0, nt, nr, dev)
        want = philox_plain(seed, nb, tick0, nt, nr)
        philox_abs = max(philox_abs, float((got - want).abs().max()))
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            fail(f"philox kernel differs from the torch stream in {bad} of "
                 f"{got.numel()} values (seed {seed})")
        log(f"# philox: {got.numel()} uniforms bitwise equal (seed {seed}, "
            f"{nb} clusters x {nt} ticks from {tick0} x {nr} rows)")
    philox_launches = prandom.uniform_grid.launches
    if philox_launches != len(checks):
        fail(f"philox check launched the kernel {philox_launches} times, "
             f"expected {len(checks)}")
    ph_args = checks[0]
    ph_ms = float(np.median(cuda_ms(
        lambda: prandom.uniform_grid(*ph_args, dev), 20)))
    ph_plain_ms = float(np.median(cuda_ms(
        lambda: philox_plain(*ph_args), 20)))
    ph_n = 3 * ph_args[1] * ph_args[3] * ph_args[4]  # uniforms written
    ph_bound, ph_by, _ = bound(
        ph_n * 4, {"conversion": (2 * ph_n, F32_UNFUSED_OPS_PER_S, "float32")})

    def setup(preset: str, variant: str = ""):
        cfg = PRESETS[preset]()
        src = SyntheticSignalSource(cfg.cluster, cfg.workload, cfg.sim,
                                    cfg.signals)
        backend, _ = load_flagship_backend(cfg, variant=variant, device=dev)
        return (cfg, src, SimParams.from_config(cfg, device=dev),
                offpeak_action(cfg.cluster, dev),
                peak_action(cfg.cluster, dev),
                None if backend is None else backend.params)

    def plain(cfg, params, traces, seed, stochastic, action_fn):
        B = traces.is_peak.shape[0]
        return batched_rollout_summary(
            params, initial_state(cfg, B, dev), action_fn, traces, seed,
            stochastic=stochastic)[1]

    def rule_fn(cfg):
        return RulePolicy(cfg.cluster, dev).action_fn()

    def carbon_fn(cfg, **constants):
        return CarbonAwarePolicy(cfg.cluster, device=dev,
                                 **constants).action_fn()

    def hold(tag: str, k, p, stochastic: bool) -> tuple[bool, float]:
        """Phase 4's standard for a kernel result against its plain
        version; returns (bitwise, largest absolute difference)."""
        torch.cuda.synchronize()
        share, worst, worst_rel, max_abs = per_cluster_share(k, p)
        same = bitwise(k, p)
        log(f"# parity {tag}: bitwise {same}; {share * 100:.4f} % "
            f"of clusters within 2e-3 on every field; worst field {worst} "
            f"(rel {worst_rel:.3g}); max abs diff {max_abs:.4g}")
        if stochastic:
            viol = mk.mean_parity_violations(k, p)
            log(f"#   mean_parity_violations: {viol}")
            if viol or share < 0.99:
                fail(f"stochastic parity ({tag})")
        else:
            rel = mean_rel(k, p)
            f_max = max(rel, key=rel.get)
            log(f"#   largest batch-mean rel diff: {f_max} {rel[f_max]:.3g}")
            if rel[f_max] > 1e-4 or share < 0.999:
                fail(f"deterministic parity ({tag})")
        return same, max_abs

    counters = {
        "rollout_profiles_kernel": mk.megakernel_summary_from_packed,
        "rollout_profiles_kernel<CARBON>":
            mk.carbon_megakernel_summary_from_packed,
        "rollout_mlp_kernel": mk.neural_megakernel_summary_from_packed,
        "plan entry": mk.plan_megakernel_summary_from_packed,
        "philox_uniform_kernel": prandom.uniform_grid,
    }

    def zero_counters() -> None:
        for entry in counters.values():
            entry.launches = 0

    def read_counters() -> dict:
        return {name: entry.launches for name, entry in counters.items()}

    clock("4")
    # ---- 4. rule and carbon kernels against their plain versions
    def parity(preset: str, B: int, modes, T: int = T_DAY) -> None:
        cfg, src, params, off, peak, _ = setup(preset)
        traces = src.batch_trace_device(T, gen(23), B, device=dev)
        for stochastic in modes:
            tag = (f"{preset} B={B} T={T} "
                   f"{'stochastic' if stochastic else 'deterministic'}")
            hold(f"rule {tag}",
                 mk.megakernel_rollout_summary(
                     params, off, peak, traces, seed=9,
                     stochastic=stochastic, device=dev),
                 plain(cfg, params, traces, 9, stochastic, rule_fn(cfg)),
                 stochastic)
            hold(f"carbon {tag}",
                 mk.carbon_megakernel_rollout_summary(
                     params, off, peak, traces, seed=9,
                     stochastic=stochastic, device=dev),
                 plain(cfg, params, traces, 9, stochastic, carbon_fn(cfg)),
                 stochastic)
        del traces
        torch.cuda.empty_cache()

    parity("default", B_PARITY, (False, True), T_PARITY)
    parity("multiregion", B_MULTI, (False, True), T_PARITY)

    clock("4b")
    # ---- 4b. the plan kernel: see plan_phase.
    plan_rec = plan_phase(dev, setup, hold, profiles)

    # The carbon constants reach the kernel, each in its place.
    cfg, src, params, off, peak, _ = setup("multiregion")
    traces = src.batch_trace_device(T_DAY // 10, gen(29), B_MULTI,
                                    device=dev)
    base = mk.carbon_megakernel_rollout_summary(
        params, off, peak, traces, seed=9, stochastic=False, device=dev)
    other = mk.carbon_megakernel_rollout_summary(
        params, off, peak, traces, seed=9, stochastic=False, device=dev,
        **CARBON_OTHER)
    hold(f"carbon {CARBON_OTHER} multiregion B={B_MULTI} T={T_DAY // 10}",
         other, plain(cfg, params, traces, 9, False,
                      carbon_fn(cfg, **CARBON_OTHER)), False)
    moved = float((base.carbon_kg - other.carbon_kg).abs().max())
    log(f"#   the constants change carbon_kg by up to {moved:.4g} kg")
    if moved <= 0:
        fail("the carbon constants do not reach the kernel")

    clock("5")
    # ---- 5. the MLP kernel against its plain version
    def mlp_plain(cfg, params, net, traces, seed, stochastic):
        return plain(cfg, params, traces, seed, stochastic,
                     mk.kernel_numerics_action_fn(net, cfg.cluster, params))

    def mlp_short(preset: str, variant: str) -> None:
        cfg, src, params, _, _, net = setup(preset, variant)
        traces = src.batch_trace_device(T_SHORT, gen(41), B_MULTI, device=dev)
        k = mk.neural_megakernel_rollout_summary(
            params, cfg.cluster, net, traces, seed=9, stochastic=False,
            device=dev)
        p = mlp_plain(cfg, params, net, traces, 9, False)
        rel = field_rel(k, p)
        bad = {f: r for f, r in rel.items()
               if r > (SHORT_LOOSE_TOL if f in SHORT_LOOSE else SHORT_TOL)}
        worst = max(rel, key=rel.get)
        log(f"# mlp parity {preset} ({variant or 'flagship'}) B={B_MULTI} "
            f"T={T_SHORT} deterministic: bitwise {bitwise(k, p)}; largest "
            f"per-cluster rel diff {worst} {rel[worst]:.3g}")
        if bad:
            fail(f"mlp short-horizon parity ({preset}): {bad}")

    mlp_short("multiregion", "")
    mlp_short("default", "replay")

    cfg, src, params, off, peak, net = setup("multiregion")
    traces = src.batch_trace_device(T_PARITY, gen(43), B_PARITY, device=dev)
    for stochastic in (False, True):
        k = mk.neural_megakernel_rollout_summary(
            params, cfg.cluster, net, traces, seed=9, stochastic=stochastic,
            device=dev)
        p = mlp_plain(cfg, params, net, traces, 9, stochastic)
        torch.cuda.synchronize()
        share, worst, worst_rel, max_abs = per_cluster_share(k, p)
        viol = mk.mean_parity_violations(k, p,
                                         mk.NEURAL_MEAN_PARITY_TOLERANCES)
        log(f"# mlp parity multiregion B={B_PARITY} T={T_PARITY} "
            f"{'stochastic' if stochastic else 'deterministic'}: bitwise "
            f"{bitwise(k, p)}; {share * 100:.4f} % of clusters within 2e-3; "
            f"worst field {worst} (rel {worst_rel:.3g}); max abs diff "
            f"{max_abs:.4g}; mean_parity_violations {viol}")
        if viol:
            fail("mlp full-day mean parity")
    del traces, k, p
    torch.cuda.empty_cache()

    traces = src.batch_trace_device(T_DAY // 10, gen(47), B_MULTI, device=dev)
    stacked = mk._tree_map(lambda x: np.stack([x, 0.5 * np.asarray(x)]), net)
    single = mk.neural_megakernel_rollout_summary(
        params, cfg.cluster, net, traces, seed=9, stochastic=True, device=dev)
    pop = mk.neural_megakernel_rollout_summary(
        params, cfg.cluster, stacked, traces, seed=9, stochastic=True,
        device=dev)
    if tuple(pop.cost_usd.shape) != (2, B_MULTI) \
            or tuple(single.cost_usd.shape) != (B_MULTI,):
        fail("population axis: wrong field shapes")
    if not all(torch.equal(getattr(pop, f)[0], getattr(single, f))
               for f in single._fields):
        fail("population axis: member 0 is not the single run")
    other_member = float((pop.cost_usd[1] - pop.cost_usd[0]).abs().max())
    log(f"# mlp population axis: fields [2, {B_MULTI}], member 0 bitwise "
        f"the single run, member 1 differs in cost_usd by up to "
        f"{other_member:.4g}")
    if other_member <= 0:
        fail("population axis: member 1 equals member 0")
    del traces, single, pop
    torch.cuda.empty_cache()

    clock("5b")
    # ---- 5b. the zero gates, 5c. the widened kernels: see lane_phases.
    lanes_found = lane_phases(dev, setup, hold)

    clock("5e")
    # ---- 5e. the MLP kernel's forward layer by layer: see forward_phase.
    forward_rec = forward_phase(dev, setup)

    clock("6")
    # ---- 6. the rule path at full size
    cfg, src, params, off, peak, _ = setup("default")
    Z = cfg.cluster.n_zones
    ops_tick = {s: float_ops_per_cluster_tick(cfg, s) for s in (False, True)}

    def rule_bound(B: int, ops: int):
        return bound(rollout_bytes(Z, B, T_DAY),
                     {"tick": (ops * B * T_DAY, F32_UNFUSED_OPS_PER_S,
                               "float32")})

    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    zero_counters()
    events[0].record()
    traces = src.batch_trace_device(T_DAY, gen(31), B_MAIN, device=dev)
    events[1].record()
    k_main = mk.megakernel_rollout_summary(params, off, peak, traces,
                                           seed=5, stochastic=True,
                                           device=dev)
    events[2].record()
    events[2].synchronize()
    rule_launches = read_counters()
    synth_ms = events[0].elapsed_time(events[1])
    path_ms = events[1].elapsed_time(events[2])
    log(f"# rule path default B={B_MAIN} T={T_DAY} stochastic: launches "
        f"{rule_launches}; batch_trace_device {synth_ms:.4f} ms, "
        f"megakernel_rollout_summary {path_ms:.4f} ms")
    if rule_launches["rollout_profiles_kernel"] < 1:
        fail("the rule path never launched rollout_profiles_kernel")

    p_main = plain(cfg, params, traces, 5, True, rule_fn(cfg))
    events[3].record()
    events[3].synchronize()
    plain_ms = events[2].elapsed_time(events[3])
    share, worst, worst_rel, main_abs = per_cluster_share(k_main, p_main)
    viol = mk.mean_parity_violations(k_main, p_main)
    log(f"#   kernel vs plain ({plain_ms:.4f} ms): bitwise "
        f"{bitwise(k_main, p_main)}; {share * 100:.4f} % of clusters within "
        f"2e-3; worst {worst} (rel {worst_rel:.3g}); max abs diff "
        f"{main_abs:.4g}; mean_parity_violations {viol}")
    if viol or share < 0.99:
        fail("rule-path kernel and plain version disagree")
    for f in ("cost_usd", "usd_per_slo_hour", "slo_attainment"):
        v = getattr(k_main, f)
        if v.shape != (B_MAIN,) or not torch.isfinite(v).all():
            fail(f"rule-path field {f} malformed")
    log(f"#   fleet means: $/SLO-hr "
        f"{k_main.usd_per_slo_hour.mean().item():.6f}, gCO2/kreq "
        f"{k_main.g_co2_per_kreq.mean().item():.6f}, SLO attainment "
        f"{k_main.slo_attainment.mean().item():.6f}")

    def rule_ms(exo, stochastic: bool) -> float:
        return median_ms(lambda: mk.megakernel_summary_from_packed(
            params, off, peak, exo, T_DAY, seed=5, stochastic=stochastic))

    packed = []
    pack_ms = cuda_ms(lambda: packed.append(mk._pack_exo(traces, T_DAY)))[0]
    exo = packed.pop()
    del traces, p_main
    torch.cuda.empty_cache()
    k_ms = rule_ms(exo, True)
    k_bound, k_by, k_terms = rule_bound(B_MAIN, ops_tick[True])

    def rule_floor(B: int, exo, stochastic: bool) -> float:
        return profiles.issue_floor_ms(
            ("rule", Z, stochastic, False, 0, False), B, T_DAY,
            lambda: mk.megakernel_summary_from_packed(
                params, off, peak, exo, T_DAY, seed=5,
                stochastic=stochastic))

    k_floor = rule_floor(B_MAIN, exo, True)
    log(f"#   _pack_exo {pack_ms:.4f} ms; kernel {k_ms:.4f} ms median of "
        f"{N_TIMED}; bound {k_bound:.4f} ms ({k_by}; terms in ms {k_terms}; "
        f"{rollout_bytes(Z, B_MAIN, T_DAY)} bytes, {ops_tick[True]} float "
        f"ops per cluster-tick); issue floor {k_floor:.4f} ms "
        f"({profiles.loop[('rule', Z, True, False, 0, False)]} SASS "
        f"instructions a tick, {PAIR} lanes a cluster); "
        f"{B_MAIN / (k_ms / 1e3):.1f} cluster-days/s")
    del exo
    torch.cuda.empty_cache()

    clock("7")
    # ---- 7. the three-policy path at full size
    cfg, src, params, off, peak, net = setup("multiregion")
    Zm = cfg.cluster.n_zones
    F, H, A = mk._mlp_dims(net, P=cfg.cluster.n_pools, Z=Zm)[0]
    tick_ops = {name: float_ops_per_cluster_tick(cfg, True, name, net)
                for name in ("rule", "carbon", "mlp")}
    events = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
    torch.cuda.synchronize()
    events[0].record()
    traces = src.batch_trace_device(T_DAY, gen(53), B_MAIN, device=dev)
    events[1].record()
    exo = mk._pack_exo(traces, T_DAY)
    events[2].record()
    del traces
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    zero_counters()
    events[3].record()
    board = {"rule": mk.megakernel_summary_from_packed(
        params, off, peak, exo, T_DAY, seed=5, stochastic=True)}
    events[4].record()
    board["carbon"] = mk.carbon_megakernel_summary_from_packed(
        params, off, peak, exo, T_DAY, seed=5, stochastic=True)
    events[5].record()
    board["flagship"] = mk.neural_megakernel_summary_from_packed(
        params, cfg.cluster, net, exo, T_DAY, seed=5, stochastic=True)
    events[6].record()
    events[6].synchronize()
    launches = read_counters()
    entry_ms = [events[i].elapsed_time(events[i + 1]) for i in range(3, 6)]
    log(f"# three-policy path multiregion B={B_MAIN} T={T_DAY} stochastic: "
        f"launches {launches}; batch_trace_device "
        f"{events[0].elapsed_time(events[1]):.4f} ms, _pack_exo "
        f"{events[1].elapsed_time(events[2]):.4f} ms; the entries (pack "
        f"of params and weights, launch, finalize) rule {entry_ms[0]:.4f} "
        f"ms, carbon {entry_ms[1]:.4f} ms, flagship {entry_ms[2]:.4f} ms")
    for name in ("rollout_profiles_kernel", "rollout_profiles_kernel<CARBON>",
                 "rollout_mlp_kernel"):
        if launches[name] < 1:
            fail(f"the three-policy path never launched {name}")
    for name, s in board.items():
        for f in ("usd_per_slo_hour", "g_co2_per_kreq", "slo_attainment"):
            v = getattr(s, f)
            if v.shape != (B_MAIN,) or not torch.isfinite(v).all():
                fail(f"three-policy field {name}.{f} malformed")
        log(f"#   {name}: $/SLO-hr {s.usd_per_slo_hour.mean().item():.6f}, "
            f"gCO2/kreq {s.g_co2_per_kreq.mean().item():.6f}, SLO "
            f"attainment {s.slo_attainment.mean().item():.6f}")

    # The plain versions on the stream's first T_PARITY ticks, against the
    # kernels re-run there.
    views = mk.unpack_exo(exo, T_PARITY, Zm)
    short = {
        "rule": mk.megakernel_summary_from_packed(
            params, off, peak, exo, T_PARITY, seed=5, stochastic=True),
        "carbon": mk.carbon_megakernel_summary_from_packed(
            params, off, peak, exo, T_PARITY, seed=5, stochastic=True),
        "flagship": mk.neural_megakernel_summary_from_packed(
            params, cfg.cluster, net, exo, T_PARITY, seed=5,
            stochastic=True)}
    checks7 = {}
    for name, action_fn, tol in (
            ("rule", rule_fn(cfg), None),
            ("carbon", carbon_fn(cfg), None),
            ("flagship", mk.kernel_numerics_action_fn(net, cfg.cluster,
                                                      params),
             mk.NEURAL_MEAN_PARITY_TOLERANCES)):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        p = plain(cfg, params, views, 5, True, action_fn)
        t1.record()
        t1.synchronize()
        share, worst, worst_rel, max_abs = per_cluster_share(short[name], p)
        viol = mk.mean_parity_violations(short[name], p, tol)
        checks7[name] = (t0.elapsed_time(t1), max_abs)
        log(f"#   {name} kernel vs plain at T={T_PARITY} "
            f"({checks7[name][0]:.4f} ms): "
            f"bitwise {bitwise(short[name], p)}; {share * 100:.4f} % of "
            f"clusters within 2e-3; worst {worst} (rel {worst_rel:.3g}); "
            f"max abs diff {max_abs:.4g}; mean_parity_violations {viol}")
        if viol:
            fail(f"three-policy path: {name} kernel and plain version "
                 f"disagree")
        del p
    del views, short

    weight_bytes = (F * H + H * H + 2 * H) * 2 + (H * A + A) * 4
    timed = {
        "rule": (
            lambda: mk.megakernel_summary_from_packed(
                params, off, peak, exo, T_DAY, seed=5, stochastic=True),
            bound(rollout_bytes(Zm, B_MAIN, T_DAY),
                  {"tick": (tick_ops["rule"] * B_MAIN * T_DAY,
                            F32_UNFUSED_OPS_PER_S, "float32")})),
        "carbon": (
            lambda: mk.carbon_megakernel_summary_from_packed(
                params, off, peak, exo, T_DAY, seed=5, stochastic=True),
            bound(rollout_bytes(Zm, B_MAIN, T_DAY),
                  {"tick": (tick_ops["carbon"] * B_MAIN * T_DAY,
                            F32_UNFUSED_OPS_PER_S, "float32")})),
        "flagship": (
            lambda: mk.neural_megakernel_summary_from_packed(
                params, cfg.cluster, net, exo, T_DAY, seed=5,
                stochastic=True),
            bound(rollout_bytes(Zm, B_MAIN, T_DAY,
                                weight_bytes=weight_bytes),
                  {"tick": (tick_ops["mlp"] * B_MAIN * T_DAY,
                            F32_UNFUSED_OPS_PER_S, "float32"),
                   "torso": (2 * (F * H + H * H) * B_MAIN * T_DAY,
                             BF16_TENSOR_OPS_PER_S, "tensor cores"),
                   "head": (2 * H * A * B_MAIN * T_DAY, F32_OPS_PER_S,
                            "float32")})),
    }
    main_ms, floors = {}, {}
    for name, (fn, (b_ms, b_by, terms)) in timed.items():
        main_ms[name] = (median_ms(fn), b_ms, b_by)
        floor = ""
        if name != "flagship":
            floors[name] = profiles.issue_floor_ms(
                (name, Zm, True, False, 0, False), B_MAIN, T_DAY, fn)
            floor = f"; issue floor {floors[name]:.4f} ms"
        log(f"#   {name} kernel {main_ms[name][0]:.4f} ms median of "
            f"{N_TIMED}; bound {b_ms:.4f} ms ({b_by}; terms in ms {terms}; "
            f"{tick_ops['mlp' if name == 'flagship' else name]} float ops "
            f"per cluster-tick outside the products){floor}; "
            f"{B_MAIN / (main_ms[name][0] / 1e3):.1f} cluster-days/s")
    del exo, board
    torch.cuda.empty_cache()

    clock("8")
    # ---- 8. the rule kernel across fleet sizes, on prefixes of one stream
    cfg, src, params, off, peak, _ = setup("default")
    traces = src.batch_trace_device(T_DAY, gen(37), max(SWEEP), device=dev)
    exo_all = mk._pack_exo(traces, T_DAY)
    del traces
    torch.cuda.empty_cache()
    for B in SWEEP:
        exo = exo_all[:, :, :B].contiguous()
        for stochastic in (False, True):
            ms = rule_ms(exo, stochastic)
            b_ms, b_by, _ = rule_bound(B, ops_tick[stochastic])
            key = ("rule", Z, stochastic, False, 0, False)
            log("# sweep " + json.dumps({
                "B": B, "T": T_DAY, "stochastic": stochastic, "ms": ms,
                "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms,
                "issue_floor_ms": rule_floor(B, exo, stochastic),
                "cluster_days_per_s": B / (ms / 1e3),
                "threads_per_cluster": PAIR,
                "warps_per_sm": PAIR * B / 32 / props.multi_processor_count,
                "resident_warps_per_sm": profiles.resident_warps_per_sm(
                    key, B),
                "registers": profiles.regs[key]}))
        del exo
    del exo_all
    torch.cuda.empty_cache()

    clock("9")
    # ---- 9. the fault and workload boards at full size: see board_phase.
    boards = board_phase(dev, setup, zero_counters, read_counters)
    torch.cuda.empty_cache()

    clock("10")
    # ---- 10. carried-state streaming: see carry_phase, streaming_phase.
    carry_found = carry_phase(dev, setup)
    stream_rec = streaming_phase(dev, setup, carry_found)

    clock("11")
    # ---- 11. the training path: see training_phase.
    train_rec = training_phase(dev, setup, hold, plain, rule_fn, carbon_fn,
                               zero_counters, read_counters)

    clock("12")
    # ---- 12. the closed control loop on the card: see loop_phase.
    loop_rec = loop_phase(dev, smi)
    log(f"# phase 12 record: {json.dumps(loop_rec['recovery'])}")

    clock("13")
    # ---- 13. the command line on the card: see cli_phase.
    cli_rec = cli_phase(dev, smi, hold, plain, zero_counters, read_counters)
    cli_paths = {
        "rollout_profiles_kernel": {
            f"command line simulate {p} (phase 13b)":
                cli_rec["launches"][f"simulate {p}"]
            for p in ("rule", "neutral")},
        "rollout_profiles_kernel<CARBON>": {
            "command line simulate carbon (phase 13b)":
                cli_rec["launches"]["simulate carbon"]}}
    cli_paths["rollout_profiles_kernel"]["command line preroll (phase "
                                         "13a)"] = cli_rec["launches"][
                                             "preroll"]

    clock("14")
    # ---- 14. the fleet and replay on the card: see replay_phase,
    # fleet_phase, ledger_phase.
    t14 = time.perf_counter()
    replay_rec = replay_phase(dev, setup, hold, plain, rule_fn, carbon_fn,
                              zero_counters, read_counters)
    fleet_rec = fleet_phase(dev, smi)
    ledger_rec = ledger_phase(dev)
    log(f"# phase 14: {time.perf_counter() - t14:.1f} s (14a "
        f"{replay_rec['seconds']:.1f}, 14b {fleet_rec['seconds']:.1f}, 14c "
        f"{ledger_rec['seconds']:.1f})")

    clock("15")
    # ---- 15. the multi-tenant service on the card: see service_phase.
    service_rec = service_phase(dev, smi)

    clock("16")
    # ---- 16. geo arbitrage on the card: see geo_phase.
    geo_rec = geo_phase(dev, smi, setup, hold, plain, rule_fn, carbon_fn)

    clock("17")
    # ---- 17. the scenario axis and the search on the card: see
    # search_phase.
    search_rec = search_phase(dev, smi, hold)

    clock("18")
    # ---- 18. the flywheel on the card: see flywheel_phase.
    flywheel_rec = flywheel_phase(dev, smi)

    clock("19")
    # ---- 19. the device mesh: see mesh_phase.
    mesh_rec = mesh_phase(dev, smi, setup)

    clock("20")
    # ---- 20. the kernels, the card, the result
    def train_paths(name: str) -> dict:
        return {"CEM generations (phase 11b)":
                    train_rec["cem"]["launches"][name],
                "train_flagship (phase 11e)":
                    train_rec["flagship"]["launches"][name]}

    def replay_paths(name: str) -> dict:
        return {"replayed day (phase 14a)": replay_rec["launches"][name],
                "replay CEM generations (phase 14a)":
                    replay_rec["cem_launches"][name]}

    kernels = [
        {"name": "rollout_profiles_kernel", "route": "cuda",
         "source": "ccka_tpu_torch/csrc/rollout_profiles.cu",
         "replaces": "ccka_tpu/sim/megakernel.py:1010",
         "launches": rule_launches["rollout_profiles_kernel"],
         "launches_by_path": {
             "rule path (phase 6)": rule_launches["rollout_profiles_kernel"],
             "three-policy path (phase 7)":
                 launches["rollout_profiles_kernel"],
             **train_paths("rollout_profiles_kernel"),
             **cli_paths["rollout_profiles_kernel"],
             **replay_paths("rollout_profiles_kernel"),
             "streamed replayed day (phase 14a), by instantiation":
                 replay_rec["carry_launches"],
             "replayed day through the streaming pipeline (phase 14a), "
             "by instantiation": replay_rec["streaming_launches"]},
         "max_abs_err": main_abs, "ms": k_ms, "plain_ms": plain_ms,
         "bound_ms": k_bound, "bound_by": k_by, "library_ms": None,
         "issue_floor_ms": k_floor,
         "shape": f"default B={B_MAIN} T={T_DAY} stochastic (phase 6): "
                  f"launches, max_abs_err, ms, plain_ms and bound_ms are "
                  f"all of that path",
         "three_policy_path": {
             "shape": f"multiregion B={B_MAIN} T={T_DAY} stochastic "
                      f"(phase 7)",
             "launches": launches["rollout_profiles_kernel"],
             "max_abs_err": checks7["rule"][1], "ms": main_ms["rule"][0],
                 "plain_ms": checks7["rule"][0],
             "plain_shape": f"multiregion B={B_MAIN} T={T_PARITY}",
             "bound_ms": main_ms["rule"][1],
             "bound_by": main_ms["rule"][2],
             "issue_floor_ms": floors["rule"]}},
        {"name": "philox_uniform_kernel", "route": "cuda",
         "source": "ccka_tpu_torch/csrc/rollout_profiles.cu",
         "replaces": "ccka_tpu/sim/megakernel.py:228",
         "launches": philox_launches,
         "launches_from": "phase 3, the bitwise check: the kernel is on no "
                          "rollout path (0 launches in phases 6 and 7)",
         "launches_by_path": {
             "rule path (phase 6)": rule_launches["philox_uniform_kernel"],
             "three-policy path (phase 7)":
                 launches["philox_uniform_kernel"]},
         "max_abs_err": philox_abs, "ms": ph_ms, "plain_ms": ph_plain_ms,
         "bound_ms": ph_bound, "bound_by": ph_by, "library_ms": None},
        {"name": "rollout_profiles_kernel<CARBON>", "route": "cuda",
         "source": "ccka_tpu_torch/csrc/rollout_profiles.cu",
         "replaces": "ccka_tpu/sim/megakernel.py:456",
         "launches": launches["rollout_profiles_kernel<CARBON>"],
         "launches_by_path": {
             "three-policy path (phase 7)":
                 launches["rollout_profiles_kernel<CARBON>"],
             **train_paths("rollout_profiles_kernel<CARBON>"),
             **cli_paths["rollout_profiles_kernel<CARBON>"],
             **replay_paths("rollout_profiles_kernel<CARBON>")},
         "max_abs_err": checks7["carbon"][1], "ms": main_ms["carbon"][0],
         "plain_ms": checks7["carbon"][0], "bound_ms": main_ms["carbon"][1],
         "bound_by": main_ms["carbon"][2], "library_ms": None,
         "issue_floor_ms": floors["carbon"],
         "shape": f"multiregion B={B_MAIN} T={T_DAY} stochastic (phase 7)",
         "plain_shape": f"multiregion B={B_MAIN} T={T_PARITY}"},
        {"name": "rollout_mlp_kernel", "route": "cuda",
         "source": "ccka_tpu_torch/csrc/rollout_mlp.cu",
         "replaces": "ccka_tpu/sim/megakernel.py:1144",
         "launches": launches["rollout_mlp_kernel"],
         "launches_by_path": {
             "three-policy path (phase 7)": launches["rollout_mlp_kernel"],
             **train_paths("rollout_mlp_kernel"),
             **replay_paths("rollout_mlp_kernel")},
         "population_launch": {
             "shape": f"multiregion NP={TRAIN_POP} members x G={TRAIN_G} "
                      f"traces x T={T_DAY} stochastic, a CEM generation "
                      f"(phase 11b)",
             "launches": train_rec["cem"]["launches"]["rollout_mlp_kernel"],
             "ms": train_rec["cem"]["population_ms"],
             "bound_ms": train_rec["cem"]["population_bound_ms"],
             "bound_by": train_rec["cem"]["population_bound_by"],
             "plain_ms": train_rec["cem"]["population_plain_s"] * 1e3,
             "plain_shape": f"NP={TRAIN_POP} x G={TRAIN_G} x T={T_POP}",
             "max_abs_err": train_rec["cem"]["population_max_abs_err"]},
         "max_abs_err": checks7["flagship"][1],
         "ms": main_ms["flagship"][0], "plain_ms": checks7["flagship"][0],
         "bound_ms": main_ms["flagship"][1],
         "bound_by": main_ms["flagship"][2], "library_ms": None,
         "shape": f"multiregion B={B_MAIN} T={T_DAY} stochastic, F={F} "
                  f"H={H} A={A}, one member (phase 7)",
         "plain_shape": f"multiregion B={B_MAIN} T={T_PARITY}"},
        forward_rec,
        {"name": "rollout_profiles_kernel<PLAN>", "route": "cuda",
         "source": "ccka_tpu_torch/csrc/rollout_profiles.cu",
         "replaces": PLAN_REPLACES,
         "launches": plan_rec["launches"],
         "launches_from": "phase 4b, its checks: the boards' streams carry "
                          "lanes, so their mpc rows run the lane "
                          "instantiations below, and the factory's "
                          "playback (phase 11d) the CARRY ones",
         "launches_by_path": {
             "factory playback (phase 11d), by instantiation":
                 {k: v for k, v in train_rec["factory"]["launches"].items()
                  if "PLAN" in k}},
         "max_abs_err": plan_rec["max_abs_err"], "ms": plan_rec["ms"],
         "plain_ms": plan_rec["plain_ms"], "bound_ms": plan_rec["bound_ms"],
         "bound_by": plan_rec["bound_by"], "library_ms": None,
         "issue_floor_ms": plan_rec["issue_floor_ms"],
         "bitwise": plan_rec["bitwise"],
         "shape": f"multiregion B={B_MAIN} T={T_DAY} stochastic, a random "
                  f"per-cluster plan (phase 4b)",
         "plain_shape": f"multiregion B={B_MULTI} T={T_PARITY} stochastic"},
    ] + lane_kernel_rows(boards, lanes_found) + carry_kernel_rows(
        carry_found, stream_rec)
    for row in kernels:
        wide = replay_rec["wide"].get(row["name"])
        if wide is not None:
            row.setdefault("launches_by_path", {})[
                "widened replayed day (phase 14a)"] = replay_rec[
                    "wide_launches"][row["name"]]
            row["replayed"] = dict(wide, shape=f"default B={B_MAIN} "
                                   f"T={T_DAY} stochastic, the replayed "
                                   f"store with mild faults and the mixed "
                                   f"families (phase 14a)")
    names = {row["name"] for row in kernels}
    for path, counts in geo_rec["launches_by_path"].items():
        missing = set(counts) - names
        if missing:
            fail(f"phase 16 launched {sorted(missing)}, which the kernels "
                 f"line has no row for")
        for row in kernels:
            if row["name"] in counts:
                row.setdefault("launches_by_path", {})[path] = counts[
                    row["name"]]
    for path, counts in search_rec["launches_by_path"].items():
        missing = set(counts) - names
        if missing:
            fail(f"phase 17 launched {sorted(missing)}, which the kernels "
                 f"line has no row for")
        for row in kernels:
            if row["name"] in counts:
                row.setdefault("launches_by_path", {})[path] = counts[
                    row["name"]]
    for path, counts in flywheel_rec["launches_by_path"].items():
        missing = set(counts) - names
        if missing:
            fail(f"phase 18 launched {sorted(missing)}, which the kernels "
                 f"line has no row for")
        for row in kernels:
            if row["name"] in counts:
                row.setdefault("launches_by_path", {})[path] = counts[
                    row["name"]]
    for path, counts in mesh_rec["launches_by_path"].items():
        missing = set(counts) - names
        if missing:
            fail(f"phase 19 launched {sorted(missing)}, which the kernels "
                 f"line has no row for")
        for row in kernels:
            if row["name"] in counts:
                row.setdefault("launches_by_path", {})[path] = counts[
                    row["name"]]
    for row in kernels:
        if row["name"] in search_rec["kernels"]:
            row["search"] = dict(
                search_rec["kernels"][row["name"]],
                shape=f"default B={SEARCH_POP} x {SEARCH_INNER} T={T_DAY} "
                      f"stochastic, the scenario population stream (phase "
                      f"17b)")
    for row in kernels:
        if row["name"] in geo_rec["kernels"]:
            row["geo"] = dict(geo_rec["kernels"][row["name"]],
                              shape=f"multiregion B={B_MAIN} T={T_DAY} "
                                    f"stochastic on the region-widened "
                                    f"stream (phase 16a)")
    log(f"# build {build_s:.2f} s; total {time.perf_counter() - t_start:.1f}"
        f" s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
