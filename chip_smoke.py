#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one H100.

    python3 chip_smoke.py [--profile]

1. Builds the Hopper kernels from `src/repro_torch/kernels/csrc` with
   nvcc (one process per source, all at once) and prints the build time
   and each source's registers and spills.
2. Holds every kernel against its plain PyTorch version on the card, at
   the shapes its path gives it: `edge_rounds` (K1) on sw_1000's padded
   tiles, on random DAG tiles and on the seven solves of the sparse main
   path's first iteration (operands recorded from `core.run`),
   `edge_rounds_bucketed` (K2) on ba_10000's degree buckets (also
   against K1 on the same problem; each K1 and K2 record carries the
   cluster of CTAs a task row got), `simplex_project` (K3) on both
   scenarios' data and result rows under a random mask, on the two
   QPs of each main path's first iteration and on those of the dense
   engine's first iteration on sw_1000 ([64,000, 1,001]: K = V + 1) and
   sw_queue ([12,000, 101]), both bit for bit with equal
   rounds (K1, K2) or to atol 1e-5 with every row summing to 1 or all
   zero (K3; its bound counts 5 bytes a coordinate and 12 more a
   permitted one); `flash_attention` (K4) on Qwen3-0.6B's prefill,
   q [1, 16, L, 128] against k, v [1, 8, L, 128], causal, L in {17, 128,
   333, 512}, on OLMoE's, k, v [1, 16, L, 128], L in {17, 333, 512}, on
   Qwen2-VL-7B's, q [1, 28, L, 128] against [1, 4, L, 128], L in {333,
   512}, and on whisper-base's (8 heads, hd 64): the encoder [1, 8,
   1500, 64] non-causal, the decoder causal at L in {333, 512} and the
   cross attention, q [1, 8, L, 64] against k, v [1, 8, 1500, 64]
   non-causal, L in {17, 333, 512} (off the path: hd 80 causal and on
   cross lengths); `decode_attention` (K5) on their decode steps, q [8,
   8, 2, 128] against [8, 1024, 8, 128] caches and q [8, 16, 1, 128]
   against [8, 1024, 16, 128], with ragged lengths from 1 to 1024,
   every length 1, every length 1024, and one request (B = 1) of length
   1024, Qwen2-VL's q [8, 4, 7, 128] against [8, 1024, 4, 128] and
   whisper's self attention q [8, 8, 1, 64] against [8, 1024, 8, 64] at
   the ragged lengths, and its cross attention against [8, 1500, 8, 64]
   at every length 1,500 (and off the path at hd 50, G = 3), all in
   float32 (rtol = atol = 2e-4) and bfloat16 (2e-2), then K5, K4 and K4
   on cross lengths captured in one CUDA graph and replayed on new
   inputs and lengths (2e-2); `ssd_scan`
   (K6) on Mamba2-130M's prefill, x [B, L, 24, 64], dt [B, L, 24], A
   [24], B/C [B, L, 128], L in {17, 128, 256, 512} at B = 1 and L = 256
   at B = 4, float32 and bfloat16, the serve's short prompts (L 25 and
   63) in bfloat16, and from an initial state at B = 2, L = 128 float32
   and B = 1, L = 512 and B = 2, L = 1280 bfloat16, plus two ragged
   shapes off the path (N 20 and 256, P 40 and 136): y to 1e-4 (float32)
   or 1e-2 (bfloat16, one ulp) and the final state to 1e-4, each with
   its kernel launches a call; `moe_gmm` (K7) on OLMoE's expert
   products, [64, C, 2048] @ [64, 2048, 1024] and [64, C, 1024] @ [64,
   1024, 2048] at C in {4, 52, 80}, plus two ragged shapes, in float32
   (rtol 1e-5 of Σ|x·w|) and bfloat16 (one ulp), at C = 4 also with 40
   of 64 experts `active` (equal to the dense kernel bit for bit), and
   one launch with `active` replayed from a CUDA graph on new inputs
   and active sets.
   Prints the times of each, and for K4 and K5 that of PyTorch's
   scaled_dot_product_attention, for K7 that of torch.bmm, on the same
   inputs as a yardstick (no PyTorch call computes K6's function); K1,
   K3 and K4–K7 are timed by the profiler's device time (for K4 and K5
   CUDA events around the run are printed beside it, and the kernel's
   ratio to SDPA), K2 by CUDA events.
3. Drives the sparse main path, Algorithm 1 for 20 iterations: sw_1000
   padded (K1 + K3) and ba_10000 bucketed (K2 + K3), each under both
   drivers (`init_run_state` + `run_chunk`): the host loop, and the
   fused driver, whose iteration is one CUDA graph captured once and
   replayed.  The launch counts must be 2 + 5·n and 2·n for the n
   iterations dispatched (the fused driver's counted through its
   replays), every cost finite and non-increasing, the accepted costs
   equal to the JAX reference's golden trajectory (`src/repro_torch/
   data/reference_costs.json`) to rtol 2e-4, and the fused run equal to
   the host run bit for bit (costs, rejections, final φ).  Then the
   options path: the same two scenarios under `scaling="paper",
   refresh_every=5` (κ = 1, so each iteration also solves the stacked
   longest-path recursion, K1 / K2 with `max, shift=1`): 2 + 6·n
   recursion launches, both drivers against the goldens `sw_1000_paper`
   and `ba_10000_paper` and bit for bit against each other.  Each
   record carries its driver and ms an iteration, the fused ones the
   graph's capture seconds and pool bytes; both drivers are then timed
   again in alternating rounds.  The longest-path solves of the options
   path's first iteration (operands recorded from `run_chunk`) are held
   against their plain versions and timed, and a traced 3-iteration run
   of each path gives K1, K2 and K3's device time a launch (and each
   kernel instantiation's) on the path's own inputs.
   The `paper` phase then runs the reference's default engine, the
   dense one (`method="dense"`, fused driver: one CUDA graph an
   iteration with the LU solves on cuSOLVER / cuBLAS), as the paper's
   evaluation does, held to the JAX goldens of `src/repro_torch/data/
   reference_paper.json` (final costs, totals, L_data and L_result to
   rtol 1e-4): Fig. 4 (`run_all`'s four algorithms, 250 iterations, on
   the eight Table II scenarios; SGP's wins and mean ratio to the best
   baseline as benchmarks/fig4_totalcost.py derives them), Fig. 5c
   (connected_er at rate_scale 0.6-1.8, 200 iterations), Fig. 5b (SGP
   and GP with β = 0.3 for 100 iterations, `fail_node` of the largest
   compute node, `refeasibilize`, 120 more; every accepted cost to rtol
   1e-3, the recovery iterations equal), Fig. 5d (a_m from 0.2 to 4,
   200 iterations) and abilene's optimality after 300 iterations
   (Theorem 1's residual < 0.05, loop-free, the final cost within 1.01
   of the port's `flow_domain_optimum`, which is held to the golden's,
   `marginals_vs_autodiff` < 1e-4); the fused driver bit for bit the
   host driver on the dense and broadcast engines; at sw_1000 the dense
   engine for 20 iterations against its `reference_costs.json` golden
   (K3 at K = 1001; its taint closure and LU solve timed alone), and
   `run_spoo`, `run_lcor` and SGP on the sparse engine for 200
   iterations (K1 and K3) with `run_lpr`'s greedy branch, SGP's final φ
   loop-free.  Each record carries its seconds, ms an iteration and
   launches; the phase its seconds.
   The `replay` phase then runs churn replay (`core.ReplayEngine`) at the
   reference's sizes, against `src/repro_torch/data/
   reference_replay.json` (the JAX `ReplayEngine`): `sw_1000_churn`
   (padded: K1 + K3), `ba_1000_churn` (bucketed: K2 + K3) and
   `sw_1000_taskchurn` (a task pool: arrivals, a departure, a recycled
   slot), the canned schedules of `scenarios.churn_schedule`.  Each row's
   event loop checks the invariants after every event and is held to
   the golden: the same events, segment lengths and accepted steps,
   costs to rtol 2e-4, segment costs that never rise, the admissions;
   the churn rows run again with the cold baseline (warm and cold
   iterations-to-target equal to the golden's); the fused stream (one
   CUDA graph a same-graph window, `FusedStream.rebaseline` between
   events) must equal the event loop bit for bit (costs, final φ,
   records), and the task row's inactive rows must be exactly inert.
   Then `ba_10000_churn` (bucketed, no golden), stream against loop bit
   for bit with the invariants at the end.  Each record carries the
   launches of every run (K1 or K2, and K3, each above 0), the graphs'
   captures and capture seconds an event, the SPT cache's hits, the
   host's `refeasibilize_sparse` ms after the hub failure, and ms an
   event and an iteration of loop and stream in alternating rounds
   (median and spread).
   The `robust` phase then runs fault injection, guards and the fleet
   (`core.faults`, `core.guards`, `core.fleet`) under the fused driver:
   on sw_1000 (K1 + K3) and ba_10000 (bucketed, K2 + K3), 20 iterations
   a run, the inert plan (participation 1.0, dropout 0.0, corruption
   0.0) and a guarded fault-free run each equal the plain run bit for
   bit, a faulted run (participation 0.5, staleness 2, dropout 0.2) in
   four chunks equals the whole one (its fault generator too), each
   run's K1 / K2 and K3 launches are counted through the replays, and
   plain, faulted and guarded runs are timed in alternating rounds
   (median and spread, the graphs' launches a replay and pool bytes);
   participation 0.5 with staleness 3 for 60 iterations ends within 1 %
   of the synchronous 30 on sw_queue and ba_1000 (the reference's rows;
   the ratio recorded ungated at sw_1000 and ba_10000); sw_1000 under 20
   % corruption with guards (checkpoints every 2, 64 retries) rolls back
   and keeps a finite iterate and costs, with no fewer corruptions than
   trips, and under 100 % without guards ends poisoned; a fleet of 8
   sw_1000 lanes (rates, destinations and result ratios perturbed from
   seed 0) replays one CUDA graph an iteration, each lane bit for bit
   its solo fused run, timed against the eight solo runs' sum.
   The `distributed` phase then runs the task-sharded driver
   (`core.distributed`) on a world of one over NCCL (`core.task_mesh()`,
   an in-process store): sw_1000 padded (K1 + K3) and ba_10000 bucketed
   (K2 + K3) under both drivers, 20 iterations, each run bit for bit the
   single-process `run_chunk` of the same driver (the fused one replays
   one CUDA graph an iteration with the all-reduce of F / G inside it),
   with its ms an iteration beside the single-process run's, its
   launches and the collective's ms alone; a faulted (participation 0.5,
   staleness 2, dropout 0.2) and a guarded (20 % corruption) sw_1000 run
   each bit for bit its single-process run; a zero-event
   `ReplayEngine(driver="distributed")` equal to `run_distributed`; the
   node-sharded measurement on a (1, 1) mesh bit for bit
   `flows_carry_and_cost`; then two processes on the one card over gloo
   (`--distributed-worker`, host driver): abilene cut to S = 9 (one
   padding task) on the sparse and dense engines held to the reference's
   2-device run (`reference_distributed.json`, costs at rtol 2e-4, φ at
   atol 1e-4) and sw_1000 held to the world of one's accepted costs at
   rtol 2e-4, both ranks alike.
   The `router` phase then runs the SGP request router at `router_256`
   (`serving.router.router_256`: 16 frontends, 256 pods, V = 273, 16
   classes in a pool of 32 slots, Dmax 257) against the JAX router's run
   (`reference_router.json`): plan(150) under the fused driver (accepted
   costs at rtol 2e-4, the same rejections), bit for bit the host
   driver's and `plan(distributed=True)`'s; K1 at the router's [32, 273,
   257] tiles against its plain version; a stream of 100,000 requests
   drawn from the demand mix (tokens poisson(20) + 1) through `observe`
   and sampled `decide`, µs a request, the pods' pick frequencies within
   3 Σ_p sqrt(q_p (1 − q_p) / n) in L1 of the plan's dispatch shares q;
   `greedy_plan` costlier than the plan and equal to the golden's; the
   busiest pod's failover (150 warm iterations) and a drift (one class
   at 1.5×, one new class admitted into slot 16 through
   `maybe_rebaseline`) held to the golden, each with its launches.
4. Serves Qwen3-0.6B (28 layers), then Mamba2-130M (24 layers), at full
   width through `ServingEngine`, random weights from SERVE_SEED: 12
   requests on 8 slots, max_len 1024, 32 new tokens (Mamba2's prompts
   are 16-256 tokens, two of them 512: the chunk contract).  In float32
   (TF32 off) the tokens must equal the JAX engine's
   (`src/repro_torch/data/reference_serve.json`,
   `reference_serve_mamba2.json`) and the logits at its top-5 indices
   hold to rtol 1e-3; a token may differ only where the stored top-2
   margin is under that tolerance, and the request's comparison stops
   there.  In bfloat16 the same requests run through the kernels,
   timed: per layer one K4 launch per prefill and one K5 per decode
   step (Qwen3), one K6 per prefill and none per decode step (Mamba2),
   no other kernel, every request done with the output length its
   budget and EOS dictate; prints prefill ms per request, decode ms per
   step, tokens/s and peak memory.  Then, with every logits row kept,
   they run through the kernels again (the same tokens), with the plain
   versions forced (`impl="ref"`), and with the witness: the plain
   versions taking their float32 sums in another order (attention over
   the keys in reverse order; the SSD as `ssd_sequential`, token by
   token).  At the prefill and at each decode step until the tokens
   part, the kernels' logits may be no further from the plain run's
   than 1.5 times the witness's, in max abs and in relative L2; whether
   they are within 2e-2 is printed.
5. Serves OLMoE-1B-7B at full width, the same requests and settings,
   with the router's load EMAs as the model state.  Float32 at
   OLMOE_F32_LAYERS layers against `reference_serve_olmoe.json`, call
   by call in the engine's order; the EMAs are engine-global, so the
   first call that fails ends the comparison and passes only at a
   routing near-tie (the call's smallest gap between a token's K-th
   and (K+1)-th selection logits under 1e-4 of max(1, |K-th|)) or a
   top-2 near-tie; with none the final EMAs hold to rtol 1e-5.  The
   smallest router gap of the run is printed.  Bfloat16 at all 16
   layers, weights drawn on the card with a torch.Generator: per layer
   one K4 and three K7 per prefill, one K5 and three K7 per decode
   step; then the plain versions choose the tokens and at every call
   the kernels and the witness (keys and the gmm's D reversed) take the
   same inputs, the kernels held to 1.5 times the witness's distance.
   Then whisper-base at full width (6 + 6 layers, 1,500 frames), the
   same requests and settings, the engine feeding zero frame features:
   float32 against `reference_serve_whisper.json` as in 4., then the
   golden's random-feature record (prompts of 333 and 64 tokens
   prefilled into two lanes on frame features from
   RandomState(SERVE_SEED).standard_normal([2, 1500, 512]), 16 greedy
   decode steps) under the same rule at rtol 1e-2 (rounding alone moves
   these logits by up to ~5e-3) or, where more, three times the run's
   own move on the features one ulp up; bfloat16 through the kernels,
   the plain versions and the witness (keys and head dims reversed: the
   scores of these models without qk-norm reach the hundreds) in the
   engine and on the random features, held at 1.5 times the witness's
   distance; per decoder layer three K4 per prefill (its self and cross
   attention and its encoder layer's) and two K5 per decode step.  Then
   Qwen2-VL-7B (M-RoPE): float32 at VLM_F32_LAYERS of 28 layers against
   `reference_serve_qwen2vl.json`, bfloat16 at all 28 with weights drawn
   on the card, one K4 per layer a prefill and one K5 a decode step,
   held to the same witness.  Each serve prints tokens/s, prefill ms a
   request, decode ms a step and peak memory.
6. The `train` phase (`"phase": "train"` records, ~70 s; it runs after
   the `router` phase and before the serves of 4. and 5., whose models
   stay in memory for --profile): K4's backward
   (`flash_attention_bwd.cu`, three launches a call; bfloat16 at hd 64
   and 128 on the tensor cores) against the
   gradient of K4's plain version under autograd at the training
   shapes, Qwen3-0.6B's q [8, 16, 512, 128] against [8, 8, 512, 128]
   causal on packed segments, Qwen2-VL-7B's [2, 28, 512, 128] against [2,
   4, 512, 128] (G = 7), whisper-base's encoder [8, 8, 1500, 64], decoder
   [8, 8, 128, 64] causal on packed segments and cross attention at L
   in {17, 333, 512} against 1,500 frames, float32
   to K4_BWD_RTOL of each gradient's largest magnitude and bfloat16
   within 1.5x the witness's bfloat16 ulps (keys and head dims
   reversed), each call twice bit for bit, the forward it takes (output,
   float32 output, log-sum-exp) held against the plain version; K7's
   backward (two more K7
   launches: dx = K7(dy, wᵀ), dw = K7(xᵀ, dy)) at OLMoE's [64, C, 2048]
   @ [64, 2048, 1024], C 80 (40 of 64 experts active) and 640, float32
   to 1e-5 of Σ|·| and bfloat16 by the same ulp rule; each record with
   ms, the bound, the plain version's ms and, as yardsticks, SDPA's
   backward alone (K4's library time) and its forward + backward, or
   two torch.bmm calls.  Then the training path,
   `train.build_train_step` over `LM.loss` / `EncDecLM.loss` at full
   width: Qwen3-0.6B in float32 at 4 of 28 layers, 3 AdamW steps of 2 x
   128 packed tokens, the losses, gradient norms and learning rates held
   to the JAX train step's (`reference_train.json`) at TRAIN_F32_RTOL;
   Qwen3-0.6B in bfloat16 (28 layers, 4 steps of 8 x 512), OLMoE-1B-7B
   (2 layers, 2 steps, `moe_ep_scatter` off and on) and whisper-base (2
   steps of 8 x 128 tokens on 1,500 random frames) through the kernels,
   the plain versions and three witnesses, each gap held on its own
   within 1.5x the largest witness gap from plain (`train_gap_rule`):
   step 1's loss in every run, the later steps' losses and gradient
   norms with Qwen3, Qwen3's step-1 gradient leaf by leaf
   (`leaf_gap_rule`); whisper-base again in bfloat16 from a start whose
   stacked leaves take a per-layer fan-in (`per_layer_fan_in`; its
   largest score recorded beside the parity start's), its step-1
   gradient leaf by leaf; whisper-base's and OLMoE's step-1 gradient in
   float32 (`f32_step1_check`: loss, norm and leaves), where rounding
   neither saturates whisper's softmax into flips nor flips OLMoE's
   routes; the expert-parallel OLMoE's step-1 loss and gradient
   computed twice, bit for bit; each
   kernel run launches K4 twice a layer a step (the remat recomputes
   it), K4's backward once, with MoE K7 and its backward six times a
   layer a step, and calls no plain version.  Prints ms a step, tokens/s,
   the host's idle share and peak memory.
7. Prints one `kernels` JSON line (K4's and K5's launches summed over
   the four attention serves' bfloat16 kernel runs and the train
   phase's, K4's and K7's backward the train phase's) and, last, the
   device line.

With `--profile` it also traces one more 20-iteration run of each sparse
path (both scenarios, default and paper options) under each driver,
the `robust` phase's plain, faulted and guarded fused runs of each,
and one bfloat16 serve of each of the five models, with torch.profiler
and prints the device time by kernel and the device's busy share (not
part of the checks above).

Exits non-zero on any failure, and when no CUDA device is present.
Every earlier line is a JSON record, except the nvidia-smi line.
"""
import contextlib
import dataclasses
import gc
import inspect
import itertools
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N_ITERS = 20
PATHS = (("sw_1000", False), ("ba_10000", True))   # (scenario, bucketed)
DRIVERS = ("host", "fused")
# the options path's run options (its goldens: "<scenario>_paper")
PAPER_OPTS = {"scaling": "paper", "refresh_every": 5}
# (label, run options, recursion launches an iteration beyond the 2 of φ⁰)
PATH_OPTIONS = (("default", {}, 5), ("paper", PAPER_OPTS, 6))
TIMING_ROUNDS = 3
# published H100 SXM peaks (dense): HBM3 bytes/s, float32 outside the
# tensor cores; the card's power limit is printed beside them
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
# the serving phases: Qwen3-0.6B at full width, the requests and the
# reference tokens and logits of src/repro_torch/data/reference_serve.json
SERVE_ARCH = "qwen3-0.6b"
SERVE_SEED = 0
SERVE_REQUESTS = 12
SERVE_CONFIG = {"max_slots": 8, "max_len": 1024, "max_new_tokens": 32,
                "eos_id": 1}
# the Mamba2 serving phases: mamba2-130m at full width, the same seed and
# engine settings, the requests of reference_serve_mamba2.json
MAMBA_ARCH = "mamba2-130m"
MAMBA_REQUESTS = 12
# the chunk of K6's operation count in bound_ms, fixed at the chunked
# SSD's 64 so that the bound counts the same work whatever chunk the
# kernel runs
SSD_BOUND_CHUNK = 64
# the OLMoE serving phases: olmoe-1b-7b at full width, the same seed,
# engine settings and request recipe; float32 at OLMOE_F32_LAYERS layers
# against reference_serve_olmoe.json, bfloat16 at all 16
OLMOE_ARCH = "olmoe-1b-7b"
OLMOE_REQUESTS = 12
OLMOE_F32_LAYERS = 4
# the whisper serving phases: whisper-base at full width (6 + 6 layers,
# 1,500 frames), the same seed, engine settings and request recipe, the
# engine's zero frame features; float32 against
# reference_serve_whisper.json, whose second record is two prompts on
# random features decoded WHISPER_FEAT_STEPS greedy steps
WHISPER_ARCH = "whisper-base"
WHISPER_REQUESTS = 12
WHISPER_FEAT_STEPS = 16
# the random-feature record's top-5 rtol: float32 rounding alone moves
# this random model's logits there by up to ~5e-3 (ROADMAP §3)
WHISPER_FEAT_RTOL = 1e-2
# the VLM serving phases: qwen2-vl-7b (M-RoPE) at full width, the same
# seed, settings and requests; float32 at VLM_F32_LAYERS layers against
# reference_serve_qwen2vl.json, bfloat16 at all 28, weights drawn on the
# card
VLM_ARCH = "qwen2-vl-7b"
VLM_REQUESTS = 12
VLM_F32_LAYERS = 4
# the train phase: Qwen3-0.6B at full width in float32 at TRAIN_F32_LAYERS
# of 28 layers, TRAIN_F32_STEPS steps of TRAIN_F32_BATCH x TRAIN_F32_SEQ
# packed tokens under AdamW at TRAIN_OPT, against the JAX train step's
# losses, gradient norms and learning rates (reference_train.json,
# tests/test_torch_train.py --write-golden); then bfloat16 through the
# kernels against the plain versions and a witness: Qwen3-0.6B (28
# layers) TRAIN_BF16_STEPS steps of TRAIN_BF16_BATCH x TRAIN_BF16_SEQ,
# OLMoE-1B-7B at TRAIN_MOE_LAYERS layers and whisper-base (decoder
# sequence TRAIN_ENCDEC_SEQ against 1,500 frames), each a few steps
TRAIN_ARCH = "qwen3-0.6b"
TRAIN_SEED = 0
TRAIN_F32_LAYERS = 4
TRAIN_F32_BATCH, TRAIN_F32_SEQ, TRAIN_F32_STEPS = 2, 128, 3
TRAIN_OPT = {"lr": 1e-3, "warmup_steps": 2, "decay_steps": 100}
# float32 rounding alone (the golden's witness: the JAX run from weights
# one ulp up) moves these losses by ~1e-7 and the gradient norms by
# ~1e-7 relative; the kernels' sums in another order stay well inside
TRAIN_F32_RTOL = 1e-4
TRAIN_BF16_BATCH, TRAIN_BF16_SEQ, TRAIN_BF16_STEPS = 8, 512, 4
TRAIN_MOE_ARCH = "olmoe-1b-7b"
TRAIN_MOE_LAYERS, TRAIN_MOE_STEPS = 2, 2
TRAIN_ENCDEC_ARCH = "whisper-base"
TRAIN_ENCDEC_SEQ, TRAIN_ENCDEC_STEPS = 128, 2
# K4's backward in float32 against the plain version's gradient: of each
# gradient's largest magnitude (measured ~2e-6)
K4_BWD_RTOL = 1e-4
# K4's backward at the training path's shapes: (B, H, KV, Lq, Lk, hd,
# causal, packed segments, case)
K4_BWD_FRAMES = 1500
K4_BWD_SHAPES = [
    (8, 16, 8, 512, 512, 128, True, True,
     "qwen3 train [8,16,512,128] causal packed"),
    (2, 28, 4, 512, 512, 128, True, True,
     "qwen2vl train [2,28,512,128] G=7 causal packed"),
    (8, 8, 8, K4_BWD_FRAMES, K4_BWD_FRAMES, 64, False, False,
     f"whisper encoder [8,8,{K4_BWD_FRAMES},64] non-causal"),
    (8, 8, 8, TRAIN_ENCDEC_SEQ, TRAIN_ENCDEC_SEQ, 64, True, True,
     f"whisper decoder [8,8,{TRAIN_ENCDEC_SEQ},64] causal packed")] + [
    (8, 8, 8, L, K4_BWD_FRAMES, 64, False, False,
     f"whisper cross L={L} against F={K4_BWD_FRAMES}")
    for L in (17, 333, 512)]
# K4's training forward against its plain version: the output at the
# serving checks' tolerances (allclose: atol = rtol), the float32 output
# and the log-sum-exp (a float32 function of the same inputs in both
# dtypes; ~1e-6 measured) at K4_STATS_TOL
K4_FWD_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
K4_STATS_TOL = 1e-5
# the names of the kernels under src/repro_torch/kernels/csrc, as the
# profiler reports them after "(anonymous namespace)::"
PORT_KERNEL_PREFIXES = ("edge_rounds", "simplex_project", "flash_fwd",
                        "bwd_", "decode_split", "ssd_scan", "gmm_")


T0 = time.perf_counter()
# the card's name and power limit as nvidia-smi reads them, set by main()
# and printed beside every serve's memory and times
CARD = {"nvidia_smi": None}


def emit(record: dict) -> None:
    """One JSON line; a phase's record carries the seconds since start."""
    if "phase" in record:
        record = {**record, "at_s": round(time.perf_counter() - T0, 1)}
    print(json.dumps(record), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def bound_ms(n_bytes: float, n_ops: float, peak_ops: float = PEAK_F32_FLOPS):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` back-to-back calls, one pair
    of CUDA events around the run (one warm-up call first), so the host's
    launch overhead hides behind the queued work wherever it can."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, reps: int) -> float:
    """Device time of `fn` per call: the kernels (and copies) it launches,
    summed by torch.profiler over `reps` calls, from a window in which
    every kernel's events number a multiple of `reps`.  Unlike CUDA
    events around back-to-back calls, this leaves out the host's launch
    time when a call's kernels are shorter than it."""
    # the profiler can hand back no device events for a window, or keep
    # only some of a window's launches: take an empty window again,
    # longer, and a partial one again as it was; if every window stays
    # partial, time a call as each kernel's mean over the events kept
    # times its launches a call
    for attempt in range(5):
        events = device_events(torch, fn, reps)
        total = sum(t for _, t in events.values())
        partial = {k: n for k, (n, _) in events.items() if n % reps}
        if total > 0 and not partial:
            return total / 1e3 / reps
        emit({"phase": "profiler_window_partial" if partial
              else "profiler_window_empty", "attempt": attempt,
              "reps": reps, "counts": partial})
        if not partial:
            reps *= 4
        time.sleep(1.0)
    if not partial:
        raise RuntimeError("the profiler kept no device events in five "
                           "windows")
    per_call = sum(t / n * max(1, round(n / reps))
                   for n, t in events.values())
    emit({"phase": "profiler_window_estimate", "reps": reps,
          "counts": {k: n for k, (n, _) in events.items()},
          "ms": per_call / 1e3})
    return per_call / 1e3


def graph_ms(torch, fn, reps: int, side=None) -> float:
    """Device time of `fn` per call from CUDA events around replays of
    one CUDA graph of `reps` calls: no host launch time between the
    calls and no profiler (one eager warm-up call first).  The warm-up
    and the capture run on the stream `side` (default: a new one)."""
    side = torch.cuda.Stream() if side is None else side
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * reps)


def graph_grad_ms(torch, forward, inputs, cot, reps: int) -> float:
    """Device time of `torch.autograd.grad(out, inputs, cot)` on a
    retained graph (out = forward()), from CUDA events around replays of
    one CUDA graph of `reps` such calls.  The forward runs once, eagerly,
    on the capture stream: a backward op runs on its forward's stream,
    so the backward's kernels are captured and the forward's are not."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = forward()
    return graph_ms(torch, lambda: torch.autograd.grad(
        out, inputs, cot, retain_graph=True), reps, side)


def device_events(torch, fn, reps: int) -> dict:
    """The profiler's device events over `reps` calls of `fn` (one
    warm-up call first): {key: [count, total µs]}.  The profiler can
    lose some or all of a window's device events, never add any."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: [e.count, e.self_device_time_total]
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and e.key != "Activity Buffer Request"
            and e.self_device_time_total > 0}


def substochastic(torch, gen, mask, S, scale):
    """Random φ-like slot weights: rows sum to at most `scale`."""
    w = torch.rand((S,) + tuple(mask.shape), generator=gen,
                   device=mask.device) * mask
    return w * (scale / w.sum(-1, keepdim=True).clamp_min(1.0))


def golden_costs(src) -> dict:
    """The JAX reference's main-path trajectories, by scenario."""
    with open(os.path.join(src, "repro_torch", "data",
                           "reference_costs.json")) as f:
        return json.load(f)


def check_costs(label, hist, want) -> float:
    """Holds one `core.run` history to its golden trajectory `want`: every
    cost finite and non-increasing, the same accepted steps and
    rejections, the costs to rtol 2e-4.  Returns the largest relative
    difference."""
    costs, ref_costs = hist["costs"], want["costs"]
    require(all(map(math.isfinite, costs)), f"{label}: a cost is not "
            "finite")
    require(all(b <= a for a, b in zip(costs, costs[1:])),
            f"{label}: an accepted cost rose")
    require(len(costs) == len(ref_costs)
            and hist["n_rejected"] == want["n_rejected"],
            f"{label}: {len(costs)} costs / {hist['n_rejected']} "
            f"rejections vs the reference's {len(ref_costs)} / "
            f"{want['n_rejected']}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(costs, ref_costs))
    require(rel <= 2e-4, f"{label}: costs differ from the reference by "
            f"rtol {rel}")
    return rel


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs the "
              "card", file=sys.stderr)
        return 1
    src = os.path.join(HERE, "src")
    require(os.path.isdir(os.path.join(src, "repro_torch")),
            "run from the root of a checkout (src/repro_torch missing)")
    sys.path.insert(0, src)
    from repro_torch import core
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.edge_rounds import (cluster_plan, cluster_size,
                                                 edge_rounds_bucketed_cuda,
                                                 edge_rounds_cuda, k1_plan)
    from repro_torch.kernels.simplex_project import (rows_per_warp,
                                                     simplex_project_cuda)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    CARD["nvidia_smi"] = smi
    dev = torch.device("cuda")
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # ------------------------------------------------------------ build
    t0 = time.perf_counter()
    reports = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_flags": " ".join(_build.NVCC_FLAGS),
          "ptxas": {name: ptxas_summary(out)
                    for name, out in reports.items()}})
    if "moe_gmm_bwd" in reports:     # K7's backward: no spills, by design
        spills = ptxas_summary(reports["moe_gmm_bwd"])["spills"]
        require(not spills, f"moe_gmm_bwd spills: {spills}")

    # -------------------------------------------------------- scenarios
    nets, nbrs, bks = {}, {}, {}
    for name in ("sw_1000", "ba_10000"):
        t0 = time.perf_counter()
        nets[name] = core.make_scenario(core.TABLE_II[name], device=dev)
        nbrs[name] = core.build_neighbors(nets[name].adj)
        bks[name] = core.build_buckets(nets[name].adj)
        emit({"phase": "scenario", "name": name, "V": nets[name].V,
              "S": nets[name].S, "Dmax": nbrs[name].Dmax,
              "Dmax_in": int(nbrs[name].in_nbr.shape[1]),
              "padded_lanes": nets[name].V * nbrs[name].Dmax,
              "bucket_lanes_out": bks[name].out.lanes,
              "bucket_lanes_in": bks[name].inn.lanes,
              "seconds": time.perf_counter() - t0})

    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}     # kernel name -> dict of the headline numbers

    def headline(kname, **kv):
        row = results.setdefault(kname, {"max_abs_err": 0.0})
        err = kv.pop("max_abs_err")
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if kv.get("main"):
            row.update({k: v for k, v in kv.items() if k != "main"})

    # ------------------------------------------------- K1 edge_rounds
    def k1_case(label, w, b, nbr32, mask8, reduce, shift, max_rounds=None,
                main=False):
        V, D = nbr32.shape
        plan = k1_plan(w.shape[0], V, D)
        x, rounds = edge_rounds_cuda(w, b, nbr32, mask8, reduce, shift,
                                     max_rounds)
        torch.cuda.synchronize()
        xr, kr = ref.edge_rounds_ref(w, b, nbr32.long(), mask8.bool(),
                                     reduce, shift, max_rounds)
        require(torch.equal(x, xr), f"K1 {label}: kernel != plain")
        require(int(rounds.max()) == kr, f"K1 {label}: rounds "
                f"{int(rounds.max())} != plain {kr}")
        ms = device_ms(torch, lambda: edge_rounds_cuda(
            w, b, nbr32, mask8, reduce, shift, max_rounds), 20)
        plain = time_ms(torch, lambda: ref.edge_rounds_ref(
            w, b, nbr32.long(), mask8.bool(), reduce, shift, max_rounds), 3)
        n_bytes = (w.numel() * w.element_size() + b.numel() * b.element_size()
                   + V * D * 5 + x.numel() * x.element_size())
        n_ops = 3.0 * float(rounds.sum()) * V * D
        bms, by = bound_ms(n_bytes, n_ops)
        emit({"phase": "kernel", "kernel": "edge_rounds", "case": label,
              "shape": list(w.shape), "dtype": str(w.dtype),
              "reduce": reduce, "shift": shift, "bitwise": True,
              "cluster": plan.size, "tiles_in_smem": plan.tiles,
              "slots_a_lane": plan.slots_a_lane(D),
              "smem_bytes_per_cta": plan.smem_bytes(D),
              "rounds_max": int(rounds.max()), "ms": ms, "plain_ms": plain,
              "bound_ms": bms, "bound_by": by})
        headline("edge_rounds", max_abs_err=0.0, main=main, ms=ms,
                 plain_ms=plain, bound_ms=bms, bound_by=by)

    # the operands of core.run's first iteration on both paths
    path_ops = {name: record_path_operands(torch, core, ops, nets[name],
                                           nbrs[name], bks[name], bucketed)
                for name, bucketed in PATHS}
    for i, (w, b, nbr32, mask8, reduce, shift, max_rounds) in enumerate(
            path_ops["sw_1000"]["edge_rounds"]):
        k1_case(f"sw_1000 path call {i} ({reduce})", w, b, nbr32, mask8,
                reduce, shift, max_rounds)
    # the options path (scaling="paper": κ = 1) adds the stacked
    # longest-path recursion, max with shift = 1, to every iteration
    paper_ops = {name: record_path_operands(
        torch, core, ops, nets[name], nbrs[name], bks[name], bucketed,
        PAPER_OPTS) for name, bucketed in PATHS}
    for i, (w, b, nbr32, mask8, reduce, shift, max_rounds) in enumerate(
            paper_ops["sw_1000"]["edge_rounds"]):
        if shift == 1.0:
            k1_case(f"sw_1000 paper path call {i} (longest path, max "
                    "shift=1)", w, b, nbr32, mask8, reduce, shift,
                    max_rounds)
            stacked_check(torch, f"K1 sw_1000 paper path call {i}", w, b,
                          lambda w_, b_: edge_rounds_cuda(
                              w_, b_, nbr32, mask8, reduce, shift,
                              max_rounds)[0])

    net, nb = nets["sw_1000"], nbrs["sw_1000"]
    S, V = net.S, net.V
    w_out = substochastic(torch, gen, nb.out_mask, S, 0.9)
    w_in = w_out[:, nb.in_nbr, nb.in_slot]
    i32, u8 = torch.int32, torch.uint8
    k1_case("sw_1000 traffic (in-edges)", w_in, net.r, nb.in_nbr.to(i32),
            nb.in_mask.to(u8), "sum", 0.0, main=True)
    k1_case("sw_1000 marginals (out-edges)", w_out,
            torch.rand((S, V), generator=gen, device=dev),
            nb.out_nbr.to(i32), nb.out_mask.to(u8), "sum", 0.0)
    sup = (torch.rand((2 * S, V, nb.Dmax), generator=gen, device=dev)
           < 0.3) & nb.out_mask
    seeds = torch.rand((2 * S, V), generator=gen, device=dev) < 0.02
    for dt in (torch.float32, torch.bfloat16):
        k1_case(f"sw_1000 taint pair max {dt}", sup.to(dt), seeds.to(dt),
                nb.out_nbr.to(i32), nb.out_mask.to(u8), "max", 0.0)
    dag = nb.out_mask & (nb.out_nbr > torch.arange(V, device=dev)[:, None])
    k1_case("sw_1000 longest path max shift=1", dag.float()[None].expand(
        S, V, nb.Dmax).contiguous(), torch.zeros((S, V), device=dev),
        nb.out_nbr.to(i32), nb.out_mask.to(u8), "max", 1.0)
    gen_cpu = torch.Generator().manual_seed(1)
    adj = torch.triu(torch.rand((V, V), generator=gen_cpu) < 0.01, 1)
    dnb = core.build_neighbors(adj, device=dev)
    k1_case("random DAG V=1000", substochastic(torch, gen, dnb.out_mask, S,
                                               1.0),
            torch.rand((S, V), generator=gen, device=dev),
            dnb.out_nbr.to(i32), dnb.out_mask.to(u8), "sum", 0.0)

    # ------------------------------------------ K2 edge_rounds_bucketed
    net, nb, bk = nets["ba_10000"], nbrs["ba_10000"], bks["ba_10000"]
    S, V = net.S, net.V

    def k2_case(label, w, b, eb, nbr, mask, w_pad, reduce, main=False,
                shift=0.0):
        plan = cluster_plan(eb, cluster_size(w.shape[0], eb.lanes))
        x, rounds = edge_rounds_bucketed_cuda(w, b, eb, reduce, shift)
        torch.cuda.synchronize()
        xr, kr = ref.edge_rounds_bucketed_ref(w, b, eb, reduce, shift)
        xp, kp = edge_rounds_cuda(w_pad, b, nbr.to(torch.int32),
                                  mask.to(torch.uint8), reduce, shift)
        torch.cuda.synchronize()
        require(torch.equal(x, xr), f"K2 {label}: kernel != plain")
        require(torch.equal(x, xp), f"K2 {label}: bucketed != padded K1")
        require(int(rounds.max()) == kr == int(kp.max()),
                f"K2 {label}: round counts differ")
        ms = time_ms(torch, lambda: edge_rounds_bucketed_cuda(
            w, b, eb, reduce, shift), 20)
        plain = time_ms(torch, lambda: ref.edge_rounds_bucketed_ref(
            w, b, eb, reduce, shift), 3)
        k1_ms = time_ms(torch, lambda: edge_rounds_cuda(
            w_pad, b, nbr.to(torch.int32), mask.to(torch.uint8), reduce,
            shift), 5)
        lanes = eb.lanes
        # every task row's weights read once over its lanes
        n_bytes = (w.shape[0] * lanes * w.element_size() + lanes * 13
                   + V * 4 + b.numel() * b.element_size()
                   + x.numel() * x.element_size())
        n_ops = 3.0 * float(rounds.sum()) * lanes
        bms, by = bound_ms(n_bytes, n_ops)
        emit({"phase": "kernel", "kernel": "edge_rounds_bucketed",
              "case": label, "shape": list(w.shape), "dtype": str(w.dtype),
              "lanes": lanes, "cluster": plan.size,
              "smem_bytes_per_cta": plan.smem_bytes, "reduce": reduce,
              "shift": shift,
              "bitwise": True,
              "rounds_max": int(rounds.max()), "ms": ms, "plain_ms": plain,
              "padded_k1_ms": k1_ms, "bound_ms": bms, "bound_by": by})
        headline("edge_rounds_bucketed", max_abs_err=0.0, main=main, ms=ms,
                 plain_ms=plain, bound_ms=bms, bound_by=by)

    w_out = substochastic(torch, gen, nb.out_mask, S, 0.9)
    k2_case("ba_10000 traffic (in buckets)", w_out, net.r, bk.inn,
            nb.in_nbr, nb.in_mask, w_out[:, nb.in_nbr, nb.in_slot], "sum",
            main=True)
    k2_case("ba_10000 marginals (out buckets)", w_out,
            torch.rand((S, V), generator=gen, device=dev), bk.out,
            nb.out_nbr, nb.out_mask, w_out, "sum")
    sup = ((torch.rand((2 * S, V, nb.Dmax), generator=gen, device=dev)
            < 0.3) & nb.out_mask).to(torch.bfloat16)
    seeds = (torch.rand((2 * S, V), generator=gen, device=dev)
             < 0.02).to(torch.bfloat16)
    k2_case("ba_10000 taint pair max bf16", sup, seeds, bk.out, nb.out_nbr,
            nb.out_mask, sup, "max")
    for i, (w, b, eb, reduce, shift, max_rounds) in enumerate(
            paper_ops["ba_10000"]["edge_rounds_bucketed"]):
        if shift == 1.0:
            k2_case(f"ba_10000 paper path call {i} (longest path, max "
                    "shift=1)", w, b, eb, nb.out_nbr, nb.out_mask, w,
                    reduce, shift=shift)
            stacked_check(torch, f"K2 ba_10000 paper path call {i}", w, b,
                          lambda w_, b_: edge_rounds_bucketed_cuda(
                              w_, b_, eb, reduce, shift, max_rounds)[0])

    # ------------------------------------------------ K3 simplex_project
    def k3_case(label, phi, delta, M, perm, main=False):
        R, K = phi.shape
        out = simplex_project_cuda(phi, delta, M, perm)
        torch.cuda.synchronize()
        want = ref.simplex_project_ref(phi, delta, M, perm)
        err = float((out - want).abs().max())
        require(err <= 1e-5, f"K3 {label}: max abs err {err} > 1e-5")
        sums = out.sum(-1)
        live = perm.any(-1)
        require(bool(((sums[live] - 1).abs() <= 1e-5).all()),
                f"K3 {label}: a permitted row does not sum to 1")
        require(bool((out[~live] == 0).all()),
                f"K3 {label}: a blocked row is not all zero")
        ms = device_ms(torch, lambda: simplex_project_cuda(phi, delta, M,
                                                           perm), 20)
        plain = time_ms(torch, lambda: ref.simplex_project_ref(
            phi, delta, M, perm), 3)
        n_perm = perm.sum(-1)
        halvings, work = bisection_halvings(torch, ref, phi, delta, M, perm,
                                            weight=n_perm)
        # the mask read and the output written once a coordinate; φ, δ and
        # M read where permitted; 3 flops a permitted coordinate a halving
        permitted = int(n_perm.sum())
        n_bytes = R * K * 5 + 12 * permitted
        n_ops = 3.0 * work + 12.0 * permitted
        bms, by = bound_ms(n_bytes, n_ops)
        emit({"phase": "kernel", "kernel": "simplex_project", "case": label,
              "shape": [R, K], "max_abs_err": err,
              "rows_per_warp": rows_per_warp(K), "permitted": permitted,
              "max_permitted_a_row": int(n_perm.max()),
              "mean_halvings": halvings / R, "ms": ms, "plain_ms": plain,
              "bound_ms": bms, "bound_by": by})
        headline("simplex_project", max_abs_err=err, main=main, ms=ms,
                 plain_ms=plain, bound_ms=bms, bound_by=by)

    for name in ("sw_1000", "ba_10000"):
        R, D = nets[name].S * nets[name].V, nbrs[name].Dmax
        for label, K in (("data", D + 1), ("result", D)):
            phi = torch.rand((R, K), generator=gen, device=dev)
            phi = phi / phi.sum(-1, keepdim=True)
            delta = torch.rand((R, K), generator=gen, device=dev) * 3
            M = torch.rand((R, K), generator=gen, device=dev) * 2 + 0.25
            M[::5] = 1e-14
            perm = torch.rand((R, K), generator=gen, device=dev) < 0.7
            perm[::11] = False
            k3_case(f"{name} {label} rows (random 70 % mask)", phi, delta,
                    M, perm, main=(name == "ba_10000" and label == "data"))
        for i, args in enumerate(path_ops[name]["simplex_project"]):
            k3_case(f"{name} path call {i} ({'data' if i == 0 else 'result'}"
                    " rows)", *args[:4])
    # the dense engine's rows [S·V, V+1] and [S·V, V]: its first
    # iteration's two QPs, at K = 1001 on sw_1000 and on sw_queue
    for name in DENSE_K3_SCENARIOS:
        dnet = nets.get(name) or core.make_scenario(core.TABLE_II[name],
                                                    device=dev)
        rec = record_path_operands(torch, core, ops, dnet, None, None,
                                   False, method="dense")
        for i, args in enumerate(rec["simplex_project"]):
            k3_case(f"{name} dense path call {i} "
                    f"({'data' if i == 0 else 'result'} rows)", *args[:4])
        del rec, dnet
        torch.cuda.empty_cache()

    # ------------------------------------- K4 flash / K5 decode attention
    attention_kernel_checks(torch, emit_kernel=headline)
    # ------------------------------------------------------ K6 ssd_scan
    ssd_kernel_checks(torch, emit_kernel=headline)
    # ------------------------------------------------------- K7 moe_gmm
    gmm_kernel_checks(torch, emit_kernel=headline)

    # -------------------------------------------------------- main path
    golden = golden_costs(src)
    path_launches = {}
    for label, opts, per_it in PATH_OPTIONS:
        for name, bucketed in PATHS:
            key = name if label == "default" else f"{name}_{label}"
            phi0 = core.spt_phi_sparse(nets[name], nbrs[name])
            args = (torch, core, ops, nets[name], phi0, nbrs[name],
                    bks[name], bucketed, opts)
            runs = {}
            for driver in DRIVERS:
                state, counts, seconds = drive_path(*args, driver)
                hist = {"costs": state.costs,
                        "n_rejected": state.n_rejected}
                n_exec = len(state.costs) - 1 + state.n_rejected
                # the fused driver dispatches every iteration, frozen or not
                n = N_ITERS if driver == "fused" else n_exec
                rounds_kernel = ("edge_rounds_bucketed" if bucketed
                                 else "edge_rounds")
                want = {k: 0 for k in counts}
                want.update({rounds_kernel: 2 + per_it * n,
                             "simplex_project": 2 * n})
                require(counts == want, f"{key} {driver}: launches {counts} "
                        f"!= {want}")
                rel = check_costs(f"{key} {driver}", hist, golden[key])
                for k in ("edge_rounds", "edge_rounds_bucketed",
                          "simplex_project"):
                    path_launches[k] = path_launches.get(k, 0) + counts[k]
                runs[driver] = state
                emit({"phase": "main_path", "scenario": name,
                      "options": label, "run_options": opts,
                      "bucketed": bucketed, "driver": driver,
                      "iterations": n_exec, "dispatched": n,
                      "rejected": state.n_rejected, "launches": counts,
                      "seconds": seconds,
                      "ms_per_iteration": seconds * 1e3 / n,
                      "first_cost": state.costs[0],
                      "final_cost": state.costs[-1],
                      "max_rel_err_vs_reference": rel,
                      "graph": state.graph_stats})
            host, fused = runs["host"], runs["fused"]
            require(host.costs == fused.costs
                    and host.n_rejected == fused.n_rejected
                    and all(torch.equal(a, b) for a, b in
                            zip(core.sgp._fields(host.phi),
                                core.sgp._fields(fused.phi))),
                    f"{key}: the fused driver differs from the host driver")
            times = {d: [] for d in DRIVERS}
            capture_s = []
            for r in range(TIMING_ROUNDS):
                for driver in (DRIVERS if r % 2 == 0 else DRIVERS[::-1]):
                    state, _, seconds = drive_path(*args, driver)
                    times[driver].append(seconds * 1e3 / N_ITERS)
                    if driver == "fused":
                        capture_s.append(state.graph_stats["capture_s"])
            emit({"phase": "drivers", "scenario": name, "options": label,
                  "bitwise_fused_equals_host": True,
                  "ms_per_iteration": times,
                  # the fused chunk's one capture, spread over its
                  # iterations, is in its ms an iteration above
                  "fused_capture_s": capture_s,
                  "median_ms_per_iteration": {
                      d: sorted(v)[len(v) // 2] for d, v in times.items()},
                  "warm_launch_ms": path_launch_ms(
                      torch, core, nets[name], phi0, nbrs[name], bks[name],
                      bucketed, opts)})
    # ------------------------------------------------------- paper phase
    t_paper = time.perf_counter()
    paper = paper_figures(torch, core, ops, dev, paper_golden(src))
    real = paper_real_size(torch, core, ops, dev, src)
    path_launches["simplex_project"] += (paper["simplex_project"]
                                         + real["simplex_project"])
    path_launches["edge_rounds"] += (paper["edge_rounds"]
                                     + real["edge_rounds"])
    emit({"phase": "paper", "case": "done", "launches": {
        "simplex_project": paper["simplex_project"]
        + real["simplex_project"],
        "edge_rounds": paper["edge_rounds"] + real["edge_rounds"]},
        "seconds": time.perf_counter() - t_paper})
    gc.collect()
    torch.cuda.empty_cache()
    # ------------------------------------------------------ replay phase
    t_replay = time.perf_counter()
    replay = replay_phase(torch, core, ops, dev, src)
    for k, v in replay.items():
        path_launches[k] += v
    emit({"phase": "replay", "case": "done", "launches": replay,
          "seconds": time.perf_counter() - t_replay})
    gc.collect()
    torch.cuda.empty_cache()
    # ------------------------------------------------------ robust phase
    t_robust = time.perf_counter()
    robust = robust_phase(torch, core, ops, dev, nets, nbrs, bks)
    for k, v in robust.items():
        path_launches[k] += v
    emit({"phase": "robust", "case": "done", "launches": robust,
          "seconds": time.perf_counter() - t_robust})
    gc.collect()
    torch.cuda.empty_cache()
    # ------------------------------------------------ distributed phase
    t_dist = time.perf_counter()
    distributed = distributed_phase(torch, core, ops, src, nets, nbrs, bks)
    for k, v in distributed.items():
        path_launches[k] += v
    emit({"phase": "distributed", "case": "done", "launches": distributed,
          "seconds": time.perf_counter() - t_dist})
    # ------------------------------------------------------ router phase
    t_router = time.perf_counter()
    routed = router_phase(torch, core, ops, src)
    for k, v in routed.items():
        path_launches[k] += v
    emit({"phase": "router", "case": "done", "launches": routed,
          "seconds": time.perf_counter() - t_router})
    gc.collect()
    torch.cuda.empty_cache()
    # ------------------------------------------------------ train phase
    # before the serves, which keep their models for --profile; its
    # launches join the path's after them
    trained = train_phase(torch, src, headline)
    gc.collect()
    torch.cuda.empty_cache()
    # ------------------------------------- serving Qwen3-0.6B, Mamba2-130M
    serve_counts, serve_bf16 = serve_checks(
        torch, src, SERVE_ARCH, "reference_serve.json", SERVE_REQUESTS,
        witness=reversed_keys, per_prefill={"flash_attention": 1},
        per_decode={"decode_attention": 1})
    path_launches.update(serve_counts)
    mamba_counts, mamba_bf16 = serve_checks(
        torch, src, MAMBA_ARCH, "reference_serve_mamba2.json",
        MAMBA_REQUESTS, witness=sequential_ssd, per_prefill={"ssd_scan": 1},
        per_decode={})
    path_launches.update(mamba_counts)
    # ------------------------------------------------ serving OLMoE-1B-7B
    olmoe_counts, olmoe_bf16 = olmoe_serve_checks(torch, src)
    path_launches["moe_gmm"] = olmoe_counts["moe_gmm"]
    for k in ("flash_attention", "decode_attention"):
        path_launches[k] += olmoe_counts[k]
    # ----------------------------------- serving whisper-base, qwen2-vl-7b
    whisper_counts, whisper_bf16 = whisper_serve_checks(torch, src)
    vlm_counts, vlm_bf16 = serve_checks(
        torch, src, VLM_ARCH, "reference_serve_qwen2vl.json", VLM_REQUESTS,
        witness=reversed_orders, per_prefill={"flash_attention": 1},
        per_decode={"decode_attention": 1}, f32_layers=VLM_F32_LAYERS,
        draw="torch")
    for counts in (whisper_counts, vlm_counts):
        for k, v in counts.items():
            path_launches[k] += v
    for k, v in trained.items():
        path_launches[k] = path_launches.get(k, 0) + v
    for k, v in path_launches.items():
        require(v > 0, f"kernel {k} was never launched on its path")

    require("jax" not in sys.modules, "jax was imported")
    sources = {"edge_rounds": ("src/repro_torch/kernels/csrc/edge_rounds.cu",
                               "src/repro/kernels/edge_rounds.py:81"),
               "edge_rounds_bucketed": (
                   "src/repro_torch/kernels/csrc/edge_rounds.cu",
                   "src/repro/kernels/edge_rounds.py:173"),
               "simplex_project": (
                   "src/repro_torch/kernels/csrc/simplex_project.cu",
                   "src/repro/kernels/simplex_project.py:76"),
               "flash_attention": (
                   "src/repro_torch/kernels/csrc/flash_attention.cu",
                   "src/repro/kernels/flash_attention.py:68"),
               "decode_attention": (
                   "src/repro_torch/kernels/csrc/decode_attention.cu",
                   "src/repro/kernels/decode_attention.py:62"),
               "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                            "src/repro/kernels/ssd_scan.py:80"),
               "moe_gmm": ("src/repro_torch/kernels/csrc/moe_gmm.cu",
                           "src/repro/kernels/moe_gmm.py:35"),
               # the backward of K4 and of K7 (each its own source): the
               # JAX package differentiates the functions the two TPU
               # kernels compute
               "flash_attention_bwd": (
                   "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                   "src/repro/kernels/flash_attention.py:68"),
               "moe_gmm_bwd": (
                   "src/repro_torch/kernels/csrc/moe_gmm_bwd.cu",
                   "src/repro/kernels/moe_gmm.py:35")}
    emit({"kernels": [
        {"name": k, "route": "cuda", "source": sources[k][0],
         "replaces": sources[k][1], "launches": path_launches[k],
         "max_abs_err": results[k]["max_abs_err"], "ms": results[k]["ms"],
         "plain_ms": results[k]["plain_ms"],
         "bound_ms": results[k]["bound_ms"],
         "bound_by": results[k]["bound_by"],
         "library_ms": results[k].get("library_ms")}
        for k in sources]})
    if "--profile" in sys.argv[1:]:
        profile_paths(torch, core, ops, nets, nbrs, bks)
        profile_robust(torch, core, ops, nets, nbrs, bks)
        profile_decode(torch, *serve_bf16, label=f"serve {SERVE_ARCH} "
                       "bfloat16")
        profile_decode(torch, *mamba_bf16, label=f"serve {MAMBA_ARCH} "
                       "bfloat16")
        profile_decode(torch, *olmoe_bf16, label=f"serve {OLMOE_ARCH} "
                       "bfloat16")
        profile_decode(torch, *whisper_bf16, label=f"serve {WHISPER_ARCH} "
                       "bfloat16")
        profile_decode(torch, *vlm_bf16, label=f"serve {VLM_ARCH} "
                       "bfloat16")
    # the world of one that `task_mesh()` made: torn down here, so that
    # nothing is printed after the device line
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


# ------------------------------------------------------------ paper phase
# the reference's default engine (dense) on the card: the runs of
# `reference_paper.json` (Fig. 4, 5b, 5c, 5d, abilene's optimality),
# then at real size the dense engine on PAPER_REAL against its
# `reference_costs.json` golden and the sparse baselines there
PAPER_REAL = "sw_1000"
PAPER_SPARSE_ITERS = 200
# the dense engine's QPs held against K3's plain version: V + 1 = 1001
# and a Table II shape, [12,000, 101]
DENSE_K3_SCENARIOS = ("sw_1000", "sw_queue")
# fused ≡ host bit for bit on the dense and broadcast engines
PAPER_BITWISE = (("sw_queue", "dense", 20), ("connected_er", "dense", 30),
                 ("connected_er", "broadcast", 30))
PAPER_RTOL = 1e-4          # final costs and totals
PAPER_CURVE_RTOL = 1e-3    # every point of Fig. 5b's cost curves
# Fig. 5d's L_data / L_result read φ, not the cost: near the optimum φ
# moves along directions of nearly equal cost (at a_m = 0.5 a one-ulp
# change of the capacities moves the reference's own L_data by 1.9e-4,
# and the port on the CPU reads it 9.8e-4 from the golden:
# `python tests/test_torch_paper.py --l-witness`)
PAPER_L_RTOL = 1e-2


def paper_golden(src) -> dict:
    with open(os.path.join(src, "repro_torch", "data",
                           "reference_paper.json")) as f:
        return json.load(f)


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def timed(torch, ops, dev, fn):
    """(fn(), wall seconds, kernel launches), counters zeroed before."""
    sync(torch, dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    sync(torch, dev)
    return out, time.perf_counter() - t0, ops.launches()


def rel_err(got: float, want: float) -> float:
    return abs(got - want) / abs(want)


def fig4_summary(totals: dict):
    """(SGP wins, mean SGP / best-baseline ratio), as
    benchmarks/fig4_totalcost.py derives them."""
    wins, ratios = 0, []
    for out in totals.values():
        best = min(v for k, v in out.items() if k != "SGP")
        ratios.append(out["SGP"] / best)
        wins += out["SGP"] <= best * 1.001
    return wins, sum(ratios) / len(ratios)


def iters_to(costs, target) -> int:
    """Iterations until a cost reaches `target` (fig5b_convergence.py)."""
    for i, c in enumerate(costs):
        if c <= target:
            return i
    return len(costs)


def paper_run_all(torch, core, ops, dev, net, n_iters):
    """`run_all`'s four algorithms one by one (the three SGP runs on the
    default dense engine and driver), each timed: (totals, records)."""
    runs = (("SGP", lambda: core.run(net, core.spt_phi(net),
                                     n_iters=n_iters)),
            ("SPOO", lambda: core.run_spoo(net, n_iters=n_iters)),
            ("LCOR", lambda: core.run_lcor(net, n_iters=n_iters)))
    totals, recs = {}, {}
    for label, fn in runs:
        (_, h), seconds, counts = timed(torch, ops, dev, fn)
        totals[label] = h["final_cost"]
        recs[label] = {"seconds": seconds,
                       "ms_per_iteration": seconds * 1e3 / n_iters,
                       "iterations": len(h["costs"]) - 1 + h["n_rejected"],
                       "rejected": h["n_rejected"],
                       "simplex_project": counts["simplex_project"]}
        # the fused driver dispatches every iteration: two QPs each
        require(dev.type != "cuda"
                or counts["simplex_project"] == 2 * n_iters,
                f"{label}: {counts['simplex_project']} K3 launches in "
                f"{n_iters} iterations")
    lpr, seconds, _ = timed(torch, ops, dev, lambda: core.run_lpr(net))
    totals["LPR"] = lpr["final_cost"]
    recs["LPR"] = {"seconds": seconds}
    return totals, recs


def paper_totals_check(label, got, want, recs, extra=None, rtols=None):
    """Each value against the golden's to PAPER_RTOL, or to its own in
    `rtols`."""
    errs = {k: rel_err(got[k], want[k]) for k in want}
    emit({"phase": "paper", **(extra or {}), "case": label,
          "totals": got, "reference": want,
          "max_rel_err_vs_reference": max(errs.values()),
          "rel_err_vs_reference": errs, "runs": recs})
    bad = {k: e for k, e in errs.items()
           if e > (rtols or {}).get(k, PAPER_RTOL)}
    require(not bad, f"paper {label}: {got} differ from the reference's "
            f"{want} by rtol {bad}")


def paper_figures(torch, core, ops, dev, gold) -> dict:
    """Fig. 4, 5c, 5b, 5d and abilene's optimality on the dense engine,
    each held to `reference_paper.json`, and fused ≡ host on the dense
    and broadcast engines.  Returns the K3 and (Fig. 5b's failed graph
    on the sparse engine) K1 launches."""
    k3 = 0
    g = gold["fig4"]
    totals = {}
    for name in g["scenarios"]:
        net = core.make_scenario(core.TABLE_II[name], device=dev)
        totals[name], recs = paper_run_all(torch, core, ops, dev, net,
                                           g["n_iters"])
        k3 += sum(r.get("simplex_project", 0) for r in recs.values())
        paper_totals_check(f"fig4 {name}", totals[name], g["totals"][name],
                           recs, {"figure": "fig4"})
        if name == "abilene":
            # the entry point itself: the same four totals bit for bit
            whole = core.run_all(net, n_iters=g["n_iters"])
            require(whole == totals[name], f"run_all {whole} != "
                    f"{totals[name]}")
    wins, ratio = fig4_summary(totals)
    emit({"phase": "paper", "figure": "fig4", "case": "summary",
          "sgp_wins": wins, "scenarios": len(totals),
          "mean_ratio_vs_best_baseline": ratio,
          "reference": {"sgp_wins": g["sgp_wins"],
                        "mean_ratio_vs_best_baseline":
                            g["mean_ratio_vs_best_baseline"]}})
    require(wins == g["sgp_wins"], f"fig4: SGP wins {wins} of "
            f"{len(totals)}, the reference {g['sgp_wins']}")

    g = gold["fig5c"]
    for s in g["scales"]:
        net = core.make_scenario(core.TABLE_II[g["scenario"]],
                                 rate_scale=s, device=dev)
        out, recs = paper_run_all(torch, core, ops, dev, net, g["n_iters"])
        k3 += sum(r.get("simplex_project", 0) for r in recs.values())
        adv = min(v for k, v in out.items() if k != "SGP") / max(
            out["SGP"], 1e-9)
        paper_totals_check(f"fig5c rate_scale {s}", out,
                           g["totals"][str(s)], recs,
                           {"figure": "fig5c", "advantage": adv,
                            "reference_advantage": g["advantage"][str(s)]})

    g = gold["fig5b"]
    net = core.make_scenario(core.TABLE_II[g["scenario"]], device=dev)
    s1 = int(net.comp_cost.params.cpu().argmax())
    require(s1 == g["failed_node"], f"fig5b: failed node {s1}")
    curves, recs = {}, {}
    for variant, kw in (("sgp", {}), ("gp", {"variant": "gp",
                                             "beta": g["gp_beta"]})):
        def both():
            phi, h = core.run(net, core.spt_phi(net),
                              n_iters=g["fail_at"], **kw)
            net2 = core.fail_node(net, s1)
            phi2 = core.refeasibilize(net2, phi)
            _, h2 = core.run(net2, phi2, n_iters=g["n_iters_after"], **kw)
            return h["costs"] + h2["costs"], net2, phi2
        (curves[variant], net2, phi2), seconds, counts = timed(
            torch, ops, dev, both)
        k3 += counts["simplex_project"]
        n = g["fail_at"] + g["n_iters_after"]
        recs[variant] = {"seconds": seconds,
                         "ms_per_iteration": seconds * 1e3 / n,
                         "simplex_project": counts["simplex_project"]}
    recover = {v: iters_to(c[g["fail_at"]:], curves["sgp"][-1] * 1.01)
               for v, c in curves.items()}
    errs = {}
    for v, c in curves.items():
        want = g["curves"][v]
        require(len(c) == len(want), f"fig5b {v}: {len(c)} accepted costs "
                f"against the reference's {len(want)}")
        errs[v] = max(rel_err(a, b) for a, b in zip(c, want))
    emit({"phase": "paper", "figure": "fig5b", "case": "node failure",
          "failed_node": s1, "recover_iters": recover,
          "reference_recover_iters": g["recover_iters"],
          "final": {v: c[-1] for v, c in curves.items()},
          "reference_final": {v: c[-1] for v, c in g["curves"].items()},
          "max_rel_err_vs_reference": errs, "runs": recs})
    require(recover == g["recover_iters"], f"fig5b: recovery {recover}")
    # the failed graph on the sparse engine: K1 over the failed node's
    # empty row, from the repaired iterate of the last run above (GP's),
    # against the dense engine from the same iterate
    runs = {}
    for method in ("dense", "sparse"):
        (_, h), seconds, counts = timed(torch, ops, dev, lambda: core.run(
            net2, phi2, n_iters=10, method=method))
        runs[method] = h
        k3 += counts["simplex_project"]
    require(dev.type != "cuda" or counts["edge_rounds"] == 2 + 5 * 10,
            f"fig5b sparse: launches {counts}")
    check_costs("fig5b failed graph, sparse vs dense", runs["sparse"],
                runs["dense"])
    sparse_k1 = counts["edge_rounds"]
    require(max(errs.values()) <= PAPER_CURVE_RTOL
            and all(rel_err(c[-1], g["curves"][v][-1]) <= PAPER_RTOL
                    for v, c in curves.items()),
            f"fig5b: curves differ from the reference by {errs}")

    g = gold["fig5d"]
    for am in g["ams"]:
        net = core.make_scenario(core.TABLE_II[g["scenario"]], device=dev)
        net = dataclasses.replace(net, a=torch.full_like(net.a, am))
        net = core.enforce_feasibility(net)
        (phi, h), seconds, counts = timed(torch, ops, dev, lambda: core.run(
            net, core.spt_phi(net), n_iters=g["n_iters"]))
        k3 += counts["simplex_project"]
        fl = core.compute_flows(net, phi)
        computed = float(fl.g.sum())
        delivered = float((net.a[:, None] * fl.g).sum())
        got = {"L_data": float(fl.f_data.sum()) / max(computed, 1e-9),
               "L_result": float(fl.f_result.sum()) / max(delivered, 1e-9),
               "final_cost": h["final_cost"]}
        paper_totals_check(f"fig5d a_m {am}", got, g["rows"][str(am)],
                           {"SGP": {"seconds": seconds,
                                    "ms_per_iteration": seconds * 1e3
                                    / g["n_iters"],
                                    "simplex_project":
                                        counts["simplex_project"]}},
                           {"figure": "fig5d"},
                           {"L_data": PAPER_L_RTOL,
                            "L_result": PAPER_L_RTOL})

    g = gold["optimality"]
    net = core.make_scenario(core.TABLE_II[g["scenario"]], device=dev)
    (phi, h), seconds, counts = timed(torch, ops, dev, lambda: core.run(
        net, core.spt_phi(net), n_iters=g["n_iters"]))
    k3 += counts["simplex_project"]
    cert = core.theorem1_residual(net, phi)
    t0 = time.perf_counter()
    opt = core.flow_domain_optimum(net)
    opt_s = time.perf_counter() - t0
    mva = core.marginals_vs_autodiff(net, phi)
    emit({"phase": "paper", "figure": "optimality", "case": g["scenario"],
          "final_cost": h["final_cost"], **cert,
          "flow_domain_optimum": opt, "flow_domain_optimum_s": opt_s,
          "marginals_vs_autodiff": mva,
          "final_over_optimum": h["final_cost"] / opt,
          "reference": g, "seconds": seconds,
          "ms_per_iteration": seconds * 1e3 / g["n_iters"],
          "simplex_project": counts["simplex_project"]})
    require(cert["theorem1"] < 0.05 and cert["loop_free"],
            f"optimality: {cert}")
    require(h["final_cost"] <= 1.01 * opt, f"optimality: final cost "
            f"{h['final_cost']} above 1.01 x the optimum {opt}")
    require(rel_err(opt, g["flow_domain_optimum"]) <= PAPER_RTOL
            and rel_err(h["final_cost"], g["final_cost"]) <= PAPER_RTOL,
            f"optimality: {opt}, {h['final_cost']} against {g}")
    require(mva < 1e-4, f"optimality: marginals vs autodiff {mva}")

    for name, method, n in PAPER_BITWISE:
        net = core.make_scenario(core.TABLE_II[name], device=dev)
        runs = {}
        for driver in DRIVERS:
            st, seconds, counts = timed(
                torch, ops, dev, lambda: core.run_chunk(
                    net, core.init_run_state(net, core.spt_phi(net),
                                             method=method), n,
                    driver=driver))
            k3 += counts["simplex_project"]
            runs[driver] = (st, seconds, counts["simplex_project"])
        (h, hs, hk), (f, fs, fk) = runs["host"], runs["fused"]
        same = (h.costs == f.costs and h.n_rejected == f.n_rejected
                and torch.equal(h.phi.data, f.phi.data)
                and torch.equal(h.phi.result, f.phi.result))
        emit({"phase": "paper", "case": f"{name} {method} fused vs host",
              "bitwise_fused_equals_host": same, "rejected": h.n_rejected,
              "ms_per_iteration": {"host": hs * 1e3 / n,
                                   "fused": fs * 1e3 / n},
              "simplex_project": {"host": hk, "fused": fk},
              "graph": f.graph_stats})
        require(same, f"{name} {method}: the fused driver differs from the "
                "host driver")
    return {"simplex_project": k3, "edge_rounds": sparse_k1}


def paper_real_size(torch, core, ops, dev, src) -> dict:
    """At PAPER_REAL: the dense engine from `spt_phi` for N_ITERS
    iterations (fused driver) against the `reference_costs.json` golden,
    its taint and LU timed alone; then `run_spoo`, `run_lcor` and SGP on
    the sparse engine for PAPER_SPARSE_ITERS iterations and `run_lpr`
    (its greedy branch), with Theorem 1's residual and loop freedom of
    SGP's final φ.  Returns the K1 and K3 launches."""
    launches = {"edge_rounds": 0, "simplex_project": 0}
    net = core.make_scenario(core.TABLE_II[PAPER_REAL], device=dev)
    phi0 = core.spt_phi(net)

    def dense():
        st = core.init_run_state(net, phi0)
        return core.run_chunk(net, st, N_ITERS)
    st, seconds, counts = timed(torch, ops, dev, dense)
    require(counts["simplex_project"] == 2 * N_ITERS,
            f"{PAPER_REAL} dense: K3 launches {counts}")
    launches["simplex_project"] += counts["simplex_project"]
    rel = check_costs(f"{PAPER_REAL} dense", {"costs": st.costs,
                                              "n_rejected": st.n_rejected},
                      golden_costs(src)[PAPER_REAL])
    fl = st.flows
    mg = core.compute_marginals(net, st.phi, fl)
    sup = (st.phi.data[..., :-1] > core.sgp.SUPPORT_TOL) & net.adj[None]
    taint_ms = time_ms(torch, lambda: core.sgp._taint(sup, mg.rho_data), 2)
    lu_ms = time_ms(torch, lambda: core.compute_flows(net, st.phi), 2)
    # one batched [S, V, V] solve on cuSOLVER / cuBLAS (the port's, which
    # a CUDA graph captures) and on PyTorch's default backend choice
    A = torch.eye(net.V, device=dev)[None] - st.phi.result.transpose(-1, -2)
    rhs = net.r[..., None]
    solve_ms = {}
    for lib in ("cusolver", "default"):
        prev = torch.backends.cuda.preferred_linalg_library()
        torch.backends.cuda.preferred_linalg_library(lib)
        solve_ms[lib] = time_ms(torch, lambda: torch.linalg.solve_ex(
            A, rhs, check_errors=False), 3)
        torch.backends.cuda.preferred_linalg_library(prev)
    del A, rhs
    emit({"phase": "paper", "case": f"{PAPER_REAL} dense engine",
          "method": "dense", "driver": "fused", "iterations": N_ITERS,
          "rejected": st.n_rejected, "seconds": seconds,
          "ms_per_iteration": seconds * 1e3 / N_ITERS,
          "k3_shape": [net.S * net.V, net.V + 1], "launches": counts,
          "taint_ms": taint_ms, "flows_ms": lu_ms,
          "batched_solve_ms": solve_ms,
          "final_cost": st.costs[-1], "max_rel_err_vs_reference": rel,
          "graph": st.graph_stats})
    del st, fl, mg, sup

    totals, recs = {}, {}
    n = PAPER_SPARSE_ITERS
    phi_sgp = None
    # K1 launches an iteration: the candidate's two traffic solves, the
    # two marginal solves and (with blocking on) the stacked taint pair
    for label, per_it, fn in (
            ("SGP", 5, lambda: core.run(net, phi0, n_iters=n,
                                        method="sparse")),
            ("SPOO", 4, lambda: core.run_spoo(net, n_iters=n,
                                              method="sparse")),
            ("LCOR", 5, lambda: core.run_lcor(net, n_iters=n,
                                              method="sparse"))):
        (phi, h), seconds, counts = timed(torch, ops, dev, fn)
        if label == "SGP":
            phi_sgp = phi
        totals[label] = h["final_cost"]
        recs[label] = {"seconds": seconds, "ms_per_iteration":
                       seconds * 1e3 / n, "rejected": h["n_rejected"],
                       "edge_rounds": counts["edge_rounds"],
                       "simplex_project": counts["simplex_project"]}
        require(counts["simplex_project"] == 2 * n
                and counts["edge_rounds"] == 2 + per_it * n,
                f"{PAPER_REAL} sparse {label}: launches {counts}")
        for k in launches:
            launches[k] += counts[k]
    lpr, seconds, _ = timed(torch, ops, dev, lambda: core.run_lpr(net))
    totals["LPR"] = lpr["final_cost"]
    recs["LPR"] = {"seconds": seconds, "branch": "greedy"}
    cert, seconds, _ = timed(torch, ops, dev,
                             lambda: core.theorem1_residual(net, phi_sgp))
    emit({"phase": "paper", "case": f"{PAPER_REAL} sparse baselines",
          "iterations": n, "totals": totals, "runs": recs,
          "sgp_final": {**cert, "seconds": seconds}})
    require(all(map(math.isfinite, totals.values())),
            f"{PAPER_REAL}: a total is not finite: {totals}")
    require(cert["loop_free"], f"{PAPER_REAL}: SGP's final φ has a loop")
    return launches


# ----------------------------------------------------------- replay phase
# churn replay (`core.replay.ReplayEngine`) at the reference's sizes: the
# golden rows of `reference_replay.json` (key, scenario, bucketed, task
# pool), then ba_10000 (no golden: the reference takes tens of minutes
# to replay it on a CPU), stream against the event loop
REPLAY_ROWS = (("sw_1000_churn", "sw_1000", False, False),
               ("ba_1000_churn", "ba_1000", True, False),
               ("sw_1000_taskchurn", "sw_1000", False, True))
REPLAY_BIG = ("ba_10000_churn", "ba_10000", True, False)
REPLAY_TAIL = 5
REPLAY_RTOL = 2e-4
# the step out of a steep start and the costs after it (`steep_step`)
STEEP_FACTOR = 10.0
STEEP_RTOL = 1e-1
AFTER_STEEP_RTOL = 1e-3
REPLAY_ROUNDS = 3          # alternating loop / stream timing rounds
REPLAY_BIG_ROUNDS = 1      # beside its checked loop and stream runs
RECURSION_KERNELS = ("edge_rounds", "edge_rounds_bucketed",
                     "simplex_project")


def replay_golden(src) -> dict:
    with open(os.path.join(src, "repro_torch", "data",
                           "reference_replay.json")) as f:
        return json.load(f)


def replay_setup(core, scenario, task, key, dev):
    """(net, pool, canned schedule) of a replay row on `dev`."""
    if task:
        net, pool = core.taskchurn_scenario(scenario, device=dev)
    else:
        net = core.make_scenario(core.TABLE_II[scenario], device=dev)
        pool = None
    return net, pool, core.churn_schedule(key, net)


def replay_run(torch, core, ops, dev, net, pool, sched, bucketed, **play):
    """One replay from φ⁰, the launch counters set to 0 just before it.
    `play` splits into the engine's options (invariant_checks) and
    `play`'s.  Returns (engine, history, wall seconds, launches)."""
    inv = play.pop("invariant_checks", False)

    def go():
        eng = core.ReplayEngine(net, bucketed=bucketed, invariant_checks=inv,
                                pool=pool.clone() if pool is not None
                                else None)
        return eng, eng.play(sched, tail_iters=REPLAY_TAIL, **play)
    (eng, hist), seconds, counts = timed(torch, ops, dev, go)
    return eng, hist, seconds, counts


def replay_same(label, torch, a, b) -> None:
    """Two replays of the port bit for bit: costs, final φ, records and
    admissions (modulo the stream's window stamps)."""
    (ea, ha), (eb, hb) = a, b
    require(ha["costs"] == hb["costs"] and ha["n_iters"] == hb["n_iters"],
            f"{label}: the stream's costs differ from the event loop's")
    rec = [[(r.it, r.kind, r.cost_before, r.cost_after, r.segment_costs,
             r.segment_iters) for r in h["records"]] for h in (ha, hb)]
    require(rec[0] == rec[1], f"{label}: the records differ")
    adm = [[(x.action, x.slot, x.n_active, x.S_cap)
            for x in h["admission_events"]] for h in (ha, hb)]
    require(adm[0] == adm[1], f"{label}: the admissions differ")
    require(all(torch.equal(x, y) for x, y in zip(
        (ea.phi.data, ea.phi.local, ea.phi.result),
        (eb.phi.data, eb.phi.local, eb.phi.result))),
        f"{label}: the final φ differs")


def steep_step(w) -> bool:
    """True where a golden record's repaired iterate starts far up the
    queue cost's quadratic continuation (flows past SAT·capacity: its
    cost above STEEP_FACTOR times where its segment ends).  The first
    step out of it turns on ulp-level differences of large marginals: a
    one-ulp change of the capacities moves the reference's own cost
    there by up to 1.9 % and every later cost by up to 4.5e-4
    (ROADMAP.md §3)."""
    seg = w["segment_costs"]
    return bool(seg) and w["cost_after"] > STEEP_FACTOR * seg[-1]


def replay_check(label, hist, want=None, cold=False) -> dict:
    """A replay's records: finite segment costs that never rise and, with
    a golden `want`, the reference's events, segments, accepted and
    rejected steps (segment lengths), admissions and (cold) warm / cold
    iterations-to-target.  Costs hold to REPLAY_RTOL up to the first
    steep start (`steep_step`), the step out of it to STEEP_RTOL and the
    costs after it to AFTER_STEEP_RTOL.  Returns the largest relative
    difference under each bound."""
    recs = hist["records"]
    for r in recs:
        seg = r.segment_costs
        require(all(map(math.isfinite, [r.cost_after] + seg)),
                f"{label}: a cost is not finite")
        require(all(b <= a for a, b in zip(seg, seg[1:])),
                f"{label}: a segment cost rose ({r.kind} at {r.it})")
    if want is None:
        return {}
    require(len(recs) == len(want["records"]), f"{label}: event count")
    require(hist["n_iters"] == want["n_iters"]
            and len(hist["costs"]) == len(want["costs"]),
            f"{label}: iteration counts")
    # the costs before the first event, then each event's segment
    n0 = len(want["costs"]) - sum(1 + len(w["segment_costs"])
                                  for w in want["records"])
    pairs = [(REPLAY_RTOL, a, b) for a, b in
             zip(hist["costs"][:n0], want["costs"][:n0])]
    tol = REPLAY_RTOL
    for r, w in zip(recs, want["records"]):
        require((r.it, r.kind, r.segment_iters, len(r.segment_costs))
                == (w["it"], w["kind"], w["segment_iters"],
                    len(w["segment_costs"])),
                f"{label}: {r.kind} at {r.it}: {r.segment_iters} iterations"
                f", {len(r.segment_costs)} accepted vs the reference's "
                f"{w['segment_iters']}, {len(w['segment_costs'])}")
        got = [r.cost_before, r.cost_after] + r.segment_costs
        ref = [w["cost_before"], w["cost_after"]] + w["segment_costs"]
        for i, (a, b) in enumerate(zip(got, ref)):
            if i == 2 and steep_step(w):
                pairs.append((STEEP_RTOL, a, b))
                tol = AFTER_STEEP_RTOL
            else:
                pairs.append((tol, a, b))
        if cold:
            require((r.warm_iters, r.cold_iters)
                    == (w["warm_iters"], w["cold_iters"]),
                    f"{label}: {r.kind} at {r.it}: warm / cold "
                    f"{r.warm_iters} / {r.cold_iters} vs the reference's "
                    f"{w['warm_iters']} / {w['cold_iters']}")
    worst = {}
    for t, a, b in pairs:
        err = rel_err(a, b)
        require(err <= t, f"{label}: a cost {a} differs from the "
                f"reference's {b} by rtol {err} > {t}")
        worst[str(t)] = max(worst.get(str(t), 0.0), err)
    adm = [(x.action, x.slot, x.n_active, x.S_cap)
           for x in hist["admission_events"]]
    require(adm == [(x["action"], x["slot"], x["n_active"], x["S_cap"])
                    for x in want["admission_events"]],
            f"{label}: admissions {adm}")
    return worst


def graph_summary(eng, n_events) -> dict:
    """The CUDA graphs an engine's chunks and streams captured."""
    caps = sum(g["captures"] for g in eng.graph_log)
    secs = sum(g["capture_s"] or 0.0 for g in eng.graph_log)
    return {"captures": caps, "capture_s": secs,
            "capture_s_per_event": secs / max(n_events, 1)}


def spread(xs) -> dict:
    xs = sorted(xs)
    return {"median": xs[len(xs) // 2], "min": xs[0], "max": xs[-1],
            "all": xs}


def replay_timing(torch, core, ops, dev, net, pool, sched, bucketed,
                  rounds, first=None) -> dict:
    """Event loop and fused stream (no invariant checks) in alternating
    rounds: ms an event and ms an iteration, median and spread.  `first`
    ((loop seconds, stream seconds), iterations) counts an unchecked
    pair run before as the first round."""
    out = {m: {"ms_per_event": [], "ms_per_iteration": []}
           for m in ("loop", "stream")}

    def add(mode, seconds, n_iters):
        out[mode]["ms_per_event"].append(seconds * 1e3 / len(sched.events))
        out[mode]["ms_per_iteration"].append(seconds * 1e3 / n_iters)
    start = 0
    if first is not None:
        (loop_s, stream_s), n_iters = first
        add("loop", loop_s, n_iters)
        add("stream", stream_s, n_iters)
        start = 1
    for k in range(start, start + rounds):
        for mode in (("loop", "stream") if k % 2 == 0
                     else ("stream", "loop")):
            _, hist, seconds, _ = replay_run(
                torch, core, ops, dev, net, pool, sched, bucketed,
                stream=mode == "stream")
            add(mode, seconds, hist["n_iters"])
    return {m: {k: spread(v) for k, v in d.items()} for m, d in out.items()}


def repair_ms(torch, core, dev, net, sched, reps=3) -> list:
    """ms of `refeasibilize_sparse` (tiles, Dijkstra, device repair) after
    the schedule's node failure, on a 5-iteration warm iterate."""
    nbrs = core.build_neighbors(net.adj)
    st = core.init_run_state(net, core.spt_phi_sparse(net, nbrs),
                             method="sparse", nbrs=nbrs)
    core.run_chunk(net, st, 5)
    churn = core.ChurnState(net)
    for _, ev in sched.events:
        churn.apply(ev)
        if core.event_kind(ev) == "topology":
            break
    failed = churn.network()
    times = []
    for _ in range(reps):
        sync(torch, dev)
        t0 = time.perf_counter()
        core.refeasibilize_sparse(failed, st.phi, nbrs)
        sync(torch, dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def replay_phase(torch, core, ops, dev, src) -> dict:
    """The `replay` phase: each golden row's event loop (invariant checks
    after every event; the churn rows again with the cold baseline), its
    fused stream against it bit for bit, and both timed; then ba_10000's
    stream against its event loop with the invariants at the end.
    Returns the K1-K3 launches of the replays."""
    gold = replay_golden(src)
    launches = dict.fromkeys(RECURSION_KERNELS, 0)

    def count(label, counts, need):
        for k in RECURSION_KERNELS:
            launches[k] += counts[k]
        require(all(counts[k] > 0 for k in need),
                f"{label}: launches {counts}, expected {need}")
        return {k: counts[k] for k in RECURSION_KERNELS}

    for key, scenario, bucketed, task in REPLAY_ROWS + (REPLAY_BIG,):
        t_row = time.perf_counter()
        net, pool, sched = replay_setup(core, scenario, task, key, dev)
        want = gold.get(key)
        need = (("edge_rounds_bucketed" if bucketed else "edge_rounds"),
                "simplex_project")
        if want is not None:
            got = [[t, type(ev).__name__] for t, ev in sched.events]
            require(got == [[t, e["type"]] for t, e in want["schedule"]],
                    f"{key}: schedule {got}")
        args = (torch, core, ops, dev, net, pool, sched, bucketed)
        record = {"phase": "replay", "case": key, "scenario": scenario,
                  "V": net.V, "S": net.S, "bucketed": bucketed,
                  "pool": None if pool is None else
                  {"n_active": pool.n_active, "S_cap": pool.S_cap},
                  "events": len(sched.events)}
        big = want is None
        loop = replay_run(*args, invariant_checks=not big, stream=False)
        eng, hist, seconds, counts = loop
        record["loop"] = {
            "invariant_checks": not big, "seconds": seconds,
            "iterations": hist["n_iters"], "final_cost": hist["final_cost"],
            "max_rel_err_vs_reference_by_bound": replay_check(key, hist,
                                                              want),
            "spt_cache_hits": eng.spt_cache_hits,
            "graphs": graph_summary(eng, len(sched.events)),
            "launches": count(f"{key} loop", counts, need),
            "records": [[r.it, r.kind, r.cost_before, r.cost_after,
                         r.segment_iters] for r in hist["records"]]}
        if not task and not big:
            ceng, chist, seconds, counts = replay_run(
                *args, invariant_checks=True, cold_baseline=True)
            replay_check(f"{key} cold", chist, want, cold=True)
            replay_same(f"{key} cold", torch, (eng, hist), (ceng, chist))
            record["cold_baseline"] = {
                "seconds": seconds, "warm_cold_iters": [
                    [r.kind, r.warm_iters, r.cold_iters]
                    for r in chist["records"]],
                "launches": count(f"{key} cold", counts, need)}
        seng, shist, seconds, counts = replay_run(*args, stream=True)
        replay_same(key, torch, loop[:2], (seng, shist))
        record["stream"] = {
            "seconds": seconds, "bitwise_equals_loop": True,
            "spt_cache_hits": seng.spt_cache_hits,
            "graphs": graph_summary(seng, len(sched.events)),
            "launches": count(f"{key} stream", counts, need)}
        if big:
            for label, e in (("loop", eng), ("stream", seng)):
                core.check_invariants(e.net, e.phi, e.nbrs, n_loop_tasks=4)
            record["invariants_at_end"] = True
        if task:
            act = torch.as_tensor(eng.pool.active, device=dev)
            for f, fill in (("data", 0.0), ("local", 1.0), ("result", 0.0)):
                require(bool((getattr(eng.phi, f)[~act] == fill).all()),
                        f"{key}: an inactive row is not inert")
            record["admissions"] = [[x.action, x.slot]
                                    for x in hist["admission_events"]]
        record["host_repair_ms"] = (None if task else repair_ms(
            torch, core, dev, net, sched))
        record["timing"] = replay_timing(
            *args, REPLAY_BIG_ROUNDS if big else REPLAY_ROUNDS,
            first=((record["loop"]["seconds"], record["stream"]["seconds"]),
                   hist["n_iters"]) if big else None)
        record["seconds"] = time.perf_counter() - t_row
        emit(record)
        del eng, seng, loop, hist, shist
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------- robust phase
# fault injection, guards and the fleet (`core.faults`, `core.guards`,
# `core.fleet`) on the sparse main path's two scenarios, fused driver
ROBUST_ROUNDS = 3          # alternating plain / faulted / guarded rounds
# every injector armed at a value that changes nothing (staleness cannot
# be: any k > 0 draws ages in [0, k]); dropout 0.0 solves the marginals
# outside the propose, as staleness does
ROBUST_INERT = {"participation_p": 1.0, "dropout_p": 0.0, "corrupt_p": 0.0}
ROBUST_FAULTS = {"participation_p": 0.5, "staleness_k": 2,
                 "dropout_p": 0.2}
# the reference's convergence bar (tests/test_faults.py): p = 0.5 with
# staleness 3 within 1 % of the synchronous run at twice its budget,
# gated on its rows, recorded at full size
CONVERGE_ROWS = (("sw_queue", False, True), ("ba_1000", False, True),
                 ("sw_1000", False, False), ("ba_10000", True, False))
CONVERGE_ITERS = 30
FLEET_B = 8


def robust_run(torch, core, ops, net, phi0, nbrs, bks, bucketed,
               chunks=(N_ITERS,), **init_kw):
    """One fused run from `phi0` (`init_run_state`, then `run_chunk` for
    each of `chunks`), the launch counters set to 0 just before it.
    Returns (state, launch counts, wall seconds)."""
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    st = core.init_run_state(net, phi0, method="sparse", nbrs=nbrs,
                             bucketed=bucketed,
                             buckets=bks if bucketed else None, **init_kw)
    for n in chunks:
        core.run_chunk(net, st, n, driver="fused")
    torch.cuda.synchronize()
    return st, ops.launches(), time.perf_counter() - t0


def same_run(torch, core, a, b) -> bool:
    """Two runs' costs, rejections and final φ bit for bit."""
    return (a.costs == b.costs and a.n_rejected == b.n_rejected
            and all(torch.equal(x, y) for x, y in
                    zip(core.sgp._fields(a.phi), core.sgp._fields(b.phi))))


def finite_phi(torch, core, phi) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in core.sgp._fields(phi))


def graph_record(st) -> dict:
    g = st.graph_stats or {}
    return {k: g.get(k) for k in ("captures", "replays", "capture_s",
                                  "pool_bytes", "launches_per_replay")}


def robust_paths(torch, core, ops, nets, nbrs, bks, launches) -> None:
    """Per main-path scenario: the inert plan and a guarded fault-free run
    bit for bit the plain fused run, a faulted run in four chunks bit for
    bit the whole one (its fault generator and count too), the K1 / K2
    and K3 launches of each run, and the plain, faulted and guarded runs
    timed in alternating rounds."""
    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.guards import GuardConfig

    def fault_gen(seed):
        return torch.Generator(device=nets["sw_1000"].device).manual_seed(
            seed)
    for name, bucketed in PATHS:
        net, nb, bk = nets[name], nbrs[name], bks[name]
        phi0 = core.spt_phi_sparse(net, nb)
        rk = "edge_rounds_bucketed" if bucketed else "edge_rounds"
        args = (torch, core, ops, net, phi0, nb, bk, bucketed)
        kinds = {
            "plain": {},
            "inert": {"fault_plan": FaultPlan(**ROBUST_INERT)},
            "guarded": {"guards": GuardConfig()},
            "faulted": {"fault_plan": FaultPlan(**ROBUST_FAULTS)}}
        runs, counts, secs = {}, {}, {}
        for kind, kw in kinds.items():
            seed = {"fault_rng": fault_gen(1)} if "fault_plan" in kw else {}
            runs[kind], counts[kind], secs[kind] = robust_run(
                *args, **kw, **seed)
        chunked, counts["faulted 4 chunks"], _ = robust_run(
            *args, chunks=(N_ITERS // 4,) * 4, fault_plan=FaultPlan(
                **ROBUST_FAULTS), fault_rng=fault_gen(1))
        plain = runs["plain"]
        require(same_run(torch, core, plain, runs["inert"]),
                f"{name}: the inert fault plan differs from the plain run")
        require(runs["inert"].fault_state.n_corrupt.item() == 0,
                f"{name}: the inert plan corrupted a row")
        require(same_run(torch, core, plain, runs["guarded"])
                and runs["guarded"].guard_events == [],
                f"{name}: the guarded fault-free run differs from the "
                "plain run")
        fw, fc = runs["faulted"], chunked
        require(same_run(torch, core, fw, fc) and fw.it == fc.it
                and torch.equal(fw.fault_state.gen.get_state(),
                                fc.fault_state.gen.get_state()),
                f"{name}: the chunked faulted run differs from the whole "
                "run")
        require(not same_run(torch, core, plain, fw),
                f"{name}: the faults changed nothing")
        for kind, c in counts.items():
            require(c[rk] > 0 and c["simplex_project"] == 2 * N_ITERS,
                    f"{name} {kind}: launches {c}")
            for k in RECURSION_KERNELS:
                launches[k] += c[k]
        times = {k: [] for k in ("plain", "faulted", "guarded")}
        order = list(times)
        for r in range(ROBUST_ROUNDS):
            for kind in order[r:] + order[:r]:
                kw = dict(kinds[kind])
                if "fault_plan" in kw:
                    kw["fault_rng"] = fault_gen(1)
                st, c, s = robust_run(*args, **kw)
                times[kind].append(s * 1e3 / N_ITERS)
                for k in RECURSION_KERNELS:
                    launches[k] += c[k]
        emit({"phase": "robust", "case": f"{name} fused", "V": net.V,
              "S": net.S, "bucketed": bucketed,
              "faulted_plan": ROBUST_FAULTS, "inert_plan": ROBUST_INERT,
              "bitwise": {"inert_equals_plain": True,
                          "guarded_equals_plain": True,
                          "chunked_equals_whole_faulted": True},
              "final_cost": {k: runs[k].costs[-1] for k in runs},
              "rejected": {k: runs[k].n_rejected for k in runs},
              "launches": {k: {"edge_rounds": c[rk],
                               "simplex_project": c["simplex_project"]}
                           for k, c in counts.items()},
              "graph": {k: graph_record(runs[k]) for k in runs},
              "first_run_s": secs,
              "ms_per_iteration": {k: spread(v) for k, v in times.items()}})


def robust_convergence(torch, core, ops, dev, nets, nbrs, bks,
                       launches) -> None:
    """p = 0.5 participation with staleness 3 for twice the synchronous
    budget: within 1 % of the synchronous final cost on the reference's
    rows, the ratio recorded at full size."""
    from repro_torch.core.faults import FaultPlan
    for name, bucketed, gated in CONVERGE_ROWS:
        if name in nets:
            net, nb, bk = nets[name], nbrs[name], bks[name]
        else:
            net = core.make_scenario(core.TABLE_II[name], device=dev)
            nb, bk = core.build_neighbors(net.adj), None
        phi0 = core.spt_phi_sparse(net, nb)
        out = {}
        for label, n, kw in (
                ("sync", CONVERGE_ITERS, {}),
                ("async", 2 * CONVERGE_ITERS, {
                    "fault_plan": FaultPlan(participation_p=0.5,
                                            staleness_k=3),
                    "fault_rng": torch.Generator(device=dev).manual_seed(
                        2)})):
            st, c, s = robust_run(torch, core, ops, net, phi0, nb, bk,
                                  bucketed, chunks=(n,), **kw)
            for k in RECURSION_KERNELS:
                launches[k] += c[k]
            require(all(map(math.isfinite, st.costs)),
                    f"{name} {label}: a cost is not finite")
            out[label] = {"iterations": n, "final_cost": st.costs[-1],
                          "rejected": st.n_rejected, "seconds": s}
        ratio = out["async"]["final_cost"] / out["sync"]["final_cost"]
        if gated:
            require(ratio <= 1.01, f"{name}: participation 0.5, staleness "
                    f"3 ends {ratio} times the synchronous cost")
        emit({"phase": "robust", "case": f"{name} convergence",
              "V": net.V, "S": net.S, "bucketed": bucketed,
              "gated": gated, "async_over_sync": ratio, **out})


def robust_guards(torch, core, ops, nets, nbrs, launches) -> None:
    """sw_1000 under 20 % corruption with guards: rollbacks and a finite
    iterate; under 100 % corruption without guards: a poisoned one."""
    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.guards import GuardConfig
    net, nb = nets["sw_1000"], nbrs["sw_1000"]
    phi0 = core.spt_phi_sparse(net, nb)
    gen = torch.Generator(device=net.device).manual_seed(3)
    st, c, s = robust_run(
        torch, core, ops, net, phi0, nb, None, False, chunks=(30,),
        fault_plan=FaultPlan(corrupt_p=0.2), fault_rng=gen,
        guards=GuardConfig(checkpoint_every=2, max_retries=64))
    events = st.guard_events
    n_corrupt = st.fault_state.n_corrupt.item()
    require(any(e.action == "rollback" for e in events),
            "sw_1000 corrupt_p=0.2 guarded: no rollback")
    require(finite_phi(torch, core, st.phi)
            and all(map(math.isfinite, st.costs)),
            "sw_1000 corrupt_p=0.2 guarded: a non-finite iterate or cost")
    require(n_corrupt >= len(events), f"sw_1000 guarded: {n_corrupt} "
            f"corruptions for {len(events)} trips")
    u, cu, su = robust_run(
        torch, core, ops, net, phi0, nb, None, False,
        fault_plan=FaultPlan(corrupt_p=1.0),
        fault_rng=torch.Generator(device=net.device).manual_seed(0))
    require(not finite_phi(torch, core, u.phi),
            "sw_1000 corrupt_p=1.0 unguarded: the iterate is not poisoned")
    for k in RECURSION_KERNELS:
        launches[k] += c[k] + cu[k]
    emit({"phase": "robust", "case": "sw_1000 guarded corruption",
          "guarded": {"corrupt_p": 0.2, "iterations": 30, "seconds": s,
                      "n_corrupt": n_corrupt, "trips": len(events),
                      "actions": sorted({e.action for e in events}),
                      "sentinels": sorted({e.sentinel for e in events}),
                      "final_cost": st.costs[-1],
                      "launches": {k: c[k] for k in RECURSION_KERNELS}},
          "unguarded": {"corrupt_p": 1.0, "iterations": N_ITERS,
                        "seconds": su, "poisoned": True,
                        "stopped": u.stopped,
                        "n_corrupt": u.fault_state.n_corrupt.item()}})


def fleet_nets(torch, core, base, b=FLEET_B, seed=0):
    """B variants of `base` on its adjacency: rates, destinations and
    result ratios perturbed from `seed` with numpy, as the reference's
    fleet test (tests/test_fleet.py) draws them."""
    import numpy as np
    rng = np.random.RandomState(seed)
    r0, a0 = base.r.cpu().numpy(), base.a.cpu().numpy()
    dev = base.device
    out = []
    for _ in range(b):
        r = r0 * (0.6 + 0.8 * rng.rand(*r0.shape))
        dest = rng.randint(0, base.V, size=tuple(base.dest.shape))
        a = a0 * (0.5 + rng.rand(*a0.shape))
        out.append(dataclasses.replace(
            base, r=torch.tensor(r, dtype=torch.float32, device=dev),
            dest=torch.tensor(dest, dtype=torch.int64, device=dev),
            a=torch.tensor(a, dtype=torch.float32, device=dev)))
    return out


def robust_fleet(torch, core, ops, nets, nbrs, launches) -> None:
    """A fleet of FLEET_B sw_1000 lanes: one CUDA graph replay an
    iteration for all of them, each lane bit for bit its solo fused run,
    and the fleet's ms an iteration against the eight solo runs' sum in
    alternating rounds."""
    base, nb = nets["sw_1000"], nbrs["sw_1000"]
    fnets = fleet_nets(torch, core, base)
    phi0s = [core.spt_phi_sparse(n, nb) for n in fnets]

    def fleet_run():
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        st = core.init_fleet_state(fnets, phi0s=phi0s, nbrs=nb)
        core.run_fleet_chunk(st, N_ITERS)
        torch.cuda.synchronize()
        return st, ops.launches(), time.perf_counter() - t0

    def solo_runs():
        out, total, cs = [], 0.0, dict.fromkeys(RECURSION_KERNELS, 0)
        for n, p in zip(fnets, phi0s):
            st, c, s = robust_run(torch, core, ops, n, p, nb, None, False)
            out.append(st)
            total += s
            for k in RECURSION_KERNELS:
                cs[k] += c[k]
        return out, cs, total

    fleet, fc, fs = fleet_run()
    solos, sc, ss = solo_runs()
    for b, solo in enumerate(solos):
        require(fleet.costs[b] == solo.costs
                and all(torch.equal(x, y) for x, y in zip(
                    core.sgp._fields(fleet.lane_phi(b)),
                    core.sgp._fields(solo.phi))),
                f"fleet lane {b}: differs from its solo fused run")
    g = fleet.graph_stats
    require(fleet.n_dispatches == N_ITERS and g["captures"] == 1
            and g["replays"] == N_ITERS - 1,
            f"fleet: {fleet.n_dispatches} dispatches, graph {g}")
    want = {"edge_rounds": FLEET_B * (2 + 5 * N_ITERS),
            "simplex_project": FLEET_B * 2 * N_ITERS}
    require({k: fc[k] for k in want} == want
            and {k: sc[k] for k in want} == want,
            f"fleet launches {fc}, solo {sc}, want {want}")
    times = {"fleet": [fs * 1e3 / N_ITERS],
             "solo_sum": [ss * 1e3 / N_ITERS]}
    counted = [fc, sc]
    for r in range(ROBUST_ROUNDS - 1):
        for kind in (("solo_sum", "fleet") if r % 2 == 0
                     else ("fleet", "solo_sum")):
            _, c, s = fleet_run() if kind == "fleet" else solo_runs()
            require({k: c[k] for k in want} == want,
                    f"fleet round {r} {kind}: launches {c}, want {want}")
            counted.append(c)
            times[kind].append(s * 1e3 / N_ITERS)
    for c in counted:
        for k in want:
            launches[k] += c[k]
    med = {k: spread(v)["median"] for k, v in times.items()}
    emit({"phase": "robust", "case": f"fleet B={FLEET_B} sw_1000",
          "bitwise_lanes_equal_solo": True,
          "n_dispatches": fleet.n_dispatches, "graph": {
              k: g.get(k) for k in ("captures", "replays", "capture_s",
                                    "pool_bytes")},
          "launches_per_replay": g.get("launches_per_replay"),
          "launches": {"fleet": {k: fc[k] for k in want},
                       "solo": {k: sc[k] for k in want}},
          "final_costs": [c[-1] for c in fleet.costs],
          "ms_per_iteration": {k: spread(v) for k, v in times.items()},
          "fleet_over_solo_sum": med["fleet"] / med["solo_sum"]})


def robust_phase(torch, core, ops, dev, nets, nbrs, bks) -> dict:
    """The `robust` phase.  Returns the K1-K3 launches of its runs."""
    launches = dict.fromkeys(RECURSION_KERNELS, 0)
    robust_paths(torch, core, ops, nets, nbrs, bks, launches)
    robust_convergence(torch, core, ops, dev, nets, nbrs, bks, launches)
    robust_guards(torch, core, ops, nets, nbrs, launches)
    robust_fleet(torch, core, ops, nets, nbrs, launches)
    return launches


# ------------------------------------------------------ distributed phase
# the task-sharded driver (`core.distributed`): a world of one on NCCL,
# each run bit for bit the single-process driver; the node-sharded
# measurement at one node shard; two processes on the one card over gloo
DIST_WORKER_TIMEOUT = 300
DIST_RTOL = 2e-4           # 2-rank costs against the 1-rank run / golden
DIST_PHI_ATOL = 1e-4       # 2-rank φ against the reference's golden
DIST_COLLECTIVE_REPS = 200


def dist_run(torch, core, ops, net, phi0, bucketed, driver, distributed,
             chunks=(N_ITERS,), **kw):
    """One 20-iteration sparse run from `phi0`, task-sharded over the
    world (`init_distributed_state` + `run_distributed_chunk`) or
    single-process (`init_run_state` + `run_chunk`), the launch counters
    set to 0 just before it.  Returns (state, launches, wall seconds)."""
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    if distributed:
        st = core.init_distributed_state(net, phi0, method="sparse",
                                         bucketed=bucketed, **kw)
        for n in chunks:
            core.run_distributed_chunk(st, n, driver=driver)
    else:
        st = core.init_run_state(net, phi0, method="sparse",
                                 bucketed=bucketed, **kw)
        for n in chunks:
            core.run_chunk(net, st, n, driver=driver)
    torch.cuda.synchronize()
    return st, ops.launches(), time.perf_counter() - t0


def collective_ms(torch, mesh, n: int) -> float:
    """Device ms of one all-reduce of an n-float buffer over the mesh
    (CUDA events around DIST_COLLECTIVE_REPS back-to-back calls)."""
    buf = torch.zeros(n, device=mesh.device)
    return time_ms(torch, lambda: mesh.all_reduce_(buf),
                   DIST_COLLECTIVE_REPS)


def dist_world_one(torch, core, ops, nets, nbrs, launches) -> dict:
    """A world of one: sw_1000 padded and ba_10000 bucketed under both
    drivers bit for bit `run`; faulted and guarded sw_1000 bit for bit
    their single-process runs; a zero-event distributed replay equal to
    `run_distributed`; the node-sharded measurement at one node shard
    equal to `flows_carry_and_cost`.  Returns the sw_1000 host run's
    costs (the 2-rank run is held to them)."""
    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.guards import GuardConfig
    mesh = core.task_mesh()
    require(mesh.size == 1 and "nccl" in mesh.backend,
            f"the world of one is {mesh.size} ranks on {mesh.backend}")
    out = {}
    # the communicator's set-up (at its first collective) outside the times
    dist_run(torch, core, ops, nets["sw_1000"],
             core.spt_phi_sparse(nets["sw_1000"], nbrs["sw_1000"]), False,
             "fused", True, chunks=(2,))
    for name, bucketed in PATHS:
        net = nets[name]
        phi0 = core.spt_phi_sparse(net, nbrs[name])
        rk = "edge_rounds_bucketed" if bucketed else "edge_rounds"
        rec = {}
        for driver in DRIVERS:
            st, c, s = dist_run(torch, core, ops, net, phi0, bucketed,
                                driver, True)
            solo, _, s_solo = dist_run(torch, core, ops, net, phi0,
                                       bucketed, driver, False)
            require(same_run(torch, core, st, solo),
                    f"distributed {name} {driver}: differs from run")
            require(c[rk] > 0 and c["simplex_project"] > 0,
                    f"distributed {name} {driver}: launches {c}")
            for k in RECURSION_KERNELS:
                launches[k] += c[k]
            rec[driver] = {"ms_per_iteration": s * 1e3 / N_ITERS,
                           "run_ms_per_iteration": s_solo * 1e3 / N_ITERS,
                           "final_cost": st.costs[-1],
                           "rejected": st.n_rejected,
                           "launches": {rk: c[rk], "simplex_project":
                                        c["simplex_project"]},
                           "graph": graph_record(st)}
            if name == "sw_1000" and driver == "host":
                out["sw_1000_costs"] = list(st.costs)
        host, fused = rec["host"], rec["fused"]
        require(host["final_cost"] == fused["final_cost"],
                f"distributed {name}: fused differs from host")
        n_buf = nbrs[name].out_nbr.numel() + net.V
        emit({"phase": "distributed", "case": f"{name} world of one",
              "backend": mesh.backend, "bucketed": bucketed,
              "bitwise_equals_run": True, "drivers": rec,
              "all_reduce_floats": n_buf,
              "all_reduce_ms": collective_ms(torch, mesh, n_buf)})
    # faulted and guarded, sw_1000, against their single-process runs
    net, nb = nets["sw_1000"], nbrs["sw_1000"]
    phi0 = core.spt_phi_sparse(net, nb)

    def fgen():
        return torch.Generator(device=net.device).manual_seed(1)
    kinds = {"faulted": {"fault_plan": FaultPlan(**ROBUST_FAULTS)},
             "guarded": {"guards": GuardConfig(checkpoint_every=2,
                                               max_retries=64),
                         "fault_plan": FaultPlan(corrupt_p=0.2)}}
    rec = {}
    for kind, kw in kinds.items():
        st, c, s = dist_run(torch, core, ops, net, phi0, False, "fused",
                            True, fault_rng=fgen(), **kw)
        solo, _, _ = dist_run(torch, core, ops, net, phi0, False, "fused",
                              False, fault_rng=fgen(), **kw)
        require(st.costs == solo.costs
                and st.n_rejected == solo.n_rejected
                and st.fault_state.n_corrupt.item()
                == solo.fault_state.n_corrupt.item()
                and [(e.it, e.sentinel) for e in st.guard_events]
                == [(e.it, e.sentinel) for e in solo.guard_events],
                f"distributed sw_1000 {kind}: differs from run")
        require(finite_phi(torch, core, st.phi) == finite_phi(
            torch, core, solo.phi), f"distributed sw_1000 {kind}: φ")
        for k in RECURSION_KERNELS:
            launches[k] += c[k]
        rec[kind] = {"ms_per_iteration": s * 1e3 / N_ITERS,
                     "final_cost": st.costs[-1],
                     "n_corrupt": st.fault_state.n_corrupt.item(),
                     "trips": len(st.guard_events),
                     "launches": {k: c[k] for k in RECURSION_KERNELS}}
    emit({"phase": "distributed", "case": "sw_1000 faulted / guarded",
          "bitwise_equals_run": True, "runs": rec})
    # a zero-event replay on the distributed driver
    torch.cuda.synchronize()
    ops.reset_launches()
    eng = core.ReplayEngine(net, driver="distributed",
                            invariant_checks=False)
    eng.play(core.ChurnSchedule(events=()), tail_iters=N_ITERS)
    torch.cuda.synchronize()
    c = ops.launches()
    _, h = core.run_distributed(net, phi0, n_iters=N_ITERS,
                                method="sparse")
    require(eng.costs == h["costs"], "distributed zero-event replay != "
            "run_distributed")
    require(c["edge_rounds"] > 0 and c["simplex_project"] > 0,
            f"distributed replay: launches {c}")
    for k in RECURSION_KERNELS:
        launches[k] += c[k]
    # the node-sharded measurement at one node shard
    nmesh = core.task_node_mesh(1, 1)
    t0 = time.perf_counter()
    carry, cost = core.node_flows_carry_and_cost(net, phi0, nb, nmesh)
    torch.cuda.synchronize()
    node_s = time.perf_counter() - t0
    ref, ref_cost = core.flows_carry_and_cost(net, phi0, "sparse", nbrs=nb)
    bitwise = all(torch.equal(getattr(carry, f), getattr(ref, f))
                  for f in ("t_data", "t_result", "F", "G"))
    require(bitwise and torch.equal(cost, ref_cost),
            "node-sharded measurement at one shard != flows_carry_and_cost")
    emit({"phase": "distributed", "case": "sw_1000 replay and node shard",
          "replay_zero_event_equals_run_distributed": True,
          "replay_launches": {k: c[k] for k in RECURSION_KERNELS},
          "node_shard_bitwise": True, "node_shard_seconds": node_s,
          "cost": float(cost)})
    return out


def dist_worker(rank: int, port: int, out_path: str) -> int:
    """One rank of the 2-rank gloo run on the one card (host driver):
    abilene cut to S = 9 (the reference's 2-device golden) and sw_1000,
    each rank's costs, φ and launches written to `out_path`."""
    import dataclasses
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch import core
    from repro_torch.kernels import ops
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    mesh = core.task_mesh()
    out = {"rank": mesh.rank, "size": mesh.size, "backend": mesh.backend}
    net = core.make_scenario(core.TABLE_II["abilene"])
    keep = slice(0, net.S - 1)
    net = dataclasses.replace(net, dest=net.dest[keep], r=net.r[keep],
                              a=net.a[keep], w=net.w[keep],
                              task_type=net.task_type[keep])
    for method, phi0 in (("sparse", core.spt_phi_sparse(net)),
                         ("dense", core.spt_phi(net))):
        phi, h = core.run_distributed(net, phi0, n_iters=20, method=method,
                                      driver="host", mesh=mesh)
        out[f"abilene_{method}"] = {
            "costs": h["costs"], "n_rejected": h["n_rejected"],
            "phi": {f.name: getattr(phi, f.name).cpu().numpy().tolist()
                    for f in dataclasses.fields(phi)}}
    sw = core.make_scenario(core.TABLE_II["sw_1000"])
    phi0 = core.spt_phi_sparse(sw)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    _, h = core.run_distributed(sw, phi0, n_iters=N_ITERS, method="sparse",
                                driver="host", mesh=mesh)
    torch.cuda.synchronize()
    out["sw_1000"] = {"costs": h["costs"], "n_rejected": h["n_rejected"],
                      "seconds": time.perf_counter() - t0,
                      "launches": ops.launches()}
    with open(out_path, "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def dist_two_ranks(torch, src, sw_costs) -> dict:
    """Two processes on the one card over gloo, host driver: abilene at
    S = 9 held to `reference_distributed.json`, sw_1000 to the 1-rank
    run's accepted costs, both ranks alike.  Returns the K1 / K3 launches
    of the ranks' sw_1000 runs."""
    import socket
    import tempfile

    import numpy as np
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with open(os.path.join(src, "repro_torch", "data",
                           "reference_distributed.json")) as f:
        gold = json.load(f)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        paths = [os.path.join(d, f"rank{r}.json") for r in range(2)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--distributed-worker", str(r), str(port), paths[r]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        try:
            logs = [p.communicate(timeout=DIST_WORKER_TIMEOUT)[0]
                    for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, log in zip(procs, logs):
            require(p.returncode == 0, f"2-rank worker failed:\n"
                    f"{log[-3000:]}")
        ranks = []
        for p in paths:
            with open(p) as f:
                ranks.append(json.load(f))
    seconds = time.perf_counter() - t0
    worst = {}
    for r in ranks:
        for method in ("sparse", "dense"):
            got, want = r[f"abilene_{method}"], gold[method]
            require(got["n_rejected"] == want["n_rejected"]
                    and len(got["costs"]) == len(want["costs"]),
                    f"2-rank abilene {method}: rejections or length differ "
                    "from the golden")
            rel = max(abs(a - b) / abs(b)
                      for a, b in zip(got["costs"], want["costs"]))
            phi_err = max(float(np.max(np.abs(np.asarray(got["phi"][k])
                                              - np.asarray(v))))
                          for k, v in want["phi"].items())
            require(rel <= DIST_RTOL and phi_err <= DIST_PHI_ATOL,
                    f"2-rank abilene {method}: costs {rel}, φ {phi_err} "
                    "from the golden")
            worst[method] = max(worst.get(method, 0.0), rel)
        sw = r["sw_1000"]
        require(len(sw["costs"]) == len(sw_costs),
                "2-rank sw_1000: accepted steps differ from the 1-rank run")
        rel = max(abs(a - b) / abs(b) for a, b in zip(sw["costs"], sw_costs))
        require(rel <= DIST_RTOL, f"2-rank sw_1000: costs {rel} from the "
                "1-rank run")
        worst["sw_1000"] = max(worst.get("sw_1000", 0.0), rel)
        require(sw["launches"]["edge_rounds"] > 0
                and sw["launches"]["simplex_project"] > 0,
                f"2-rank sw_1000: launches {sw['launches']}")
    require(ranks[0]["sw_1000"]["costs"] == ranks[1]["sw_1000"]["costs"],
            "2-rank sw_1000: the ranks read different costs")
    emit({"phase": "distributed", "case": "2 ranks on one card, gloo, host",
          "backend": ranks[0]["backend"],
          "max_rel_err": worst, "rtol": DIST_RTOL,
          "phi_atol": DIST_PHI_ATOL,
          "sw_1000_ms_per_iteration": [
              r["sw_1000"]["seconds"] * 1e3 / N_ITERS for r in ranks],
          "sw_1000_launches": [
              {k: r["sw_1000"]["launches"][k] for k in RECURSION_KERNELS}
              for r in ranks],
          "seconds": seconds})
    return {k: sum(r["sw_1000"]["launches"][k] for r in ranks)
            for k in RECURSION_KERNELS}


def distributed_phase(torch, core, ops, src, nets, nbrs, bks) -> dict:
    """The `distributed` phase.  Returns the K1-K3 launches of its
    world-of-one runs (the 2-rank run's are in its record)."""
    launches = dict.fromkeys(RECURSION_KERNELS, 0)
    out = dist_world_one(torch, core, ops, nets, nbrs, launches)
    dist_two_ranks(torch, src, out["sw_1000_costs"])
    return launches


# ----------------------------------------------------------- router phase
# the SGP request router at the full-size cluster `router_256`
# (`serving.router.router_256`: V = 273, S_cap 32, Dmax 257) against the
# JAX router's run (`reference_router.json`)
ROUTER_RTOL = 2e-4
# the warm steps after the drift's rebaseline move by up to 4.35e-4 when
# the reference's own capacities move by one ulp (`python
# tests/test_torch_router.py --ulp-witness`, ROADMAP §3): its costs are
# held at 1e-3, its baselines and final cost at ROUTER_RTOL
ROUTER_DRIFT_RTOL = 1e-3
ROUTER_STREAM = 100_000
K1_ROUTER_REPS = 200          # K1 calls a timing window at the router's tiles
K1_ROUTER_AGREE = 2.0         # graph-timed and profiler readings agree within
ROUTER_L1_SIGMAS = 3.0


def router_golden(src) -> dict:
    with open(os.path.join(src, "repro_torch", "data",
                           "reference_router.json")) as f:
        return json.load(f)


def router_plan_check(label, router, want) -> float:
    """A plan's accepted costs and rejections against the golden's."""
    got = router.history
    require(got["n_rejected"] == want["n_rejected"]
            and len(got["costs"]) == len(want["costs"]),
            f"router {label}: {got['n_rejected']} rejections, "
            f"{len(got['costs'])} costs against {want['n_rejected']}, "
            f"{len(want['costs'])}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(got["costs"],
                                                  want["costs"]))
    require(rel <= ROUTER_RTOL, f"router {label}: costs {rel} from the "
            "golden")
    return rel


def router_phase(torch, core, ops, src) -> dict:
    """The `router` phase: `router_256`'s plan (fused ≡ host bit for bit,
    held to the golden), plan(distributed=True) ≡ plan() at a world of
    one, a 100,000-request stream through observe + sampled decide,
    greedy_plan against the optimum, the busiest pod's failover and a
    drift with one class admitted, each held to the golden.  Returns
    the K1-K3 launches of its plans."""
    import numpy as np
    from repro_torch.kernels import ref
    from repro_torch.kernels.edge_rounds import edge_rounds_cuda, k1_plan
    from repro_torch.serving.router import (RequestRouter, feed_steady,
                                            router_256)
    gold = router_golden(src)
    spec = router_256()
    launches = dict.fromkeys(RECURSION_KERNELS, 0)
    n_iters = gold["n_iters"]

    RequestRouter(**spec).plan(n_iters=2)     # warm: SPT rows, kernels

    def planned(label, **kw):
        r = RequestRouter(**spec)
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        s = r.plan(n_iters=n_iters, **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        c = ops.launches()
        require(c["edge_rounds"] > 0 and c["simplex_project"] > 0,
                f"router {label}: launches {c}")
        for k in RECURSION_KERNELS:
            launches[k] += c[k]
        return r, s, seconds, c
    r, s, sec, c = planned("plan")
    rh, sh, sec_h, _ = planned("plan host", driver="host")
    rd, sd, sec_d, _ = planned("plan distributed", distributed=True)
    require(r.net.V == gold["V"] and r.net.S == gold["S"],
            f"router_256 is V={r.net.V}, S={r.net.S}")
    rel = router_plan_check("plan", r, gold["plan"])
    for other, label in ((rh, "host driver"), (rd, "distributed")):
        require(other.history["costs"] == r.history["costs"]
                and all(torch.equal(a, b) for a, b in zip(
                    core.sgp._fields(other.phi), core.sgp._fields(r.phi))),
                f"router plan ({label}) differs from plan() bit for bit")
    cost_rel = abs(s["total_cost"] - gold["plan"]["total_cost"]) / abs(
        gold["plan"]["total_cost"])
    require(cost_rel <= ROUTER_RTOL and s["residual"]["loop_free"],
            f"router plan: total cost {cost_rel} from the golden")
    # K1 at the router's tiles: the traffic solve of the planned φ
    nb = r.nbrs
    phi_d = core.network._phi_edge_views(r.phi, nb)[0]
    w_in = phi_d[:, nb.in_nbr, nb.in_slot].contiguous()
    args = (w_in, r.net.r.contiguous(), nb.in_nbr.to(torch.int32),
            nb.in_mask.to(torch.uint8), "sum", 0.0, nb.V)
    x, rounds = edge_rounds_cuda(*args)
    xr, _ = ref.edge_rounds_ref(w_in, r.net.r, nb.in_nbr, nb.in_mask, "sum",
                                0.0, nb.V)
    require(torch.equal(x, xr), "K1 at router_256's tiles: kernel != plain")
    plan = k1_plan(w_in.shape[0], nb.V, w_in.shape[2])
    k1 = {"shape": list(w_in.shape), "reps": K1_ROUTER_REPS,
          "ms": graph_ms(torch, lambda: edge_rounds_cuda(*args),
                         K1_ROUTER_REPS),
          "plain_ms": time_ms(torch, lambda: ref.edge_rounds_ref(
              w_in, r.net.r, nb.in_nbr, nb.in_mask, "sum", 0.0, nb.V), 3),
          "cluster": plan.size, "tiles_in_smem": plan.tiles}
    # the bound: every input read once, x written once; a multiply-add a
    # lane each round this run's rows ran
    n_bytes = sum(t.numel() * t.element_size() for t in args[:4]) + (
        x.numel() * x.element_size())
    k1["bound_ms"], k1["bound_by"] = bound_ms(
        n_bytes, 2.0 * nb.V * nb.Dmax * int(rounds.sum()))
    # the profiler's reading of the same call: the kernel's own events,
    # one a call, and every device event of the window beside them; a
    # window that kept only part of K1's launches still times each one
    # it kept
    for attempt in range(3):
        events = device_events(torch, lambda: edge_rounds_cuda(*args),
                               K1_ROUTER_REPS)
        kern = [v for key, v in events.items()
                if "edge_rounds_kernel" in key]
        if len(kern) == 1 and kern[0][0] == K1_ROUTER_REPS:
            break
        emit({"phase": "profiler_window_partial", "attempt": attempt,
              "events": events})
    require(len(kern) == 1 and 2 * kern[0][0] >= K1_ROUTER_REPS,
            f"K1 at router_256's tiles: the profiler's device events "
            f"{events}")
    k1["profiler_ms"] = kern[0][1] / 1e3 / kern[0][0]
    k1["profiler_launches_kept"] = kern[0][0]
    k1["profiler_events"] = events
    ratio = max(k1["ms"], k1["profiler_ms"]) / min(k1["ms"],
                                                    k1["profiler_ms"])
    require(ratio <= K1_ROUTER_AGREE,
            f"K1 at router_256's tiles: the graph-timed {k1['ms']} ms and "
            f"the profiler's {k1['profiler_ms']} ms part by {ratio}x")
    k1["agree_within"] = K1_ROUTER_AGREE
    emit({"phase": "router", "case": "router_256 plan", "V": r.net.V,
          "S": r.net.S, "Dmax": nb.Dmax, "iterations": n_iters,
          "seconds": {"fused": sec, "host": sec_h, "distributed": sec_d},
          "ms_per_iteration": {"fused": sec * 1e3 / n_iters,
                               "host": sec_h * 1e3 / n_iters,
                               "distributed": sec_d * 1e3 / n_iters},
          "max_rel_err_vs_reference": rel, "total_cost": s["total_cost"],
          "theorem1": s["residual"]["theorem1"],
          "fused_equals_host": True, "distributed_equals_plan": True,
          "launches": {k: c[k] for k in RECURSION_KERNELS},
          "k1_router_tiles": k1})
    # the request stream on the distributed router (its plan is plan()'s)
    demand = rd.net.r[:, 1:1 + rd.F].cpu().numpy()
    p = (demand / demand.sum()).ravel()
    rng = np.random.RandomState(0)
    picks = rng.choice(p.size, size=ROUTER_STREAM, p=p)
    toks = rng.poisson(20.0, size=ROUTER_STREAM) + 1
    stream = [(rd.class_names[k // rd.F], k % rd.F, int(t))
              for k, t in zip(picks, toks)]
    rd._decision_table()
    counts = np.zeros(rd.P)
    t, t0 = 0.0, time.perf_counter()
    for name, f, tok in stream:
        t += 1e-3
        rd.observe(name, f, tok, t)
        counts[rd.decide(name, f, rng=rng)] += 1
    us = (time.perf_counter() - t0) * 1e6 / ROUTER_STREAM
    share = sd["dispatch"].sum(0) / sd["dispatch"].sum()
    l1 = float(np.abs(counts / ROUTER_STREAM - share).sum())
    bound = ROUTER_L1_SIGMAS * float(np.sqrt(share * (1.0 - share)
                                             / ROUTER_STREAM).sum())
    require(l1 <= bound, f"router stream: pick frequencies {l1} from the "
            f"plan's dispatch shares, bound {bound}")
    # greedy against the optimum
    g = r.greedy_plan()
    g_rel = abs(g["total_cost"] - gold["greedy"]["total_cost"]) / abs(
        gold["greedy"]["total_cost"])
    require(g["total_cost"] > s["total_cost"] and g_rel <= ROUTER_RTOL
            and g["assignment"].tolist() == gold["greedy"]["assignment"],
            f"router greedy: cost {g['total_cost']} against the plan's "
            f"{s['total_cost']}, {g_rel} from the golden")
    emit({"phase": "router", "case": "router_256 stream and greedy",
          "requests": ROUTER_STREAM, "us_per_request": us,
          "l1_pick_vs_dispatch": l1, "l1_bound": bound,
          "l1_bound_rule": f"{ROUTER_L1_SIGMAS} x sum_p sqrt(q_p (1 - q_p)"
                           " / n), q the plan's dispatch shares",
          "greedy_cost": g["total_cost"], "plan_cost": s["total_cost"],
          "greedy_over_plan": g["total_cost"] / s["total_cost"]})
    # the busiest pod's failover, warm
    victim = int(np.argmax(s["dispatch"].sum(axis=0)))
    require(victim == gold["failover"]["pod"],
            f"router: busiest pod {victim}, golden's {gold['failover']['pod']}")
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    s2 = r.on_pod_failure(victim, n_iters=n_iters)
    torch.cuda.synchronize()
    fail_s = time.perf_counter() - t0
    cf = ops.launches()
    for k in RECURSION_KERNELS:
        launches[k] += cf[k]
    frel = router_plan_check("failover", r, gold["failover"])
    require(s2["dispatch"][:, victim].sum() < 1e-6,
            "router failover: the failed pod still computes")
    # drift: one class up 1.5x, one new class admitted
    ds = gold["drift_spec"]
    rates = {name: np.array(spec["demand"][m], dtype=np.float64)
             for m, name in enumerate(spec["classes"])}
    rates[ds["class"]] = rates[ds["class"]] * ds["factor"]
    rates[ds["new_class"]] = np.full(spec["n_frontends"], ds["new_rate"])
    feed_steady(r, rates, seconds=ds["seconds"], dt=ds["dt"],
                a={ds["new_class"]: ds["new_a"]})
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = r.maybe_rebaseline(threshold=ds["threshold"],
                             n_iters=ds["n_iters"])
    torch.cuda.synchronize()
    drift_s = time.perf_counter() - t0
    cd = ops.launches()
    for k in RECURSION_KERNELS:
        launches[k] += cd[k]
    want = gold["rebaseline"]
    require(res["admissions"] == want["admissions"]
            and r._dynamic[ds["new_class"]] == want["slot"]
            and [x.kind for x in r._live.records] == want["records"]
            and len(r._live.costs) == len(want["costs"]),
            f"router drift: {res['admissions']}, "
            f"{[x.kind for x in r._live.records]} against the golden's")
    by_step = [abs(a - b) / abs(b) for a, b in zip(r._live.costs,
                                                   want["costs"])]
    drel = max(by_step)
    n_base = len(want["records"]) + 1        # T⁰ of each segment
    require(drel <= ROUTER_DRIFT_RTOL
            and max(by_step[:n_base] + by_step[-1:]) <= ROUTER_RTOL
            and res["drift"] == want["drift"],
            f"router drift: costs {by_step}, drift {res['drift']}")
    emit({"phase": "router", "case": "router_256 failover and drift",
          "failed_pod": victim, "failover_seconds": fail_s,
          "failover_max_rel_err": frel,
          "failover_cost": r.history["costs"][-1],
          "drift": res["drift"], "admissions": res["admissions"],
          "rebaseline_seconds": drift_s, "rebaseline_max_rel_err": drel,
          "rebaseline_rel_err_by_step": by_step,
          "rebaseline_rtol": ROUTER_DRIFT_RTOL,
          "launches": {"failover": {k: cf[k] for k in RECURSION_KERNELS},
                       "rebaseline": {k: cd[k] for k in RECURSION_KERNELS}}})
    return launches


def stacked_check(torch, label, w, b, solve):
    """The stacked pair of fixed points (`w`, `b`: two problems along the
    task axis) against each half solved alone: equal bit for bit."""
    whole = solve(w, b)
    h = w.shape[0] // 2
    halves = torch.cat([solve(w[:h].contiguous(), b[:h].contiguous()),
                        solve(w[h:].contiguous(), b[h:].contiguous())])
    torch.cuda.synchronize()
    require(torch.equal(whole, halves), f"{label}: the stacked solve "
            "differs from the unstacked ones")
    emit({"phase": "stacked_check", "case": label, "shape": list(w.shape),
          "bitwise": True, "max_path_len": float(whole.max())})


def drive_path(torch, core, ops, net, phi0, nbrs, bks, bucketed, opts,
               driver):
    """One 20-iteration run of a sparse path from `phi0` through
    `init_run_state` and `run_chunk`, the launch counters set to 0 just
    before it.  Returns (state, launch counts, wall seconds)."""
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    state = core.init_run_state(net, phi0, method="sparse", nbrs=nbrs,
                                bucketed=bucketed,
                                buckets=bks if bucketed else None)
    core.run_chunk(net, state, N_ITERS, driver=driver, **opts)
    torch.cuda.synchronize()
    return state, ops.launches(), time.perf_counter() - t0


def profile_paths(torch, core, ops, nets, nbrs, bks, top=12):
    """Device time by kernel name and the device's busy share over one
    traced 20-iteration run of each sparse path under each driver."""
    from torch.profiler import ProfilerActivity, profile
    for label, opts, _ in PATH_OPTIONS:
        for name, bucketed in PATHS:
            # φ⁰ is built outside the trace (it reads the graph back)
            args = (torch, core, ops, nets[name],
                    core.spt_phi_sparse(nets[name], nbrs[name]), nbrs[name],
                    bks[name], bucketed, opts)
            for driver in DRIVERS:
                # one untraced run first: the trace sees warm plans
                drive_path(*args, driver)
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    _, _, seconds = drive_path(*args, driver)
                wall_ms = seconds * 1e3
                # device-side events only (kernels, copies): a CPU op's
                # row also carries its kernels' time; CUPTI's own buffer
                # requests are no device work
                rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                        for e in prof.key_averages()
                        if str(e.device_type).endswith("CUDA")
                        and e.self_device_time_total > 0
                        and e.key != "Activity Buffer Request"]
                device_ms = sum(r[1] for r in rows)
                rows.sort(key=lambda r: -r[1])
                # each port kernel over all its template instantiations
                port = {k: {"ms": sum(ms for key, ms, _ in rows
                                      if tag in key),
                            "calls": sum(n for key, _, n in rows
                                         if tag in key)}
                        for k, tag in PATH_KERNEL_NAMES.items()}
                emit({"phase": "profile", "scenario": name,
                      "options": label, "driver": driver,
                      "wall_ms": wall_ms, "device_ms": device_ms,
                      "busy_share": device_ms / wall_ms if wall_ms else None,
                      "port_kernels": {k: v for k, v in port.items()
                                       if v["calls"]},
                      "top": [{"kernel": k[:80], "ms": ms, "calls": n}
                              for k, ms, n in rows[:top]]})


def profile_robust(torch, core, ops, nets, nbrs, bks, top=12):
    """Device time by kernel name and the busy share over one traced
    20-iteration fused run of each main-path scenario, plain, faulted
    and guarded (the `robust` phase's plans)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.guards import GuardConfig
    for name, bucketed in PATHS:
        net = nets[name]
        args = (torch, core, ops, net, core.spt_phi_sparse(net, nbrs[name]),
                nbrs[name], bks[name], bucketed)
        for kind, kw in (("plain", {}),
                         ("faulted", {"fault_plan": FaultPlan(
                             **ROBUST_FAULTS)}),
                         ("guarded", {"guards": GuardConfig()})):
            robust_run(*args, **kw)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                _, _, seconds = robust_run(*args, **kw)
            rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                    for e in prof.key_averages()
                    if str(e.device_type).endswith("CUDA")
                    and e.self_device_time_total > 0
                    and e.key != "Activity Buffer Request"]
            device_ms = sum(r[1] for r in rows)
            rows.sort(key=lambda r: -r[1])
            emit({"phase": "profile", "scenario": name, "robust": kind,
                  "wall_ms": seconds * 1e3, "device_ms": device_ms,
                  "busy_share": device_ms / (seconds * 1e3),
                  "top": [{"kernel": k[:80], "ms": ms, "calls": n}
                          for k, ms, n in rows[:top]]})


# the port's sparse-path kernels as the profiler names them (each
# template instantiation is a row of its own)
PATH_KERNEL_NAMES = {"edge_rounds": "edge_rounds_kernel<",
                     "edge_rounds_bucketed": "edge_rounds_bucketed_kernel<",
                     "simplex_project": "simplex_project"}


def path_launch_ms(torch, core, net, phi0, nbrs, bks, bucketed, opts,
                   n_iters=3) -> dict:
    """Device ms a launch of each port kernel on the path's own (warm)
    inputs: one traced host-driver run of `n_iters` iterations, every
    instantiation of a kernel summed, and each instantiation on its own
    (`<true, ..., float, float, float>` is the longest-path recursion:
    max over float32; the taint closure's max runs in bfloat16)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        core.run(net, phi0, n_iters=n_iters, method="sparse",
                 bucketed=bucketed, nbrs=nbrs,
                 buckets=bks if bucketed else None, driver="host", **opts)
        torch.cuda.synchronize()
    out = {}
    for k, tag in PATH_KERNEL_NAMES.items():
        rows = [(e.key, e.self_device_time_total, e.count)
                for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA") and tag in e.key]
        n = sum(c for _, _, c in rows)
        if n:
            out[k] = {"ms": sum(t for _, t, _ in rows) / 1e3 / n,
                      "launches": n,
                      "instantiations": [
                          {"kernel": key[key.index(tag):][:90],
                           "ms": t / 1e3 / c, "launches": c}
                          for key, t, c in rows]}
    return out


def bisection_halvings(torch, ref, phi, delta, M, perm, n_iter=60,
                       weight=None):
    """Halvings the rows of this input need: each row counts until its
    own bracket stops moving (the oracle's loop, row by row).  Returns
    (halvings summed over rows, the same weighted by `weight` [R])."""
    q, w, _, lo, hi = ref.dual_setup(phi, delta, M, perm)
    live = torch.ones_like(lo, dtype=torch.bool)
    wt = (torch.ones_like(lo, dtype=torch.float64) if weight is None
          else weight.double().reshape(lo.shape))
    total = torch.zeros((), dtype=torch.float64, device=phi.device)
    work = torch.zeros((), dtype=torch.float64, device=phi.device)
    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        up = torch.clamp_min(q - mid * w, 0.0).sum(-1, keepdim=True) > 1.0
        lo2, hi2 = torch.where(up, mid, lo), torch.where(up, hi, mid)
        total += live.sum()
        work += (live * wt).sum()
        live = live & ((lo2 != lo) | (hi2 != hi))
        lo, hi = lo2, hi2
        if not bool(live.any()):
            break
    return float(total), float(work)


def record_path_operands(torch, core, ops, net, nbrs, bks, bucketed,
                         opts=None, method="sparse"):
    """The operands of every K1, K2 and K3 call of one iteration of
    `core.run` (host driver, run options `opts`; its initial flow solves
    included; from `spt_phi_sparse` on the sparse engine, from `spt_phi`
    on the dense one, whose only kernel is K3), copied as the wrappers
    receive them: {"edge_rounds" | "edge_rounds_bucketed" |
    "simplex_project": [all arguments, defaults filled in]}."""
    rec = {"edge_rounds": [], "edge_rounds_bucketed": [],
           "simplex_project": []}
    real = {k: getattr(ops, f"{k}_cuda") for k in rec}

    def recorder(kind):
        sig = inspect.signature(real[kind])

        def call(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            rec[kind].append(tuple(a.clone() if torch.is_tensor(a) else a
                                   for a in bound.arguments.values()))
            return real[kind](*args, **kwargs)
        return call

    for k in rec:
        setattr(ops, f"{k}_cuda", recorder(k))
    try:
        if method == "sparse":
            core.run(net, core.spt_phi_sparse(net, nbrs), n_iters=1,
                     method="sparse", bucketed=bucketed, nbrs=nbrs,
                     buckets=bks if bucketed else None, driver="host",
                     **(opts or {}))
        else:
            core.run(net, core.spt_phi(net), n_iters=1, method=method,
                     driver="host", **(opts or {}))
        torch.cuda.synchronize()
    finally:
        for k, fn in real.items():
            setattr(ops, f"{k}_cuda", fn)
    return rec


def ptxas_summary(report: str) -> dict:
    """Most registers of any kernel of one source, and its spill lines,
    each after the (mangled) name of the function it is about."""
    regs = [int(w) for ln in report.splitlines() if "registers" in ln
            for w, nxt in zip(ln.split(), ln.split()[1:])
            if nxt.startswith("registers") and w.isdigit()]
    spills, fn = [], ""
    for ln in report.splitlines():
        if "Function properties for" in ln:
            fn = ln.split("Function properties for")[-1].strip()
        elif "spill" in ln and not ln.strip().startswith(
                "0 bytes stack frame, 0 bytes spill stores, 0 bytes "
                "spill loads"):
            spills.append(f"{fn}: {ln.strip()}")
    return {"kernels": len(regs), "max_registers": max(regs, default=0),
            "spills": spills[:8]}


def allclose(torch, got, want, tol: float):
    """(max abs error, whether |got - want| <= tol + tol·|want| holds)."""
    d = (got.float() - want.float()).abs()
    return float(d.max()), bool((d <= tol + tol * want.float().abs()).all())


def attention_kernel_checks(torch, emit_kernel):
    """K4 and K5 against their plain versions at the serving shapes, in
    float32 and bfloat16, with PyTorch's SDPA timed on the same inputs."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(1)
    tol = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
    peak = {torch.float32: PEAK_F32_FLOPS, torch.bfloat16: PEAK_BF16_FLOPS}

    def randn(*shape, dt):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    hd = 128
    # (B, H, KV, Lq, Lk, hd, causal, case): Qwen3-0.6B's prefill (16
    # heads over 8 KV heads) at four lengths, OLMoE's (16 over 16, group
    # size 1) at three, Qwen2-VL-7B's (28 over 4, group 7) at two; then
    # whisper-base's (8 over 8, hd 64): the encoder over its 1,500
    # frames, the decoder's causal self attention at two prompt lengths,
    # and its cross attention, L prompt rows against the 1,500 frames
    shapes = [(1, 16, 8, L, L, hd, True, f"qwen3 prefill L={L} causal")
              for L in (17, 128, 333, 512)]
    shapes += [(1, 16, 16, L, L, hd, True, f"olmoe prefill L={L} causal")
               for L in (17, 333, 512)]
    shapes += [(1, 28, 4, L, L, hd, True, f"qwen2vl prefill L={L} causal")
               for L in (333, 512)]
    F = 1500
    shapes += [(1, 8, 8, F, F, 64, False,
                f"whisper encoder F={F} non-causal")]
    shapes += [(1, 8, 8, L, L, 64, True, f"whisper decoder L={L} causal")
               for L in (333, 512)]
    shapes += [(1, 8, 8, L, F, 64, False,
                f"whisper cross L={L} against F={F}") for L in (17, 333, 512)]
    for dt in (torch.float32, torch.bfloat16):
        for B, H, KV, Lq, Lk, hd_s, causal, case in shapes:
            # the model's [B, L, heads, hd] activations, transposed views
            q = randn(B, Lq, H, hd_s, dt=dt).transpose(1, 2)
            k = randn(B, Lk, KV, hd_s, dt=dt).transpose(1, 2)
            v = randn(B, Lk, KV, hd_s, dt=dt).transpose(1, 2)
            out = flash_attention_cuda(q, k, v, causal=causal)
            torch.cuda.synchronize()
            want = ref.flash_attention_ref(q, k, v, causal=causal)
            err, ok = allclose(torch, out, want, tol[dt])
            require(ok, f"K4 {case} {dt}: max abs err {err} beyond "
                    f"{tol[dt]}")
            lib_err = allclose(torch, sdpa(q, k, v, is_causal=causal,
                                           enable_gqa=True), want, tol[dt])[0]
            calls = (lambda: flash_attention_cuda(q, k, v, causal),
                     lambda: ref.flash_attention_ref(q, k, v, causal),
                     lambda: sdpa(q, k, v, is_causal=causal,
                                  enable_gqa=True))
            ms, plain, lib_ms = (device_ms(torch, fn, 20) for fn in calls)
            ev_ms, ev_plain, ev_lib = (time_ms(torch, fn, 20)
                                       for fn in calls)
            n_bytes = (2 * B * H * Lq + 2 * B * KV * Lk) * hd_s \
                * q.element_size()
            pairs = Lq * (Lq + 1) / 2 if causal else Lq * Lk
            n_ops = 4.0 * B * H * hd_s * pairs
            bms, by = bound_ms(n_bytes, n_ops, peak[dt])
            emit({"phase": "kernel", "kernel": "flash_attention",
                  "case": case, "dtype": str(dt),
                  "q": [B, H, Lq, hd_s], "kv": [B, KV, Lk, hd_s],
                  "max_abs_err": err, "tol": tol[dt], "ms": ms,
                  "plain_ms": plain, "sdpa_ms": lib_ms,
                  "sdpa_ratio": ms / lib_ms,
                  "event_ms": [ev_ms, ev_plain, ev_lib],
                  "sdpa_max_abs_err": lib_err, "bound_ms": bms,
                  "bound_by": by})
            emit_kernel("flash_attention", max_abs_err=err,
                        main=(case == "qwen3 prefill L=512 causal"
                              and dt == torch.bfloat16), ms=ms,
                        plain_ms=plain, bound_ms=bms, bound_by=by,
                        library_ms=lib_ms)

    # off the path: a group of 2 at hd 64 on the tensor cores, and the
    # CUDA-core kernel for bf16 at hd 80, causal and on cross lengths
    for L, Lk, hd_x, causal in ((100, 100, 64, False), (77, 77, 80, True),
                                (45, 130, 80, False)):
        q = randn(1, 4, L, hd_x, dt=torch.bfloat16)
        k = randn(1, 2, Lk, hd_x, dt=torch.bfloat16)
        v = randn(1, 2, Lk, hd_x, dt=torch.bfloat16)
        out = flash_attention_cuda(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err, ok = allclose(torch, out, ref.flash_attention_ref(
            q, k, v, causal=causal), 2e-2)
        require(ok, f"K4 L={L} Lk={Lk} hd={hd_x}: max abs err {err} beyond "
                "2e-2")
        emit({"phase": "kernel", "kernel": "flash_attention",
              "case": f"L={L} Lk={Lk} hd={hd_x} causal={causal}",
              "dtype": "torch.bfloat16", "max_abs_err": err})
        emit_kernel("flash_attention", max_abs_err=err)

    # Qwen3-0.6B's decode (8 KV heads, group 2), then OLMoE's (16, 1):
    # ragged lengths from 1 to 1024 (the path's record), every length 1,
    # every length S, and a single request at S
    S = 1024
    ragged = [1, 1024, 17, 512, 333, 1000, 64, 777]
    len_cases = (("lengths 1..1024", ragged),
                 ("every length 1", [1] * 8),
                 ("every length 1024", [S] * 8),
                 ("B=1 length 1024", [S]))
    # (KV, G, hd, S, lengths label, lengths, model)
    dec_shapes = [(KV, G, hd, S, label, lens, model)
                  for (KV, G, model), (label, lens) in itertools.product(
                      ((8, 2, "qwen3"), (16, 1, "olmoe")), len_cases)]
    # Qwen2-VL-7B's decode (4 KV heads, group 7), whisper-base's self
    # attention (8, 1, hd 64) on ragged lengths and its cross attention
    # on the 1,500 frames, every row all of them
    dec_shapes += [(4, 7, hd, S, "lengths 1..1024", ragged, "qwen2vl"),
                   (8, 1, 64, S, "lengths 1..1024", ragged, "whisper self"),
                   (8, 1, 64, F, f"every length {F}", [F] * 8,
                    "whisper cross")]
    for dt, (KV, G, hd_s, S_c, label, lens, model) in itertools.product(
            (torch.float32, torch.bfloat16), dec_shapes):
        B = len(lens)
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        n_pos = sum(lens)
        mask = (torch.arange(S_c, device="cuda")[None]
                < lengths[:, None])[:, None, None, :]
        q = randn(B, KV, G, hd_s, dt=dt)
        kc, vc = (randn(B, S_c, KV, hd_s, dt=dt),
                  randn(B, S_c, KV, hd_s, dt=dt))
        out = decode_attention_cuda(q, kc, vc, lengths)
        torch.cuda.synchronize()
        want = ref.decode_attention_ref(q, kc, vc, lengths)
        err, ok = allclose(torch, out, want, tol[dt])
        require(ok, f"K5 {model} {label} {dt}: max abs err {err} beyond "
                f"{tol[dt]}")
        qs = q.reshape(B, KV * G, 1, hd_s)
        ks, vs = kc.transpose(1, 2), vc.transpose(1, 2)

        def lib():
            return sdpa(qs, ks, vs, attn_mask=mask, enable_gqa=True)
        lib_err = allclose(torch, lib().reshape(B, KV, G, hd_s), want,
                           tol[dt])[0]
        calls = (lambda: decode_attention_cuda(q, kc, vc, lengths),
                 lambda: ref.decode_attention_ref(q, kc, vc, lengths), lib)
        ms, plain, lib_ms = (device_ms(torch, fn, 20) for fn in calls)
        ev_ms, ev_plain, ev_lib = (time_ms(torch, fn, 20) for fn in calls)
        elt = q.element_size()
        n_bytes = (2 * n_pos * KV * hd_s + 2 * B * KV * G * hd_s) * elt \
            + 4 * B
        n_ops = 4.0 * hd_s * G * KV * n_pos
        bms, by = bound_ms(n_bytes, n_ops, peak[dt])
        emit({"phase": "kernel", "kernel": "decode_attention",
              "case": f"{model} decode B={B}, S={S_c}, {label}",
              "dtype": str(dt),
              "q": [B, KV, G, hd_s], "cache": [B, S_c, KV, hd_s],
              "positions": n_pos, "max_abs_err": err, "tol": tol[dt],
              "ms": ms, "plain_ms": plain, "sdpa_ms": lib_ms,
              "sdpa_ratio": ms / lib_ms,
              "event_ms": [ev_ms, ev_plain, ev_lib],
              "sdpa_max_abs_err": lib_err, "bound_ms": bms, "bound_by": by})
        emit_kernel("decode_attention", max_abs_err=err,
                    main=(dt == torch.bfloat16 and model == "qwen3"
                          and label == len_cases[0][0]), ms=ms,
                    plain_ms=plain,
                    bound_ms=bms, bound_by=by, library_ms=lib_ms)

    # K5 off the path: hd 50 is no multiple of a 16-byte vector (the
    # element-by-element loads) and G = 3 puts four query rows in a CTA
    for dt in (torch.float32, torch.bfloat16):
        lengths = torch.tensor([1, 64, 300], dtype=torch.int32,
                               device="cuda")
        q = randn(3, 2, 3, 50, dt=dt)
        kc, vc = randn(3, 300, 2, 50, dt=dt), randn(3, 300, 2, 50, dt=dt)
        out = decode_attention_cuda(q, kc, vc, lengths)
        torch.cuda.synchronize()
        err, ok = allclose(torch, out, ref.decode_attention_ref(
            q, kc, vc, lengths), tol[dt])
        require(ok, f"K5 hd=50 G=3 {dt}: max abs err {err} beyond "
                f"{tol[dt]}")
        emit({"phase": "kernel", "kernel": "decode_attention",
              "case": "B=3, S=300, hd=50, G=3, lengths 1, 64, 300",
              "dtype": str(dt), "max_abs_err": err})
        emit_kernel("decode_attention", max_abs_err=err)

    # K4 and K5 captured in one CUDA graph (their wrappers read no device
    # value on the host), K4 also on whisper's cross lengths: replays on
    # new inputs copied into the captured tensors, new lengths too, hold
    # against the plain versions
    B, L, S = 8, 333, 1024
    q, kc, vc = (randn(B, 8, 2, hd, dt=torch.bfloat16),
                 randn(B, S, 8, hd, dt=torch.bfloat16),
                 randn(B, S, 8, hd, dt=torch.bfloat16))
    lengths = torch.ones(B, dtype=torch.int32, device="cuda")
    qp, kp, vp = (randn(1, L, h, hd, dt=torch.bfloat16).transpose(1, 2)
                  for h in (16, 8, 8))
    qx = randn(1, L, 8, 64, dt=torch.bfloat16).transpose(1, 2)
    kx, vx = (randn(1, F, 8, 64, dt=torch.bfloat16).transpose(1, 2)
              for _ in range(2))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            decode_attention_cuda(q, kc, vc, lengths)
            flash_attention_cuda(qp, kp, vp, True)
            flash_attention_cuda(qx, kx, vx, False)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        dec = decode_attention_cuda(q, kc, vc, lengths)
        pre = flash_attention_cuda(qp, kp, vp, True)
        cross = flash_attention_cuda(qx, kx, vx, False)
    errs = []
    for lens in ([1, 1024, 17, 512, 333, 1000, 64, 777], [S] * B):
        for t in (q, kc, vc, qp, kp, vp, qx, kx, vx):
            t.copy_(torch.randn(t.shape, generator=gen, device="cuda"))
        lengths.copy_(torch.tensor(lens, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        for name, got, want in (
                ("decode_attention", dec,
                 ref.decode_attention_ref(q, kc, vc, lengths)),
                ("flash_attention", pre,
                 ref.flash_attention_ref(qp, kp, vp, True)),
                ("flash_attention", cross,
                 ref.flash_attention_ref(qx, kx, vx, False))):
            err, ok = allclose(torch, got, want, 2e-2)
            require(ok, f"{name} in a CUDA graph: max abs err {err} beyond "
                    "2e-2")
            errs.append(err)
            emit_kernel(name, max_abs_err=err)
    emit({"phase": "kernel", "kernel": "flash_attention+decode_attention",
          "case": "captured in one CUDA graph (K4 also at L=333 against "
                  f"F={F}), two replays on new inputs",
          "dtype": "torch.bfloat16", "max_abs_err": max(errs)})
    del graph


def ssd_ops(B, L, H, P, N, Q=SSD_BOUND_CHUNK) -> float:
    """Floating-point operations of the chunked SSD at chunk Q: per chunk
    of q tokens the causal C·Bᵀ tile (q(q+1)/2·N multiply-adds, shared
    by the heads), the causal intra-chunk product (q(q+1)/2·H·P), the
    state read and the state update (q·N·H·P each); two operations a
    multiply-add."""
    total = 0.0
    for t0 in range(0, L, Q):
        q = min(Q, L - t0)
        tri = q * (q + 1) / 2
        total += tri * N + tri * H * P + 2.0 * q * N * H * P
    return 2.0 * B * total


def kernel_launches(torch, fn, prefix: str, want: int) -> int:
    """Launches of the port's kernels named `prefix`... in one call of
    `fn`, as the profiler records them: the most of up to five windows,
    taken again while one counts fewer than `want` (the profiler loses
    events, it does not add them)."""
    n = 0
    for attempt in range(5):
        events = device_events(torch, fn, 1)
        n = max(n, sum(c for key, (c, _) in events.items()
                       if port_prefix(key) == prefix))
        if n >= want:
            break
        emit({"phase": "profiler_window_partial", "attempt": attempt,
              "prefix": prefix, "launches": n})
        time.sleep(1.0)
    return n


def ssd_kernel_checks(torch, emit_kernel):
    """K6 against its plain version (the chunked SSD at chunk min(256, L))
    at the Mamba2-130M prefill's shapes, x [B, L, 24, 64], dt [B, L, 24],
    A [24], B/C [B, L, 128], in float32 and bfloat16, and at two ragged
    shapes off the path: y and the final state.  Inputs as the model
    makes them: x, B and C through SiLU, dt through softplus, A =
    -exp(A_log) with A_log in [0, log 16].  Each record carries the
    wrapper's plan (heads a CTA, grid, each kernel's shared memory, which
    must equal the source's own count) and the kernel launches a call
    makes (counted by the profiler, which must be the wrapper's
    KERNEL_LAUNCHES)."""
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import ssd_scan as smod
    gen = torch.Generator(device="cuda").manual_seed(2)
    silu = torch.nn.functional.silu
    # y: float32 sums of up to a few hundred terms taken in another order
    # (the kernel's chunk of 64 against the plain version's 256): 1e-4;
    # in bfloat16 y is rounded once on both sides and may land one ulp
    # apart (2^-8 relative): 1e-2.  The final state is float32 from the
    # same inputs in both dtypes: 1e-4.
    y_tol = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
    s_tol = 1e-4
    f32, bf16 = torch.float32, torch.bfloat16
    mamba = (24, 64, 128)                        # H, P, N

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    # (B, L, dtype, from an initial state, (H, P, N))
    cases = [(1, L, dt, False, mamba) for dt in (f32, bf16)
             for L in (17, 128, 256, 512)]
    cases += [(4, 256, dt, False, mamba) for dt in (f32, bf16)]
    cases += [(2, 128, f32, True, mamba)]
    cases += [(1, 25, bf16, False, mamba), (1, 63, bf16, False, mamba),
              (1, 512, bf16, True, mamba)]
    # 20 chunks, a hand-off of 20 steps, 4 heads a CTA
    cases += [(2, 1280, bf16, True, mamba)]
    cases += [(2, 70, dt, True, (3, 40, 20)) for dt in (f32, bf16)]
    cases += [(1, 130, dt, True, (5, 136, 256)) for dt in (f32, bf16)]
    lib = _build.load("ssd_scan")
    for B, L, dt_, with_init, (H, P, N) in cases:
        x = silu(randn(B, L, H, P)).to(dt_)
        Bm, Cm = silu(randn(B, L, N)).to(dt_), silu(randn(B, L, N)).to(dt_)
        dt = torch.nn.functional.softplus(randn(B, L, H) - 1.0)
        A = -torch.exp(torch.rand((H,), generator=gen, device="cuda")
                       * math.log(16.0))
        init = randn(B, H, N, P) if with_init else None
        plan = smod.ssd_plan(B, L, H, P, N, dt_ == bf16)
        smem = [lib.ssd_scan_smem(int(dt_ == bf16), N, plan.heads, k)
                for k in (0, 1)]
        require(smem == [plan.smem_states, plan.smem_output],
                f"K6: the plan's shared memory {plan} is not the "
                f"source's {smem}")
        y, state = smod.ssd_scan_cuda(x, dt, A, Bm, Cm, init_state=init)
        torch.cuda.synchronize()
        wy, ws = ref.ssd_scan_ref(x, dt, A, Bm, Cm, init_state=init)
        err_y, ok_y = allclose(torch, y, wy, y_tol[dt_])
        err_s, ok_s = allclose(torch, state, ws, s_tol)
        label = f"K6 B={B} L={L} {dt_}" + (" init" if with_init else "") \
            + ("" if (H, P, N) == mamba else f" H={H} P={P} N={N}")
        require(y.dtype == dt_ and state.dtype == torch.float32,
                f"{label}: output dtypes {y.dtype}, {state.dtype}")
        require(ok_y, f"{label}: y max abs err {err_y} beyond {y_tol[dt_]}")
        require(ok_s, f"{label}: final state max abs err {err_s} beyond "
                f"{s_tol}")
        calls = (lambda: smod.ssd_scan_cuda(x, dt, A, Bm, Cm,
                                            init_state=init),
                 lambda: ref.ssd_scan_ref(x, dt, A, Bm, Cm,
                                          init_state=init))
        ms, plain = (device_ms(torch, fn, 10) for fn in calls)
        ev_ms, ev_plain = (time_ms(torch, fn, 10) for fn in calls)
        launches = kernel_launches(torch, calls[0], "ssd_scan",
                                   smod.KERNEL_LAUNCHES)
        require(launches == smod.KERNEL_LAUNCHES, f"{label}: {launches} "
                f"kernel launches a call, not {smod.KERNEL_LAUNCHES}")
        elt = x.element_size()
        n_bytes = (2 * x.numel() + Bm.numel() + Cm.numel()) * elt \
            + 4 * (dt.numel() + H + state.numel()
                   + (init.numel() if with_init else 0))
        # bf16 runs its products on the tensor cores
        bms, by = bound_ms(n_bytes, ssd_ops(B, L, H, P, N),
                           PEAK_BF16_FLOPS if dt_ == bf16 else PEAK_F32_FLOPS)
        emit({"phase": "kernel", "kernel": "ssd_scan", "case": label,
              "x": [B, L, H, P], "N": N, "dtype": str(dt_),
              "heads_a_cta": plan.heads, "grid": list(plan.grid(B)),
              "smem_bytes": smem, "kernel_launches": launches,
              "max_abs_err": err_y, "tol": y_tol[dt_],
              "state_max_abs_err": err_s, "state_tol": s_tol,
              "max_abs_y": float(wy.float().abs().max()),
              "ms": ms, "plain_ms": plain, "event_ms": [ev_ms, ev_plain],
              "bound_ms": bms, "bound_by": by})
        emit_kernel("ssd_scan", max_abs_err=max(err_y, err_s),
                    main=(B == 1 and L == 512 and dt_ == bf16
                          and not with_init),
                    ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                    library_ms=None)


def gmm_kernel_checks(torch, emit_kernel):
    """K7 against its plain version at OLMoE's expert products, x [64, C,
    2048] @ w [64, 2048, 1024] (wg, wu) and x [64, C, 1024] @ w [64,
    1024, 2048] (wd), C in {4, 52, 80} (the decode step's capacity and
    the prefill's at 333 and 512 tokens), plus two ragged shapes off the
    path (the second not 16-byte aligned: the CUDA-core kernel in
    bfloat16 too), in float32 (rtol 1e-5 of Σ_d |x·w|) and bfloat16 (one
    ulp, 2^-7), with torch.bmm timed on the same inputs as a yardstick
    (`bmm_ratio`).  At C = 4, as in a decode step, 40 of the 64 experts
    are also marked active with the others' rows zero: the kernel must
    equal its dense run bit for bit and the plain version to the same
    tolerance, and its time is put beside the dense one.  Last, one
    launch with `active` captured in a CUDA graph, replayed on new inputs
    and new active sets."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.moe_gmm import moe_gmm_cuda
    gen = torch.Generator(device="cuda").manual_seed(3)
    # float32: sums of up to 2048 products in another order; rounding
    # works on the partial sums, so an output's error scales with
    # Σ_d |x·w| (the kernel and cuBLAS part by ~1e-4 where a sum of
    # magnitude ~1e3 cancels to near 0), and rtol 1e-5 is of that;
    # bfloat16: both sides round one float32 sum, at most one ulp (2^-7
    # of the value) apart
    tol = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
    peak = {torch.float32: PEAK_F32_FLOPS, torch.bfloat16: PEAK_BF16_FLOPS}
    cases = [(64, C, D, F) for C in (4, 52, 80)
             for D, F in ((2048, 1024), (1024, 2048))]
    cases += [(3, 17, 200, 72), (2, 5, 37, 19)]
    for dt in (torch.float32, torch.bfloat16):
        for E, C, D, F in cases:
            x = torch.randn((E, C, D), generator=gen, device="cuda").to(dt)
            w = torch.randn((E, D, F), generator=gen, device="cuda").to(dt)
            out = moe_gmm_cuda(x, w)
            torch.cuda.synchronize()
            want = ref.moe_gmm_ref(x, w)
            if dt == torch.float32:
                d = (out - want).abs()
                err = float(d.max())
                ok = bool((d <= tol[dt] * ref.moe_gmm_ref(x.abs(),
                                                          w.abs())).all())
            else:
                err, ok = allclose(torch, out, want, tol[dt])
            label = f"K7 [{E},{C},{D}]@[{E},{D},{F}] {dt}"
            require(out.dtype == dt and out.shape == (E, C, F),
                    f"{label}: output {out.dtype} {tuple(out.shape)}")
            require(ok, f"{label}: max abs err {err} beyond {tol[dt]}")
            calls = (lambda: moe_gmm_cuda(x, w),
                     lambda: ref.moe_gmm_ref(x, w),
                     lambda: torch.bmm(x, w))
            ms, plain, lib_ms = (device_ms(torch, fn, 10) for fn in calls)
            elt = x.element_size()
            n_bytes = (E * C * D + E * D * F + E * C * F) * elt
            bms, by = bound_ms(n_bytes, 2.0 * E * C * D * F, peak[dt])
            emit({"phase": "kernel", "kernel": "moe_gmm", "case": label,
                  "x": [E, C, D], "w": [E, D, F], "dtype": str(dt),
                  "max_abs_err": err, "tol": tol[dt],
                  "max_abs_out": float(want.float().abs().max()),
                  "ms": ms, "plain_ms": plain, "bmm_ms": lib_ms,
                  "bmm_ratio": ms / lib_ms, "bound_ms": bms, "bound_by": by})
            emit_kernel("moe_gmm", max_abs_err=err,
                        main=(dt == torch.bfloat16 and C == 4 and D == 2048
                              and E == 64),
                        ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                        library_ms=lib_ms)
            if E == 64 and C == 4:
                gmm_active_case(torch, gen, x, w, dt, tol[dt], emit_kernel)
    gmm_graph_case(torch, gen, tol[torch.bfloat16], emit_kernel)


def gmm_active_case(torch, gen, x, w, dt, tol, emit_kernel, n_active=40):
    """K7 at a decode step's C = 4 with `n_active` of 64 experts holding
    rows (the others' rows zero) and `active` given: equal to the dense
    kernel on the same inputs, and to the plain version within `tol`;
    timed beside the dense kernel on the same inputs; the bound counts
    the active experts' bytes only."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.moe_gmm import moe_gmm_cuda
    E, C, D = x.shape
    F = w.shape[-1]
    active = torch.zeros(E, dtype=torch.bool, device="cuda")
    active[torch.randperm(E, generator=gen, device="cuda")[:n_active]] = True
    xa = x * active[:, None, None].to(dt)
    got = moe_gmm_cuda(xa, w, active)
    dense = moe_gmm_cuda(xa, w)
    torch.cuda.synchronize()
    want = ref.moe_gmm_ref(xa, w, active)
    label = f"K7 [{E},{C},{D}]@[{E},{D},{F}] {dt}, {n_active} active"
    require(torch.equal(got, dense), f"{label}: != the dense kernel")
    if dt == torch.float32:
        d = (got - want).abs()
        err = float(d.max())
        ok = bool((d <= tol * ref.moe_gmm_ref(xa.abs(), w.abs())).all())
    else:
        err, ok = allclose(torch, got, want, tol)
    require(ok, f"{label}: max abs err {err} beyond {tol}")
    calls = (lambda: moe_gmm_cuda(xa, w, active),
             lambda: moe_gmm_cuda(xa, w),
             lambda: ref.moe_gmm_ref(xa, w, active),
             lambda: torch.bmm(xa, w))
    ms, dense_ms, plain, lib_ms = (device_ms(torch, fn, 10) for fn in calls)
    peak = PEAK_BF16_FLOPS if dt == torch.bfloat16 else PEAK_F32_FLOPS
    n_bytes = (n_active * (C * D + D * F) + E * C * F) * x.element_size()
    bms, by = bound_ms(n_bytes, 2.0 * n_active * C * D * F, peak)
    emit({"phase": "kernel", "kernel": "moe_gmm", "case": label,
          "x": [E, C, D], "w": [E, D, F], "dtype": str(dt),
          "active": n_active, "equal_to_dense": True, "max_abs_err": err,
          "tol": tol, "ms": ms, "dense_ms": dense_ms,
          "active_ratio": ms / dense_ms, "plain_ms": plain, "bmm_ms": lib_ms,
          "bmm_ratio": ms / lib_ms, "bound_ms": bms, "bound_by": by})
    emit_kernel("moe_gmm", max_abs_err=err)


def gmm_graph_case(torch, gen, tol, emit_kernel):
    """One bfloat16 K7 launch with `active` captured in a CUDA graph (the
    wrapper reads no device value on the host), replayed on new inputs
    and new active sets copied into the captured tensors."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.moe_gmm import moe_gmm_cuda
    E, C, D, F = 64, 4, 2048, 1024
    x = torch.zeros((E, C, D), dtype=torch.bfloat16, device="cuda")
    w = torch.zeros((E, D, F), dtype=torch.bfloat16, device="cuda")
    active = torch.ones(E, dtype=torch.bool, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            moe_gmm_cuda(x, w, active)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = moe_gmm_cuda(x, w, active)
    errs = []
    for n_active in (40, 17):
        act = torch.zeros(E, dtype=torch.bool, device="cuda")
        act[torch.randperm(E, generator=gen, device="cuda")[:n_active]] = True
        active.copy_(act)
        x.copy_(torch.randn(x.shape, generator=gen, device="cuda")
                * act[:, None, None])
        w.copy_(torch.randn(w.shape, generator=gen, device="cuda"))
        graph.replay()
        torch.cuda.synchronize()
        err, ok = allclose(torch, out, ref.moe_gmm_ref(x, w, active), tol)
        require(ok, f"moe_gmm in a CUDA graph ({n_active} active): max abs "
                f"err {err} beyond {tol}")
        require(bool((out[~act] == 0).all()), "moe_gmm in a CUDA graph: an "
                "inactive expert's output is not zero")
        errs.append(err)
        emit_kernel("moe_gmm", max_abs_err=err)
    emit({"phase": "kernel", "kernel": "moe_gmm",
          "case": "[64,4,2048]@[64,2048,1024] with active, captured in a "
                  "CUDA graph, two replays on new inputs and active sets",
          "dtype": "torch.bfloat16", "max_abs_err": max(errs)})
    del graph


def watch_tokens(eng, on_token, on_call=None) -> None:
    """Call `on_token(req, logits_row)` with the logits row behind every
    token `eng` (a `ServingEngine`) hands a request, prefill and decode,
    by wrapping its model's `prefill` and `decode_step` and its `admit`
    and `step`; the engine's own code is untouched.  `on_call()`, if
    given, runs right after each model call (a prefill or a decode
    step), before its tokens are handed out.  `del eng.admit, eng.step`
    undoes the last two."""
    model, last = eng.model, {}

    class Watched:
        def __getattr__(self, name):
            return getattr(model, name)

        def prefill(self, *args):
            out = model.prefill(*args)
            last["logits"] = out[0]
            if on_call is not None:
                on_call()
            return out

        def decode_step(self, *args):
            out = model.decode_step(*args)
            last["logits"] = out[0]
            if on_call is not None:
                on_call()
            return out

    eng.model = Watched()
    admit, step = eng.admit, eng.step

    def watched_admit(req):
        did = admit(req)
        if did:
            on_token(req, last["logits"][0])
        return did

    def watched_step():
        before = list(eng.active)
        did = step()
        if did:
            for i, req in enumerate(before):
                if req is not None:
                    on_token(req, last["logits"][i])
        return did

    eng.admit, eng.step = watched_admit, watched_step


def serve_run(torch, model, prompts, on_token=None, on_call=None):
    """The serving requests through a fresh engine: (requests, stats)
    with the launch counts of this run alone and host-clock times of
    each admission and decode step (each ends in a synchronize);
    `on_token` as in `watch_tokens`, called outside the timed calls,
    `on_call` inside them."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.serving import Request, ServeConfig, ServingEngine
    eng = ServingEngine(model, ServeConfig(**SERVE_CONFIG))
    reqs = [Request(i, np.asarray(p, np.int32))
            for i, p in enumerate(prompts)]
    stats = {"prefill_ms": [], "decode_ms": []}
    admit, step = eng.admit, eng.step

    def timed(fn, key):
        def run(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            did = fn(*args)
            torch.cuda.synchronize()
            if did:
                stats[key].append((time.perf_counter() - t0) * 1e3)
            return did
        return run

    eng.admit, eng.step = timed(admit, "prefill_ms"), timed(step,
                                                            "decode_ms")
    if on_token is not None:            # outside the timers
        watch_tokens(eng, on_token, on_call)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats["base_gb"] = torch.cuda.memory_allocated() / 1e9
    ops.reset_launches()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    stats["seconds"] = time.perf_counter() - t0
    del eng.admit, eng.step     # the wrappers close over the engine
    stats["mstate"] = eng.mstate
    stats["launches"] = ops.launches()
    stats["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    stats["tokens"] = sum(len(r.out) for r in reqs)
    return reqs, stats


def check_serve_run(reqs, stats, n_layers, label, per_prefill, per_decode):
    """Every request done with the length its budget and EOS dictate;
    n_layers times `per_prefill[k]` launches of each kernel k per prefill
    and `per_decode[k]` per decode step, and none of any other kernel."""
    eos, budget = SERVE_CONFIG["eos_id"], SERVE_CONFIG["max_new_tokens"]
    for r in reqs:
        require(r.done, f"{label}: request {r.rid} not done")
        cap = min(budget + 1, SERVE_CONFIG["max_len"] - len(r.prompt))
        if eos in r.out:
            require(r.out.index(eos) == len(r.out) - 1
                    and len(r.out) <= cap,
                    f"{label}: request {r.rid} runs past EOS")
        else:
            require(len(r.out) == cap, f"{label}: request {r.rid} has "
                    f"{len(r.out)} tokens, not {cap}")
    counts = stats["launches"]
    want = {k: n_layers * (len(stats["prefill_ms"]) * per_prefill.get(k, 0)
                           + len(stats["decode_ms"]) * per_decode.get(k, 0))
            for k in counts}
    require(counts == want, f"{label}: launches {counts} != {want}")


def serve_summary(stats) -> dict:
    pre, dec = stats["prefill_ms"], sorted(stats["decode_ms"])
    return {"requests": len(pre), "decode_steps": len(dec),
            "tokens": stats["tokens"], "seconds": stats["seconds"],
            "tokens_per_s": stats["tokens"] / stats["seconds"],
            "prefill_ms_mean": sum(pre) / len(pre),
            "prefill_ms": pre,
            "decode_ms_mean": sum(dec) / len(dec),
            "decode_ms_median": dec[len(dec) // 2],
            "peak_memory_gb": stats["peak_gb"],
            "allocated_before_gb": stats["base_gb"],
            "launches": stats["launches"], "card": CARD["nvidia_smi"]}


@contextlib.contextmanager
def reversed_keys(torch, dims=False, keys=True):
    """Within it the plain attention (`kernels.ref`, the `attn_impl="ref"`
    path) takes the keys and values in reverse order, and with `dims`
    each score's sum over the head dim in reverse order too: the same
    function with its float32 sums taken in another order (segment ids
    too, and differentiable: the training witness).  keys=False leaves
    the keys in order (with `dims`: the head dims alone reversed)."""
    from repro_torch.kernels import ref
    d = -1 if dims else ()
    kd = 2 if keys else ()

    def flash(q, k, v, causal=True, segment_ids=None):
        S, g = q.shape[2], q.shape[1] // k.shape[1]
        kf = k.float().flip(kd).flip(d).repeat_interleave(g, dim=1)
        vf = v.float().flip(kd).repeat_interleave(g, dim=1)
        s = (q.float().flip(d) @ kf.transpose(-1, -2)) * q.shape[-1] ** -0.5
        keep = ref.attention_mask(S, causal, segment_ids, q.device)
        if keep is not None:
            s = torch.where(keep.flip(-1) if keys else keep, s, ref.NEG_INF)
        return ref._softmax_pv(s, vf).to(q.dtype)

    def decode(q, k_cache, v_cache, lengths):
        S, hd = k_cache.shape[1], k_cache.shape[-1]
        kf = k_cache.float().transpose(1, 2).flip(2).flip(d)
        vf = v_cache.float().transpose(1, 2).flip(2)
        s = (q.float().flip(d) @ kf.transpose(-1, -2)) * hd ** -0.5
        keep = (torch.arange(S, device=q.device)[None]
                < lengths[:, None]).flip(-1)
        s = torch.where(keep[:, None, None], s, ref.NEG_INF)
        return ref._softmax_pv(s, vf).to(q.dtype)

    saved = ref.flash_attention_ref, ref.decode_attention_ref
    ref.flash_attention_ref, ref.decode_attention_ref = flash, decode
    try:
        yield
    finally:
        ref.flash_attention_ref, ref.decode_attention_ref = saved


def reversed_orders(torch):
    """`reversed_keys` with the head-dim sums reversed too: the witness
    of the serves without qk-norm (whisper-base, Qwen2-VL-7B), whose
    random scores reach the hundreds, so that the rounding of the q·k
    sums, which the kernels take in their own order, moves the logits
    more than that of the sums over the keys."""
    return reversed_keys(torch, dims=True)


@contextlib.contextmanager
def split_p(torch, parts=2):
    """Within it the plain attention carries its probabilities P into
    the product with V as `parts` bfloat16 parts (P = p1 + p2 + ...,
    each the bfloat16 rounding of what the earlier parts leave), all
    else float32, as K4's bfloat16 forward feeds P to its tensor-core
    product; segment ids taken, differentiable (the casts pass the
    gradient on, so the backward is the plain one)."""
    from repro_torch.kernels import ref

    def flash(q, k, v, causal=True, segment_ids=None):
        S, g = q.shape[2], q.shape[1] // k.shape[1]
        kf = k.float().repeat_interleave(g, dim=1)
        vf = v.float().repeat_interleave(g, dim=1)
        s = (q.float() @ kf.transpose(-1, -2)) * q.shape[-1] ** -0.5
        keep = ref.attention_mask(S, causal, segment_ids, q.device)
        if keep is not None:
            s = torch.where(keep, s, ref.NEG_INF)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        acc, rest = 0.0, p
        for _ in range(parts):
            piece = rest.to(torch.bfloat16).float()
            acc = acc + piece @ vf
            rest = rest - piece
        return (acc / p.sum(-1, keepdim=True).clamp_min(1e-30)).to(q.dtype)

    saved = ref.flash_attention_ref
    ref.flash_attention_ref = flash
    try:
        yield
    finally:
        ref.flash_attention_ref = saved


@contextlib.contextmanager
def sequential_ssd(torch):
    """Within it the plain SSD scan (`kernels.ref.ssd_scan_ref`, the
    `impl="ref"` path) is `ssd_sequential`, the token-by-token recurrence:
    the same function with its float32 sums taken in another order."""
    from repro_torch.kernels import ref
    from repro_torch.models.layers.ssd import ssd_sequential

    def scan(x, dt, A, Bm, Cm, init_state=None, chunk=256):
        return ssd_sequential(x, dt, A, Bm, Cm, init_state=init_state)

    saved = ref.ssd_scan_ref
    ref.ssd_scan_ref = scan
    try:
        yield
    finally:
        ref.ssd_scan_ref = saved


@contextlib.contextmanager
def reversed_sums(torch):
    """Within it the plain attention takes its keys in reverse order (as
    `reversed_keys`) and the plain grouped matmul (`kernels.ref.
    moe_gmm_ref`) its sums over D in reverse order: the MoE LM's plain
    versions with their float32 sums taken in another order."""
    from repro_torch.kernels import ref

    def gmm(x, w, active=None):
        out = torch.bmm(x.float().flip(-1), w.float().flip(1))
        if active is not None:
            out = torch.where(active.bool()[:, None, None], out, 0.0)
        return out.to(x.dtype)

    saved = ref.moe_gmm_ref
    ref.moe_gmm_ref = gmm
    try:
        with reversed_keys(torch):
            yield
    finally:
        ref.moe_gmm_ref = saved


def logit_gap(run, base) -> dict:
    """Max abs and relative L2 distance between two serving runs' logits
    rows, (requests, {(rid, step): row}), at every step they
    share: the prefill, then each decode step while both have handed
    the request the same tokens."""
    (reqs, rows), (b_reqs, b_rows) = run, base
    worst, num, den, n = 0.0, 0.0, 0.0, 0
    for r, b in zip(reqs, b_reqs):
        for t in range(min(len(r.out), len(b.out))):
            x, y = rows[(r.rid, t)], b_rows[(b.rid, t)]
            worst = max(worst, float((x - y).abs().max()))
            num += float(((x - y) ** 2).sum())
            den += float((y ** 2).sum())
            n += 1
            if r.out[t] != b.out[t]:
                break
    return {"max_abs": worst, "rel_l2": math.sqrt(num / den), "rows": n}


def one_ulp_shift(torch, model, golden) -> float:
    """The float32 witness: the largest relative change (against
    max(|logit|, 1)) of the prefill's logits at the golden's top-5
    indices when every entry of the embedding table moves by one ulp
    (times 1 + 2^-23), each prefill from the zero model state.  Printed
    beside the float32 serve's gap from the golden, whose rtol it shows
    the model's own sensitivity to."""
    from repro_torch.models import module
    saved = model.embed.detach().clone()
    worst = 0.0
    for r in golden["requests"]:
        prompt = torch.as_tensor([r["prompt"]], device=model.device)
        idx = torch.as_tensor(r["top5_indices"][0], device=model.device)
        rows = []
        for scale in (1.0, 1.0 + 2.0 ** -23):
            with torch.no_grad():
                model.embed.copy_(saved * scale)
            cache = module.zeros(model.init_cache_specs(1, prompt.shape[1]),
                                 model.device)
            state = module.zeros(model.state_specs(), model.device)
            rows.append(model.prefill(state, cache, prompt,
                                      *stub_feats(torch, model, 1))[0][
                                          0, idx].float())
        worst = max(worst, float(((rows[1] - rows[0]).abs()
                                  / rows[0].abs().clamp_min(1.0)).max()))
    with torch.no_grad():
        model.embed.copy_(saved)
    return worst


def stub_feats(torch, model, batch) -> tuple:
    """What a prefill of `batch` rows takes besides the prompt: for an
    encoder-decoder model the engine's stub, zero frame features [batch,
    n_enc_frames, d_model] float32; nothing for any other."""
    cfg = model.cfg
    if cfg.family != "encdec":
        return ()
    return (torch.zeros((batch, cfg.n_enc_frames, cfg.d_model),
                        device=model.device),)


def serve_checks(torch, src, arch, golden_name, n_requests, witness,
                 per_prefill, per_decode, f32_layers=None, draw="numpy",
                 on_f32=None, on_bf16=None):
    """A serving phase at `arch`'s full width: float32 against the JAX
    golden `golden_name` (at `f32_layers` layers where given, as the
    golden), then bfloat16 through the kernels, timed and counted, and
    through the plain versions and the `witness` (a context in which the
    plain versions take their float32 sums in another order), its
    weights the float32 run's numpy draw (`draw="numpy"`) or drawn on
    the card (`"torch"`).  `on_f32(model, golden)` and `on_bf16(model)`
    run more checks on the two models.  Returns the launch counts of
    the bfloat16 kernel run and what --profile needs."""
    from repro_torch import configs
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.launch.serve import load_model
    from repro_torch.models import build_model, module
    golden = load_golden(src, golden_name, arch, n_requests)
    cfg = configs.get_config(arch)
    cfg32 = cfg if f32_layers is None else cfg.replace(n_layers=f32_layers)
    require(golden["config"] == json.loads(json.dumps(
        {k: getattr(cfg32, k) for k in golden["config"]})),
        f"{golden_name} names another configuration")
    t0 = time.perf_counter()
    specs = build_model(cfg32, device="meta").param_specs()
    tree = module.init(specs, SERVE_SEED)
    emit({"phase": "serve_weights", "arch": arch, "dtype": "float32",
          "n_layers": cfg32.n_layers, "params": module.param_count(specs),
          "seconds": time.perf_counter() - t0})
    prompts = [r["prompt"] for r in golden["requests"]]

    # float32, TF32 off, against the JAX engine's tokens and logits
    model = build_model(float32_config(torch, cfg32))
    model.load_state_dict(lm_params_from_numpy(model.cfg, tree,
                                               model.device))
    if draw != "numpy":
        del tree
    gidx = {r["rid"]: r["top5_indices"] for r in golden["requests"]}
    seen, f32_first = {}, {}

    def gather(req, row):
        t = len(req.out) - 1
        if t == 0:
            f32_first[req.rid] = row.float().cpu()
        if t < len(gidx[req.rid]):
            idx = torch.as_tensor(gidx[req.rid][t], device=row.device)
            seen[(req.rid, t)] = row.float()[idx]

    label = f"{arch} float32 serve ({cfg32.n_layers} layers)"
    reqs, stats = serve_run(torch, model, prompts, on_token=gather)
    check_serve_run(reqs, stats, cfg32.n_layers, label, per_prefill,
                    per_decode)
    worst, worst_prefill, diverged = 0.0, 0.0, []
    for r, g in zip(reqs, golden["requests"]):
        for t, gtok in enumerate(g["tokens"]):
            require(t < len(r.out), f"{label}: request {r.rid} ended at "
                    f"{len(r.out)} tokens, the reference at "
                    f"{len(g['tokens'])}")
            rel, parted = top5_check(torch, label, r, g, t, seen)
            worst = max(worst, rel)
            worst_prefill = max(worst_prefill, rel if t == 0 else 0.0)
            if parted is not None:
                diverged.append(parted)
                break
        else:
            require(len(r.out) == len(g["tokens"]), f"{label}: request "
                    f"{r.rid} has {len(r.out)} tokens, the reference "
                    f"{len(g['tokens'])}")
    emit({"phase": "serve", "arch": arch, "dtype": "float32",
          "n_layers": cfg32.n_layers, "vs": golden_name,
          "max_rel_err_top5": worst,
          "max_rel_err_top5_prefill": worst_prefill,
          "diverged_at_near_ties": diverged,
          "one_ulp_embed_shift_top5": one_ulp_shift(torch, model, golden),
          **serve_summary(stats)})
    if on_f32 is not None:
        on_f32(model, golden)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # bfloat16, the production dtypes
    t0 = time.perf_counter()
    if draw == "numpy":
        model = build_model(cfg)
        model.load_state_dict(lm_params_from_numpy(cfg, tree,
                                                   model.device))
        del tree
    else:
        model = load_model(cfg, SERVE_SEED, draw="torch")
        torch.cuda.synchronize()
        emit({"phase": "serve_weights", "arch": arch, "dtype": "bfloat16",
              "n_layers": cfg.n_layers,
              "params": module.param_count(model.param_specs()),
              "draw": "torch.Generator on the card",
              "seconds": time.perf_counter() - t0,
              "allocated_gb": torch.cuda.memory_allocated() / 1e9})
    # (a float32 run cut in depth gives no prefill to compare with)
    counts = bf16_serve_checks(torch, model, prompts, witness, per_prefill,
                               per_decode,
                               f32_first if f32_layers is None else {})
    if on_bf16 is not None:
        on_bf16(model)
    return counts, (model, prompts)


def load_golden(src, golden_name, arch, n_requests) -> dict:
    with open(os.path.join(src, "repro_torch", "data", golden_name)) as f:
        golden = json.load(f)
    require(golden["arch"] == arch and golden["seed"] == SERVE_SEED
            and golden["serve"] == SERVE_CONFIG
            and len(golden["requests"]) == n_requests,
            f"{golden_name} names another configuration")
    return golden


def float32_config(torch, cfg):
    """cfg in float32 throughout, with TF32 off for every product."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return cfg.replace(compute_dtype=torch.float32,
                       cache_dtype=torch.float32)


def top5_check(torch, label, r, g, t, seen, tol=1e-3):
    """Step t of request r against its golden g: the logits at the
    golden's top-5 indices to rtol `tol` (of max(1, |logit|)), and the
    token equal unless the golden's top-2 margin is under that
    tolerance.  Returns (the relative error, a record of the parting or
    None)."""
    want = torch.tensor(g["top5_values"][t])
    got = seen[(r.rid, t)].cpu()
    rel = float(((got - want).abs() / want.abs().clamp_min(1.0)).max())
    require(rel <= tol, f"{label}: request {r.rid} step {t}: top-5 logits "
            f"off by rtol {rel}")
    if r.out[t] == g["tokens"][t]:
        return rel, None
    margin = g["top2_margin"][t]
    require(margin < tol * max(1.0, abs(want[0].item())),
            f"{label}: request {r.rid} step {t}: token {r.out[t]} != "
            f"{g['tokens'][t]} at top-2 margin {margin}")
    return rel, {"rid": r.rid, "step": t, "margin": margin}


def bf16_serve_checks(torch, model, prompts, witness, per_prefill,
                      per_decode, f32_first, forced=False) -> dict:
    """The bfloat16 serve: through the kernels, timed and counted; then,
    each logits row kept, through the kernels again, through the plain
    versions and through the witness, the kernels held to 1.5x the
    witness's distance from the plain run (`logit_gap`).  With `forced`
    (a model whose state is engine-global, as the MoE load EMAs) the
    three take the same inputs at every call instead (`forced_gaps`).
    Returns the launch counts of the timed run."""
    arch = model.cfg.name
    n_layers = model.cfg.n_layers
    label = f"{arch} bfloat16 serve"
    reqs, stats = serve_run(torch, model, prompts)
    check_serve_run(reqs, stats, n_layers, label, per_prefill, per_decode)
    emit({"phase": "serve", "arch": arch, "dtype": "bfloat16",
          "n_layers": n_layers, "kernels": "hopper", **serve_summary(stats)})
    runs = {}
    for name, impl, order in (
            ("kernels", None, contextlib.nullcontext()),
            ("plain", "ref", contextlib.nullcontext()),
            ("witness", "ref", witness(torch))):
        if forced and name != "kernels":
            continue
        rows = {}

        def keep(req, row, rows=rows):
            rows[(req.rid, len(req.out) - 1)] = row.float().cpu()

        model.impl = impl
        with order:
            r_reqs, r_stats = serve_run(torch, model, prompts, on_token=keep)
        require(all(r.done for r in r_reqs), f"{label}, {name} run: a "
                "request is not done")
        require(impl is None or not any(r_stats["launches"].values()),
                f"{label}: the {name} run launched a kernel")
        runs[name] = (r_reqs, rows)
    model.impl = None
    require([r.out for r in runs["kernels"][0]] == [r.out for r in reqs],
            f"{label}: two runs through the kernels differ")
    # bfloat16 rounds at every layer, and the layers carry any change of
    # float32 rounding into the logits: the kernels are held to what one
    # such change does to the plain versions, the witness's gap
    if forced:
        gaps = forced_gaps(torch, model, prompts, witness)
        record = {}
    else:
        gaps = {name: logit_gap(runs[name], runs["plain"])
                for name in ("kernels", "witness")}
        record = {"same_tokens_as_plain": {
            name: [a.out == b.out for a, b in zip(runs[name][0],
                                                  runs["plain"][0])]
            for name in gaps}}
        if f32_first:
            record["prefill_max_abs_vs_float32"] = {
                name: max(float((rows[(rid, 0)] - row).abs().max())
                          for rid, row in f32_first.items())
                for name, (_, rows) in runs.items()}
    emit({"phase": "serve", "arch": arch, "dtype": "bfloat16",
          "n_layers": n_layers, "vs_plain": gaps, "forced": forced,
          "kernels_within_2e-2": gaps["kernels"]["max_abs"] <= 2e-2,
          **record})
    for key in ("max_abs", "rel_l2"):
        require(gaps["kernels"][key] <= 1.5 * gaps["witness"][key],
                f"{label}: the kernels' logits are {key} "
                f"{gaps['kernels'][key]} from the plain versions', more "
                f"than 1.5x the witness's {gaps['witness'][key]}")
    return {k: stats["launches"][k] for k in {**per_prefill, **per_decode}}


def forced_gaps(torch, model, prompts, witness) -> dict:
    """The serving requests through the plain versions, which choose the
    tokens; at every call (a prefill or a decode step) the kernels and
    the witness take copies of the same model state, cache lanes,
    tokens and positions.  Returns `logit_gap`'s record of each against
    the plain logits over the rows of active requests at every call:
    with the state engine-global, a run of its own would carry every
    earlier call's routing into the later ones."""
    import numpy as np
    from repro_torch.models import module
    from repro_torch.serving import Request, ServeConfig, ServingEngine
    eng = ServingEngine(model, ServeConfig(**SERVE_CONFIG))
    acc = {name: {"max_abs": 0.0, "num": 0.0, "den": 0.0, "rows": 0}
           for name in ("kernels", "witness")}

    def call(fn, state, cache, tokens, *rest):
        rows = ([0] if tokens.shape[0] == 1 else
                [i for i, r in enumerate(eng.active) if r is not None])
        outs = {}
        for name, impl, order in (
                ("kernels", None, contextlib.nullcontext()),
                ("witness", "ref", witness(torch))):
            model.impl = impl
            with order:
                outs[name] = getattr(model, fn)(
                    module.tree_map(torch.clone, state),
                    module.tree_map(torch.clone, cache), tokens,
                    *rest)[0][rows].float()
        model.impl = "ref"
        out = getattr(model, fn)(state, cache, tokens, *rest)
        base = out[0][rows].float()
        for name, got in outs.items():
            a = acc[name]
            a["max_abs"] = max(a["max_abs"], float((got - base).abs().max()))
            a["num"] += float(((got - base) ** 2).sum())
            a["den"] += float((base ** 2).sum())
            a["rows"] += len(rows)
        return out

    class Forced:
        def __getattr__(self, name):
            return getattr(model, name)

        def prefill(self, *args):
            return call("prefill", *args)

        def decode_step(self, *args):
            return call("decode_step", *args)

    eng.model = Forced()
    reqs = [Request(i, np.asarray(p, np.int32))
            for i, p in enumerate(prompts)]
    try:
        eng.run(reqs)
    finally:
        model.impl = None
    require(all(r.done for r in reqs), "the forced run: a request is not "
            "done")
    return {name: {"max_abs": a["max_abs"],
                   "rel_l2": math.sqrt(a["num"] / a["den"]),
                   "rows": a["rows"]} for name, a in acc.items()}


def olmoe_serve_checks(torch, src):
    """The OLMoE serving phases.  Float32 at full width and
    OLMOE_F32_LAYERS layers against the JAX golden, call by call in the
    engine's order, each call's logits at the golden's top-5 to rtol 1e-3
    and its tokens equal; the load EMAs are engine-global, so the first
    call that fails ends the comparison, and passes only at a routing
    near-tie (the call's smallest gap between a token's K-th and
    (K+1)-th selection logits under 1e-4 of max(1, |K-th|)) or at a
    top-2 near-tie of the golden's logits.  With no such call the final
    load EMAs hold to rtol 1e-5.  Then bfloat16 at full width and all 16
    layers, weights drawn on the card from SERVE_SEED (`module.draw`):
    per layer one K4 and three K7 per prefill, one K5 and three K7 per
    decode step, held to the witness (keys and D reversed)."""
    from repro_torch import configs
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.launch.serve import load_model
    from repro_torch.models import build_model, module
    from repro_torch.models.lm import LM
    golden_name = "reference_serve_olmoe.json"
    golden = load_golden(src, golden_name, OLMOE_ARCH, OLMOE_REQUESTS)
    cfg = configs.get_config(OLMOE_ARCH)
    cfg4 = cfg.replace(n_layers=OLMOE_F32_LAYERS)
    require(golden["config"] == {k: getattr(cfg4, k)
                                 for k in golden["config"]},
            f"{golden_name} names another configuration")
    per_prefill = {"flash_attention": 1, "moe_gmm": 3}
    per_decode = {"decode_attention": 1, "moe_gmm": 3}
    prompts = [r["prompt"] for r in golden["requests"]]

    t0 = time.perf_counter()
    specs = LM(cfg4, device="meta").param_specs()
    tree = module.init(specs, SERVE_SEED)
    model = build_model(float32_config(torch, cfg4))
    model.load_state_dict(lm_params_from_numpy(model.cfg, tree,
                                               model.device))
    del tree
    emit({"phase": "serve_weights", "arch": OLMOE_ARCH, "dtype": "float32",
          "n_layers": cfg4.n_layers, "params": module.param_count(specs),
          "seconds": time.perf_counter() - t0})
    gidx = {r["rid"]: r["top5_indices"] for r in golden["requests"]}
    seen, at_call, gaps = {}, {}, []

    def gather(req, row):
        t = len(req.out) - 1
        at_call[(req.rid, t)] = len(gaps) - 1
        if t < len(gidx[req.rid]):
            idx = torch.as_tensor(gidx[req.rid][t], device=row.device)
            seen[(req.rid, t)] = row.float()[idx]

    def router_gap():
        gaps.append(model.metrics["router_gap"])

    label = f"{OLMOE_ARCH} float32 serve ({cfg4.n_layers} layers)"
    reqs, stats = serve_run(torch, model, prompts, on_token=gather,
                            on_call=router_gap)
    check_serve_run(reqs, stats, cfg4.n_layers, label, per_prefill,
                    per_decode)
    gaps = [float(x) for x in gaps]
    by_call = {}
    for r, g in zip(reqs, golden["requests"]):
        for t, c in enumerate(g["calls"]):
            by_call.setdefault(c, []).append((r, g, t))
    worst, diverged = 0.0, []
    for c in range(golden["n_calls"]):
        try:
            parted = []
            for r, g, t in by_call[c]:
                require(at_call.get((r.rid, t)) == c, f"{label}: request "
                        f"{r.rid} step {t} is not in call {c}")
                rel, p = top5_check(torch, label, r, g, t, seen)
                worst = max(worst, rel)
                if p is not None:
                    parted.append(p)
            if parted:
                diverged.append({"call": c, "kind": "top-2 margin",
                                 "parted": parted})
                break
        except RuntimeError as err:
            require(gaps[c] < 1e-4, f"{err} (router gap {gaps[c]} at "
                    f"call {c})")
            diverged.append({"call": c, "kind": "routing",
                             "router_gap": gaps[c], "failure": str(err)})
            break
    ema_err = None
    if not diverged:
        require(len(gaps) == golden["n_calls"], f"{label}: {len(gaps)} "
                f"calls, the reference {golden['n_calls']}")
        want = torch.tensor(golden["final_load_ema"])
        got = stats["mstate"]["slot_00"]["load_ema"].float().cpu()
        ema_err = float(((got - want).abs()
                         / want.abs().clamp_min(1e-30)).max())
        require(ema_err <= 1e-5, f"{label}: final load EMAs off by rtol "
                f"{ema_err}")
    emit({"phase": "serve", "arch": OLMOE_ARCH, "dtype": "float32",
          "n_layers": cfg4.n_layers, "vs": golden_name,
          "max_rel_err_top5": worst, "calls": len(gaps),
          "diverged_at_near_ties": diverged,
          "final_load_ema_max_rel_err": ema_err,
          "min_router_gap": min(gaps),
          "one_ulp_embed_shift_top5": one_ulp_shift(torch, model, golden),
          **serve_summary(stats)})
    del model
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    model = load_model(cfg, SERVE_SEED, draw="torch")
    torch.cuda.synchronize()
    emit({"phase": "serve_weights", "arch": OLMOE_ARCH, "dtype": "bfloat16",
          "n_layers": cfg.n_layers,
          "params": module.param_count(model.param_specs()),
          "draw": "torch.Generator on the card",
          "seconds": time.perf_counter() - t0,
          "allocated_gb": torch.cuda.memory_allocated() / 1e9})
    # (the float32 run has 4 layers: no prefill comparison with it)
    counts = bf16_serve_checks(torch, model, prompts, reversed_sums,
                               per_prefill, per_decode, {}, forced=True)
    return counts, (model, prompts)


def feature_run(torch, model, prompts, feats, steps):
    """The encoder-decoder on real frame features: prompt b prefilled
    into lane b of a fresh cache on feats[b], then `steps` greedy decode
    steps of all lanes.  Returns ((lanes with .rid and .out, {(lane,
    step): logits row, float32 on the host}), the launch counts)."""
    import types
    from repro_torch.kernels import ops
    from repro_torch.models import module
    dev = model.device
    cache = module.zeros(model.init_cache_specs(len(prompts),
                                                SERVE_CONFIG["max_len"]), dev)
    lanes = [types.SimpleNamespace(rid=b, out=[]) for b in
             range(len(prompts))]
    rows = {}

    def take(b, row):
        rows[(b, len(lanes[b].out))] = row.float().cpu()
        lanes[b].out.append(int(torch.argmax(row)))

    ops.reset_launches()
    for b, p in enumerate(prompts):
        lane = module.tree_map(lambda c: c[:, b:b + 1], cache)
        logits = model.prefill({}, lane, torch.as_tensor([p], device=dev),
                               feats[b:b + 1])[0]
        take(b, logits[0])
    pos = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                       device=dev)
    for _ in range(steps):
        toks = torch.tensor([[r.out[-1]] for r in lanes], device=dev)
        logits = model.decode_step({}, cache, toks, pos)[0]
        for b in range(len(lanes)):
            take(b, logits[b])
        pos += 1
    torch.cuda.synchronize()
    return (lanes, rows), ops.launches()


def golden_feats(torch, golden, dev):
    """The random-feature record's frame features:
    RandomState(seed).standard_normal(shape) float32."""
    import numpy as np
    rec = golden["random_features"]
    require(rec["seed"] == SERVE_SEED and rec["decode_steps"]
            == WHISPER_FEAT_STEPS, "the random-feature record names "
            "another recipe")
    x = np.random.RandomState(rec["seed"]).standard_normal(rec["shape"])
    return torch.from_numpy(x.astype(np.float32)).to(dev)


def feature_launches(model, n_prefills, n_steps) -> dict:
    """K4 once an encoder layer and twice a decoder layer a prefill, K5
    twice a decoder layer a decode step, nothing else."""
    from repro_torch.kernels import ops
    want = {k: 0 for k in ops.launches()}
    want["flash_attention"] = n_prefills * (model.n_enc + 2 * model.n_dec)
    want["decode_attention"] = n_steps * 2 * model.n_dec
    return want


def whisper_feature_f32(torch, model, golden) -> None:
    """The float32 whisper-base on the golden's random-feature record:
    two prompts on real frame features, prefill and WHISPER_FEAT_STEPS
    greedy steps, and the per-layer launches.  Each step's logits at
    the golden's top-5 within rtol WHISPER_FEAT_RTOL (of max(1,
    |logit|)) or, where more, three times the witness's largest move,
    its token equal but at a stored top-2 near-tie under that tolerance
    (the lane's comparison stops there).  The witness is the same run on
    the features one ulp up (times 1 + 2^-23), printed: on
    standard-normal features this random model's attention is nearly
    one-hot on scores of hundreds, and float32 rounding moves its logits
    by up to ~3e-3, the port's on the CPU as on the card up to 5.4e-3
    from the golden at the same step (ROADMAP §3)."""
    rec = golden["random_features"]
    feats = golden_feats(torch, golden, model.device)
    prompts = [r["prompt"] for r in rec["requests"]]
    (lanes, rows), counts = feature_run(torch, model, prompts, feats,
                                        WHISPER_FEAT_STEPS)
    require(counts == feature_launches(model, len(prompts),
                                       WHISPER_FEAT_STEPS),
            f"whisper random features: launches {counts}")
    (w_lanes, w_rows), _ = feature_run(torch, model, prompts,
                                       feats * (1.0 + 2.0 ** -23),
                                       WHISPER_FEAT_STEPS)
    label = "whisper-base float32, random features"
    seen, witness = {}, 0.0
    for r, g in zip(lanes, rec["requests"]):
        for t, idx in enumerate(g["top5_indices"]):
            idx = torch.as_tensor(idx)
            seen[(r.rid, t)] = got = rows[(r.rid, t)][idx]
            moved = (w_rows[(r.rid, t)][idx] - got).abs()
            witness = max(witness, float(
                (moved / got.abs().clamp_min(1.0)).max()))
    tol = max(WHISPER_FEAT_RTOL, 3 * witness)
    worst, diverged = 0.0, []
    for r, g in zip(lanes, rec["requests"]):
        for t in range(len(g["tokens"])):
            rel, parted = top5_check(torch, label, r, g, t, seen, tol)
            worst = max(worst, rel)
            if parted is not None:
                diverged.append(parted)
                break
    emit({"phase": "serve", "arch": WHISPER_ARCH, "dtype": "float32",
          "case": "random features", "vs": "reference_serve_whisper.json "
          "random_features", "prompts": [len(p) for p in prompts],
          "decode_steps": WHISPER_FEAT_STEPS, "max_rel_err_top5": worst,
          "one_ulp_feature_shift_top5": witness, "rtol": tol,
          "witness_same_tokens": [a.out == b.out for a, b in
                                  zip(w_lanes, lanes)],
          "diverged_at_near_ties": diverged, "launches": counts})


def whisper_feature_bf16(torch, model, golden) -> None:
    """The bfloat16 whisper-base on the random-feature record's inputs
    through the kernels, the plain versions and the witness (keys and
    head dims reversed): the kernels' logits no further from the plain run's than
    1.5 times the witness's, in max abs and relative L2, at the prefill
    and each step until the tokens part (`logit_gap`)."""
    rec = golden["random_features"]
    feats = golden_feats(torch, golden, model.device)
    prompts = [r["prompt"] for r in rec["requests"]]
    runs = {}
    for name, impl, order in (
            ("kernels", None, contextlib.nullcontext()),
            ("plain", "ref", contextlib.nullcontext()),
            ("witness", "ref", reversed_orders(torch))):
        model.impl = impl
        with order:
            runs[name], counts = feature_run(torch, model, prompts, feats,
                                             WHISPER_FEAT_STEPS)
        want = (feature_launches(model, len(prompts), WHISPER_FEAT_STEPS)
                if impl is None else {k: 0 for k in counts})
        require(counts == want, f"whisper random features bf16, {name}: "
                f"launches {counts}")
    model.impl = None
    gaps = {name: logit_gap(runs[name], runs["plain"])
            for name in ("kernels", "witness")}
    emit({"phase": "serve", "arch": WHISPER_ARCH, "dtype": "bfloat16",
          "case": "random features", "vs_plain": gaps,
          "same_tokens_as_plain": {
              name: [a.out == b.out for a, b in zip(runs[name][0],
                                                    runs["plain"][0])]
              for name in gaps}})
    for key in ("max_abs", "rel_l2"):
        require(gaps["kernels"][key] <= 1.5 * gaps["witness"][key],
                f"whisper random features bf16: the kernels' logits are "
                f"{key} {gaps['kernels'][key]} from the plain versions', "
                f"more than 1.5x the witness's {gaps['witness'][key]}")


def whisper_serve_checks(torch, src):
    """The whisper-base serving phases at full width: float32 against
    `reference_serve_whisper.json` on the engine's zero frame features,
    then on the golden's random-feature record; bfloat16 through the
    kernels against the plain versions and the witness (keys and head
    dims reversed), in the engine and on the random features.  Per decoder layer a
    prefill launches K4 three times (its self and cross attention and
    its encoder layer's: the two stacks are equally deep) and a decode
    step K5 twice."""
    from repro_torch import configs
    cfg = configs.get_config(WHISPER_ARCH)
    require(cfg.n_enc_layers == cfg.n_layers, "whisper's per-layer launch "
            "counts need stacks of one depth")
    golden = load_golden(src, "reference_serve_whisper.json", WHISPER_ARCH,
                         WHISPER_REQUESTS)
    return serve_checks(
        torch, src, WHISPER_ARCH, "reference_serve_whisper.json",
        WHISPER_REQUESTS, witness=reversed_orders,
        per_prefill={"flash_attention": 3},
        per_decode={"decode_attention": 2},
        on_f32=lambda model, g: whisper_feature_f32(torch, model, g),
        on_bf16=lambda model: whisper_feature_bf16(torch, model, golden))


def profile_decode(torch, model, prompts, label, top=12):
    """Device time by kernel over one traced bfloat16 serving run."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, stats = serve_run(torch, model, prompts)
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0
            and e.key != "Activity Buffer Request"]
    device_ms = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    wall_ms = stats["seconds"] * 1e3
    emit({"phase": "profile", "scenario": label,
          "wall_ms": wall_ms, "device_ms": device_ms,
          "busy_share": device_ms / wall_ms,
          "prefills": len(stats["prefill_ms"]),
          "decode_steps": len(stats["decode_ms"]),
          "launches": stats["launches"],
          "top": [{"kernel": k[:80], "ms": ms, "calls": n}
                  for k, ms, n in rows[:top]],
          # the port's own kernels (csrc/), wherever they rank
          "port_kernels": [{"kernel": k[:80], "ms": ms, "calls": n}
                           for k, ms, n in rows if port_prefix(k)]})


# ------------------------------------------------------------ train phase
def grads_of(torch, fn, ins, cot):
    """(fn(*ins), the gradients of Σ fn(*ins)·cot with respect to `ins`),
    each input a fresh leaf."""
    leaves = [t.detach().requires_grad_() for t in ins]
    out = fn(*leaves)
    grads = torch.autograd.grad(out, leaves, cot)
    return out.detach(), grads


def bf16_ulps(torch, got, plain, floor=2.0 ** -6):
    """The largest distance of `got` from `plain` (both bfloat16) in units
    of the bfloat16 ulp at |plain|, the ulp floored at that of floor ·
    max|plain| (near zero, float32 cancellation rather than the final
    rounding sets the distance)."""
    p = plain.float().abs()
    mag = torch.clamp_min(p, floor * float(p.max()))
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((got.float() - plain.float()).abs() / ulp).max())


def witness_check(torch, label, got, plain, wit, factor=1.5):
    """bfloat16: `got` no further from `plain` than `factor` times the
    witness `wit` (the plain version with its float32 sums in another
    order), in bfloat16 ulps (`bf16_ulps`): two float32-accurate results
    round to at most one ulp apart, so max-abs distances, which an ulp's
    binade scales, would compare a witness's flip in one binade with the
    kernel's in the next.  Returns (ulps, witness ulps, max abs)."""
    d, w = bf16_ulps(torch, got, plain), bf16_ulps(torch, wit, plain)
    require(d <= factor * max(w, 1.0), f"{label}: {d} ulps from plain, "
            f"beyond {factor} x the witness's {w}")
    return d, w, float((got.float() - plain.float()).abs().max())


def k4_forward_check(torch, label, q, k, v, causal, seg, out, lse, o32):
    """K4's training forward (`return_lse=True`) against its plain
    version: `out` against `flash_attention_ref` (allclose at K4_FWD_TOL
    of its dtype), the float32 output `o32` and the rows' log-sum-exp
    `lse` against the plain version in float32 on the same (exactly
    widened) inputs at K4_STATS_TOL.  Returns the three max abs errors."""
    from repro_torch.kernels import ref
    errs = {}
    tol = K4_FWD_TOL[str(q.dtype).removeprefix("torch.")]
    err, ok = allclose(torch, out, ref.flash_attention_ref(
        q, k, v, causal, seg), tol)
    require(ok, f"{label} out: max abs err {err} beyond {tol}")
    errs["out"] = err
    qf, kf, vf = (t.float() for t in (q, k, v))
    g = q.shape[1] // k.shape[1]
    s = (qf @ kf.repeat_interleave(g, dim=1).transpose(-1, -2)) \
        * q.shape[-1] ** -0.5
    keep = ref.attention_mask(q.shape[2], causal, seg, q.device)
    if keep is not None:
        s = torch.where(keep, s, ref.NEG_INF)
    for name, got, want in (
            ("o32", o32, ref.flash_attention_ref(qf, kf, vf, causal, seg)),
            ("lse", lse, torch.logsumexp(s, dim=-1))):
        err, ok = allclose(torch, got, want, K4_STATS_TOL)
        require(ok, f"{label} {name}: max abs err {err} beyond "
                f"{K4_STATS_TOL}")
        errs[name] = err
    return errs


def k4_bwd_segments(torch, B, S):
    """The packed batch's segment ids [B, S] on the card (documents of
    mean 512 tokens, TRAIN_SEED): K4_BWD_SHAPES' packed cases."""
    from repro_torch.data import DataConfig, packed_batches
    b = next(packed_batches(DataConfig(vocab=1000, seq_len=S,
                                       global_batch=B, seed=TRAIN_SEED)))
    return torch.as_tensor(b["segment_ids"], device="cuda")


def k4_bwd_checks(torch, emit_kernel):
    """K4's backward (`flash_attention_bwd_cuda`, three launches a call)
    against the gradient of its plain version under autograd, at the
    training path's shapes: Qwen3-0.6B's q [8, 16, 512, 128] against
    k, v [8, 8, 512, 128] causal on packed segments (`packed_batches`,
    documents of mean 512 tokens), Qwen2-VL-7B's q [2, 28, 512, 128]
    against [2, 4, 512, 128] (G = 7) causal on packed segments, and
    whisper-base's (hd 64): the encoder [8, 8, 1500, 64] non-causal, the
    decoder's self attention [8, 8, 128, 64] causal on packed segments
    (the train phase's whisper batch) and the cross attention, q [8, 8,
    L, 64] against [8, 8, 1500, 64], L in {17, 333, 512}.  Float32 to
    K4_BWD_RTOL of each gradient's largest magnitude; bfloat16 no
    further from plain than 1.5x the witness (the plain version with its
    keys and head dims reversed), in bfloat16 ulps (`witness_check`).
    The forward that the backward takes is held too: its output against
    `flash_attention_ref` (the serving checks' K4_FWD_TOL), its float32
    output and its log-sum-exp against the plain version's in float32
    (K4_STATS_TOL).  Timed: the
    backward (ms), K4's forward with its log-sum-exp plus the backward
    (fwd_bwd_ms), SDPA's backward alone on a retained graph (sdpa_bwd_ms,
    the row's library time: a yardstick the port never calls) and its
    forward + backward (sdpa_fwd_bwd_ms; with the segments as a boolean
    mask), each by CUDA events around replays of a CUDA graph of 10
    calls (`graph_ms`, `graph_grad_ms`: device time without the host's
    launch time, which the tensor-core backward undercuts at the small
    shapes; the profiler, which keeps only part of its windows late in
    a full run, would retake each window five times); the backward also
    by CUDA events around back-to-back eager calls (eager_ms, host time
    included where it is longer), and the plain version's forward +
    backward under autograd (plain_ms, and its backward alone) by CUDA
    events; launch_ms splits the backward by launch (D, dK/dV, dQ), each
    launch's mean over the events one profiler window kept."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_cuda)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(7)
    peak = {torch.float32: PEAK_F32_FLOPS, torch.bfloat16: PEAK_BF16_FLOPS}

    shapes = K4_BWD_SHAPES
    witness_fn = {}
    with reversed_orders(torch):
        witness_fn["flash"] = ref.flash_attention_ref
    for dt in (torch.float32, torch.bfloat16):
        for B, H, KV, Lq, Lk, hd, causal, packed, case in shapes:
            q = torch.randn((B, Lq, H, hd), generator=gen,
                            device="cuda").to(dt).transpose(1, 2)
            k, v = (torch.randn((B, Lk, KV, hd), generator=gen,
                                device="cuda").to(dt).transpose(1, 2)
                    for _ in range(2))
            do = torch.randn((B, Lq, H, hd), generator=gen,
                             device="cuda").to(dt).transpose(1, 2)
            seg = k4_bwd_segments(torch, B, Lq) if packed else None
            out, lse, o32 = flash_attention_cuda(q, k, v, causal, seg,
                                                 return_lse=True)
            fwd_errs = k4_forward_check(torch, f"K4 forward {case} {dt}",
                                        q, k, v, causal, seg, out, lse, o32)
            got = flash_attention_bwd_cuda(do, q, k, v, o32, lse, causal, seg)
            again = flash_attention_bwd_cuda(do, q, k, v, o32, lse, causal,
                                             seg)
            torch.cuda.synchronize()
            require(all(torch.equal(a, b) for a, b in zip(got, again)),
                    f"K4 backward {case} {dt}: a second call differs")

            def plain(q_, k_, v_):
                return ref.flash_attention_ref(q_, k_, v_, causal, seg)
            _, want = grads_of(torch, plain, (q, k, v), do)
            errs = {}
            if dt == torch.float32:
                for name, g, w in zip(("dq", "dk", "dv"), got, want):
                    err = float((g - w).abs().max())
                    tol = K4_BWD_RTOL * float(w.abs().max())
                    require(err <= tol, f"K4 backward {case} {name}: max abs "
                            f"err {err} beyond {tol}")
                    errs[name] = err
                wit = None
            else:
                _, wgrads = grads_of(torch, lambda a, b_, c: witness_fn[
                    "flash"](a, b_, c, causal, seg), (q, k, v), do)
                wit, ulps = {}, {}
                for name, g, w, x in zip(("dq", "dk", "dv"), got, want,
                                         wgrads):
                    ulps[name], wit[name], errs[name] = witness_check(
                        torch, f"K4 backward {case} {dt} {name}", g, w, x)
            mask = (None if seg is None else
                    ref.attention_mask(Lq, causal, seg, q.device))
            qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))

            def lib_fwd():
                return (sdpa(qs, ks, vs, attn_mask=mask, enable_gqa=True)
                        if mask is not None else
                        sdpa(qs, ks, vs, is_causal=causal, enable_gqa=True))

            def lib():
                torch.autograd.grad(lib_fwd(), (qs, ks, vs), do)

            def fwd_bwd():
                _, l_, o_ = flash_attention_cuda(q, k, v, causal, seg,
                                                 return_lse=True)
                flash_attention_bwd_cuda(do, q, k, v, o_, l_, causal, seg)

            def plain_fb():
                grads_of(torch, plain, (q, k, v), do)
            pq, pk, pv = (t.detach().requires_grad_() for t in (q, k, v))
            po = plain(pq, pk, pv)

            def plain_bwd():
                torch.autograd.grad(po, (pq, pk, pv), do, retain_graph=True)
            def bwd():
                flash_attention_bwd_cuda(do, q, k, v, o32, lse, causal, seg)
            ms = graph_ms(torch, bwd, 10)
            # each launch's mean device time (D, dK/dV, dQ)
            split = {k.split("::", 1)[-1].split("(")[0]: t / max(n, 1) / 1e3
                     for k, (n, t) in device_events(torch, bwd, 10).items()}
            eager_ms = time_ms(torch, bwd, 10)
            fb_ms = graph_ms(torch, fwd_bwd, 10)
            plain_ms = time_ms(torch, plain_fb, 3)
            plain_b = time_ms(torch, plain_bwd, 3)
            lib_ms = graph_ms(torch, lib, 10)
            lib_b = graph_grad_ms(torch, lib_fwd, (qs, ks, vs), do, 10)
            del po
            elt = q.element_size()
            qo = B * H * Lq * hd
            kvn = B * KV * Lk * hd
            n_bytes = (3 * qo + 2 * kvn) * elt + (qo + 2 * kvn) * elt \
                + 4 * B * H * Lq + (4 * B * Lq if seg is not None else 0)
            if seg is None:
                pairs = B * (Lq * (Lq + 1) / 2 if causal else Lq * Lk)
            else:           # the pairs this batch's segments keep
                pairs = float(mask.expand(B, 1, Lq, Lk).sum())
            n_ops = 10.0 * H * hd * pairs
            bms, by = bound_ms(n_bytes, n_ops, peak[dt])
            rec = {"phase": "train", "kernel": "flash_attention_bwd",
                   "case": case, "dtype": str(dt),
                   "q": [B, H, Lq, hd], "kv": [B, KV, Lk, hd],
                   "segments": (int(seg.max()) if seg is not None else None),
                   "max_abs_err": errs, "forward_max_abs_err": fwd_errs,
                   "ms": ms, "launch_ms": split, "eager_ms": eager_ms,
                   "fwd_bwd_ms": fb_ms,
                   "plain_ms": plain_ms, "plain_bwd_ms": plain_b,
                   "sdpa_bwd_ms": lib_b, "sdpa_fwd_bwd_ms": lib_ms,
                   "bound_ms": bms,
                   "bound_by": by, "bitwise_repeat": True}
            if wit is not None:
                rec.update(ulps=ulps, witness_ulps=wit)
            else:
                rec["rtol"] = K4_BWD_RTOL
            emit(rec)
            emit_kernel("flash_attention_bwd", max_abs_err=max(errs.values()),
                        main=(dt == torch.bfloat16 and case == shapes[0][-1]),
                        ms=ms, plain_ms=plain_b, bound_ms=bms, bound_by=by,
                        library_ms=lib_b)
            del q, k, v, do, out, lse, o32, got, again, want, qs, ks, vs
    torch.cuda.empty_cache()


# K7's backward at OLMoE's expert products: (C, D, F, active experts of
# 64).  D 2048 / F 1024 are the wg and wu products, D 1024 / F 2048 the
# wd product; C = 80 is a 512-token row's capacity, C = 640 the train
# step's 8 rows of 512 tokens
K7_BWD_SHAPES = ((80, 2048, 1024, 40), (640, 2048, 1024, 64),
                 (80, 1024, 2048, 40), (640, 1024, 2048, 64))


def k7_bwd_checks(torch, emit_kernel):
    """K7's backward (`moe_gmm_bwd_cuda`) at `K7_BWD_SHAPES`, x [64, C, D]
    @ w [64, D, F], against the gradient of the plain version: float32
    (two launches of the forward kernel on transposed copies) to 1e-5 of
    Σ|·| per output (the sums of two products over C or F), bfloat16
    (one launch of the backward kernel, `csrc/moe_gmm_bwd.cu`) no further
    than 1.5x the witness (D reversed in the plain forward), the inactive
    experts' dx and dw zero, one launch a call.  In bfloat16 also: two
    calls equal bit for bit, and a dx-only and a dw-only call equal to
    the full call's dx and dw, at both C of the wg shape.  Timed beside
    two torch.bmm calls (dy @ wᵀ, xᵀ @ dy: a yardstick, not one call;
    `bmm_ratio`); the bound counts the function's bytes (dy, x, w read,
    dx, dw written, for the active experts) and operations, the
    inactive experts' zeros (`zero_bytes`) beside it, and
    `transpose_bytes` the copies the float32 route makes (none in
    bfloat16).  Timed by CUDA events, as `k4_bwd_checks`."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.moe_gmm import moe_gmm_bwd_cuda
    gen = torch.Generator(device="cuda").manual_seed(8)
    peak = {torch.float32: PEAK_F32_FLOPS, torch.bfloat16: PEAK_BF16_FLOPS}
    E = 64

    def rev(x, w, active):
        out = torch.bmm(x.float().flip(-1), w.float().flip(1))
        return torch.where(active.bool()[:, None, None], out, 0.0).to(x.dtype)
    for dt in (torch.float32, torch.bfloat16):
        for C, D, F, n_active in K7_BWD_SHAPES:
            x = torch.randn((E, C, D), generator=gen, device="cuda").to(dt)
            w = (torch.randn((E, D, F), generator=gen, device="cuda")
                 * D ** -0.5).to(dt)
            dy = torch.randn((E, C, F), generator=gen, device="cuda").to(dt)
            active = torch.zeros(E, dtype=torch.bool, device="cuda")
            active[torch.randperm(E, generator=gen, device="cuda")[
                :n_active]] = True
            x = torch.where(active[:, None, None], x, 0).to(dt)
            n0 = moe_gmm_bwd_cuda.launches
            dx, dw = moe_gmm_bwd_cuda(dy, x, w, active)
            torch.cuda.synchronize()
            n_launch = moe_gmm_bwd_cuda.launches - n0
            _, (px, pw) = grads_of(torch, lambda a, b: ref.moe_gmm_ref(
                a, b, active), (x, w), dy)
            label = f"K7 backward [{E},{C},{D}]@[{E},{D},{F}] " \
                    f"{n_active} active {dt}"
            extra = {}
            if dt == torch.float32:
                _, (ax, aw) = grads_of(torch, lambda a, b: ref.moe_gmm_ref(
                    a, b, active), (x.abs(), w.abs()), dy.abs())
                errs = {}
                for name, g, want, mag in (("dx", dx, px, ax),
                                           ("dw", dw, pw, aw)):
                    d = (g - want).abs()
                    errs[name] = float(d.max())
                    require(bool((d <= 1e-5 * mag).all()),
                            f"{label} {name}: max abs err {errs[name]} "
                            "beyond 1e-5 of Σ|·|")
                require(n_launch == 2, f"{label}: {n_launch} launches, "
                        "not 2")
                transpose = 2 * (E * C * D + E * D * F) * x.element_size()
            else:
                _, (wx, ww) = grads_of(torch, lambda a, b: rev(a, b, active),
                                       (x, w), dy)
                errs, wit, ulps = {}, {}, {}
                for name, g, want, wg in (("dx", dx, px, wx),
                                          ("dw", dw, pw, ww)):
                    ulps[name], wit[name], errs[name] = witness_check(
                        torch, f"{label} {name}", g, want, wg)
                require(n_launch == 1, f"{label}: {n_launch} launches, "
                        "not 1")
                require(not dx[~active].any() and not dw[~active].any(),
                        f"{label}: an inactive expert's dx or dw is not zero")
                extra = {"ulps": ulps, "witness_ulps": wit}
                if D == 2048:
                    dx2, dw2 = moe_gmm_bwd_cuda(dy, x, w, active)
                    dxo, none = moe_gmm_bwd_cuda(dy, x, w, active, True,
                                                 False)
                    none2, dwo = moe_gmm_bwd_cuda(dy, x, w, active, False,
                                                  True)
                    torch.cuda.synchronize()
                    require(torch.equal(dx2, dx) and torch.equal(dw2, dw),
                            f"{label}: two calls differ")
                    require(none is None and none2 is None
                            and torch.equal(dxo, dx)
                            and torch.equal(dwo, dw),
                            f"{label}: a dx-only or dw-only call differs "
                            "from the full call")
                    extra.update(bitwise_twice=True, dx_only_dw_only=True)
                    del dx2, dw2, dxo, dwo
                transpose = 0
            ms = time_ms(torch, lambda: moe_gmm_bwd_cuda(dy, x, w, active),
                         10)
            plain = time_ms(torch, lambda: grads_of(
                torch, lambda a, b: ref.moe_gmm_ref(a, b, active), (x, w),
                dy), 3)
            lib_ms = time_ms(torch, lambda: (torch.bmm(dy, w.transpose(1, 2)),
                                             torch.bmm(x.transpose(1, 2),
                                                       dy)), 10)
            elt = x.element_size()
            n_bytes = (C * F + 2 * (C * D + D * F)) * elt * n_active
            n_ops = 4.0 * n_active * C * D * F
            bms, by = bound_ms(n_bytes, n_ops, peak[dt])
            emit({"phase": "train", "kernel": "moe_gmm_bwd", "case": label,
                  "dtype": str(dt), "x": [E, C, D], "w": [E, D, F],
                  "active": n_active, "launches_a_call": n_launch,
                  "max_abs_err": errs, "ms": ms, "plain_ms": plain,
                  "two_bmm_ms": lib_ms, "bmm_ratio": ms / lib_ms,
                  "transpose_bytes": transpose,
                  "zero_bytes": (E - n_active) * (C * D + D * F) * elt,
                  "bound_ms": bms, "bound_by": by, **extra,
                  "nvidia_smi": CARD["nvidia_smi"]})
            emit_kernel("moe_gmm_bwd", max_abs_err=max(errs.values()),
                        main=(dt == torch.bfloat16 and C == 640
                              and D == 2048), ms=ms, plain_ms=plain,
                        bound_ms=bms, bound_by=by, library_ms=None)
            del x, w, dy, dx, dw, px, pw
    torch.cuda.empty_cache()


@contextlib.contextmanager
def counted_plain(torch):
    """Within it every call of K4's and K7's plain versions is counted
    (the kernel runs of the train phase must make none)."""
    from repro_torch.kernels import ref
    calls = {"flash_attention_ref": 0, "moe_gmm_ref": 0}
    saved = {name: getattr(ref, name) for name in calls}

    def counting(name):
        def fn(*a, **kw):
            calls[name] += 1
            return saved[name](*a, **kw)
        return fn
    for name in calls:
        setattr(ref, name, counting(name))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(ref, name, fn)


def train_batches(torch, cfg, batch, seq, n, seed, gen=None):
    """n packed batches on the card (`packed_batches` at `seed`), the
    stub frontends' inputs drawn from `gen` as the launcher draws them."""
    from repro_torch.data import DataConfig, packed_batches
    it = packed_batches(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                   global_batch=batch, seed=seed))
    out = []
    for _ in range(n):
        b = {k: torch.as_tensor(v, device="cuda")
             for k, v in next(it).items()}
        if cfg.family == "encdec":
            b["enc_feats"] = 0.02 * torch.randn(
                (batch, cfg.n_enc_frames, cfg.d_model), generator=gen,
                device="cuda")
        out.append(b)
    return out


def train_start(torch, cfg, batch, seq, steps):
    """The bfloat16 train runs' shared start: float32 masters drawn on
    the card from TRAIN_SEED (`module.draw`), zero model state, and
    `steps` packed batches (`train_batches`, the frames drawn from the
    same generator) -> (param specs, train state, batches)."""
    from repro_torch.models import build_model, module
    from repro_torch.train import TrainConfig, init_train_state
    gen = torch.Generator(device="cuda").manual_seed(TRAIN_SEED)
    model = build_model(cfg, device="meta")
    specs = model.param_specs()
    params = module.draw(specs, gen, "cuda", lambda path, spec: torch.float32)
    mstate = module.tree_map(lambda s: torch.zeros(
        s.shape, dtype=s.dtype, device="cuda"), model.state_specs())
    state = init_train_state(params, mstate, TrainConfig())
    return specs, state, train_batches(torch, cfg, batch, seq, steps,
                                       TRAIN_SEED, gen)


def train_witnesses(torch, moe=False):
    """The bfloat16 train runs' witnesses, as contexts: the plain
    versions with their float32 sums in other orders (the keys, or with
    MoE the gmm's D and the keys; the head dims alone; keys and head dims
    both).  Bfloat16 steps of these random models part by more than
    rounding would suggest (whisper's first gradient norm moves by 4 %
    between two orders), so the rule takes the largest of their gaps."""
    return [(lambda: reversed_sums(torch)) if moe
            else (lambda: reversed_keys(torch)),
            lambda: reversed_keys(torch, dims=True, keys=False),
            lambda: reversed_orders(torch)]


def train_run(torch, cfg, impl, state, batches, opt, ctx=None):
    """The port's train steps (`build_train_step`, a model on the meta
    device of `impl`) from `state` over `batches` -> (per-step metrics
    as floats, the launches, ms a step, host-idle share, peak bytes)."""
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainConfig, build_train_step
    step = build_train_step(build_model(cfg, device="meta", impl=impl),
                            TrainConfig(opt=OptConfig(**opt)))
    mets, walls, enq = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    with (ctx if ctx is not None else contextlib.nullcontext()):
        for b in batches:
            t0 = time.perf_counter()
            state, m = step(state, b)
            enq.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            mets.append({k: float(v) for k, v in m.items()})
    launches = {k: v for k, v in ops.launches().items() if v}
    # the first step builds and warms up; the rest are the steady state
    tail = walls[1:] or walls
    idle = sum(w - e for w, e in zip(walls[1:], enq[1:])) / max(sum(tail),
                                                                1e-9)
    return (mets, launches, 1e3 * sum(tail) / len(tail), idle,
            torch.cuda.max_memory_allocated())


def step1_grads(torch, cfg, impl, state, batch, ctx=None):
    """Step 1's loss and gradient (`train.loss_and_grads` on a model on
    the meta device of `impl`, within `ctx`) -> (loss, {leaf path:
    float32 gradient}, the layers' stacked leaves one entry a layer,
    "path[i]")."""
    from repro_torch.models import build_model
    from repro_torch.models.module import leaves
    from repro_torch.train import loss_and_grads
    with (ctx if ctx is not None else contextlib.nullcontext()):
        loss, grads, _, _ = loss_and_grads(
            build_model(cfg, device="meta", impl=impl), state["params"],
            state["model_state"], batch)
    out = {}
    for p, g in leaves(grads):       # a stacked leaf layer by layer
        name = "/".join(p)
        if p[0].endswith("blocks"):
            out.update((f"{name}[{i}]", x) for i, x in enumerate(g.float()))
        else:
            out[name] = g.float()
    return float(loss), out


def grad_norm(grads) -> float:
    """The global norm of `step1_grads`'s leaves (float64 sums)."""
    return float(sum(float(g.double().square().sum())
                     for g in grads.values()) ** 0.5)


def per_layer_fan_in(torch, specs, state, d_model) -> None:
    """Rescales, in place, each layer-stacked `fan_in` leaf of the train
    state's float32 masters from std scale/√L (both packages' rule: a
    stacked leaf's fan-in is its layer count L) to scale/√n, n the
    inputs of one layer's map: the leading dims of a leaf that writes
    the residual (wo's H·hd, wd's d_ff), else its first dim (d_model for
    wq, wk, wv, wg, wu).  The parity draws stay as they are; this start
    is chip_smoke.py's own, so that the random model's softmax does not
    saturate and its bf16 gradients mean something."""
    from repro_torch.models.module import leaves
    with torch.no_grad():
        for path, spec in leaves(specs):
            if spec.init != "fan_in" or not path[0].endswith("blocks"):
                continue
            n = (math.prod(spec.shape[1:-1]) if spec.shape[-1] == d_model
                 else spec.shape[1])
            leaf = state["params"]
            for k in path:
                leaf = leaf[k]
            leaf.mul_(math.sqrt(spec.shape[0] / n))


@contextlib.contextmanager
def score_max(torch):
    """Within it every call of K4's plain version appends to the yielded
    list the largest |q·k|/√hd of its kept scores."""
    from repro_torch.kernels import ref
    seen, saved = [], ref.flash_attention_ref

    def fn(q, k, v, causal=True, segment_ids=None):
        with torch.no_grad():
            g = q.shape[1] // k.shape[1]
            s = (q.float() @ k.float().repeat_interleave(g, dim=1)
                 .transpose(-1, -2)).abs() * q.shape[-1] ** -0.5
            keep = ref.attention_mask(q.shape[2], causal, segment_ids,
                                      q.device)
            if keep is not None:
                s = torch.where(keep, s, 0.0)
            seen.append(float(s.max()))
            del s
        return saved(q, k, v, causal, segment_ids)
    ref.flash_attention_ref = fn
    try:
        yield seen
    finally:
        ref.flash_attention_ref = saved


def f32_step1_check(torch, label, cfg, batch, seq, witnesses):
    """Step 1 of the train run of `cfg` in float32
    (`float32_config`, `train_start`'s start and batch): the kernels'
    loss, gradient norm (`train_gap_rule`) and gradient leaf by leaf
    (`leaf_gap_rule`) against the plain versions', within 1.5x the
    witnesses'.  In float32 a reordered sum moves the scores by ~1e-7
    of their size, so the softmax and the router's top-k seldom flip and
    the gradients stay comparable where the bfloat16 ones do not."""
    cfg = float32_config(torch, cfg)
    _, state, batches = train_start(torch, cfg, batch, seq, 1)
    b = batches[0]
    runs = [step1_grads(torch, cfg, "ref", state, b)]
    runs += [step1_grads(torch, cfg, "ref", state, b, w())
             for w in witnesses]
    loss, grads = step1_grads(torch, cfg, None, state, b)
    mets = [[{"loss": r[0], "grad_norm": grad_norm(r[1])}] for r in runs]
    got, lim, bad = train_gap_rule(
        [{"loss": loss, "grad_norm": grad_norm(grads)}], mets[0], mets[1:])
    leaf, leaf_bad = leaf_gap_rule(grads, runs[0][1], [r[1] for r in runs[1:]])
    emit({"phase": "train", "case": f"{label} float32 step 1",
          "layers": cfg.n_layers, "batch": [batch, seq], "loss": loss,
          "grad_norm": grad_norm(grads), "plain_loss": runs[0][0],
          "plain_grad_norm": mets[0][0]["grad_norm"],
          "witness_loss": [m[0]["loss"] for m in mets[1:]],
          "witness_grad_norm": [m[0]["grad_norm"] for m in mets[1:]],
          "gap_from_plain": {k: v[0] for k, v in got.items()},
          "witness_limit": {k: v[0] for k, v in lim.items()},
          "step1_leaves": leaf, "nvidia_smi": CARD["nvidia_smi"]})
    require(not bad and not leaf_bad, f"train {label} float32 step 1: "
            + "; ".join(bad + leaf_bad))
    del state, batches, runs, grads


def leaf_gap_rule(got, plain, wits, factor=1.5, floor=2.0 ** -8):
    """Step 1's gradient leaf by leaf: each leaf of `got` no further from
    `plain`'s (‖g − g_plain‖) than `factor` times the largest of the
    witnesses' `wits` distances, floored at `floor` (a bfloat16 ulp) of
    ‖g_plain‖.  A fault in one layer's gradient moves that layer's
    leaves by their whole size, while the global norm, which one large
    leaf may carry, hardly moves.  -> ({"worst": the leaf nearest its
    limit, "ratio": its distance over its limit, "largest": the leaf
    that parts most, "distance", "witness"}, the failures)."""
    rows, bad = [], []
    for path, gp in plain.items():
        d = float((got[path] - gp).norm())
        w = max([float((x[path] - gp).norm()) for x in wits]
                + [floor * float(gp.norm())])
        rows.append((d / w if w > 0 else float(d > 0) * float("inf"),
                     path, d, w))
        if d > factor * w:
            bad.append(f"step 1 gradient {path}: {d} from plain, beyond "
                       f"{factor} x the witnesses' {w}")
    worst = max(rows)
    big = max(rows, key=lambda r: r[2])
    return {"worst": worst[1], "ratio": worst[0], "largest": big[1],
            "distance": big[2], "witness": big[3]}, bad


def train_gaps(mets, base):
    """{"loss" / "grad_norm": [step 1's distance from `base`, the largest
    over the later steps]}: step 1 is one forward and one gradient from
    the shared start, the later steps follow each run's own updates."""
    out = {}
    for key in ("loss", "grad_norm"):
        d = [abs(m[key] - b[key]) for m, b in zip(mets, base)]
        out[key] = [d[0], max(d[1:], default=0.0)]
    return out


ALL_GAPS = (("loss", 0), ("loss", 1), ("grad_norm", 0), ("grad_norm", 1))


def train_gap_rule(mets, plain, wits, factor=1.5, hold=ALL_GAPS):
    """The train runs' rule: for the loss and the gradient norm each, and
    for step 1 and the later steps each (the pairs (key, 0 or 1) that
    `hold` names), the kernel run `mets` no further from the `plain` run
    than `factor` times the largest of the witness runs' `wits`
    distances (floored at 2^-20 of the plain value, a few float32
    ulps).  -> (kernel gaps, witness limits before the factor, the
    failures as strings)."""
    got = train_gaps(mets, plain)
    gaps = [train_gaps(w, plain) for w in wits]
    lim, bad = {}, []
    for key, parts in got.items():
        lim[key] = []
        for i, d in enumerate(parts):
            steps = plain[:1] if i == 0 else plain[1:]
            floor = 2.0 ** -20 * max((abs(m[key]) for m in steps),
                                     default=0.0)
            w = max([g[key][i] for g in gaps] + [floor])
            lim[key].append(w)
            if (key, i) in hold and d > factor * w:
                bad.append(f"{key} {'step 1' if i == 0 else 'later steps'}"
                           f" {d} from plain, beyond {factor} x the "
                           f"witnesses' {w}")
    return got, lim, bad


def train_phase(torch, src, emit_kernel) -> dict:
    """The `train` phase: K4's and K7's backward against their plain
    versions (`k4_bwd_checks`, `k7_bwd_checks`), then the training path
    (`train.build_train_step` over `LM.loss` / `EncDecLM.loss`) at full
    width: Qwen3-0.6B in float32 at TRAIN_F32_LAYERS layers against
    `reference_train.json` (losses, gradient norms, learning rates to
    TRAIN_F32_RTOL), Qwen3-0.6B in bfloat16 at all 28 layers on 8 x 512
    packed batches through the kernels, the plain versions and the
    witness, OLMoE-1B-7B at TRAIN_MOE_LAYERS layers with
    `moe_ep_scatter` off and on, whisper-base (6 + 6 layers, 1,500
    frames), from the parity draws and again with a per-layer fan-in.  A
    kernel run must launch K4 forward (twice a layer a step:
    the remat recomputes it), K4's backward and, with MoE, K7 and its
    backward, and call no plain version; its losses and gradient norms
    within `train_gap_rule` of the plain run's (the gaps each run
    holds: below), Qwen3's and the per-layer whisper's step-1 gradient
    within `leaf_gap_rule`; the expert-parallel OLMoE's step 1 twice
    bit for bit; then whisper-base's and OLMoE's step 1 in float32
    (`f32_step1_check`).  Returns
    the kernel runs' launches."""
    from repro_torch import configs
    from repro_torch.convert import train_state_from_numpy
    from repro_torch.models import build_model, module
    from repro_torch.train import TrainConfig, init_train_state
    t_phase = time.perf_counter()
    k4_bwd_checks(torch, emit_kernel)
    k7_bwd_checks(torch, emit_kernel)
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    # ---------------------------------------- float32 against the golden
    with open(os.path.join(src, "repro_torch", "data",
                           "reference_train.json")) as f:
        gold = json.load(f)
    require(gold["arch"] == TRAIN_ARCH and gold["seed"] == TRAIN_SEED
            and gold["layers"] == TRAIN_F32_LAYERS
            and (gold["batch"], gold["seq"], gold["steps"]) == (
                TRAIN_F32_BATCH, TRAIN_F32_SEQ, TRAIN_F32_STEPS)
            and gold["opt"] == TRAIN_OPT,
            "reference_train.json names another run")
    cfg32 = float32_config(torch, configs.get_config(TRAIN_ARCH)).replace(
        n_layers=TRAIN_F32_LAYERS)
    t0 = time.perf_counter()
    params = module.init(build_model(cfg32, device="meta").param_specs(),
                         TRAIN_SEED)
    tc = TrainConfig()
    state = init_train_state(train_state_from_numpy(params, "cuda"), {}, tc)
    del params
    draw_s = time.perf_counter() - t0
    batches = train_batches(torch, cfg32, TRAIN_F32_BATCH, TRAIN_F32_SEQ,
                            TRAIN_F32_STEPS, TRAIN_SEED)
    mets, counts, ms, idle, peak = train_run(torch, cfg32, None, state,
                                             batches, TRAIN_OPT)
    rel = {}
    for key in ("loss", "grad_norm", "lr"):
        for t, (m, want, wit) in enumerate(zip(mets, gold[key],
                                               gold["witness"][key])):
            r = abs(m[key] - want) / abs(want)
            rel[key] = max(rel.get(key, 0.0), r)
            require(r <= TRAIN_F32_RTOL, f"train float32 step {t + 1} {key} "
                    f"{m[key]} != golden {want} (rtol {r})")
    want_counts = {"flash_attention": 2 * TRAIN_F32_LAYERS * TRAIN_F32_STEPS,
                   "flash_attention_bwd": TRAIN_F32_LAYERS * TRAIN_F32_STEPS}
    require(counts == want_counts, f"train float32 launches {counts} != "
            f"{want_counts}")
    add(counts)
    emit({"phase": "train", "case": f"{TRAIN_ARCH} float32 against "
          "reference_train.json", "layers": TRAIN_F32_LAYERS,
          "batch": [TRAIN_F32_BATCH, TRAIN_F32_SEQ],
          "loss": [m["loss"] for m in mets],
          "grad_norm": [m["grad_norm"] for m in mets],
          "golden_loss": gold["loss"], "golden_grad_norm": gold["grad_norm"],
          "witness_loss": gold["witness"]["loss"],
          "witness_grad_norm": gold["witness"]["grad_norm"],
          "max_rel_err": rel, "rtol": TRAIN_F32_RTOL, "launches": counts,
          "numpy_draw_s": draw_s, "ms_per_step": ms,
          "peak_bytes": peak, "nvidia_smi": CARD["nvidia_smi"]})
    del state, batches
    gc.collect()
    torch.cuda.empty_cache()

    def bf16_runs(arch, cfg, witnesses, batch, seq, steps, want, extra="",
                  hold=ALL_GAPS, leaves=False, fan_in=False, repeat=False):
        t0 = time.perf_counter()
        specs, state, batches = train_start(torch, cfg, batch, seq, steps)
        if fan_in:
            per_layer_fan_in(torch, specs, state, cfg.d_model)
        draw_s = time.perf_counter() - t0
        with counted_plain(torch) as calls:
            mets, counts, ms, idle, peak = train_run(
                torch, cfg, None, state, batches, TRAIN_OPT)
        require(sum(calls.values()) == 0, f"train {arch}{extra}: the kernel "
                f"run called plain versions {calls}")
        require(counts == want, f"train {arch}{extra} launches {counts} != "
                f"{want}")
        extras = {}
        if repeat:      # step 1's loss and gradient twice, bit for bit
            (l1, g1), (l2, g2) = (step1_grads(torch, cfg, None, state,
                                              batches[0]) for _ in range(2))
            extras["bitwise_repeat"] = l1 == l2 and all(
                torch.equal(g1[k], g2[k]) for k in g1)
            require(extras["bitwise_repeat"], f"train {arch}{extra}: a "
                    "second step-1 loss and gradient differ")
            del g1, g2
        if fan_in:      # a plain step 1's largest score, from this start
            # and, for contrast, from the parity draws' start
            for name, st in (("score_max", state), ("score_max_stacked",
                                                    None)):
                if st is None:
                    st = train_start(torch, cfg, batch, seq, 1)[1]
                with score_max(torch) as seen:
                    step1_grads(torch, cfg, "ref", st, batches[0])
                extras[name] = max(seen)
                del st
        plain = train_run(torch, cfg, "ref", state, batches, TRAIN_OPT)
        wits = [train_run(torch, cfg, "ref", state, batches, TRAIN_OPT,
                          witness())[0] for witness in witnesses]
        got, lim, bad = train_gap_rule(mets, plain[0], wits, hold=hold)
        leaf = None
        if leaves:      # step 1's gradient leaf by leaf, the same start
            g_plain = step1_grads(torch, cfg, "ref", state, batches[0])[1]
            g_wits = [step1_grads(torch, cfg, "ref", state, batches[0],
                                  witness())[1] for witness in witnesses]
            leaf, leaf_bad = leaf_gap_rule(
                step1_grads(torch, cfg, None, state, batches[0])[1],
                g_plain, g_wits)
            del g_plain, g_wits
            bad += leaf_bad
        tokens = batch * seq
        emit({"phase": "train", "case": f"{arch}{extra} bfloat16",
              "layers": cfg.n_layers, "batch": [batch, seq],
              "params": module.param_count(specs),
              "loss": [m["loss"] for m in mets],
              "grad_norm": [m["grad_norm"] for m in mets],
              "plain_loss": [m["loss"] for m in plain[0]],
              "plain_grad_norm": [m["grad_norm"] for m in plain[0]],
              "witness_loss": [[m["loss"] for m in w] for w in wits],
              "witness_grad_norm": [[m["grad_norm"] for m in w]
                                    for w in wits],
              "gap_from_plain": got, "witness_limit": lim,
              "held": [f"{k} {'step 1' if i == 0 else 'later'}"
                       for k, i in hold], "step1_leaves": leaf,
              "launches": counts, "ms_per_step": ms,
              "tokens_per_s": tokens / ms * 1e3,
              "host_idle_share": idle, "peak_bytes": peak,
              "plain_ms_per_step": plain[2], "plain_peak_bytes": plain[4],
              "draw_s": draw_s, **extras, "nvidia_smi": CARD["nvidia_smi"]})
        require(not bad, f"train {arch}{extra} bfloat16: "
                + "; ".join(bad))
        add(counts)
        del state, batches
        gc.collect()
        torch.cuda.empty_cache()

    # --------------------------------------- Qwen3-0.6B bfloat16, 28 layers
    # What each bfloat16 run holds (every gap is recorded): the loss of
    # step 1, a forward from the shared start, always.  Step 1's
    # gradient norm is one projection of a gradient that any reordering
    # moves by ~4 % (Qwen3's `embed`), too noisy for a 1.5x rule; Qwen3
    # holds that gradient leaf by leaf instead, and its later steps.
    # With MoE a rounding flips a few tokens' experts (the router's
    # top-k) and whisper's saturated softmax decorrelates its gradient,
    # so their later steps measure noise and their step-1 gradients are
    # held in float32 below; whisper's again in bfloat16 from a start
    # with a per-layer fan-in, where its softmax does not saturate.
    later = (("loss", 0), ("loss", 1), ("grad_norm", 1))
    witnesses = train_witnesses(torch)
    cfg = configs.get_config(TRAIN_ARCH)
    L, n = cfg.n_layers, TRAIN_BF16_STEPS
    bf16_runs(TRAIN_ARCH, cfg, witnesses, TRAIN_BF16_BATCH,
              TRAIN_BF16_SEQ, n, {"flash_attention": 2 * L * n,
                                  "flash_attention_bwd": L * n},
              hold=later, leaves=True)
    # ---------------------------------- OLMoE-1B-7B, both dispatch lowerings
    for ep in (False, True):
        cfg = configs.get_config(TRAIN_MOE_ARCH).replace(
            n_layers=TRAIN_MOE_LAYERS, moe_ep_scatter=ep)
        L, n = cfg.n_layers, TRAIN_MOE_STEPS
        bf16_runs(TRAIN_MOE_ARCH, cfg, train_witnesses(torch, moe=True),
                  TRAIN_BF16_BATCH,
                  TRAIN_BF16_SEQ, n, {"flash_attention": 2 * L * n,
                                      "flash_attention_bwd": L * n,
                                      "moe_gmm": 6 * L * n,
                                      "moe_gmm_bwd": 3 * L * n},
                  f" ({L} layers, moe_ep_scatter={ep})",
                  hold=(("loss", 0),), repeat=ep)
    # ------------------------------------------------------- whisper-base
    cfg = configs.get_config(TRAIN_ENCDEC_ARCH)
    n = TRAIN_ENCDEC_STEPS
    # a decoder layer runs K4 twice (self, cross), an encoder layer once
    n_fwd = cfg.n_layers * 2 + (cfg.n_enc_layers or cfg.n_layers)
    whisper = cfg
    bf16_runs(TRAIN_ENCDEC_ARCH, cfg, witnesses, TRAIN_BF16_BATCH,
              TRAIN_ENCDEC_SEQ, n, {"flash_attention": 2 * n_fwd * n,
                                    "flash_attention_bwd": n_fwd * n},
              hold=(("loss", 0),))
    bf16_runs(TRAIN_ENCDEC_ARCH, cfg, witnesses, TRAIN_BF16_BATCH,
              TRAIN_ENCDEC_SEQ, n, {"flash_attention": 2 * n_fwd * n,
                                    "flash_attention_bwd": n_fwd * n},
              " (per-layer fan-in)", hold=(("loss", 0),), leaves=True,
              fan_in=True)
    # ---------------------------- float32 step 1, loss, norm and leaves
    # whisper-base's scores reach the hundreds (the stacked weights'
    # fan-in is the layer count, and it has no qk-norm)
    f32_step1_check(torch, TRAIN_ENCDEC_ARCH, whisper, TRAIN_BF16_BATCH,
                    TRAIN_ENCDEC_SEQ, witnesses)
    f32_step1_check(torch, f"{TRAIN_MOE_ARCH} ({TRAIN_MOE_LAYERS} layers)",
                    configs.get_config(TRAIN_MOE_ARCH).replace(
                        n_layers=TRAIN_MOE_LAYERS), TRAIN_BF16_BATCH,
                    TRAIN_BF16_SEQ, train_witnesses(torch, moe=True))
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "train", "case": "done", "launches": launches,
          "seconds": time.perf_counter() - t_phase})
    return launches


def port_prefix(key: str):
    """The PORT_KERNEL_PREFIXES entry a profiler key starts with, or
    None."""
    name = key.split("(anonymous namespace)::", 1)[-1]
    return next((p for p in PORT_KERNEL_PREFIXES if name.startswith(p)),
                None)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--distributed-worker"]:
        sys.exit(dist_worker(int(sys.argv[2]), int(sys.argv[3]),
                             sys.argv[4]))
    sys.exit(main())
